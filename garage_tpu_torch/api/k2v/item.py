"""Copy of garage_tpu/api/k2v/item.py: import paths rewritten, issue and PR tags dropped.

K2V item endpoints: ReadItem / InsertItem / DeleteItem / PollItem.

Ref parity: src/api/k2v/item.rs. Values travel raw
(application/octet-stream, single value) or as a JSON array of base64
strings (null = deletion marker); the X-Garage-Causality-Token header
carries the item's causal context both ways.
"""

from __future__ import annotations

import base64
import json

from ...model.k2v.causality import CausalContext
from ...model.k2v.item_table import K2VItem, partition_pk
from ..http import Request, Response
from ..s3.xml import S3Error

CAUSALITY_TOKEN = "x-garage-causality-token"


def parse_causality_token(s: str) -> CausalContext:
    ct = CausalContext.parse(s)
    if ct is None:
        raise S3Error("InvalidCausalityToken", 400,
                      "Invalid causality token")
    return ct


def _accept(req: Request) -> str:
    """-> "json" | "binary" | "either" (ref: item.rs ReturnFormat)."""
    accept = req.header("accept")
    if accept is None:
        return "json"
    parts = [p.strip().split(";")[0] for p in accept.split(",")]
    wants_json = "application/json" in parts or "*/*" in parts
    wants_bin = "application/octet-stream" in parts or "*/*" in parts
    if wants_json and wants_bin:
        return "either"
    if wants_json:
        return "json"
    if wants_bin:
        return "binary"
    raise S3Error("NotAcceptable", 406,
                  "Accept must include application/json or "
                  "application/octet-stream")


def make_item_response(req: Request, item: K2VItem) -> Response:
    vals = item.values()
    if not vals:
        raise S3Error("NoSuchKey", 404, "no such key")
    ct = item.causal_context().serialize()
    fmt = _accept(req)
    if fmt == "binary" and len(vals) > 1:
        return Response(409, [(CAUSALITY_TOKEN, ct)])
    if fmt == "binary" or (fmt == "either" and len(vals) == 1):
        v = vals[0]
        if v is None:
            return Response(204, [(CAUSALITY_TOKEN, ct),
                                  ("content-type",
                                   "application/octet-stream")])
        return Response(200, [(CAUSALITY_TOKEN, ct),
                              ("content-type",
                               "application/octet-stream")], v)
    body = json.dumps([
        None if v is None else base64.b64encode(v).decode() for v in vals
    ]).encode()
    return Response(200, [(CAUSALITY_TOKEN, ct),
                          ("content-type", "application/json")], body)


async def handle_read_item(ctx, req: Request, partition_key: str,
                           sort_key: str) -> Response:
    item = await ctx.garage.k2v_item_table.get(
        partition_pk(ctx.bucket_id, partition_key), sort_key.encode())
    if item is None:
        raise S3Error("NoSuchKey", 404, "no such key")
    return make_item_response(req, item)


async def handle_insert_item(ctx, req: Request, partition_key: str,
                             sort_key: str) -> Response:
    ct_str = req.header(CAUSALITY_TOKEN)
    ct = parse_causality_token(ct_str) if ct_str else None
    value = await req.body.read_all(limit=10 << 20)
    await ctx.garage.k2v_rpc.insert(ctx.bucket_id, partition_key,
                                    sort_key, ct, value)
    return Response(204)


async def handle_delete_item(ctx, req: Request, partition_key: str,
                             sort_key: str) -> Response:
    ct_str = req.header(CAUSALITY_TOKEN)
    if not ct_str:
        raise S3Error("InvalidRequest", 400,
                      "X-Garage-Causality-Token is required for deletes")
    ct = parse_causality_token(ct_str)
    await req.body.drain()
    await ctx.garage.k2v_rpc.insert(ctx.bucket_id, partition_key,
                                    sort_key, ct, None)
    return Response(204)


async def handle_poll_range(ctx, req: Request,
                            partition_key: str) -> Response:
    """POST /{bucket}/{partition}?poll_range — wait for changes in a
    sort-key range vs a seen marker (ref: api/k2v poll_range +
    model/k2v/seen.rs)."""
    raw = await req.body.read_all(limit=1 << 20)
    try:
        spec = json.loads(raw.decode()) if raw else {}
    except (ValueError, UnicodeDecodeError):
        raise S3Error("InvalidRequest", 400, "body is not valid JSON")
    try:
        timeout = min(float(spec.get("timeout", 300)), 600.0)
    except (TypeError, ValueError):
        raise S3Error("InvalidRequest", 400, "bad timeout")
    try:
        res = await ctx.garage.k2v_rpc.poll_range(
            ctx.bucket_id, partition_key,
            spec.get("prefix"), spec.get("start"), spec.get("end"),
            spec.get("seenMarker"), timeout)
    except ValueError as e:
        raise S3Error("InvalidRequest", 400, str(e))
    if res is None:
        return Response(304)
    items, seen = res
    body = json.dumps({
        "items": [{
            "sk": i.sort_key_str,
            "ct": i.causal_context().serialize(),
            "v": [None if v is None else base64.b64encode(v).decode()
                  for v in i.values()],
        } for i in items],
        "seenMarker": seen,
    }).encode()
    return Response(200, [("content-type", "application/json")], body)


async def handle_poll_item(ctx, req: Request, partition_key: str,
                           sort_key: str) -> Response:
    ct = parse_causality_token(req.query.get("causality_token", ""))
    try:
        timeout = min(float(req.query.get("timeout", "300")), 600.0)
    except ValueError:
        raise S3Error("InvalidRequest", 400, "bad timeout")
    item = await ctx.garage.k2v_rpc.poll_item(
        ctx.bucket_id, partition_key, sort_key, ct, timeout)
    if item is None:
        return Response(304, [(CAUSALITY_TOKEN, ct.serialize())])
    return make_item_response(req, item)
