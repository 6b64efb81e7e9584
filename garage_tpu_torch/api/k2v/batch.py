"""Copy of garage_tpu/api/k2v/batch.py: import paths rewritten, issue and PR tags dropped.

K2V batch endpoints: InsertBatch / ReadBatch / DeleteBatch.

Ref parity: src/api/k2v/batch.rs. All three take JSON arrays; reads and
deletes are per-partition-key range queries over the item table.
"""

from __future__ import annotations

import base64
import json

from ...model.k2v.causality import CausalContext
from ...model.k2v.item_table import partition_pk
from ..http import Request, Response
from ..s3.xml import S3Error
from .item import parse_causality_token

MAX_LIMIT = 1000


async def _json_body(req: Request):
    raw = await req.body.read_all(limit=10 << 20)
    try:
        return json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        raise S3Error("InvalidRequest", 400, "body is not valid JSON")


async def handle_insert_batch(ctx, req: Request) -> Response:
    spec = await _json_body(req)
    if not isinstance(spec, list):
        raise S3Error("InvalidRequest", 400, "expected a JSON array")
    items = []
    for it in spec:
        try:
            pk, sk = it["pk"], it["sk"]
            ct = (parse_causality_token(it["ct"])
                  if it.get("ct") else None)
            v = it.get("v")
            # strict base64 like the reference (batch.rs:30-33): a
            # value with out-of-alphabet bytes is a client bug, not
            # data to silently mangle
            value = (base64.b64decode(v, validate=True)
                     if v is not None else None)
        except (KeyError, TypeError, ValueError):
            raise S3Error("InvalidRequest", 400, "malformed batch item")
        items.append((pk, sk, ct, value))
    await ctx.garage.k2v_rpc.insert_batch(ctx.bucket_id, items)
    return Response(204)


def check_start_in_prefix(start, prefix) -> None:
    """ref: range.rs:30-40 — a start key outside the prefix window is a
    contradiction the reference rejects up front (both directions).
    Non-string values 400 too: the reference rejects them at
    deserialization, and letting them through turns into a 500 at the
    first .startswith/.encode."""
    for v in (start, prefix):
        if v is not None and not isinstance(v, str):
            raise S3Error("InvalidRequest", 400,
                          "prefix/start must be strings")
    if prefix and start is not None and not start.startswith(prefix):
        raise S3Error(
            "InvalidRequest", 400,
            f"Start key '{start}' does not start with prefix '{prefix}'")


def _parse_query(qjson: dict) -> dict:
    if not isinstance(qjson, dict) or "partitionKey" not in qjson:
        raise S3Error("InvalidRequest", 400, "query needs partitionKey")
    if not isinstance(qjson["partitionKey"], str):
        raise S3Error("InvalidRequest", 400, "partitionKey must be a string")
    if qjson.get("end") is not None and not isinstance(qjson["end"], str):
        raise S3Error("InvalidRequest", 400, "end must be a string")
    check_start_in_prefix(qjson.get("start"), qjson.get("prefix"))
    raw_limit = qjson.get("limit")
    return {
        "partition_key": qjson["partitionKey"],
        "prefix": qjson.get("prefix"),
        "start": qjson.get("start"),
        "end": qjson.get("end"),
        "limit": (min(int(raw_limit), MAX_LIMIT)
                  if raw_limit is not None else MAX_LIMIT),
        "reverse": bool(qjson.get("reverse", False)),
        "single_item": bool(qjson.get("singleItem", False)),
        "conflicts_only": bool(qjson.get("conflictsOnly", False)),
        "tombstones": bool(qjson.get("tombstones", False)),
    }


async def _range_items(ctx, spec: dict, limit: int) -> list:
    """Range bounds (prefix / start / exclusive end, both directions)
    are enforced server-side by TableData.read_range."""
    pk = partition_pk(ctx.bucket_id, spec["partition_key"])
    flt = {"type": "item", "conflicts_only": spec["conflicts_only"],
           "tombstones": spec["tombstones"]}
    return await ctx.garage.k2v_item_table.get_range(
        pk,
        spec["start"].encode() if spec["start"] else None,
        flt=flt, limit=limit, reverse=spec["reverse"],
        prefix_sk=spec["prefix"].encode() if spec["prefix"] else None,
        end_sk=spec["end"].encode() if spec["end"] is not None else None)


def _item_json(item) -> dict:
    return {
        "sk": item.sort_key_str,
        "ct": item.causal_context().serialize(),
        "v": [None if v is None else base64.b64encode(v).decode()
              for v in item.values()],
    }


async def handle_read_batch(ctx, req: Request) -> Response:
    spec = await _json_body(req)
    if not isinstance(spec, list):
        raise S3Error("InvalidRequest", 400, "expected a JSON array")
    queries = [_parse_query(qj) for qj in spec]
    results = []
    for q in queries:
        if q["single_item"]:
            if q["start"] is None:
                raise S3Error("InvalidRequest", 400,
                              "singleItem requires start (the sort key)")
            item = await ctx.garage.k2v_item_table.get(
                partition_pk(ctx.bucket_id, q["partition_key"]),
                q["start"].encode())
            items = ([_item_json(item)] if item is not None
                     and (q["tombstones"] or not item.is_tombstone())
                     else [])
            results.append({
                "partitionKey": q["partition_key"],
                "prefix": q["prefix"], "start": q["start"],
                "end": q["end"], "limit": q["limit"],
                "reverse": q["reverse"], "singleItem": True,
                "items": items, "more": False, "nextStart": None,
            })
            continue
        # fetch one extra row: its sort key becomes the next page's
        # (inclusive) start without re-serving the boundary item
        items = await _range_items(ctx, q, q["limit"] + 1)
        more = len(items) > q["limit"]
        next_start = items[q["limit"]].sort_key_str if more else None
        items = items[:q["limit"]]
        results.append({
            "partitionKey": q["partition_key"],
            "prefix": q["prefix"], "start": q["start"], "end": q["end"],
            "limit": q["limit"], "reverse": q["reverse"],
            "singleItem": False,
            "items": [_item_json(i) for i in items],
            "more": more,
            "nextStart": next_start,
        })
    return Response(200, [("content-type", "application/json")],
                    json.dumps(results).encode())


async def handle_delete_batch(ctx, req: Request) -> Response:
    spec = await _json_body(req)
    if not isinstance(spec, list):
        raise S3Error("InvalidRequest", 400, "expected a JSON array")
    results = []
    for qj in spec:
        q = _parse_query(qj)
        if q["single_item"]:
            if q["start"] is None:
                raise S3Error("InvalidRequest", 400,
                              "singleItem requires start (the sort key)")
            item = await ctx.garage.k2v_item_table.get(
                partition_pk(ctx.bucket_id, q["partition_key"]),
                q["start"].encode())
            deleted = 0
            if item is not None and not item.is_tombstone():
                await ctx.garage.k2v_rpc.insert(
                    ctx.bucket_id, q["partition_key"], q["start"],
                    item.causal_context(), None)
                deleted = 1
        else:
            # drain the whole range in pages — a silent cap would
            # report success while leaving items behind
            deleted = 0
            page = dict(q)
            while True:
                items = await _range_items(ctx, page, MAX_LIMIT)
                batch = [(q["partition_key"], i.sort_key_str,
                          i.causal_context(), None)
                         for i in items if not i.is_tombstone()]
                if batch:
                    await ctx.garage.k2v_rpc.insert_batch(ctx.bucket_id,
                                                          batch)
                deleted += len(batch)
                if len(items) < MAX_LIMIT:
                    break
                page["start"] = items[-1].sort_key_str + "\x00"
        results.append({
            "partitionKey": q["partition_key"], "prefix": q["prefix"],
            "start": q["start"], "end": q["end"],
            "singleItem": q["single_item"], "deletedItems": deleted,
        })
    return Response(200, [("content-type", "application/json")],
                    json.dumps(results).encode())
