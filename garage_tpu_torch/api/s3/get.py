"""Copy of garage_tpu/api/s3/get.py: import paths rewritten, issue and PR tags dropped.

GetObject / HeadObject, with range and conditional requests.

Ref parity: src/api/s3/get.rs:139-508. Serves inline data directly;
block data streams block-by-block through BlockManager (ordered,
failover per block). Range requests binary-search the version's block
list; conditionals (If-None-Match / If-Modified-Since) answer 304.
"""

from __future__ import annotations

import asyncio
import datetime
from collections import deque
from typing import AsyncIterator, Optional

from ..http import Request, Response
from .xml import S3Error, no_such_key


def http_date(ts_msec: int) -> str:
    return datetime.datetime.fromtimestamp(
        ts_msec / 1000, datetime.timezone.utc
    ).strftime("%a, %d %b %Y %H:%M:%S GMT")


def _parse_http_date(s: str, which: str) -> float:
    try:
        return datetime.datetime.strptime(
            s, "%a, %d %b %Y %H:%M:%S GMT"
        ).replace(tzinfo=datetime.timezone.utc).timestamp()
    except ValueError:
        # ref: get.rs PreconditionHeaders::parse ok_or_bad_request
        raise S3Error("InvalidArgument", 400, f"invalid date in {which}")


def _etag_matches(header_val: str, etag: str) -> bool:
    """Client tokens may come quoted or bare (the reference strips
    quotes: get.rs trim_matches('\"'))."""
    cands = [e.strip() for e in header_val.split(",")]
    return "*" in cands or any(c.strip('"') == etag for c in cands)


def check_preconditions(get_header, version, etag: str) -> Optional[str]:
    """RFC 7232 §6 evaluation order, shared by GET/HEAD and the copy
    family (ref: get.rs:819-855 PreconditionHeaders::check). Returns
    None (pass), "fail" (412 always) or "not_modified" (304 on GET,
    412 on copy). `get_header` maps a bare condition name ("if-match")
    to the header value, letting copy prefix x-amz-copy-source-."""
    im = get_header("if-match")
    if im is not None:
        if not _etag_matches(im, etag):
            return "fail"
    else:
        ius = get_header("if-unmodified-since")
        if ius is not None:
            t = _parse_http_date(ius, "if-unmodified-since")
            # floor to whole seconds: Last-Modified has 1 s resolution
            if version.timestamp // 1000 > t:
                return "fail"
    inm = get_header("if-none-match")
    if inm is not None:
        if _etag_matches(inm, etag):
            return "not_modified"
    else:
        ims = get_header("if-modified-since")
        if ims is not None:
            t = _parse_http_date(ims, "if-modified-since")
            if version.timestamp // 1000 <= t:
                return "not_modified"
    return None


def check_copy_source_preconditions(req: Request, version, etag: str) -> None:
    """`x-amz-copy-source-if-*` for CopyObject / UploadPartCopy. On a
    copy, EVERY failed condition — including the ones a GET would
    answer 304 to — is a 412 (ref: get.rs check_copy_source)."""
    pfx = "x-amz-copy-source-"
    if check_preconditions(
            lambda name: req.header(pfx + name), version, etag) is not None:
        raise S3Error("PreconditionFailed", 412,
                      "copy source precondition failed")


def _object_headers(version, meta) -> list[tuple[str, str]]:
    """ref: get.rs object_headers."""
    out = [("etag", f'"{meta.etag}"'),
           ("last-modified", http_date(version.timestamp)),
           ("accept-ranges", "bytes"),
           ("x-amz-version-id", version.uuid.hex())]
    for name, v in sorted(meta.headers.items()):
        if name.startswith(("x-garage-ssec-", "x-garage-checksum-")):
            continue  # internal markers; surfaced as x-amz-* on demand
        out.append((name, v))
    if "content-type" not in meta.headers:
        out.append(("content-type", "application/octet-stream"))
    from .encryption import sse_response_headers

    out.extend(sse_response_headers(meta))
    return out


def parse_range(spec: str, size: int) -> Optional[tuple[int, int]]:
    """'bytes=a-b' -> (start, end_exclusive), or None if unparsable.

    Multi-range specs ('bytes=0-0,5-9') are rejected as a whole (-> 416
    upstream): this server serves single ranges only, and silently
    answering with just the first range hands the client a body it
    didn't ask for — a multipart/byteranges consumer would misparse it.
    """
    if not spec.startswith("bytes="):
        return None
    ranges = [p for p in spec[len("bytes="):].split(",") if p.strip()]
    if len(ranges) != 1:
        return None
    r = ranges[0].strip()
    start_s, _, end_s = r.partition("-")
    try:
        if start_s == "":
            n = int(end_s)  # suffix range: last n bytes
            if n == 0:
                return None
            return max(0, size - n), size
        start = int(start_s)
        end = int(end_s) + 1 if end_s else size
    except ValueError:
        return None
    if start >= size or start >= end:
        return None
    return start, min(end, size)


async def handle_get(ctx, req: Request, head: bool = False) -> Response:
    from .encryption import check_key_for_meta, request_sse_key

    obj = await ctx.garage.object_table.get(ctx.bucket_id,
                                            ctx.key.encode())
    v = obj.last_data() if obj is not None else None
    if v is None:
        raise no_such_key(ctx.key)
    meta = v.state.data.meta
    sse_key = check_key_for_meta(meta, request_sse_key(req))

    # conditionals (ref: get.rs try_answer_cached)
    cond = check_preconditions(req.header, v, meta.etag)
    if cond == "fail":
        raise S3Error("PreconditionFailed", 412, "precondition failed")
    if cond == "not_modified":
        return Response(304, _object_headers(v, meta))

    headers = _object_headers(v, meta)
    # response-content-* query overrides (ref: get.rs:41-44,104-107;
    # presigned-download UX: the signer picks the browser-facing
    # content-type/disposition at sign time)
    for qname, hname in (("response-content-type", "content-type"),
                         ("response-content-language", "content-language"),
                         ("response-content-encoding", "content-encoding"),
                         ("response-content-disposition",
                          "content-disposition"),
                         ("response-cache-control", "cache-control"),
                         ("response-expires", "expires")):
        ov = req.query.get(qname)
        if ov is not None:
            headers = [(n, val) for n, val in headers if n != hname]
            headers.append((hname, ov))
    if (req.header("x-amz-checksum-mode") or "").upper() == "ENABLED":
        for name, val in meta.headers.items():
            if name.startswith("x-garage-checksum-"):
                algo = name[len("x-garage-checksum-"):]
                headers.append((f"x-amz-checksum-{algo}", val))
    size = meta.size
    rng = None
    prefetched_version = None
    part_q = req.query.get("partNumber")
    if part_q is not None:
        if req.header("range"):
            raise S3Error("InvalidRequest", 400,
                          "cannot combine partNumber and Range")
        rng, n_parts, prefetched_version = await _part_range(
            ctx, v, size, part_q)
        headers.append(("x-amz-mp-parts-count", str(n_parts)))
        if size == 0:
            # a 0-byte object has no valid byte range; serve the whole
            # (empty) body like AWS instead of "bytes 0--1/0"
            rng = None
    elif req.header("range"):
        rng = parse_range(req.header("range"), size)
        if rng is None:
            return Response(416, [("content-range", f"bytes */{size}")])

    data = v.state.data
    if data.kind == "inline":
        payload = (sse_key.decrypt_block(data.blob)
                   if sse_key is not None else data.blob)
        if rng is not None:
            start, end = rng
            headers.append(("content-range",
                            f"bytes {start}-{end - 1}/{size}"))
            if head:
                headers.append(("content-length", str(end - start)))
                return Response(206, headers)
            return Response(206, headers, payload[start:end])
        if head:
            headers.append(("content-length", str(len(payload))))
            return Response(200, headers)
        return Response(200, headers, payload)

    version = (prefetched_version if prefetched_version is not None
               else await ctx.garage.version_table.get(v.uuid, b""))
    if version is None:
        raise no_such_key(ctx.key)
    blocks = list(version.blocks.items())  # sorted by (part, offset)

    if head:
        if rng is not None:
            start, end = rng
            headers.append(("content-range",
                            f"bytes {start}-{end - 1}/{size}"))
            headers.append(("content-length", str(end - start)))
            return Response(206, headers)
        headers.append(("content-length", str(size)))
        return Response(200, headers)

    if rng is None:
        return Response(200, headers + [("content-length", str(size))],
                        _stream_blocks(ctx.garage, blocks, 0, size,
                                       sse_key))
    start, end = rng
    headers.append(("content-range", f"bytes {start}-{end - 1}/{size}"))
    headers.append(("content-length", str(end - start)))
    return Response(206, headers, _stream_blocks(ctx.garage, blocks,
                                                 start, end, sse_key))


async def _part_range(ctx, v, size: int, part_q: str):
    """?partNumber=N -> (byte range, part count, prefetched Version or
    None) — the Version row is returned so the block path doesn't fetch
    it a second time (ref: get.rs handle_get with part_number).
    Non-multipart objects are a single part 1 covering the whole body."""
    try:
        pn = int(part_q)
        if pn < 1:
            raise ValueError
    except ValueError:
        raise S3Error("InvalidArgument", 400, "bad partNumber")
    version = None
    if v.state.data.kind != "inline":
        version = await ctx.garage.version_table.get(v.uuid, b"")
    if version is None or not list(version.blocks.items()):
        if pn != 1:
            raise S3Error("InvalidPartNumber", 416, "no such part")
        return (0, size), 1, version
    part_sizes: dict[int, int] = {}
    for (part, _off), (_h, blen) in version.blocks.items():
        part_sizes[part] = part_sizes.get(part, 0) + blen
    parts = sorted(part_sizes)
    if pn not in part_sizes:
        raise S3Error("InvalidPartNumber", 416, "no such part")
    start = sum(part_sizes[p] for p in parts if p < pn)
    return (start, start + part_sizes[pn]), len(parts), version


async def open_object_stream(garage, src_v, start: int, end: int,
                             src_sse=None):
    """Plaintext byte-stream reader over [start, end) of an object
    version (inline or block-backed), decrypting with `src_sse` when
    given. Shared by CopyObject and UploadPartCopy (ref: copy.rs
    source-stream plumbing)."""
    from .multipart import _StreamReader
    from .xml import S3Error

    if src_v.state.data.kind == "inline":
        blob = src_v.state.data.blob
        if src_sse is not None:
            blob = src_sse.decrypt_block(blob)
        piece = blob[start:end]

        async def gen_inline():
            yield piece

        return _StreamReader(gen_inline())
    src_version = await garage.version_table.get(src_v.uuid, b"")
    if src_version is None:
        raise S3Error("NoSuchKey", 404, "source version vanished")
    blocks = list(src_version.blocks.items())
    return _StreamReader(_stream_blocks(garage, blocks, start, end,
                                        src_sse))


def _plan_blocks(blocks, start: int, end: int) -> list[tuple[bytes, int, int]]:
    """-> [(hash, lo, hi)] covering [start, end) of the concatenated
    block list. lo/hi are plaintext offsets within each block."""
    plan = []
    pos = 0
    for _key, (h, size) in blocks:
        if pos + size <= start:
            pos += size
            continue
        if pos >= end:
            break
        plan.append((h, max(0, start - pos), min(size, end - pos)))
        pos += size
    return plan


# decrypt below this size stays inline: a thread hop costs more than
# the AES-GCM call itself (matches the put path's 64 KiB hash threshold)
_DECRYPT_OFFLOAD_MIN = 64 * 1024


def _slice(data, lo: int, hi: int):
    """Zero-copy body slice: a partial block is served through a
    memoryview instead of materializing a fresh bytes object (the HTTP
    writer accepts any bytes-like)."""
    if lo == 0 and hi >= len(data):
        return data
    return memoryview(data)[lo:hi]


async def _stream_blocks(garage, blocks, start: int, end: int,
                         sse_key=None) -> AsyncIterator[bytes]:
    """Stream [start, end) of the concatenated block list
    (ref: get.rs body_from_blocks_range + the ordered readahead buffer
    it feeds). Block sizes in the version map are plaintext sizes; with
    `sse_key` each fetched block is decrypted before slicing, so ranges
    address plaintext offsets.

    Readahead: up to `[s3_api] get_readahead_blocks` blocks beyond the
    one currently being streamed are fetched concurrently with
    asyncio.create_task, and yielded strictly in order — the next
    block(s) ride the wire while the current one drains to the client,
    so GET throughput is no longer one-block-RTT-at-a-time.
    Per-block failover lives inside rpc_get_block and is unchanged; a
    block that fails on every holder fails the stream exactly where the
    sequential loop would have. Client disconnects close this generator
    (http.write_response calls aclose), whose finally block cancels
    every in-flight prefetch — no orphaned tasks.
    get_readahead_blocks = 0 reproduces the sequential behavior."""
    plan = _plan_blocks(blocks, start, end)
    depth = getattr(garage.config, "s3_get_readahead_blocks", 3)

    # SSE-C blocks are excluded from the hot-block read cache: the
    # payload is ciphertext the node can only decrypt while the
    # client's key is in hand — never keep it in RAM past the request
    cacheable = sse_key is None

    if depth <= 0:
        # strictly sequential fallback switch
        for h, lo, hi in plan:
            data = await garage.block_manager.rpc_get_block(
                h, cacheable=cacheable)
            if sse_key is not None:
                data = sse_key.decrypt_block(data)
            yield _slice(data, lo, hi)
        return

    async def fetch(h):
        data = await garage.block_manager.rpc_get_block(
            h, cacheable=cacheable)
        if sse_key is not None:
            # AES-GCM releases the GIL; MiB-scale blocks decrypt in a
            # worker thread so the loop keeps serving other requests.
            # Decrypting inside the prefetch task (not at yield time)
            # overlaps decrypt with the wire, and ordered yields keep
            # the plaintext sequence correct regardless of which
            # prefetch finishes first.
            if len(data) >= _DECRYPT_OFFLOAD_MIN:
                data = await asyncio.to_thread(sse_key.decrypt_block, data)
            else:
                data = sse_key.decrypt_block(data)
        return data

    window: deque[asyncio.Task] = deque()
    nxt = 0  # next plan index to schedule
    try:
        while nxt < len(plan) or window:
            # current block + `depth` ahead may be in flight at once
            while nxt < len(plan) and len(window) < depth + 1:
                window.append(asyncio.create_task(fetch(plan[nxt][0])))
                nxt += 1
            _h, lo, hi = plan[nxt - len(window)]
            # await while the task is STILL in the window: if this
            # generator itself is cancelled mid-await, the task must
            # remain reachable by the finally below or it leaks
            data = await window[0]
            window.popleft()
            yield _slice(data, lo, hi)
    finally:
        # client went away (or a fetch failed): cancel synchronously
        # first so nothing new starts, then settle the tasks so no
        # "exception was never retrieved" noise outlives the request
        for t in window:
            t.cancel()
        if window:
            await asyncio.gather(*window, return_exceptions=True)
