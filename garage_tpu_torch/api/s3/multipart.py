"""Multipart upload endpoints (ported from the JAX package's
api/s3/multipart.py).

Ref parity: src/api/s3/multipart.rs:36-506. Create registers an
Uploading{multipart} object version + MPU row; each part gets its own
Version (keyed by a fresh uuid) whose blocks it streams; Complete
validates the client's part list against stored parts, splices all part
versions into one final Version (renumbered by part), and writes the
Complete object; Abort tombstones.

What differs from the JAX package: the three handlers of an upload are
traced, each under one span around its whole body: `s3.mpu.create`,
`s3.mpu.put_part` (attrs `part`, `size`: the part number and its body's
bytes) and `s3.mpu.complete` (attrs `parts`, `blocks`), with
`s3.mpu.ref_repoint` (attr `blocks`) around the Complete's loop that
re-points each block's ref to the final version. Attrs learnt inside a
handler are set on the span's dict when they are known.
"""

from __future__ import annotations

import hashlib
import logging

from ...model.s3.block_ref_table import BlockRef
from ...model.s3.mpu_table import MpuPart, MultipartUpload, MultipartUploadTable
from ...model.s3.object_table import (Object, ObjectVersion,
                                      ObjectVersionData, ObjectVersionMeta,
                                      ObjectVersionState)
from ...model.s3.version_table import BACKLINK_MPU, BACKLINK_OBJECT, Version
from ...utils.crdt import now_msec
from ...utils.data import gen_uuid
from ...utils.tracing import span
from ..http import Request, Response
from .put import Chunker, extract_metadata_headers, read_and_put_blocks
from .xml import S3Error, xml, xml_response

log = logging.getLogger("garage_tpu_torch.api.s3.multipart")


class _UploadMeta:
    """Adapter exposing an uploading version's headers dict with the
    `.headers` attribute check_key_for_meta expects."""

    __slots__ = ("headers",)

    def __init__(self, headers: dict):
        self.headers = headers


async def _get_upload(ctx, upload_id_hex: str):
    """-> (mpu, object_version) or raises NoSuchUpload
    (ref: multipart.rs get_upload)."""
    try:
        uid = bytes.fromhex(upload_id_hex)
        if len(uid) != 32:
            raise ValueError
    except ValueError:
        raise S3Error("NoSuchUpload", 404, upload_id_hex)
    mpu = await ctx.garage.mpu_table.get(uid, b"")
    obj = await ctx.garage.object_table.get(ctx.bucket_id,
                                            ctx.key.encode())
    ov = obj.version(uid) if obj is not None else None
    if (mpu is None or mpu.is_tombstone() or ov is None
            or not ov.is_uploading(check_multipart=True)):
        raise S3Error("NoSuchUpload", 404, upload_id_hex)
    return mpu, ov


async def handle_create_multipart(ctx, req: Request) -> Response:
    """ref: multipart.rs handle_create_multipart_upload."""
    async with span("s3.mpu.create"):
        return await _create_multipart(ctx, req)


async def _create_multipart(ctx, req: Request) -> Response:
    from .encryption import META_SSEC_ALGO, META_SSEC_MD5, request_sse_key

    await req.body.drain()
    headers = extract_metadata_headers(req)
    sse_key = request_sse_key(req)
    if sse_key is not None:
        headers = {**headers, META_SSEC_ALGO: "AES256",
                   META_SSEC_MD5: sse_key.md5_b64}
    uuid = gen_uuid()
    ts = now_msec()
    obj = Object(ctx.bucket_id, ctx.key, [ObjectVersion(
        uuid, ts, ObjectVersionState.uploading(headers, multipart=True))])
    await ctx.garage.object_table.insert(obj)
    mpu = MultipartUpload.new(uuid, ts, ctx.bucket_id, ctx.key)
    await ctx.garage.mpu_table.insert(mpu)
    return xml_response(xml("InitiateMultipartUploadResult",
                            xml("Bucket", ctx.bucket_name),
                            xml("Key", ctx.key),
                            xml("UploadId", uuid.hex())))


async def handle_put_part(ctx, req: Request) -> Response:
    """ref: multipart.rs handle_put_part."""
    async with span("s3.mpu.put_part") as sp:
        return await _put_part(ctx, req, sp.attrs)


async def _put_part(ctx, req: Request, attrs: dict) -> Response:
    q = req.query
    try:
        part_number = int(q["partNumber"])
        if not (1 <= part_number <= 10000):
            raise ValueError
    except (KeyError, ValueError):
        raise S3Error("InvalidArgument", 400, "bad partNumber")
    attrs["part"] = part_number
    mpu, ov = await _get_upload(ctx, q.get("uploadId", ""))

    # validate headers BEFORE inserting any rows — a 400 here must not
    # leak an uploading version/part placeholder
    from ..checksum import Checksummer, request_checksum_value
    from .encryption import check_key_for_meta, request_sse_key

    try:
        expected_checksum = request_checksum_value(req.headers)
    except ValueError as e:
        raise S3Error("InvalidRequest", 400, str(e))
    checksummer = (Checksummer(expected_checksum[0])
                   if expected_checksum is not None else None)
    # SSE-C: the part's key must match the key declared at create time
    sse_key = check_key_for_meta(
        _UploadMeta(ov.state.headers or {}), request_sse_key(req))

    ts = mpu.next_timestamp(part_number)
    version_uuid = gen_uuid()
    # register the part (etag/size unset until data is stored)
    mpu2 = MultipartUpload.new(mpu.upload_id, mpu.timestamp,
                               ctx.bucket_id, ctx.key)
    mpu2.parts = mpu2.parts.put((part_number, ts), MpuPart(version_uuid))
    await ctx.garage.mpu_table.insert(mpu2)
    version = Version.new(version_uuid, (BACKLINK_MPU, mpu.upload_id))
    await ctx.garage.version_table.insert(version)
    # same zero-copy ingest pool as PutObject (put.save_stream): big
    # uploads arrive as parts, so UploadPart is the hotter wire path
    pool = None
    if sse_key is None:
        pool = ctx.garage.block_manager.ingest_pool(
            ctx.garage.config.block_size,
            getattr(ctx.garage.config, "s3_ingest_buffers", 0))
    chunker = Chunker(req.body, ctx.garage.config.block_size, pool=pool)
    first = await chunker.next()
    if first is None:
        raise S3Error("EntityTooSmall", 400, "empty part")
    from ... import native

    md5 = native.Md5()  # fuses with the content hash on the host route
    try:
        total, _md5_hex, etag, _first_hash = await read_and_put_blocks(
            ctx.garage, version, part_number, first, chunker, md5,
            checksummer=checksummer, sse_key=sse_key)
        if checksummer is not None \
                and checksummer.b64() != expected_checksum[1]:
            raise S3Error("BadDigest", 400, "checksum mismatch")
    except BaseException:
        if hasattr(first, "release"):
            first.release()  # idempotent: a handed-over lease already
            # went back via its put task's finally
        # interrupted part: tombstone its version so block refs get
        # dropped now instead of leaking until abort/complete
        # (ref: multipart.rs:165-258 InterruptedCleanup)
        try:
            await ctx.garage.version_table.insert(Version.new(
                version_uuid, (BACKLINK_MPU, mpu.upload_id), deleted=True))
        except Exception as e:
            log.warning("interrupted-part tombstone failed (block refs "
                        "leak until abort/complete): %s", e)
        raise
    attrs["size"] = total

    # record the finished part
    done = MultipartUpload.new(mpu.upload_id, mpu.timestamp,
                               ctx.bucket_id, ctx.key)
    done.parts = done.parts.put((part_number, ts),
                                MpuPart(version_uuid, etag, total))
    await ctx.garage.mpu_table.insert(done)
    return Response(200, [("etag", f'"{etag}"')])


class _StreamReader:
    """Adapts an async byte-chunk generator to the body-reader interface
    Chunker expects (read(n) returning b'' at EOF, never over-returning).

    Fast path: with an empty carry buffer, a generator chunk that fits
    the request passes through untouched — the GET readahead pipeline's
    blocks reach the put pipeline (CopyObject re-encryption,
    UploadPartCopy) without the old extend+slice+memmove round trip."""

    def __init__(self, gen):
        self._gen = gen
        self._buf = bytearray()
        self._eof = False

    async def read(self, n: int = 65536):
        while not self._eof and len(self._buf) < n:
            try:
                chunk = await self._gen.__anext__()
            except StopAsyncIteration:
                self._eof = True
                break
            if chunk and not self._buf and len(chunk) <= n:
                return chunk  # zero-copy pass-through
            self._buf.extend(chunk)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def aclose(self) -> None:
        aclose = getattr(self._gen, "aclose", None)
        if aclose is not None:
            await aclose()


async def handle_upload_part_copy(ctx, req: Request) -> Response:
    """UploadPartCopy: fill a part from (a range of) an existing object
    (ref: api/s3/copy.rs:340-520 handle_upload_part_copy). The source
    streams through the normal put pipeline — re-chunked and, when the
    upload is SSE-C, re-encrypted under the destination key — so any
    source range and any encryption combination is correct; aligned
    whole-block reuse is left to CopyObject."""
    from urllib.parse import unquote

    from ...model.helper import GarageHelper
    from .encryption import (check_key_for_meta, copy_source_sse_key,
                             request_sse_key)
    from .get import parse_range

    q = req.query
    try:
        part_number = int(q["partNumber"])
        if not (1 <= part_number <= 10000):
            raise ValueError
    except (KeyError, ValueError):
        raise S3Error("InvalidArgument", 400, "bad partNumber")
    mpu, ov = await _get_upload(ctx, q.get("uploadId", ""))
    dst_sse = check_key_for_meta(_UploadMeta(ov.state.headers or {}),
                                 request_sse_key(req))

    src = unquote(req.header("x-amz-copy-source") or "").lstrip("/")
    src_bucket_name, _, src_key = src.partition("/")
    if not src_bucket_name or not src_key:
        raise S3Error("InvalidRequest", 400,
                      "malformed x-amz-copy-source")
    helper = GarageHelper(ctx.garage)
    src_bucket_id = await helper.resolve_global_bucket_name(src_bucket_name)
    if src_bucket_id is None:
        raise S3Error("NoSuchBucket", 404, src_bucket_name)
    if not ctx.api_key.allow_read(src_bucket_id):
        raise S3Error("AccessDenied", 403, "no read access to source")
    src_obj = await ctx.garage.object_table.get(src_bucket_id,
                                                src_key.encode())
    src_v = src_obj.last_data() if src_obj is not None else None
    if src_v is None:
        raise S3Error("NoSuchKey", 404, src_key)
    src_meta = src_v.state.data.meta
    from .get import check_copy_source_preconditions

    check_copy_source_preconditions(req, src_v, src_meta.etag)
    src_sse = check_key_for_meta(src_meta, copy_source_sse_key(req))

    size = src_meta.size
    start, end = 0, size
    range_hdr = req.header("x-amz-copy-source-range")
    if range_hdr:
        rng = parse_range(range_hdr, size)
        if rng is None:
            raise S3Error("InvalidRange", 416, "bad copy source range")
        start, end = rng
    # validate BEFORE inserting any rows — emptiness is knowable now
    if end - start == 0:
        raise S3Error("InvalidRequest", 400, "empty copy source range")
    from .get import open_object_stream

    source = await open_object_stream(ctx.garage, src_v, start, end,
                                      src_sse)

    await req.body.drain()
    ts = mpu.next_timestamp(part_number)
    version_uuid = gen_uuid()
    mpu2 = MultipartUpload.new(mpu.upload_id, mpu.timestamp,
                               ctx.bucket_id, ctx.key)
    mpu2.parts = mpu2.parts.put((part_number, ts), MpuPart(version_uuid))
    await ctx.garage.mpu_table.insert(mpu2)
    version = Version.new(version_uuid, (BACKLINK_MPU, mpu.upload_id))
    await ctx.garage.version_table.insert(version)

    from ... import native

    md5 = native.Md5()
    try:
        chunker = Chunker(source, ctx.garage.config.block_size)
        first = await chunker.next()
        if first is None:
            raise S3Error("InvalidRequest", 400, "empty copy source")
        total, _md5_hex, etag, _ = await read_and_put_blocks(
            ctx.garage, version, part_number, first, chunker, md5,
            sse_key=dst_sse)
    except BaseException:
        try:
            await ctx.garage.version_table.insert(Version.new(
                version_uuid, (BACKLINK_MPU, mpu.upload_id),
                deleted=True))
        except Exception as e:
            log.warning("interrupted-copy tombstone failed (block refs "
                        "leak until abort/complete): %s", e)
        raise
    finally:
        # an aborted copy must cancel the source's readahead prefetches
        # now, not at GC time
        await source.aclose()

    done = MultipartUpload.new(mpu.upload_id, mpu.timestamp,
                               ctx.bucket_id, ctx.key)
    done.parts = done.parts.put((part_number, ts),
                                MpuPart(version_uuid, etag, total))
    await ctx.garage.mpu_table.insert(done)
    from .put import _http_date

    return xml_response(xml("CopyPartResult",
                            xml("LastModified", _http_date(now_msec())),
                            xml("ETag", f'"{etag}"')))


async def handle_complete_multipart(ctx, req: Request) -> Response:
    """ref: multipart.rs handle_complete_multipart_upload."""
    async with span("s3.mpu.complete") as sp:
        return await _complete_multipart(ctx, req, sp.attrs)


async def _complete_multipart(ctx, req: Request, attrs: dict) -> Response:
    import xml.etree.ElementTree as ET

    body = await req.body.read_all(limit=1 << 20)
    try:
        root = ET.fromstring(body.decode())
    except ET.ParseError:
        raise S3Error("MalformedXML", 400, "cannot parse request")
    asked = []  # [(part_number, etag)]
    for part in root:
        if not part.tag.endswith("Part"):
            continue
        pn = etag = None
        for c in part:
            if c.tag.endswith("PartNumber"):
                pn = int(c.text)
            elif c.tag.endswith("ETag"):
                etag = (c.text or "").strip().strip('"')
        if pn is not None:
            asked.append((pn, etag))
    if not asked or asked != sorted(asked, key=lambda x: x[0]) \
            or len({p for p, _ in asked}) != len(asked):
        raise S3Error("InvalidPartOrder", 400,
                      "parts must be ordered and unique")

    upload_id = req.query.get("uploadId", "")
    mpu, ov = await _get_upload(ctx, upload_id)

    # newest stored record per part number that has completed
    stored = {}
    for (pn, ts), part in mpu.parts.items():
        if part.etag is not None:
            if pn not in stored or ts > stored[pn][0]:
                stored[pn] = (ts, part)
    parts = []
    for pn, etag in asked:
        if pn not in stored or (etag and stored[pn][1].etag != etag):
            raise S3Error("InvalidPart", 400, f"part {pn} not found")
        parts.append((pn, stored[pn][1]))
    attrs["parts"] = len(parts)

    # splice all part versions into the final object version
    # (ref: multipart.rs:260-330)
    final = Version.new(ov.uuid, (BACKLINK_OBJECT, ctx.bucket_id, ctx.key))
    total_size = 0
    etag_md5 = hashlib.md5()
    for pn, part in parts:
        pv = await ctx.garage.version_table.get(part.version, b"")
        if pv is None or pv.is_tombstone():
            raise S3Error("InvalidPart", 400, f"part {pn} lost")
        for (_p, off), (h, sz) in pv.blocks.items():
            final = Version(final.uuid, final.deleted,
                            final.blocks.put((pn, off), (h, sz)),
                            final.backlink)
            total_size += sz
        etag_md5.update(bytes.fromhex(part.etag))
    attrs["blocks"] = n_blocks = len(final.blocks)
    # quotas are enforced at completion, when the real total is known
    # (ref: multipart.rs handle_complete_multipart_upload check_quotas)
    from .put import check_quotas

    existing = await ctx.garage.object_table.get(ctx.bucket_id,
                                                 ctx.key.encode())
    await check_quotas(ctx.garage, ctx.bucket_id, total_size, existing)
    await ctx.garage.version_table.insert(final)
    # re-point block refs from part versions to the final version
    async with span("s3.mpu.ref_repoint", blocks=n_blocks):
        for pn, part in parts:
            pv = await ctx.garage.version_table.get(part.version, b"")
            for _k, (h, _s) in pv.blocks.items():
                await ctx.garage.block_ref_table.insert(
                    BlockRef.new(h, ov.uuid))

    etag = f"{etag_md5.hexdigest()}-{len(parts)}"
    headers = (ov.state.headers if ov.state.kind == "uploading" else {})
    meta = ObjectVersionMeta(headers, total_size, etag)
    first_hash = next(iter([h for _k, (h, _s) in final.blocks.items()]),
                      b"\x00" * 32)
    done = Object(ctx.bucket_id, ctx.key, [ObjectVersion(
        ov.uuid, ov.timestamp,
        ObjectVersionState.complete(
            ObjectVersionData.first_block(meta, first_hash)))])
    await ctx.garage.object_table.insert(done)
    return xml_response(xml("CompleteMultipartUploadResult",
                            xml("Bucket", ctx.bucket_name),
                            xml("Key", ctx.key),
                            xml("ETag", f'"{etag}"')))


async def handle_abort_multipart(ctx, req: Request) -> Response:
    """ref: multipart.rs handle_abort_multipart_upload."""
    upload_id = req.query.get("uploadId", "")
    mpu, ov = await _get_upload(ctx, upload_id)
    aborted = Object(ctx.bucket_id, ctx.key, [ObjectVersion(
        ov.uuid, ov.timestamp, ObjectVersionState.aborted())])
    await ctx.garage.object_table.insert(aborted)
    return Response(204)
