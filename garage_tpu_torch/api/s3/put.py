"""PutObject / CopyObject: the hot write path (ported from the JAX
package's api/s3/put.py).

Ref parity: src/api/s3/put.rs:60-640. save_stream chunks the body at
block_size, inlines tiny objects (< 3072 B) into the object row, and
otherwise pipelines: read chunk -> md5+blake2 hash -> put block + meta
(≤ 3 concurrent), exactly the reference's staged pipeline. The TPU batch
plane hooks in at BlockManager (hashing/erasure batching happen below
this layer).

What differs from the JAX package: when the object-table lookup that
runs beside the first block's read fails (a 503 while a node or a
gateway worker has not yet reached its peers), the first block's ingest
lease goes back to the pool. The JAX package's text leaves it leased,
and once all `[s3_api] ingest_buffers` have leaked that way every later
PUT of the process waits for a lease forever.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
from typing import Optional

from ...block.manager import INLINE_THRESHOLD
from ...model.s3.block_ref_table import BlockRef
from ...model.s3.object_table import (Object, ObjectVersion,
                                      ObjectVersionData, ObjectVersionMeta,
                                      ObjectVersionState,
                                      object_upload_version)
from ...model.s3.version_table import BACKLINK_OBJECT, Version
from ...utils.crdt import now_msec
from ...utils.data import gen_uuid
from ...utils.metrics import registry
from ..http import Request, Response
from .xml import S3Error, bad_request

log = logging.getLogger("garage_tpu_torch.api.s3.put")

# default concurrent block writes in the put pipeline (ref: put.rs:42);
# the live value comes from `[s3_api] put_blocks_max_parallel`
# (config.s3_put_blocks_max_parallel), runtime-tunable via admin
# POST /v1/s3/tuning so the bench can sweep it
PUT_BLOCKS_MAX_PARALLEL = 3
_MULTICORE = (os.cpu_count() or 1) > 1


def put_parallelism(garage) -> int:
    v = getattr(garage.config, "s3_put_blocks_max_parallel",
                PUT_BLOCKS_MAX_PARALLEL)
    return max(1, int(v or PUT_BLOCKS_MAX_PARALLEL))


class Chunker:
    """Re-chunk a body reader into block_size blocks
    (ref: put.rs StreamChunker). Asking the reader for exactly the
    missing byte count (read() never over-returns) means blocks
    assemble with ONE join copy — zero when a read yields the whole
    block — instead of the old bytearray extend+slice+memmove trio,
    which was a measurable share of the one-core PUT path.

    With `pool` (a hostbuf.HostBufPool — the zero-copy ingest path,
    an earlier change), full blocks land DIRECTLY in a leased stripe-layout
    buffer via the reader's readinto1 and next() returns the
    BlockLease; partial tail blocks (and readers without readinto1)
    degrade to bytes through the classic path. The CALLER owns each
    returned lease and must release it."""

    def __init__(self, body, block_size: int, shape=None, pool=None):
        self.body = body
        self.block_size = block_size
        self.eof = False
        # qos byte-shaper (async callable) for bodies whose length was
        # unknown at admission time — see qos.QosEngine.shape_bytes
        self.shape = shape
        self.pool = pool
        self._rest = b""  # overshoot carry (AwsChunkedReader returns
        # whole decoded client chunks, ignoring the requested size)

    async def next(self):
        if self.pool is not None:
            return await self._next_lease()
        return await self._next_bytes()

    async def _next_lease(self):
        """Fill a leased buffer in place. Returns the lease (full
        block), bytes (the sub-block tail — its true shard length
        differs, so it takes the classic staging path), or None."""
        if self.eof and not self._rest:
            return None
        lease = await self.pool.acquire()
        mv = lease.body_mv()
        have = 0
        try:
            if self._rest:
                # a carry only exists after a readinto1-less fallback
                # read over-returned; land it first (counted: it IS a
                # copy into the buffer)
                r = self._rest
                n = min(len(r), self.block_size)
                mv[:n] = r[:n]
                registry().inc("s3_put_copy_bytes", n, path="assemble")
                self._rest = r[n:] if n < len(r) else b""
                have = n
            readinto = getattr(self.body, "readinto1", None)
            while not self.eof and have < self.block_size:
                if readinto is not None:
                    n = await readinto(mv[have:self.block_size])
                    if not n:
                        self.eof = True
                        break
                    have += n
                else:
                    chunk = await self.body.read(self.block_size - have)
                    if not chunk:
                        self.eof = True
                        break
                    fit = min(len(chunk), self.block_size - have)
                    mv[have:have + fit] = chunk[:fit]
                    registry().inc("s3_put_copy_bytes", fit,
                                   path="ingest")
                    if fit < len(chunk):
                        self._rest = chunk[fit:]
                    have += fit
            if not have:
                lease.release()
                return None
            if self.shape is not None:
                await self.shape(have)
            if have == self.block_size:
                lease.length = have
                out, lease = lease, None  # ownership moves to the caller
                return out
            # tail block: materialize once and recycle the buffer
            out = bytes(mv[:have])
            registry().inc("s3_put_copy_bytes", have, path="assemble")
            return out
        finally:
            if lease is not None:
                lease.release()

    async def _next_bytes(self) -> Optional[bytes]:
        chunks: list = []
        have = 0
        if self._rest:
            chunks.append(self._rest)
            have = len(self._rest)
            self._rest = b""
        while not self.eof and have < self.block_size:
            chunk = await self.body.read(self.block_size - have)
            if not chunk:
                self.eof = True
                break
            chunks.append(chunk)
            have += len(chunk)
            # every read() materializes fresh bytes between the socket
            # and the block — the copy the leased path deletes
            registry().inc("s3_put_copy_bytes", len(chunk), path="read")
        if not have:
            return None
        whole = chunks[0] if len(chunks) == 1 else b"".join(chunks)
        if len(chunks) > 1:
            registry().inc("s3_put_copy_bytes", len(whole),
                           path="assemble")
        if have > self.block_size:
            # memoryview carry: the overshoot (an AwsChunkedReader can
            # return a many-MiB client chunk) is carried as a zero-copy
            # view over `whole`; the old bytes-slice pair copied both
            # halves of every oversized chunk. The view is materialized
            # exactly once, when it lands in a returned block below.
            mv = memoryview(whole)
            self._rest = mv[self.block_size:]
            whole = mv[:self.block_size]
        if self.shape is not None:
            await self.shape(len(whole))
        # downstream (hashing, encryption, the block RPC) expects real
        # bytes; a view materializes here — ONE copy per block total
        if not isinstance(whole, bytes):
            registry().inc("s3_put_copy_bytes", len(whole),
                           path="assemble")
            whole = bytes(whole)
        return whole


def extract_metadata_headers(req: Request) -> dict:
    """content-type + x-amz-meta-* + standard overridable headers
    (ref: put.rs get_headers)."""
    out = {}
    for h in ("content-type", "content-encoding", "content-language",
              "content-disposition", "cache-control", "expires"):
        v = req.header(h)
        if v is not None:
            out[h] = v
    for name, v in req.headers.items():
        if name.startswith("x-amz-meta-"):
            out[name] = v
    redir = req.header("x-amz-website-redirect-location")
    if redir is not None:
        # ref: put.rs:681-692 — stored as metadata; the web server
        # serves a 301 to it
        if not redir.startswith(("/", "http://", "https://")):
            raise bad_request(
                "Invalid x-amz-website-redirect-location header")
        out["x-amz-website-redirect-location"] = redir
    return out


def next_timestamp(existing: Optional[Object]) -> int:
    """ref: put.rs next_timestamp — strictly after any existing
    version."""
    now = now_msec()
    if existing is None or not existing.versions:
        return now
    return max(now, max(v.timestamp for v in existing.versions) + 1)


async def get_bucket_quotas(garage, bucket_id: bytes) -> dict:
    bucket = await garage.bucket_table.get(bucket_id, b"")
    params = bucket.params if bucket is not None else None
    return (params.quotas.value if params is not None else None) or {}


async def check_quotas(garage, bucket_id: bytes,
                       size_hint: Optional[int], existing,
                       quotas: Optional[dict] = None) -> None:
    """Reject when this upload would exceed the bucket's quotas
    (ref: src/api/s3/put.rs check_quotas). Every write path (put, copy,
    post_object, multipart complete) enforces the same rule: once early
    with the declared length, and again after streaming with the REAL
    total (a spoofed or missing length header must not bypass the size
    quota). `size_hint` None = unknown: only the object-count quota can
    be checked; replacing an object frees its current size."""
    q = quotas if quotas is not None \
        else await get_bucket_quotas(garage, bucket_id)
    max_size, max_objects = q.get("max_size"), q.get("max_objects")
    if max_size is None and max_objects is None:
        return
    nodes = list(
        garage.system.layout_manager.history.all_nongateway_nodes())
    counters = await garage.object_counter.read(bucket_id, b"", nodes)
    replaced = existing.last_data() if existing is not None else None
    if max_objects is not None and replaced is None:
        if counters.get("objects", 0) + 1 > max_objects:
            raise S3Error("AccessDenied", 403,
                          "Object quota is reached on this bucket")
    if max_size is not None and size_hint is not None:
        freed = replaced.state.data.meta.size if replaced is not None else 0
        if counters.get("bytes", 0) - freed + size_hint > max_size:
            raise S3Error("AccessDenied", 403,
                          "Bucket size quota is reached")


async def save_stream(garage, bucket_id: bytes, key: str, headers: dict,
                      body, content_md5: Optional[str] = None,
                      expected_checksum: Optional[tuple[str, str]] = None,
                      sse_key=None,
                      content_length: Optional[int] = None,
                      quotas: Optional[dict] = None):
    """-> (version_uuid, version_timestamp, etag, total_size).
    ref: put.rs:122-330 save_stream. `expected_checksum` is a declared
    (algo, base64-value) x-amz-checksum-* header to enforce; `sse_key`
    is an SSE-C customer key — blocks (and inline payloads) are stored
    AES-GCM encrypted, metadata records only the key's MD5."""
    checksummer = None
    if expected_checksum is not None:
        from ..checksum import Checksummer

        checksummer = Checksummer(expected_checksum[0])
    if sse_key is not None:
        from .encryption import META_SSEC_ALGO, META_SSEC_MD5

        headers = {**headers, META_SSEC_ALGO: "AES256",
                   META_SSEC_MD5: sse_key.md5_b64}
    if expected_checksum is not None:
        # persist the validated checksum so GET/HEAD can return it
        # under x-amz-checksum-mode: ENABLED (ref: checksum.rs storage)
        headers = {**headers,
                   f"x-garage-checksum-{expected_checksum[0]}":
                       expected_checksum[1]}
    from ...utils.tracing import span

    block_size = garage.config.block_size
    # bodies that declared a length were charged to the qos bytes
    # bucket at admission; unknown-length (chunked) bodies are shaped
    # per-block here instead, so neither path double-charges
    qos = getattr(garage, "qos", None)
    shape = (qos.shape_bytes if qos is not None
             and content_length is None else None)
    # zero-copy ingest pool: erasure-mode plaintext PUTs
    # land full blocks straight into stripe-layout lease buffers.
    # SSE-C keeps the classic path — encryption rewrites every byte
    # anyway, so in-place staging buys nothing there.
    pool = None
    if sse_key is None:
        pool = garage.block_manager.ingest_pool(
            block_size, getattr(garage.config, "s3_ingest_buffers", 0))
    chunker = Chunker(body, block_size, shape=shape, pool=pool)
    async with span("s3.put.first_read_and_lookup"):
        first_block, existing = await asyncio.gather(
            chunker.next(), garage.object_table.get(bucket_id, key.encode()),
            return_exceptions=True)
    failed = [r for r in (first_block, existing)
              if isinstance(r, BaseException)]
    if failed:
        # either half failed: the other half's lease goes back
        if hasattr(first_block, "release"):
            first_block.release()
        raise failed[0]
    try:
        if quotas is None:  # callers with a loaded ReqCtx pass them in
            quotas = await get_bucket_quotas(garage, bucket_id)
        await check_quotas(garage, bucket_id, content_length, existing,
                           quotas=quotas)
    except BaseException:
        # a leased first block must go back to the pool on ANY early
        # exit (quota reached, table error) — release is idempotent,
        # so later owners double-releasing is harmless
        if hasattr(first_block, "release"):
            first_block.release()
        raise
    first_block = first_block or b""
    if hasattr(first_block, "release") \
            and len(first_block) < INLINE_THRESHOLD:
        # only reachable with a sub-threshold block_size: the inline
        # branch stores bytes, so materialize and recycle the lease
        _l = first_block
        first_block = bytes(_l.view())
        _l.release()
    uuid = gen_uuid()
    ts = next_timestamp(existing)
    from ... import native

    md5 = native.Md5()  # hashlib fallback inside when no native lib

    if len(first_block) < INLINE_THRESHOLD:
        if content_length != len(first_block):
            # declared length absent or wrong (spoofed
            # x-amz-decoded-content-length): enforce on the actual size
            await check_quotas(garage, bucket_id, len(first_block),
                               existing, quotas=quotas)
        md5.update(first_block)
        etag = md5.hexdigest()
        if content_md5 is not None and not _md5_matches(content_md5, etag):
            raise bad_request("Content-MD5 mismatch")
        if checksummer is not None:
            # lint: ignore[GL10] first update may lazily build+dlopen the native CRC lib (one-time, lock-guarded); steady state is an in-memory table update
            checksummer.update(first_block)
            if checksummer.b64() != expected_checksum[1]:
                raise bad_request("checksum mismatch")
        if sse_key is not None:
            # never record/expose the plaintext MD5 of an encrypted
            # object: a queryable plaintext digest lets any reader
            # dictionary-attack SSE-C content (ref: encryption.rs:210)
            etag = ssec_etag()
        meta = ObjectVersionMeta(headers, len(first_block), etag)
        blob = (sse_key.encrypt_block(first_block) if sse_key is not None
                else first_block)
        ov = ObjectVersion(uuid, ts, ObjectVersionState.complete(
            ObjectVersionData.inline(meta, blob)))
        await garage.object_table.insert(Object(bucket_id, key, [ov]))
        return uuid, ts, etag, len(first_block)

    try:
        # register the upload, then stream blocks
        up = Object(bucket_id, key, [ObjectVersion(
            uuid, ts,
            ObjectVersionState.uploading(headers, multipart=False))])
        await garage.object_table.insert(up)
        version = Version.new(uuid, (BACKLINK_OBJECT, bucket_id, key))
        await garage.version_table.insert(version)

        total, md5_hex, etag, first_hash = await read_and_put_blocks(
            garage, version, 1, first_block, chunker, md5,
            checksummer=checksummer, sse_key=sse_key)
        if total != content_length:
            # the declared length was wrong or absent (spoofed
            # x-amz-decoded-content-length, form upload with no length):
            # re-check the size quota with the REAL streamed total
            await check_quotas(garage, bucket_id, total, existing,
                               quotas=quotas)
        if content_md5 is not None \
                and not _md5_matches(content_md5, md5_hex):
            raise bad_request("Content-MD5 mismatch")
        if checksummer is not None \
                and checksummer.b64() != expected_checksum[1]:
            raise bad_request("checksum mismatch")
        meta = ObjectVersionMeta(headers, total, etag)
        done = Object(bucket_id, key, [ObjectVersion(
            uuid, ts, ObjectVersionState.complete(
                ObjectVersionData.first_block(meta, first_hash)))])
        await garage.object_table.insert(done)
        return uuid, ts, etag, total
    except BaseException:
        if hasattr(first_block, "release"):
            first_block.release()  # idempotent (see above)
        # interrupted upload: mark aborted so refs get cleaned up
        # (ref: put.rs InterruptedCleanup)
        try:
            await garage.object_table.insert(Object(bucket_id, key, [
                ObjectVersion(uuid, ts, ObjectVersionState.aborted())]))
        except Exception as e:
            log.warning("aborted-upload marker failed (refs leak until "
                        "repair): %s", e)
        raise


def ssec_etag() -> str:
    """Random ETag for SSE-C objects (ref: encryption.rs:210-222) —
    32 hex chars so complete-multipart's bytes.fromhex still works."""
    import os

    return os.urandom(16).hex()


def _md5_matches(content_md5_b64: str, etag_hex: str) -> bool:
    import base64

    try:
        return base64.b64decode(content_md5_b64).hex() == etag_hex
    except Exception:
        return False


async def read_and_put_blocks(garage, version: Version, part_number: int,
                              first_block: bytes, chunker: Chunker, md5,
                              checksummer=None, sse_key=None):
    """The staged put pipeline (ref: put.rs:378-530): ≤3 concurrent
    block writes; version + block_ref rows inserted alongside each
    block. With `sse_key`, blocks are AES-GCM encrypted before hashing
    and storage (the content address covers the ciphertext, so scrub
    verifies without the key); the version's block map keeps PLAINTEXT
    sizes so range reads address plaintext offsets.

    -> (total_size, md5_hex, etag, first_hash). `md5_hex` is the
    plaintext MD5 for Content-MD5 validation only; `etag` is what may
    be stored/exposed — randomized here, structurally, whenever
    sse_key is set (ref: encryption.rs:210-222), so no call site can
    forget and leak the plaintext digest."""
    max_parallel = put_parallelism(garage)
    sem = asyncio.Semaphore(max_parallel)
    tasks: list[asyncio.Task] = []
    offset = 0
    first_hash = None
    block = first_block
    # rows THIS request enqueued, per table: the targeted flush
    # probes only keys that can exist in that table's queue
    queued_vkeys: set[bytes] = set()
    queued_bkeys: set[bytes] = set()

    async def put_one(blk, off: int, plain_len: int, h: bytes):
        """`blk` is bytes or a BlockLease (zero-copy path). This task
        owns a lease once created: release rides its finally, which
        runs on success, failure AND cancellation."""
        from ...utils.tracing import span

        try:
            async with sem, span("s3.put.block", offset=off,
                                 size=len(blk)):
                v = Version(version.uuid, version.deleted,
                            version.blocks.put((part_number, off),
                                               (h, plain_len)),
                            version.backlink)
                # version/block_ref rows ride the LOCAL insert queue
                # (ONE tiny db tx for both rows) instead of two quorum
                # RPCs per block — the reference's structure
                # (put.rs:545); read_and_put_blocks flushes the queues
                # through the quorum path before the caller commits the
                # Complete row, so read-your-writes is preserved
                from ...table.table import queue_insert_local_many

                # lint: ignore[GL10] measured: this deliberately tiny two-row tx (see comment above) costs less than the to_thread handoff on the per-block PUT path
                vk, bk = queue_insert_local_many([
                    (garage.version_table, v),
                    (garage.block_ref_table, BlockRef.new(h, version.uuid)),
                ])
                queued_vkeys.add(vk)
                queued_bkeys.add(bk)
                # SSE-C blocks are never cached (cacheable=False): the
                # stored payload is ciphertext tied to the client's key
                await garage.block_manager.rpc_put_block(
                    h, blk,
                    compress=False if sse_key is not None else None,
                    cacheable=sse_key is None)
        finally:
            if hasattr(blk, "release"):
                blk.release()

    from ...utils.tracing import span

    # plaintext MD5 (ETag chain) fuses with the content hash in one
    # native pass when there is no SSE boundary (md5 covers plaintext,
    # the content hash ciphertext, so encryption forces two walks)
    fused = sse_key is None and getattr(md5, "fused", False)
    feeder = garage.block_manager.feeder
    # active-stream mark (fused streams only: SSE/non-native streams
    # never submit hash_md5, so counting them would make the dispatcher
    # wait for lanes that cannot arrive): sizes the feeder's gather
    # window for the 8-way cross-request MD5
    if fused:
        feeder.active_streams += 1
    try:
        while block is not None:
            # a leased block is read EVERYWHERE below through a view
            # over the pinned buffer — digests, checksums and the
            # feeder all walk the same memory the socket filled
            data = block.view() if hasattr(block, "view") else block
            # md5 (ETag) and the declared checksum are independent
            # digests of the same block: run them concurrently in
            # worker threads (both release the GIL) so the cost is
            # max(), not sum(); on multicore the loop keeps serving
            # other requests meanwhile
            jobs = []
            if not fused:
                if _MULTICORE and len(block) >= 65536:
                    jobs.append(asyncio.to_thread(md5.update, data))
                else:
                    md5.update(data)
            if checksummer is not None:
                jobs.append(asyncio.to_thread(checksummer.update, data))
            if jobs:
                await asyncio.gather(*jobs)
            plain_len = len(block)
            stored = (await asyncio.to_thread(sse_key.encrypt_block, block)
                      if sse_key is not None else block)
            async with span("s3.put.hash", size=plain_len
                            if stored is block else len(stored)):
                if fused:
                    h = await garage.block_manager.hash_block_md5(data, md5)
                else:
                    h = await garage.block_manager.hash_block(
                        data if stored is block else stored)
            if first_hash is None:
                first_hash = h
            tasks.append(asyncio.create_task(
                put_one(stored, offset, plain_len, h)))
            offset += plain_len
            # backpressure: don't build an unbounded task list
            while len(tasks) > max_parallel:
                done, _ = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    if t.exception() is not None:
                        raise t.exception()
                tasks = [t for t in tasks if not t.done()]
            async with span("s3.put.chunk_read"):
                block = await chunker.next()
        if tasks:
            await asyncio.gather(*tasks)
        # make THIS request's queued version/block_ref rows
        # quorum-visible before the caller's Complete insert
        # (read-your-writes); other requests' backlog is theirs to flush
        async with span("s3.put.flush_meta"):
            await garage.version_table.flush_insert_queue(queued_vkeys)
            await garage.block_ref_table.flush_insert_queue(queued_bkeys)
    except BaseException:
        for t in tasks:
            t.cancel()
        # settle cancelled tasks before the caller writes its cleanup
        # tombstone, or a late block_ref insert could race past it
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        # the in-flight block may be a lease not yet handed to a
        # put_one (e.g. the checksum threw between next() and
        # create_task); handed-over ones were just released by their
        # task's finally, so this idempotent release never double-frees
        if hasattr(block, "release"):
            block.release()
        # flush queued rows BEFORE the caller's aborted-object tombstone:
        # the tombstone's trigger queue-inserts Version(deleted=True),
        # which would CRDT-merge into a still-queued per-block row and
        # wipe its block map before replicas ever saw it — then no
        # BlockRef tombstones fire while the queued live BlockRefs still
        # propagate, leaking the blocks' refcounts permanently. Shielded:
        # a task cancellation mid-flush (CancelledError is NOT an
        # Exception) must not reopen that ordering hazard — the flush
        # finishes in the background while we proceed to the tombstone.
        async def _flush_both():
            await garage.version_table.flush_insert_queue(queued_vkeys)
            await garage.block_ref_table.flush_insert_queue(queued_bkeys)

        flush = asyncio.ensure_future(_flush_both())
        # keep re-awaiting until the flush actually lands: returning
        # early (even to re-raise) would let the caller's tombstone
        # insert race the still-in-flight flush — the exact ordering
        # hazard documented above. Repeated cancellations only re-arm
        # the wait; the shielded task itself is never cancelled.
        while not flush.done():
            try:
                await asyncio.shield(flush)
            except asyncio.CancelledError:
                continue
            except Exception:
                break  # flush failed; retrieved below, original re-raised
        flush.cancelled() or flush.exception()  # retrieve, don't mask
        raise
    finally:
        if fused:
            feeder.active_streams -= 1
    md5_hex = md5.hexdigest()
    etag = ssec_etag() if sse_key is not None else md5_hex
    return offset, md5_hex, etag, first_hash


async def handle_put(ctx, req: Request) -> Response:
    """ref: put.rs:60-120 handle_put."""
    from ..checksum import request_checksum_value
    from .encryption import request_sse_key

    headers = extract_metadata_headers(req)
    try:
        expected_checksum = request_checksum_value(req.headers)
    except ValueError as e:
        raise bad_request(str(e))
    sse_key = request_sse_key(req)
    # aws-chunked bodies declare the true payload size separately; the
    # raw content-length there includes per-chunk framing
    cl = req.header("x-amz-decoded-content-length") \
        or req.header("content-length")
    uuid, ts, etag, _ = await save_stream(
        ctx.garage, ctx.bucket_id, ctx.key, headers, req.body,
        content_md5=req.header("content-md5"),
        expected_checksum=expected_checksum,
        sse_key=sse_key,
        content_length=int(cl) if cl and cl.isdigit() else None,
        quotas=(ctx.bucket.params.quotas.value or {})
        if ctx.bucket is not None and ctx.bucket.params is not None
        else None,
    )
    extra = []
    if sse_key is not None:
        from .encryption import ALGO_HEADER, KEY_MD5_HEADER

        extra = [(ALGO_HEADER, "AES256"),
                 (KEY_MD5_HEADER, sse_key.md5_b64)]
    return Response(200, [("etag", f'"{etag}"'),
                          ("x-amz-version-id", uuid.hex())] + extra)


async def handle_copy(ctx, req: Request) -> Response:
    """CopyObject within/between buckets (ref: api/s3/copy.rs — block
    reuse: new version/block_ref rows point at the same hashes; no data
    movement)."""
    from urllib.parse import unquote

    src = unquote(req.header("x-amz-copy-source") or "").lstrip("/")
    src_bucket_name, _, src_key = src.partition("/")
    if not src_bucket_name or not src_key:
        raise bad_request("malformed x-amz-copy-source")
    helper_g = ctx.garage
    from ...model.helper import GarageHelper

    helper = GarageHelper(helper_g)
    src_bucket_id = await helper.resolve_global_bucket_name(src_bucket_name)
    if src_bucket_id is None:
        raise S3Error("NoSuchBucket", 404, src_bucket_name)
    if not ctx.api_key.allow_read(src_bucket_id):
        raise S3Error("AccessDenied", 403, "no read access to source")
    src_obj = await helper_g.object_table.get(src_bucket_id,
                                              src_key.encode())
    src_v = src_obj.last_data() if src_obj is not None else None
    if src_v is None:
        raise S3Error("NoSuchKey", 404, src_key)
    from .get import check_copy_source_preconditions

    check_copy_source_preconditions(req, src_v, src_v.state.data.meta.etag)

    from .encryption import (check_key_for_meta, copy_source_sse_key,
                             meta_is_encrypted, request_sse_key)

    src_sse_hdr = copy_source_sse_key(req)
    dst_sse = request_sse_key(req)
    if src_sse_hdr is None and dst_sse is None \
            and meta_is_encrypted(src_v.state.data.meta):
        # don't silently duplicate ciphertext the caller can't prove it
        # can read (ref: encryption.rs check_decrypt_common)
        raise S3Error(
            "InvalidRequest", 400,
            "source object is SSE-C encrypted; "
            "x-amz-copy-source-server-side-encryption-customer-* "
            "headers are required")
    # x-amz-metadata-directive: REPLACE takes the request's metadata
    # instead of the source's (ref: copy.rs:83-90) — the canonical
    # "update an object's metadata" operation is a self-copy with
    # REPLACE
    replace_meta = (req.header("x-amz-metadata-directive") or "") \
        .upper() == "REPLACE"

    if src_sse_hdr is not None or dst_sse is not None:
        # encryption boundary crossing: stream the source plaintext
        # through the normal save path, re-encrypting under the
        # destination key (ref: copy.rs re-encryption path)
        src_meta = src_v.state.data.meta
        src_sse = check_key_for_meta(src_meta, src_sse_hdr)
        from .get import open_object_stream

        source = await open_object_stream(helper_g, src_v, 0,
                                          src_meta.size, src_sse)
        headers = (extract_metadata_headers(req) if replace_meta
                   else {k: v for k, v in src_meta.headers.items()
                         if not k.startswith("x-garage-ssec-")})
        try:
            uuid, ts, etag, _ = await save_stream(
                helper_g, ctx.bucket_id, ctx.key, headers, source,
                sse_key=dst_sse, content_length=src_meta.size,
                quotas=(ctx.bucket.params.quotas.value or {})
                if ctx.bucket is not None and ctx.bucket.params is not None
                else None)
        finally:
            # an aborted copy must cancel the source's readahead
            # prefetches now, not at GC time
            await source.aclose()
        from .xml import xml, xml_response

        return xml_response(xml("CopyObjectResult",
                                xml("LastModified", _http_date(ts)),
                                xml("ETag", f'"{etag}"')))

    uuid = gen_uuid()
    ts = now_msec()
    data = src_v.state.data
    meta = (ObjectVersionMeta(extract_metadata_headers(req),
                              data.meta.size, data.meta.etag)
            if replace_meta else data.meta)
    if data.kind == "inline":
        ov = ObjectVersion(uuid, ts, ObjectVersionState.complete(
            ObjectVersionData.inline(meta, data.blob)))
        await helper_g.object_table.insert(
            Object(ctx.bucket_id, ctx.key, [ov]))
    else:
        src_version = await helper_g.version_table.get(src_v.uuid, b"")
        if src_version is None:
            raise S3Error("NoSuchKey", 404, src_key)
        up = Object(ctx.bucket_id, ctx.key, [ObjectVersion(
            uuid, ts, ObjectVersionState.uploading({}, False))])
        await helper_g.object_table.insert(up)
        new_version = Version.new(uuid,
                                  (BACKLINK_OBJECT, ctx.bucket_id, ctx.key))
        blocks = list(src_version.blocks.items())
        for bk, (h, size) in blocks:
            new_version = Version(new_version.uuid, new_version.deleted,
                                  new_version.blocks.put(bk, (h, size)),
                                  new_version.backlink)
        await helper_g.version_table.insert(new_version)
        for bk, (h, size) in blocks:
            await helper_g.block_ref_table.insert(BlockRef.new(h, uuid))
        done = Object(ctx.bucket_id, ctx.key, [ObjectVersion(
            uuid, ts, ObjectVersionState.complete(
                ObjectVersionData.first_block(meta, data.blob)))])
        await helper_g.object_table.insert(done)

    from .xml import xml, xml_response

    lm = _http_date(ts)
    return xml_response(xml("CopyObjectResult",
                            xml("LastModified", lm),
                            xml("ETag", f'"{data.meta.etag}"')))


def _http_date(ts_msec: int) -> str:
    import datetime

    return datetime.datetime.fromtimestamp(
        ts_msec / 1000, datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%S.000Z")
