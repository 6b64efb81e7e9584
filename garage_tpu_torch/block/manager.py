"""BlockManager: the content-addressed block data path (ported from the
JAX package's block/manager.py).

Ref parity: src/block/manager.rs. Public surface mirrors the reference
(`rpc_put_block`, `rpc_get_block`, `block_incref/decref`) but the write
path is generic over the BlockCodec: replicate-N sends the whole
(optionally compressed) block to every node of the hash's write sets;
erasure(k, m) RS-encodes the packed block into k+m shards (kernel G1
on the GPU) placed on k+m distinct ring nodes, and reads gather any k.

What differs from the JAX package: the manager takes a torch `device`
("cuda" unless the caller asks for "cpu") beside the feeder mode
`device_mode` ("require" by default, where the JAX package's is
"auto"; "auto" and "off" as there), and hands both to its DeviceFeeder
(with the `[tpu]` knobs, `tpu_cfg`) and the device to its codec — the
CPU in "off", where nothing touches the card; the shard file format
adds `pack_shards` (all shards of a block framed in one buffer,
byte-identical to `pack_shard`), which the feeder's encode_put readback
uses; a replicated block's quorum write is traced as
`block.write_replicas` (attrs `copies`, `quorum`), the twin of the
erasure path's `block.write_shards`.

Local files (under the DataLayout path scheme):
  whole blocks:  {hex}[.zst|.zlib] content = DataBlock payload
  shards:        {hex}.s{i}        content = shard file (len+checksum hdr)

RPC ops on endpoint "garage_tpu/block":
  {op: "put", hash, part|None, comp?, data}  part=None -> whole block (comp present: data = bare payload; absent: packed)
  {op: "get", hash, part|None}
  {op: "need", hash}                      -> {needed: bool}
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import time
import zlib
from typing import Optional

import numpy as np

from ..chaos import injector as _chaos
from ..net.message import PRIO_BACKGROUND, PRIO_NORMAL
from ..rpc.rpc_helper import (
    HedgedRace,
    RequestStrategy,
    RpcHelper,
)
from ..utils.data import blake2sum
from ..utils.metrics import registry
from ..utils.error import CorruptData, MissingBlock, QuorumError, RpcError
from .block import BLOCK_SUFFIXES, COMPRESSION_NONE, DataBlock, comp_of_path
from .codec import BlockCodec, ErasureCodec, ReplicateCodec, shard_nodes_of
from .layout import DataLayout
from .rc import BlockRc

log = logging.getLogger("garage_tpu_torch.block")

INLINE_THRESHOLD = 3072  # ref: block/manager.rs:46

_tmp_ctr = itertools.count()
_TMP_MAX_AGE = 3600.0  # stale .tmpN orphans (crash mid-write) get swept

_SHARD_MAGIC_V1 = b"GTS1"  # blake2-256 checksum (legacy)
_SHARD_MAGIC_C32C = b"GTS2"  # crc32c (native slice-by-8 kernel)
_SHARD_MAGIC_C32 = b"GTS3"  # zlib crc32 (no native toolchain)


def _write_flavour():
    """(magic, crc function) for new shard files: crc32c once the native
    library is loaded; until then (loaded() never triggers a build,
    which would block the caller for seconds) zlib crc32."""
    from .. import native

    if native.loaded():
        return _SHARD_MAGIC_C32C, native.crc32c
    return _SHARD_MAGIC_C32, zlib.crc32


def pack_shard(data: bytes, packed_len: int) -> bytes:
    """Shard file image for `data`, one shard of a block whose packed
    length is `packed_len`: `_write_flavour`'s choice, with the crc
    called by name so that the call graph sees the native chain."""
    from .. import native

    if native.loaded():
        magic, ck = _SHARD_MAGIC_C32C, native.crc32c(data)
    else:
        magic, ck = _SHARD_MAGIC_C32, zlib.crc32(data)
    return (magic + packed_len.to_bytes(8, "big")
            + ck.to_bytes(4, "big") + data)


def pack_shards(parts: list[np.ndarray], packed_len: int) -> list[memoryview]:
    """pack_shard for every row of `parts` (2-D uint8 arrays of equal
    width, stacked in order), framed in ONE buffer: the shard file
    images come back as memoryviews over it, byte-identical to
    [pack_shard(bytes(row), packed_len) ...], with one copy of the
    payload instead of three."""
    sl = parts[0].shape[1]
    n = sum(p.shape[0] for p in parts)
    out = np.empty((n, 16 + sl), dtype=np.uint8)
    row = 0
    for p in parts:
        out[row:row + p.shape[0], 16:] = p
        row += p.shape[0]
    magic, crc = _write_flavour()
    out[:, :12] = np.frombuffer(magic + packed_len.to_bytes(8, "big"),
                                dtype=np.uint8)
    for i in range(n):
        out[i, 12:16] = np.frombuffer(crc(out[i, 16:]).to_bytes(4, "big"),
                                      dtype=np.uint8)
    view = memoryview(out.reshape(-1))
    stride = 16 + sl
    return [view[i * stride:(i + 1) * stride] for i in range(n)]


def validate_shard(raw) -> int:
    """Checksum-verify a shard file image without copying its payload;
    -> whole-block packed length. Raises CorruptData. Reads every
    format (crc32c, zlib crc32, legacy blake2)."""
    mv = memoryview(raw)
    magic = bytes(mv[:4])
    packed_len = int.from_bytes(mv[4:12], "big")
    if magic == _SHARD_MAGIC_C32C:
        ck, data = bytes(mv[12:16]), mv[16:]
        from .. import native

        if native.loaded():
            good = native.crc32c(data).to_bytes(4, "big") == ck
        else:  # cross-node file from a native writer, no library here
            good = native.crc32c_py(data).to_bytes(4, "big") == ck
        if not good:
            raise CorruptData(b"")
    elif magic == _SHARD_MAGIC_C32:
        ck, data = bytes(mv[12:16]), mv[16:]
        if zlib.crc32(data).to_bytes(4, "big") != ck:
            raise CorruptData(b"")
    elif magic == _SHARD_MAGIC_V1:
        ck, data = bytes(mv[12:44]), mv[44:]
        if blake2sum(data) != ck:
            raise CorruptData(b"")
    else:
        raise CorruptData(b"")
    return packed_len


def unpack_shard(raw: bytes) -> tuple[bytes, int]:
    """-> (shard bytes, whole-block packed length); raises CorruptData."""
    packed_len = validate_shard(raw)
    hdr = 44 if bytes(raw[:4]) == _SHARD_MAGIC_V1 else 16
    return raw[hdr:], packed_len


def _hex_in(x: str, parts: set) -> bool:
    """Is the 2-hex-char prefix dir `x` one of the wanted partitions?
    (Foreign dir names in a data root are skipped, not crashed on.)"""
    try:
        return int(x, 16) in parts
    except ValueError:
        return False


class _ByteSemaphore:
    """Async counting semaphore over bytes with FIFO wakeup; a single
    oversize request (> capacity) is allowed when it is alone, so giant
    blocks don't deadlock."""

    def __init__(self, capacity: int):
        self.capacity = max(1, capacity)
        self.in_use = 0
        self._waiters: list[tuple[int, asyncio.Future]] = []

    async def acquire(self, n: int) -> None:
        # the fast path must not barge past queued waiters, or a large
        # request starves under a steady stream of small ones
        if not self._waiters and (
                self.in_use == 0 or self.in_use + n <= self.capacity):
            self.in_use += n
            return
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append((n, fut))
        try:
            await fut
        except BaseException:
            try:
                self._waiters.remove((n, fut))
            except ValueError:
                # already popped by release(): granted unless cancelled
                if fut.done() and not fut.cancelled():
                    self.release(n)
            raise

    def queue_depth(self) -> int:
        """Writers currently parked behind the byte budget — a pressure
        signal that reacts BEFORE request latency does (the qos
        governor samples it alongside its latency EWMA)."""
        return len(self._waiters)

    def waiting_bytes(self) -> int:
        return sum(n for n, _ in self._waiters)

    def release(self, n: int) -> None:
        self.in_use -= n
        while self._waiters:
            need, fut = self._waiters[0]
            if self.in_use != 0 and self.in_use + need > self.capacity:
                break
            self._waiters.pop(0)
            if not fut.cancelled():
                self.in_use += need
                fut.set_result(None)


class BlockManager:
    def __init__(self, system, db, data_layout: DataLayout,
                 codec: Optional[BlockCodec] = None,
                 compression: bool = True, fsync: bool = False,
                 device="cuda",
                 device_mode: str = "require",
                 device_batch_blocks: int = 256,
                 tpu_cfg=None,
                 ram_buffer_max: int = 256 * 1024 * 1024,
                 read_cache_max_bytes: Optional[int] = None,
                 resync_breaker_aware: bool = True,
                 cache_tier: bool = True,
                 cache_tier_hint_top_n: int = 16,
                 cache_lease_wait_ms: float = 250.0,
                 cache_prefetch_inflight: int = 2,
                 cache_packed_max_bytes: Optional[int] = None):
        self.system = system
        self.db = db
        self.data_layout = data_layout
        self.compression = compression
        self.fsync = fsync
        self.rc = BlockRc(db)
        self.rpc = RpcHelper(system)
        if codec is None:
            rm = system.replication
            if rm.erasure is not None:
                codec = ErasureCodec(
                    *rm.erasure, write_quorum=rm.block_write_quorum,
                    device="cpu" if device_mode == "off" else device)
            else:
                codec = ReplicateCodec(rm.factor,
                                       write_quorum=rm.write_quorum)
        self.codec = codec
        from .feeder import DeviceFeeder

        self.feeder = DeviceFeeder(
            codec=codec if isinstance(codec, ErasureCodec) else None,
            mode=device_mode,
            max_batch=device_batch_blocks,
            device=device,
            tpu_cfg=tpu_cfg,
        )
        # RAM held by in-flight outbound block writes, bounded like the
        # reference's buffer_stream semaphore (ref: manager.rs:156,
        # util/config.rs:272-274 block_ram_buffer_max). Slot unit = one
        # byte; putters acquire len(packed) before fan-out.
        self._ram_sem = _ByteSemaphore(ram_buffer_max)
        # hot-block read cache (block/cache.py): decoded payloads keyed
        # by content hash, sized off block_ram_buffer_max unless the
        # `[block] read_cache_max_bytes` knob says otherwise (0 = off)
        from .cache import BlockCache

        if read_cache_max_bytes is None:
            read_cache_max_bytes = ram_buffer_max // 4
        self.cache = BlockCache(read_cache_max_bytes)
        # packed-bytes tier segment: the EXACT on-disk packed
        # bytes an erasure decode reassembles, keyed by the same content
        # hash. Shard rebuilds and scrub stripe repairs re-encode from
        # it (deterministic RS encode -> byte-identical shards, the
        # _repair_stripe precedent), skipping the k-shard gather; a
        # degraded GET serves from it before gathering. Erasure-only: in
        # replicate mode the packed form is just scheme byte + payload
        # and the plain cache already covers it. `[block]
        # cache_packed_max_bytes` (0 = off), default ram_buffer_max/8.
        if cache_packed_max_bytes is None:
            cache_packed_max_bytes = ram_buffer_max // 8
        self.packed_cache = BlockCache(
            cache_packed_max_bytes if self.erasure else 0)
        # node-local read singleflight: one store gather+
        # decode per hash per process, concurrent readers collapse onto
        # the leader's future (the node-local leg of the lease story)
        self._sf: dict[bytes, asyncio.Future] = {}
        self.sf_leaders = 0
        self.sf_collapsed = 0
        # optional async hook (Garage wires qos.shape_bytes): every
        # foreground block read — hit or miss — charges the qos bytes
        # budget, so GET/copy traffic is paced evenly whether it is
        # served from RAM or from the store (background resync/scrub
        # reads don't come through rpc_get_block and stay uncharged)
        self.read_qos_charge = None
        # worker-sharded read cache (gateway/): when set (gateway API
        # workers only), cacheable reads are routed to the rendezvous-
        # hash OWNER worker over loopback RPC so the node holds one
        # decoded copy of a hot block instead of one per worker. The
        # router duck-type is {owner_of(h), owns(h), forward(owner, h)}.
        self.cache_router = None
        self.endpoint = system.netapp.endpoint("garage_tpu/block").set_handler(
            self._handle
        )
        # CLUSTER cache tier (block/cache_tier.py): rendezvous
        # owner routing over the layout's storage-node roster, breaker-
        # filtered; non-owner reads probe the owner's cache in one hop
        # and warm it on miss, so the cluster pays ~1 decode per hot
        # block instead of 1 per node. `[block] cache_tier = false`
        # kills the lane (every read serves node-locally as before).
        self.cache_tier = None
        peering = getattr(system, "peering", None)
        if cache_tier and peering is not None:
            from .cache_tier import ClusterCacheTier

            self.cache_tier = ClusterCacheTier(
                self, hint_top_n=cache_tier_hint_top_n,
                lease_wait_ms=cache_lease_wait_ms,
                prefetch_inflight=cache_prefetch_inflight)
            # hot-hash hints ride the existing peering pings: the
            # peering layer stays block-agnostic (plain callables), the
            # tier decides what is hot and what a hint means
            peering.hint_provider = self.cache_tier.hot_hashes
            peering.hint_sink = self.cache_tier.note_hints
        from .resync import BlockResyncManager

        self.resync = BlockResyncManager(
            self, db, breaker_aware=resync_breaker_aware)
        # set by spawn_workers; pre-set so API-only processes (gateway
        # workers never spawn block workers) can render metrics/state
        self.scrub_worker = None
        self.metrics = {"bytes_read": 0, "bytes_written": 0,
                        "corruptions": 0, "resync_sent": 0,
                        "resync_recv": 0, "resync_bytes": 0,
                        # full store reads (gather+decode / disk+verify)
                        # — what the cluster cache tier exists to
                        # dedupe; bench_cache_tier sums this across
                        # nodes to prove "~1 decode per hot block"
                        "store_reads": 0}
        # layout-transition participation: a new layout
        # version means every block held or needed here must be
        # re-examined (fetch what moved in, offload what moved away),
        # and once that backlog drains the block layer reports its
        # sync position so old layout versions can be GC'd. The block
        # layer registers as a sync SOURCE next to the table syncers —
        # the node's sync tracker advances at the minimum across
        # layers.
        lm = getattr(system, "layout_manager", None)
        if lm is not None:
            lm.register_sync_source("blocks")
            self.resync.bootstrap_layout_marker()
            lm.on_change.append(self.resync.note_layout_change)

    @property
    def erasure(self) -> bool:
        return isinstance(self.codec, ErasureCodec)

    def spawn_workers(self, runner, scrub: bool = True) -> None:
        from .repair import ScrubWorker

        self.resync.spawn_workers(runner)
        self.scrub_worker = None
        if scrub:
            self.scrub_worker = ScrubWorker(self)
            runner.spawn_worker(self.scrub_worker)

    def register_bg_vars(self, vars) -> None:
        """Runtime-tunables for `worker get/set` (ref: BgVars
        registrations in block/manager.rs:213-233)."""
        res = self.resync

        def set_rt(v):
            res.tranquility = float(v)
            # an explicit operator set takes the knob away from the qos
            # governor until it is explicitly re-enabled
            res.tranquility_manual = True

        vars.register_rw("resync-tranquility",
                         lambda: res.tranquility, set_rt)
        sw = getattr(self, "scrub_worker", None)
        if sw is not None:
            def set_st(v):
                sw.state.tranquility = float(v)
                sw.state.tranquility_manual = True
                sw.persister.save(sw.state)

            def set_paused(v):
                sw.state.paused = v.lower() in ("1", "true", "yes")
                sw.persister.save(sw.state)

            vars.register_rw("scrub-tranquility",
                             lambda: sw.state.tranquility, set_st)
            vars.register_rw("scrub-paused",
                             lambda: sw.state.paused, set_paused)
            vars.register_rw(
                "scrub-last-completed",
                lambda: sw.state.last_completed,
                lambda v: (_ for _ in ()).throw(
                    ValueError("read-only variable")),
            )

            def set_deep(v):
                sw.deep = v.lower() in ("1", "true", "yes")

            vars.register_rw("scrub-deep", lambda: int(sw.deep), set_deep)

    async def stop(self) -> None:
        await self.feeder.stop()

    # ==== cluster write path (ref: manager.rs:366-450) ==================

    async def hash_block(self, data: bytes) -> bytes:
        """Content hash of a plain block — batched with all concurrent
        callers through the device feeder (API PUT path entry point)."""
        return await self.feeder.hash(data)

    async def hash_block_md5(self, data: bytes, md5acc) -> bytes:
        """Content hash + ETag-MD5 advance in one feeder call (kernel
        B3 for the hash; the MD5 lanes advance on the host once the
        digests are back; see feeder.hash_with_md5)."""
        return await self.feeder.hash_with_md5(data, md5acc)

    def ingest_pool(self, block_size: int, count: int):
        """The pinned ingest buffer pool for the PUT fast path
        (block/hostbuf.py), built lazily once. Erasure-only: the pool's
        flat layout IS the RS staging stripe; replicate mode returns
        None and PUTs keep the classic path. `count` comes from
        `[s3_api] ingest_buffers` (0 disables)."""
        if not self.erasure or count <= 0:
            return None
        pool = getattr(self, "_ingest_pool", None)
        if pool is None:
            from .hostbuf import HostBufPool

            pool = HostBufPool(self.codec.k, block_size, count)
            self._ingest_pool = pool
        return pool

    async def rpc_put_block(self, hash32: bytes, data: bytes,
                            compress: Optional[bool] = None,
                            cacheable: bool = True) -> None:
        """`data` is the block payload: bytes, or a hostbuf.BlockLease
        on the zero-copy ingest path (erasure + no SSE; the caller owns
        the lease and releases it after this returns)."""
        from ..utils.tracing import span

        lease = data if hasattr(data, "stripe") else None
        await self._ram_sem.acquire(len(data))
        try:
            async with span("block.put", size=len(data), hash=hash32):
                do_compress = (self.compression if compress is None
                               else compress)
                if lease is not None:
                    blk = (await asyncio.to_thread(
                        DataBlock.compress, lease.view())
                        if do_compress else None)
                    if blk is None or blk.compression == COMPRESSION_NONE:
                        # zero-copy leg: scheme byte lands in the
                        # lease's header slot and the feeder stages the
                        # prefilled stripe directly — no pack, no pad
                        lease.set_scheme(COMPRESSION_NONE)
                        await self._put_erasure(
                            hash32, bytes([COMPRESSION_NONE]), lease)
                    else:
                        # the body shrank: the compressed copy is a NEW
                        # (smaller) buffer, so the classic path costs
                        # nothing extra
                        await self._put_erasure(hash32,
                                                bytes([blk.compression]),
                                                blk.bytes)
                elif self.erasure:
                    blk = (await asyncio.to_thread(DataBlock.compress, data)
                           if do_compress else DataBlock.plain(data))
                    # the 1-byte DataBlock header travels as a prefix so
                    # the megabyte payload is never concat-copied
                    await self._put_erasure(hash32,
                                            bytes([blk.compression]),
                                            blk.bytes)
                else:
                    blk = (await asyncio.to_thread(DataBlock.compress, data)
                           if do_compress else DataBlock.plain(data))
                    # scheme byte travels as its own field: the
                    # megabyte payload is never concat-copied into a
                    # packed buffer (same trick as the erasure prefix)
                    await self._put_replicate(hash32, blk.compression,
                                              blk.bytes)
            # write-through: freshly written blocks are the hottest
            # reads (read-after-write). `data` is exactly the decoded
            # payload rpc_get_block returns. SSE-C callers pass
            # cacheable=False — never cache payloads the node cannot
            # re-derive without the client's key. Under a sharded
            # gateway cache only the OWNER worker keeps the copy, and
            # under the CLUSTER tier only the owner NODE does (a
            # non-owner write-through would recreate the N-duplicates
            # problem the routing exists to kill): a non-owner PUT
            # warms the cluster owner with a bounded background push
            # instead of filling its own cache.
            if cacheable:
                tier = getattr(self, "cache_tier", None)
                if lease is not None and (self.cache.max_bytes > 0
                                          or tier is not None):
                    # caches keep references past the request; a lease's
                    # buffer is recycled at release, so the write-through
                    # needs its own durable copy (a CACHE fill, not a
                    # data-plane hop — deliberately outside
                    # s3_put_copy_bytes)
                    data = bytes(lease.view())
                tier_owner = (tier.owner_of(hash32)
                              if tier is not None else None)
                if tier_owner is not None:
                    # lint: ignore[GL03] guarded by the cacheable= audit flag itself: SSE-C callers pass cacheable=False (pinned by conformance tests), so tainted payloads never reach the tier push
                    self.cache_tier.insert_at(tier_owner, hash32, data)
                # a storage node that is not the cluster owner keeps no
                # local copy; gateway workers (cache_router set) keep
                # their worker-sharded node-level copy regardless —
                # the frontend L1 under the cluster tier's L2
                if (tier_owner is None
                        or self.cache_router is not None) and (
                        self.cache_router is None
                        or self.cache_router.owns(hash32)):
                    # lint: ignore[GL03] guarded by the cacheable= audit flag itself: SSE-C callers pass cacheable=False (pinned by conformance tests), so tainted payloads never reach this insert
                    self.cache.insert(hash32, data)
        finally:
            self._ram_sem.release(len(data))

    async def _put_replicate(self, hash32: bytes, comp: int,
                             payload: bytes) -> None:
        from ..utils.tracing import span

        helper = self.system.layout_helper
        with helper.write_lock():
            sets = helper.write_sets_of(hash32)
            async with span("block.write_replicas", copies=self.codec.width,
                            quorum=self.codec.write_quorum):
                # lint: ignore[GL06] write_lock is a layout-version PIN (refcount), not mutual exclusion; holding it across the quorum write IS the union-window contract (manager.rs:344)
                await self.rpc.try_write_many_sets(
                    self.endpoint, sets,
                    {"op": "put", "hash": hash32, "part": None,
                     "comp": comp, "data": payload},
                    RequestStrategy(quorum=self.codec.write_quorum,
                                    prio=PRIO_NORMAL,
                                    timeout=60.0),
                )

    async def _put_erasure(self, hash32: bytes, prefix: bytes,
                           data: bytes) -> None:
        from ..utils.tracing import span

        async with span("block.encode", size=len(data)):
            payloads = await self.feeder.encode_put(data, prefix=prefix)
        # shard payloads stay memoryviews over the encoder's one output
        # buffer: split_blob hoists them out of the dict before msgpack
        # (never serialized), self-calls hand them to validate/write
        # directly, and remote sends scatter them as raw blob sections
        helper = self.system.layout_helper
        with helper.write_lock():
            # One shard placement per live layout version, mirroring
            # try_write_many_sets: the write is acked only once EVERY
            # version's placement holds a write quorum of shards, so a
            # layout transition never weakens the ack-lock guarantee.
            sets: list[list[tuple[bytes, int]]] = []
            for v in helper.versions_for_writes():
                placement = shard_nodes_of(v, hash32, self.codec.width)
                if len(placement) < self.codec.write_quorum:
                    raise QuorumError(self.codec.write_quorum, 1, 0,
                                      len(placement), ["cluster too small"])
                s = [(n, i) for i, n in enumerate(placement)]
                if s not in sets:
                    sets.append(s)
            # quorum unit = placement entry (node, shard index): a node
            # may be assigned different shard indices under different
            # layout versions, so keys are tuples, not bare node ids
            async with span("block.write_shards", width=self.codec.width):
                await self._write_shard_sets(hash32, payloads, sets)

    async def _write_shard_sets(self, hash32, payloads, sets) -> None:
        # hedge=True (ROADMAP carry-over): a shard holder that sits in
        # the quorum-critical set and goes quiet used to hold the whole
        # PUT to its timeout — exactly the tail a draining node grows
        # during a resize. Shard puts are keyed by content hash + shard
        # index, so a re-issued backup push landing twice writes the
        # same bytes to the same path: idempotent, first ack wins.
        await self.rpc.try_write_many_sets(
            self.endpoint, sets, None,
            RequestStrategy(quorum=self.codec.write_quorum,
                            prio=PRIO_NORMAL, timeout=60.0,
                            hedge=True),  # lint: ignore[GL02] shard puts are content-addressed and idempotent; a duplicate backup push re-writes identical bytes
            make_call=lambda key: self.endpoint.call(
                key[0],
                {"op": "put", "hash": hash32, "part": key[1],
                 "data": payloads[key[1]]},
                PRIO_NORMAL, timeout=60.0,
            ),
        )

    # ==== cluster read path (ref: manager.rs:243-363) ===================

    async def rpc_get_block(self, hash32: bytes,
                            cacheable: bool = True, route: bool = True,
                            charge: bool = True) -> bytes:
        """Decoded block payload. A read-cache hit returns without any
        block RPC — in erasure mode that means the whole shard gather +
        RS decode + verify is skipped. `cacheable=False` (SSE-C) both
        bypasses the lookup and suppresses the miss fill — and, on a
        gateway worker, also skips cross-worker routing, so an SSE-C
        payload never crosses a worker boundary.

        `route=False` serves locally even when a gateway cache router
        is installed (the owner-side handler of a forwarded read uses
        it — one hop, never a chain; the CLUSTER tier probe below is a
        different layer and stays live, so a worker serving a sibling's
        forward still exploits the cluster owner's cache). `charge=False`
        skips the qos byte charge (the FORWARDING worker charges its
        own lease for bytes it serves to its client; the owner must not
        double-charge)."""
        charge_fn = self.read_qos_charge if charge else None
        fill = cacheable
        tier = None
        tier_owner = None
        push_owner = True
        if cacheable:
            data = self.cache.get(hash32)
            if data is not None:
                if charge_fn is not None:
                    await charge_fn(len(data))
                return data
            # routing exists to exploit the OWNER's cache; with the
            # cache disabled (read_cache_max_bytes = 0) a forward is a
            # guaranteed miss plus a second loopback hop — skip it
            router = (self.cache_router
                      if route and self.cache.max_bytes > 0 else None)
            tier = getattr(self, "cache_tier", None)
            if router is not None and tier is not None \
                    and tier.local_owner(hash32):
                # tier-aware worker shortcut: this NODE is
                # the block's cluster cache-tier owner, so the cluster
                # copy (write-through + probe warms) already lives
                # here — a worker-ring forward would spend a loopback
                # hop reaching a sibling whose best answer is bytes
                # this process can serve itself
                registry().inc("cache_tier_local_owner_shortcut")
                router = None
            if router is not None:
                owner = router.owner_of(hash32)
                if owner is not None:
                    data = await router.forward(owner, hash32)
                    if data is not None:
                        if charge_fn is not None:
                            await charge_fn(len(data))
                        return data
                    # owner unreachable: serve from the store directly,
                    # WITHOUT filling our cache — a transient forward
                    # failure must not seed duplicate copies
                    fill = False
            # cluster cache tier (block/cache_tier.py): a non-owner
            # read probes the block's owner NODE in one hedge-safe hop
            # — a hit is the whole point of the tier (zero gathers,
            # zero decodes anywhere); a miss or open-breaker owner
            # falls through to today's local path, and the decoded
            # result warms the owner below. The probe carries the
            # lease protocol: a cold herd's first prober is
            # granted the decode lease, the rest park at the owner
            # INSIDE the probe's flat timeout and are woken by the
            # holder's insert — a flash crowd pays ~1 decode per
            # block cluster-wide, not 1 per node. SSE-C never reaches
            # this probe: cacheable=False skips the enclosing branch.
            if tier is not None:
                tier_owner = tier.owner_of(hash32)
                if tier_owner is not None:
                    kinds = ("plain", "packed") if self.erasure \
                        else ("plain",)
                    res = await tier.probe_full(tier_owner, hash32,
                                                cacheable=cacheable,
                                                kinds=kinds)
                    if res.plain is not None:
                        if charge_fn is not None:
                            await charge_fn(len(res.plain))
                        return res.plain
                    if res.timed_out:
                        # parked behind the lease and lost: the
                        # holder's MiB-scale insert push is presumed in
                        # flight — do NOT pile this node's own push on
                        # top (N redundant pushes are exactly the
                        # amplification leases exist to kill)
                        push_owner = False
                    if self.cache_router is None:
                        # storage node: one decoded copy per CLUSTER —
                        # the owner gets the write-through, this node
                        # does not keep one. Gateway WORKERS keep their
                        # worker-sharded node-level copy (the frontend
                        # L1; the cluster tier is its L2) — without it
                        # every hot forward would re-probe the storage
                        # owner over loopback.
                        fill = False
                elif tier.leases.live(hash32):
                    # THIS node is the hash's cache owner and a remote
                    # prober currently holds the decode lease: park
                    # behind it like a remote waiter would, then
                    # re-check — the holder's insert usually lands
                    # first and this read never touches the store
                    await tier.leases.wait(
                        hash32, tier.probe_wait_ms() / 1000.0)
                    data = self.cache.get(hash32)
                    if data is not None:
                        if charge_fn is not None:
                            await charge_fn(len(data))
                        return data
                if tier_owner is None and tier.enabled \
                        and self.cache.max_bytes > 0:
                    # owner-side SELF-lease: this node is about to pay
                    # the herd's decode, so a remote prober arriving
                    # while it is in flight must PARK behind this lease
                    # instead of being granted a second one — without
                    # it a herd that includes the owner pays two
                    # decodes per block, not one. No-op when a lease
                    # is already live or the wait-mode is off; the fill
                    # below resolves it (the error path resolves too).
                    tier.leases.mint(hash32, self.system.id)
        if cacheable:
            # node-local singleflight: concurrent readers of one hash
            # collapse onto a single gather+decode (SSE-C stays on the
            # direct path — its payloads must not transit a shared
            # future other requests can await)
            try:
                data = await self._read_store(hash32)
            except BaseException:
                if tier is not None and tier_owner is None:
                    # a failed owner read must not leave probers parked
                    # out their full wait behind a lease nobody will
                    # resolve — wake them now; they re-check the cache
                    # (the truth) and fall back to their own stores
                    tier.leases.resolve(hash32)
                raise
        else:
            data = await self._get_uncached(hash32)
        if fill:
            # fill is only ever True inside the cacheable branch; SSE-C
            # callers pass cacheable=False (pinned by conformance tests)
            self.cache.insert(hash32, data)
        if cacheable and tier is not None and tier_owner is None:
            # owner-side fill: wake every prober parked on this hash
            # (no-op without a live lease)
            tier.leases.resolve(hash32)
        if tier_owner is not None and push_owner:
            # write-through at the owner (bounded background push): the
            # next reader of this block — on any node — probe-hits
            # instead of paying another gather+decode. tier_owner is
            # only resolved inside the cacheable branch, so SSE-C
            # payloads never reach the tier push
            tier.insert_at(tier_owner, hash32, data)
        if charge_fn is not None:
            # charged symmetrically with the hit path above: a byte
            # budget that only priced one of RAM/store reads would
            # invert the cache's advantage (or let hot sets ride free)
            await charge_fn(len(data))
        return data

    async def _read_store(self, hash32: bytes) -> bytes:
        """Node-local read singleflight: the first caller of
        a hash becomes the LEADER and pays the store gather+decode;
        every concurrent caller awaits the leader's future instead of
        decoding the same bytes again. A leader that fails or is
        cancelled releases the hash — one surviving waiter retries (and
        becomes the new leader), so collapse can never lose a read that
        would have succeeded solo. Cacheable reads only: SSE-C stays on
        the direct _get_uncached path."""
        fut = self._sf.get(hash32)
        if fut is not None:
            self.sf_collapsed += 1
            registry().inc("cache_sf_collapsed")
            try:
                # shield: one waiter's client disconnecting must not
                # cancel the leader's decode out from under the rest
                return await asyncio.shield(fut)
            except asyncio.CancelledError:
                if not fut.cancelled():
                    raise  # THIS caller was cancelled, not the leader
            except Exception as e:
                # leader failed; retry below, possibly as the new leader
                log.debug("read singleflight leader for %s failed: %s",
                          hash32[:4].hex(), e)
            return await self._read_store(hash32)
        fut = asyncio.get_running_loop().create_future()
        self._sf[hash32] = fut
        self.sf_leaders += 1
        registry().inc("cache_sf_leader")
        try:
            data = await self._get_uncached(hash32, fill_packed=True)
        except BaseException as e:
            if isinstance(e, asyncio.CancelledError):
                fut.cancel()
            else:
                fut.set_exception(e)
                fut.exception()  # consumed: no orphan-future warning
            raise
        else:
            fut.set_result(data)
            return data
        finally:
            self._sf.pop(hash32, None)

    async def _get_uncached(self, hash32: bytes,
                            fill_packed: bool = False) -> bytes:
        self.metrics["store_reads"] += 1
        if self.erasure:
            # verification happens inside: a decode is retried against
            # every distinct packed_len candidate before giving up.
            # fill_packed (cacheable reads only — _read_store sets it,
            # the direct SSE-C path never does) admits the reassembled
            # packed bytes into the packed tier segment for the
            # rebuild/repair lane.
            return await self._get_erasure(hash32,
                                           fill_packed=fill_packed)
        packed, verified = await self._get_replicate(hash32)

        def unpack_verify() -> bytes:
            blk = DataBlock.unpack(packed)
            if not verified:
                blk.verify(hash32)
            return blk.plain_bytes()

        # MiB-scale decompress+hash release the GIL: run them in a
        # worker thread so the GET readahead pipeline's prefetches
        # genuinely overlap instead of serializing on the event loop
        if len(packed) >= 64 * 1024:
            return await asyncio.to_thread(unpack_verify)
        return unpack_verify()

    async def _get_replicate(self, hash32: bytes) -> tuple[bytes, bool]:
        """-> (packed block, already_content_verified). Local reads
        verify inside read_local — re-hashing the same MiB in
        rpc_get_block doubled the CPU cost of every local GET block.

        Remote failover is HEDGED: when the current holder hasn't
        answered within its observed p95, the next candidate (breaker-
        and ping-ranked) is asked in parallel instead of waiting out
        the full timeout — a hung holder costs one hedge delay, not
        30-60 s (Dean & Barroso, "The Tail at Scale")."""
        me = self.system.id
        nodes = self.system.layout_helper.block_read_nodes_of(hash32)
        errs: list[Exception] = []
        if me in nodes:
            try:
                # off the event loop: a cold-cache disk read plus the
                # content verify would stall every other request for
                # milliseconds per block
                local = await asyncio.to_thread(self.read_local, hash32)
                if local is not None:
                    return local, True
            except OSError as e:
                # injected/real local EIO: degrade to the remote holders
                errs.append(e)
        remote = self.rpc.request_order([n for n in nodes if n != me])
        race = HedgedRace(self.rpc.health(), "block_get")
        i = 0

        def launch(hedged: bool = False):
            nonlocal i
            node = remote[i]
            i += 1
            race.launch(node, self.rpc.call(
                self.endpoint, node,
                {"op": "get", "hash": hash32, "part": None},
                PRIO_NORMAL, timeout=60.0,
            ), hedged)

        if remote:
            launch()
        try:
            while race.pending:
                done = await race.wait(
                    can_hedge=i < len(remote),
                    launch_hedge=lambda: launch(hedged=True))
                # drain EVERY completed task before returning: a loser
                # that failed in the same wait round must have its
                # exception retrieved, or asyncio logs an orphan
                won = None
                won_node = None
                for _node, was_hedged, t in done:
                    try:
                        resp = t.result()
                        if won is None and resp.get("data") is not None:
                            won = resp["data"]
                            won_node = _node
                            race.note_success(was_hedged)
                    except Exception as e:
                        errs.append(e)
                if won is not None:
                    self._count_remote_read(won_node, len(won))
                    return won, False
                # every holder in this round failed or had no copy:
                # move down the list
                if done and i < len(remote):
                    launch()
        finally:
            # a task that finished between the wait and this cleanup
            # still needs its exception consumed
            race.cancel_pending()
        raise MissingBlock(hash32)

    def _count_remote_read(self, node: bytes, nbytes: int) -> None:
        """Remote-read byte accounting by zone locality:
        request_order keeps reads local-zone-first, so the cross-zone
        series should stay a small fraction of the total — bench_zone
        and the zone-partition drill assert on exactly that ratio."""
        registry().inc("block_remote_read_bytes", nbytes)
        layout = self.system.layout_helper.current()
        mine = layout.node_role(self.system.id)
        theirs = layout.node_role(node)
        if mine is None or theirs is None \
                or not mine.zone or not theirs.zone:
            return
        if mine.zone != theirs.zone:
            registry().inc("block_cross_zone_read_bytes", nbytes)

    async def _get_erasure(self, hash32: bytes,
                           fill_packed: bool = False) -> bytes:
        """Gather k shards, decode, verify against the content address.

        The shard header's packed_len field sits outside the shard
        checksum, so _gather_parts majority-votes it — but a vote can
        TIE (e.g. k=2 with one rotted header). On verify failure every
        other distinct candidate is decoded and checked before moving
        on: a recoverable block must never be reported corrupt because
        the wrong tiebreak was picked (ADVICE r5).

        A local packed-tier hit short-circuits the whole
        gather: the cached bytes ARE the reassembled packed block
        (content-verified at admission), so only the unpack+verify
        remains."""
        if fill_packed:
            cached = self.packed_cache.get(hash32)
            if cached is not None:
                registry().inc("cache_packed_local_hit")

                def unpack_cached() -> bytes:
                    blk = DataBlock.unpack(cached)
                    blk.verify(hash32)
                    return blk.plain_bytes()

                try:
                    if len(cached) >= 64 * 1024:
                        return await asyncio.to_thread(unpack_cached)
                    return unpack_cached()
                except CorruptData:
                    # can't happen for an admission-verified entry, but
                    # a cache must never be the lane that serves rot
                    self.packed_cache.discard(hash32)
        helper = self.system.layout_helper
        versions = list(reversed(
            helper.history.versions + helper.history.old_versions
        ))
        tried = set()
        gathered_any = False
        for v in versions:
            placement = shard_nodes_of(v, hash32, self.codec.width)
            key = tuple(placement)
            if key in tried or not placement:
                continue
            tried.add(key)
            got = await self._gather_parts(hash32, placement,
                                           self.codec.read_need)
            if got is None:
                continue
            gathered_any = True
            parts, candidates, _lens = got
            for packed_len in candidates:
                try:
                    packed = await self._decode_parts(parts, packed_len)

                    def unpack_verify(packed=packed) -> bytes:
                        blk = DataBlock.unpack(packed)
                        blk.verify(hash32)
                        return blk.plain_bytes()

                    # MiB-scale decompress+verify off the event loop,
                    # same rule as the replicate read path
                    if len(packed) >= 64 * 1024:
                        plain = await asyncio.to_thread(unpack_verify)
                    else:
                        plain = unpack_verify()
                    if fill_packed:
                        # the decode just proved these ARE the packed
                        # bytes behind the content address: admit them
                        # into the packed tier segment so the next
                        # rebuild/degraded read skips the gather
                        self._packed_fill(hash32, packed)
                    return plain
                except (CorruptData, ValueError, IndexError):
                    # a forged/rotted length can make the decode itself
                    # blow up, not just the content check — either way
                    # the next candidate gets its chance
                    log.info("block %s: decode at packed_len=%d failed "
                             "verification", hash32[:4].hex(), packed_len)
                    continue
        if gathered_any:
            raise CorruptData(hash32)
        raise MissingBlock(hash32)

    def _packed_fill(self, hash32: bytes, packed) -> None:
        """Admit freshly decoded+verified packed bytes into the packed
        tier segment: locally when this node is the hash's ring owner
        (or routing is moot), else a bounded background push to the
        owner — same one-copy-per-ring discipline as the plain segment.
        Only reachable from fill_packed=True paths, which only cacheable
        reads set (the SSE-C audit boundary)."""
        pc = getattr(self, "packed_cache", None)
        if pc is None:
            return
        tier = getattr(self, "cache_tier", None)
        owner = tier.owner_of(hash32) if tier is not None else None
        if owner is not None:
            # fill_packed is only set by _read_store, which SSE-C reads
            # (cacheable=False) never enter
            tier.insert_at(owner, hash32, bytes(packed), kind="packed")
        elif pc.max_bytes > 0:
            pc.insert(hash32, bytes(packed))
            registry().inc("cache_packed_insert_local")

    async def packed_from_tier(self, hash32: bytes) -> Optional[bytes]:
        """Exact on-disk packed block bytes from the packed tier
        segment, or None — the rebuild/repair lane (resync's
        _rebuild_shard, repair's _repair_stripe). Local segment first;
        a REMOTE probe is hint-gated like resync's plain-tier fetches,
        so a rebalance wave over a million cold blocks never sprays a
        million wasted probes. Returned bytes were content-verified at
        admission (and re-verified by probe_packed for the remote
        case)."""
        pc = getattr(self, "packed_cache", None)
        packed = pc.get(hash32) if pc is not None else None
        if packed is not None:
            registry().inc("cache_packed_local_hit")
            return packed
        tier = getattr(self, "cache_tier", None)
        if tier is None or not tier.is_hot(hash32):
            return None
        owner = tier.owner_of(hash32)
        if owner is None:
            return None
        return await tier.probe_packed(owner, hash32)

    async def _decode_parts(self, parts: dict[int, bytes],
                            packed_len: int) -> bytes:
        """Stripe parts -> packed block bytes. The all-systematic case
        is a pure concat (codec.decode, no math, no queue hop); a
        DEGRADED set routes through the feeder's batched `decode` op,
        so concurrent degraded GETs — and scrub/resync rebuild waves —
        coalesce into one pattern-as-data device launch instead of one
        blocking host matmul per block on the event loop."""
        codec = self.codec
        idx = tuple(sorted(parts.keys())[: codec.read_need])
        if len(parts) < codec.read_need:
            raise MissingBlock(b"")
        if all(i < codec.k for i in idx):
            return codec.decode(parts, packed_len)
        return await self.feeder.decode(idx, [parts[i] for i in idx],
                                        packed_len)

    async def _gather_parts(self, hash32: bytes, placement: list[bytes],
                            need: int):
        """Fetch parts concurrently until `need` distinct indices are in
        hand; over-request nothing (systematic shards first, then the
        rest on failure). -> (parts, packed_len candidates ranked by
        vote count majority first, per-index header packed_len) or
        None. The per-index map lets deep scrub see WHICH holder's
        header disagrees with the majority (header rot repair)."""
        me = self.system.id

        async def fetch(node, idx):
            try:
                if node == me:
                    # off the event loop: deep scrub drives MiB-scale
                    # local reads through here, and a cold-cache disk
                    # read would stall every foreground request
                    # (ADVICE r5)
                    raw = await asyncio.to_thread(
                        self.read_local_shard, hash32, idx)
                    if raw is None:
                        return None
                    # lint: ignore[GL10] shard crc is native-C microseconds; the flagged open/cc chain is the one-time kernel build, cached for the process lifetime
                    return unpack_shard(raw)
                # self.rpc.call (not endpoint.call): the helper records
                # per-peer health and applies the adaptive timeout, so
                # a hung holder stops costing the full flat timeout
                # once its p99 is known
                resp = await self.rpc.call(
                    self.endpoint, node,
                    {"op": "get", "hash": hash32, "part": idx},
                    PRIO_NORMAL, timeout=60.0,
                )
                if resp.get("data") is None:
                    return None
                return unpack_shard(resp["data"])
            except Exception as e:
                # local disk/unpack failures are a different signal
                # than a peer fetch failing; don't conflate them
                registry().inc("block_shard_fetch_errors",
                               source="local" if node == me else "remote")
                log.debug("shard fetch part=%d from %s failed: %s",
                          idx, node[:4].hex(), e)
                return None

        race = HedgedRace(self.rpc.health(), "block_get_shard")
        parts: dict[int, bytes] = {}
        lens_by_idx: dict[int, int] = {}
        order = list(enumerate(placement))  # systematic first by design
        i = 0

        def launch_next(hedged: bool = False):
            nonlocal i
            idx, node = order[i]
            i += 1
            race.launch(idx, fetch(node, idx), hedged)

        try:
            while len(parts) < need and (race.pending or i < len(order)):
                while i < len(order) \
                        and len(race.pending) < need - len(parts):
                    launch_next()
                if not race.pending:
                    break
                # when every in-flight shard fetch is past its holder's
                # observed p95, the hedge launches the next candidate
                # shard instead of waiting out a hung holder (exceeds
                # the need-len(parts) concurrency cap by design)
                done = await race.wait(
                    can_hedge=i < len(order),
                    launch_hedge=lambda: launch_next(hedged=True),
                    hedge_nodes=[placement[idx]
                                 for idx, _ in race.pending.values()])
                for idx, was_hedged, t in done:
                    r = t.result()
                    if r is not None:
                        parts[idx] = r[0]
                        lens_by_idx[idx] = r[1]
                        race.note_success(was_hedged)
        finally:
            # cancel stragglers (hedges included) on every exit path —
            # a client disconnect cancels this coroutine at the wait
            # above, and the in-flight MiB-scale fetches must not keep
            # running for nobody; fetch() swallows its own errors so
            # nothing logs
            race.cancel_pending()
        if len(parts) < need:
            return None
        lens = list(lens_by_idx.values())
        # MAJORITY packed_len, not last-arrival: the shard header's
        # length field is outside the shard checksum, so one rotted or
        # forged header must not poison the whole decode (deep-scrub
        # repair decodes candidate subsets against this value; the read
        # path would fail content verification and miss a recoverable
        # block). With <= m corrupt shards the majority is the truth —
        # but a vote can TIE, so every distinct value is returned ranked
        # by count (ties broken toward the larger length: truncating a
        # real block always fails verification, padding can succeed for
        # trailing-zero payloads) and callers that verify content try
        # them in order.
        ranked = sorted(set(lens),
                        key=lambda v: (-lens.count(v), -v))
        return parts, ranked, lens_by_idx

    # ==== refcount hooks (called from block_ref table trigger) ==========

    def block_incref(self, tx, hash32: bytes) -> None:
        if self.rc.block_incref(tx, hash32):
            tx.on_commit(lambda: self.resync.push_now(hash32))

    def block_decref(self, tx, hash32: bytes) -> None:
        if self.rc.block_decref(tx, hash32):
            def on_unreferenced():
                # the block just became deletable: drop its cached
                # payload now — a ghost must not pin RAM for gc_delay
                cache = getattr(self, "cache", None)
                if cache is not None:
                    cache.discard(hash32)
                pc = getattr(self, "packed_cache", None)
                if pc is not None:
                    pc.discard(hash32)
                self.resync.push_at(hash32, time.time() + self.rc.gc_delay)

            tx.on_commit(on_unreferenced)

    @property
    def _chaos_node(self) -> bytes:
        """Local node id for chaos fault scoping (bare test managers
        built via __new__ have no system)."""
        s = getattr(self, "system", None)
        return getattr(s, "id", b"") or b""

    # ==== local file store (ref: manager.rs:709-805) ====================

    def _find(self, hash32: bytes, suffixes) -> Optional[str]:
        for d in self.data_layout.candidate_dirs(hash32):
            for sfx in suffixes:
                p = os.path.join(d, hash32.hex() + sfx)
                if os.path.exists(p):
                    return p
        return None

    def _write_file(self, path: str, content: bytes) -> None:
        d = os.path.dirname(path)
        # lazy init: tests build bare managers via __new__
        made = getattr(self, "_made_dirs", None)
        if made is None:
            made = self._made_dirs = set()
        if d not in made:
            os.makedirs(d, exist_ok=True)
            if len(made) >= 65536:
                made.clear()
            made.add(d)
        # unique tmp per writer: two concurrent puts of the same
        # content-addressed file must not steal each other's tmp (the
        # reference serializes via hash-sharded mutexes, manager.rs:113;
        # here either rename winning is fine — the bytes are identical)
        tmp = path + f".tmp{next(_tmp_ctr)}"
        for attempt in range(2):
            try:
                with open(tmp, "wb") as f:
                    f.write(content)
                    if self.fsync:
                        f.flush()
                        os.fsync(f.fileno())
                break
            except FileNotFoundError:
                # cached dir vanished under us (quarantine/rebalance
                # pruning): recreate and retry once
                if attempt:
                    raise
                os.makedirs(d, exist_ok=True)
        os.replace(tmp, path)
        if self.fsync:
            dirfd = os.open(os.path.dirname(path), os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        self.metrics["bytes_written"] += len(content)

    def write_local(self, hash32: bytes, packed: bytes) -> None:
        """Store a whole packed DataBlock (1-byte scheme + payload)."""
        self.write_local_payload(hash32, packed[0],
                                 memoryview(packed)[1:])

    def write_local_payload(self, hash32: bytes, comp: int,
                            payload) -> None:
        """Store a whole block from (scheme, payload) — the zero-copy
        form the "put" RPC carries (the payload is never concat-copied
        behind a packed header byte)."""
        from .block import SUFFIX_OF

        suffix = SUFFIX_OF.get(comp)
        if suffix is None:
            raise CorruptData(hash32)
        if _chaos.ACTIVE is not None:
            # chaos seam (disk write): EIO or torn write
            payload = _chaos.ACTIVE.disk_write(self._chaos_node, hash32,
                                               payload)
        path = self.data_layout.block_path(hash32, suffix)
        self._write_file(path, payload)
        # drop other-compression variants if present (ref: manager.rs
        # write_block replaces regardless of compression state)
        for sfx in BLOCK_SUFFIXES:
            if sfx == suffix:
                continue
            other = self.data_layout.block_path(hash32, sfx)
            if os.path.exists(other):
                os.remove(other)

    def read_local(self, hash32: bytes) -> Optional[bytes]:
        """-> packed DataBlock bytes, verifying content hash
        (ref: manager.rs:554-609)."""
        p = self._find(hash32, BLOCK_SUFFIXES)
        if p is None:
            return None
        with open(p, "rb") as f:
            raw = f.read()
        if _chaos.ACTIVE is not None:
            # chaos seam (disk read): EIO or single-bit rot, scoped by
            # local node id + hash prefix; rot is caught by the content
            # verify below exactly like real media decay would be
            raw = _chaos.ACTIVE.disk_read(self._chaos_node, hash32, raw)
        self.metrics["bytes_read"] += len(raw)
        blk = DataBlock(comp_of_path(p), raw)
        try:
            blk.verify(hash32)
        except CorruptData:
            self._quarantine(p, hash32)
            return None
        return blk.pack()

    def write_local_shard(self, hash32: bytes, part: int, raw: bytes) -> None:
        validate_shard(raw)  # checksum before storing (no payload copy)
        if _chaos.ACTIVE is not None:
            # chaos seam (disk write), after validation: a torn image
            # lands on disk and the next read's checksum catches it
            raw = _chaos.ACTIVE.disk_write(self._chaos_node, hash32, raw)
        self._write_file(self.data_layout.block_path(hash32, f".s{part}"), raw)

    def read_local_shard(self, hash32: bytes, part: int) -> Optional[bytes]:
        p = self._find(hash32, [f".s{part}"])
        if p is None:
            return None
        with open(p, "rb") as f:
            raw = f.read()
        if _chaos.ACTIVE is not None:
            # chaos seam (disk read): a rotted shard fails the checksum
            # check below -> quarantine + resync, and the erasure read
            # falls through to the remaining shards (degraded decode)
            raw = _chaos.ACTIVE.disk_read(self._chaos_node, hash32, raw)
        self.metrics["bytes_read"] += len(raw)
        try:
            unpack_shard(raw)
        except CorruptData:
            self._quarantine(p, hash32)
            return None
        return raw

    def local_parts(self, hash32: bytes) -> list[int]:
        """Shard indices stored here."""
        out = []
        for d in self.data_layout.candidate_dirs(hash32):
            if not os.path.isdir(d):
                continue
            pre = hash32.hex() + ".s"
            for fn in os.listdir(d):
                if fn.startswith(pre) and ".tmp" not in fn \
                        and not fn.endswith(".corrupted"):
                    try:
                        out.append(int(fn[len(pre):]))
                    except ValueError:
                        pass
        return sorted(set(out))

    def has_local(self, hash32: bytes) -> bool:
        if self.erasure:
            return bool(self.local_parts(hash32))
        return self._find(hash32, BLOCK_SUFFIXES) is not None

    def is_shard_needed(self, hash32: bytes) -> bool:
        """Answer to the 'need' RPC: does this node still want data for
        this block? In erasure mode, needed = rc-referenced AND our
        layout-assigned shard index is missing (holding some *other*
        stale shard doesn't satisfy the assignment)."""
        if not self.rc.is_needed(hash32):
            return False
        if not self.erasure:
            return not self.has_local(hash32)
        placement = shard_nodes_of(self.system.layout_helper.current(),
                                   hash32, self.codec.width)
        me = self.system.id
        if me not in placement:
            return False
        return placement.index(me) not in self.local_parts(hash32)

    def delete_local(self, hash32: bytes) -> None:
        cache = getattr(self, "cache", None)
        if cache is not None:
            cache.discard(hash32)
        pc = getattr(self, "packed_cache", None)
        if pc is not None:
            pc.discard(hash32)
        for d in self.data_layout.candidate_dirs(hash32):
            if not os.path.isdir(d):
                continue
            for fn in os.listdir(d):
                if not fn.startswith(hash32.hex()) \
                        or fn.endswith(".corrupted"):
                    continue
                if ".tmp" in fn:
                    # in-flight write (writer renames tmp -> final):
                    # since an earlier change delete_local and write_local run in
                    # worker threads, so the listdir can catch a tmp
                    # that the writer renames before our remove lands;
                    # abandoned tmps are sweep_stale_tmp's job
                    continue
                try:
                    os.remove(os.path.join(d, fn))
                except FileNotFoundError:
                    pass  # lost the race to a concurrent delete/rename

    def _quarantine(self, path: str, hash32: bytes) -> None:
        """Corrupted file: move aside + queue resync
        (ref: manager.rs:586-601)."""
        log.warning("corrupted block file %s", path)
        self.metrics["corruptions"] += 1
        try:
            os.replace(path, path + ".corrupted")
        except OSError:
            pass
        self.resync.push_now(hash32)

    def sweep_stale_tmp(self, root: str, files: list[str]) -> None:
        """Delete .tmpN orphans older than _TMP_MAX_AGE (a writer that
        crashed between open and rename leaves one; unique tmp names
        mean nothing else ever reclaims it). Called from the walking
        iterators so the scrub pass doubles as the janitor."""
        now = time.time()
        for fn in files:
            if ".tmp" not in fn:
                continue
            p = os.path.join(root, fn)
            try:
                if now - os.stat(p).st_mtime > _TMP_MAX_AGE:
                    os.remove(p)
            except OSError:
                pass

    def iter_local_blocks(self, parts: Optional[set] = None):
        """Yield (hash32, path) for every stored block/shard file.
        `parts` restricts the walk to those partitions (h[0] values —
        PARTITION_BITS is 8, so partition == first hash byte): the
        on-disk layout keys the first directory level by h[0].hex(),
        so pruning there skips whole subtrees instead of stat()ing
        every file in the store (the rebalance enumerator's
        moved-partition scoping)."""
        seen = set()
        for d in self.data_layout.dirs:
            for root, dirs, files in os.walk(d.path):
                if parts is not None and root == d.path:
                    dirs[:] = [x for x in dirs
                               if len(x) == 2 and _hex_in(x, parts)]
                self.sweep_stale_tmp(root, files)
                for fn in files:
                    if ".tmp" in fn or fn.endswith(".corrupted"):
                        continue
                    hexpart = fn.split(".")[0]
                    try:
                        h = bytes.fromhex(hexpart)
                    except ValueError:
                        continue
                    if len(h) == 32 and h not in seen:
                        if parts is not None and h[0] not in parts:
                            continue
                        seen.add(h)
                        yield h, os.path.join(root, fn)

    def iter_local_blocks_sorted(self, start: bytes = b""):
        """Yield distinct hash32 in ascending hash order, resuming after
        `start`. One pass over the tree: the on-disk layout is keyed by
        hash prefix ({h[0]}/{h[1]}/{hex}), so walking the two prefix
        levels in sorted order gives global hash order without holding
        the whole listing in memory (scrub cursor resume, ref
        repair.rs:169-232 BlockStoreIterator)."""
        roots = [d.path for d in self.data_layout.dirs]
        # discover which prefix dirs actually exist (a sparse store has
        # few) instead of probing all 65,536 combinations
        lvl1_of: dict[str, list[str]] = {}
        for r in roots:
            try:
                l1s = os.listdir(r)
            except OSError:
                continue
            for l1 in l1s:
                if len(l1) == 2:
                    lvl1_of.setdefault(l1, []).append(r)
        start_l1 = start[:1].hex() if start else ""
        start_l2 = start[1:2].hex() if len(start) >= 2 else ""
        for lvl1 in sorted(lvl1_of):
            if lvl1 < start_l1:
                continue
            lvl2s: dict[str, list[str]] = {}
            for r in lvl1_of[lvl1]:
                try:
                    l2s = os.listdir(os.path.join(r, lvl1))
                except OSError:
                    continue
                for l2 in l2s:
                    if len(l2) == 2:
                        lvl2s.setdefault(l2, []).append(r)
            for lvl2 in sorted(lvl2s):
                if lvl1 == start_l1 and lvl2 < start_l2:
                    continue
                names = set()
                for r in lvl2s[lvl2]:
                    d = os.path.join(r, lvl1, lvl2)
                    try:
                        ls = os.listdir(d)
                    except OSError:
                        continue
                    self.sweep_stale_tmp(d, ls)
                    names.update(ls)
                hashes = set()
                for fn in names:
                    if ".tmp" in fn or fn.endswith(".corrupted"):
                        continue
                    try:
                        h = bytes.fromhex(fn.split(".")[0])
                    except ValueError:
                        continue
                    if len(h) == 32 and h > start:
                        hashes.add(h)
                yield from sorted(hashes)

    # ==== server side ===================================================

    async def _handle(self, from_node: bytes, payload, stream):
        op = payload["op"]
        h = payload.get("hash", b"")
        if op == "put":
            part = payload.get("part")
            if part is None:
                comp = payload.get("comp")
                if comp is not None:
                    await asyncio.to_thread(self.write_local_payload, h,
                                            comp, payload["data"])
                else:  # legacy packed form (resync push path)
                    await asyncio.to_thread(self.write_local, h,
                                            payload["data"])
            else:
                data = payload["data"]
                if self.fsync or len(data) > (512 << 10):
                    await asyncio.to_thread(self.write_local_shard, h,
                                            part, data)
                else:
                    # a ~256 KiB tmpfs/page-cache write costs less than
                    # the thread handoff it would ride; six shards per
                    # block made the hops a measured top cost
                    # lint: ignore[GL10] measured: small no-fsync shard writes cost less than the to_thread handoff (the fsync/large branch above does hop)
                    self.write_local_shard(h, part, data)
            return {"ok": True}
        if op == "get":
            part = payload.get("part")
            if part is None:
                data = await asyncio.to_thread(self.read_local, h)
            else:
                data = await asyncio.to_thread(self.read_local_shard, h, part)
            return {"data": data}
        if op == "need":
            needed = await asyncio.to_thread(self.is_shard_needed, h)
            return {"needed": needed}
        if op == "cache_probe":
            # cluster cache tier: read-only, single-hop,
            # RAM-only — a miss answers None and NEVER falls through to
            # the store (the prober's local path is the fallback, so a
            # probe can't chain or amplify). Hedge-safe by construction:
            # re-asking an idempotent RAM lookup is free (a re-asked
            # lease grant re-mints or re-parks, both idempotent too).
            # an earlier change: `kinds` selects the segments (plain/packed);
            # `wait_ms`+`lease` engage the singleflight protocol — a
            # miss behind a live lease PARKS here (inside the caller's
            # flat probe timeout, clamped again server-side), a bare
            # miss with lease=True mints one for the caller.
            kinds = payload.get("kinds") or ("plain",)
            data, kind = self._tier_lookup(h, kinds)
            tier = getattr(self, "cache_tier", None)
            if data is None and tier is not None and "plain" in kinds:
                wait_ms = min(float(payload.get("wait_ms") or 0.0),
                              tier.probe_wait_ms())
                if wait_ms > 0 and tier.leases.live(h):
                    await tier.leases.wait(h, wait_ms / 1000.0)
                    data, kind = self._tier_lookup(h, kinds)
                    if data is None:
                        registry().inc("cache_tier_serve_miss")
                        return {"data": None, "waited": True}
                    registry().inc("cache_tier_serve_hit")
                    return {"data": data, "kind": kind,
                            "waited": True}
                if wait_ms > 0 and payload.get("lease") \
                        and self.cache.max_bytes > 0 \
                        and tier.leases.mint(h, from_node):
                    registry().inc("cache_tier_serve_miss")
                    return {"data": None, "lease": True}
            if data is not None:
                registry().inc("cache_tier_serve_hit")
            else:
                registry().inc("cache_tier_serve_miss")
            return {"data": data, "kind": kind}
        if op == "cache_insert":
            # write-through from a non-owner's miss-decode. Content-
            # verified before admission: a content-addressed cache must
            # never hold bytes that don't hash to their key, or every
            # future probe hit serves corruption with a straight face.
            data = payload["data"]
            if payload.get("kind", "plain") == "packed":
                # packed segment: verification = unpack +
                # content verify — the address covers the plain bytes,
                # so a successful unpack-verify proves the packed image
                pc = getattr(self, "packed_cache", None)
                if pc is None or pc.max_bytes <= 0:
                    return {"ok": False}

                def check_packed() -> None:
                    DataBlock.unpack(data).verify(h)

                try:
                    await asyncio.to_thread(check_packed)
                except Exception:
                    registry().inc("cache_tier_insert_corrupt")
                    log.warning("packed tier insert of %s from %s "
                                "failed verification; dropped",
                                h[:4].hex(), from_node[:4].hex())
                    return {"ok": False}
                pc.insert(h, data)
                registry().inc("cache_tier_insert_served")
                return {"ok": True}
            cache = getattr(self, "cache", None)
            if cache is None or cache.max_bytes <= 0:
                return {"ok": False}
            from ..utils.data import content_hash_matches

            if not await asyncio.to_thread(content_hash_matches,
                                           data, h):
                registry().inc("cache_tier_insert_corrupt")
                log.warning("tier insert of %s from %s failed content "
                            "verification; dropped", h[:4].hex(),
                            from_node[:4].hex())
                return {"ok": False}
            cache.insert(h, data)
            tier = getattr(self, "cache_tier", None)
            if tier is not None:
                # the lease holder's bytes just landed: wake every
                # prober parked on this hash (no-op without a lease)
                tier.leases.resolve(h)
            registry().inc("cache_tier_insert_served")
            return {"ok": True}
        raise RpcError(f"unknown block op {op!r}")

    def _tier_lookup(self, h: bytes, kinds):
        """RAM-only lookup across the requested tier segments, plain
        preferred (a GET wants the decoded payload; packed costs the
        prober an unpack). -> (data, kind) or (None, None)."""
        if "plain" in kinds:
            cache = getattr(self, "cache", None)
            data = cache.get(h) if cache is not None else None
            if data is not None:
                return data, "plain"
        if "packed" in kinds:
            pc = getattr(self, "packed_cache", None)
            data = pc.get(h) if pc is not None else None
            if data is not None:
                return data, "packed"
        return None, None
