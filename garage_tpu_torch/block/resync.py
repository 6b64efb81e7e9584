"""Copy of garage_tpu/block/resync.py: import paths rewritten, issue and PR tags dropped.

Block resync: the self-healing queue of the block store.

Ref parity: src/block/resync.rs. A persistent queue (db tree keyed by
due-time ++ hash) drives re-examination of blocks: a block this node
needs but lacks is fetched from a holder (or, in erasure mode, its shard
is rebuilt from any k others — TPU repair matmul); a block held but no
longer needed is offered to nodes that still need it, then deleted.
Failures back off exponentially 1 min -> 64 min in a persistent error
tree, so a dead peer doesn't melt the queue.

Resize participation: a layout version bump enumerates every
block this node holds or references into the queue (the rebalance
backlog); draining it IS the data migration, and an empty queue after
a rebalance lets the block layer report its layout-sync position so
old versions can be GC'd. Placement decisions consult the shared
PeerHealthTracker: rebalance traffic never re-queues at a peer whose
circuit breaker is open — it spreads across healthy holders and lets
the backoff retry the broken one after its breaker closes.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Optional

from ..net.message import PRIO_BACKGROUND
from ..utils.background import Worker, WState, spawn
from ..utils.error import MissingBlock
from ..utils.metrics import registry
from .codec import shard_nodes_of
from .manager import pack_shard, unpack_shard

log = logging.getLogger("garage_tpu_torch.block.resync")

RESYNC_RETRY_DELAY = 60.0  # doubles up to 64x (ref: resync.rs:37-40)
MAX_RESYNC_WORKERS = 8


class BlockResyncManager:
    def __init__(self, manager, db, breaker_aware: bool = True):
        self.manager = manager
        self.db = db
        self.queue = db.open_tree("block_resync_queue")  # due_ms ++ hash -> b""
        self.errors = db.open_tree("block_resync_errors")  # hash -> (count, next_ms)
        self.meta = db.open_tree("block_resync_meta")  # rebalance marker
        self.n_workers = 1
        self.tranquility = 0.0
        # True after an operator `worker set resync-tranquility`: the
        # qos governor leaves the knob alone until re-enabled
        self.tranquility_manual = False
        # `[block] resync_breaker_aware`: skip open-breaker peers when
        # placing rebalance pushes/fetches
        self.breaker_aware = breaker_aware
        # shard rebuilds served from the packed-bytes tier segment
        #: each one skipped a whole k-shard gather
        self.rebuild_tier_hits = 0
        # error backoff base — tests/benches shrink it so chaos-induced
        # failures retry within the harness window instead of in a
        # minute
        self.retry_delay = RESYNC_RETRY_DELAY
        # layout version whose rebalance enumeration has COMPLETED
        # (None until bootstrap_layout_marker or an enumeration runs)
        self._enumerated_version: Optional[int] = None
        self._enumerating = 0
        # blocks popped from the queue but still being resynced; an idle
        # worker must not report "backlog drained" while a sibling
        # worker holds the last block in flight (it may fail + re-queue,
        # and the sync tracker is monotonic — a premature report can't
        # be retracted)
        self._in_flight = 0
        # (version, retry-not-before) of a rebalance enumeration that
        # FAILED: the marker is persisted before the scan runs, so
        # note_layout_change won't re-fire for this version — the
        # worker idle path retries from here instead
        self._enumerate_retry: Optional[tuple[int, float]] = None
        # consecutive breaker deferrals per block (cleared on success):
        # past DEFER_CAP the block falls back to the exponential error
        # backoff — a PERMANENTLY dead holder must not be probed every
        # breaker cooldown forever
        self._defer_counts: dict[bytes, int] = {}

    # ---- layout rebalance ------------------------------------

    def _marker(self) -> Optional[int]:
        raw = self.meta.get(b"rebalance_version")
        return int.from_bytes(raw, "big") if raw else None

    def _set_marker(self, version: int) -> None:
        self.meta.insert(b"rebalance_version", version.to_bytes(8, "big"))

    def _current_version(self) -> int:
        s = getattr(self.manager, "system", None)
        return (s.layout_helper.current().version
                if s is not None else 0)

    def bootstrap_layout_marker(self) -> None:
        """Boot-time resume: a fresh store adopts the current layout
        version vacuously (nothing to move); a store whose persisted
        marker — or whose own persisted sync tracker — is behind the
        current version crashed or was offline during a transition and
        re-enumerates, so a kill-and-restart resumes the migration
        instead of silently forgetting it."""
        v = self._current_version()
        marker = self._marker()
        if marker is None:
            self._set_marker(v)
            self._enumerated_version = v
            return
        s = self.manager.system
        synced = s.layout_manager.history.update_trackers.sync.get(
            s.id, 0)
        if marker < v or synced < marker:
            self.enqueue_rebalance(v)
        else:
            self._enumerated_version = marker

    def note_layout_change(self) -> None:
        """LayoutManager.on_change hook — cheap no-op until the current
        version actually moves past the last enumerated one (tracker
        gossip fires this constantly during a transition)."""
        v = self._current_version()
        marker = self._marker()
        if marker is not None and v <= marker:
            return
        self.enqueue_rebalance(v)

    def enqueue_rebalance(self, version: int) -> None:
        """Queue every block this node references or stores in a
        partition whose placement changed between the last enumerated
        layout and `version` (fetch what moved in, offload what moved
        away). Unchanged partitions are skipped — a resize that moves
        1/N of the ring re-examines ~1/N of the store, not all of it."""
        prev = self._marker()
        self._set_marker(version)
        self._enumerating += 1
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            # no running loop (boot-time resume before asyncio.run):
            # enumerate synchronously — it is a startup cost either way
            loop = asyncio.new_event_loop()
            try:
                loop.run_until_complete(self._enumerate(version, prev))
            finally:
                loop.close()
            return
        spawn(self._enumerate(version, prev), "resync-rebalance")

    def _moved_partitions(self, version: int,
                          prev: Optional[int]) -> Optional[set]:
        """Partitions whose full placement tuple differs between layout
        `prev` and `version`, or None when only a full scan is sound
        (no prior marker, either version already GC'd from history).
        Placement is a pure function of the partition — replicate reads
        the ring row, erasure walks successive partitions for width
        distinct nodes (codec.shard_nodes_of) — so comparing one
        synthetic hash per partition covers every block in it."""
        if prev is None or prev == version:
            return None
        m = self.manager
        s = getattr(m, "system", None)
        history = getattr(getattr(s, "layout_manager", None), "history",
                          None)
        if history is None:
            return None
        old = history.get_version(prev)
        new = history.get_version(version)
        if old is None or new is None:
            return None

        from ..rpc.layout.version import N_PARTITIONS

        def placement(lv, p: int) -> tuple:
            if m.erasure:
                synth = bytes([p]) + bytes(31)
                return tuple(shard_nodes_of(lv, synth, m.codec.width))
            return tuple(lv.nodes_of(p))

        return {p for p in range(N_PARTITIONS)
                if placement(old, p) != placement(new, p)}

    async def _enumerate(self, version: int,
                         prev: Optional[int] = None) -> None:
        moved = self._moved_partitions(version, prev)

        def scan() -> int:
            seen: set[bytes] = set()
            for h in self.manager.rc.all_hashes():
                if moved is None or h[0] in moved:
                    seen.add(bytes(h))
            for h, _ in self.manager.iter_local_blocks(parts=moved):
                seen.add(h)
            for h in seen:
                self.push_now(h)
            return len(seen)

        try:
            n = await asyncio.to_thread(scan)
            registry().inc("resync_rebalance_enqueued", n)
            if moved is None:
                registry().inc("resync_rebalance_full_scans")
            else:
                from ..rpc.layout.version import N_PARTITIONS

                registry().inc("resync_rebalance_partitions_scanned",
                               len(moved))
                registry().inc("resync_rebalance_partitions_skipped",
                               N_PARTITIONS - len(moved))
            log.info("layout v%d: %d blocks queued for rebalance (%s)",
                     version, n,
                     "full scan" if moved is None
                     else f"{len(moved)}/256 partitions")
            if self._enumerated_version is None \
                    or version > self._enumerated_version:
                self._enumerated_version = version
            self._enumerate_retry = None
        except Exception as e:
            # without this, a transient scan failure wedges the
            # transition until restart: the marker already says v, so
            # no layout-change hook will ever re-enumerate
            log.warning("layout v%d rebalance enumeration failed, "
                        "will retry: %s", version, e)
            self._enumerate_retry = (version, time.monotonic() + 5.0)
        finally:
            self._enumerating -= 1

    def maybe_report_synced(self) -> bool:
        """Once the rebalance backlog (queue AND error tree) is fully
        drained, report the block layer's sync position to the layout
        manager so the node's sync tracker — and with it old-version
        GC — can advance. Idempotent and cheap; called from the resync
        worker's idle path and the resize harness."""
        retry = self._enumerate_retry
        if retry is not None and not self._enumerating:
            rv, not_before = retry
            if time.monotonic() >= not_before:
                self._enumerate_retry = None
                self.enqueue_rebalance(rv)
            return False
        v = self._enumerated_version
        if v is None or self._enumerating or self._in_flight:
            return False
        if self.queue_len() or self.errors_len():
            return False
        s = getattr(self.manager, "system", None)
        lm = getattr(s, "layout_manager", None)
        if lm is None:
            return False
        # pessimistic tracker (residual): hold the report until
        # every OTHER sync source (the table syncers) has reported v.
        # block_ref rows land — and enqueue their fetches via the ref
        # trigger — strictly BEFORE their table source reports, so once
        # the tables are through and our queue/error/in-flight state is
        # empty, every row-triggered fetch has genuinely drained. Until
        # then an empty queue may only mean the rows haven't arrived
        # yet, and reporting would let the cluster GC a layout version
        # this node still needs to source those blocks from.
        if not lm.sources_synced_through(v, exclude="blocks"):
            return False
        lm.sync_until_from("blocks", v)
        return True

    # ---- breaker-aware placement ---------------------------------------

    def _placement_order(self, nodes) -> tuple[list[bytes], int]:
        """(candidates to try now, count skipped): peers ranked by
        breaker state (healthy first), with open-breaker peers dropped
        from this attempt entirely — pushing at a known-broken peer
        just burns its timeout and re-queues the block."""
        nodes = list(nodes)
        if not self.breaker_aware:
            return nodes, 0
        health = self.manager.rpc.health()
        if health is None:
            return nodes, 0
        now = time.monotonic()
        ranked = sorted(nodes,
                        key=lambda n: health.breaker_rank(n, now))
        keep = [n for n in ranked
                if health.breaker_state(n, now) != "open"]
        skipped = len(nodes) - len(keep)
        if skipped:
            registry().inc("resync_breaker_skip", skipped)
        return keep, skipped

    # ---- queue ---------------------------------------------------------

    @staticmethod
    def _qkey(at: float, hash32: bytes) -> bytes:
        return int(at * 1000).to_bytes(8, "big") + hash32

    def push_now(self, hash32: bytes) -> None:
        self.queue.insert(self._qkey(time.time(), hash32), b"")

    def push_at(self, hash32: bytes, at: float) -> None:
        self.queue.insert(self._qkey(at, hash32), b"")

    def queue_len(self) -> int:
        return len(self.queue)

    def due_len(self, cap: int = 4096) -> int:
        """Entries due NOW — excludes error-backoff and breaker-deferred
        requeues parked in the future, which sit in the queue without
        competing for anything. The governor reads this, not
        queue_len(): a peer outage parks thousands of blocks on 60 s+
        backoffs, and counting them as live pressure would throttle
        idle background work for minutes. Capped: the pressure signal
        saturates at resync_backlog_ref anyway."""
        now_ms = int(time.time() * 1000)
        n = 0
        # limit= keeps the tree from materializing the whole queue
        # under the db lock when an outage parks 100k+ future entries
        for k, _ in self.queue.iter(limit=cap):
            if int.from_bytes(k[:8], "big") > now_ms:
                break
            n += 1
        return n

    def errors_len(self) -> int:
        return len(self.errors)

    def _pop_due(self) -> Optional[bytes]:
        now = time.time()
        for k, _ in self.queue.iter():
            if int.from_bytes(k[:8], "big") > now * 1000:
                return None
            self.queue.remove(k)
            h = k[8:]
            # skip if errored and not yet due for retry
            e = self.errors.get(h)
            if e is not None:
                _, next_ms = self._parse_err(e)
                if next_ms > now * 1000:
                    self.queue.insert(self._qkey(next_ms / 1000, h), b"")
                    continue
            return h
        return None

    @staticmethod
    def _parse_err(raw: bytes) -> tuple[int, int]:
        return int.from_bytes(raw[:4], "big"), int.from_bytes(raw[4:], "big")

    def _record_error(self, hash32: bytes) -> None:
        e = self.errors.get(hash32)
        count = self._parse_err(e)[0] + 1 if e else 1
        delay = self.retry_delay * (2 ** min(count - 1, 6))
        # ±25% jitter: one node outage queues thousands of blocks in
        # the same second, and deterministic doubling would march them
        # all into synchronized retry storms against the recovering peer
        delay *= 1.0 + random.uniform(-0.25, 0.25)
        next_ms = int((time.time() + delay) * 1000)
        self.errors.insert(
            hash32, count.to_bytes(4, "big") + next_ms.to_bytes(8, "big")
        )
        self.queue.insert(self._qkey(next_ms / 1000, hash32), b"")

    def _clear_error(self, hash32: bytes) -> None:
        # NB: deliberately does NOT reset _defer_counts — a deferral
        # returns normally through the worker's success path, and
        # resetting there would defeat the DEFER_CAP escalation; the
        # count clears where the block's move actually completes
        self.errors.remove(hash32)

    def iter_errors(self, limit: int = 1000):
        """[(hash32, failures, next_try_ms)] — `block list-errors`."""
        out = []
        for h, raw in self.errors.iter(limit=limit):
            count, next_ms = self._parse_err(raw)
            out.append((h, count, next_ms))
        return out

    def retry_now(self, hashes=None, all_errors: bool = False) -> int:
        """Clear backoff + requeue (`block retry-now`)."""
        if all_errors:
            hashes = [h for h, _ in self.errors.iter(limit=1 << 20)]
        hashes = hashes or []
        for h in hashes:
            self._clear_error(h)
            self.push_now(h)
        return len(hashes)

    def spawn_workers(self, runner) -> None:
        for i in range(self.n_workers):
            runner.spawn_worker(ResyncWorker(self, i))

    # ---- the resync decision (ref: resync.rs:354-505) ------------------

    async def resync_block(self, hash32: bytes) -> None:
        m = self.manager
        needed = m.rc.is_needed(hash32)
        have = m.has_local(hash32)

        # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
        if have and not needed and m.rc.is_deletable_now(hash32):
            await self._offload(hash32)
            return
        if needed and not have:
            await self._fetch(hash32)
            return
        if needed and have and m.erasure:
            # do we hold the RIGHT shard for the current layout?
            await self._fix_shard_placement(hash32)

    async def _offload(self, hash32: bytes) -> None:
        """Not needed here: give our copy/shard to nodes that need it,
        then delete (ref: resync.rs:404-460). Breaker-aware: an
        open-breaker recipient defers the offload (backoff retry)
        instead of burning a timeout against a known-dead peer — and
        the local copy is NEVER deleted while a recipient was
        skipped."""
        m = self.manager
        me = m.system.id
        if m.erasure:
            placement = shard_nodes_of(m.system.layout_helper.current(),
                                       hash32, m.codec.width)
        else:
            placement = m.system.layout_helper.current_storage_nodes_of(hash32)
        candidates, skipped = self._placement_order(
            n for n in placement if n != me)
        for node in candidates:
            try:
                resp, _ = await m.endpoint.call(
                    node, {"op": "need", "hash": hash32}, PRIO_BACKGROUND
                )
                if not resp.get("needed"):
                    continue
                if m.erasure:
                    want = placement.index(node)
                    raw = await asyncio.to_thread(
                        m.read_local_shard, hash32, want)
                    if raw is None:
                        # rebuild their shard from what we can gather
                        raw = await self._rebuild_shard(hash32, want)
                    if raw is not None:
                        await m.endpoint.call(
                            node, {"op": "put", "hash": hash32,
                                   "part": want, "data": raw},
                            PRIO_BACKGROUND,
                        )
                        m.metrics["resync_bytes"] += len(raw)
                else:
                    packed = await asyncio.to_thread(m.read_local,
                                                     hash32)
                    if packed is not None:
                        await m.endpoint.call(
                            node, {"op": "put", "hash": hash32,
                                   "part": None, "data": packed},
                            PRIO_BACKGROUND,
                        )
                        m.metrics["resync_bytes"] += len(packed)
                m.metrics["resync_sent"] += 1
            except Exception as e:
                log.info("offload %s to %s failed: %s",
                         hash32[:4].hex(), node[:4].hex(), e)
                raise
        if skipped:
            # a recipient with an open breaker never got its copy: keep
            # ours and retry on the BREAKER's timescale (~cooldown, or
            # the error backoff once the deferral cap is hit) — either
            # way the pending queue/error entry keeps the node
            # correctly un-synced until the offload completes
            # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
            if not self._defer(hash32):
                raise RuntimeError(
                    f"offload deferred > {self.DEFER_CAP}× on "
                    f"breaker-open recipients ({skipped} skipped)")
            registry().inc("resync_offload_deferred", skipped)
            return
        await asyncio.to_thread(m.delete_local, hash32)
        await asyncio.to_thread(m.rc.clear_deletable, hash32)
        self._defer_counts.pop(hash32, None)

    # consecutive breaker deferrals before a block escalates to the
    # exponential error backoff (~cap × BREAKER_COOLDOWN of fast
    # retries buys a briefly-down peer its recovery window)
    DEFER_CAP = 6

    def _defer(self, hash32: bytes) -> bool:
        """An op that failed while peers sat behind an open breaker is
        a deferral, not a failure: requeue on the breaker's timescale
        instead of landing in the error tree, whose 60 s-doubling
        backoff would block the layout sync report for minutes on a
        peer that recovers in seconds. Returns False once the block
        has deferred DEFER_CAP times in a row — the caller must then
        treat it as a real failure so a permanently dead peer gets the
        exponential backoff, not a probe every cooldown forever.
        (Callers count the deferral under their own literal metric
        name — GL07.)"""
        n = self._defer_counts.get(hash32, 0) + 1
        if n > self.DEFER_CAP:
            return False
        self._defer_counts[hash32] = n
        from ..net.peering import BREAKER_COOLDOWN

        self.push_at(hash32, time.time() + BREAKER_COOLDOWN)
        return True

    def _open_breaker_holders(self, hash32: bytes) -> int:
        """Holders of hash32 (any readable layout version, excluding
        us) whose breaker is currently open."""
        if not self.breaker_aware:
            return 0
        m = self.manager
        health = m.rpc.health()
        if health is None:
            return 0
        me = m.system.id
        now = time.monotonic()
        return sum(1 for n in m.system.layout_helper
                   .block_read_nodes_of(hash32)
                   if n != me
                   and health.breaker_state(n, now) == "open")

    async def _fetch(self, hash32: bytes) -> None:
        """Needed but absent: get it (ref: resync.rs:462-505).

        Replicate fetches of HINTED-HOT blocks route through the
        cluster cache tier first: if a peer's gossiped
        hot-hash hints say the block is hot, one probe to its cache
        owner replaces the remote packed read, and the payload is
        re-packed locally (any compression variant of the right plain
        bytes is a valid replica — the content address covers the
        plain bytes). Cold blocks never probe: a rebalance enumeration
        of the whole store must not spray one wasted RPC per block.
        Erasure SHARD fetches ride the PACKED tier via
        _rebuild_shard: the cached bytes are the exact packed block the
        stripe was cut from, so the deterministic re-encode reproduces
        byte-identical shards — the old recompression restriction only
        applied to the DECODED segment."""
        m = self.manager
        if not m.erasure:
            if await self._fetch_via_tier(hash32):
                return
            try:
                packed, _verified = await m._get_replicate(hash32)
            except Exception:
                skipped = self._open_breaker_holders(hash32)
                # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
                if skipped and self._defer(hash32):
                    registry().inc("resync_fetch_deferred", skipped)
                    return
                raise
            await asyncio.to_thread(m.write_local, hash32, packed)
            self._defer_counts.pop(hash32, None)
            m.metrics["resync_recv"] += 1
            m.metrics["resync_bytes"] += len(packed)
            return
        # erasure: our assigned shard, fetched or rebuilt
        placement = shard_nodes_of(m.system.layout_helper.current(),
                                   hash32, m.codec.width)
        me = m.system.id
        if me not in placement:
            return  # not a holder anymore; nothing to fetch
        want = placement.index(me)
        raw, skipped = await self._fetch_shard(hash32, placement, want)
        if raw is None:
            raw = await self._rebuild_shard(hash32, want)
        if raw is None:
            if skipped and self._defer(hash32):
                registry().inc("resync_fetch_deferred", skipped)
                return
            raise MissingBlock(hash32)
        await asyncio.to_thread(m.write_local_shard, hash32, want, raw)
        self._defer_counts.pop(hash32, None)
        m.metrics["resync_recv"] += 1
        m.metrics["resync_bytes"] += len(raw)

    async def _fetch_via_tier(self, hash32: bytes) -> bool:
        """Hint-gated tier read for a replicate fetch: True when the
        block landed locally via the cache tier (probe hit at the
        owner, content-verified there, re-packed and stored here)."""
        m = self.manager
        tier = getattr(m, "cache_tier", None)
        if tier is None or not tier.is_hot(hash32):
            return False
        owner = tier.owner_of(hash32)
        if owner is None:
            return False
        data = await tier.probe(owner, hash32)
        if data is None:
            return False
        from .block import DataBlock

        blk = (await asyncio.to_thread(DataBlock.compress, data)
               if m.compression else DataBlock.plain(data))
        await asyncio.to_thread(m.write_local_payload, hash32,
                                blk.compression, blk.bytes)
        registry().inc("cache_tier_resync_hits")
        self._defer_counts.pop(hash32, None)
        m.metrics["resync_recv"] += 1
        m.metrics["resync_bytes"] += len(data)
        return True

    async def _fix_shard_placement(self, hash32: bytes) -> None:
        """After a layout change we may hold shard j but be assigned
        shard i: fetch/rebuild i; the stale j is dropped once rc says
        deletable (or by offload on the next pass)."""
        m = self.manager
        placement = shard_nodes_of(m.system.layout_helper.current(),
                                   hash32, m.codec.width)
        me = m.system.id
        if me not in placement:
            return
        want = placement.index(me)
        if want in m.local_parts(hash32):
            return
        raw, skipped = await self._fetch_shard(hash32, placement, want)
        if raw is None:
            raw = await self._rebuild_shard(hash32, want)
        if raw is None:
            # don't swallow: draining the queue without our assigned
            # shard would let maybe_report_synced declare the layer
            # synced — and old-version GC proceed — while this node is
            # below the erasure tolerance the layout claims
            # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
            if skipped and self._defer(hash32):
                registry().inc("resync_fetch_deferred", skipped)
                return
            raise MissingBlock(hash32)
        await asyncio.to_thread(m.write_local_shard, hash32, want, raw)
        self._defer_counts.pop(hash32, None)

    async def _fetch_shard(self, hash32: bytes, placement: list[bytes],
                           idx: int) -> tuple[Optional[bytes], int]:
        """Ask everyone for shard idx (an old holder may have it) —
        healthy holders first, open-breaker ones not at all (the
        backoff retry returns once their breaker closes). Returns
        (data, holders skipped for an open breaker) so the caller can
        tell a deferral from a real miss."""
        m = self.manager
        candidates, skipped = self._placement_order(
            n for n in placement if n != m.system.id)
        for node in candidates:
            try:
                resp, _ = await m.endpoint.call(
                    node, {"op": "get", "hash": hash32, "part": idx},
                    PRIO_BACKGROUND,
                )
                if resp.get("data") is not None:
                    return resp["data"], skipped
            except Exception as e:
                log.debug("resync shard fetch part=%d from %s "
                          "failed: %s", idx, node[:4].hex(), e)
                continue
        return None, skipped

    async def _rebuild_shard(self, hash32: bytes, idx: int) -> Optional[bytes]:
        """RS repair: gather any k parts, recompute shard idx through
        the feeder's batched `repair` op — concurrent resync workers'
        rebuilds (a repair/rebalance wave) coalesce into one
        pattern-as-data device launch instead of one host matmul per
        stripe on the event loop.

        Packed-tier fast path: when the packed block bytes
        are in the tier (local segment, or a hint-gated owner probe),
        the deterministic RS encode regenerates ALL shards byte-
        identically from them — zero gather RPCs, zero repair matmul.
        encode_put's framing is pack_shard(crc32c) like the original
        PUT, so the rebuilt file is the file that was lost."""
        m = self.manager
        packed = await m.packed_from_tier(hash32)
        if packed is not None:
            try:
                framed = await m.feeder.encode_put(bytes(packed))
                if idx < len(framed):
                    self.rebuild_tier_hits += 1
                    registry().inc("cache_packed_rebuild_hit")
                    return bytes(framed[idx])
            except Exception as e:
                log.debug("packed-tier rebuild of %s.s%d failed: %s "
                          "(falling back to gather)",
                          hash32[:4].hex(), idx, e)
        placement = shard_nodes_of(m.system.layout_helper.current(),
                                   hash32, m.codec.width)
        got = await m._gather_parts(hash32, placement, m.codec.read_need)
        if got is None:
            return None
        parts, len_candidates, _lens = got
        packed_len = len_candidates[0]  # majority vote
        if idx in parts:
            # lint: ignore[GL10] pack_shard's crc is native-C microseconds; the flagged open/cc chain is the one-time kernel build, cached for the process lifetime
            return pack_shard(parts[idx], packed_len)
        present = tuple(sorted(parts.keys())[: m.codec.read_need])
        rebuilt = await m.feeder.repair(present, (idx,),
                                        [parts[i] for i in present])
        return pack_shard(rebuilt[idx], packed_len)


class ResyncWorker(Worker):
    def __init__(self, resync: BlockResyncManager, i: int):
        self.resync = resync
        self.name = f"block resync {i}"

    async def work(self):
        # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
        h = self.resync._pop_due()
        if h is None:
            # backlog drained: report the block layer's layout-sync
            # position so old layout versions can be GC'd (no-op
            # unless a rebalance actually completed)
            self.resync.maybe_report_synced()
            return WState.IDLE
        self.resync._in_flight += 1
        try:
            await self.resync.resync_block(h)
            self.resync._clear_error(h)
        except Exception as e:
            log.info("resync %s failed: %s", h[:4].hex(), e)
            # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
            self.resync._record_error(h)
        finally:
            self.resync._in_flight -= 1
        if self.resync.tranquility > 0:
            from ..utils.background import Throttled

            return Throttled(self.resync.tranquility)
        return WState.BUSY

    async def wait_for_work(self):
        await asyncio.sleep(1.0)

    def info(self):
        from ..utils.background import WorkerInfo

        return WorkerInfo(
            name=self.name,
            queue_length=self.resync.queue_len(),
            persistent_errors=self.resync.errors_len(),
        )
