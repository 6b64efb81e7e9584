"""Copy of garage_tpu/block/repair.py: import paths rewritten, issue and PR tags dropped.

Scrub and repair workers for the block store.

Ref parity: src/block/repair.rs. ScrubWorker reads every stored
block/shard, verifies integrity (whole blocks: blake2 of plain content;
shards: header checksum + optional cross-shard parity check through the
TPU RS math), quarantines corrupt files and queues resync. RepairWorker
is the one-shot full pass: every RC-known and every on-disk block gets a
resync examination (used after disasters / layout surgery).

The scrub cursor persists so a restart resumes mid-pass
(ref: repair.rs:169-232 persisted BlockStoreIterator).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import random
import time

from ..utils import migrate
from .block import BLOCK_SUFFIXES, comp_of_path
from ..utils.background import Throttled, Worker, WorkerInfo, WState
from ..utils.metrics import registry
from ..utils.persister import Persister

log = logging.getLogger("garage_tpu_torch.block.repair")

SCRUB_INTERVAL = 25 * 86400.0  # ~25 days, ref: repair.rs:24-27


async def gather_bounded(gather, items: list, window: int) -> list:
    """Run `gather(*item)` for every item with at most `window` in
    flight; results in item order. Deep scrub's leader sweep used an
    UNBOUNDED asyncio.gather of k-shard stripe gathers — on a large
    scrub batch that is batch×width concurrent MiB-scale fetches
    spiking RAM and RPC concurrency at once. The feeder batch size is
    the natural window: the parity-check launch downstream can't
    consume more than one batch at a time anyway, so gathering wider
    only buys memory pressure."""
    sem = asyncio.Semaphore(max(1, int(window)))

    async def one(item):
        async with sem:
            return await gather(*item)

    return await asyncio.gather(*[one(it) for it in items])


class ScrubState(migrate.Migratable):
    VERSION_MARKER = b"GTscrb01"

    def __init__(self, cursor: bytes = b"", last_completed: float = 0.0,
                 corruptions: int = 0, tranquility: float = 4.0,
                 paused: bool = False, tranquility_manual: bool = False):
        self.cursor = cursor
        self.last_completed = last_completed
        self.corruptions = corruptions
        self.tranquility = tranquility
        self.paused = paused
        # True after an operator `worker set scrub-tranquility`:
        # PERSISTED, so the qos governor keeps its hands off the knob
        # across restarts until explicitly re-enabled
        self.tranquility_manual = tranquility_manual

    def pack(self):
        return [self.cursor, self.last_completed, self.corruptions,
                self.tranquility, self.paused, self.tranquility_manual]

    @classmethod
    def unpack(cls, o):
        return cls(*o)


class ScrubWorker(Worker):
    BATCH = 16

    def __init__(self, manager, interval: float = SCRUB_INTERVAL):
        self.manager = manager
        self.name = "block scrub"
        self.interval = interval
        self.persister = Persister(manager.system.meta_dir, "scrub_state",
                                   ScrubState)
        self.state = self.persister.load() or ScrubState()
        self._jitter = random.random() * 0.4 + 0.8  # ±20%
        self._iter = None  # live sorted walk; rebuilt from cursor on restart
        self._pending_cmd: str | None = None
        # erasure deep pass toggle (runtime-tunable: `worker set
        # scrub-deep 0` turns off the per-stripe gather on clusters
        # where scrub bandwidth matters more than wrong-shard detection)
        self.deep = True
        self.deep_checked = 0  # stripes parity-checked as leader
        self.deep_repaired = 0  # flagged stripes fully repaired
        self.header_repaired = 0  # shards rewritten for header rot
        # packed-tier ride: repair-leg lookups into the
        # packed segment and the hits that skipped stripe localization
        # (bench derives scrub_cache_hit_rate = hits / lookups)
        self.scrub_cache_lookups = 0
        self.scrub_cache_hits = 0

    def _due(self) -> bool:
        return (time.time() - self.state.last_completed
                >= self.interval * self._jitter)

    def command(self, cmd: str) -> None:
        """Operator control (CLI `repair scrub <cmd>`). Commands are
        applied at the top of the next work() tick so they can never be
        clobbered by an in-flight batch's cursor save
        (ref: repair.rs ScrubWorkerCommand channel)."""
        if cmd not in ("start", "pause", "resume", "cancel"):
            raise ValueError(f"unknown scrub command {cmd!r}")
        self._pending_cmd = cmd

    def _apply_pending(self) -> None:
        cmd, self._pending_cmd = self._pending_cmd, None
        if cmd is None:
            return
        if cmd == "start":
            self.state.last_completed = 0.0
            self.state.cursor = b""
            self.state.paused = False
            self._iter = None
        elif cmd == "pause":
            self.state.paused = True
        elif cmd == "resume":
            self.state.paused = False
        elif cmd == "cancel":
            self.state.cursor = b""
            self._iter = None
            self.state.last_completed = time.time()
        self.persister.save(self.state)

    async def work(self):
        self._apply_pending()
        if self.state.paused or not self._due():
            return WState.IDLE
        if self._iter is None:
            # single ordered walk per pass; on restart resume after the
            # persisted cursor instead of rescanning from the front
            self._iter = self.manager.iter_local_blocks_sorted(
                self.state.cursor
            )

        def pull_batch():
            batch = []
            for h in self._iter:
                batch.append(h)
                if len(batch) >= self.BATCH:
                    break
            return batch

        try:
            batch = await asyncio.to_thread(pull_batch)
        except Exception:
            self._iter = None  # re-derive from cursor on retry
            raise
        if not batch:
            self._iter = None
            self.state.cursor = b""
            self.state.last_completed = time.time()
            self.persister.save(self.state)
            log.info("scrub pass complete, %d corruptions total",
                     self.state.corruptions)
            return WState.IDLE
        t0 = time.monotonic()
        try:
            bad = await self.scrub_batch(batch)
        except Exception:
            # the live iterator has advanced past this batch; drop it so
            # the retry re-derives the batch from the persisted cursor
            self._iter = None
            raise
        self.state.corruptions += bad
        self.state.cursor = batch[-1]
        self.persister.save(self.state)
        dt = time.monotonic() - t0
        if self.state.tranquility > 0:
            return Throttled(self.state.tranquility * dt / max(len(batch), 1))
        return WState.BUSY

    async def scrub_batch(self, batch: list[bytes]) -> int:
        """Verify a batch; returns number of corrupt blocks.

        Whole blocks verify as ONE batched content-hash pass through the
        device feeder (the TPU replacement for the reference's
        block-at-a-time rehash loop, src/block/repair.rs:169-528).
        Erasure blocks get two passes: per-shard header checksums
        host-side (cheap, catches local bit rot), then the cross-shard
        DEEP pass (_deep_scrub) — stripes gathered by their scrub
        leader and parity-checked in feeder batches, which catches a
        shard that is internally consistent but WRONG, the class of
        corruption the reference's whole-block rehash would see and
        per-shard checksums cannot."""
        m = self.manager
        if m.erasure:
            bad = await asyncio.to_thread(
                lambda: sum(0 if self._scrub_shards(h) else 1 for h in batch)
            )
            if self.deep:
                bad += await self._deep_scrub(batch)
            return bad

        def read_all():
            out = []
            for h in batch:
                p = m._find(h, BLOCK_SUFFIXES)
                if p is None:
                    out.append((h, None, None))
                    continue
                try:
                    with open(p, "rb") as f:
                        raw = f.read()
                    from .block import DataBlock, MissingCodec

                    blk = DataBlock(comp_of_path(p), raw)
                    try:
                        out.append((h, p, blk.plain_bytes()))
                    except MissingCodec:
                        # codec wheel absent, data not corrupt: skip,
                        # never quarantine (block.py MissingCodec)
                        out.append((h, None, None))
                except Exception:
                    out.append((h, p, None))  # unreadable = corrupt
            return out

        reads = await asyncio.to_thread(read_all)
        to_verify = [(h, plain) for h, p, plain in reads if plain is not None]
        oks = await m.feeder.verify_blocks(to_verify)
        ok_of = {h: ok for (h, _), ok in zip(to_verify, oks)}
        bad = 0
        for h, p, plain in reads:
            if plain is None:
                if p is not None:
                    await asyncio.to_thread(m._quarantine, p, h)
                    bad += 1
                # p is None: block not stored here (moved) — not corrupt
            elif not ok_of.get(h, False):
                await asyncio.to_thread(m._quarantine, p, h)
                bad += 1
        return bad

    def _scrub_shards(self, hash32: bytes) -> bool:
        m = self.manager
        ok = True
        for part in m.local_parts(hash32):
            if m.read_local_shard(hash32, part) is None:
                ok = False
        return ok

    async def _deep_scrub(self, batch: list[bytes]) -> int:
        """Cross-shard parity detect + repair for erasure stripes.

        Per-shard header checksums only certify each shard file against
        itself; a shard that passes its own checksum but holds the
        wrong bytes (aborted overwrite, misplaced file, buggy writer)
        silently poisons a future decode. The stripe's scrub LEADER —
        first node of its placement, so exactly one node pays the
        gather per pass — fetches all width shards and batches them
        through feeder.parity_check: parity re-derivation (the encode
        bit-matmul) flags any inconsistent stripe in one device pass.
        Localization + repair run host-side only on flagged stripes
        (_repair_stripe). Blocks with missing shards are skipped here:
        absence is resync/repair's job, and parity over a partial
        stripe cannot tell loss from corruption."""
        from .codec import shard_nodes_of

        m = self.manager
        me = m.system.id
        v = m.system.layout_helper.current()
        leaders = []
        for h in batch:
            placement = shard_nodes_of(v, h, m.codec.width)
            if placement and placement[0] == me:
                leaders.append((h, placement))
        if not leaders:
            return 0
        # stripe gathers are independent: run them concurrently so a
        # slow holder costs the batch max(latency), not the sum — but
        # WINDOWED at the feeder batch size (gather_bounded) so a big
        # scrub batch can't fan out batch×width shard fetches at once
        gathered = await gather_bounded(
            lambda h, p: m._gather_parts(h, p, m.codec.width),
            leaders, getattr(m.feeder, "max_batch", self.BATCH))
        stripes, metas, flagged, clean = [], [], [], []
        for (h, placement), got in zip(leaders, gathered):
            if got is None:
                continue
            parts, len_candidates, lens_by_idx = got
            packed_len = len_candidates[0]  # majority vote
            self.deep_checked += 1
            stripe = [parts[i] for i in range(m.codec.width)]
            if len({len(s) for s in stripe}) != 1:
                # unequal shard lengths ARE the inconsistency (e.g. a
                # misplaced shard of another block): flag straight to
                # repair — stacking them would crash parity_check and a
                # deterministic raise here would wedge the scrub cursor
                # on this batch forever
                flagged.append((h, parts, packed_len, placement,
                                lens_by_idx))
                continue
            stripes.append(stripe)
            metas.append((h, parts, packed_len, placement, lens_by_idx))
        if stripes:
            oks = await m.feeder.parity_check(stripes)
            flagged.extend(meta for ok, meta in zip(oks, metas) if not ok)
            clean = [meta for ok, meta in zip(oks, metas) if ok]
        bad = 0
        for h, parts, packed_len, placement, lens in flagged:
            bad += 1
            repaired = await self._repair_stripe(h, parts, packed_len,
                                                 placement, lens)
            self.deep_repaired += bool(repaired)
            log.warning("deep scrub: stripe %s inconsistent (%s)",
                        h.hex()[:16],
                        "repaired" if repaired else "NOT repaired")
        # header-rot pass over parity-CLEAN stripes (ADVICE r5): the
        # packed_len field sits outside the shard checksum, so a rotted
        # header passes every local check AND the cross-shard parity
        # check (parity covers payload bytes only) — yet it poisons any
        # future decode that lands on the wrong length. Rewrite each
        # disagreeing shard (same payload, corrected header) on its
        # holder. Flagged stripes are excluded on purpose: their
        # payloads are suspect, and _repair_stripe's re-encode already
        # regenerates correct headers for everything it pushes.
        for h, parts, packed_len, placement, lens in clean:
            bad_idx = [i for i, v in lens.items() if v != packed_len]
            if not bad_idx:
                continue
            votes = sum(1 for v in lens.values() if v == packed_len)
            if votes * 2 <= len(lens):
                # no strict majority: rewriting could spread the rotted
                # value instead of fixing it — leave for the read
                # path's try-every-candidate logic and the operator
                log.warning("deep scrub: stripe %s packed_len vote tied "
                            "(%s); headers left untouched",
                            h.hex()[:16], sorted(set(lens.values())))
                continue
            # bind first, then add (GL12): `x += await ...` reads the
            # counter BEFORE the (multi-RPC) await and stores after it,
            # so a concurrent repair wave's increments in that window
            # would be lost
            repaired = await self._repair_headers(
                h, parts, packed_len, placement, bad_idx)
            self.header_repaired += repaired
        return bad

    async def _repair_headers(self, hash32: bytes, parts: dict[int, bytes],
                              packed_len: int, placement: list[bytes],
                              bad_idx: list[int]) -> int:
        """Push a rewritten shard (held payload, majority packed_len
        header) to every holder whose header disagreed; -> shards
        fixed."""
        from ..net.message import PRIO_BACKGROUND
        from .manager import pack_shard

        fixed = 0
        for i in bad_idx:
            try:
                await self.manager.endpoint.call(
                    placement[i],
                    {"op": "put", "hash": hash32, "part": i,
                     # lint: ignore[GL10] pack_shard's crc is native-C microseconds; the flagged open/cc chain is the one-time kernel build, cached for the process lifetime
                     "data": pack_shard(parts[i], packed_len)},
                    PRIO_BACKGROUND, timeout=60.0)
                fixed += 1
                log.warning("deep scrub: rewrote rotted header of shard "
                            "%d of %s (packed_len -> %d)", i,
                            hash32.hex()[:16], packed_len)
            except Exception as e:
                log.warning("deep scrub: header rewrite of shard %d of "
                            "%s failed (%s)", i, hash32.hex()[:16], e)
        return fixed

    async def _repair_stripe(self, hash32: bytes, parts: dict[int, bytes],
                             packed_len: int, placement: list[bytes],
                             lens: dict[int, int] | None = None) -> bool:
        """Find + fix the corrupt shard(s) of a parity-inconsistent
        stripe. Ground truth is the block's content address: a decode
        from a candidate k-subset is right iff the unpacked block
        hashes to hash32. Tries the packed-bytes tier first (
        — the cached image IS the stripe's source, re-verified here
        because scrub trusts nothing), then the all-systematic subset,
        then each single-data-shard exclusion (covers any single
        corrupt shard, the overwhelmingly likely case); the corrected
        stripe is re-encoded and every differing shard pushed to its
        holder through the normal shard-put path (validate +
        tmp/rename replace). Only this REPAIR leg rides the cache —
        the detect pass keeps touching the disks it exists to check."""
        from ..net.message import PRIO_BACKGROUND
        from .block import DataBlock
        from .manager import unpack_shard

        m = self.manager
        codec = m.codec
        k, w = codec.k, codec.width

        def try_subset(idx: tuple[int, ...]):
            # decode stays host-side (numpy) on purpose: localization
            # runs inside the scrub worker and a dead device must never
            # wedge it — the batched detect above already rides the
            # feeder's watchdogs
            import numpy as _np

            from ..ops import rs

            try:
                if all(i < k for i in idx):
                    packed = codec.decode({i: parts[i] for i in idx},
                                          packed_len)  # pure concat
                else:
                    shards = _np.stack(
                        [_np.frombuffer(parts[i], dtype=_np.uint8)
                         for i in idx])
                    data = rs.decode_np(k, codec.m, idx, shards)
                    packed = rs.join_stripe(data, packed_len)
                blk = DataBlock.unpack(packed)
                blk.verify(hash32)
                return packed
            except Exception as e:
                log.debug("decode candidate %s rejected: %s", idx, e)
                return None

        candidates = [tuple(range(k))]
        # one corrupt data shard, substituted by EACH parity shard in
        # turn: trying every parity keeps a simultaneously-corrupt
        # parity shard from blocking the substitution, so a
        # data+parity double corruption still localizes (re-encode then
        # fixes both). Two corrupt DATA shards stay out of scope — the
        # pair search is combinatorial and the reference repairs
        # nothing in this class at all.
        # parity-OUTER order: the full single-corruption sweep with
        # parity k runs first (the common case succeeds within k+1
        # candidates), and only then the other parities sweep for the
        # data+parity double-corruption case
        for p in range(k, w):
            for drop in range(k):
                candidates.append(tuple(i for i in range(k) if i != drop)
                                  + (p,))
        def verify_cached(packed) -> bytes | None:
            try:
                blk = DataBlock.unpack(packed)
                blk.verify(hash32)
                return bytes(packed)
            except Exception as e:
                log.debug("scrub cached packed bytes for %s failed "
                          "re-verification: %s", hash32[:4].hex(), e)
                return None

        good_packed = None
        self.scrub_cache_lookups += 1
        cached = await m.packed_from_tier(hash32)
        if cached is not None:
            # scrub paranoia: re-verify even admission-checked bytes —
            # the repair leg is about to OVERWRITE shards with them
            good_packed = await asyncio.to_thread(verify_cached, cached)
            if good_packed is not None:
                self.scrub_cache_hits += 1
                registry().inc("cache_packed_scrub_hit")
        for idx in candidates:
            if good_packed is not None:
                break
            good_packed = await asyncio.to_thread(try_subset, idx)
        if good_packed is None:
            # >1 corrupt shard (or corrupt beyond what single-exclusion
            # finds): leave the files for operator repair; the count is
            # already in the scrub stats
            return False
        framed = await m.feeder.encode_put(good_packed)
        fixed = True
        for i, node in enumerate(placement[:w]):
            raw = bytes(framed[i])
            # lint: ignore[GL10] shard crc is native-C microseconds; the flagged open/cc chain is the one-time kernel build, cached for the process lifetime
            good_payload, good_len = unpack_shard(raw)
            if good_payload == parts[i] and (
                    lens is None or lens.get(i) == good_len):
                # payload AND header both right on this holder; a
                # payload-identical shard with a rotted header must
                # still be pushed or the rot survives the repair
                continue
            try:
                await m.endpoint.call(
                    node, {"op": "put", "hash": hash32, "part": i,
                           "data": raw},
                    PRIO_BACKGROUND, timeout=60.0)
            except Exception as e:
                log.warning("deep scrub: pushing repaired shard %d of %s "
                            "to %s failed (%s)", i, hash32.hex()[:16],
                            node.hex()[:8], e)
                fixed = False
        return fixed

    async def wait_for_work(self):
        # 1 s polling tick, not one 60 s sleep: an operator `repair
        # scrub start` must take effect promptly, not after the tail of
        # an idle minute (ref: repair.rs reacts to its command channel
        # immediately)
        for _ in range(60):
            if self._pending_cmd is not None:
                return
            await asyncio.sleep(1.0)

    def info(self):
        from ..utils.background import WorkerInfo

        cursor = self.state.cursor[:4].hex() if self.state.cursor else "-"
        if self.manager.erasure and self.deep:
            cursor += (f" deep:{self.deep_checked}"
                       f"/{self.deep_repaired} repaired")
            if self.header_repaired:
                cursor += f" hdr:{self.header_repaired}"
        return WorkerInfo(
            name=self.name,
            progress=cursor,
            tranquility=int(self.state.tranquility),
        )


class RebalanceWorker(Worker):
    """One-shot: move every stored block/shard file whose primary data
    dir changed (multi-HDD layout update) to its new primary dir
    (ref: src/block/repair.rs:531-640 RebalanceWorker). Walks all
    candidate dirs; a file found outside its primary location is moved
    (tmp+rename within the target dir); duplicate copies left by an
    interrupted earlier pass are deduped in favour of the primary."""

    def __init__(self, manager):
        self.manager = manager
        self.name = "block rebalance"
        self._iter = None
        self.moved = 0
        self.freed_bytes = 0

    def _rebalance_batch(self, hashes: list[bytes]) -> None:
        m = self.manager
        lay = m.data_layout
        for h in hashes:
            primary = lay.primary_dir(h)
            for d in lay.candidate_dirs(h):
                if d == primary or not os.path.isdir(d):
                    continue
                pre = h.hex()
                for fn in os.listdir(d):
                    if not fn.startswith(pre) or ".tmp" in fn \
                            or fn.endswith(".corrupted"):
                        continue
                    src = os.path.join(d, fn)
                    dst = os.path.join(primary, fn)
                    try:
                        size = os.path.getsize(src)
                        if os.path.exists(dst):
                            # stray copy: only drop it if the primary
                            # copy is intact (size match) — a crash
                            # mid-copy can leave a truncated dst, and
                            # deleting src then would lose the block
                            if os.path.getsize(dst) == size:
                                os.remove(src)
                                self.freed_bytes += size
                            else:
                                self._copy_over(src, dst)
                                os.remove(src)
                                self.moved += 1
                                self.freed_bytes += size
                            continue
                        os.makedirs(primary, exist_ok=True)
                        # same-FS fast path; cross-FS needs copy+rename
                        try:
                            os.rename(src, dst)
                        except OSError:
                            self._copy_over(src, dst)
                            os.remove(src)
                        self.moved += 1
                        self.freed_bytes += size
                    except OSError as e:
                        log.warning("rebalance of %s failed: %s", src, e)

    def _copy_over(self, src: str, dst: str) -> None:
        """Durable cross-FS copy: tmp + (optional) fsync + rename, the
        same discipline as BlockManager._write_file."""
        tmp = dst + f".tmp-rb{os.getpid()}"
        with open(src, "rb") as fsrc, open(tmp, "wb") as fdst:
            fdst.write(fsrc.read())
            if self.manager.fsync:
                fdst.flush()
                os.fsync(fdst.fileno())
        os.replace(tmp, dst)
        if self.manager.fsync:
            dirfd = os.open(os.path.dirname(dst), os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)

    async def work(self):
        m = self.manager
        if self._iter is None:
            self._iter = m.iter_local_blocks_sorted()
        batch = list(itertools.islice(self._iter, 64))
        if not batch:
            return WState.DONE
        await asyncio.to_thread(self._rebalance_batch, batch)
        return WState.BUSY

    def info(self):
        inf = WorkerInfo(name=self.name)
        inf.progress = (f"moved {self.moved}, "
                        f"freed {self.freed_bytes // (1 << 20)} MiB")
        return inf


class RepairWorker(Worker):
    """One-shot: resync-examine every block we know of
    (ref: repair.rs:35-165)."""

    def __init__(self, manager):
        self.manager = manager
        self.name = "block repair"
        self._phase = 0  # 0: rc table, 1: disk, 2: done
        self._iter = None

    async def work(self):
        m = self.manager
        if self._phase == 0:
            if self._iter is None:
                self._iter = m.rc.all_hashes()
            batch = list(itertools.islice(self._iter, 256))
            if batch:
                # one thread hop per 256 queue inserts (GL10)
                await asyncio.to_thread(
                    lambda: [m.resync.push_now(h) for h in batch])
                return WState.BUSY
            self._phase, self._iter = 1, None
            return WState.BUSY
        if self._phase == 1:
            if self._iter is None:
                self._iter = m.iter_local_blocks()
            batch = [h for h, _ in itertools.islice(self._iter, 256)]
            if batch:
                await asyncio.to_thread(
                    lambda: [m.resync.push_now(h) for h in batch])
                return WState.BUSY
            self._phase = 2
        return WState.DONE
