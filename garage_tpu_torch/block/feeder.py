"""DeviceFeeder: batches block math from concurrent requests onto the GPU.

Every block-math request of the block data path — content hash (+ the
S3 ETag MD5 advance), RS encode, degraded-read decode, shard repair,
scrub verify and parity check — funnels through one queue. A single
dispatcher drains whatever has accumulated, groups it by operation, and
issues one batched device call per group through the staged backend
(block/device_backend.py: the hand-written CUDA kernels G1, G2, B3 and
S2). The S3 front end's SigV4 chunk digests ride the same queue
(`sha256_hex`).
Under load, concurrent PUTs coalesce into large batches.

Every batch runs on the feeder's device; nothing is ever re-run on the
host. The first request probes the device in process (torch.cuda) and
raises to its caller if the device is absent; a device group that fails
or hangs fails its own requests. The device route is a STAGED PIPELINE:
each batch flows h2d -> compute -> d2h through three worker threads,
with up to `[tpu] inflight_batches` batches in flight, under a
watchdog.

The `[tpu]` knobs that mean the same on CUDA are honoured, as in the JAX
package: `batch_blocks` (the greedy-drain cap, `max_batch`),
`inflight_batches` (runtime-settable through the admin API's
/v1/s3/tuning), `batch_timeout_s` (the watchdog), `batch_linger_ms`
(the PUT lanes' gather window; 0 ships at once), `pad_buckets` (the
backend's item-count ladder) and `mesh_min_items` (the smallest batch
that takes the device grid, when the grid has several cells). The
routing floors and trials have no counterpart here (model/garage.py
names them when set).

Ported from the JAX package's block/feeder.py; what differs: the probe,
the backend (torch; a device grid in place of the mesh), one mode
("require": no host routing, calibration or fallback: a lone stream's
chunk digest goes to the device too), and the content hash fixed to
BLAKE3.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Optional

import torch

from .device_backend import (PAD_BUCKETS, STAGES, DevicePipeline,
                             TorchDeviceBackend, group_bytes)

log = logging.getLogger("garage_tpu_torch.block.feeder")

# defaults of the [tpu] knobs (utils/config.py TpuConfig leaves some
# None): a batch stuck longer than the timeout means the device hung
_BATCH_TIMEOUT = 300.0
# batches concurrently in flight through the h2d/compute/d2h stages
_INFLIGHT_BATCHES = 3
# gather window for same-op PUT lanes: each PUT stream keeps at most one
# of these in flight per block, so lanes only line up if the dispatcher
# lingers for the other streams' submissions
_LINGER_OPS = ("hash_md5", "hash", "encode_put", "sha256")
_LINGER_MS = 6.0


def probe_device(device="cuda") -> dict:
    """In-process probe of `device` -> {"ok", "platform", "name",
    "error"}."""
    key = str(device)
    res = {"ok": False, "platform": "cpu", "name": "", "error": ""}
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            res.update(ok=True, name="cpu")
        elif dev.type != "cuda":
            res["error"] = f"unsupported device {key!r}"
        elif not torch.cuda.is_available():
            res["error"] = "torch.cuda.is_available() is false"
        else:
            idx = (torch.cuda.current_device() if dev.index is None
                   else dev.index)
            if idx >= torch.cuda.device_count():
                res["error"] = (f"{key}: only "
                                f"{torch.cuda.device_count()} devices")
            else:
                res.update(ok=True, platform="cuda",
                           name=torch.cuda.get_device_name(idx))
    except (RuntimeError, ValueError) as e:
        res["error"] = str(e)
    return res


class _DeviceHang(Exception):
    """A device pipeline stage hung (or a sibling batch's stage did and
    aborted the generation)."""


class _Item:
    __slots__ = ("op", "data", "future")

    def __init__(self, op: str, data, future):
        self.op = op
        self.data = data
        self.future = future


class DeviceFeeder:
    """One per block manager. Every batch runs on `device`, the torch
    device of the backend: "cuda" unless the caller asks for "cpu" (the
    kernels' plain torch versions). `mode` accepts only "require", the
    JAX package's name for that rule."""

    def __init__(self, codec=None, mode: str = "require",
                 max_batch: int = 256, backend=None, device="cuda",
                 tpu_cfg=None, grid=None):
        if mode != "require":
            raise ValueError(f"unknown feeder mode {mode!r}: the port has "
                             "only \"require\"")
        self.codec = codec
        self.device = device
        # greedy-drain cap: blocks per device batch ([tpu] batch_blocks)
        self.max_batch = max(1, int(max_batch))

        # the other [tpu] knobs (utils/config.py TpuConfig); None or no
        # config leaves the module default in force
        def knob(name, default):
            v = getattr(tpu_cfg, name, None) if tpu_cfg is not None else None
            return default if v is None else v

        # batches in flight through the stages; read at every dispatch,
        # so a runtime change (/v1/s3/tuning) applies from the next batch
        self.inflight_batches = max(1, int(knob("inflight_batches",
                                                _INFLIGHT_BATCHES)))
        # per-batch watchdog budget, seconds
        self.batch_timeout = float(knob("batch_timeout_s", _BATCH_TIMEOUT))
        # gather window of the PUT lanes, seconds; 0 ships at once
        self.batch_linger = max(
            0.0, float(knob("batch_linger_ms", _LINGER_MS))) / 1000.0
        # item-count ladder of the backend's launch shapes
        self.pad_buckets = tuple(
            int(b) for b in knob("pad_buckets", PAD_BUCKETS))
        # the device grid (parallel/mesh.py; None: every visible CUDA
        # device when there are several) and the smallest batch it takes
        self.grid = grid
        self.mesh_min_items = int(knob("mesh_min_items", 8))
        # a ready backend object (tests), else TorchDeviceBackend
        self._backend = backend
        self._backend_lock = threading.Lock()
        self._q: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._probe_lock: Optional[asyncio.Lock] = None
        self._device_ok = False
        self.stats = {"batches": 0, "items": 0, "device_batches": 0,
                      "device_items": 0, "device_bytes": 0,
                      "max_batch": 0, "pad_waste_bytes": 0,
                      # device batches split over the device grid
                      "mesh_batches": 0,
                      # read-side (decode + repair) engagement counters
                      "decode_items": 0, "decode_device_items": 0,
                      "decode_device_bytes": 0,
                      # device groups re-run on the host: none ever is (a
                      # failed group raises); the chip smoke checks it
                      "device_fallbacks": 0}
        # staged pipeline state: the current executor generation, the
        # batches in flight, per-stage busy seconds and the wall-clock
        # union of windows with >= 1 device leg in flight
        self._pl: Optional[DevicePipeline] = None
        self._pl_busy: dict[str, float] = {s: 0.0 for s in STAGES}
        # the same busy seconds split by op: where the device route's
        # time goes (h2d packing, launch, readback + host finish)
        self._op_busy: dict[str, dict[str, float]] = {}
        # device items by op (the S3 path reads its sha256 share)
        self._op_items: dict[str, int] = {}
        self._pl_wall = 0.0
        self._win_open = 0
        self._win_t0 = 0.0
        self._inflight_tasks: set = set()
        # PUT streams currently mid block loop: sizes the gather window
        self.active_streams = 0

    # ---- lifecycle ----------------------------------------------------

    def _ensure_started(self) -> None:
        if self._task is None or self._task.done():
            self._q = asyncio.Queue()
            self._task = asyncio.create_task(self._run(), name="device-feeder")

    def _get_backend(self):
        """The staged device backend, built lazily from a pipeline
        worker thread (CUDA initialisation never runs on the loop)."""
        with self._backend_lock:
            if self._backend is None:
                self._backend = TorchDeviceBackend(
                    codec=self.codec, device=self.device, stats=self.stats,
                    pad_buckets=self.pad_buckets, grid=self.grid,
                    mesh_min_items=self.mesh_min_items)
            return self._backend

    async def _probe(self) -> None:
        """Resolve the device verdict once, off the loop; a negative
        verdict raises to the caller."""
        if self._probe_lock is None:
            self._probe_lock = asyncio.Lock()
        async with self._probe_lock:
            if self._device_ok:
                return
            res = await asyncio.to_thread(probe_device, self.device)
            if not res["ok"]:
                raise RuntimeError(f"device required but probe failed: "
                                   f"{res['error'] or res['platform']}")
            self._device_ok = True

    async def stop(self) -> None:
        # snapshot-and-clear everything this stop owns BEFORE awaiting:
        # a concurrent _submit() may respawn a dispatcher (with a new
        # queue) while the old one unwinds
        t, self._task = self._task, None
        q = self._q
        inflight = list(self._inflight_tasks)
        self._inflight_tasks.clear()
        if t is not None:
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        # each cancelled _finish_batch fails its items' futures
        for bt in inflight:
            bt.cancel()
            try:
                await bt
            except (asyncio.CancelledError, Exception):
                pass
        if q is not None:
            while not q.empty():
                item = q.get_nowait()
                if not item.future.done():
                    item.future.set_exception(RuntimeError("feeder stopped"))

    # ---- public async ops ---------------------------------------------

    async def _submit(self, op: str, data):
        if not self._device_ok:
            await self._probe()
        self._ensure_started()
        fut = asyncio.get_running_loop().create_future()
        await self._q.put(_Item(op, data, fut))
        return await fut

    async def hash(self, data: bytes) -> bytes:
        """Content hash of one block (batched with concurrent callers)."""
        return await self._submit("hash", data)

    async def hash_with_md5(self, data: bytes, md5acc) -> bytes:
        """Content hash + S3-ETag MD5 advance for one block. Rides the
        feeder queue so blocks from CONCURRENT requests form one batch:
        MD5 is a serial chain within an object but independent across
        objects (the native kernel runs up to 8 chains in AVX2
        lockstep). The device hashes (B3); the MD5s advance host-side
        once the digests are back."""
        if getattr(md5acc, "fused", False):
            return await self._submit("hash_md5", (md5acc, data))
        # a hashlib-backed accumulator (no native library) has no lanes
        md5acc.update(data)
        return await self.hash(data)

    async def sha256_hex(self, data) -> str:
        """SigV4 chunk-signature SHA-256 (hex) of one message: a buffer
        or a span list hashed as one. Chunk digests are independent
        across streams (the signature chain, not the hash, carries
        continuity), so concurrent PUTs' chunks batch into one S2
        launch."""
        return await self._submit("sha256", data)

    async def encode(self, packed: bytes) -> list[bytes]:
        """Erasure parts for one packed block (batched)."""
        if self.codec is None:
            raise RuntimeError("feeder has no codec")
        return await self._submit("encode", packed)

    async def encode_put(self, data: bytes, prefix: bytes = b"") -> list:
        """Erasure parts for one packed block (logical stream
        prefix||data), each framed as a ready-to-send shard payload
        (pack_shard format). `data` may be an ingest lease
        (block/hostbuf.py): the device stage copies its stripe() rows,
        and the PUT task, which awaits this call, releases it after."""
        if self.codec is None:
            raise RuntimeError("feeder has no codec")
        if hasattr(data, "stripe"):
            return await self._submit("encode_put", data)
        return await self._submit("encode_put", (prefix, data))

    async def verify_blocks(self, items: list[tuple[bytes, bytes]]
                            ) -> list[bool]:
        """[(hash32, plain)] -> per-item content-hash match (scrub)."""
        futs = [self._submit("verify", (h, d)) for h, d in items]
        return list(await asyncio.gather(*futs))

    async def parity_check(self, stripes: list[list[bytes]]) -> list[bool]:
        """Scrub deep pass: per-stripe cross-shard consistency. Each
        stripe is the full [k data + m parity] shard payload list
        (equal lengths within one stripe). True = the stored parity
        rows equal parity re-derived from the data rows (kernel G2)."""
        if self.codec is None:
            raise RuntimeError("feeder has no codec")
        futs = [self._submit("parity_check", s) for s in stripes]
        return list(await asyncio.gather(*futs))

    def _check_stripe(self, present, shards, k: int, width: int) -> tuple:
        """Shared validation for the read-side ops, BEFORE the queue: a
        malformed item fails its own caller, never its batch-mates."""
        present = tuple(present)
        if len(present) != k or len(shards) != k:
            raise ValueError(
                f"need exactly k={k} present shards, got "
                f"{len(present)} indices / {len(shards)} payloads")
        if len(set(present)) != k or any(
                not 0 <= int(i) < width for i in present):
            raise ValueError(
                f"present indices must be {k} distinct values in "
                f"[0, {width}); got {present}")
        slen = len(shards[0])
        if any(len(s) != slen for s in shards):
            raise ValueError("unequal shard lengths in decode/repair "
                             "stripe (corrupt or misplaced shard)")
        return present

    async def decode(self, present, shards: list, plain_len: int) -> bytes:
        """Erasure decode of one stripe: `shards` are the surviving
        payloads in ascending `present`-index order; -> the packed block
        bytes (join_stripe at plain_len). Batched with every concurrent
        caller into one pattern-as-data launch."""
        if self.codec is None:
            raise RuntimeError("feeder has no codec")
        codec = self.codec
        present = self._check_stripe(present, shards, codec.k,
                                     codec.k + codec.m)
        return await self._submit("decode", (present, list(shards),
                                             plain_len))

    async def repair(self, present, missing, shards: list) -> dict:
        """Rebuild the `missing` shard payloads of one stripe from the k
        `present` ones -> {missing_index: payload}; concurrent rebuilds
        batch into one launch per len(missing)."""
        if self.codec is None:
            raise RuntimeError("feeder has no codec")
        codec = self.codec
        width = codec.k + codec.m
        present = self._check_stripe(present, shards, codec.k, width)
        missing = tuple(missing)
        if not missing:
            return {}
        if any(not 0 <= int(i) < width for i in missing):
            raise ValueError(
                f"missing indices must be in [0, {width}); got {missing}")
        return await self._submit("repair", (present, missing,
                                             list(shards)))

    # ---- dispatcher ----------------------------------------------------

    async def _run(self) -> None:
        while True:
            first = await self._q.get()
            batch = [first]
            try:
                # greedy non-waiting drain: whatever queued while the
                # last batch was on the device becomes the next batch
                while not self._q.empty() \
                        and len(batch) < self.max_batch:
                    batch.append(self._q.get_nowait())
                n_same = sum(1 for it in batch if it.op == first.op)
                want = min(self.active_streams, 8)
                if first.op in _LINGER_OPS and self.batch_linger > 0 \
                        and self.active_streams > 1 and n_same < want:
                    # several PUT streams are mid-block-loop: a short
                    # gather window lets their next submissions line up
                    loop = asyncio.get_running_loop()
                    deadline = loop.time() + self.batch_linger
                    while n_same < want and len(batch) < self.max_batch:
                        left = deadline - loop.time()
                        if left <= 0:
                            break
                        try:
                            item = await asyncio.wait_for(
                                self._q.get(), left)
                        except asyncio.TimeoutError:
                            break
                        batch.append(item)
                        if item.op == first.op:
                            n_same += 1
                # bounded in-flight depth, read anew for every batch
                while len(self._inflight_tasks) >= self.inflight_batches:
                    await asyncio.wait(self._inflight_tasks,
                                       return_when=asyncio.FIRST_COMPLETED)
                t = asyncio.create_task(self._finish_batch(batch),
                                        name="feeder-batch")
                self._inflight_tasks.add(t)
                t.add_done_callback(self._inflight_tasks.discard)
            except BaseException as e:
                for item in batch:
                    if not item.future.done():
                        item.future.set_exception(
                            e if not isinstance(e, asyncio.CancelledError)
                            else RuntimeError("feeder stopped"))
                if isinstance(e, asyncio.CancelledError):
                    raise

    async def _finish_batch(self, batch: list) -> None:
        """Run one batch, one device group per op, and resolve every
        item future with its result or its group's error."""
        try:
            self._count_batch(batch)
            by_op: dict[str, list[int]] = {}
            for i, item in enumerate(batch):
                by_op.setdefault(item.op, []).append(i)
            results: list = [None] * len(batch)
            await asyncio.gather(*(self._run_group(op, batch, idxs, results)
                                   for op, idxs in by_op.items()))
            for item, res in zip(batch, results):
                if not item.future.done():
                    if isinstance(res, BaseException):
                        item.future.set_exception(res)
                    else:
                        item.future.set_result(res)
        except BaseException as e:
            for item in batch:
                if not item.future.done():
                    item.future.set_exception(
                        e if not isinstance(e, asyncio.CancelledError)
                        else RuntimeError("feeder stopped"))
            if isinstance(e, asyncio.CancelledError):
                raise

    def _count_batch(self, batch: list) -> None:
        self.stats["batches"] += 1
        self.stats["items"] += len(batch)
        self.stats["decode_items"] += sum(
            1 for it in batch if it.op in ("decode", "repair"))
        self.stats["max_batch"] = max(self.stats["max_batch"], len(batch))

    async def _run_group(self, op: str, batch: list, idxs: list,
                         results: list) -> None:
        """One op group: staged h2d -> compute -> d2h with the watchdog
        over ALL stages. A hang abandons the stage threads; a hang or a
        device error fails the group's requests."""
        blobs = [batch[i].data for i in idxs]
        self._window_open()
        try:
            out = await asyncio.wait_for(self._staged_op(op, blobs),
                                         self.batch_timeout)
        except (asyncio.TimeoutError, _DeviceHang) as e:
            self._on_device_hang()
            err = RuntimeError(f"device {op} batch hung ({type(e).__name__})")
            err.__cause__ = e
            out = [err] * len(idxs)
        except Exception as e:
            out = [e] * len(idxs)
        else:
            self._count_device(op, len(idxs), group_bytes(op, blobs))
        finally:
            self._window_close()
        for i, o in zip(idxs, out):
            results[i] = o

    def _count_device(self, op: str, n: int, total: int) -> None:
        self.stats["device_batches"] += 1
        self.stats["device_items"] += n
        self.stats["device_bytes"] += total
        self._op_items[op] = self._op_items.get(op, 0) + n
        if op in ("decode", "repair"):
            self.stats["decode_device_items"] += n
            self.stats["decode_device_bytes"] += total

    async def _staged_op(self, op: str, blobs: list) -> list:
        """h2d -> compute -> d2h through the current pipeline
        generation's stage threads."""
        pl = self._pipeline()
        be = self._get_backend
        busy: list[float] = []
        staged = await self._stage_call(
            pl, "h2d", lambda: be().stage(op, blobs), busy)
        handle = await self._stage_call(
            pl, "compute", lambda: be().compute(op, staged), busy)
        out = await self._stage_call(
            pl, "d2h", lambda: be().readback(op, handle), busy)
        per_op = self._op_busy.setdefault(op, dict.fromkeys(STAGES, 0.0))
        for stage, sec in zip(STAGES, busy):
            per_op[stage] += sec
        return out

    async def _stage_call(self, pl: DevicePipeline, stage: str, fn,
                          busy: list):
        if pl.dead:
            raise _DeviceHang("pipeline aborted")
        loop = asyncio.get_running_loop()
        job = pl.submit(stage, loop, fn)
        abort = asyncio.create_task(pl.aborted.wait())
        try:
            await asyncio.wait({job.fut, abort},
                               return_when=asyncio.FIRST_COMPLETED)
            if not job.fut.done() and job.claimed:
                # the stage thread is already executing this job: wait
                # it out, so its side effects (d2h advances the MD5 ETag
                # chains) complete before the group reports its outcome
                await asyncio.wait({job.fut})
            if job.fut.done():
                busy.append(job.busy)
                return job.fut.result()
            raise _DeviceHang("pipeline aborted by a sibling batch hang")
        finally:
            abort.cancel()
            if not job.fut.done():
                job.fut.cancel()

    # ---- pipeline lifecycle + overlap accounting (loop thread) ---------

    def _pipeline(self) -> DevicePipeline:
        if self._pl is None or self._pl.dead:
            self._pl = DevicePipeline(self._pl_busy)
        return self._pl

    def _on_device_hang(self) -> None:
        """First watchdog to fire wins: mark the generation dead (its
        stuck daemon threads are abandoned) and wake every sibling batch
        via the abort event; the next batch gets a fresh generation."""
        pl = self._pl
        if pl is None or pl.dead:
            return
        pl.dead = True
        pl.aborted.set()
        log.error("feeder batch stuck >%ss; pipeline generation abandoned",
                  self.batch_timeout)

    def _window_open(self) -> None:
        if self._win_open == 0:
            self._win_t0 = time.monotonic()
        self._win_open += 1

    def _window_close(self) -> None:
        self._win_open -= 1
        if self._win_open == 0:
            self._pl_wall += time.monotonic() - self._win_t0

    def pipeline_stats(self) -> dict:
        """Per-stage busy seconds (in total and by op), device items by
        op, the wall-clock union of in-flight windows, and busy/wall
        (> 1.0 means stages overlapped)."""
        busy = {k: round(v, 6) for k, v in self._pl_busy.items()}
        wall = self._pl_wall
        if self._win_open > 0:
            wall += time.monotonic() - self._win_t0
        total = sum(self._pl_busy.values())
        return {"busy_s": busy,
                "op_busy_s": {op: {k: round(v, 6) for k, v in st.items()}
                              for op, st in self._op_busy.items()},
                "op_items": dict(self._op_items),
                "wall_s": round(wall, 6),
                "overlap_efficiency": round(total / wall, 3) if wall > 0
                else 0.0,
                "inflight": len(self._inflight_tasks)}
