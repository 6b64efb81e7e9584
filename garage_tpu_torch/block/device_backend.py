"""Staged device backend for the DeviceFeeder pipeline (torch/CUDA).

- `StageExecutor` / `DevicePipeline` (copied from the JAX package):
  three daemon worker threads — h2d (host pack + host->device copy),
  compute (kernel launch), d2h (readback + host-side finish). Each
  stage is one thread, so stage N of batch B+1 can run while stage N+1
  of batch B runs. Generations are disposable: a hung stage is
  abandoned (the feeder swaps in a fresh generation), never joined.

- `TorchDeviceBackend`: the device route, with the same
  stage/compute/readback contract and ops as the JAX package's
  JaxDeviceBackend. Its kernels are G1/G2
  (ops/gf_kernel.py), B3 (ops/treehash.py) and S2 (ops/sha256.py) on
  CUDA tensors, their plain torch versions on CPU tensors. Item counts
  pad up the bucket ladder (`[tpu] pad_buckets`, default PAD_BUCKETS)
  so the set of launch shapes stays finite; shard lengths pad only to
  the kernels' 16-byte vector width (no compile is keyed on them, so
  the power-of-two shard-length bucket of the JAX package would only
  add padding); SHA-256 rows pad to their group's longest message.
  Zero padding is safe for the RS ops (the code is linear); hash pad
  rows are full-length zero messages whose digests are sliced away.
  Decode/repair ship the erasure pattern as DATA: each stripe's
  coefficient matrix rides with its shards into one G1 launch, so no
  launch depends on which shards survived.

  The grid route (the JAX package's mesh route): with a device grid of
  more than one cell (parallel/mesh.py; by default every visible CUDA
  device when there are several), encode, parity-check and decode /
  repair batches of at least `[tpu] mesh_min_items` items round their
  stripe count up to a multiple of dp and their shard length up to tp
  vector widths, and run the grid's split steps; `mesh_batches` counts
  them. On one card the grid has one cell and the route stays off.

  All three stages run on ONE CUDA stream owned by the backend
  (torch's current stream is per thread, and the stages run in three
  threads), and the h2d stage waits for its copies before it returns:
  a PUT task releases its ingest lease as soon as encode_put returns,
  and the next PUT overwrites that buffer. Overlap of stages on
  separate streams is later work. Every launch shape the backend has
  not launched before adds one to the feeder's `recompiles` (the JAX
  package counts XLA compiles there; the kernels here are built once,
  so the count says how many distinct shapes the padding let through).

- `StubDeviceBackend` (ported from the JAX package): a deterministic
  device emulator (`[tpu] device_backend = "stub"` or
  GARAGE_TPU_DEVICE_BACKEND=stub) that computes real results through
  the feeder's host route and sleeps a modelled transfer / compute /
  readback latency per stage, so pipeline overlap, the watchdog and
  the routing are testable without a GPU. It launches no kernel.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time

import numpy as np
import torch

from .. import resolve_device

log = logging.getLogger("garage_tpu_torch.block.device_backend")

STAGES = ("h2d", "compute", "d2h")

# item-count bucket ladder for fixed-shape launches (the JAX package's
# [tpu] pad_buckets default)
PAD_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def bucket_items(n: int, buckets=PAD_BUCKETS) -> int:
    """Smallest bucket >= n (n itself above the ladder)."""
    for b in buckets:
        if b >= n:
            return int(b)
    return n


def bucket_len(n: int, quantum: int = 1024) -> int:
    """Next power of two >= n (minimum `quantum`): the JAX package's
    shard-length bucket. The port's launches pad shard lengths only to
    the vector width (`round_vec`); this stays for callers that want the
    JAX package's shape ladder."""
    b = quantum
    while b < n:
        b <<= 1
    return b


def verify_matches(digs: list, items: list) -> list[bool]:
    """Per-item content-hash verdicts for [(hash32, plain)] items:
    digest equality, else the legacy-algorithm rule."""
    from ..utils.data import content_hash_matches

    return [dg == h or content_hash_matches(d, h)
            for dg, (h, d) in zip(digs, items)]


def group_bytes(op: str, blobs: list) -> int:
    """Payload bytes of one op group (the feeder's accounting rule)."""
    if op in ("verify", "encode_put", "hash_md5"):
        # 2-tuples, except encode_put also carries ingest leases
        # (scheme byte + body in one pool buffer, sized total_len)
        return sum(b.total_len if hasattr(b, "total_len") else len(b[1])
                   for b in blobs)
    if op == "sha256":  # item = one message: a buffer or a span list
        from ..ops.sha256 import part_len

        return sum(part_len(b) for b in blobs)
    if op == "parity_check":  # item = one stripe (shard list)
        return sum(len(b) for s in blobs for b in s)
    if op == "decode":  # item = (present, shards, plain_len)
        return sum(len(b) for it in blobs for b in it[1])
    if op == "repair":  # item = (present, missing, shards)
        return sum(len(b) for it in blobs for b in it[2])
    return sum(len(b) for b in blobs
               if isinstance(b, (bytes, bytearray, memoryview)))


class StageJob:
    """One submitted stage execution. `claimed` flips True (worker
    thread, GIL-atomic) the instant the fn starts running — the feeder
    uses it to tell "queued, safely skippable" from "already executing,
    must be waited out" when a watchdog/abort cancels the future. A job
    cancelled BEFORE it is claimed is never executed at all: stage fns
    can carry side effects (the d2h MD5 lane advance), which must not
    land after their batch has already failed. `busy` is the fn's
    exclusive execution time, NOT the pipeline wall, which includes
    queue wait behind sibling batches; `wait` is that queue wait, from
    submit to the claim (both in seconds)."""

    __slots__ = ("loop", "fut", "fn", "claimed", "busy", "wait", "t_sub")

    def __init__(self, loop, fn):
        self.loop = loop
        self.fut = loop.create_future()
        self.fn = fn
        self.claimed = False
        self.busy = 0.0
        self.wait = 0.0
        self.t_sub = time.perf_counter()


class StageExecutor:
    """One daemon worker thread running one pipeline stage's jobs in
    submission order. Results are delivered to the submitting event
    loop via call_soon_threadsafe; a job whose future was cancelled
    before execution is skipped entirely, one cancelled mid-execution
    completes silently. Busy seconds accumulate into the shared
    per-stage dict — the numerator of the overlap-efficiency metric."""

    def __init__(self, name: str, busy: dict):
        self.name = name
        self._busy = busy
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"feeder-{name}")
        self._thread.start()

    def submit(self, loop, fn) -> StageJob:
        job = StageJob(loop, fn)
        self._jobs.put(job)
        return job

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job.fut.cancelled():
                continue  # abandoned while queued: never execute
            t0 = time.perf_counter()
            job.wait = t0 - job.t_sub  # set before `claimed` is seen
            job.claimed = True
            try:
                res, err = job.fn(), None
            except BaseException as e:
                res, err = None, e
            job.busy = time.perf_counter() - t0
            self._busy[self.name] += job.busy

            def deliver(fut=job.fut, res=res, err=err):
                if fut.cancelled():
                    return  # abandoned by the watchdog mid-execution
                if err is not None:
                    fut.set_exception(err)
                else:
                    fut.set_result(res)

            try:
                job.loop.call_soon_threadsafe(deliver)
            except RuntimeError:
                # loop already closed (feeder stopped mid-batch):
                # the caller's future is moot, nothing to deliver to
                pass


class DevicePipeline:
    """One GENERATION of the three stage executors plus its abort
    event. On a hang the feeder marks the generation dead and sets
    `aborted` so every sibling in-flight batch fails immediately
    instead of each waiting out its own full watchdog; the
    next device batch gets a fresh generation (fresh threads — the
    stuck ones are abandoned)."""

    def __init__(self, busy: dict):
        import asyncio

        self.dead = False
        self.aborted = asyncio.Event()
        self._execs = {s: StageExecutor(s, busy) for s in STAGES}

    def submit(self, stage: str, loop, fn) -> StageJob:
        return self._execs[stage].submit(loop, fn)


# ---------------------------------------------------------------------------
# Torch backend: padded staged launches of the hand-written kernels
# ---------------------------------------------------------------------------


def round_vec(n: int, parts: int = 1) -> int:
    """Shard-length pad: the GF kernels' 16-byte vector width, in each
    of `parts` equal byte parts."""
    q = 16 * parts
    return max(q, -(-n // q) * q)


def _default_grid(device: torch.device):
    """Every visible CUDA device when there are several, else None."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    from ..parallel.mesh import data_plane_mesh

    return data_plane_mesh()


def _fill_stripe(dst: np.ndarray, pre: bytes, data, sl: int) -> None:
    """dst (k, >= sl) <- the rows of rs.split_stripe(pre + data, k) with
    shard length sl, zero tail and row padding included — one copy of
    the payload, without building the concatenation. Row j holds bytes
    [j*sl, (j+1)*sl) of the logical stream pre || data."""
    p = len(pre)
    src = np.frombuffer(data, dtype=np.uint8)
    n = p + src.size
    dst[0, :p] = np.frombuffer(pre, dtype=np.uint8)
    for j in range(dst.shape[0]):
        base = j * sl
        lo, hi = max(base, p), min(base + sl, n)
        if lo < hi:
            dst[j, lo - base:hi - base] = src[lo - p:hi - p]
        dst[j, max(hi, base) - base:] = 0


class TorchDeviceBackend:
    """The device route, split into h2d / compute / d2h. All three
    methods run in StageExecutor worker threads (never the event loop),
    under the feeder's watchdog."""

    def __init__(self, codec=None, device="cuda", stats: dict | None = None,
                 pad_buckets=PAD_BUCKETS, grid=None, mesh_min_items: int = 8):
        self.codec = codec
        self.pad_buckets = tuple(sorted(int(b) for b in pad_buckets)) \
            or PAD_BUCKETS
        self.device = resolve_device(device)
        self.stats = stats if stats is not None else {"pad_waste_bytes": 0,
                                                      "mesh_batches": 0,
                                                      "recompiles": 0}
        # launch shapes seen so far (the `recompiles` count)
        self._shapes: set = set()
        # the grid route: `grid` (parallel/mesh.py Grid) or, by default,
        # every visible CUDA device when there are several
        self.grid = grid if grid is not None else _default_grid(self.device)
        self.mesh_min_items = max(1, int(mesh_min_items))
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)

    # ---- shared helpers --------------------------------------------------

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._cuda
                else contextlib.nullcontext())

    def _host(self, shape) -> tuple[torch.Tensor, np.ndarray]:
        """An uninitialised host staging tensor (page-locked when the
        device is CUDA, so the h2d copy is one DMA) and its numpy view."""
        t = torch.empty(shape, dtype=torch.uint8, pin_memory=self._cuda)
        return t, t.numpy()

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    def _h2d_done(self) -> None:
        """Block until this stream's copies have landed: the host
        buffers (ingest leases, staging) may be reused once the h2d
        stage returns."""
        if self._cuda:
            self._stream.synchronize()

    @staticmethod
    def _numpy(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def _shape(self, *key) -> None:
        """Count a launch shape the backend has not launched before."""
        if key not in self._shapes:
            self._shapes.add(key)
            self.stats["recompiles"] = self.stats.get("recompiles", 0) + 1

    def _grid_for(self, n_items: int):
        """The grid for a batch of n_items, or None (one device)."""
        if self.grid is None or self.grid.size < 2 \
                or n_items < self.mesh_min_items:
            return None
        return self.grid

    def _padded(self, n_items: int, slen: int, grid):
        """(items, shard length) of a launch: the bucket ladder and the
        vector width, rounded up to the grid's dp and tp parts."""
        bpad = bucket_items(n_items, self.pad_buckets)
        if grid is None:
            return bpad, round_vec(slen)
        dp, tp = grid.shape["dp"], grid.shape["tp"]
        return -(-bpad // dp) * dp, round_vec(slen, tp)

    # ---- stage: host pack + pad + h2d -----------------------------------

    def stage(self, op: str, blobs: list):
        with self._on_stream():
            if op in ("hash", "verify", "hash_md5"):
                datas = blobs if op == "hash" else [d for _, d in blobs]
                inner = self._stage_hash(datas)
            elif op in ("encode", "encode_put"):
                inner = self._stage_rs(blobs, op)
            elif op == "parity_check":
                inner = self._stage_parity(blobs)
            elif op in ("decode", "repair"):
                inner = self._stage_gf(op, blobs)
            elif op == "sha256":
                inner = self._stage_sha256(blobs)
            else:
                raise RuntimeError(f"unknown device op {op!r}")
            self._h2d_done()
        return (op, blobs, inner)

    def _stage_hash(self, datas: list):
        from ..ops import treehash

        groups: dict[int, list[int]] = {}
        for i, d in enumerate(datas):
            groups.setdefault(treehash.n_chunks_for(len(d)), []).append(i)
        staged = []
        for c, idxs in groups.items():
            b = bucket_items(len(idxs), self.pad_buckets)
            padded = c * treehash.CHUNK_LEN
            buf_t, buf = self._host((b, padded))
            # pad rows are full-length zero messages: a shorter pad
            # length would be an invalid c-chunk message
            lengths = np.full(b, padded, dtype=np.int32)
            for row, i in enumerate(idxs):
                arr = np.frombuffer(datas[i], dtype=np.uint8)
                buf[row, : arr.size] = arr
                buf[row, arr.size:] = 0
                lengths[row] = arr.size
            buf[len(idxs):] = 0
            waste = b * padded - sum(len(datas[i]) for i in idxs)
            self.stats["pad_waste_bytes"] += waste
            staged.append((idxs, self._to_device(buf_t),
                           self._to_device(torch.from_numpy(lengths))))
        return (len(datas), staged)

    def _stage_sha256(self, datas: list):
        """One (B, W) group of SHA-padded rows: W is the longest
        message's padded length (S2 reads only a row's own blocks and
        is built once for every width, so no width or item bucket)."""
        from ..ops import sha256 as sha

        lens = [sha.part_len(d) for d in datas]
        nbs = np.array([sha.n_blocks_for(n) for n in lens], dtype=np.int32)
        width = int(nbs.max()) * sha.BLOCK
        buf_t, buf = self._host((len(datas), width))
        for row, d in enumerate(datas):
            # pad_row_into wants the row's padded blocks zeroed
            buf[row, lens[row]:int(nbs[row]) * sha.BLOCK] = 0
            sha.pad_row_into(buf[row], d)
        self.stats["pad_waste_bytes"] += buf.size - sum(lens)
        # lint: ignore[GL15] S2 is one build for every shape and plans nothing per shape (no plan cache, no graph); the width follows the longest message by design, so a row bucket would close no shape set
        return (self._to_device(buf_t),
                self._to_device(torch.from_numpy(nbs)))

    def _stage_rs(self, blocks: list, op: str):
        """(B, k, S) data stripes. Items: plain blocks ("encode"),
        (prefix, data) tuples or ingest leases ("encode_put"; a lease's
        stripe() IS the split layout). The host staging tensor keeps the
        data shards for readback, which slices them from it instead of
        reading them back from the device."""
        from ..ops import rs

        k = self.codec.k

        def total_len(b):
            if hasattr(b, "total_len"):
                return b.total_len
            return len(b) if op == "encode" else len(b[0]) + len(b[1])

        slens = [rs.shard_len(total_len(b), k) for b in blocks]
        grid = self._grid_for(len(blocks))
        bpad, smax = self._padded(len(blocks), max(slens), grid)
        batch_t, batch = self._host((bpad, k, smax))
        for i, b in enumerate(blocks):
            sl = slens[i]
            if hasattr(b, "stripe") and b.full:
                batch[i, :, :sl] = b.stripe()
                batch[i, :, sl:] = 0
            else:
                pre, data = ((b"", b) if op == "encode" else
                             (bytes([b.buf[0]]), b.view())
                             if hasattr(b, "stripe") else b)
                _fill_stripe(batch[i], pre, data, sl)
        batch[len(blocks):] = 0
        waste = bpad * k * smax - sum(total_len(b) for b in blocks)
        self.stats["pad_waste_bytes"] += waste
        return (blocks, slens, batch_t, self._to_device(batch_t), grid)

    def _stage_parity(self, stripes: list[list[bytes]]):
        k, m = self.codec.k, self.codec.m
        grid = self._grid_for(len(stripes))
        bpad, smax = self._padded(len(stripes),
                                  max(len(s[0]) for s in stripes), grid)
        arr_t, arr = self._host((bpad, k + m, smax))
        arr[...] = 0
        for i, s in enumerate(stripes):
            for j, b in enumerate(s):
                arr[i, j, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        waste = bpad * (k + m) * smax - sum(len(b) for s in stripes for b in s)
        self.stats["pad_waste_bytes"] += waste
        return (len(stripes), self._to_device(arr_t), grid)

    def _stage_gf(self, op: str, items: list):
        """Pad + h2d for the pattern-as-data decode/repair launches,
        grouped by OUTPUT ROW COUNT (decode rebuilds k rows, repair
        len(missing)): one launch needs a uniform (B, rows, k) matrix
        stack. The shape key EXCLUDES the erasure pattern."""
        from ..ops import rs

        k, m = self.codec.k, self.codec.m
        shards_of = ((lambda it: it[1]) if op == "decode"
                     else (lambda it: it[2]))
        groups: dict[int, list[int]] = {}
        for i, it in enumerate(items):
            rows = k if op == "decode" else len(it[1])
            groups.setdefault(rows, []).append(i)
        staged = []
        for rows, idxs in groups.items():
            slens = [len(shards_of(items[i])[0]) for i in idxs]
            grid = self._grid_for(len(idxs))
            bpad, smax = self._padded(len(idxs), max(slens), grid)
            batch_t, batch = self._host((bpad, k, smax))
            batch[...] = 0
            # pad rows keep zero matrices: zero output rows, sliced away
            mats = np.zeros((bpad, rows, k), dtype=np.uint8)
            for row, i in enumerate(idxs):
                it = items[i]
                present = tuple(it[0])
                for j, s in enumerate(shards_of(it)):
                    batch[row, j, : len(s)] = np.frombuffer(s, dtype=np.uint8)
                mats[row] = (rs.decode_matrix(k, m, present) if op == "decode"
                             else rs.repair_matrix(k, m, present,
                                                   tuple(it[1])))
            waste = bpad * k * smax - sum(
                len(b) for i in idxs for b in shards_of(items[i]))
            self.stats["pad_waste_bytes"] += waste
            staged.append((idxs, slens,
                           self._to_device(torch.from_numpy(mats)),
                           self._to_device(batch_t), grid))
        return staged

    # ---- compute: launch the kernels (no host sync) ----------------------

    def compute(self, op: str, staged):
        from ..ops import rs, sha256, treehash
        from ..parallel import mesh as pmesh

        op, blobs, inner = staged
        k, m = (self.codec.k, self.codec.m) if self.codec else (0, 0)
        with self._on_stream():
            if op in ("hash", "verify", "hash_md5"):
                n, groups = inner
                for _idxs, buf, _lens in groups:
                    self._shape("hash", *buf.shape)
                out = (n, [(idxs, treehash.hash_rows(buf, lens))
                           for idxs, buf, lens in groups])
            elif op == "sha256":
                self._shape("sha256", *inner[0].shape)
                out = sha256.hash_rows(*inner)
            elif op in ("encode", "encode_put"):
                blocks, slens, batch_t, dev, grid = inner
                self._shape("encode", *dev.shape, grid is not None)
                if grid is not None:
                    parity = pmesh.make_encode_step(
                        grid, k, m, dev.shape[2])(dev)
                    self.stats["mesh_batches"] += 1
                else:
                    parity = rs.encode(k, m, dev)
                out = (blocks, slens, batch_t, parity)
            elif op == "parity_check":
                n, dev, grid = inner
                self._shape("parity_check", *dev.shape, grid is not None)
                if grid is not None:
                    ok = pmesh.make_parity_check_step(
                        grid, k, m, dev.shape[2])(dev)
                    self.stats["mesh_batches"] += 1
                else:
                    ok = rs.parity_check(k, m, dev)
                out = (n, ok)
            elif op in ("decode", "repair"):
                out = []
                for idxs, slens, mats, dev, grid in inner:
                    # the erasure pattern rides in `mats` as data: the
                    # shape is (items, output rows, k, shard length)
                    self._shape("gf", *mats.shape, dev.shape[2],
                                grid is not None)
                    if grid is not None:
                        res = pmesh.make_gf_apply_step(
                            grid, k, mats.shape[1], dev.shape[2])(mats, dev)
                        self.stats["mesh_batches"] += 1
                    else:
                        res = rs.gf_apply_batched(mats, dev)
                    out.append((idxs, slens, res))
            else:
                raise RuntimeError(f"unknown device op {op!r}")
        return (op, blobs, out)

    # ---- readback: d2h + host-side finish -------------------------------

    def readback(self, op: str, handle) -> list:
        with self._on_stream():
            return self._readback(op, handle)

    def _readback(self, op: str, handle) -> list:
        from ..ops import rs

        op, blobs, inner = handle
        if op in ("hash", "verify", "hash_md5"):
            n, launched = inner
            digests: list = [None] * n
            for idxs, dig in launched:
                arr = self._numpy(dig)
                for row, i in enumerate(idxs):
                    digests[i] = arr[row].tobytes()
            if op == "verify":
                return verify_matches(digests, blobs)
            if op == "hash_md5":
                # digests are safely back on the host FIRST: a device
                # failure raises before this point, so a retry re-runs
                # with MD5 state untouched (no double-counted ETag
                # bytes). Only then advance the serial MD5 chains.
                from .. import native

                native.md5_update_many(list(blobs))
            return digests
        if op == "sha256":
            return [row.tobytes().hex() for row in self._numpy(inner)]
        if op in ("encode", "encode_put"):
            blocks, slens, batch_t, parity = inner
            k, m = self.codec.k, self.codec.m
            par = self._numpy(parity)
            batch = batch_t.numpy()
            if op == "encode_put":
                from .manager import pack_shards

                return [pack_shards(
                            [batch[i, :, :sl], par[i, :, :sl]],
                            b.total_len if hasattr(b, "total_len")
                            else len(b[0]) + len(b[1]))
                        for i, (b, sl) in enumerate(zip(blobs, slens))]
            return [[bytes(batch[i, j, :sl]) for j in range(k)]
                    + [bytes(par[i, j, :sl]) for j in range(m)]
                    for i, sl in enumerate(slens)]
        if op == "parity_check":
            n, ok = inner
            return [bool(v) for v in self._numpy(ok)[:n]]
        if op in ("decode", "repair"):
            results: list = [None] * len(blobs)
            for idxs, slens, out in inner:
                arr = self._numpy(out)
                for row, i in enumerate(idxs):
                    sl = slens[row]
                    if op == "decode":
                        # (present, shards, plain_len) -> packed bytes
                        results[i] = rs.join_stripe(arr[row, :, :sl],
                                                    blobs[i][2])
                    else:
                        # (present, missing, shards) -> {idx: payload}
                        results[i] = {
                            mi: bytes(arr[row, j, :sl])
                            for j, mi in enumerate(tuple(blobs[i][1]))}
            return results
        raise RuntimeError(f"unknown device op {op!r}")


# ---------------------------------------------------------------------------
# Stub backend: deterministic latency emulation over the host route
# ---------------------------------------------------------------------------


class StubDeviceBackend:
    """Emulated device: real results (the feeder's host route), modelled
    latency.

    Each stage sleeps `fixed_s + bytes / (rate_gbps * 1e9)` with the
    op's payload bytes (d2h uses the result-size estimate), so overlap
    and watchdog behaviour are measurable and deterministic. Rates come
    from the constructor or the GARAGE_TPU_STUB_GBPS env var
    ("h2d,compute,d2h").

    Test hook: setting `hang_stage` to one of ("h2d", "compute", "d2h")
    makes the next entry into that stage block forever: the injected
    mid-pipeline device hang the watchdog tests use.
    """

    name = "stub"

    def __init__(self, feeder=None, h2d_gbps: float = 1.0,
                 compute_gbps: float = 8.0, d2h_gbps: float = 1.0,
                 fixed_s: float = 0.0):
        env = os.environ.get("GARAGE_TPU_STUB_GBPS")
        if env:
            try:
                parts = [float(x) for x in env.split(",")]
                # pad a short list with the remaining positional
                # defaults ("1,2" keeps d2h's default, not compute's)
                defaults = [h2d_gbps, compute_gbps, d2h_gbps]
                h2d_gbps, compute_gbps, d2h_gbps = (
                    parts + defaults[len(parts):])[:3]
            except ValueError:
                log.warning("bad GARAGE_TPU_STUB_GBPS %r; using defaults",
                            env)
        self.feeder = feeder
        self.rates = {"h2d": h2d_gbps, "compute": compute_gbps,
                      "d2h": d2h_gbps}
        self.fixed_s = float(fixed_s)
        self.hang_stage: str | None = None

    def _maybe_hang(self, stage: str) -> None:
        if self.hang_stage == stage:
            self.hang_stage = None  # one hang; siblings abort via event
            log.warning("stub backend: injected hang in %s stage", stage)
            threading.Event().wait()  # daemon thread, abandoned forever

    def _sleep(self, stage: str, nbytes: int) -> None:
        time.sleep(self.fixed_s + nbytes / (self.rates[stage] * 1e9))

    def stage(self, op: str, blobs: list):
        self._maybe_hang("h2d")
        nbytes = group_bytes(op, blobs)
        self._sleep("h2d", nbytes)
        return (op, blobs, nbytes)

    def compute(self, op: str, staged):
        self._maybe_hang("compute")
        op, blobs, nbytes = staged
        self._sleep("compute", nbytes)
        f = self.feeder
        if op in ("hash", "verify", "hash_md5"):
            datas = blobs if op == "hash" else [d for _, d in blobs]
            res = f._do_hash(list(datas), "host")
        elif op == "sha256":
            res = f._do_sha256(list(blobs), "host")
        elif op == "encode":
            res = f._do_encode(list(blobs), "host")
        elif op == "encode_put":
            res = f._do_encode_put(list(blobs), "host")
        elif op == "parity_check":
            res = f._do_parity_check(list(blobs), "host")
        elif op == "decode":
            res = f._do_decode(list(blobs), "host")
        elif op == "repair":
            res = f._do_repair(list(blobs), "host")
        else:
            raise RuntimeError(f"unknown device op {op!r}")
        return (op, blobs, res)

    def readback(self, op: str, handle) -> list:
        self._maybe_hang("d2h")
        op, blobs, res = handle
        if op in ("hash", "verify", "hash_md5", "sha256"):
            out_bytes = 32 * len(res)
        elif op in ("encode", "encode_put"):
            out_bytes = sum(len(b) for parts in res for b in parts)
        elif op == "decode":
            out_bytes = sum(len(b) for b in res)
        elif op == "repair":
            out_bytes = sum(len(b) for d in res for b in d.values())
        else:
            out_bytes = len(res)
        self._sleep("d2h", out_bytes)
        if op == "verify":
            return verify_matches(res, blobs)
        if op == "hash_md5":
            from .. import native

            native.md5_update_many(list(blobs))
        return res
