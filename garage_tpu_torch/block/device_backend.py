"""Staged device backend for the DeviceFeeder pipeline (torch/CUDA).

- `StageExecutor` / `DevicePipeline` (copied from the JAX package):
  three daemon worker threads — h2d (host pack + host->device copy),
  compute (kernel launch), d2h (readback + host-side finish). Each
  stage is one thread, so stage N of batch B+1 can run while stage N+1
  of batch B runs. Generations are disposable: a hung stage is
  abandoned (the feeder swaps in a fresh generation), never joined.

- `TorchDeviceBackend`: the device route, with the same
  stage/compute/readback contract and ops as the JAX package's
  JaxDeviceBackend, on one device. Its kernels are G1/G2
  (ops/gf_kernel.py) and B3 (ops/treehash.py) on CUDA tensors, their
  plain torch versions on CPU tensors. Item counts pad up the bucket
  ladder (PAD_BUCKETS) so the set of launch shapes stays finite; shard lengths pad only to the kernels' 16-byte vector width
  (no compile is keyed on them, so the power-of-two shard-length bucket
  of the JAX package would only add padding). Zero padding is safe for
  the RS ops (the code is linear); hash pad rows are full-length zero
  messages whose digests are sliced away. Decode/repair ship the
  erasure pattern as DATA: each stripe's coefficient matrix rides with
  its shards into one G1 launch, so no launch depends on which shards
  survived.

  All three stages run on ONE CUDA stream owned by the backend
  (torch's current stream is per thread, and the stages run in three
  threads), and the h2d stage waits for its copies before it returns:
  a PUT task releases its ingest lease as soon as encode_put returns,
  and the next PUT overwrites that buffer. Overlap of stages on
  separate streams is later work.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from .. import resolve_device

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
    exclusive execution time (the per-op stage breakdown), NOT the
    pipeline wall, which includes queue wait behind sibling batches."""

    __slots__ = ("loop", "fut", "fn", "claimed", "busy")

    def __init__(self, loop, fn):
        self.loop = loop
        self.fut = loop.create_future()
        self.fn = fn
        self.claimed = False
        self.busy = 0.0


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
            job.claimed = True
            t0 = time.perf_counter()
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


def round_vec(n: int) -> int:
    """Shard-length pad: the GF kernels' 16-byte vector width."""
    return max(16, -(-n // 16) * 16)


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

    def __init__(self, codec=None, device="cuda", stats: dict | None = None):
        self.codec = codec
        self.device = resolve_device(device)
        self.stats = stats if stats is not None else {"pad_waste_bytes": 0}
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
                raise NotImplementedError("sha256 lane: later slice")
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
            b = bucket_items(len(idxs))
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
        smax = round_vec(max(slens))
        bpad = bucket_items(len(blocks))
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
        return (blocks, slens, batch_t, self._to_device(batch_t))

    def _stage_parity(self, stripes: list[list[bytes]]):
        k, m = self.codec.k, self.codec.m
        smax = round_vec(max(len(s[0]) for s in stripes))
        bpad = bucket_items(len(stripes))
        arr_t, arr = self._host((bpad, k + m, smax))
        arr[...] = 0
        for i, s in enumerate(stripes):
            for j, b in enumerate(s):
                arr[i, j, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        waste = bpad * (k + m) * smax - sum(len(b) for s in stripes for b in s)
        self.stats["pad_waste_bytes"] += waste
        return (len(stripes), self._to_device(arr_t))

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
            smax = round_vec(max(slens))
            bpad = bucket_items(len(idxs))
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
                           self._to_device(batch_t)))
        return staged

    # ---- compute: launch the kernels (no host sync) ----------------------

    def compute(self, op: str, staged):
        from ..ops import rs, treehash

        op, blobs, inner = staged
        k, m = (self.codec.k, self.codec.m) if self.codec else (0, 0)
        with self._on_stream():
            if op in ("hash", "verify", "hash_md5"):
                n, groups = inner
                out = (n, [(idxs, treehash.hash_rows(buf, lens))
                           for idxs, buf, lens in groups])
            elif op in ("encode", "encode_put"):
                blocks, slens, batch_t, dev = inner
                out = (blocks, slens, batch_t, rs.encode(k, m, dev))
            elif op == "parity_check":
                n, dev = inner
                out = (n, rs.parity_check(k, m, dev))
            elif op in ("decode", "repair"):
                out = [(idxs, slens, rs.gf_apply_batched(mats, dev))
                       for idxs, slens, mats, dev in inner]
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
