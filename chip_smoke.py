#!/usr/bin/env python3
"""Chip smoke for garage_tpu_torch, the PyTorch/CUDA port of the block
data path, on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel).
2. Kernel phase: calls each kernel's wrapper on the card at the shapes
   the main path gives it — G1 gf_apply (RS(10,4) encode, decode and
   repair with mixed erasure patterns), G2 gf_check, B3 blake3_rows —
   and holds the result byte for byte against its plain torch version
   on the same inputs and against the native C oracles; times each
   with CUDA events (median of 20 launches) beside its bound.
3. Main path, with every launch count set to 0 just before it and read
   just after: a DeviceFeeder(codec=ErasureCodec(10, 4),
   mode="require", max_batch=256) on cuda:0 drives
   - PUT: 1 GiB (1024 blocks of 1 MiB, made from a seed) as 8
     concurrent objects; each block through hash_with_md5 (one
     native.Md5 per object), then encode_put with the scheme-byte
     prefix; the 14 framed shards of each block go to 14 node
     directories under a temporary directory; every ETag is checked
     against hashlib.md5 and every content hash against the host BLAKE3;
   - degraded GET: every block decoded from 10 shards, 4 erased in a
     pattern that changes from block to block, checked byte for byte
     and by content hash;
   - scrub: verify_blocks and parity_check over every stripe with one
     flipped byte planted in one shard: exactly that stripe is flagged;
   - repair: the 4 erased shards of every block rebuilt byte-identical.
4. Prints the card (nvidia-smi name and power limit), the build time,
   per-kernel launches / ms / GB/s, the path's rates and the feeder's
   counters, a `{"kernels": [...]}` line, and last
   `{"ok": true, "device": {...}}`.

Any mismatch, a kernel with no launch on the main path, or a host
fallback exits non-zero without the last line; so does a machine
without CUDA, or a directory without the garage_tpu_torch package.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261017
K, M = 10, 4
BLOCK = 1 << 20
N_BLOCKS = 1024
N_OBJECTS = 8
BATCH = 256
PUT_BATCH = 8  # hash_md5 batches: one block per concurrent object
WINDOW = 64  # encode_put calls in flight per object
# The card's peaks (NVIDIA H100 SXM data sheet, at the 700 W limit):
HBM_BYTES_PER_S = 3.35e12
# 32-bit lane instructions per second, of any type: each of an SM's 4
# schedulers issues at most one 32-lane warp instruction per clock, the
# rate the data sheet's 67 TFLOP/s float32 counts with an FMA as 2 flops
LANE_OPS_PER_S = 67e12 / 2
# one BLAKE3 compression on sm_90: 7 rounds x 8 G x 12 instructions
# (2 three-input adds and 2 two-input adds as IADD3, 4 xors, 4 rotates
# as funnel shifts or byte permutes) + 8 xors for the output words
B3_OPS_PER_COMPRESSION = 7 * 8 * 12 + 8


class SmokeError(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(torch, a, b) -> int:
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def patterns(rng, n: int) -> list[tuple[tuple, tuple]]:
    """n distinct (present, erased) pairs of RS(10,4), 4 shards erased,
    at least one of them a data shard."""
    out, seen = [], set()
    while len(out) < n:
        erased = tuple(sorted(int(i) for i in
                              rng.choice(K + M, M, replace=False)))
        if erased in seen or min(erased) >= K:
            continue
        seen.add(erased)
        out.append((tuple(i for i in range(K + M) if i not in erased),
                    erased))
    return out


def kernel_phase(torch, data: np.ndarray, rng, dev) -> dict:
    from garage_tpu_torch import native
    from garage_tpu_torch.block.device_backend import round_vec
    from garage_tpu_torch.ops import gf_kernel, rs, treehash

    slen = rs.shard_len(1 + BLOCK, K)
    s = round_vec(slen)  # the backend's shard-length pad
    x_np = data[: BATCH * K * s].reshape(BATCH, K, s)
    x = torch.from_numpy(x_np).to(dev)
    res = {}

    # G1, encode: one broadcast parity matrix
    pmat = torch.from_numpy(rs.parity_matrix(K, M)[None].copy()).to(dev)
    out = gf_kernel.gf_apply(pmat, x)
    plain = gf_kernel.gf_apply_plain(pmat, x)
    err = max_abs_err(torch, out, plain)
    out_np = out.cpu().numpy()
    for i in range(BATCH):
        check(np.array_equal(out_np[i], native.gf_matmul(
            rs.parity_matrix(K, M), x_np[i])), f"G1 encode != native, item {i}")
    check(err == 0, f"G1 encode != plain torch (max err {err})")
    del plain
    res["gf_apply"] = {
        "err": err,
        "ms": time_ms(torch, lambda: gf_kernel.gf_apply(pmat, x)),
        "plain_ms": time_ms(torch, lambda: gf_kernel.gf_apply_plain(pmat, x),
                            reps=5, warmup=1),
        # G1 and G2 are table lookups and xors; their bound is the bytes
        # (no matrix product runs that a data-sheet rate would price)
        "bytes": (K + M) * s * BATCH + M * K,
        "shape": f"encode ({BATCH},{K},{s})->({BATCH},{M},{s})"}
    # the PUT path's own batches are as wide as the concurrent objects
    xp = x[:PUT_BATCH]
    check(torch.equal(gf_kernel.gf_apply(pmat, xp),
                      gf_kernel.gf_apply_plain(pmat, xp)),
          f"G1 encode != plain torch at batch {PUT_BATCH}")
    res["gf_apply[put]"] = {
        "err": 0, "ms": time_ms(torch, lambda: gf_kernel.gf_apply(pmat, xp)),
        "bytes": (K + M) * s * PUT_BATCH + M * K,
        "shape": f"encode ({PUT_BATCH},{K},{s})->({PUT_BATCH},{M},{s})"}

    # G2 on the verified parity, 8 stripes corrupted in one byte each
    stripes = torch.cat([x, out], dim=1)
    bad = sorted(int(i) for i in rng.choice(BATCH, 8, replace=False))
    for i in bad:
        stripes[i, int(rng.integers(K + M)), int(rng.integers(slen))] ^= 0x10
    ok = gf_kernel.gf_check(pmat, stripes)
    ok_plain = gf_kernel.gf_check_plain(pmat, stripes)
    flagged = sorted(int(i) for i in torch.nonzero(~ok).flatten().tolist())
    check(flagged == bad, f"G2 flagged {flagged}, planted {bad}")
    check(torch.equal(ok, ok_plain), "G2 != plain torch")
    res["gf_check"] = {
        "err": 0,
        "ms": time_ms(torch, lambda: gf_kernel.gf_check(pmat, stripes)),
        "plain_ms": time_ms(torch, lambda: gf_kernel.gf_check_plain(
            pmat, stripes), reps=5, warmup=1),
        "bytes": (K + M) * s * BATCH + 4 * BATCH + M * K,
        "shape": f"({BATCH},{K + M},{s}) -> ({BATCH},) flags"}
    del stripes, out

    # G1, decode and repair: per-item matrices, mixed erasure patterns
    pats = patterns(rng, 16)
    for op, rows in (("decode", K), ("repair", M)):
        mats_np = np.stack([
            rs.decode_matrix(K, M, p) if op == "decode"
            else rs.repair_matrix(K, M, p, e)
            for p, e in (pats[i % len(pats)] for i in range(BATCH))])
        mats = torch.from_numpy(mats_np).to(dev)
        got = gf_kernel.gf_apply(mats, x)
        plain = gf_kernel.gf_apply_plain(mats, x)
        err = max_abs_err(torch, got, plain)
        check(err == 0, f"G1 {op} != plain torch (max err {err})")
        got_np = got.cpu().numpy()
        for i in range(0, BATCH, 7):
            check(np.array_equal(got_np[i], native.gf_matmul(
                mats_np[i], x_np[i])), f"G1 {op} != native, item {i}")
        del plain, got
        res[f"gf_apply[{op}]"] = {
            "err": err,
            "ms": time_ms(torch, lambda: gf_kernel.gf_apply(mats, x)),
            "bytes": (K + rows) * s * BATCH + rows * K * BATCH,
            "shape": f"{op} ({BATCH},{K},{s})->({BATCH},{rows},{s}), "
                     f"{len(pats)} patterns"}
    del x
    torch.cuda.empty_cache()

    # B3 at the PUT shape (256 rows of 1 MiB), then edge lengths
    msgs_np = data[: BATCH * BLOCK].reshape(BATCH, BLOCK)
    msgs = torch.from_numpy(msgs_np).to(dev)
    lens = torch.full((BATCH,), BLOCK, dtype=torch.int32, device=dev)
    got = treehash.hash_rows(msgs, lens)
    plain = treehash.hash_rows_plain(msgs, lens)
    err = max_abs_err(torch, got, plain)
    check(err == 0, f"B3 != plain torch (max err {err})")
    want = native.blake3_many([msgs_np[i].tobytes() for i in range(BATCH)])
    got_np = got.cpu().numpy()
    check(all(got_np[i].tobytes() == want[i] for i in range(BATCH)),
          "B3 != native BLAKE3")
    for lengths in ([0, 1, 63, 64, 65, 1023, 1024], [1025, 2047, 2048],
                    [3 * 1024 + 1, 4096], [BLOCK - 1, BLOCK]):
        c = max(1, -(-max(lengths) // 1024))
        m_np = np.zeros((len(lengths), c * 1024), dtype=np.uint8)
        for i, n in enumerate(lengths):
            m_np[i, :n] = data[i * 7919: i * 7919 + n]
        m_t, l_t = (torch.from_numpy(m_np).to(dev),
                    torch.tensor(lengths, dtype=torch.int32, device=dev))
        got_e = treehash.hash_rows(m_t, l_t).cpu().numpy()
        check(np.array_equal(got_e, treehash.hash_rows_plain(m_t, l_t)
                             .cpu().numpy()), f"B3 != plain at {lengths}")
        want_e = native.blake3_many([m_np[i, :n].tobytes()
                                     for i, n in enumerate(lengths)])
        check(all(got_e[i].tobytes() == w for i, w in enumerate(want_e)),
              f"B3 != native at {lengths}")
    compressions = BATCH * (16 * (BLOCK // 1024) + BLOCK // 1024 - 1)
    res["blake3_rows"] = {
        "err": err,
        "ms": time_ms(torch, lambda: treehash.hash_rows(msgs, lens)),
        "plain_ms": time_ms(torch, lambda: treehash.hash_rows_plain(
            msgs, lens), reps=5, warmup=1),
        "bytes": BATCH * BLOCK + 4 * BATCH + 32 * BATCH,
        "ops": compressions * B3_OPS_PER_COMPRESSION,
        "shape": f"({BATCH},{BLOCK}) rows -> ({BATCH},32) digests"}
    mp, lp = msgs[:PUT_BATCH], lens[:PUT_BATCH]
    check(torch.equal(treehash.hash_rows(mp, lp), plain[:PUT_BATCH]),
          f"B3 != plain torch at batch {PUT_BATCH}")
    res["blake3_rows[put]"] = {
        "err": 0, "ms": time_ms(torch, lambda: treehash.hash_rows(mp, lp)),
        "bytes": PUT_BATCH * (BLOCK + 36),
        "ops": compressions // BATCH * PUT_BATCH * B3_OPS_PER_COMPRESSION,
        "shape": f"({PUT_BATCH},{BLOCK}) rows -> ({PUT_BATCH},32) digests"}
    del msgs, plain, got
    torch.cuda.empty_cache()
    for r in res.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r.get("ops", 0) / LANE_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["gbps"] = r["bytes"] / (r["ms"] * 1e-3) / 1e9
    return res


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


async def main_path(data: np.ndarray, root: str, rng, dev) -> dict:
    from garage_tpu_torch import native
    from garage_tpu_torch.block.codec import ErasureCodec
    from garage_tpu_torch.block.feeder import DeviceFeeder
    from garage_tpu_torch.block.manager import unpack_shard

    feeder = DeviceFeeder(codec=ErasureCodec(K, M, device=dev),
                          mode="require", max_batch=BATCH, device=dev)
    nodes = [os.path.join(root, f"node{j:02d}") for j in range(K + M)]
    for d in nodes:
        os.makedirs(d)
    blocks = [data[i * BLOCK:(i + 1) * BLOCK].tobytes()
              for i in range(N_BLOCKS)]
    hashes: list = [None] * N_BLOCKS
    per_obj = N_BLOCKS // N_OBJECTS
    rates = {}

    def write_shards(i: int, parts) -> None:
        for j, part in enumerate(parts):
            with open(os.path.join(nodes[j], f"{i:05d}"), "wb") as f:
                f.write(part)

    def read_shards(i: int, which) -> list:
        out = []
        for j in which:
            with open(os.path.join(nodes[j], f"{i:05d}"), "rb") as f:
                out.append(unpack_shard(f.read()))
        return out

    async def put_object(o: int):
        md5 = native.Md5()
        window = asyncio.Semaphore(WINDOW)
        tasks = []

        async def store(i: int):
            try:
                parts = await feeder.encode_put(blocks[i], prefix=b"\x00")
                await asyncio.to_thread(write_shards, i, parts)
            finally:
                window.release()

        feeder.active_streams += 1
        try:
            for i in range(o * per_obj, (o + 1) * per_obj):
                hashes[i] = await feeder.hash_with_md5(blocks[i], md5)
                await window.acquire()
                tasks.append(asyncio.create_task(store(i)))
            await asyncio.gather(*tasks)
        finally:
            feeder.active_streams -= 1
        return md5.hexdigest()

    try:
        t0 = time.perf_counter()
        etags = await asyncio.gather(*(put_object(o)
                                       for o in range(N_OBJECTS)))
        rates["put_s"] = time.perf_counter() - t0
        for o, etag in enumerate(etags):
            want = hashlib.md5(
                data[o * per_obj * BLOCK:(o + 1) * per_obj * BLOCK]).hexdigest()
            check(etag == want, f"ETag of object {o}: {etag} != {want}")
        host = native.blake3_many(blocks)
        check(hashes == host, "content hash != host BLAKE3")

        # degraded GET: 4 shards erased, pattern per block
        pats = patterns(rng, 32)
        pat_of = [pats[i % len(pats)] for i in range(N_BLOCKS)]
        t0 = time.perf_counter()
        for w in range(0, N_BLOCKS, BATCH):
            idx = range(w, w + BATCH)
            reads = await asyncio.gather(*(asyncio.to_thread(
                read_shards, i, pat_of[i][0][:K]) for i in idx))
            outs = await asyncio.gather(*(feeder.decode(
                pat_of[i][0][:K], [p for p, _ in r], r[0][1])
                for i, r in zip(idx, reads)))
            for i, out in zip(idx, outs):
                check(out[0] == 0 and out[1:] == blocks[i],
                      f"degraded GET of block {i} differs")
            check(native.blake3_many([o[1:] for o in outs])
                  == hashes[w:w + BATCH], "degraded GET content hash")
        rates["get_s"] = time.perf_counter() - t0

        # scrub: one flipped byte in one data shard of one stripe
        bad_block, bad_shard = int(rng.integers(N_BLOCKS)), int(rng.integers(K))
        t0 = time.perf_counter()
        flagged_hash, flagged_parity = [], []
        for w in range(0, N_BLOCKS, BATCH):
            idx = list(range(w, w + BATCH))
            reads = await asyncio.gather(*(asyncio.to_thread(
                read_shards, i, range(K + M)) for i in idx))
            stripes = [[p for p, _ in r] for r in reads]
            if bad_block in idx:
                row = stripes[bad_block - w]
                flip = bytearray(row[bad_shard])
                flip[len(flip) // 2] ^= 0x01
                row[bad_shard] = bytes(flip)
            plains = [b"".join(st[:K])[1:1 + BLOCK] for st in stripes]
            ok_hash = await feeder.verify_blocks(
                [(hashes[i], p) for i, p in zip(idx, plains)])
            ok_par = await feeder.parity_check(stripes)
            flagged_hash += [i for i, v in zip(idx, ok_hash) if not v]
            flagged_parity += [i for i, v in zip(idx, ok_par) if not v]
        rates["scrub_s"] = time.perf_counter() - t0
        check(flagged_hash == [bad_block],
              f"verify_blocks flagged {flagged_hash}, planted {bad_block}")
        check(flagged_parity == [bad_block],
              f"parity_check flagged {flagged_parity}, planted {bad_block}")

        # repair: rebuild the erased shards of every block
        t0 = time.perf_counter()
        for w in range(0, N_BLOCKS, BATCH):
            idx = range(w, w + BATCH)
            reads = await asyncio.gather(*(asyncio.to_thread(
                read_shards, i, range(K + M)) for i in idx))
            outs = await asyncio.gather(*(feeder.repair(
                pat_of[i][0][:K], pat_of[i][1],
                [reads[i - w][j][0] for j in pat_of[i][0][:K]])
                for i in idx))
            for i, out in zip(idx, outs):
                check(out == {e: reads[i - w][e][0] for e in pat_of[i][1]},
                      f"repair of block {i} differs")
        rates["repair_s"] = time.perf_counter() - t0
        rates["stats"] = dict(feeder.stats)
        rates["pipeline"] = feeder.pipeline_stats()
        return rates
    finally:
        await feeder.stop()


# ---------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: no torch ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from garage_tpu_torch.ops import _build, kernel_launches, \
            reset_launches
    except ImportError as e:
        print(f"chip_smoke: garage_tpu_torch not found beside this script "
              f"({e})", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed nothing")
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {sorted(built)} compiled in "
          f"{time.perf_counter() - t0:.2f} s (nvcc, parallel)")
    for name, info in sorted(built.items()):
        for line in info["ptxas"]:
            print(f"  ptxas {name}: {line}")

    rng = np.random.default_rng(SEED)
    data = np.frombuffer(bytearray(rng.bytes(N_BLOCKS * BLOCK)),
                         dtype=np.uint8)

    dev = torch.device("cuda", 0)
    kres = kernel_phase(torch, data, rng, dev)
    for name, r in kres.items():
        print(f"kernel {name} {r['shape']}: ok, {r['ms']:.4f} ms "
              f"({r['gbps']:.1f} GB/s), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})"
              + (f", plain {r['plain_ms']:.2f} ms" if "plain_ms" in r
                 else ""))

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        reset_launches()
        rates = asyncio.run(main_path(data, root, rng, dev))
        launches = kernel_launches()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stats = rates["stats"]
    gib = N_BLOCKS * BLOCK
    print(f"main path PUT: {N_BLOCKS} x 1 MiB in {N_OBJECTS} objects, "
          f"{gib / rates['put_s'] / 1e9:.3f} GB/s ({rates['put_s']:.2f} s)")
    print(f"main path degraded GET: {gib / rates['get_s'] / 1e9:.3f} GB/s "
          f"({rates['get_s']:.2f} s)")
    print(f"main path scrub: {N_BLOCKS / rates['scrub_s']:.1f} blocks/s "
          f"({rates['scrub_s']:.2f} s), exactly the planted stripe flagged")
    print(f"main path repair: {gib / rates['repair_s'] / 1e9:.3f} GB/s of "
          f"blocks ({rates['repair_s']:.2f} s)")
    print("feeder: device_items={device_items} decode_device_items="
          "{decode_device_items} device_fallbacks={device_fallbacks} "
          "items={items} batches={batches} "
          "max_batch={max_batch}".format(**stats))
    print(f"pipeline: {json.dumps(rates['pipeline'])}")
    print(f"launches on the main path: {json.dumps(launches)}")
    check(stats["device_fallbacks"] == 0, "device fallbacks on the main path")
    check(stats["device_items"] == stats["items"],
          "a main-path request did not run on the device")
    check(stats["device_items"] > 0 and stats["decode_device_items"] > 0,
          "the main path did not reach the device")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    meta = {
        "gf_apply": ("garage_tpu_torch/csrc/gf256.cu",
                     "garage_tpu/ops/pallas_gf.py:32"),
        "gf_check": ("garage_tpu_torch/csrc/gf256.cu",
                     "garage_tpu/ops/rs.py:217"),
        "blake3_rows": ("garage_tpu_torch/csrc/blake3.cu",
                        "garage_tpu/ops/treehash.py:205"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = kres[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
