#!/usr/bin/env python3
"""Chip smoke for garage_tpu_torch, the PyTorch/CUDA port, on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel).
2. Kernel phase: calls each kernel's wrapper on the card at the shapes
   the main paths give it — G1 gf_apply (RS(10,4) encode, decode and
   repair with mixed erasure patterns), G2 gf_check, B3 blake3_rows, S2
   sha256_rows (SHA padding edges up to 8 KiB, and 8 and 256 rows of a
   64 KiB chunk) — and holds the result byte for byte against its plain
   torch version on the same inputs and against the native C oracles
   (S2 against hashlib); times each with CUDA events (median of 20
   launches) beside its bound.
3. Block path, with every launch count set to 0 just before it and read
   just after: a DeviceFeeder(codec=ErasureCodec(10, 4), max_batch=256)
   on cuda:0 drives
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
4. S3 path, with the launch counts set to 0 again: 14 port Garage nodes
   on cuda:0 in this process (erasure(10,4), 1 MiB blocks, loopback
   transport), node 0's S3 front end on a loopback TCP port, a key and
   a bucket made through the admin RPC handler; 8 client threads
   (tests/s3util.py, an independent stdlib signer) PUT 64 objects of
   16 MiB as STREAMING-AWS4-HMAC-SHA256-PAYLOAD in 64 KiB chunks, 8
   more the same way under torch.profiler (the device's busy time and
   idle share in that window, from the trace), 16 more with
   UNSIGNED-PAYLOAD, GET all of them, stop 4 nodes and GET 16
   degraded; every body and MD5 ETag is checked, and every signed
   chunk of the first round must have reached S2.
5. Prints the card (nvidia-smi name and power limit), the build time,
   per-kernel launches / ms / GB/s, the paths' rates and the feeders'
   counters, a `{"kernels": [...]}` line, and last
   `{"ok": true, "device": {...}}`.

Any mismatch, a kernel with no launch on its path, or a host fallback
exits non-zero without the last line; so does a machine without CUDA,
or a directory without the garage_tpu_torch package.
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
# one SHA-256 compression on sm_90: 64 rounds x 14 instructions (6
# rotates as funnel shifts, 4 LOP3 for the two sigmas, ch and maj, 4
# adds as IADD3) + 48 schedule steps x 10 (4 shifts, 2 LOP3, 2 IADD3,
# 2 more shift/xor) + 4 vector loads, 16 byte swaps, 8 state adds and
# the loop: ~1,407
S2_OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 31
# the serial floor of one message, S2's operations bound: its blocks
# are compressed in sequence by one thread, and one warp issues at most
# one instruction per clock (each round's critical path through `e`,
# ~4 dependent instructions of ~4 cycles, is shorter), so a message
# takes at least its blocks x S2_SERIAL_CYCLES cycles at the card's top
# SM clock (nvidia-smi clocks.max.sm, read in the run)
S2_SERIAL_CYCLES = max(64 * 4 * 4, S2_OPS_PER_COMPRESSION)
# S3 phase: Garage's erasure(10,4) on 14 nodes, 1 MiB blocks, SigV4
# aws-chunked bodies in 64 KiB chunks; 9 metadata replicas, the fewest
# whose majority quorums survive the m = 4 node failures the erasure
# code survives (2 x 4 + 1)
S3_RF = 9
S3_OBJECTS = 64
S3_OBJ_SIZE = 16 << 20
S3_CHUNK = 64 << 10
S3_UNSIGNED = 16
S3_CLIENTS = 8


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


def kernel_phase(torch, data: np.ndarray, rng, dev, sm_hz: float) -> dict:
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
            "plain_ms": time_ms(torch, lambda: gf_kernel.gf_apply_plain(
                mats, x), reps=5, warmup=1),
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
    res.update(sha256_kernel(torch, data, dev, sm_hz))
    for r in res.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        # all lanes of the card, or (S2) one message's serial chain
        t_ops = max(r.get("ops", 0) / LANE_OPS_PER_S * 1e3,
                    r.get("serial_ms", 0.0))
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["gbps"] = r["bytes"] / (r["ms"] * 1e-3) / 1e9
    return res


def sha_rows(sha, msgs: list) -> tuple[np.ndarray, np.ndarray]:
    """(B, W) SHA-padded rows (W the longest message's padded length)
    and (B,) block counts, as the backend stages them."""
    nbs = np.array([sha.n_blocks_for(len(m)) for m in msgs], dtype=np.int32)
    buf = np.zeros((len(msgs), int(nbs.max()) * sha.BLOCK), dtype=np.uint8)
    for i, m in enumerate(msgs):
        sha.pad_row_into(buf[i], m)
    return buf, nbs


def sha256_kernel(torch, data: np.ndarray, dev, sm_hz: float) -> dict:
    """S2 against its plain torch version (SHA padding edges up to 8 KiB,
    and the path's batch of 64 KiB chunks) and against hashlib (8 and
    256 rows of 64 KiB)."""
    from garage_tpu_torch.ops import sha256 as sha

    res = {}
    lens = [0, 55, 56, 63, 64, 119, 120, 8192]
    msgs = [data[i * 9973:i * 9973 + n].tobytes() for i, n in enumerate(lens)]
    buf, nbs = sha_rows(sha, msgs)
    m_t, n_t = torch.from_numpy(buf).to(dev), torch.from_numpy(nbs).to(dev)
    got = sha.hash_rows(m_t, n_t)
    plain = sha.hash_rows_plain(m_t, n_t)
    check(torch.equal(got, plain), f"S2 != plain torch at {lens}")
    got_np = got.cpu().numpy()
    check(all(got_np[i].tobytes() == hashlib.sha256(m).digest()
              for i, m in enumerate(msgs)), f"S2 != hashlib at {lens}")
    out = {}
    for rows in (S3_CLIENTS, BATCH):
        msgs = [data[i * S3_CHUNK:(i + 1) * S3_CHUNK].tobytes()
                for i in range(rows)]
        buf, nbs = sha_rows(sha, msgs)
        m_t = torch.from_numpy(buf).to(dev)
        n_t = torch.from_numpy(nbs).to(dev)
        got_np = sha.hash_rows(m_t, n_t).cpu().numpy()
        check(all(got_np[i].tobytes() == hashlib.sha256(m).digest()
                  for i, m in enumerate(msgs)),
              f"S2 != hashlib at {rows} rows of {S3_CHUNK} B")
        t = time.perf_counter()
        for m in msgs:
            hashlib.sha256(m).digest()
        host_ms = (time.perf_counter() - t) * 1e3
        comp = rows * int(nbs[0])
        out[rows] = {
            "err": 0,
            "ms": time_ms(torch, lambda: sha.hash_rows(m_t, n_t)),
            "bytes": buf.size + 4 * rows + 32 * rows,
            "ops": comp * S2_OPS_PER_COMPRESSION,
            "serial_ms": int(nbs.max()) * S2_SERIAL_CYCLES / sm_hz * 1e3,
            "hashlib_ms": host_ms,
            "shape": f"({rows},{buf.shape[1]}) rows of {S3_CHUNK} B -> "
                     f"({rows},32) digests"}
        if rows == S3_CLIENTS:
            # the plain version at the path's batch: ~1.9 M small launches
            t = time.perf_counter()
            plain = sha.hash_rows_plain(m_t, n_t)
            torch.cuda.synchronize()
            out[rows]["plain_ms"] = (time.perf_counter() - t) * 1e3
            got = sha.hash_rows(m_t, n_t)
            check(torch.equal(got, plain),
                  f"S2 != plain torch at {rows} rows of {S3_CHUNK} B")
    res["sha256_rows"] = out[S3_CLIENTS]
    res["sha256_rows[256]"] = out[BATCH]
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
# S3 phase: a port-composed erasure(10,4) cluster behind the S3 front end
# ---------------------------------------------------------------------------


class PortCluster:
    """`n` port Garage nodes in this process on the port's loopback
    transport (net/local.py), one storage role each, one zone."""

    def __init__(self, root: str, n: int, rf: int, erasure: tuple,
                 block_size: int, device):
        from garage_tpu_torch.net import LocalNetwork

        self.root, self.n, self.rf = root, n, rf
        self.erasure, self.block_size, self.device = erasure, block_size, device
        self.net = LocalNetwork()
        self.garages: list = []
        self.tasks: list = []
        self.alive: list = []

    def _config(self, i: int):
        from garage_tpu_torch.utils.config import Config, DataDir, QosConfig

        d = os.path.join(self.root, f"node{i:02d}")
        return Config(metadata_dir=os.path.join(d, "meta"),
                      data_dir=[DataDir(path=os.path.join(d, "data"))],
                      db_engine="memory", replication_factor=self.rf,
                      erasure_coding="%d,%d" % self.erasure,
                      block_size=self.block_size,
                      # reads measure the store path: no RAM block
                      # caches, node-local or cluster-wide
                      block_read_cache_max_bytes=0,
                      block_cache_packed_max_bytes=0,
                      block_cache_tier=False,
                      qos=QosConfig(governor=False))

    async def start(self) -> None:
        from garage_tpu_torch.model.garage import Garage
        from garage_tpu_torch.rpc.layout import NodeRole

        for i in range(self.n):
            g = Garage(self._config(i), local_net=self.net,
                       status_interval=1.0, ping_interval=2.0,
                       device=self.device)
            self.garages.append(g)
            self.tasks.append(asyncio.create_task(g.run()))
            self.alive.append(True)
        g0 = self.garages[0]
        for g in self.garages[1:]:
            await g.netapp.try_connect(g0.netapp.public_addr, g0.system.id)
            g.system.peering.add_peer(g0.netapp.public_addr, g0.system.id)
        await self._wait(lambda: all(len(g.netapp.conns) == self.n - 1
                                     for g in self.garages), 60, "mesh")
        lm = g0.system.layout_manager
        for g in self.garages:
            lm.history.stage_role(g.system.id,
                                  NodeRole(zone="dc1", capacity=1 << 40))
        lm.apply_staged(None)
        await self._wait(lambda: all(
            g.system.layout_manager.history.current().version == 1
            for g in self.garages), 60, "layout v1")

    async def _wait(self, cond, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            check(time.monotonic() < deadline, f"cluster: timeout ({what})")
            await asyncio.sleep(0.05)

    async def stop_node(self, i: int) -> None:
        """A node goes away: its transport first, then its Garage."""
        g = self.garages[i]
        self.alive[i] = False
        self.net.nodes.pop(g.system.id, None)
        await g.netapp.shutdown()
        await g.stop()
        self.tasks[i].cancel()
        await asyncio.gather(self.tasks[i], return_exceptions=True)

    async def stop(self) -> None:
        live = [i for i in range(self.n) if self.alive[i]]
        for i in live:
            await self.garages[i].netapp.shutdown()
        for i in live:
            await self.garages[i].stop()
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)


def device_busy(prof, path: str) -> dict:
    """Device time in a profiler window, from its trace: the union of
    the card's kernel, copy and memset intervals (busy_s), their sums by
    kind, and kernel seconds by name."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")]
    os.unlink(path)
    busy, end = 0.0, float("-inf")
    by_cat: dict = {}
    by_kernel: dict = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_cat[e["cat"]] = by_cat.get(e["cat"], 0.0) + float(e["dur"]) / 1e6
        if e["cat"] == "kernel":
            name = e["name"].split("(")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + float(e["dur"]) / 1e6
    return {"events": len(events), "busy_s": busy / 1e6, "by_cat": by_cat,
            "by_kernel": by_kernel}


async def s3_phase(data: np.ndarray, root: str, dev, *, nodes: int = 14,
                   rf: int = S3_RF, erasure: tuple = (K, M),
                   block_size: int = BLOCK, n_objects: int = S3_OBJECTS,
                   obj_size: int = S3_OBJ_SIZE, chunk: int = S3_CHUNK,
                   n_unsigned: int = S3_UNSIGNED, n_degraded: int = 16,
                   clients: int = S3_CLIENTS) -> dict:
    """PUT `n_objects` objects as signed aws-chunked bodies, `clients`
    more the same way under the profiler, and `n_unsigned` more with
    UNSIGNED-PAYLOAD through node 0's S3 front end, GET all of them back, stop m nodes and GET `n_degraded` again;
    every body and ETag is checked. -> rates and counters."""
    import concurrent.futures
    import socket

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from s3util import S3Client

    from garage_tpu_torch.admin.rpc import AdminRpcHandler
    from garage_tpu_torch.api.s3.api_server import S3ApiServer

    check(len(data) >= (n_objects + n_unsigned) * obj_size,
          "s3 phase: not enough seeded data")
    objs = [data[i * obj_size:(i + 1) * obj_size]
            for i in range(n_objects + n_unsigned)]
    # the profiled window's objects: the first ones rotated by a byte,
    # so that none of their blocks is stored already
    traced = range(len(objs), len(objs) + clients)
    objs += [np.roll(objs[i], 1) for i in range(clients)]
    etags = [hashlib.md5(o).hexdigest() for o in objs]
    cluster = PortCluster(root, nodes, rf, erasure, block_size, dev)
    out = {}
    loop = asyncio.get_running_loop()
    pool = concurrent.futures.ThreadPoolExecutor(clients)
    s3 = None
    try:
        t0 = time.perf_counter()
        await cluster.start()
        g0 = cluster.garages[0]
        admin = AdminRpcHandler(g0)
        key = await admin.op_key_new({"name": "chip-smoke"})
        await admin.op_key_allow({"key": key["key_id"],
                                  "create_bucket": True})
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        s3 = S3ApiServer(g0)
        await s3.start("127.0.0.1", port)
        client = S3Client("127.0.0.1", port, key["key_id"],
                          key["secret_key"])
        st, _, body = await loop.run_in_executor(
            pool, lambda: client.request("PUT", "/smoke"))
        check(st == 200, f"CreateBucket: {st} {body[:200]!r}")
        out["boot_s"] = time.perf_counter() - t0

        def put_signed(i: int) -> None:
            o = objs[i]
            chunks = [o[j:j + chunk].tobytes()
                      for j in range(0, len(o), chunk)]
            st, hdr, body = client.put_chunked(f"/smoke/o{i:04d}", chunks)
            check(st == 200, f"signed PUT o{i}: {st} {body[:300]!r}")
            check(hdr.get("etag", "").strip('"') == etags[i],
                  f"ETag of o{i}: {hdr.get('etag')} != {etags[i]}")

        def put_unsigned(i: int) -> None:
            st, hdr, body = client.request(
                "PUT", f"/smoke/o{i:04d}", body=objs[i].tobytes(),
                unsigned_payload=True, timeout=120)
            check(st == 200, f"unsigned PUT o{i}: {st} {body[:300]!r}")
            check(hdr.get("etag", "").strip('"') == etags[i],
                  f"ETag of o{i}: {hdr.get('etag')} != {etags[i]}")

        def get(i: int) -> None:
            st, hdr, body = client.request("GET", f"/smoke/o{i:04d}",
                                           timeout=120)
            check(st == 200, f"GET o{i}: {st} {body[:300]!r}")
            check(body == objs[i].tobytes(), f"GET o{i}: bytes differ")
            check(hdr.get("etag", "").strip('"') == etags[i],
                  f"GET o{i}: ETag {hdr.get('etag')} != {etags[i]}")

        async def run(fn, idx) -> float:
            t = time.perf_counter()
            await asyncio.gather(*(loop.run_in_executor(pool, fn, i)
                                   for i in idx))
            return time.perf_counter() - t

        feeder = g0.block_manager.feeder
        out["put_s"] = await run(put_signed, range(n_objects))
        out["pipeline_signed"] = feeder.pipeline_stats()
        sha_items = out["pipeline_signed"]["op_items"].get("sha256", 0)
        # a steady window under the profiler: each client PUTs one more
        # object, signed
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out["put_traced_s"] = await run(put_signed, traced)
        out["busy_traced"] = device_busy(prof, os.path.join(root, "trace"))
        out["put_unsigned_s"] = await run(
            put_unsigned, range(n_objects, n_objects + n_unsigned))
        out["get_s"] = await run(get, range(len(objs)))
        # m nodes go away (never node 0, which serves S3): every block
        # now misses the shards they held
        down = list(range(nodes - erasure[1], nodes))
        for i in down:
            await cluster.stop_node(i)
        dec0 = feeder.stats["decode_device_items"]
        out["get_degraded_s"] = await run(get, range(n_degraded))
        out["degraded_decodes"] = feeder.stats["decode_device_items"] - dec0
        out["sha256_items"] = sha_items
        out["chunks_sent"] = n_objects * (-(-obj_size // chunk))
        out["stats"] = dict(feeder.stats)
        out["pipeline"] = feeder.pipeline_stats()
        out["fallbacks_all_nodes"] = sum(
            g.block_manager.feeder.stats["device_fallbacks"]
            for g in cluster.garages)
        out["bytes"] = {"put": n_objects * obj_size,
                        "put_unsigned": n_unsigned * obj_size,
                        "put_traced": clients * obj_size,
                        "get": len(objs) * obj_size,
                        "get_degraded": n_degraded * obj_size}
        return out
    finally:
        if s3 is not None:
            await s3.stop()
        await cluster.stop()
        pool.shutdown(wait=True)


def max_sm_clock_hz() -> float:
    """The card's top SM clock, as nvidia-smi reports it (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    check(bool(out) and out[0].isdigit(),
          f"nvidia-smi clocks.max.sm printed {out!r}")
    print(f"max SM clock {out[0]} MHz (nvidia-smi clocks.max.sm)")
    return int(out[0]) * 1e6


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
    data = np.frombuffer(bytearray(rng.bytes(max(
        N_BLOCKS * BLOCK, (S3_OBJECTS + S3_UNSIGNED) * S3_OBJ_SIZE))),
        dtype=np.uint8)

    dev = torch.device("cuda", 0)
    kres = kernel_phase(torch, data, rng, dev, max_sm_clock_hz())
    for name, r in kres.items():
        print(f"kernel {name} {r['shape']}: ok, {r['ms']:.4f} ms "
              f"({r['gbps']:.1f} GB/s), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})"
              + (f", plain {r['plain_ms']:.2f} ms" if "plain_ms" in r
                 else "")
              + (f", serial floor {r['serial_ms']:.4f} ms, all-lanes "
                 f"{r['ops'] / LANE_OPS_PER_S * 1e3:.5f} ms, host hashlib "
                 f"{r['hashlib_ms']:.3f} ms" if "serial_ms" in r else ""))

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # each path runs with every launch count set to 0 just before it
        reset_launches()
        rates = asyncio.run(main_path(data, os.path.join(root, "block"),
                                      rng, dev))
        launches = kernel_launches()
        reset_launches()
        s3 = asyncio.run(s3_phase(data, os.path.join(root, "s3"), dev))
        s3_launches = kernel_launches()
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
    print(f"launches on the block path: {json.dumps(launches)}")
    check(stats["device_fallbacks"] == 0, "device fallbacks on the main path")
    check(stats["device_items"] == stats["items"],
          "a main-path request did not run on the device")
    check(stats["device_items"] > 0 and stats["decode_device_items"] > 0,
          "the main path did not reach the device")
    for name in ("gf_apply", "gf_check", "blake3_rows"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the block path")

    b = s3["bytes"]
    print(f"S3 phase: 14-node erasure(10,4) port cluster booted in "
          f"{s3['boot_s']:.2f} s; {S3_CLIENTS} client threads")
    print(f"S3 PUT signed aws-chunked ({S3_OBJECTS} x {S3_OBJ_SIZE >> 20} "
          f"MiB, {S3_CHUNK >> 10} KiB chunks): "
          f"{b['put'] / s3['put_s'] / 1e9:.3f} GB/s ({s3['put_s']:.2f} s)")
    bt = s3["busy_traced"]
    if bt["events"]:
        print(f"S3 signed PUT, profiled window ({S3_CLIENTS} x "
              f"{S3_OBJ_SIZE >> 20} MiB more): {s3['put_traced_s']:.2f} s "
              f"({b['put_traced'] / s3['put_traced_s'] / 1e9:.3f} GB/s), "
              f"device busy {bt['busy_s']:.3f} s (idle share "
              f"{1 - bt['busy_s'] / s3['put_traced_s']:.4f}); by kind "
              f"{json.dumps(bt['by_cat'])}; kernels "
              f"{json.dumps(bt['by_kernel'])}")
    else:
        print(f"S3 signed PUT, profiled window: {s3['put_traced_s']:.2f} s, "
              f"device busy not measured (the profiler recorded no device "
              f"events)")
    print(f"S3 PUT UNSIGNED-PAYLOAD ({S3_UNSIGNED} x {S3_OBJ_SIZE >> 20} "
          f"MiB): {b['put_unsigned'] / s3['put_unsigned_s'] / 1e9:.3f} GB/s "
          f"({s3['put_unsigned_s']:.2f} s)")
    print(f"S3 GET all {b['get'] // S3_OBJ_SIZE}: "
          f"{b['get'] / s3['get_s'] / 1e9:.3f} GB/s ({s3['get_s']:.2f} s), "
          f"bytes and MD5 ETags equal")
    print(f"S3 GET degraded (4 nodes down, 16 objects): "
          f"{b['get_degraded'] / s3['get_degraded_s'] / 1e9:.3f} GB/s "
          f"({s3['get_degraded_s']:.2f} s), {s3['degraded_decodes']} "
          f"device decodes, bytes and MD5 ETags equal")
    ratio = s3["sha256_items"] / s3["chunks_sent"]
    print(f"S3 sha256 device items {s3['sha256_items']} / signed chunks "
          f"sent {s3['chunks_sent']} = {ratio:.4f}")
    print("S3 node-0 feeder: device_items={device_items} items={items} "
          "batches={batches} max_batch={max_batch} decode_device_items="
          "{decode_device_items} device_fallbacks={device_fallbacks}"
          .format(**s3["stats"]))
    print(f"S3 pipeline after the signed PUT round: "
          f"{json.dumps(s3['pipeline_signed'])}")
    print(f"S3 pipeline at the end: {json.dumps(s3['pipeline'])}")
    print(f"launches on the S3 path: {json.dumps(s3_launches)}")
    check(s3["fallbacks_all_nodes"] == 0, "device fallbacks on the S3 path")
    check(s3["stats"]["device_items"] == s3["stats"]["items"],
          "an S3-path request did not run on the device")
    check(s3["sha256_items"] == s3["chunks_sent"],
          "a signed chunk that landed whole in a lease missed S2")
    check(s3["degraded_decodes"] > 0, "degraded GETs decoded nothing")
    for name in ("sha256_rows", "gf_apply", "blake3_rows"):
        check(s3_launches[name] > 0,
              f"kernel {name} was not launched on the S3 path")

    meta = {
        "gf_apply": ("garage_tpu_torch/csrc/gf256.cu",
                     "garage_tpu/ops/pallas_gf.py:32"),
        "gf_check": ("garage_tpu_torch/csrc/gf256.cu",
                     "garage_tpu/ops/rs.py:217"),
        "blake3_rows": ("garage_tpu_torch/csrc/blake3.cu",
                        "garage_tpu/ops/treehash.py:205"),
        "sha256_rows": ("garage_tpu_torch/csrc/sha256.cu",
                        "garage_tpu/ops/sha256.py:107"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = kres[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name] + s3_launches[name],
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
