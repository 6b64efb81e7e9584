#!/usr/bin/env python3
"""Chip smoke for garage_tpu_torch, the PyTorch/CUDA port, on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --kernel-phase-of DIR   # step 2 of DIR only

The second form builds the kernels of the checkout at DIR and runs its
own kernel phase (its chip_smoke.kernel_phase, seed and data), printing
each kernel's times as one JSON line: run it for two checkouts in turns
(A, B, B, A) in one call to compare their kernels on one card.

1. Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel).
2. Kernel phase: calls each kernel's wrapper on the card at the shapes
   the main paths give it — G1 gf_apply (RS(10,4) encode, decode and
   repair with mixed erasure patterns), G2 gf_check, B3 blake3_rows, S2
   sha256_rows (33 ragged rows of 1-1,025 blocks, SHA padding edges up
   to 8 KiB, and 8 and 256 rows of a 64 KiB chunk) — and holds the
   result byte for byte against its plain torch version on the same
   inputs and against the native C oracles (S2 against hashlib); times
   each with CUDA events (median of 20 eager launches, and per launch
   of 20 replayed in a CUDA graph: the device time without the host's
   launch gap) beside its bound, and fails if a kernel reads faster
   than its bound. S2's and B3's bounds include their dependent chains,
   timed on the card in the run (clock64, one thread); G1's and G2's
   tile and grid and B3's CTAs at each timed shape are printed beside
   its time. G2 also checks wide codes (erasure(1,17), (51,16) and
   (240,16)) with planted corruptions against its plain version.
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
3b. Router phase, with the launch counts set to 0 again: a
   DeviceFeeder(mode="auto") on cuda:0 (its mode and its backend,
   TorchDeviceBackend, checked) calibrates the host route and the
   device route (B3, G1 encode and decode launched), prints its MB/s
   per op and route, then runs the block path above at full width: the
   content hashes, the BLAKE3 of every block's 14 framed shards and the
   ETags equal the "require" run's, each op's items on each route and
   the trials are printed, 0 fallbacks. A mode="off" feeder runs the
   first quarter the same way: byte-equal and 0 launches. Last, the S3
   phase's deployment (14 nodes) built with `[tpu] enable = false` on
   cuda:0 answers a signed aws-chunked PUT of 16 MiB and its GET with 0
   launches.
4. S3 path, with the launch counts set to 0 again: 14 port Garage nodes
   on cuda:0 in this process (erasure(10,4), 1 MiB blocks, loopback
   transport); node 0 serves S3, the admin HTTP API, K2V and the web
   front end on loopback TCP ports. Through the admin API: the key, the
   bucket, its permissions and website access, and
   `feeder_inflight_batches` set to 2, read back and restored to 3,
   the routing floor `feeder_device_min_bytes` likewise. 8 client threads
   (tests/s3util.py, an independent stdlib signer) PUT 64 objects of
   16 MiB as STREAMING-AWS4-HMAC-SHA256-PAYLOAD in 64 KiB chunks, 8
   more the same way under torch.profiler (the device's busy time and
   idle share in that window, from the trace); then /metrics must read
   at least the feeder's own counters and 0 fallbacks. 16 more objects
   go in with UNSIGNED-PAYLOAD; all are read back through S3, 16
   through the web front end; the K2V round (64 items inserted, read,
   batch-read, half overwritten in a batch, a quarter deleted, one
   poll) checks every value; 4 nodes stop, and 16 objects are read
   degraded through S3 and through the web front end (G1 decodes
   counted). Every body and MD5 ETag is checked, and every signed
   chunk of the first round must have reached S2.
   Then a feeder built from `[tpu] batch_blocks = 8, batch_linger_ms =
   0` hashes 32 concurrent 1 MiB blocks on the card in batches of at
   most 8.
4b. Durability phase, with the launch counts set to 0 again: the S3
   phase's deployment (14 port nodes, erasure(10,4), 1 MiB blocks, no
   RAM or tier caches) takes 1 GiB (1,024 blocks from the seed) through
   node 0's BlockManager.rpc_put_block from 8 concurrent writers, each
   block referenced on every node. Planted: 8 forged shards (2 on
   parity rows), 2 wrong-length shards, 2 rotted packed_len headers, a
   forged data + parity pair in one block, and a disk_bitrot fault on
   one stripe leader's read. A deep scrub runs through every node's
   admin RPC (`worker set scrub-tranquility 0`, `repair scrub start`)
   until every node's scrub-last-completed advances: the summed
   block_scrub_* counters of /metrics must equal the plant, each
   repaired stripe re-encoded through the feeder (G1), G2 launched, and
   every block read back. Then node 13 stops and loses its data
   directory, a layout puts a fresh node 14 in its role, and `repair
   blocks` runs on every node with resync-tranquility 0: node 14's
   shards, rebuilt by the resync workers through feeder.repair (G1),
   must equal a host re-encode (native oracle and numpy RS), every
   queue and error tree must empty, every block read back, and no node
   fall back to the host.
5. Grid phase (parallel/mesh.py), with the launch counts set to 0 again:
   the put, scrub and repair steps on 16 RS(10,4) stripes of 105,472 B
   a shard (a 1 MiB block's shard rounded up to BLAKE3's chunk), at dp =
   1 and on the grid [cuda:0, cuda:0] at (dp, tp) = (2, 1) and (1, 2):
   every output byte-equal to the plain composition on the card (held
   against the host RS oracle and the native BLAKE3), one planted
   corruption flagged by the scrub step, each step's launches and wall
   ms printed; then a feeder on that grid (dp = 2, `mesh_min_items` 8)
   encodes, parity-checks, decodes and repairs 16 blocks through the
   grid route, byte-equal to the one-device route.
6. Gateway phase: the S3 phase's deployment as 14 processes of
   `python -m garage_tpu_torch.cli.server --device cuda`; node 0 runs
   the admin API and 4 gateway worker processes on the card, through
   which 8 client threads PUT 16 x 16 MiB signed (64 KiB aws-chunks)
   and 16 unsigned, and GET all back byte for byte; one worker is
   SIGKILLed a quarter into a round of 16 more PUTs: every request must
   succeed within the client's retries, the worker come back ready and
   the lease conservation gauge read 1 throughout; every live worker's
   feeder must show device items and no fallback (node 0's /metrics,
   worker-labelled), and the kernels must have launched in the workers.
   The card's free memory is read before and after the boot.
7. Prints the card (nvidia-smi name and power limit), the build time,
   per-kernel launches / ms / GB/s, the paths' rates and the feeders'
   counters, B3's launches by batch size on each path, the front ends'
   line (web and degraded web GET GB/s, K2V operations/s, admin request
   latency, with the card's name and power limit), a
   `{"kernels": [...]}` line, and last
   `{"ok": true, "device": {...}}`.

Any mismatch, a kernel with no launch on its path, or a host fallback
exits non-zero without the last line; so does a machine without CUDA,
or a directory without the garage_tpu_torch package.
"""

from __future__ import annotations

import asyncio
import hashlib
import inspect
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
# S2's chain floor: a message's blocks are compressed in sequence, and
# each of a block's 64 rounds is at least 3 dependent instructions
# through `e` (rotate -> LOP3 -> IADD3; 6, 11 and 25 are not byte
# rotations, so no shorter chain exists on sm_90). The cycles of that
# 3-instruction chain are measured in the run (sha256.chain_cycles: one
# thread, clock64), so a message takes at least blocks x 64 x those
# cycles at the card's top SM clock (nvidia-smi clocks.max.sm)
S2_CHAIN_INSTRUCTIONS = 3
# B3's chain floor: a row's digest needs 16 + ceil(log2 C) compressions
# in series (a chunk's 16 blocks, then one parent per tree level), each
# 7 rounds of 2 G steps in series (columns, then diagonals); the cycles
# of one G step's dependent chain (4 add -> xor -> rotate triples) are
# measured in the run (treehash.chain_cycles: one thread, clock64)
B3_G_STEPS_PER_COMPRESSION = 14


def b3_chain_ms(c: int, g_cycles: float, sm_hz: float) -> float:
    depth = 16 + max(0, (c - 1).bit_length())
    return depth * B3_G_STEPS_PER_COMPRESSION * g_cycles / sm_hz * 1e3
# G1's product runs on the tensor cores: dense int8 at 1,979 TOP/s
# (data sheet); per byte position it multiplies 8k input bits into 8
# output bits of two rows at once (bits 0 and 7 of each sum), 2 x 8k x 8
# x ceil(r / 2) operations
INT8_OPS_PER_S = 1979e12


def g1_ops(b: int, s: int, k: int, r: int) -> int:
    return 2 * b * s * 8 * k * 8 * -(-r // 2)


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
# node 0's other front ends: the admin HTTP API (its bearer token), the
# web front end (website buckets under this root domain; objects read
# through it healthy and then degraded) and K2V (items written, read,
# batch-read, deleted and polled)
ADMIN_TOKEN = "chip-smoke-admin-token"
WEB_ROOT = ".web.smoke"
S3_WEB = 16
K2V_ITEMS = 64
# durability phase: the S3 phase's deployment holding N_BLOCKS blocks of
# BLOCK bytes (1 GiB), written by N_OBJECTS writers; every wait of the
# phase ends at DUR_TIMEOUT seconds
DUR_NODES = 14
DUR_TIMEOUT = 600.0
# grid phase: the split steps (parallel/mesh.py) on RS(10,4) stripes of
# 1 MiB blocks; a shard is 104,864 B, rounded up to BLAKE3's 1,024-byte
# chunk, as the put, scrub and repair steps need
GRID_B = 16
GRID_S = 103 * 1024
GRID_REPAIR = ((0, 1, 2, 4, 5, 6, 8, 9, 10, 12), (3, 7, 11, 13))
# gateway phase: the S3 phase's deployment as 14 node processes, node 0
# with this many gateway worker processes on the same card
GW_WORKERS = 4
GW_SIGNED = 16
GW_UNSIGNED = 16
GW_KILL_ROUND = 16
GW_TOP_UP = 4 << 20  # objects of the rounds that reach every worker


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


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call with the host out of the way: `reps` calls
    captured in one CUDA graph, the median of 5 replays over `reps`."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def kernel_times(torch, fn) -> dict:
    """ms: one eager call from the host, as the paths make it (CUDA
    events, median of 20; at small shapes it holds the wrapper's host
    time too); device_ms: the same call replayed in a CUDA graph."""
    return {"ms": time_ms(torch, fn), "device_ms": graph_ms(torch, fn)}


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
    plan = dict(gf_kernel.last_plan)  # the tile and grid it launched with
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
        **kernel_times(torch, lambda: gf_kernel.gf_apply(pmat, x)),
        "plain_ms": time_ms(torch, lambda: gf_kernel.gf_apply_plain(pmat, x),
                            reps=5, warmup=1),
        "bytes": (K + M) * s * BATCH + M * K,
        "ops": g1_ops(BATCH, s, K, M), "ops_per_s": INT8_OPS_PER_S,
        "plan": plan,
        "shape": f"encode ({BATCH},{K},{s})->({BATCH},{M},{s})"}
    # the PUT path's own batches are as wide as the concurrent objects
    xp = x[:PUT_BATCH]
    check(torch.equal(gf_kernel.gf_apply(pmat, xp),
                      gf_kernel.gf_apply_plain(pmat, xp)),
          f"G1 encode != plain torch at batch {PUT_BATCH}")
    plan = dict(gf_kernel.last_plan)
    res["gf_apply[put]"] = {
        "err": 0, **kernel_times(torch, lambda: gf_kernel.gf_apply(pmat, xp)),
        "bytes": (K + M) * s * PUT_BATCH + M * K,
        "ops": g1_ops(PUT_BATCH, s, K, M),
        "ops_per_s": INT8_OPS_PER_S,
        "plan": plan,
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
    plan = dict(gf_kernel.last_check_plan)
    res["gf_check"] = {
        "err": 0,
        **kernel_times(torch, lambda: gf_kernel.gf_check(pmat, stripes)),
        "plain_ms": time_ms(torch, lambda: gf_kernel.gf_check_plain(
            pmat, stripes), reps=5, warmup=1),
        # the syndrome's int8 products: 2 x 8(k + m) x 8 x ceil(m / 2)
        # operations per byte position, below the bytes
        "bytes": (K + M) * s * BATCH + 4 * BATCH + M * K,
        "ops": g1_ops(BATCH, s, K + M, M), "ops_per_s": INT8_OPS_PER_S,
        "plan": plan,
        "shape": f"({BATCH},{K + M},{s}) -> ({BATCH},) flags"}
    del stripes, out
    res["gf_check"]["wide"] = g2_wide_codes(torch, rng, dev)

    # G1, decode and repair: per-item matrices, mixed erasure patterns
    pats = patterns(rng, 16)
    for op, rows in (("decode", K), ("repair", M)):
        mats_np = np.stack([
            rs.decode_matrix(K, M, p) if op == "decode"
            else rs.repair_matrix(K, M, p, e)
            for p, e in (pats[i % len(pats)] for i in range(BATCH))])
        mats = torch.from_numpy(mats_np).to(dev)
        got = gf_kernel.gf_apply(mats, x)
        plan = dict(gf_kernel.last_plan)
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
            **kernel_times(torch, lambda: gf_kernel.gf_apply(mats, x)),
            "plain_ms": time_ms(torch, lambda: gf_kernel.gf_apply_plain(
                mats, x), reps=5, warmup=1),
            "bytes": (K + rows) * s * BATCH + rows * K * BATCH,
            "ops": g1_ops(BATCH, s, K, rows),
            "ops_per_s": INT8_OPS_PER_S,
            "plan": plan,
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
                    [3 * 1024 + 1, 4096], [BLOCK - 1, BLOCK], [BLOCK],
                    [33 * 1024 - 5]):
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
    g_cycles = treehash.chain_cycles(dev)
    treehash.hash_rows(msgs, lens)
    plan = dict(treehash.last_plan)
    res["blake3_rows"] = {
        "err": err,
        **kernel_times(torch, lambda: treehash.hash_rows(msgs, lens)),
        "chain_cycles_per_g": g_cycles,
        "chain_ms": b3_chain_ms(BLOCK // 1024, g_cycles, sm_hz),
        "plan": plan,
        "plain_ms": time_ms(torch, lambda: treehash.hash_rows_plain(
            msgs, lens), reps=5, warmup=1),
        "bytes": BATCH * BLOCK + 4 * BATCH + 32 * BATCH,
        "ops": compressions * B3_OPS_PER_COMPRESSION,
        "shape": f"({BATCH},{BLOCK}) rows -> ({BATCH},32) digests"}
    mp, lp = msgs[:PUT_BATCH], lens[:PUT_BATCH]
    check(torch.equal(treehash.hash_rows(mp, lp), plain[:PUT_BATCH]),
          f"B3 != plain torch at batch {PUT_BATCH}")
    plan = dict(treehash.last_plan)
    res["blake3_rows[put]"] = {
        "err": 0, **kernel_times(torch, lambda: treehash.hash_rows(mp, lp)),
        "chain_cycles_per_g": g_cycles,
        "chain_ms": b3_chain_ms(BLOCK // 1024, g_cycles, sm_hz),
        "plan": plan,
        "bytes": PUT_BATCH * (BLOCK + 36),
        "ops": compressions // BATCH * PUT_BATCH * B3_OPS_PER_COMPRESSION,
        "shape": f"({PUT_BATCH},{BLOCK}) rows -> ({PUT_BATCH},32) digests"}
    del msgs, plain, got
    torch.cuda.empty_cache()
    res.update(sha256_kernel(torch, data, dev, sm_hz))
    for r in res.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        # all lanes (or G1: the int8 tensor cores) of the card, or (S2)
        # one message's dependent chain
        rate = r.get("ops_per_s", LANE_OPS_PER_S)
        r["ops_ms"] = r.get("ops", 0) / rate * 1e3
        t_ops = max(r["ops_ms"], r.get("chain_ms", 0.0))
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["gbps"] = r["bytes"] / (r["device_ms"] * 1e-3) / 1e9
    return res


def g2_wide_codes(torch, rng, dev) -> dict:
    """G2 on codes past 16 parity rows or k x m > 800 (a few launches over
    groups of syndrome rows): 10 stripes each, 8 with one flipped byte
    (in the first and last data and parity rows, and random ones; at the
    first byte, the last, or one of the last 16) and 2 intact; exactly
    the planted stripes are flagged, as by the plain version."""
    from garage_tpu_torch import native
    from garage_tpu_torch.ops import gf_kernel, rs

    out = {}
    s = 4096 + 32
    for k, m in ((1, 17), (51, 16), (240, 16)):
        n = k + m
        data = rng.integers(0, 256, (10, k, s), dtype=np.uint8)
        pmat = rs.parity_matrix(k, m)
        st = np.concatenate([data, np.stack([native.gf_matmul(pmat, d)
                                             for d in data])], axis=1)
        rows = [0, k - 1, k, n - 1] + [int(i) for i in rng.integers(0, n, 4)]
        for i, row in enumerate(rows):
            pos = [0, s - 1, s - 1 - int(rng.integers(1, 16))][i % 3]
            st[i, row, pos] ^= 1 << int(rng.integers(8))
        st_t = torch.from_numpy(st).to(dev)
        before = gf_kernel.launches["gf_check"]
        ok = rs.parity_check(k, m, st_t)
        launches = gf_kernel.launches["gf_check"] - before
        check(ok.cpu().tolist() == [False] * 8 + [True] * 2,
              f"G2 ({k},{m}) flagged {(~ok).nonzero().flatten().tolist()}, "
              f"planted 0-7")
        mats = torch.from_numpy(pmat[None].copy()).to(dev)
        check(torch.equal(ok, gf_kernel.gf_check_plain(mats, st_t)),
              f"G2 ({k},{m}) != plain torch")
        out[f"{k},{m}"] = {"launches": launches, "rows_per_launch":
                           gf_kernel.g2_plan(10, k, m, s, dev)[0]}
    return out


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
    # rows of 1, 2, 17 and 1,025 blocks in one launch of 33 rows: two
    # CTAs, lanes that finish at different blocks
    lens = [(0, 64, 1024, S3_CHUNK)[i % 4] + i % 3 for i in range(33)]
    msgs = [data[i * 5003:i * 5003 + n].tobytes() for i, n in enumerate(lens)]
    buf, nbs = sha_rows(sha, msgs)
    got_np = sha.hash_rows(torch.from_numpy(buf).to(dev),
                           torch.from_numpy(nbs).to(dev)).cpu().numpy()
    check(all(got_np[i].tobytes() == hashlib.sha256(m).digest()
              for i, m in enumerate(msgs)),
          "S2 != hashlib on ragged rows of 1-1,025 blocks")
    chain = sha.chain_cycles(dev)
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
            **kernel_times(torch, lambda: sha.hash_rows(m_t, n_t)),
            "bytes": buf.size + 4 * rows + 32 * rows,
            "ops": comp * S2_OPS_PER_COMPRESSION,
            "chain_cycles_per_round": chain,
            "dep_latency_cycles": chain / S2_CHAIN_INSTRUCTIONS,
            "chain_ms": int(nbs.max()) * 64 * chain / sm_hz * 1e3,
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


async def main_path(data: np.ndarray, root: str, rng, dev, feeder=None,
                    n_blocks: int = N_BLOCKS) -> dict:
    """PUT, degraded GET, scrub and repair of the first `n_blocks` blocks
    of `data` through `feeder` (default: a "require" feeder on `dev`),
    which is stopped at the end. -> rates, the feeder's counters, and
    per block its content hash and the BLAKE3 of its 14 framed shards
    (the outputs two feeders are held equal on)."""
    from garage_tpu_torch import native
    from garage_tpu_torch.block.codec import ErasureCodec
    from garage_tpu_torch.block.feeder import DeviceFeeder
    from garage_tpu_torch.block.manager import unpack_shard

    if feeder is None:
        feeder = DeviceFeeder(codec=ErasureCodec(K, M, device=dev),
                              mode="require", max_batch=BATCH, device=dev)
    nodes = [os.path.join(root, f"node{j:02d}") for j in range(K + M)]
    for d in nodes:
        os.makedirs(d)
    blocks = [data[i * BLOCK:(i + 1) * BLOCK].tobytes()
              for i in range(n_blocks)]
    hashes: list = [None] * n_blocks
    shard_digests: list = [None] * n_blocks
    per_obj = n_blocks // N_OBJECTS
    rates = {}

    def write_shards(i: int, parts) -> None:
        for j, part in enumerate(parts):
            with open(os.path.join(nodes[j], f"{i:05d}"), "wb") as f:
                f.write(part)
        shard_digests[i] = native.blake3(b"".join(bytes(p) for p in parts))

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
        rates["etags"] = etags

        # degraded GET: 4 shards erased, pattern per block
        pats = patterns(rng, 32)
        pat_of = [pats[i % len(pats)] for i in range(n_blocks)]
        t0 = time.perf_counter()
        for w in range(0, n_blocks, BATCH):
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
        bad_block, bad_shard = int(rng.integers(n_blocks)), int(rng.integers(K))
        t0 = time.perf_counter()
        flagged_hash, flagged_parity = [], []
        for w in range(0, n_blocks, BATCH):
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
        for w in range(0, n_blocks, BATCH):
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
        rates["hashes"], rates["shard_digests"] = hashes, shard_digests
        return rates
    finally:
        await feeder.stop()


# ---------------------------------------------------------------------------
# Router phase: the feeder's "auto" and "off" modes, and a host-only node
# ---------------------------------------------------------------------------


def route_split(stats: dict, pipeline: dict) -> dict:
    """Items by op on each route, the trials and the fallbacks."""
    ops = sorted(set(pipeline["op_items"]) | set(pipeline["op_host_items"]))
    return {"ops": {op: {"device": pipeline["op_items"].get(op, 0),
                         "host": pipeline["op_host_items"].get(op, 0)}
                    for op in ops},
            "inline_items": stats["inline_items"], "trials": stats["trials"],
            "device_fallbacks": stats["device_fallbacks"]}


async def router_phase(data: np.ndarray, root: str, rng, dev,
                       ref: dict) -> dict:
    """An "auto" feeder on `dev` (calibrated first) through the block
    path at full width, then an "off" feeder through its first quarter,
    each held byte for byte against `ref` (the "require" run) and the
    native oracles; "off" must launch nothing. -> rates, routes and the
    launches of each part."""
    import torch

    from garage_tpu_torch.block.codec import ErasureCodec
    from garage_tpu_torch.block.device_backend import TorchDeviceBackend
    from garage_tpu_torch.block.feeder import DeviceFeeder
    from garage_tpu_torch.ops import kernel_launches, reset_launches

    out = {}
    feeder = DeviceFeeder(codec=ErasureCodec(K, M, device=dev), mode="auto",
                          max_batch=BATCH, device=dev)
    check(feeder.mode == "auto", f"the auto feeder runs {feeder.mode!r} "
          f"(GARAGE_TPU_DEVICE={os.environ.get('GARAGE_TPU_DEVICE')!r})")
    backend = feeder._get_backend()
    check(type(backend) is TorchDeviceBackend,
          f"the auto feeder's backend is {type(backend).__name__}")
    t0 = time.perf_counter()
    await feeder.ready()
    out["calibration_s"] = time.perf_counter() - t0
    out["calibration_launches"] = kernel_launches()
    out["calibration"] = feeder.perf_summary()
    cal = out["calibration_launches"]
    # (only CUDA launches count: a CPU rehearsal skips this gate)
    check(torch.device(dev).type != "cuda"
          or (cal["blake3_rows"] >= 1 and cal["gf_apply"] >= 2),
          f"calibration's device legs did not launch B3 and G1 (encode "
          f"and decode): {cal}")
    n_blocks = len(ref["hashes"])
    auto = await main_path(data, os.path.join(root, "auto"), rng, dev,
                           feeder=feeder, n_blocks=n_blocks)
    out["auto"], out["auto_launches"] = auto, kernel_launches()
    out["auto_route"] = route_split(auto["stats"], auto["pipeline"])
    out["rates_after"] = feeder.perf_summary()
    for key in ("hashes", "shard_digests", "etags"):
        check(auto[key] == ref[key],
              f"auto feeder: {key} differ from the require run")
    check(auto["stats"]["device_fallbacks"] == 0,
          "device fallbacks in the auto feeder")

    reset_launches()
    quarter = n_blocks // 4
    off = DeviceFeeder(codec=ErasureCodec(K, M, device=dev), mode="off",
                       max_batch=BATCH, device=dev)
    res = await main_path(data, os.path.join(root, "off"), rng, dev,
                          feeder=off, n_blocks=quarter)
    out["off"], out["off_launches"] = res, kernel_launches()
    for key in ("hashes", "shard_digests"):
        check(res[key] == ref[key][:quarter],
              f"off feeder: {key} differ from the require run")
    check(sum(out["off_launches"].values()) == 0,
          f"the off feeder launched kernels: {out['off_launches']}")
    check(res["stats"]["device_items"] == 0 and off._backend is None,
          "the off feeder reached the device")
    return out


async def host_node_phase(data: np.ndarray, root: str, dev) -> dict:
    """The S3 phase's deployment (14 port nodes, erasure(10,4), 1 MiB
    blocks) with `[tpu] enable = false` on `dev`: one signed aws-chunked
    PUT of 16 MiB and its GET through node 0's S3 front end, checked by
    bytes and MD5 ETag. -> timings and every node's feeder mode."""
    import concurrent.futures

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from s3util import S3Client

    from garage_tpu_torch.admin.http import AdminHttpServer
    from garage_tpu_torch.admin.rpc import AdminRpcHandler
    from garage_tpu_torch.api.s3.api_server import S3ApiServer

    obj = data[:S3_OBJ_SIZE].tobytes()
    cluster = PortCluster(root, 14, S3_RF, (K, M), BLOCK, dev,
                          tpu_enable=False)
    loop = asyncio.get_running_loop()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    servers, out = [], {}
    try:
        await cluster.start()
        g0 = cluster.garages[0]
        g0.config.admin_token = ADMIN_TOKEN
        s3 = S3ApiServer(g0)
        for srv in (s3, AdminHttpServer(g0, admin_rpc=AdminRpcHandler(g0))):
            await srv.start("127.0.0.1", 0)
            servers.append(srv)
        port, admin_port = (srv.http.bound_port for srv in servers)
        feeder = g0.block_manager.feeder
        key = await loop.run_in_executor(pool, admin_setup,
                                         AdminApi(admin_port), feeder)
        client = S3Client("127.0.0.1", port, *key)
        chunks = [obj[j:j + S3_CHUNK] for j in range(0, len(obj), S3_CHUNK)]
        t0 = time.perf_counter()
        st, hdr, body = await loop.run_in_executor(
            pool, client.put_chunked, "/smoke/host-only", chunks)
        out["put_s"] = time.perf_counter() - t0
        check(st == 200, f"host-only node PUT: {st} {body[:300]!r}")
        check(hdr.get("etag", "").strip('"') == hashlib.md5(obj).hexdigest(),
              f"host-only node ETag {hdr.get('etag')}")
        t0 = time.perf_counter()
        st, _hdr, body = await loop.run_in_executor(
            pool, lambda: client.request("GET", "/smoke/host-only",
                                         timeout=120))
        out["get_s"] = time.perf_counter() - t0
        check(st == 200 and body == obj, f"host-only node GET: {st}")
        out["modes"] = sorted({g.block_manager.feeder.mode
                               for g in cluster.garages})
        out["stats"] = dict(feeder.stats)
        check(out["modes"] == ["off"], f"feeder modes {out['modes']}")
        check(all(g.block_manager.feeder._backend is None
                  for g in cluster.garages),
              "a host-only node built a device backend")
        out["chunks"] = len(chunks)
        return out
    finally:
        for srv in servers:
            await srv.stop()
        await cluster.stop()
        pool.shutdown()


# ---------------------------------------------------------------------------
# S3 phase: a port-composed erasure(10,4) cluster behind the S3 front end
# ---------------------------------------------------------------------------


class PortCluster:
    """`n` port Garage nodes in this process on the port's loopback
    transport (net/local.py), one storage role each, one zone."""

    def __init__(self, root: str, n: int, rf: int, erasure: tuple,
                 block_size: int, device, tpu_enable: bool = True):
        from garage_tpu_torch.net import LocalNetwork

        self.root, self.n, self.rf = root, n, rf
        self.tpu_enable = tpu_enable
        self.erasure, self.block_size, self.device = erasure, block_size, device
        self.net = LocalNetwork()
        self.garages: list = []
        self.tasks: list = []
        self.alive: list = []

    def _config(self, i: int):
        from garage_tpu_torch.utils.config import (Config, DataDir, QosConfig,
                                                   TpuConfig)

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
                      qos=QosConfig(governor=False),
                      tpu=TpuConfig(enable=self.tpu_enable))

    def _boot(self) -> None:
        from garage_tpu_torch.model.garage import Garage

        g = Garage(self._config(len(self.garages)), local_net=self.net,
                   status_interval=1.0, ping_interval=2.0,
                   device=self.device)
        self.garages.append(g)
        self.tasks.append(asyncio.create_task(g.run()))
        self.alive.append(True)

    async def _mesh(self) -> None:
        g0 = self.garages[0]
        live = [g for g, up in zip(self.garages, self.alive) if up]
        for g in live[1:]:
            if g0.system.id not in g.netapp.conns:
                await g.netapp.try_connect(g0.netapp.public_addr,
                                           g0.system.id)
                g.system.peering.add_peer(g0.netapp.public_addr,
                                          g0.system.id)
        await self._wait(lambda: all(len(g.netapp.conns) >= len(live) - 1
                                     for g in live), 60, "mesh")

    async def add_node(self):
        """One more node, joined to the live ones (no layout role yet)
        -> its Garage."""
        self._boot()
        await self._mesh()
        return self.garages[-1]

    async def start(self) -> None:
        from garage_tpu_torch.rpc.layout import NodeRole

        for _ in range(self.n):
            self._boot()
        g0 = self.garages[0]
        await self._mesh()
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
        live = [i for i, up in enumerate(self.alive) if up]
        for i in live:
            await self.garages[i].netapp.shutdown()
        for i in live:
            await self.garages[i].stop()
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)


# ---------------------------------------------------------------------------
# Durability phase: deep scrub and a node replacement on the S3 phase's
# deployment
# ---------------------------------------------------------------------------


def time_calls(obj, name: str, acc: dict) -> None:
    """Wrap obj.name, a coroutine function or a plain one, so that each
    call adds its wall seconds, one call and, if it raised, one raise to
    acc[name] = [seconds, calls, raises]."""
    fn, cell = getattr(obj, name), acc.setdefault(name, [0.0, 0, 0])

    def note(t: float, ok: bool) -> None:
        cell[0] += time.perf_counter() - t
        cell[1] += 1
        cell[2] += not ok
    if inspect.iscoroutinefunction(fn):
        async def timed(*a, **kw):
            t, ok = time.perf_counter(), False
            try:
                got = await fn(*a, **kw)
                ok = True
                return got
            finally:
                note(t, ok)
    else:
        def timed(*a, **kw):
            t, ok = time.perf_counter(), False
            try:
                got = fn(*a, **kw)
                ok = True
                return got
            finally:
                note(t, ok)
    setattr(obj, name, timed)


def durability_plant() -> list[tuple[int, tuple, str]]:
    """What the durability phase plants, by block index: (block, parts,
    how). 8 forged shards (valid header checksum, wrong payload), the
    last 2 on parity rows; 2 shards of the right framing and the wrong
    length; 2 rotted packed_len headers over the right payload; one
    block with a forged data and a forged parity shard; and a disk_bitrot
    fault on the stripe leader's read of one more block."""
    out = [(b, (b,), "forge") for b in range(6)]
    out += [(6 + j, (K + j,), "forge") for j in range(2)]
    out += [(8, (3,), "length"), (9, (1,), "length")]
    out += [(10, (2,), "header"), (11, (K + 1,), "header")]
    out += [(12, (2, K + 1), "forge"), (13, (0,), "bitrot")]
    return out


async def durability_phase(data: np.ndarray, root: str, dev) -> dict:
    """N_BLOCKS blocks from `data` through node 0's
    BlockManager.rpc_put_block by N_OBJECTS concurrent writers, each
    referenced on every node of a DUR_NODES-node erasure(K, M) cluster;
    durability_plant's faults planted; a deep scrub driven through every
    node's admin RPC (`worker set scrub-tranquility 0`, `repair scrub
    start`) until every node's scrub-last-completed advances, held
    against the plant and read back; then the last node stops and loses
    its data directory, a layout replaces its role by a fresh node in
    the same zone, and `repair blocks` runs on every node with
    `resync-tranquility 0` until every resync queue is empty: the new
    node's shards must equal a host re-encode and every block must read
    back. -> rates, counters and the rebuild's time split."""
    from garage_tpu_torch import chaos, native
    from garage_tpu_torch.admin.http import AdminHttpServer
    from garage_tpu_torch.block.block import DataBlock
    from garage_tpu_torch.block.codec import shard_nodes_of
    from garage_tpu_torch.block.manager import pack_shard, unpack_shard
    from garage_tpu_torch.ops import gf256, kernel_launches, rs

    width = K + M
    plant = durability_plant()
    blocks = [data[b * BLOCK:(b + 1) * BLOCK].tobytes()
              for b in range(N_BLOCKS)]
    cluster = PortCluster(root, DUR_NODES, S3_RF, (K, M), BLOCK, dev)
    rng = np.random.default_rng(SEED + 7)
    out = {}
    try:
        await cluster.start()
        g0 = cluster.garages[0]
        bm0 = g0.block_manager
        admins = [AdminHttpServer(g) for g in cluster.garages]

        async def admin(i: int, op: str, **kw):
            return await admins[i].rpc._handle(None, {"op": op, **kw}, None)

        def launches_since(before: dict) -> dict:
            now = kernel_launches()
            return {n: now[n] - before.get(n, 0) for n in now
                    if now[n] != before.get(n, 0)}

        def op_items(op: str) -> int:
            return sum(g.block_manager.feeder.pipeline_stats()["op_items"]
                       .get(op, 0) for g, up in zip(cluster.garages,
                                                    cluster.alive) if up)

        def incref_all(g) -> None:
            bm = g.block_manager
            bm.db.transaction(lambda tx: [bm.rc.block_incref(tx, h)
                                          for h in hashes])

        # -- data ---------------------------------------------------------
        hashes: list = [None] * N_BLOCKS

        async def writer(w: int) -> None:
            for b in range(w, N_BLOCKS, N_OBJECTS):
                h = await bm0.hash_block(blocks[b])
                await bm0.rpc_put_block(h, blocks[b])
                hashes[b] = h

        t0 = time.perf_counter()
        await asyncio.gather(*(writer(w) for w in range(N_OBJECTS)))
        out["put_s"] = time.perf_counter() - t0
        for g in cluster.garages:
            incref_all(g)
        by_id = {g.system.id: g.block_manager for g in cluster.garages}
        layout = g0.system.layout_helper.current()
        placements = [shard_nodes_of(layout, h, width) for h in hashes]

        def all_stored() -> bool:
            return all(i in by_id[p[i]].local_parts(h)
                       for h, p in zip(hashes, placements)
                       for i in range(width))
        deadline = time.monotonic() + DUR_TIMEOUT
        while not await asyncio.to_thread(all_stored):
            check(time.monotonic() < deadline,
                  "durability: not every shard was stored")
            await asyncio.sleep(0.2)

        # -- the plant ----------------------------------------------------
        bitrot = None
        for b, parts, how in plant:
            h, holders = hashes[b], placements[b]
            if how == "bitrot":
                bitrot = (holders[0], h)
                continue
            for part in parts:
                bm = by_id[holders[part]]
                payload, plen = unpack_shard(bm.read_local_shard(h, part))
                if how == "forge":
                    payload = (bytes(x ^ 0xA5 for x in payload[:128])
                               + payload[128:])
                elif how == "length":
                    payload, plen = rng.bytes(len(payload) + 512), 999_999
                else:
                    plen = 999_999
                bm.write_local_shard(h, part, pack_shard(payload, plen))
        want = {"corruptions": sum(how != "header" for _, _, how in plant),
                "deep_repaired": sum(how in ("forge", "length")
                                     for _, _, how in plant),
                "header_repaired": sum(how == "header"
                                       for _, _, how in plant)}
        ctl = chaos.arm(seed=SEED)
        rot = ctl.add(chaos.FaultSpec(kind="disk_bitrot",
                                      node=bitrot[0].hex()[:8],
                                      hash_prefix=bitrot[1].hex()[:8],
                                      count=1))

        # -- deep scrub, as an operator drives it -------------------------
        decodes = [0]
        decode_np = rs.decode_np

        def counted_decode(*a, **kw):
            decodes[0] += 1
            return decode_np(*a, **kw)
        rs.decode_np = counted_decode
        l0 = kernel_launches()
        checks0, encodes0 = op_items("parity_check"), op_items("encode_put")
        repairs0 = op_items("repair")
        try:
            last = []
            for i in range(DUR_NODES):
                r = await admin(i, "worker_set", name="scrub-tranquility",
                                value="0")
                check(float(r["value"]) == 0,
                      f"scrub-tranquility on node {i}: {r}")
                last.append(float((await admin(
                    i, "worker_get", name="scrub-last-completed"))
                    ["vars"]["scrub-last-completed"]))
            t_start = time.time()
            for i in range(DUR_NODES):
                await admin(i, "repair", what="scrub", cmd="start")
            done = [None] * DUR_NODES
            while None in done:
                check(time.monotonic() < deadline + DUR_TIMEOUT,
                      "durability: a node's scrub pass did not complete")
                for i in range(DUR_NODES):
                    if done[i] is None:
                        v = float((await admin(
                            i, "worker_get", name="scrub-last-completed"))
                            ["vars"]["scrub-last-completed"])
                        if v > last[i]:
                            done[i] = v
                await asyncio.sleep(0.1)
            out["scrub_s"] = max(done) - t_start
        finally:
            rs.decode_np = decode_np
            chaos.disarm()
        out["scrub_launches"] = launches_since(l0)
        out["stripes_checked"] = op_items("parity_check") - checks0
        out["repair_encodes"] = op_items("encode_put") - encodes0
        out["host_decodes"] = decodes[0]
        out["bitrot_fired"] = rot.fired
        scrub = dict.fromkeys(("block_scrub_corruptions",
                               "block_scrub_deep_stripes_checked",
                               "block_scrub_deep_stripes_repaired",
                               "block_scrub_header_repaired"), 0)
        for adm in admins:
            got = gauges(adm.render_metrics())
            for key in scrub:
                scrub[key] += int(got[key])
        out["scrub"] = scrub
        check(rot.fired == 1, "durability: the disk_bitrot never fired")
        check(scrub["block_scrub_corruptions"] == want["corruptions"]
              and scrub["block_scrub_deep_stripes_repaired"]
              == want["deep_repaired"]
              and scrub["block_scrub_header_repaired"]
              == want["header_repaired"],
              f"durability: scrub counters {scrub} != the plant {want}")
        check(out["scrub_launches"].get("gf_check", 0) > 0,
              "durability: G2 never launched in the scrub")
        check(out["repair_encodes"] == want["deep_repaired"],
              f"durability: {out['repair_encodes']} re-encodes through the "
              f"feeder for {want['deep_repaired']} repaired stripes")
        check(out["scrub_launches"].get("gf_apply", 0) > 0,
              "durability: G1 never launched in the scrub's repairs")

        def resync_busy() -> list:
            """-> the live nodes whose resync has work queued or running,
            each noted in busy_at with the time it was last seen so."""
            now, busy = time.perf_counter(), []
            for i, g in enumerate(cluster.garages):
                q = g.block_manager.resync
                if cluster.alive[i] and (q.queue_len() or q._in_flight):
                    busy_at[i] = now
                    busy.append(i)
            return busy
        busy_at: dict = {}

        async def wait_resync(what: str) -> float:
            t = time.perf_counter()
            while resync_busy():
                check(time.monotonic() < deadline + 2 * DUR_TIMEOUT,
                      f"durability: resync queues never drained ({what})")
                await asyncio.sleep(0.05)
            errors = {i: g.block_manager.resync.errors_len()
                      for i, g in enumerate(cluster.garages)
                      if cluster.alive[i]
                      and g.block_manager.resync.errors_len()}
            check(not errors, f"durability: resync errors ({what}) {errors}")
            return time.perf_counter() - t

        await wait_resync("after the scrub")
        out["scrub_resync_repairs"] = op_items("repair") - repairs0

        async def read_all(what: str) -> float:
            t = time.perf_counter()
            sem = asyncio.Semaphore(N_OBJECTS)

            async def one(b: int) -> None:
                async with sem:
                    got = await bm0.rpc_get_block(hashes[b])
                check(got == blocks[b],
                      f"durability: block {b} differs ({what})")
            await asyncio.gather(*(one(b) for b in range(N_BLOCKS)))
            return time.perf_counter() - t

        out["read_after_scrub_s"] = await read_all("after the scrub")

        # -- node replacement ---------------------------------------------
        gone = DUR_NODES - 1
        gone_id = cluster.garages[gone].system.id
        await cluster.stop_node(gone)
        shutil.rmtree(os.path.join(root, f"node{gone:02d}", "data"))
        fresh = await cluster.add_node()
        admins.append(AdminHttpServer(fresh))
        incref_all(fresh)
        new = len(cluster.garages) - 1
        # the rebuild's time split, node by node: a block's resync, the
        # probe of every other node for the wanted shard, the gather of
        # K shards, the feeder's batched repair (G1) and the shard write
        split = {}
        for i, g in enumerate(cluster.garages):
            if cluster.alive[i]:
                bm, acc = g.block_manager, split.setdefault(i, {})
                time_calls(bm.resync, "resync_block", acc)
                time_calls(bm.resync, "_fetch_shard", acc)
                time_calls(bm, "_gather_parts", acc)
                time_calls(bm.feeder, "repair", acc)
                time_calls(bm, "write_local_shard", acc)
        busy_at.clear()
        l0 = kernel_launches()
        repairs0 = op_items("repair")
        t0 = time.perf_counter()
        await admin(0, "layout_remove", node=gone_id)
        await admin(0, "layout_assign", node=fresh.system.id, zone="dc1",
                    capacity=1 << 40)
        v = (await admin(0, "layout_apply"))["version"]
        live = [i for i, up in enumerate(cluster.alive) if up]
        await cluster._wait(lambda: all(
            cluster.garages[i].system.layout_helper.current().version == v
            for i in live), 60, f"layout v{v}")
        for i in live:
            r = await admin(i, "worker_set", name="resync-tranquility",
                            value="0")
            check(float(r["value"]) == 0,
                  f"resync-tranquility on node {i}: {r}")
            await admin(i, "repair", what="blocks")
        layout = g0.system.layout_helper.current()
        fm = fresh.block_manager
        assigned = [(b, shard_nodes_of(layout, h, width))
                    for b, h in enumerate(hashes)]
        assigned = [(b, p.index(fresh.system.id)) for b, p in assigned
                    if fresh.system.id in p]

        def rebuilt() -> bool:
            return all(i in fm.local_parts(hashes[b]) for b, i in assigned)
        # a rebuild that fails waits out the resync error backoff: the
        # wait below, and replace_s, include it
        while not await asyncio.to_thread(rebuilt):
            check(time.monotonic() < deadline + 2 * DUR_TIMEOUT,
                  "durability: the new node's shards were never rebuilt")
            resync_busy()
            await asyncio.sleep(0.5)
        await wait_resync("after the node replacement")
        out["replace_s"] = time.perf_counter() - t0
        out["busy_s"] = {i: at - t0 for i, at in busy_at.items()}
        out["split"] = {i: {name: list(cell) for name, cell in acc.items()}
                        for i, acc in split.items()}
        out["replace_launches"] = launches_since(l0)
        out["rebuild_items"] = op_items("repair") - repairs0

        # node `new` holds every shard the new placement gives it, each
        # equal to a host re-encode (the native oracle, and the numpy RS
        # for the row)
        pmat = rs.parity_matrix(K, M)

        def held_against_host() -> int:
            nbytes = 0
            for b, h in enumerate(hashes):
                check(gone_id not in shard_nodes_of(layout, h, width),
                      "durability: the old node still placed")
            for b, i in assigned:
                raw = fm.read_local_shard(hashes[b], i)
                check(raw is not None,
                      f"durability: block {b} shard {i} missing on the new "
                      f"node")
                blk = DataBlock.compress(blocks[b])
                want_raw = native.rs_encode_packed(
                    blk.bytes, K, M, pmat, prefix=bytes([blk.compression]))[i]
                stripe = rs.split_stripe(blk.pack(), K)
                row = (stripe[i] if i < K
                       else gf256.gf_matmul(pmat[i - K:i - K + 1],
                                            stripe)[0])
                payload, _ = unpack_shard(raw)
                check(bytes(raw) == bytes(want_raw)
                      and payload == row.tobytes(),
                      f"durability: block {b} shard {i} on the new node != "
                      f"the host re-encode")
                nbytes += len(raw)
            return nbytes
        out["rebuilt_bytes"] = await asyncio.to_thread(held_against_host)
        check(out["rebuilt_bytes"] > 0, "durability: nothing rebuilt")
        check(out["replace_launches"].get("gf_apply", 0) > 0,
              "durability: G1 never launched in the rebuild")
        out["read_after_replace_s"] = await read_all(
            "after the node replacement")
        out["fallbacks"] = {
            i: g.block_manager.feeder.stats["device_fallbacks"]
            for i, g in enumerate(cluster.garages)}
        check(not any(out["fallbacks"].values()),
              f"durability: device fallbacks {out['fallbacks']}")
        out["nodes"] = len(live)
        out["new_node"] = new
        return out
    finally:
        await cluster.stop()


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


class AdminApi:
    """Blocking client of node 0's admin HTTP API (run in a client
    thread); keeps each request's latency."""

    def __init__(self, port: int):
        self.port = port
        self.ms: list[float] = []

    def call(self, method: str, path: str, body=None) -> tuple:
        import http.client

        t = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=60)
        try:
            conn.request(method, path, body=b"" if body is None
                         else json.dumps(body).encode(),
                         headers={"authorization": f"Bearer {ADMIN_TOKEN}"})
            r = conn.getresponse()
            raw = r.read()
        finally:
            conn.close()
        self.ms.append((time.perf_counter() - t) * 1e3)
        try:
            return r.status, json.loads(raw.decode())
        except ValueError:
            return r.status, raw


def admin_setup(api: AdminApi, feeder) -> tuple[str, str]:
    """The smoke key and bucket (with website access) through the admin
    HTTP API, and /v1/s3/tuning's `feeder_inflight_batches` set to 2,
    read back, and restored to 3, and the routing floor
    `feeder_device_min_bytes` set to 1 MiB, read back and restored,
    before the timed rounds. -> (key id, secret)."""
    st, k = api.call("POST", "/v1/key", {"name": "chip-smoke"})
    check(st == 200 and k["accessKeyId"].startswith("GK"),
          f"admin POST /v1/key: {st} {k!r}")
    st, b = api.call("POST", "/v1/bucket", {"globalAlias": "smoke"})
    check(st == 200 and "id" in b, f"admin POST /v1/bucket: {st} {b!r}")
    st, r = api.call("POST", "/v1/bucket/allow", {
        "bucketId": b["id"], "accessKeyId": k["accessKeyId"],
        "permissions": {"read": True, "write": True, "owner": True}})
    check(st == 200, f"admin POST /v1/bucket/allow: {st} {r!r}")
    st, r = api.call("PUT", f"/v1/bucket?id={b['id']}", {
        "websiteAccess": {"enabled": True, "indexDocument": "index.html"}})
    check(st == 200 and r["websiteAccess"] is True,
          f"admin PUT /v1/bucket (website): {st} {r!r}")
    for depth in (2, 3):
        st, r = api.call("POST", "/v1/s3/tuning",
                         {"feeder_inflight_batches": depth})
        check(st == 200 and r["feeder_inflight_batches"] == depth
              and feeder.inflight_batches == depth,
              f"tuning feeder_inflight_batches={depth}: {st} {r!r}")
        st, r = api.call("GET", "/v1/s3/tuning")
        check(st == 200 and r["feeder_inflight_batches"] == depth,
              f"tuning read back: {st} {r!r}")
    floor = feeder.device_min_bytes
    for v in (1 << 20, floor):
        st, r = api.call("POST", "/v1/s3/tuning",
                         {"feeder_device_min_bytes": v})
        check(st == 200 and r["feeder_device_min_bytes"] == v
              and feeder.device_min_bytes == v,
              f"tuning feeder_device_min_bytes={v}: {st} {r!r}")
        st, r = api.call("GET", "/v1/s3/tuning")
        check(st == 200 and r["feeder_device_min_bytes"] == v,
              f"routing floor read back: {st} {r!r}")
    return k["accessKeyId"], k["secretAccessKey"]


def gauges(text: str) -> dict:
    """The unlabelled samples of a Prometheus exposition."""
    out = {}
    for ln in text.splitlines():
        parts = ln.split()
        if len(parts) == 2 and not ln.startswith("#") and "{" not in ln:
            out[parts[0]] = float(parts[1])
    return out


def k2v_round(port: int, key: tuple, n: int) -> dict:
    """n items through node 0's K2V API with the port's client: insert,
    read back, batch-read, overwrite half in one batch, delete a
    quarter with their causality tokens, and a poll that a second
    client's write wakes; every value is checked. -> ops and seconds."""
    import base64
    import threading

    from garage_tpu_torch.k2v_client import K2vClient

    c = K2vClient("127.0.0.1", port, "smoke", *key)
    pk = "smoke-pk"
    vals = {f"sk{i:04d}": f"value {i} ".encode() * (1 + i % 7)
            for i in range(n)}
    ops = 0
    t = time.perf_counter()
    for sk, v in vals.items():
        c.insert_item(pk, sk, v)
    ops += n
    toks = {}
    for sk, v in vals.items():
        r = c.read_item(pk, sk)
        check(r.values == [v], f"K2V read {sk}: {r.values!r}")
        toks[sk] = r.causality
    ops += n
    keys = sorted(vals)
    half = keys[: n // 2]
    c.insert_batch([(pk, sk, b"batch " + sk.encode(), toks[sk])
                    for sk in half])
    ops += 1
    for sk in half:
        vals[sk] = b"batch " + sk.encode()
    got = c.read_batch([{"partitionKey": pk}])[0]
    ops += 1
    check([(it["sk"], [base64.b64decode(v) for v in it["v"]])
           for it in got["items"]] == [(sk, [vals[sk]]) for sk in keys],
          "K2V batch read: values differ")
    gone = keys[n // 2: n // 2 + n // 4]
    for sk in gone:
        c.delete_item(pk, sk, toks[sk])
    ops += len(gone)
    for sk in gone:
        check(c.read_item(pk, sk).values == [None],
              f"K2V {sk} not deleted")
    ops += len(gone)
    last = keys[-1]

    def write_later() -> None:
        time.sleep(0.2)
        K2vClient("127.0.0.1", port, "smoke", *key).insert_item(
            pk, last, b"polled", causality=toks[last])

    th = threading.Thread(target=write_later)
    th.start()
    r = c.poll_item(pk, last, toks[last], timeout=30)
    th.join()
    ops += 2
    check(r is not None and r.values == [b"polled"],
          f"K2V poll: {r!r}")
    return {"ops": ops, "s": time.perf_counter() - t}


def web_get(port: int, i: int) -> bytes:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", f"/o{i:04d}", headers={"host": "smoke" + WEB_ROOT})
        r = conn.getresponse()
        body = r.read()
    finally:
        conn.close()
    check(r.status == 200, f"web GET o{i}: {r.status} {body[:300]!r}")
    return body


async def s3_phase(data: np.ndarray, root: str, dev, *, nodes: int = 14,
                   rf: int = S3_RF, erasure: tuple = (K, M),
                   block_size: int = BLOCK, n_objects: int = S3_OBJECTS,
                   obj_size: int = S3_OBJ_SIZE, chunk: int = S3_CHUNK,
                   n_unsigned: int = S3_UNSIGNED, n_degraded: int = 16,
                   clients: int = S3_CLIENTS, n_web: int = S3_WEB,
                   k2v_items: int = K2V_ITEMS) -> dict:
    """Node 0 serves S3, the admin HTTP API, K2V and the web front end.
    The key and bucket come from the admin API, which also sets and
    reads back the feeder's in-flight depth. PUT `n_objects` objects as
    signed aws-chunked bodies, `clients` more the same way under the
    profiler (then /metrics is held against the feeder's stats), and
    `n_unsigned` more with UNSIGNED-PAYLOAD through node 0's S3 front
    end, GET all of them back and `n_web` through the web front end, run
    the K2V round, stop m nodes and GET `n_degraded` again through S3
    and `n_web` through the web front end; every body and ETag is
    checked. -> rates and counters."""
    import concurrent.futures

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from s3util import S3Client

    from garage_tpu_torch.admin.http import AdminHttpServer
    from garage_tpu_torch.admin.rpc import AdminRpcHandler
    from garage_tpu_torch.api.k2v.api_server import K2VApiServer
    from garage_tpu_torch.api.s3.api_server import S3ApiServer
    from garage_tpu_torch.ops import kernel_launches
    from garage_tpu_torch.web.server import WebServer

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
    servers = []
    try:
        t0 = time.perf_counter()
        await cluster.start()
        g0 = cluster.garages[0]
        g0.config.admin_token = ADMIN_TOKEN
        s3 = S3ApiServer(g0)
        for srv in (s3, AdminHttpServer(g0, admin_rpc=AdminRpcHandler(g0)),
                    K2VApiServer(g0), WebServer(g0, s3, root_domain=WEB_ROOT)):
            await srv.start("127.0.0.1", 0)
            servers.append(srv)
        port, admin_port, k2v_port, web_port = (
            srv.http.bound_port for srv in servers)
        feeder = g0.block_manager.feeder
        api = AdminApi(admin_port)
        key = await loop.run_in_executor(pool, admin_setup, api, feeder)
        client = S3Client("127.0.0.1", port, *key)
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
        # /metrics after the signed rounds: at least the feeder's own
        # counters taken just before the scrape
        snap = dict(feeder.stats)
        st, text = await loop.run_in_executor(
            pool, api.call, "GET", "/metrics")
        check(st == 200, f"admin GET /metrics: {st}")
        m = gauges(text.decode() if isinstance(text, bytes) else str(text))
        for name in ("device_items", "batches"):
            check(m.get(f"feeder_{name}", -1) >= snap[name] > 0,
                  f"/metrics feeder_{name} {m.get(f'feeder_{name}')} "
                  f"below the feeder's {snap[name]}")
        check(m.get("feeder_device_fallbacks") == 0,
              f"/metrics feeder_device_fallbacks "
              f"{m.get('feeder_device_fallbacks')}")
        out["metrics"] = {k: m[k] for k in (
            "feeder_device_items", "feeder_batches",
            "feeder_device_fallbacks")}
        out["metrics_snapshot"] = {k: snap[k] for k in (
            "device_items", "batches", "device_fallbacks")}
        out["put_unsigned_s"] = await run(
            put_unsigned, range(n_objects, n_objects + n_unsigned))
        out["get_s"] = await run(get, range(len(objs)))

        def get_web(i: int) -> None:
            check(web_get(web_port, i) == objs[i].tobytes(),
                  f"web GET o{i}: bytes differ")

        def launches_during(before: dict) -> dict:
            now = kernel_launches()
            return {k: now[k] - before.get(k, 0) for k in now
                    if now[k] != before.get(k, 0)}

        l0 = kernel_launches()
        out["web_get_s"] = await run(get_web, range(n_web))
        out["web_launches"] = launches_during(l0)
        out["k2v"] = await loop.run_in_executor(
            pool, k2v_round, k2v_port, key, k2v_items)
        # m nodes go away (never node 0, which serves the front ends):
        # every block now misses the shards they held
        down = list(range(nodes - erasure[1], nodes))
        for i in down:
            await cluster.stop_node(i)
        dec0 = feeder.stats["decode_device_items"]
        out["get_degraded_s"] = await run(get, range(n_degraded))
        out["degraded_decodes"] = feeder.stats["decode_device_items"] - dec0
        dec0, l0 = feeder.stats["decode_device_items"], kernel_launches()
        out["web_degraded_s"] = await run(get_web, range(n_web))
        out["web_degraded_decodes"] = (feeder.stats["decode_device_items"]
                                       - dec0)
        out["web_degraded_launches"] = launches_during(l0)
        out["admin_ms"] = list(api.ms)
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
                        "get_degraded": n_degraded * obj_size,
                        "web": n_web * obj_size}
        return out
    finally:
        for srv in servers:
            await srv.stop()
        await cluster.stop()
        pool.shutdown(wait=True)


async def tpu_knob_check(data: np.ndarray, dev, n: int = 32) -> dict:
    """A feeder built from `[tpu] batch_blocks = 8, batch_linger_ms = 0`
    (as a node's BlockManager builds it) takes `n` concurrent hash_md5
    items of 1 MiB on the card and never ships a batch wider than 8;
    every digest and MD5 is checked. -> its stats."""
    from garage_tpu_torch import native
    from garage_tpu_torch.block.feeder import DeviceFeeder
    from garage_tpu_torch.utils.config import TpuConfig

    # what read_config makes of a [tpu] section with these two keys
    tpu = TpuConfig(**{"batch_blocks": 8, "batch_linger_ms": 0})
    feeder = DeviceFeeder(max_batch=tpu.batch_blocks, device=dev,
                          tpu_cfg=tpu)
    check(feeder.max_batch == 8 and feeder.batch_linger == 0,
          "[tpu] knobs not read")
    blocks = [data[i * BLOCK:(i + 1) * BLOCK].tobytes() for i in range(n)]
    md5s = [native.Md5() for _ in blocks]
    feeder.active_streams = n
    try:
        digests = await asyncio.gather(*(
            feeder.hash_with_md5(b, m) for b, m in zip(blocks, md5s)))
    finally:
        await feeder.stop()
    check(digests == [native.blake3(b) for b in blocks],
          "[tpu] check: content hashes differ")
    check([m.hexdigest() for m in md5s]
          == [hashlib.md5(b).hexdigest() for b in blocks],
          "[tpu] check: MD5s differ")
    st = feeder.stats
    check(st["device_items"] == n and 0 < st["max_batch"] <= 8,
          f"[tpu] batch_blocks = 8: device_items {st['device_items']}, "
          f"widest batch {st['max_batch']}")
    return dict(st)


# ---------------------------------------------------------------------------
# Grid phase: the split data-plane steps on a grid of repeated devices
# ---------------------------------------------------------------------------


def grid_reference(torch, data: np.ndarray, dev) -> dict:
    """The grid phase's inputs and what every step must give, from the
    plain torch composition on the card (G1's and B3's plain versions)
    held against the host RS oracle and the native BLAKE3."""
    from garage_tpu_torch import native
    from garage_tpu_torch.ops import gf_kernel, rs, treehash

    n = K + M
    host = data[:GRID_B * K * GRID_S].reshape(GRID_B, K, GRID_S)
    x = torch.from_numpy(host.copy()).to(dev)
    pmat = torch.from_numpy(rs.parity_matrix(K, M).copy()).reshape(
        1, M, K).to(dev)
    parity = gf_kernel.gf_apply_plain(pmat, x)
    allsh = torch.cat([x, parity], dim=1)
    lens = torch.full((GRID_B * n,), GRID_S, dtype=torch.int32, device=dev)
    hashes = treehash.hash_rows_plain(
        allsh.reshape(GRID_B * n, GRID_S), lens).reshape(GRID_B, n, 32)
    par_np, hashes_np = parity.cpu().numpy(), hashes.cpu().numpy()
    check(all(np.array_equal(par_np[i], rs.encode_np(K, M, host[i]))
              for i in range(GRID_B)), "grid: plain parity != host RS")
    shards_np = np.concatenate([host, par_np], axis=1)
    want = native.blake3_many([shards_np[i, j].tobytes()
                               for i in range(GRID_B) for j in range(n)])
    check([bytes(r) for r in hashes_np.reshape(-1, 32)] == want,
          "grid: plain BLAKE3 != native BLAKE3")
    return {"x": x, "shards": allsh, "parity": parity, "hashes": hashes}


def grid_steps(torch, ref: dict, dev) -> dict:
    """The put, scrub and repair steps at dp = 1, then on the grid
    [dev, dev] at (dp, tp) = (2, 1) and (1, 2), B = GRID_B stripes of
    GRID_S bytes a shard: every output byte-equal to the plain
    composition (ref), one planted corruption flagged by the scrub step.
    -> per grid and step: kernel launches of one call and its wall ms
    (median of 5 calls, synchronised)."""
    from garage_tpu_torch.ops import kernel_launches
    from garage_tpu_torch.parallel import mesh as pmesh

    present, missing = GRID_REPAIR
    x, shards, hashes = ref["x"], ref["shards"], ref["hashes"]

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    bad = shards.clone()
    bad[3, 2, 777] ^= 1
    out = {}
    for name, devs, tp in (("dp=1", [dev], 1), ("dp=2,tp=1", [dev, dev], 1),
                           ("dp=1,tp=2", [dev, dev], 2)):
        grid = pmesh.data_plane_mesh(devices=devs, tp=tp)
        put = pmesh.make_put_step(grid, K, M, GRID_S)
        scrub = pmesh.make_scrub_step(grid, K, M, GRID_S)
        repair = pmesh.make_repair_step(grid, K, M, present, missing, GRID_S)
        steps = {"put": lambda: put(x),
                 "scrub": lambda: scrub(shards, hashes),
                 "scrub_planted": lambda: scrub(bad, hashes),
                 "repair": lambda: repair(shards[:, list(present)])}
        res = {}
        for step, fn in steps.items():
            before = kernel_launches()
            got = fn()
            sync()
            after = kernel_launches()
            walls = []
            for _ in range(5):
                t = time.perf_counter()
                fn()
                sync()
                walls.append((time.perf_counter() - t) * 1e3)
            res[step] = {"out": got, "ms": statistics.median(walls),
                         "launches": {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]}}
        parity, digests = res["put"]["out"]
        check(torch.equal(parity, ref["parity"]),
              f"grid {name}: put parity differs from the plain version")
        check(torch.equal(digests, hashes),
              f"grid {name}: put hashes differ from the plain version")
        mask, count = res["scrub"]["out"]
        check(int(count) == 0 and not bool(mask.any()),
              f"grid {name}: clean stripes flagged")
        mask, count = res["scrub_planted"]["out"]
        check(int(count) == 1 and bool(mask[3, 2])
              and int(mask.sum()) == 1,
              f"grid {name}: planted corruption not flagged alone")
        rebuilt, rhashes = res["repair"]["out"]
        check(torch.equal(rebuilt, shards[:, list(missing)]),
              f"grid {name}: repaired shards differ")
        check(torch.equal(rhashes, hashes[:, list(missing)]),
              f"grid {name}: repaired shards' hashes differ")
        out[name] = {step: {"ms": r["ms"], "launches": r["launches"]}
                     for step, r in res.items()}
    return out


async def grid_feeder(data: np.ndarray, dev, *, devices=None,
                      mesh_min_items: int = 8, n: int = GRID_B,
                      block: int = BLOCK, reference: dict | None = None
                      ) -> dict:
    """A DeviceFeeder with the grid `devices` (default [dev, dev], dp =
    2) and `[tpu] mesh_min_items`: n concurrent 1 MiB blocks encoded,
    their stripes parity-checked with one corrupt, decoded and repaired.
    With `reference` (this function's result on the one-device route)
    every result must equal it. -> results and the feeder's stats."""
    from garage_tpu_torch.block.codec import ErasureCodec
    from garage_tpu_torch.block.feeder import DeviceFeeder
    from garage_tpu_torch.parallel.mesh import data_plane_mesh
    from garage_tpu_torch.utils.config import TpuConfig

    grid = None
    if reference is not None:
        grid = data_plane_mesh(devices=devices or [dev, dev], tp=1)
    feeder = DeviceFeeder(codec=ErasureCodec(K, M, device=dev), device=dev,
                          max_batch=BATCH, grid=grid,
                          tpu_cfg=TpuConfig(mesh_min_items=mesh_min_items))
    blocks = [data[i * block:(i + 1) * block].tobytes() for i in range(n)]
    present, missing = GRID_REPAIR
    try:
        await feeder.encode(blocks[0][:1000])  # probes the device
        stripes = await asyncio.gather(*(feeder.encode(b) for b in blocks))
        bad = [list(st) for st in stripes]
        bad[5][K] = bytes([bad[5][K][0] ^ 1]) + bad[5][K][1:]
        checks = await feeder.parity_check(bad)
        decoded = await asyncio.gather(*(
            feeder.decode(present, [st[i] for i in present], len(b))
            for st, b in zip(stripes, blocks)))
        repaired = await asyncio.gather(*(
            feeder.repair(present, missing, [st[i] for i in present])
            for st in stripes))
    finally:
        await feeder.stop()
    res = {"stripes": stripes, "checks": checks, "decoded": decoded,
           "repaired": repaired}
    check(checks == [i != 5 for i in range(n)],
          f"grid feeder: parity verdicts {checks}")
    check(decoded == blocks, "grid feeder: decoded blocks differ")
    if reference is not None:
        for key in res:
            check(res[key] == reference[key],
                  f"grid feeder: {key} differ from the one-device route")
    res["stats"] = dict(feeder.stats)
    return res


# ---------------------------------------------------------------------------
# Gateway phase: the erasure deployment as node processes, node 0 with
# gateway workers on the card
# ---------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def node_config(d: str, rpc_port: int, rf: int, erasure: tuple,
                block_size: int, front: str = "") -> str:
    """garage.toml of one node of the gateway phase's cluster: memory
    metadata, no RAM block caches (as the S3 phase), `front` appended."""
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "garage.toml")
    with open(path, "w") as f:
        f.write(f"""metadata_dir = "{d}/meta"
data_dir = "{d}/data"
replication_factor = {rf}
erasure_coding = "{erasure[0]},{erasure[1]}"
block_size = {block_size}
rpc_bind_addr = "127.0.0.1:{rpc_port}"
rpc_public_addr = "127.0.0.1:{rpc_port}"

[metadata]
db_engine = "memory"

[block]
read_cache_max_bytes = 0
cache_packed_max_bytes = 0
cache_tier = false

[qos]
governor = false
{front}""")
    return path


def worker_gauges(text: str, name: str) -> dict:
    """{worker index: value} of a worker-labelled sample `name`."""
    import re

    out = {}
    for m in re.finditer(r'^%s\{(?:[^}]*,)?worker="(\d+)"\} (\S+)$'
                         % re.escape(name), text, re.M):
        out[int(m.group(1))] = float(m.group(2))
    return out


def kernel_gauges(text: str) -> dict:
    """{kernel: launches} summed over the gateway workers' samples."""
    import re

    out: dict = {}
    for m in re.finditer(r'^feeder_kernel_launches\{kernel="(\w+)",'
                         r'worker="\d+"\} (\S+)$', text, re.M):
        out[m.group(1)] = out.get(m.group(1), 0) + int(float(m.group(2)))
    return out


def gateway_phase(torch, data: np.ndarray, root: str, device: str = "cuda",
                  *, nodes: int = 14, rf: int = S3_RF,
                  erasure: tuple = (K, M), block_size: int = BLOCK,
                  workers: int = GW_WORKERS, n_signed: int = GW_SIGNED,
                  n_unsigned: int = GW_UNSIGNED,
                  n_kill: int = GW_KILL_ROUND, obj_size: int = S3_OBJ_SIZE,
                  top_up: int = GW_TOP_UP, chunk: int = S3_CHUNK,
                  clients: int = S3_CLIENTS, timeout: float = 120.0) -> dict:
    """`nodes` processes of `python -m garage_tpu_torch.cli.server
    --device <device>` on loopback TCP; node 0 serves S3 through
    `[gateway] workers` worker processes and the admin API, through
    which the nodes are connected, the layout applied and the key and
    bucket made. `clients` threads PUT `n_signed` objects signed
    (aws-chunked, `chunk` bytes a chunk), `n_unsigned` unsigned, and GET
    them all back; a round of `n_kill` more unsigned PUTs loses one
    worker to SIGKILL a quarter of the way in, and every request must
    succeed within the client's retries; the worker comes back ready;
    the lease conservation gauge reads 1 throughout; small rounds then
    reach every live worker, whose feeder must show device items and no
    fallback. -> rates, boot seconds, memory and per-worker counters."""
    import concurrent.futures
    import re
    import signal
    import threading

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from s3util import S3Client

    total = n_signed + n_unsigned + n_kill
    check(len(data) >= total * obj_size, "gateway phase: not enough data")
    objs = [data[i * obj_size:(i + 1) * obj_size] for i in range(total)]
    etags = [hashlib.md5(o).hexdigest() for o in objs]
    cuda = device != "cpu"
    env = dict(os.environ, PYTHONPATH=HERE, PYTHONUNBUFFERED="1",
               RUST_LOG="warning")
    if not cuda:
        env["OMP_NUM_THREADS"] = "1"
    s3_port, admin_port = free_port(), free_port()
    rpc_ports = [free_port() for _ in range(nodes)]
    front = (f'\n[s3_api]\napi_bind_addr = "127.0.0.1:{s3_port}"\n'
             f's3_region = "garage"\n\n[admin]\n'
             f'api_bind_addr = "127.0.0.1:{admin_port}"\n'
             f'admin_token = "{ADMIN_TOKEN}"\n\n[gateway]\n'
             f'workers = {workers}\nlease_interval_s = 0.5\n'
             f'respawn_backoff_s = 0.5\n')
    cfgs = [node_config(os.path.join(root, f"node{i:02d}"), rpc_ports[i], rf,
                        erasure, block_size, front if i == 0 else "")
            for i in range(nodes)]
    out: dict = {}
    procs, logs, ids = [], [[] for _ in range(nodes)], [None] * nodes
    ready = [threading.Event() for _ in range(nodes)]
    worker_pids: set = set()

    def reader(i: int, proc) -> None:
        for line in proc.stdout:
            logs[i].append(line)
            m = re.match(r"garage_tpu_torch node ([0-9a-f]{64}) ready", line)
            if m:
                ids[i] = m.group(1)
                ready[i].set()

    api = AdminApi(admin_port)
    t_phase = time.perf_counter()

    def note(what: str) -> None:  # progress, on stderr
        print(f"[gateway +{time.perf_counter() - t_phase:.1f} s] {what}",
              file=sys.stderr, flush=True)

    def admin(method: str, path: str, body=None):
        st, r = api.call(method, path, body)
        check(st == 200, f"gateway admin {method} {path}: {st} {r!r}")
        return r

    def metrics() -> str:
        st, text = api.call("GET", "/metrics")
        check(st == 200, f"gateway admin GET /metrics: {st}")
        return text.decode() if isinstance(text, bytes) else str(text)

    if cuda:
        torch.cuda.synchronize()
        out["mem_free_before"] = torch.cuda.mem_get_info(0)[0]
    pool = concurrent.futures.ThreadPoolExecutor(clients)
    try:
        t0 = time.perf_counter()
        for i in range(nodes):
            p = subprocess.Popen(
                [sys.executable, "-m", "garage_tpu_torch.cli.server",
                 "--config", cfgs[i], "--device", device,
                 "--log-level", "warning"],
                cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            procs.append(p)
            threading.Thread(target=reader, args=(i, p), daemon=True).start()
        for i in range(nodes):
            while not ready[i].wait(1.0):
                check(procs[i].poll() is None and
                      time.perf_counter() - t0 < 300,
                      f"gateway node {i} not ready: "
                      + "".join(logs[i][-20:]))
        out["boot_s"] = time.perf_counter() - t0
        note(f"{nodes} nodes ready")
        st = admin("GET", "/v1/gateway")
        worker_pids.update(w["pid"] for w in st["workers"])
        check(st["workers_alive"] == workers
              and all(w["ready"] for w in st["workers"]),
              f"gateway workers not ready: {st!r}")
        if cuda:
            torch.cuda.synchronize()
            out["mem_free_booted"] = torch.cuda.mem_get_info(0)[0]
        res = admin("POST", "/v1/connect",
                    [f"{ids[i]}@127.0.0.1:{rpc_ports[i]}"
                     for i in range(1, nodes)])
        check(all(r["success"] for r in res), f"connect: {res!r}")
        admin("POST", "/v1/layout", [
            {"id": ids[i], "zone": "dc1", "capacity": 1 << 40}
            for i in range(nodes)])
        admin("POST", "/v1/layout/apply", {"version": 1})
        deadline = time.monotonic() + 120
        while True:
            st = admin("GET", "/v1/status")
            if st["layoutVersion"] == 1 and sum(
                    1 for nd in st["nodes"] if nd["isUp"]
                    and nd.get("role")) >= nodes:
                break
            check(time.monotonic() < deadline,
                  f"gateway cluster not up: {st!r}")
            time.sleep(0.5)
        k = admin("POST", "/v1/key", {"name": "gateway"})
        b = admin("POST", "/v1/bucket", {"globalAlias": "smoke"})
        admin("POST", "/v1/bucket/allow", {
            "bucketId": b["id"], "accessKeyId": k["accessKeyId"],
            "permissions": {"read": True, "write": True, "owner": True}})
        client = S3Client("127.0.0.1", s3_port, k["accessKeyId"],
                          k["secretAccessKey"])
        retries = [0]

        def retrying(what: str, fn, tries: int = 14):
            last = ""
            for attempt in range(tries):
                try:
                    st, hdr, body = fn()
                    if st == 200:
                        return hdr, body
                    last = f"{st} {body[:200]!r}"
                except OSError as e:
                    last = repr(e)
                retries[0] += 1
                note(f"{what}: retry {attempt + 1} after {last}")
                time.sleep(min(0.25 * 2 ** attempt, 4.0))
            raise SmokeError(f"gateway {what}: failed after {tries} "
                             f"tries: {last}")

        def put_signed(i: int) -> None:
            o = objs[i]
            chunks = [o[j:j + chunk].tobytes()
                      for j in range(0, len(o), chunk)]
            hdr, _ = retrying(f"signed PUT g{i}", lambda: client.put_chunked(
                f"/smoke/g{i:04d}", chunks))
            check(hdr.get("etag", "").strip('"') == etags[i],
                  f"gateway ETag of g{i}")

        def put_unsigned(i: int) -> None:
            hdr, _ = retrying(f"unsigned PUT g{i}", lambda: client.request(
                "PUT", f"/smoke/g{i:04d}", body=objs[i].tobytes(),
                unsigned_payload=True, timeout=timeout))
            check(hdr.get("etag", "").strip('"') == etags[i],
                  f"gateway ETag of g{i}")

        def get(i: int) -> None:
            hdr, body = retrying(f"GET g{i}", lambda: client.request(
                "GET", f"/smoke/g{i:04d}", timeout=timeout))
            check(body == objs[i].tobytes(), f"gateway GET g{i}: bytes differ")
            check(hdr.get("etag", "").strip('"') == etags[i],
                  f"gateway GET g{i}: ETag")

        def run(fn, idx) -> float:
            t = time.perf_counter()
            list(pool.map(fn, idx))
            return time.perf_counter() - t

        def workers_connected(what: str) -> None:
            """Until every worker sees every storage node up: a worker
            learns the other nodes from the store's peer list."""
            deadline = time.monotonic() + 180
            while True:
                up = worker_gauges(metrics(), "cluster_storage_nodes_up")
                if len(up) == workers and min(up.values()) >= nodes:
                    return
                check(time.monotonic() < deadline,
                      f"gateway: {what}: storage nodes up per worker {up}")
                time.sleep(0.5)

        workers_connected("before the timed rounds")
        retrying("warm-up PUT", lambda: client.request(
            "PUT", "/smoke/warm", body=b"w" * 1000, unsigned_payload=True))
        # connect, layout, key and bucket, every worker reaching every
        # storage node, one PUT
        out["setup_s"] = time.perf_counter() - t0 - out["boot_s"]
        note("cluster set up")
        out["put_s"] = run(put_signed, range(n_signed))
        note("signed PUT round done")
        out["put_unsigned_s"] = run(put_unsigned,
                                    range(n_signed, n_signed + n_unsigned))
        out["get_s"] = run(get, range(n_signed + n_unsigned))
        out["retries_before_kill"] = retries[0]
        note("unsigned PUT and GET rounds done")

        # a worker lost to SIGKILL a quarter into a round of PUTs: the
        # conservation gauge is sampled from the kill until it is back
        samples: list = []
        sampling = threading.Event()

        def sample() -> None:
            while not sampling.is_set():
                samples.append(gauges(metrics()).get(
                    "gateway_lease_conservation_ok"))
                time.sleep(0.25)

        st = admin("GET", "/v1/gateway")
        victim = next(w for w in st["workers"] if w["index"] == 1)
        kill_idx = list(range(n_signed + n_unsigned, total))
        done = [0]
        done_lock = threading.Lock()

        def put_and_kill(i: int) -> None:
            put_unsigned(i)
            with done_lock:
                done[0] += 1
                kill = done[0] == max(1, len(kill_idx) // 4)
            if kill:
                os.kill(victim["pid"], signal.SIGKILL)
                out["killed"] = {"index": victim["index"],
                                 "pid": victim["pid"]}

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t_kill = time.perf_counter()
        out["kill_round_s"] = run(put_and_kill, kill_idx)
        check("killed" in out, "gateway: no worker was killed")
        note("kill round done")
        list(pool.map(get, kill_idx))
        deadline = time.monotonic() + 180
        while True:
            st = admin("GET", "/v1/gateway")
            if st["workers_alive"] == workers and st["restarts_total"] >= 1 \
                    and all(w["ready"] for w in st["workers"]):
                break
            check(time.monotonic() < deadline,
                  f"gateway: killed worker not back: {st!r}")
            time.sleep(0.25)
        out["respawn_s"] = time.perf_counter() - t_kill
        note("killed worker back")
        workers_connected("after the respawn")
        out["reconnect_s"] = time.perf_counter() - t_kill
        worker_pids.update(w["pid"] for w in st["workers"])
        check(victim["pid"] not in [w["pid"] for w in st["workers"]],
              "gateway: the killed worker's pid is still listed")
        sampling.set()
        sampler.join()
        out["conservation_samples"] = len(samples)
        check(samples and all(v == 1 for v in samples),
              f"gateway: lease conservation gauge read {samples}")
        check(st["broker"]["conservation_ok"],
              "gateway: broker conservation broken")
        out["retries"] = retries[0]

        # small rounds until every live worker (the respawned one too,
        # once it has the layout) has run block math on its device
        n_top = max(1, min(len(data) // top_up, 4 * clients))
        small = [data[i * top_up:(i + 1) * top_up] for i in range(n_top)]
        rounds = 0
        deadline = time.monotonic() + 120
        while True:
            text = metrics()
            items = worker_gauges(text, "feeder_device_items")
            if len(items) == workers and min(items.values()) > 0:
                break
            check(time.monotonic() < deadline,
                  f"gateway: workers without device items: {items}")
            rounds += 1
            time.sleep(0.5)

            def put_small(i: int, r=rounds) -> None:
                retrying(f"PUT t{r}-{i}", lambda: client.request(
                    "PUT", f"/smoke/t{r}-{i:03d}", body=small[i].tobytes(),
                    unsigned_payload=True, timeout=timeout))

            run(put_small, range(n_top))
        out["top_up_rounds"] = rounds
        fallbacks = worker_gauges(text, "feeder_device_fallbacks")
        check(len(fallbacks) == workers and not any(fallbacks.values()),
              f"gateway: worker fallbacks {fallbacks}")
        out["worker_device_items"] = items
        out["worker_batches"] = worker_gauges(text, "feeder_batches")
        out["worker_launches"] = kernel_gauges(text)
        out["conservation_final"] = gauges(text).get(
            "gateway_lease_conservation_ok")
        check(out["conservation_final"] == 1,
              "gateway: conservation gauge at the end")
        if cuda:
            torch.cuda.synchronize()
            out["mem_free_end"] = torch.cuda.mem_get_info(0)[0]
        out["bytes"] = {"put": n_signed * obj_size,
                        "put_unsigned": n_unsigned * obj_size,
                        "get": (n_signed + n_unsigned) * obj_size}
        return out
    except BaseException:
        for i, lines in enumerate(logs):  # the nodes' last words
            if lines:
                print(f"[gateway node {i} log]\n" + "".join(lines[-30:]),
                      file=sys.stderr)
        raise
    finally:
        pool.shutdown(wait=True)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for pid in worker_pids:  # workers outliving a killed store
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    if b"garage_tpu_torch.gateway.worker" in f.read():
                        os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


def geometry(name: str, r: dict) -> str:
    """The launch geometry and the operation or chain floors of a timed
    kernel shape, for its kernel line."""
    p = r.get("plan", {})
    if name.startswith("gf_apply"):
        return (f", tile {p['tile']} B, grid {p['grid']} CTAs over "
                f"{p['units']} units, int8 tensor-core bound "
                f"{r['ops_ms']:.4f} ms")
    if name.startswith("gf_check"):
        return (f", tile {p['tile']} B, grid {p['grid']} CTAs over "
                f"{p['units']} units, {p['launches']} launch(es), int8 "
                f"tensor-core bound {r['ops_ms']:.4f} ms")
    if name.startswith("blake3"):
        return (f", {p['ctas']} CTAs of {p['warps_per_cta']} warps, "
                f"{p['blocks']} blocks a row, "
                f"{'small-batch' if p['small'] else 'full-card'} instance, "
                f"chain "
                f"{r['chain_cycles_per_g']:.3f} cycles per G step, chain "
                f"floor {r['chain_ms']:.4f} ms, all-lanes "
                f"{r['ops_ms']:.5f} ms")
    if "chain_ms" in r:
        return (f", chain {r['chain_cycles_per_round']:.3f} cycles per "
                f"round ({r['dep_latency_cycles']:.3f} per dependent "
                f"instruction), chain floor {r['chain_ms']:.4f} ms, "
                f"all-lanes {r['ops_ms']:.5f} ms, host hashlib "
                f"{r['hashlib_ms']:.3f} ms")
    return ""


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
            reset_launches, treehash
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
              f"({r['gbps']:.1f} GB/s), device {r['device_ms']:.4f} ms "
              f"(CUDA graph), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})"
              + (f", plain {r['plain_ms']:.2f} ms" if "plain_ms" in r
                 else "") + geometry(name, r))
        check(min(r["ms"], r["device_ms"]) >= r["bound_ms"],
              f"kernel {name} reads above its bound: {r['device_ms']} ms < "
              f"{r['bound_ms']} ms")
    for code, w in kres["gf_check"]["wide"].items():
        print(f"kernel gf_check erasure({code}): 8 planted stripes of 10 "
              f"flagged, equal to plain torch; {w['launches']} launch(es) "
              f"of {w['rows_per_launch']} syndrome rows")

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # each path runs with every launch count set to 0 just before it
        reset_launches()
        rates = asyncio.run(main_path(data, os.path.join(root, "block"),
                                      rng, dev))
        launches = kernel_launches()
        b3_batches = dict(sorted(treehash.batch_sizes.items()))
        # router phase: "auto" (its calibration included) and "off", then
        # a host-only node, each counted from 0
        t_router = time.perf_counter()
        reset_launches()
        router = asyncio.run(router_phase(
            data, os.path.join(root, "router"), rng, dev, rates))
        reset_launches()
        host_node = asyncio.run(host_node_phase(
            data, os.path.join(root, "host_node"), dev))
        host_node_launches = kernel_launches()
        router["phase_s"] = time.perf_counter() - t_router
        reset_launches()
        s3 = asyncio.run(s3_phase(data, os.path.join(root, "s3"), dev))
        s3_launches = kernel_launches()
        s3_b3_batches = dict(sorted(treehash.batch_sizes.items()))
        knobs = asyncio.run(tpu_knob_check(data, dev))
        reset_launches()
        dur = asyncio.run(durability_phase(
            data, os.path.join(root, "durability"), dev))
        dur_launches = kernel_launches()
        # grid phase: what the steps and the grid feeder must give first
        # (plain composition, one-device feeder), then the path itself
        gref = grid_reference(torch, data, dev)
        grid_one = asyncio.run(grid_feeder(data, dev))
        reset_launches()
        gsteps = grid_steps(torch, gref, dev)
        gfeed = asyncio.run(grid_feeder(data, dev, reference=grid_one))
        grid_launches = kernel_launches()
        del gref, grid_one
        # gateway phase: its kernels run in the worker processes, which
        # start with every count at 0; their /metrics carry the counts
        gw = gateway_phase(torch, data, os.path.join(root, "gateway"))
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
    print(f"B3 launches by batch size (rows) on the block path: "
          f"{json.dumps(b3_batches)}")
    check(stats["device_fallbacks"] == 0, "device fallbacks on the main path")
    check(stats["device_items"] == stats["items"],
          "a main-path request did not run on the device")
    check(stats["device_items"] > 0 and stats["decode_device_items"] > 0,
          "the main path did not reach the device")
    for name in ("gf_apply", "gf_check", "blake3_rows"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the block path")

    ar, auto = router["auto_launches"], router["auto"]
    print(f"router phase ({smi[0]}): {router['phase_s']:.2f} s in all; "
          f"auto feeder on {dev} calibrated in "
          f"{router['calibration_s']:.2f} s (4 x 1 MiB a leg), MB/s by "
          f"op/route {json.dumps(router['calibration'])}; calibration "
          f"launches {json.dumps(router['calibration_launches'])}")
    print(f"router auto, {N_BLOCKS} x 1 MiB: PUT "
          f"{gib / auto['put_s'] / 1e9:.3f} GB/s, degraded GET "
          f"{gib / auto['get_s'] / 1e9:.3f} GB/s, scrub "
          f"{N_BLOCKS / auto['scrub_s']:.1f} blocks/s, repair "
          f"{gib / auto['repair_s'] / 1e9:.3f} GB/s; byte-equal to the "
          f"require run and the oracles; items by op and route "
          f"{json.dumps(router['auto_route'])}; MB/s at the end "
          f"{json.dumps(router['rates_after'])}; launches (calibration "
          f"included) {json.dumps(ar)}")
    off = router["off"]
    quarter = N_BLOCKS // 4 * BLOCK
    print(f"router off, {N_BLOCKS // 4} x 1 MiB: PUT "
          f"{quarter / off['put_s'] / 1e9:.3f} GB/s, degraded GET "
          f"{quarter / off['get_s'] / 1e9:.3f} GB/s, scrub "
          f"{N_BLOCKS // 4 / off['scrub_s']:.1f} blocks/s, repair "
          f"{quarter / off['repair_s'] / 1e9:.3f} GB/s; byte-equal; "
          f"launches {json.dumps(router['off_launches'])}; items by op "
          f"{json.dumps(route_split(off['stats'], off['pipeline']))}")
    print(f"[tpu] enable = false node (14 nodes, erasure(10,4), {dev}): "
          f"signed PUT of {S3_OBJ_SIZE >> 20} MiB in {host_node['chunks']} "
          f"chunks {host_node['put_s']:.2f} s, GET {host_node['get_s']:.2f} "
          f"s, bytes and ETag equal; feeder modes {host_node['modes']}; "
          f"launches {json.dumps(host_node_launches)}")
    check(sum(host_node_launches.values()) == 0,
          f"the host-only node launched kernels: {host_node_launches}")
    check(router["auto_route"]["device_fallbacks"] == 0,
          "device fallbacks in the router phase")

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
    print(f"B3 launches by batch size (rows) on the S3 path: "
          f"{json.dumps(s3_b3_batches)}")
    check(s3["fallbacks_all_nodes"] == 0, "device fallbacks on the S3 path")
    check(s3["stats"]["device_items"] == s3["stats"]["items"],
          "an S3-path request did not run on the device")
    check(s3["sha256_items"] == s3["chunks_sent"],
          "a signed chunk that landed whole in a lease missed S2")
    check(s3["degraded_decodes"] > 0, "degraded GETs decoded nothing")
    print(f"admin HTTP API: key and bucket created, website access set, "
          f"feeder_inflight_batches set to 2 and read back, restored to 3, "
          f"the routing floor feeder_device_min_bytes set to 1 MiB, read "
          f"back and restored; /metrics after the signed rounds "
          f"{json.dumps(s3['metrics'])} against the feeder's "
          f"{json.dumps(s3['metrics_snapshot'])}")
    print(f"web path launches: healthy {json.dumps(s3['web_launches'])}, "
          f"degraded {json.dumps(s3['web_degraded_launches'])} "
          f"({s3['web_degraded_decodes']} device decodes)")
    k2v = s3["k2v"]
    adm = s3["admin_ms"]
    print(f"front ends on node 0 ({smi[0]}): web GET ({S3_WEB} x "
          f"{S3_OBJ_SIZE >> 20} MiB) {b['web'] / s3['web_get_s'] / 1e9:.3f} "
          f"GB/s ({s3['web_get_s']:.2f} s); degraded web GET (4 nodes "
          f"down) {b['web'] / s3['web_degraded_s'] / 1e9:.3f} GB/s "
          f"({s3['web_degraded_s']:.2f} s), bytes equal; K2V "
          f"{k2v['ops'] / k2v['s']:.1f} operations/s ({k2v['ops']} in "
          f"{k2v['s']:.2f} s, values equal); admin request latency median "
          f"{statistics.median(adm):.2f} ms, max {max(adm):.2f} ms over "
          f"{len(adm)} requests")
    print(f"[tpu] batch_blocks = 8, batch_linger_ms = 0 on {dev}: "
          f"{knobs['device_items']} concurrent hash_md5 items of 1 MiB in "
          f"{knobs['batches']} batches, widest {knobs['max_batch']}")
    check(s3["web_degraded_decodes"] > 0,
          "degraded web GETs decoded nothing on the device")
    for name in ("sha256_rows", "gf_apply", "blake3_rows"):
        check(s3_launches[name] > 0,
              f"kernel {name} was not launched on the S3 path")

    sc = dur["scrub"]
    sl, rl = dur["scrub_launches"], dur["replace_launches"]
    per_g2 = dur["stripes_checked"] / max(1, sl.get("gf_check", 0))
    per_g1 = dur["rebuild_items"] / max(1, rl.get("gf_apply", 0))
    print(f"durability phase ({smi[0]}): {dur['nodes']}-node erasure(10,4) "
          f"port cluster on {dev}, {N_BLOCKS} blocks of 1 MiB written "
          f"through node 0's rpc_put_block by {N_OBJECTS} writers in "
          f"{dur['put_s']:.2f} s, every block referenced on every node")
    print(f"deep scrub (scrub-tranquility 0, `repair scrub start` on every "
          f"node): {N_BLOCKS / dur['scrub_s']:.1f} blocks/s ({N_BLOCKS} "
          f"blocks over the slowest node's pass, {dur['scrub_s']:.2f} s); "
          f"/metrics summed over the nodes {json.dumps(sc)}, equal to the "
          f"plant; disk_bitrot fired {dur['bitrot_fired']} time(s); G2 "
          f"launches {sl.get('gf_check', 0)} for {dur['stripes_checked']} "
          f"stripes ({per_g2:.2f} stripes "
          f"per launch); G1 launches {sl.get('gf_apply', 0)} ("
          f"{dur['repair_encodes']} repair re-encodes through the feeder, "
          f"{dur['scrub_resync_repairs']} resync rebuilds); localisation "
          f"decodes on the host {dur['host_decodes']}; all {N_BLOCKS} "
          f"blocks read back byte-equal through node 0 in "
          f"{dur['read_after_scrub_s']:.2f} s; launches "
          f"{json.dumps(sl)}")
    writes, here = (dur["split"][dur["new_node"]][name][1]
                    for name in ("write_local_shard", "repair"))
    print(f"node replacement (node {dur['nodes'] - 1} stopped and wiped, "
          f"node {dur['new_node']} takes its role in the same zone, "
          f"`repair blocks` with resync-tranquility 0 on every node): "
          f"{dur['rebuilt_bytes'] / dur['replace_s'] / 1e9:.4f} GB/s "
          f"({dur['rebuilt_bytes']} shard bytes on the new node, each equal "
          f"to the host re-encode: {writes - here} fetched from their old "
          f"holders, {here} rebuilt there), queues drained "
          f"{dur['replace_s']:.2f} s after the layout change; G1 launches "
          f"{rl.get('gf_apply', 0)} for {dur['rebuild_items']} feeder "
          f"repair items across the cluster, the shards lost with node "
          f"{dur['nodes'] - 1} ({per_g1:.2f} per launch); all {N_BLOCKS} "
          f"blocks read back byte-equal in "
          f"{dur['read_after_replace_s']:.2f} s; 0 fallbacks on all nodes; "
          f"launches {json.dumps(rl)}")

    def calls(acc: dict) -> str:
        return ", ".join(f"{name} {t:.2f} s / {n} = {1e3 * t / max(1, n):.2f}"
                         f" ms ({r} raised)"
                         for name, (t, n, r) in acc.items())
    new, split = dur["new_node"], dur["split"]
    others = {}
    for i, acc in split.items():
        for name, cell in acc.items():
            if i != new:
                into = others.setdefault(name, [0.0, 0, 0])
                for j in range(3):
                    into[j] += cell[j]
    busy = dur["busy_s"]
    slowest = max((t for i, t in busy.items() if i != new), default=0.0)
    print(f"rebuild time split ({smi[0]}; wall seconds summed over calls, "
          f"calls overlap on one event loop): new node {new}: "
          f"{calls(split[new])}; the {len(split) - 1} other nodes together: "
          f"{calls(others)}; resync busy until {busy.get(new, 0):.2f} s "
          f"(new node), {slowest:.2f} s (slowest other node) after the "
          f"layout change")
    for name in ("gf_apply", "gf_check"):
        check(dur_launches.get(name, 0) > 0,
              f"kernel {name} was not launched on the durability path")

    for grid, steps in gsteps.items():
        print(f"grid {grid} [{dev}], {GRID_B} stripes RS(10,4) of "
              f"{GRID_S} B a shard: "
              + "; ".join(f"{step} {r['ms']:.3f} ms, launches "
                          f"{json.dumps(r['launches'])}"
                          for step, r in steps.items())
              + "; byte-equal to the plain composition")
    fs = gfeed["stats"]
    print(f"grid feeder [{dev}, {dev}] dp=2, mesh_min_items 8: "
          f"{GRID_B} x 1 MiB encoded, parity-checked (1 planted), decoded, "
          f"repaired; mesh_batches={fs['mesh_batches']} "
          f"device_batches={fs['device_batches']} "
          f"device_fallbacks={fs['device_fallbacks']}; equal to the "
          f"one-device route")
    print(f"launches on the grid path: {json.dumps(grid_launches)}")
    check(fs["mesh_batches"] > 0, "the grid feeder took no grid route")
    check(fs["device_fallbacks"] == 0, "device fallbacks on the grid path")
    for name in ("gf_apply", "gf_check", "blake3_rows"):
        check(grid_launches[name] > 0,
              f"kernel {name} was not launched on the grid path")

    gb = gw["bytes"]
    gw_rates = {"put": gb["put"] / gw["put_s"] / 1e9,
                "put_unsigned": gb["put_unsigned"] / gw["put_unsigned_s"]
                / 1e9,
                "get": gb["get"] / gw["get_s"] / 1e9}
    s3_rates = {"put": b["put"] / s3["put_s"] / 1e9,
                "put_unsigned": b["put_unsigned"] / s3["put_unsigned_s"]
                / 1e9,
                "get": b["get"] / s3["get_s"] / 1e9}
    mem = ""
    if "mem_free_before" in gw:
        mem = (f"; card memory taken by the cluster's processes: "
               f"{(gw['mem_free_before'] - gw['mem_free_booted']) / 2**30:.2f}"
               f" GiB at boot, "
               f"{(gw['mem_free_before'] - gw['mem_free_end']) / 2**30:.2f}"
               f" GiB at the end")
    print(f"gateway phase ({smi[0]}): 14 node processes, erasure(10,4), "
          f"node 0 with {GW_WORKERS} gateway workers on {dev}, booted in "
          f"{gw['boot_s']:.2f} s, set up in {gw['setup_s']:.2f} s (layout, "
          f"key, every worker reaching the 14 nodes){mem}")
    print(f"gateway S3 GB/s (beside the in-process S3 phase of this run): "
          f"signed PUT ({GW_SIGNED} x {S3_OBJ_SIZE >> 20} MiB) "
          f"{gw_rates['put']:.3f} ({gw['put_s']:.2f} s; in-process "
          f"{s3_rates['put']:.3f}), unsigned PUT "
          f"{gw_rates['put_unsigned']:.3f} ({gw['put_unsigned_s']:.2f} s; "
          f"in-process "
          f"{s3_rates['put_unsigned']:.3f}), GET {gw_rates['get']:.3f} "
          f"({gw['get_s']:.2f} s; in-process {s3_rates['get']:.3f})")
    killed = gw["killed"]
    print(f"gateway worker {killed['index']} (pid {killed['pid']}) "
          f"SIGKILLed a quarter into a round of {GW_KILL_ROUND} unsigned "
          f"PUTs ({gw['kill_round_s']:.2f} s): every request succeeded "
          f"({gw['retries']} client retries in the phase, "
          f"{gw['retries_before_kill']} before the kill), all {GW_WORKERS} "
          f"workers ready {gw['respawn_s']:.2f} s after the kill and "
          f"reaching the 14 nodes {gw['reconnect_s']:.2f} s after it, lease "
          f"conservation 1 in {gw['conservation_samples']} samples and at "
          f"the end; {gw['top_up_rounds']} small round(s) to reach every "
          f"worker")
    print(f"gateway workers: feeder_device_items "
          f"{json.dumps(gw['worker_device_items'])}, feeder_batches "
          f"{json.dumps(gw['worker_batches'])}, 0 fallbacks; launches "
          f"counted by the live workers {json.dumps(gw['worker_launches'])}")
    for name in ("sha256_rows", "gf_apply", "blake3_rows"):
        check(gw["worker_launches"].get(name, 0) > 0,
              f"kernel {name} was not launched in the gateway workers")

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
            "launches": (launches[name] + ar[name] + s3_launches[name]
                         + dur_launches.get(name, 0) + grid_launches[name]
                         + gw["worker_launches"].get(name, 0)),
            "launches_by_path": {
                "block": launches[name], "router": ar[name],
                "s3": s3_launches[name],
                "durability": dur_launches.get(name, 0),
                "grid": grid_launches[name],
                "gateway": gw["worker_launches"].get(name, 0)},
            "max_abs_err": r["err"], "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    by_name = {k["name"]: k for k in kernels}
    by_name["gf_apply"]["shapes"] = {
        key: {"ms": kres[key]["ms"], "device_ms": kres[key]["device_ms"],
              "bound_ms": kres[key]["bound_ms"],
              "bound_by": kres[key]["bound_by"],
              "tile": kres[key]["plan"]["tile"],
              "grid": kres[key]["plan"]["grid"]}
        for key in ("gf_apply", "gf_apply[put]", "gf_apply[decode]",
                    "gf_apply[repair]")}
    for name, keys in (("gf_check", ("tile", "grid", "units", "launches")),
                       ("blake3_rows", ("warps_per_cta", "ctas", "blocks",
                                        "small"))):
        by_name[name]["shapes"] = {
            key: {"ms": kres[key]["ms"], "device_ms": kres[key]["device_ms"],
                  "bound_ms": kres[key]["bound_ms"],
                  "bound_by": kres[key]["bound_by"],
                  **{g: kres[key]["plan"][g] for g in keys}}
            for key in kres if key.startswith(name)}
    b3 = kres["blake3_rows"]
    by_name["blake3_rows"].update({
        "chain_cycles_per_g": b3["chain_cycles_per_g"],
        "chain_ms": b3["chain_ms"],
        "batches": {"block": b3_batches, "s3": s3_b3_batches}})
    by_name["gf_check"]["wide"] = kres["gf_check"]["wide"]
    s2, s2_256 = kres["sha256_rows"], kres["sha256_rows[256]"]
    by_name["sha256_rows"].update({
        "dep_latency_cycles": s2["dep_latency_cycles"],
        "chain_cycles_per_round": s2["chain_cycles_per_round"],
        "rows256": {"ms": s2_256["ms"], "device_ms": s2_256["device_ms"]}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_phase_of(tree: str) -> int:
    """Step 2 of the checkout at `tree`, with its own script, seed and
    data; prints {"tree", "kernels": {name: {"ms", "device_ms"}}}."""
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_tree", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from garage_tpu_torch.ops import _build

    check(os.path.dirname(os.path.dirname(_build.CSRC)) == tree,
          f"garage_tpu_torch of {tree} not first on the path")
    _build.build_all()
    rng = np.random.default_rng(mod.SEED)
    data = np.frombuffer(bytearray(rng.bytes(max(
        mod.N_BLOCKS * mod.BLOCK,
        (mod.S3_OBJECTS + mod.S3_UNSIGNED) * mod.S3_OBJ_SIZE))),
        dtype=np.uint8)
    res = mod.kernel_phase(torch, data, rng, torch.device("cuda", 0),
                           max_sm_clock_hz())
    print(json.dumps({"tree": tree, "kernels": {
        name: {"ms": r["ms"], "device_ms": r["device_ms"]}
        for name, r in res.items()}}))
    return 0


if __name__ == "__main__":
    try:
        if len(sys.argv) == 3 and sys.argv[1] == "--kernel-phase-of":
            sys.exit(kernel_phase_of(sys.argv[2]))
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
