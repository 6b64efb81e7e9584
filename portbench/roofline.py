"""The card's peaks and the least time of each kernel's work, from
shapes alone (a frozen copy of chip_smoke.py's peak constants and
`g1_ops`). The least time of one item is the larger of its operations
over the peak rate that executes them and its bytes over HBM bandwidth;
each input byte is read once and each output byte written once."""

from __future__ import annotations

from portbench import traffic

# NVIDIA H100 SXM data sheet, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
# 32-bit lane instructions per second, of any type: each of an SM's 4
# schedulers issues at most one 32-lane warp instruction per clock, the
# rate the data sheet's 67 TFLOP/s float32 counts with an FMA as 2 flops
LANE_OPS_PER_S = 67e12 / 2
# dense int8 tensor-core operations per second
INT8_OPS_PER_S = 1979e12
# one BLAKE3 compression on sm_90: 7 rounds x 8 G x 12 instructions
# + 8 xors for the output words
B3_OPS_PER_COMPRESSION = 7 * 8 * 12 + 8
# one SHA-256 compression on sm_90: 64 rounds x 14 instructions + 48
# schedule steps x 10 + 31 for loads, byte swaps, state adds and the loop
S2_OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 31


def g1_ops(s: int, k: int, r: int) -> int:
    """G1's tensor-core operations for one stripe of k rows of s bytes
    into r output rows: per byte position it multiplies 8k input bits
    into 8 output bits of two rows at once."""
    return 2 * s * 8 * k * 8 * -(-r // 2)


def b3_s(n: int) -> float:
    """BLAKE3-256 of n bytes: one compression per 64-byte block of each
    1 KiB chunk, one per parent node."""
    chunks = max(1, -(-n // 1024))
    blocks = sum(max(1, -(-c // 64)) for c in traffic.chunks_of(n, 1024)) \
        if n else 1
    ops = (blocks + chunks - 1) * B3_OPS_PER_COMPRESSION
    return max(ops / LANE_OPS_PER_S, (n + 32) / HBM_BYTES_PER_S)


def s2_s(n: int) -> float:
    """SHA-256 of n bytes (message padding included)."""
    ops = -(-(n + 9) // 64) * S2_OPS_PER_COMPRESSION
    return max(ops / LANE_OPS_PER_S, (n + 32) / HBM_BYTES_PER_S)


def g1_s(s: int, k: int, r: int) -> float:
    """One stripe through G1: k rows of s bytes in, r rows out."""
    return max(g1_ops(s, k, r) / INT8_OPS_PER_S,
               (k + r) * s / HBM_BYTES_PER_S)


def per_item_s(spec: dict, cfg: dict) -> dict[str, float]:
    """Mean least device seconds of one feeder item of each op the
    mix's traffic sends to the card, over the mix's size set: blocks of
    `block_size`, their packed stripes (one scheme byte more, cut in k
    rows) and, for signed bodies, the full chunks (shorter tail chunks
    are hashed on the host). Items the mix does not make are absent."""
    bs = cfg["garage"]["block_size"]
    ec = cfg["garage"].get("erasure_coding")
    k, m = map(int, ec.split(",")) if ec else (0, 0)
    blocks = [b for size in traffic.size_set(spec)
              for b in traffic.blocks_of(size, bs)]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    out = {}
    if spec["op"] == "put":
        out["hash_md5"] = mean([b3_s(b) for b in blocks])
        if k:
            out["encode_put"] = mean(
                [g1_s(-(-(b + 1) // k), k, m) for b in blocks])
        if spec.get("payload") == "signed":
            out["sha256"] = s2_s(spec["chunk"])
    elif spec["op"] == "get" and k:
        out["decode"] = mean([g1_s(-(-(b + 1) // k), k, k) for b in blocks])
    return out


def least_s(op_items: dict, spec: dict, cfg: dict) -> float | None:
    """Least device seconds of the items the card ran; None where it
    ran none of the ops this arithmetic knows."""
    per = per_item_s(spec, cfg)
    seen = {op: n for op, n in op_items.items() if op in per and n > 0}
    if not seen:
        return None
    return sum(n * per[op] for op, n in seen.items())
