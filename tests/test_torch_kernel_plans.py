"""G1's design on the CPU: its bit-matrix fragments (a host model of
the kernel's g1_build_bfrag, held against the JAX package's
bitmat_t_for and pallas_gf._mat_bits_jk), a numpy emulation of its
fragment algorithm (the mma.sync m16n8k32 lane layouts of the PTX ISA,
the nibble unpack and the quad epilogue) against the JAX package's
GF(2^8) apply, and codes wider than one launch's 16 input rows."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from garage_tpu.ops import gf256 as jgf256
from garage_tpu.ops import pallas_gf as jpallas
from garage_tpu.ops import rs as jrs
from garage_tpu_torch.ops import gf_kernel, rs

def _rows_per_frag(k: int) -> int:
    """Output rows one G1 B fragment carries (G1_ROWS_PER_FRAG in
    csrc/gf256.cu): two, at bits 0 and 7 of each byte, while a row's sum
    stays below 2^7 (8k <= 96 input bits), else one."""
    return 2 if k <= 12 else 1


def mma_b_fragments(mat: np.ndarray) -> np.ndarray:
    """G1's B operand as the kernel builds it in shared memory
    (g1_build_bfrag), (r, k) u8 coefficients -> (ceil(r / RB), KS, 32,
    8) u8, RB = _rows_per_frag(k): lane 4g + t of k-step ks holds, for
    input row j = 4 ks + t, bytes 0-3 = bit g of A[i][j] * 2^bb and bytes
    4-7 = bit g of A[i][j] * 2^(4 + bb) (zero for j >= k), for output row
    i = RB ip at bit 0 of the byte and i = RB ip + 1 at bit 7."""
    mat = np.asarray(mat, dtype=np.uint8)
    r, k = mat.shape
    ks, rb = -(-k // 4), _rows_per_frag(k)
    out = np.zeros((-(-r // rb), ks, 32, 8), dtype=np.uint8)
    for i in range(r):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for step in range(ks):
                j = 4 * step + t
                if j >= k:
                    continue
                for b in range(8):
                    p = int(jgf256.gf_mul(int(mat[i, j]), 1 << b))
                    bit = (p >> g) & 1
                    out[i // rb, step, lane, b] |= bit << (7 * (i % rb))
    return out


def _fragments_to_bitmatrix(frag: np.ndarray, r: int, k: int) -> np.ndarray:
    """(ceil(r / RB), KS, 32, 8) fragments -> the (8r, 8k) bit matrix they
    hold (row RB ip at bit 0 of each byte, row RB ip + 1 at bit 7)."""
    rb = _rows_per_frag(k)
    bits = np.zeros((8 * r, 8 * k), dtype=np.uint8)
    for ip, step, lane, b in itertools.product(
            range(frag.shape[0]), range(frag.shape[1]), range(32), range(8)):
        g, t = lane >> 2, lane & 3
        j, v = 4 * step + t, int(frag[ip, step, lane, b])
        assert v & ~0x81 == 0 and (rb == 2 or v <= 1)
        for h in range(rb):
            if j < k and rb * ip + h < r:
                bits[8 * (rb * ip + h) + g, 8 * j + b] = (v >> (7 * h)) & 1
            else:
                assert (v >> (7 * h)) & 1 == 0
    return bits


@pytest.mark.parametrize("shape", [(4, 10), (10, 10), (1, 1), (16, 16),
                                   (3, 5), (7, 12), (2, 13)])
def test_mma_b_fragments_hold_the_jax_bit_matrix(shape):
    mat = np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    r, k = shape
    frag = mma_b_fragments(mat)
    rb = _rows_per_frag(k)
    assert frag.shape == (-(-r // rb), -(-k // 4), 32, 8)
    bits = _fragments_to_bitmatrix(frag, r, k)
    assert np.array_equal(bits.T, jgf256.bitmat_t_for(mat))
    # the Pallas kernel's operand is the same matrix, columns permuted
    jk = jpallas._mat_bits_jk(mat.tobytes(), r, k)
    perm = [s * 8 + j for j in range(8) for s in range(k)]
    assert np.array_equal(bits[:, perm], jk)


# --- numpy emulation of G1's fragment algorithm (csrc/gf256.cu g1_tile)


def _mma_m16n8k32(a_regs, b_regs, c_regs):
    """One warp's mma.sync.m16n8k32.row.col.s32.u8.u8.s32 from per-lane
    fragments (PTX ISA layouts): a (32, 4, 4) u8 bytes, b (32, 2, 4),
    c (32, 4) int32 -> c + a . b."""
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(16):
            row = g if (i < 4 or 8 <= i < 12) else g + 8
            col = t * 4 + (i & 3) + (16 if i >= 8 else 0)
            a[row, col] = a_regs[lane, i // 4, i % 4]
        for i in range(8):
            b[t * 4 + (i & 3) + (16 if i >= 4 else 0), g] = \
                b_regs[lane, i // 4, i % 4]
    c = a @ b
    out = c_regs.copy()
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            out[lane, i] += c[g + (8 if i >= 2 else 0), t * 2 + (i & 1)]
    return out


def _spread4(n: int) -> list[int]:
    v = (n * 0x00204081) & 0x01010101
    return [(v >> (8 * q)) & 0xFF for q in range(4)]


def _emulate_g1_pass(mat: np.ndarray, x: np.ndarray) -> np.ndarray:
    """G1 over one warp pass of 64 positions: (r, k) coefficients, (k,
    64) bytes -> (r, 64) bytes, lane by lane as the kernel does it."""
    r, k = mat.shape
    frag = mma_b_fragments(mat)  # (r, KS, 32, 8)
    ks_n = frag.shape[1]
    a = np.zeros((ks_n, 4, 32, 4, 4), np.int64)  # ks, mt, lane, reg, byte
    for ks, lane in itertools.product(range(ks_n), range(32)):
        g, t = lane >> 2, lane & 3
        j = 4 * ks + t
        v = x[j, 8 * g:8 * g + 8] if j < k else np.zeros(8, np.uint8)
        for mt in range(4):
            p0, p1 = int(v[2 * mt]), int(v[2 * mt + 1])
            a[ks, mt, lane] = [_spread4(p0 & 15), _spread4(p1 & 15),
                               _spread4(p0 >> 4), _spread4(p1 >> 4)]
    rb = _rows_per_frag(k)
    out = np.zeros((r, 64), np.uint8)
    for ip in range(frag.shape[0]):
        c = np.zeros((4, 32, 4), np.int64)
        for ks, mt in itertools.product(range(ks_n), range(4)):
            b = frag[ip, ks].reshape(32, 2, 4)
            c[mt] = _mma_m16n8k32(a[ks, mt], b, c[mt])
        for h in range(rb):  # row rb * ip + h: bit 7 h of each sum
            i = rb * ip + h
            if i >= r:
                continue
            words = []
            for lane in range(32):
                t = lane & 3
                lo = hi = 0
                for mt in range(4):
                    bit = [(int(c[mt, lane, e]) >> (7 * h)) & 1
                           for e in range(4)]
                    two = (bit[0] | bit[1] << 1 | (bit[2] | bit[3] << 1) << 8) \
                        << (16 * (mt & 1))
                    if mt < 2:
                        lo |= two
                    else:
                        hi |= two
                words.append((lo << 2 * t, hi << 2 * t))
            for g in range(8):  # the quad's OR, then lane t == 0 stores
                lo = hi = 0
                for t in range(4):
                    lo |= words[4 * g + t][0]
                    hi |= words[4 * g + t][1]
                out[i, 8 * g:8 * g + 8] = np.frombuffer(
                    lo.to_bytes(4, "little") + hi.to_bytes(4, "little"),
                    np.uint8)
    return out


@pytest.mark.parametrize("k,r", [(10, 4), (4, 2), (1, 1), (16, 3), (5, 16),
                                 (12, 7), (13, 2), (16, 16)])
def test_g1_fragment_algorithm_matches_jax(k, r):
    rng = np.random.default_rng(k * 17 + r)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    x = rng.integers(0, 256, (k, 64), dtype=np.uint8)
    want = np.asarray(jgf256.bit_matmul_apply(
        jgf256.bitmat_t_for(mat), x[None]))[0]
    assert np.array_equal(_emulate_g1_pass(mat, x), want)
    assert np.array_equal(want, jgf256.gf_matmul(mat, x))


def test_g1_fragment_algorithm_rs104_decode_pattern():
    present = (0, 2, 3, 5, 6, 7, 9, 10, 12, 13)
    mat = jrs.decode_matrix(10, 4, present)
    x = np.random.default_rng(3).integers(0, 256, (10, 64), dtype=np.uint8)
    assert np.array_equal(_emulate_g1_pass(mat, x),
                          jgf256.gf_matmul(mat, x))


# --- G1 past one launch's 16 input rows: the wrapper's k-slices


@pytest.mark.parametrize("k,r", [(17, 4), (20, 4), (20, 20), (33, 1),
                                 (50, 16), (4, 17), (64, 40), (800, 1)])
def test_gf_apply_takes_maps_wider_than_one_launch(k, r):
    """Maps past one G1 launch's 16 x 16 (erasure(20,4) encode and its
    20 x 20 decode) keep working: on the CPU the plain version,
    byte-equal to the JAX package's GF apply, per item and broadcast."""
    rng = np.random.default_rng(k * 13 + r)
    x = rng.integers(0, 256, (2, k, 48), dtype=np.uint8)
    for mats in (rng.integers(0, 256, (1, r, k), dtype=np.uint8),
                 rng.integers(0, 256, (2, r, k), dtype=np.uint8)):
        got = gf_kernel.gf_apply(torch.from_numpy(mats),
                                 torch.from_numpy(x)).numpy()
        for i in range(2):
            want = np.asarray(jgf256.bit_matmul_apply(
                jgf256.bitmat_t_for(mats[i % mats.shape[0]]), x[i][None]))[0]
            assert np.array_equal(got[i], want)


def test_wide_code_encodes_decodes_and_repairs_like_the_jax_package():
    """erasure(20,4) through the port's rs on the CPU: parity, a decode
    of 20 data rows and a repair of two lost shards equal the JAX
    package's."""
    k, m = 20, 4
    data = np.random.default_rng(20).integers(0, 256, (3, k, 80),
                                              dtype=np.uint8)
    parity = rs.encode(k, m, torch.from_numpy(data)).numpy()
    assert np.array_equal(parity, np.asarray(jrs.encode(k, m, data)))
    stripes = np.concatenate([data, parity], axis=1)
    missing = (3, 21)
    present = tuple(i for i in range(k + m) if i not in missing)[:k]
    shards = stripes[:, list(present)]
    got = rs.decode(k, m, present, torch.from_numpy(shards)).numpy()
    assert np.array_equal(got, data)
    assert np.array_equal(got, np.asarray(jrs.decode(k, m, present, shards)))
    got = rs.repair(k, m, present, missing, torch.from_numpy(shards)).numpy()
    assert np.array_equal(got, stripes[:, list(missing)])
    assert np.array_equal(got, np.asarray(jrs.repair(k, m, present, missing,
                                                     shards)))
