"""The kernels' designs on the CPU.

G1: its bit-matrix fragments (a host model of the kernel's
gf_build_bfrag, held against the JAX package's bitmat_t_for and
pallas_gf._mat_bits_jk), a numpy emulation of its fragment algorithm
(the mma.sync m16n8k32 lane layouts of the PTX ISA, the nibble unpack
and the quad epilogue) against the JAX package's GF(2^8) apply, and
codes wider than one launch's 16 input rows.

B3: a Python model of the fused schedule (blocks of G chunks merged
level by level, block roots merged by the row's last CTA, in place and
then by shuffles, ROOT on the last parent) over the chunks' chaining
values, against blake3_py and the JAX package's hash_fn.

G2: a host model of the syndrome's [A | I] B fragments against the JAX
package's bitmat_t_for, and a numpy emulation of the check (bit planes
in the mma's K order, sums across 16-row slices, the OR of the output
bits) against the JAX package's rs.parity_check."""

from __future__ import annotations

import functools
import itertools

import numpy as np
import pytest
import torch

from garage_tpu.ops import gf256 as jgf256
from garage_tpu.ops import pallas_gf as jpallas
from garage_tpu.ops import rs as jrs
from garage_tpu.ops import treehash as jtreehash
from garage_tpu_torch.ops import gf_kernel, rs, treehash

def _rows_per_frag(k: int) -> int:
    """Output rows one G1 B fragment carries (G1_ROWS_PER_FRAG in
    csrc/gf256.cu): two, at bits 0 and 7 of each byte, while a row's sum
    stays below 2^7 (8k <= 96 input bits), else one."""
    return 2 if k <= 12 else 1


def mma_b_fragments(mat: np.ndarray) -> np.ndarray:
    """G1's B operand as the kernel builds it in shared memory
    (gf_build_bfrag), (r, k) u8 coefficients -> (ceil(r / RB), KS, 32,
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


# --- B3: the fused schedule of csrc/blake3.cu


def _warp_merge(nodes, lanes, root):
    """warp_merge: node i in lane i, __shfl_down_sync by 1, 2, 4, ...;
    lane l merges when it is a left node with a right neighbour."""
    cnt = len(nodes)
    regs = list(nodes) + [list(treehash.IV)] * (lanes - cnt)
    step = 1
    while cnt > 1:
        right = [regs[i + step] if i + step < lanes else regs[i]
                 for i in range(lanes)]
        for i in range(lanes):
            if i % (2 * step) == 0 and i // step + 1 < cnt:
                regs[i] = treehash._parent_cv_py(regs[i], right[i],
                                                 root and cnt == 2)
        cnt = (cnt + 1) // 2
        step *= 2
    return regs[0]


def _cta_merge(nodes, root):
    """cta_merge: thread t makes parent t of each level, the thread
    after the last pair carries an odd tail up."""
    cur = list(nodes)
    while len(cur) > 1:
        cnt, pairs = len(cur), len(cur) // 2
        nxt = [treehash._parent_cv_py(cur[2 * t], cur[2 * t + 1],
                                      root and cnt == 2)
               for t in range(pairs)]
        cur = nxt + cur[2 * pairs:]
    return cur[0]


def b3_fused(cvs, per, lanes=32):
    """The digest B3 computes from a row's chunk chaining values: blocks
    of `per` chunks (one CTA each) merged in shared memory, then the
    row's last CTA merges the block roots (while more than `lanes`
    remain, in place in the workspace, `lanes` pairs a pass, each pass
    reading before it writes; then by shuffles), ROOT on the last
    parent."""
    blocks = -(-len(cvs) // per)
    roots = [_cta_merge(cvs[j * per:(j + 1) * per], blocks == 1)
             for j in range(blocks)]
    if blocks == 1:
        words = roots[0]
    else:
        level, cnt = list(roots), blocks
        while cnt > lanes:
            pairs = cnt // 2
            for p0 in range(0, pairs, lanes):
                ps = range(p0, min(p0 + lanes, pairs))
                reads = [(level[2 * p], level[2 * p + 1]) for p in ps]
                for p, (left, right) in zip(ps, reads):
                    level[p] = treehash._parent_cv_py(left, right, False)
            if cnt % 2:
                level[pairs] = level[cnt - 1]
            cnt = pairs + cnt % 2
        words = _warp_merge(level[:cnt], lanes, True)
    return b"".join(w.to_bytes(4, "little") for w in words)


B3_CHUNK_COUNTS = [1, 2, 3, 4, 5, 31, 32, 33, 63, 64, 65, 70]


@functools.lru_cache(maxsize=None)
def _b3_rows(c):
    """Two rows of c chunks (one ending mid-chunk, one full), their
    chunks' chaining values, and the JAX package's hash_fn digests."""
    rng = np.random.default_rng(500 + c)
    lens = [max(1, c * 1024 - 300), c * 1024]
    msgs = np.zeros((2, c * 1024), np.uint8)
    for i, n in enumerate(lens):
        msgs[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    cvs = [[treehash._chunk_cv_py(msgs[i, 1024 * j:min(n, 1024 * (j + 1))]
                                  .tobytes(), j, c == 1) for j in range(c)]
           for i, n in enumerate(lens)]
    want = np.ascontiguousarray(np.asarray(jtreehash.hash_fn(c)(
        msgs, np.asarray(lens, np.int32))).astype("<u4")).view(np.uint8)
    return msgs, lens, cvs, want.reshape(2, 32)


@pytest.mark.parametrize("per,lanes", [(4, 4), (32, 32), (128, 32)])
@pytest.mark.parametrize("c", B3_CHUNK_COUNTS)
def test_b3_fused_schedule_matches_blake3_and_jax(c, per, lanes):
    """Blocks of 4 (with a 4-lane final merge, so that more block roots
    than lanes take the in-place passes), 32 and 128 chunks."""
    msgs, lens, cvs, want = _b3_rows(c)
    for i, n in enumerate(lens):
        got = b3_fused(cvs[i], per, lanes)
        assert got == treehash.blake3_py(msgs[i, :n].tobytes())
        assert got == want[i].tobytes()


def test_b3_fused_schedule_past_32_block_roots():
    """1025 chunks in blocks of 32: 33 block roots, one in-place pass
    of the last CTA's warp before the shuffles."""
    rng = np.random.default_rng(7)
    cvs = [[int(w) for w in rng.integers(0, 1 << 32, 8, dtype=np.uint64)]
           for _ in range(1025)]
    want = _cta_merge(cvs, True)  # the plain level-by-level tree
    got = b3_fused(cvs, 32, 32)
    assert got == b"".join(w.to_bytes(4, "little") for w in want)


# --- G2: the syndrome [A | I] . stripe of csrc/gf256.cu


H100_SMEM_OPTIN = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin


def g2_shape(k, r):
    """g2_shape in csrc/gf256.cu: staged rows, k-steps per slice and in
    all, rows per B column, B columns."""
    n = k + r
    ks = -(-n // 4) if n <= 16 else 4
    kt = ks if n <= 16 else 4 * -(-n // 16)
    rb = 2 if n <= 15 else 1
    return n, ks, kt, rb, -(-r // rb)


def g2_rows_per_launch(k, m, optin=H100_SMEM_OPTIN):
    """gt_g1_plan(check = 1): the most syndrome rows whose staged rows
    (two stages of 256-byte tiles, 32-byte row pad) and B fragments fit
    a CTA's shared memory."""
    def smem(r):
        n, _, kt, _, nfrag = g2_shape(k, r)
        return 2 * n * (256 + 32) + nfrag * kt * 32 * 8 + 16
    rows = m
    while rows > 1 and smem(rows) > optin:
        rows -= 1
    return rows


def g2_b_fragments(amat):
    """gf_build_bfrag for G2: (r, k) coefficients -> H = [A | I_r] as
    (nfrag, kt, 32 lanes, 8 bytes): lane 4g + t of k-step ks holds, for
    input row j = 4 ks + t, byte bb = bit g of H[i][j] * 2^bb, rows rb ip
    at bit 0 and rb ip + 1 at bit 7."""
    r, k = amat.shape
    n, _, kt, rb, nfrag = g2_shape(k, r)
    h = np.concatenate([amat, np.eye(r, dtype=np.uint8)], axis=1)
    hp = np.zeros((nfrag * rb, 4 * kt), np.uint8)
    hp[:r, :n] = h
    prod = jgf256.gf_mul(hp[:, :, None],
                         (1 << np.arange(8, dtype=np.uint8))[None, None])
    out = np.zeros((nfrag, kt, 32, 8), np.uint8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        bits = (prod[:, t::4, :] >> g) & 1  # (rows, kt, 8): j = 4 ks + t
        bits = bits.reshape(nfrag, rb, kt, 8)
        for hh in range(rb):
            out[:, :, lane, :] |= (bits[:, hh] << (7 * hh)).astype(np.uint8)
    return out


def _g2_bitmatrix(frag, r, n, rb):
    """(nfrag, kt, 32, 8) fragments -> the (8r, 8n) bit matrix they hold."""
    bits = np.zeros((8 * r, 8 * n), np.uint8)
    for ip, ks, lane, b in itertools.product(
            range(frag.shape[0]), range(frag.shape[1]), range(32), range(8)):
        g, t = lane >> 2, lane & 3
        j, v = 4 * ks + t, int(frag[ip, ks, lane, b])
        for hh in range(rb):
            i = rb * ip + hh
            bit = (v >> (7 * hh)) & 1
            if i < r and j < n:
                bits[8 * i + g, 8 * j + b] = bit
            else:
                assert bit == 0
    return bits


G2_CODES = [(10, 4), (4, 2), (1, 17), (17, 1), (51, 16), (240, 16)]


def _g2_launches(k, m):
    rows = g2_rows_per_launch(k, m)
    return [(off, min(rows, m - off)) for off in range(0, m, rows)]


@pytest.mark.parametrize("k,m", G2_CODES + [(12, 3), (1, 255)])
def test_g2_b_fragments_hold_the_jax_bit_matrix_of_a_beside_i(k, m):
    """Each launch's B operand is the bit matrix of [A_rows | I]: the
    identity lands on the K positions of the parity rows staged after
    the k data rows."""
    amat = rs.parity_matrix(k, m)
    launches = _g2_launches(k, m)
    assert launches[0][1] == {(240, 16): 5, (1, 255): 49}.get((k, m), m)
    for off, r in launches:
        n, _, kt, rb, nfrag = g2_shape(k, r)
        sub = amat[off:off + r]
        frag = g2_b_fragments(sub)
        assert frag.shape == (nfrag, kt, 32, 8)
        h = np.concatenate([sub, np.eye(r, dtype=np.uint8)], axis=1)
        assert np.array_equal(_g2_bitmatrix(frag, r, n, rb).T,
                              jgf256.bitmat_t_for(h))


def _unpack_k_order(rows, kt):
    """(n, S) staged bytes -> (S, 32 kt) 0/1 in the mma's K order: k-step
    ks, K = 4t + bb is bit bb of row 4 ks + t, K = 16 + 4t + bb bit 4 +
    bb (rows past n are zero)."""
    n, s = rows.shape
    padded = np.zeros((4 * kt, s), np.uint8)
    padded[:n] = rows
    bits = (padded[:, :, None] >> np.arange(8)) & 1  # (rows, S, 8)
    bits = bits.reshape(kt, 4, s, 8)  # ks, t, pos, bit
    lo = bits[..., :4].transpose(2, 0, 1, 3).reshape(s, kt, 16)
    hi = bits[..., 4:].transpose(2, 0, 1, 3).reshape(s, kt, 16)
    return np.concatenate([lo, hi], axis=2).reshape(s, 32 * kt)


def _b_k_order(frag):
    """(nfrag, kt, 32, 8) fragments -> (nfrag, 32 kt, 8) B matrices in
    the same K order (lane 4g + t, byte bb -> K = 4t + bb, N = g; byte 4
    + bb -> K = 16 + 4t + bb)."""
    nfrag, kt = frag.shape[:2]
    out = np.zeros((nfrag, kt, 32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for bb in range(4):
            out[:, :, 4 * t + bb, g] = frag[:, :, lane, bb]
            out[:, :, 16 + 4 * t + bb, g] = frag[:, :, lane, 4 + bb]
    return out.reshape(nfrag, 32 * kt, 8)


def g2_emulate(k, m, stripes):
    """G2 on (B, k + m, S) stripes: per launch, the k data rows and its
    parity rows staged, the sums of every B column over all 16-row
    slices (as the s32 accumulators keep them), the OR of their output
    bits (bit 0, and bit 7 where a column carries two rows) -> (B,) bool,
    True where intact."""
    amat = rs.parity_matrix(k, m)
    flags = np.zeros(stripes.shape[0], bool)
    for off, r in _g2_launches(k, m):
        n, _, kt, rb, _ = g2_shape(k, r)
        bmat = _b_k_order(g2_b_fragments(amat[off:off + r]))
        mask = 0x81 if rb == 2 else 0x01
        for b, st in enumerate(stripes):
            staged = np.concatenate([st[:k], st[k + off:k + off + r]])
            sums = _unpack_k_order(staged, kt).astype(np.int64) @ bmat
            flags[b] |= bool(np.bitwise_or.reduce(sums, axis=None) & mask)
    return ~flags


@pytest.mark.parametrize("k,m", G2_CODES)
def test_g2_syndrome_emulation_matches_jax_parity_check(k, m):
    """Stripe i gets one corrupt byte in row i (first byte, last byte or
    one of the last 16 in turn); the last stripe stays intact."""
    n, s = k + m, 32
    rng = np.random.default_rng(k * 100 + m)
    data = rng.integers(0, 256, (n + 1, k, s), dtype=np.uint8)
    par = np.stack([jgf256.gf_matmul(jrs.parity_matrix(k, m), d)
                    for d in data])
    stripes = np.concatenate([data, par], axis=1)
    for i in range(n):
        pos = [0, s - 1, s - 1 - int(rng.integers(1, 16))][i % 3]
        stripes[i, i, pos] ^= 1 << int(rng.integers(8))
    want = np.asarray(jrs.parity_check(k, m, stripes))
    assert want.tolist() == [False] * n + [True]
    assert g2_emulate(k, m, stripes).tolist() == want.tolist()
