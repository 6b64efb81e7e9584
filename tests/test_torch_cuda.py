"""The port's CUDA kernels (G1 gf_apply, G2 gf_check, B3 blake3_rows,
S2 sha256_rows) against their plain torch versions and the numpy/Python oracles, on
the card. Skipped where there is no CUDA device; run on a GPU machine
with `python -m pytest tests/test_torch_cuda.py -m cuda`."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from garage_tpu_torch import native
from garage_tpu_torch.ops import gf_kernel, rs, sha256, treehash

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _data(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("s", [16, 4096, 16 * 1100, 104858])
def test_gf_apply_encode_matches_plain(dev, s):
    k, m = 10, 4
    x = torch.from_numpy(_data(s, (3, k, s)))
    want = rs.encode(k, m, x).numpy()  # CPU: plain torch
    before = gf_kernel.launches["gf_apply"]
    got = rs.encode(k, m, x.to(dev)).cpu().numpy()
    assert gf_kernel.launches["gf_apply"] == before + 1
    assert np.array_equal(got, want)


def test_gf_apply_mixed_patterns_matches_plain(dev):
    k, m = 10, 4
    rng = np.random.default_rng(1)
    pats = [tuple(sorted(rng.choice(k + m, k, replace=False)))
            for _ in range(5)]
    mats = torch.from_numpy(np.stack([rs.decode_matrix(k, m, p)
                                      for p in pats]))
    x = torch.from_numpy(_data(2, (5, k, 4096)))
    want = gf_kernel.gf_apply_plain(mats, x).numpy()
    got = gf_kernel.gf_apply(mats.to(dev), x.to(dev)).cpu().numpy()
    assert np.array_equal(got, want)


def test_gf_check_flags_exactly_the_corrupt_stripes(dev):
    k, m = 10, 4
    data = _data(3, (4, k, 8192))
    par = np.stack([rs.encode_np(k, m, d) for d in data])
    st = np.concatenate([data, par], axis=1)
    st[2, 11, 4000] ^= 0x80
    got = rs.parity_check(k, m, torch.from_numpy(st).to(dev)).cpu()
    assert got.tolist() == [True, True, False, True]


@pytest.mark.parametrize("lengths", [[0, 1, 1023, 1024], [1025, 2048],
                                     [3 * 1024 + 1, 4096], [1 << 20] * 2])
def test_blake3_rows_matches_oracle(dev, lengths):
    c = max(1, -(-max(lengths) // 1024))
    msgs = np.zeros((len(lengths), c * 1024), dtype=np.uint8)
    for i, n in enumerate(lengths):
        msgs[i, :n] = _data(n, n)
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = treehash.hash_rows(torch.from_numpy(msgs).to(dev),
                             lens.to(dev)).cpu().numpy()
    want = treehash.hash_rows(torch.from_numpy(msgs), lens).numpy()
    assert np.array_equal(got, want)  # the plain torch version
    for i, n in enumerate(lengths[:4]):
        if n <= 4096:  # the pure-Python oracle, where it is quick
            assert got[i].tobytes() == treehash.blake3_py(
                msgs[i, :n].tobytes())


@pytest.mark.parametrize("lengths", [[0, 1, 55, 56, 63, 64, 65, 119, 120],
                                     [8192, 100, 4095],
                                     [65536] * 3])
def test_sha256_rows_matches_plain_and_hashlib(dev, lengths):
    msgs = [_data(n + 7, n).tobytes() for n in lengths]
    nbs = np.array([sha256.n_blocks_for(len(m)) for m in msgs], np.int32)
    rows = np.zeros((len(msgs), int(nbs.max()) * sha256.BLOCK), np.uint8)
    for i, m in enumerate(msgs):
        sha256.pad_row_into(rows[i], m)
    before = sha256.launches["sha256_rows"]
    got = sha256.hash_rows(torch.from_numpy(rows).to(dev),
                           torch.from_numpy(nbs).to(dev)).cpu().numpy()
    assert sha256.launches["sha256_rows"] == before + 1
    for i, m in enumerate(msgs):
        assert got[i].tobytes() == hashlib.sha256(m).digest()
    if max(lengths) <= 8192:  # the plain torch version, where it is quick
        want = sha256.hash_rows(torch.from_numpy(rows),
                                torch.from_numpy(nbs)).numpy()
        assert np.array_equal(got, want)


# --- S2 (warp-specialised) and G1 (tensor cores): shapes of the redesign


def _sha_rows(msgs, width=None, fill=0):
    nbs = np.array([sha256.n_blocks_for(len(m)) for m in msgs], np.int32)
    width = width or int(nbs.max()) * sha256.BLOCK
    rows = np.full((len(msgs), width), fill, np.uint8)
    for i, m in enumerate(msgs):
        rows[i, :int(nbs[i]) * sha256.BLOCK] = 0
        sha256.pad_row_into(rows[i], m)
    return rows, nbs


@pytest.mark.parametrize("b", [1, 8, 31, 32, 33, 256, 300])
def test_sha256_rows_mixed_block_counts(dev, b):
    """Rows of 1, 2, 17 and 1,025 blocks in one launch, so a consumer
    warp's lanes finish at different blocks, and (B > 32) CTAs of
    different lengths."""
    rng = np.random.default_rng(b)
    sizes = [0, 64, 1024, 65536]  # 1, 2, 17, 1025 blocks
    lens = [sizes[int(i)] + int(rng.integers(0, 8))
            for i in rng.integers(0, 4, b)]
    lens = [min(n, 65536) for n in lens]
    msgs = [_data(1000 + i, n).tobytes() for i, n in enumerate(lens)]
    rows, nbs = _sha_rows(msgs)
    got = sha256.hash_rows(torch.from_numpy(rows).to(dev),
                           torch.from_numpy(nbs).to(dev)).cpu().numpy()
    for i, m in enumerate(msgs):
        assert got[i].tobytes() == hashlib.sha256(m).digest(), i
    small = [i for i, n in enumerate(lens) if n <= 1024][:8]
    if small:  # the plain torch version, on rows short enough for it
        sub, nsub = _sha_rows([msgs[i] for i in small])
        want = sha256.hash_rows(torch.from_numpy(sub),
                                torch.from_numpy(nsub)).numpy()
        assert np.array_equal(got[small], want)


def test_sha256_rows_wider_buffer_than_blocks(dev):
    """Bytes past a row's blocks (here 0xFF) are never read."""
    msgs = [_data(77 + n, n).tobytes() for n in (3, 100, 1000)]
    rows, nbs = _sha_rows(msgs, width=64 * 64, fill=0xFF)
    got = sha256.hash_rows(torch.from_numpy(rows).to(dev),
                           torch.from_numpy(nbs).to(dev)).cpu().numpy()
    want = sha256.hash_rows(torch.from_numpy(rows),
                            torch.from_numpy(nbs)).numpy()
    assert np.array_equal(got, want)
    for i, m in enumerate(msgs):
        assert got[i].tobytes() == hashlib.sha256(m).digest()


@pytest.mark.parametrize("b", [1, 8, 256])
@pytest.mark.parametrize("s", [16, 4096, 2048 * 3 + 48])
@pytest.mark.parametrize("k,r", [(1, 1), (16, 1), (1, 16), (16, 16), (10, 4)])
def test_gf_apply_shapes_broadcast_and_per_item(dev, b, s, k, r):
    rng = np.random.default_rng(b * 7 + s + k * 31 + r)
    x = rng.integers(0, 256, (b, k, s), dtype=np.uint8)
    one = rng.integers(0, 256, (1, r, k), dtype=np.uint8)
    per = rng.integers(0, 256, (b, r, k), dtype=np.uint8)
    xt = torch.from_numpy(x)
    for mats in (one, per):
        mt = torch.from_numpy(mats)
        got = gf_kernel.gf_apply(mt.to(dev), xt.to(dev)).cpu().numpy()
        want = gf_kernel.gf_apply_plain(mt, xt).numpy()
        assert np.array_equal(got, want)
        for i in (0, b - 1):
            assert np.array_equal(got[i], native.gf_matmul(
                mats[i % mats.shape[0]], x[i]))


def test_gf_apply_every_rs42_pattern_and_mixed_rs104(dev):
    """Every RS(4,2) decode pattern, then 40 mixed RS(10,4) decode and
    repair patterns, each in one launch."""
    import itertools

    x = _data(5, (15, 4, 4096))
    pats = list(itertools.combinations(range(6), 4))
    mats = np.stack([rs.decode_matrix(4, 2, p) for p in pats])
    got = gf_kernel.gf_apply(torch.from_numpy(mats).to(dev),
                             torch.from_numpy(x).to(dev)).cpu().numpy()
    for i in range(len(pats)):
        assert np.array_equal(got[i], native.gf_matmul(mats[i], x[i]))
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (40, 10, 104864), dtype=np.uint8)
    erased = [tuple(sorted(rng.choice(14, 4, replace=False)))
              for _ in range(40)]
    present = [tuple(i for i in range(14) if i not in e) for e in erased]
    for mats in (np.stack([rs.decode_matrix(10, 4, p) for p in present]),
                 np.stack([rs.repair_matrix(10, 4, p, e)
                           for p, e in zip(present, erased)])):
        mt, xt = torch.from_numpy(mats), torch.from_numpy(x)
        got = gf_kernel.gf_apply(mt.to(dev), xt.to(dev)).cpu().numpy()
        assert np.array_equal(got, gf_kernel.gf_apply_plain(mt, xt).numpy())
        for i in (0, 17, 39):
            assert np.array_equal(got[i], native.gf_matmul(mats[i], x[i]))


@pytest.mark.parametrize("k,r", [(17, 4), (20, 20), (33, 1), (50, 16),
                                 (4, 17), (40, 40)])
def test_gf_apply_maps_wider_than_one_launch(dev, k, r):
    """Maps past one launch's 16 x 16 run as launches over 16-row slices
    of input and output, the slices along k XORed into the output;
    broadcast and per-item matrices, S not a tile multiple."""
    rng = np.random.default_rng(k * 5 + r)
    x = rng.integers(0, 256, (8, k, 2048 + 48), dtype=np.uint8)
    xt = torch.from_numpy(x)
    for mats in (rng.integers(0, 256, (1, r, k), dtype=np.uint8),
                 rng.integers(0, 256, (8, r, k), dtype=np.uint8)):
        mt = torch.from_numpy(mats)
        before = gf_kernel.launches["gf_apply"]
        got = gf_kernel.gf_apply(mt.to(dev), xt.to(dev)).cpu().numpy()
        assert gf_kernel.launches["gf_apply"] - before == \
            -(-k // 16) * -(-r // 16)
        assert np.array_equal(got, gf_kernel.gf_apply_plain(mt, xt).numpy())
        for i in (0, 7):
            assert np.array_equal(got[i], native.gf_matmul(
                mats[i % mats.shape[0]], x[i]))


@pytest.mark.parametrize("b,r,tile", [(8, 4, 2048), (8, 10, 2048),
                                      (256, 4, 2048), (256, 10, 2048),
                                      (1, 4, 256)])
def test_g1_plan_at_the_path_shapes(dev, b, r, tile):
    """The library's planner on the card, RS(10,4) shards of a 1 MiB
    block: 2 KiB tiles fill every SM at the PUT batch of 8 and stay
    within the CTAs the registers allow at 256; one stripe is too few
    units for any tile but the smallest."""
    s = 104864
    got_tile, grid, units, smem = gf_kernel.g1_plan(b, 10, r, s, dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert got_tile == tile
    assert units == b * -(-s // tile)
    assert 1 <= grid <= min(units, 16 * n_sm)
    assert smem >= 2 * 10 * tile
    x = torch.zeros((b, 10, s), dtype=torch.uint8, device=dev)
    gf_kernel.gf_apply(torch.zeros((1, r, 10), dtype=torch.uint8,
                                   device=dev), x)
    assert gf_kernel.last_plan == {"b": b, "k": 10, "r": r, "s": s,
                                   "tile": tile, "grid": grid,
                                   "units": units, "smem": smem}


def test_sha256_chain_cycles_is_measured(dev):
    c = sha256.chain_cycles(dev)
    assert 3 <= c < 200


# --- B3 (one fused launch) and G2 (tensor-core syndrome): the redesign


def _b3_rows(rng, b, c):
    """b rows of c chunks: ragged lengths ending mid-chunk, on a chunk
    boundary and one byte into the last chunk; every fourth row a
    full-length zero pad row."""
    lens = []
    for i in range(b):
        lo = (c - 1) * 1024
        lens.append([c * 1024, lo + 1, lo + 1 + int(rng.integers(0, 1023)),
                     c * 1024][i % 4])
    msgs = np.zeros((b, c * 1024), np.uint8)
    for i, n in enumerate(lens):
        if i % 4 != 3:
            msgs[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return msgs, lens


@pytest.mark.parametrize("b", [1, 8, 33, 256])
def test_blake3_rows_every_chunk_count(dev, b):
    """C = 1..70, 1024 and 1025 (blocks of 32-128 chunks: partial blocks,
    C = 33 just past a block of 32, more than 32 block roots at 1025 in
    one row): one launch per call, byte-equal to native BLAKE3 and to
    the plain torch version on the card."""
    rng = np.random.default_rng(b)
    for c in list(range(1, 71)) + [1024, 1025]:
        msgs, lens = _b3_rows(rng, b, c)
        m_t = torch.from_numpy(msgs).to(dev)
        l_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        before = treehash.launches["blake3_rows"]
        got = treehash.hash_rows(m_t, l_t)
        assert treehash.launches["blake3_rows"] == before + 1
        got_np = got.cpu().numpy()
        want = native.blake3_many([msgs[i, :n].tobytes()
                                   for i, n in enumerate(lens)])
        for i in range(b):
            assert got_np[i].tobytes() == want[i], (c, i, lens[i])
        assert torch.equal(got, treehash.hash_rows_plain(m_t, l_t)), c


def test_blake3_back_to_back_launches_on_different_data(dev):
    """The row counters come back to zero after every launch: calls of
    different shapes and data, one after the other on one stream, are
    all right."""
    rng = np.random.default_rng(11)
    shapes = [(8, 1024), (33, 65), (8, 1024), (1, 1025), (256, 40), (3, 33)]
    for b, c in shapes + shapes[::-1]:
        msgs, lens = _b3_rows(rng, b, c)
        got = treehash.hash_rows(
            torch.from_numpy(msgs).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev)).cpu().numpy()
        want = native.blake3_many([msgs[i, :n].tobytes()
                                   for i, n in enumerate(lens)])
        assert [got[i].tobytes() for i in range(b)] == want, (b, c)


@pytest.mark.parametrize("b,c,wpc,ctas,small", [
    (8, 1024, 2, 128, 1), (1, 1024, 1, 32, 1), (256, 1024, 4, 2048, 0),
    (1, 1, 1, 1, 1), (3, 33, 1, 6, 1), (256, 70, 4, 256, 0),
    (16, 1024, 4, 128, 1), (17, 1024, 4, 136, 0)])
def test_b3_plan_at_the_path_shapes(dev, b, c, wpc, ctas, small):
    """A CTA per block of 32 chunks per warp of a row; CTAs of 1, 2 or 4
    warps spread the batch of 8 rows of 1 MiB over 128 SMs, one row over
    32; the small-batch instance while the warps fit one a scheduler."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert n_sm == 132  # the H100 SXM the expected geometry is for
    blocks = -(-c // (32 * wpc))
    assert treehash.b3_plan(b, c, dev) == (wpc, ctas, blocks, small)
    treehash.hash_rows(torch.zeros((b, c * 1024), dtype=torch.uint8,
                                   device=dev),
                       torch.full((b,), c * 1024, dtype=torch.int32,
                                  device=dev))
    assert treehash.last_plan == {"b": b, "c": c, "warps_per_cta": wpc,
                                  "ctas": ctas, "blocks": blocks,
                                  "small": bool(small)}
    assert treehash.batch_sizes.get(b, 0) >= 1


def test_blake3_chain_cycles_is_measured(dev):
    c = treehash.chain_cycles(dev)
    assert 12 <= c < 400  # 12 dependent instructions a G step


def _stripes_with_planted(k, m, s, seed):
    """k + m + 1 intact RS(k, m) stripes of s bytes; stripe i < k + m gets
    one corrupt byte in row i, at its first byte, its last, or one in
    its last 16 in turn; the last stripe stays intact."""
    rng = np.random.default_rng(seed)
    n = k + m
    data = rng.integers(0, 256, (n + 1, k, s), dtype=np.uint8)
    pmat = rs.parity_matrix(k, m)
    par = np.stack([native.gf_matmul(pmat, d) for d in data])
    st = np.concatenate([data, par], axis=1)
    for i in range(n):
        pos = [0, s - 1, s - 1 - int(rng.integers(1, 16))][i % 3]
        st[i, i, pos] ^= 1 << int(rng.integers(8))
    return st


@pytest.mark.parametrize("k,m", [(10, 4), (4, 2), (1, 17), (17, 1), (51, 16),
                                 (240, 16), (20, 20), (1, 1), (12, 3)])
@pytest.mark.parametrize("s", [48, 4096 + 32])
def test_gf_check_flags_one_corrupt_byte_in_any_row(dev, k, m, s):
    """Every code with k + m <= 256 is checked; a one-byte corruption in
    any row (first byte, last byte, the last 16 bytes) flips exactly its
    stripe's flag, and a clean stripe never flips; equal to the plain
    version on the CPU."""
    st = _stripes_with_planted(k, m, s, seed=k * 1000 + m + s)
    n = k + m
    before = gf_kernel.launches["gf_check"]
    got = rs.parity_check(k, m, torch.from_numpy(st).to(dev)).cpu()
    rows = gf_kernel.g2_plan(n + 1, k, m, -(-s // 16) * 16, dev)[0]
    assert gf_kernel.launches["gf_check"] - before == -(-m // rows)
    assert got.tolist() == [False] * n + [True]
    if s < 64:  # the plain version on the CPU, where it is quick
        assert torch.equal(got, rs.parity_check(k, m, torch.from_numpy(st)))


def test_gf_check_per_item_matrices_and_back_to_back(dev):
    """Per-item parity maps (one wrong for stripe 1), then a second
    launch on other data: the flags are each call's own."""
    k, m, s = 10, 4, 104864
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (6, k, s), dtype=np.uint8)
    mats = np.stack([rs.parity_matrix(k, m)] * 6)
    st = np.concatenate([data, np.stack([rs.encode_np(k, m, d)
                                         for d in data])], axis=1)
    mats[1, 2, 3] ^= 1
    ok = gf_kernel.gf_check(torch.from_numpy(mats).to(dev),
                            torch.from_numpy(st).to(dev)).cpu().tolist()
    assert ok == [True, False, True, True, True, True]
    st[4, k + 3, s // 2] ^= 0x20
    ok = rs.parity_check(k, m, torch.from_numpy(st).to(dev)).cpu().tolist()
    assert ok == [True, True, True, True, False, True]


@pytest.mark.parametrize("shape", [(0, 14, 4096), (3, 14, 0)])
def test_gf_check_empty_batch_or_width(dev, shape):
    """No stripes, or stripes of no bytes: nothing to check, every stripe
    intact, no error."""
    st = torch.zeros(shape, dtype=torch.uint8, device=dev)
    assert rs.parity_check(10, 4, st).cpu().tolist() == [True] * shape[0]


@pytest.mark.parametrize("b", [8, 256])
def test_g2_plan_rs104_is_one_launch(dev, b):
    s = 104864
    rows, tile, grid, units, smem = gf_kernel.g2_plan(b, 10, 4, s, dev)
    assert rows == 4
    assert units == b * -(-s // tile)
    assert 1 <= grid <= units
    assert smem >= 2 * 14 * tile
