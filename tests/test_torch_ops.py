"""The port's ops (garage_tpu_torch.ops) against the JAX package, on the
CPU, at zero tolerance: every output is bytes.

The same inputs, made from a numpy seed, go through the JAX functions
(XLA on the CPU; the Pallas kernel in interpret mode, as the JAX
package's own tests run it) and through the port's counterparts, whose
CPU route is each kernel's plain torch version; the reference operands
(bit-expanded matrices) reach the port through weights.from_reference.
"""

from __future__ import annotations

import hashlib
import itertools

import numpy as np
import pytest
import torch

from garage_tpu import native as jnative
from garage_tpu.ops import gf256 as jgf256
from garage_tpu.ops import pallas_gf
from garage_tpu.ops import rs as jrs
from garage_tpu.ops import treehash as jtreehash
from garage_tpu_torch import native as tnative
from garage_tpu_torch import weights
from garage_tpu_torch.ops import gf256, gf_kernel, rs, treehash

# tier-1 runs several pytest workers per machine: one torch thread each
torch.set_num_threads(1)

CPU = "cpu"


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _data(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# G1 plain formulation: the bit-matrix helpers against the JAX ones
# ---------------------------------------------------------------------------


def test_unpack_pack_bits_match_jax():
    x = _data(1, (2, 3, 40))
    got = gf256.unpack_bits(_t(x)).numpy()
    want = np.asarray(jgf256.unpack_bits(x))
    assert np.array_equal(got.astype(np.int8), want)
    assert np.array_equal(gf256.pack_bits(_t(want.astype(np.int32)), 3)
                          .numpy().reshape(-1),
                          np.asarray(jgf256.pack_bits(want, 3)).reshape(-1))


def test_bit_matmul_apply_matches_jax():
    k, m = 10, 4
    bitmat_t = jgf256.bitmat_t_for(jrs.parity_matrix(k, m))
    x = _data(2, (3, k, 96))
    want = np.asarray(jgf256.bit_matmul_apply(bitmat_t, x))
    got = gf256.bit_matmul_apply(_t(bitmat_t), _t(x)).numpy()
    assert np.array_equal(got, want)


def test_expand_bits_t_matches_bitmat_t_for():
    mats = np.stack([jrs.decode_matrix(4, 2, p)
                     for p in [(0, 1, 2, 4), (1, 3, 4, 5), (2, 3, 4, 5)]])
    got = gf256.expand_bits_t(_t(mats)).numpy()
    want = np.stack([jgf256.bitmat_t_for(a) for a in mats])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["bitmat_t", "mat_bits_jk"])
def test_from_reference_recovers_coefficients(name):
    k, m = 10, 4
    pm = jrs.parity_matrix(k, m)
    arr = (jgf256.bitmat_t_for(pm) if name == "bitmat_t"
           else pallas_gf._mat_bits_jk(pm.tobytes(), m, k))
    got = weights.from_reference(k, m, {name: arr}, device=CPU)[name]
    assert np.array_equal(got.numpy(), pm)


def test_pattern_bit_matrices_match_reference():
    """The port's copies of the matrix builders agree with the JAX
    package's, for every RS(4,2) present-set and a repair pattern."""
    for present in itertools.combinations(range(6), 4):
        assert np.array_equal(rs.decode_bitmat_t(4, 2, present),
                              jrs.decode_bitmat_t(4, 2, present))
    assert np.array_equal(rs.repair_bitmat_t(10, 4, tuple(range(2, 12)),
                                             (0, 1, 12, 13)),
                          jrs.repair_bitmat_t(10, 4, tuple(range(2, 12)),
                                              (0, 1, 12, 13)))


def test_from_reference_rejects_non_expansion():
    bad = jgf256.bitmat_t_for(jrs.parity_matrix(4, 2)).copy()
    bad[3, 5] ^= 1
    with pytest.raises(ValueError):
        weights.from_reference(4, 2, {"bitmat_t": bad}, device=CPU)


def test_from_reference_requires_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        weights.from_reference(4, 2, {"x": np.zeros(4, np.uint8)})


# ---------------------------------------------------------------------------
# G1: encode / decode / repair against XLA and the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,m", [(4, 2), (10, 4)])
def test_encode_matches_xla_and_pallas(k, m):
    data = _data(10 + k, (3, k, 256))
    got = rs.encode(k, m, _t(data)).numpy()
    assert np.array_equal(got, np.asarray(jrs.encode(k, m, data)))
    assert np.array_equal(
        got, np.asarray(pallas_gf.encode(k, m, data, interpret=True)))


@pytest.mark.parametrize("present",
                         list(itertools.combinations(range(6), 4)))
def test_decode_every_rs42_pattern(present):
    k, m = 4, 2
    data = _data(20, (2, k, 256))
    full = np.concatenate([data, np.asarray(jrs.encode(k, m, data))], axis=1)
    surv = np.ascontiguousarray(full[:, list(present)])
    got = rs.decode(k, m, present, _t(surv)).numpy()
    assert np.array_equal(got, data)
    assert np.array_equal(got, np.asarray(jrs.decode(k, m, present, surv)))
    assert np.array_equal(got, np.asarray(pallas_gf.gf_apply(
        jrs.decode_matrix(k, m, present), surv, interpret=True)))


@pytest.mark.parametrize("missing", [(0,), (5,), (0, 1), (2, 5), (4, 5)])
def test_repair_matches_xla_and_pallas(missing):
    k, m = 4, 2
    data = _data(30, (2, k, 256))
    full = np.concatenate([data, np.asarray(jrs.encode(k, m, data))], axis=1)
    present = tuple(i for i in range(k + m) if i not in missing)[:k]
    surv = np.ascontiguousarray(full[:, list(present)])
    got = rs.repair(k, m, present, missing, _t(surv)).numpy()
    assert np.array_equal(got, full[:, list(missing)])
    assert np.array_equal(
        got, np.asarray(jrs.repair(k, m, present, missing, surv)))
    assert np.array_equal(got, np.asarray(pallas_gf.gf_apply(
        jrs.repair_matrix(k, m, present, missing), surv, interpret=True)))


@pytest.mark.parametrize("k,m", [(4, 2), (10, 4)])
def test_mixed_pattern_batch_matches_gf_apply_batched(k, m):
    """One batched launch, a different erasure pattern per item, the
    reference's (B, 8k, 8k) bit matrices carried over by from_reference."""
    rng = np.random.default_rng(40 + k)
    pats = [tuple(sorted(rng.choice(k + m, k, replace=False)))
            for _ in range(6)]
    x = _data(41, (len(pats), k, 128))
    bitmats = np.stack([jrs.decode_bitmat_t(k, m, p) for p in pats])
    want = np.asarray(jrs.gf_apply_batched(bitmats, x))
    ops = weights.from_reference(k, m, {"bitmat_t": bitmats, "x": x},
                                 device=CPU)
    got = rs.gf_apply_batched(ops["bitmat_t"], ops["x"]).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.stack(
        [jrs.decode_np(k, m, p, x[i]) for i, p in enumerate(pats)]))


def test_decode_sampled_rs104_patterns():
    k, m = 10, 4
    data = _data(50, (1, k, 128))
    full = np.concatenate([data, np.asarray(jrs.encode(k, m, data))], axis=1)
    rng = np.random.default_rng(51)
    for _ in range(8):
        present = tuple(sorted(rng.choice(k + m, k, replace=False)))
        surv = np.ascontiguousarray(full[:, list(present)])
        got = rs.decode(k, m, present, _t(surv)).numpy()
        assert np.array_equal(got, np.asarray(
            jrs.decode(k, m, present, surv))), present


def test_gf_apply_broadcast_equals_per_item():
    mat = jrs.parity_matrix(10, 4)
    x = _data(60, (3, 10, 48))
    one = gf_kernel.gf_apply(_t(mat[None]), _t(x)).numpy()
    per = gf_kernel.gf_apply(_t(np.stack([mat] * 3)), _t(x)).numpy()
    assert np.array_equal(one, per)


def test_gf_apply_rejects_bad_operands():
    x = torch.zeros((2, 4, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        gf_kernel.gf_apply(torch.zeros((2, 2, 3), dtype=torch.uint8), x)
    with pytest.raises(TypeError):
        gf_kernel.gf_apply(torch.zeros((1, 2, 4), dtype=torch.int32), x)
    with pytest.raises(ValueError):  # an empty map
        gf_kernel.gf_apply(torch.zeros((1, 0, 4), dtype=torch.uint8), x)


# ---------------------------------------------------------------------------
# G2: parity check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,m", [(4, 2), (10, 4)])
def test_parity_check_matches_xla(k, m):
    data = _data(70 + k, (4, k, 256))
    stripes = np.concatenate(
        [data, np.asarray(jrs.encode(k, m, data))], axis=1)
    stripes[1, 0, 17] ^= 0x40  # one corrupt data byte
    stripes[3, k + m - 1, 255] ^= 1  # one corrupt parity byte
    want = np.asarray(jrs.parity_check(k, m, stripes))
    got = rs.parity_check(k, m, _t(stripes)).numpy()
    assert want.tolist() == [True, False, True, False]
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("k,m", [(1, 17), (17, 1), (51, 16), (240, 16)])
def test_parity_check_wide_codes_match_xla(k, m):
    """Codes past 16 parity rows or k x m > 800 (G2 refused them before
    its tensor-core redesign): intact stripes, a corrupt data byte and
    a corrupt parity byte, equal to the JAX package's flags."""
    data = _data(90 + k + m, (4, k, 48))
    stripes = np.concatenate(
        [data, np.asarray(jrs.encode(k, m, data))], axis=1)
    stripes[1, k - 1, 0] ^= 0x02  # the last data row's first byte
    stripes[2, k + m - 1, 47] ^= 0x80  # the last parity row's last byte
    want = np.asarray(jrs.parity_check(k, m, stripes))
    got = rs.parity_check(k, m, _t(stripes)).numpy()
    assert want.tolist() == [True, False, False, True]
    assert got.tolist() == want.tolist()


# ---------------------------------------------------------------------------
# B3: BLAKE3 rows against the jitted JAX hash_fn
# ---------------------------------------------------------------------------


def _rows(lengths, c, seed):
    rng = np.random.default_rng(seed)
    msgs = np.zeros((len(lengths), c * 1024), dtype=np.uint8)
    for i, n in enumerate(lengths):
        msgs[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return msgs, np.asarray(lengths, dtype=np.int32)


@pytest.mark.parametrize("lengths,c", [
    ([0, 1, 1023, 1024, 1024], 1),   # last row: a pad row
    ([1025, 2048], 2),
    ([3 * 1024 + 1, 4096], 4),        # second row: a pad row
])
def test_hash_rows_matches_jax_hash_fn(lengths, c):
    msgs, lens = _rows(lengths, c, seed=80 + c)
    if c > 1:
        msgs[-1] = 0  # full-length zero message, as the backends pad
    want = np.ascontiguousarray(np.asarray(
        jtreehash.hash_fn(c)(msgs, lens)).astype("<u4")).view(np.uint8)
    got = treehash.hash_rows(_t(msgs), _t(lens)).numpy()
    assert np.array_equal(got, want.reshape(len(lengths), 32))
    for i, n in enumerate(lengths):
        assert got[i].tobytes() == treehash.blake3_py(msgs[i, :n].tobytes())


def test_hash_rows_masks_bytes_past_length():
    msgs, lens = _rows([700, 1024], 1, seed=90)
    dirty = msgs.copy()
    dirty[0, 700:] = 0xAB
    assert np.array_equal(treehash.hash_rows(_t(dirty), _t(lens)).numpy(),
                          treehash.hash_rows(_t(msgs), _t(lens)).numpy())


def test_hash_rows_rejects_ragged_rows():
    with pytest.raises(ValueError):
        treehash.hash_rows(torch.zeros((1, 1000), dtype=torch.uint8),
                           torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The port's copies of the host library agree with the JAX package's
# ---------------------------------------------------------------------------


def test_native_copies_agree():
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C toolchain for the native libraries")
    blob = _data(100, 70_001).tobytes()
    assert tnative.blake3(blob) == jnative.blake3(blob)
    assert tnative.crc32c(blob) == jnative.crc32c(blob)
    blobs = [blob[:n] for n in (0, 1, 64, 1025, 70_001)]
    assert tnative.blake3_many(blobs) == jnative.blake3_many(blobs)
    a, b = tnative.Md5(), jnative.Md5()
    a.update(blob)
    b.update(blob)
    assert a.hexdigest() == b.hexdigest()
    # the 8-lane MD5 advance, over more objects than lanes
    ta = [tnative.Md5() for _ in range(9)]
    ja = [jnative.Md5() for _ in range(9)]
    tnative.md5_update_many([(m, blob[:100 * i]) for i, m in enumerate(ta)])
    jnative.md5_update_many([(m, blob[:100 * i]) for i, m in enumerate(ja)])
    assert [m.hexdigest() for m in ta] == [m.hexdigest() for m in ja] \
        == [hashlib.md5(blob[:100 * i]).hexdigest() for i in range(9)]
    pm = jrs.parity_matrix(10, 4)
    x = _data(101, (10, 333))
    assert np.array_equal(tnative.gf_matmul(pm, x), jnative.gf_matmul(pm, x))
