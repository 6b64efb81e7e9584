"""The port's CUDA kernels (G1 gf_apply, G2 gf_check, B3 blake3_rows)
against their plain torch versions and the numpy/Python oracles, on
the card. Skipped where there is no CUDA device; run on a GPU machine
with `python -m pytest tests/test_torch_cuda.py -m cuda`."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from garage_tpu_torch.ops import gf_kernel, rs, treehash

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
