"""The port's SHA-256 module (garage_tpu_torch.ops.sha256, kernel S2's
plain torch version and host helpers) against the JAX package's
ops/sha256.py (hash_rows jitted on the CPU) and hashlib, at zero
tolerance: digests are bytes."""

from __future__ import annotations

import hashlib
import time

import numpy as np
import pytest
import torch

from garage_tpu.ops import sha256 as jsha
from garage_tpu_torch.ops import sha256 as tsha

# tier-1 runs several pytest workers per machine: one torch thread each
torch.set_num_threads(1)

EDGES = [0, 1, 55, 56, 63, 64, 65, 119, 120]


def _msgs(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in lengths]


def _port_rows(msgs):
    """Rows as the port's backend stages them: one group, width = the
    longest message's padded length."""
    nbs = np.array([tsha.n_blocks_for(tsha.part_len(m)) for m in msgs],
                   dtype=np.int32)
    rows = np.zeros((len(msgs), int(nbs.max()) * tsha.BLOCK), np.uint8)
    for i, m in enumerate(msgs):
        assert tsha.pad_row_into(rows[i], m) == nbs[i]
    return rows, nbs


def _port_hex(msgs):
    rows, nbs = _port_rows(msgs)
    out = tsha.hash_rows(torch.from_numpy(rows), torch.from_numpy(nbs))
    return [r.tobytes().hex() for r in out.numpy()]


def _jax_hex(msgs):
    """The JAX package's device route: rows padded to its block bucket,
    hash_fn(bucket) on the CPU platform."""
    nbs = np.array([jsha.n_blocks_for(jsha.part_len(m)) for m in msgs],
                   dtype=np.int32)
    npad = jsha.blocks_bucket(int(nbs.max()))
    rows = np.zeros((len(msgs), npad * jsha.BLOCK), np.uint8)
    for i, m in enumerate(msgs):
        jsha.pad_row_into(rows[i], m)
    return jsha.digests_to_hex(jsha.hash_fn(npad)(rows, nbs))


@pytest.mark.parametrize("lengths", [
    EDGES,                     # every padding edge, an odd batch of 9
    [1000, 5, 4096, 130],      # rows of different block counts, one group
    [8192],                    # one row, 129 blocks
], ids=["edges", "mixed", "8k"])
def test_plain_matches_reference_and_hashlib(lengths):
    msgs = _msgs(lengths, seed=len(lengths) * 7 + lengths[0])
    got = _port_hex(msgs)
    assert got == [hashlib.sha256(m).hexdigest() for m in msgs]
    assert got == _jax_hex(msgs)


@pytest.mark.parametrize("lengths", [
    EDGES, [1000, 5, 4096, 130], [8192],
], ids=["edges", "mixed", "8k"])
def test_tensor_formulation_matches_reference_and_hashlib(lengths,
                                                          monkeypatch):
    """The tensor formulation (what a CUDA tensor or a wide CPU batch
    takes) on the same rows, with the integer route switched off."""
    monkeypatch.setattr(tsha, "_INT_ROUTE_ROWS", 0)
    msgs = _msgs(lengths, seed=len(lengths) * 7 + lengths[0])
    got = _port_hex(msgs)
    assert got == [hashlib.sha256(m).hexdigest() for m in msgs]
    assert got == _jax_hex(msgs)


@pytest.mark.parametrize("nblocks", [1, 1025, 3126])
def test_plain_long_rows_match_reference_and_hashlib(nblocks):
    """One row of 1, 1,025 (64 KiB) and 3,126 (a 200,000-byte aws-chunk)
    blocks, alone and at both padding edges of that block count."""
    lengths = [max((nblocks - 1) * tsha.BLOCK - 8, 0),   # shortest
               nblocks * tsha.BLOCK - 9]                 # longest
    msgs = _msgs(lengths, seed=nblocks)
    for m in msgs:
        assert tsha.n_blocks_for(len(m)) == nblocks
        got = _port_hex([m])
        assert got == [hashlib.sha256(m).hexdigest()]
        assert got == _jax_hex([m])


def test_plain_64k_row_is_fast_on_the_cpu():
    """A --device cpu node hashes every signed 64 KiB chunk with the
    plain version; at ~7 s a chunk a 350 KB body timed out at the S3
    client's 30 s, so one 64 KiB row must take well under a second."""
    msg = _msgs([65536], seed=11)[0]
    rows, nbs = _port_rows([msg])
    rows_t, nbs_t = torch.from_numpy(rows), torch.from_numpy(nbs)
    t0 = time.perf_counter()
    out = tsha.hash_rows_plain(rows_t, nbs_t)
    elapsed = time.perf_counter() - t0
    assert out.numpy()[0].tobytes() == hashlib.sha256(msg).digest()
    assert elapsed < 3.0, f"{elapsed:.2f} s for one 64 KiB row"


def test_span_list_messages():
    """A chunk handed over as the spans it landed in (the zero-copy
    aws-chunked path) hashes as one message."""
    whole = _msgs([3000], seed=3)[0]
    spans = [memoryview(whole)[:1], memoryview(whole)[1:1500],
             memoryview(whole)[1500:]]
    msgs = [spans, (whole[:64], whole[64:]), whole[:56]]
    got = _port_hex(msgs)
    want = [hashlib.sha256(whole).hexdigest()] * 2 + [
        hashlib.sha256(whole[:56]).hexdigest()]
    assert got == want
    assert got == _jax_hex(msgs)
    assert [tsha.sha256_hex_py(m) for m in msgs] == want


@pytest.mark.parametrize("n", EDGES + [1000])
def test_host_helpers_match_reference(n):
    msg = _msgs([n], seed=n)[0]
    assert tsha.n_blocks_for(n) == jsha.n_blocks_for(n)
    assert tsha.part_len([msg[:3], msg[3:]]) == jsha.part_len(msg) == n
    width = tsha.n_blocks_for(n) * tsha.BLOCK
    a, b = np.zeros(width, np.uint8), np.zeros(width, np.uint8)
    assert tsha.pad_row_into(a, msg) == jsha.pad_row_into(b, msg)
    assert np.array_equal(a, b)
    words = np.random.default_rng(n).integers(0, 1 << 32, (3, 8),
                                              dtype=np.uint64)
    assert tsha.digests_to_hex(words.astype(np.uint32)) == \
        jsha.digests_to_hex(words.astype(np.uint32))


def test_bytes_past_a_rows_blocks_are_not_read():
    """The group's shorter rows carry garbage past their own blocks: the
    digest depends only on the row's active blocks."""
    msgs = _msgs([10, 300], seed=5)
    rows, nbs = _port_rows(msgs)
    rows[0, nbs[0] * tsha.BLOCK:] = 0xA5
    out = tsha.hash_rows(torch.from_numpy(rows), torch.from_numpy(nbs))
    assert [r.tobytes().hex() for r in out.numpy()] == \
        [hashlib.sha256(m).hexdigest() for m in msgs]


def test_cpu_route_counts_no_launch_and_shapes_are_checked():
    before = tsha.launches["sha256_rows"]
    _port_hex(_msgs([100], seed=1))
    assert tsha.launches["sha256_rows"] == before
    with pytest.raises(ValueError):
        tsha.hash_rows(torch.zeros((2, 100), dtype=torch.uint8),
                       torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsha.hash_rows(torch.zeros((2, 64), dtype=torch.int32),
                       torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsha.hash_rows(torch.zeros((2, 64), dtype=torch.uint8),
                       torch.ones(3, dtype=torch.int32))
