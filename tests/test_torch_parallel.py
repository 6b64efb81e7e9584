"""The port's split data-plane steps (garage_tpu_torch.parallel.mesh)
against the JAX package's (garage_tpu.parallel.mesh) on the CPU, at zero
tolerance: every output is bytes.

The JAX side runs on the 8-device virtual CPU mesh that tests/conftest.py
provides; the port's grid holds 8 `cpu` devices, so every split (dp over
stripes, tp over bytes, the whole-shard hash layout) runs its own parts
and gathers them, with each kernel's plain torch version in every cell.
The cases follow tests/test_parallel.py: RS(4,2) and RS(10,4) across
(dp, tp) in {(8,1), (4,2), (2,4)}, the shard-S fallback when tp does not
divide n, corruption through the scrub step, one repair program across
erasure patterns, and the tp errors. The feeder's grid route is held
against its one-device route for encode, parity check, decode and
repair.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from garage_tpu.ops import rs as jrs
from garage_tpu.parallel import mesh as jmesh
from garage_tpu_torch.parallel import mesh as tmesh

# tier-1 runs several pytest workers per machine: one torch thread each
torch.set_num_threads(1)

SHAPES = [(4, 2), (10, 4)]
GRIDS = [(8, 1), (4, 2), (2, 4)]
S = 2048


def _grids(dp: int, tp: int):
    import jax

    assert len(jax.devices()) >= dp * tp, "conftest must provide 8 devices"
    return (jmesh.data_plane_mesh(dp * tp, tp=tp),
            tmesh.data_plane_mesh(tp=tp, devices=["cpu"] * (dp * tp)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stripes(batch: int, k: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(batch, k, S), dtype=np.uint8)
    parity = np.stack([jrs.encode_np(k, m, data[i]) for i in range(batch)])
    return data, np.concatenate([data, parity], axis=1)


def test_grid_shape_and_defaults():
    grid = tmesh.data_plane_mesh(devices=["cpu"] * 8)
    assert grid.shape == {"dp": 4, "tp": 2} and grid.size == 8
    assert tmesh.data_plane_mesh(3, devices=["cpu"] * 8).shape == \
        {"dp": 3, "tp": 1}
    assert tmesh.data_plane_mesh(devices=["cpu"]).shape == {"dp": 1, "tp": 1}
    # equal grids are one cache key for the steps
    assert tmesh.make_encode_step(grid, 4, 2, S) is tmesh.make_encode_step(
        tmesh.data_plane_mesh(devices=["cpu"] * 8), 4, 2, S)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.data_plane_mesh()


@pytest.mark.parametrize("dp,tp", GRIDS)
@pytest.mark.parametrize("k,m", SHAPES)
def test_put_step_sharded_matches_reference(k, m, dp, tp):
    jgrid, tgrid = _grids(dp, tp)
    batch = dp * 2
    data, shards = _stripes(batch, k, m, seed=k * 100 + tp)
    jparity, jhashes = jmesh.make_put_step(jgrid, k, m, S)(data)
    parity, hashes = tmesh.make_put_step(tgrid, k, m, S)(_t(data))
    assert hashes.shape == (batch, k + m, 32) and hashes.dtype == torch.uint8
    _eq(parity, jparity)
    _eq(parity, shards[:, k:])
    _eq(hashes, jhashes)


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
@pytest.mark.parametrize("k,m", SHAPES)
def test_scrub_step_detects_injected_corruption(k, m, dp, tp):
    jgrid, tgrid = _grids(dp, tp)
    batch = dp * 2
    data, shards = _stripes(batch, k, m, seed=7)
    _, jhashes = jmesh.make_put_step(jgrid, k, m, S)(data)
    _, hashes = tmesh.make_put_step(tgrid, k, m, S)(_t(data))
    jscrub = jmesh.make_scrub_step(jgrid, k, m, S)
    scrub = tmesh.make_scrub_step(tgrid, k, m, S)
    bad, count = scrub(_t(shards), hashes)
    assert int(count) == 0 and not bad.any()

    # one byte flipped in a data shard, one in a parity shard
    shards2 = shards.copy()
    shards2[1, 0, 100] ^= 0xFF
    shards2[2, k + 1, 5] ^= 0x01
    jbad2, jcount2 = jscrub(shards2, np.asarray(jhashes))
    bad2, count2 = scrub(_t(shards2), hashes)
    assert bad2[1, 0] and bad2[2, k + 1]
    assert int(count2) == 2 and count2.dtype == torch.int32
    _eq(bad2, jbad2)
    assert int(count2) == int(jcount2)


@pytest.mark.parametrize("dp,tp", GRIDS)
def test_repair_step_rebuilds_missing(dp, tp):
    k, m = 10, 4
    jgrid, tgrid = _grids(dp, tp)
    batch = dp * 2
    _, shards = _stripes(batch, k, m, seed=9)
    present = (0, 1, 2, 3, 4, 6, 7, 8, 9, 12)
    missing = (5, 10, 13)
    surviving = shards[:, list(present), :]
    jrebuilt, jhashes = jmesh.make_repair_step(
        jgrid, k, m, present, missing, S)(surviving)
    rebuilt, hashes = tmesh.make_repair_step(
        tgrid, k, m, present, missing, S)(_t(surviving))
    _eq(rebuilt, shards[:, list(missing), :])
    _eq(rebuilt, jrebuilt)
    _eq(hashes, jhashes)


def test_repair_step_shares_one_program_across_patterns():
    """Same-size erasure patterns share ONE shape-keyed step: the repair
    matrix is a runtime operand, never a key."""
    k, m = 4, 2
    jgrid, tgrid = _grids(4, 2)
    _, shards = _stripes(8, k, m, seed=11)
    patterns = [((0, 1, 2, 4), (3,)), ((1, 2, 3, 5), (0,)),
                ((0, 2, 3, 4), (1,))]
    tmesh._repair_apply_step.cache_clear()
    for present, missing in patterns:
        surviving = shards[:, list(present), :]
        rebuilt, hashes = tmesh.make_repair_step(
            tgrid, k, m, present, missing, S)(_t(surviving))
        jrebuilt, jhashes = jmesh.make_repair_step(
            jgrid, k, m, present, missing, S)(surviving)
        _eq(rebuilt, shards[:, list(missing), :])
        _eq(rebuilt, jrebuilt)
        _eq(hashes, jhashes)
    assert tmesh._repair_apply_step.cache_info().currsize == 1


@pytest.mark.parametrize("dp,tp", GRIDS)
def test_encode_parity_check_and_gf_apply_steps_match_reference(dp, tp):
    """The feeder's three grid steps against the JAX package's on the
    same stripes: parity, the per-stripe verdicts (one corrupt stripe)
    and a pattern-as-data decode with a different pattern per stripe."""
    k, m = 10, 4
    jgrid, tgrid = _grids(dp, tp)
    batch = dp * 2
    data, shards = _stripes(batch, k, m, seed=13 + tp)
    _eq(tmesh.make_encode_step(tgrid, k, m, S)(_t(data)),
        jmesh.make_encode_step(jgrid, k, m, S)(data))

    bad = shards.copy()
    bad[batch - 1, k + 2, S - 1] ^= 0x40
    ok = tmesh.make_parity_check_step(tgrid, k, m, S)(_t(bad))
    _eq(ok, jmesh.make_parity_check_step(jgrid, k, m, S)(bad))
    assert ok.tolist() == [True] * (batch - 1) + [False]

    rng = np.random.default_rng(tp)
    presents = [tuple(sorted(rng.choice(k + m, k, replace=False).tolist()))
                for _ in range(batch)]
    surviving = np.stack([shards[i, list(p)] for i, p in enumerate(presents)])
    mats = np.stack([jrs.decode_matrix(k, m, p) for p in presents])
    bits = np.stack([jrs.decode_bitmat_t(k, m, p) for p in presents])
    got = tmesh.make_gf_apply_step(tgrid, k, k, S)(_t(mats), _t(surviving))
    _eq(got, data)
    _eq(got, jmesh.make_gf_apply_step(jgrid, k, k, S)(bits, surviving))


def test_layout_fallback_when_tp_does_not_divide_n():
    _, grid = _grids(2, 4)
    # n = 14, tp = 4: the whole-shard layout falls back to splitting S
    _, shards_layout, n_sharded = tmesh._layouts(grid, 14, S)
    assert not n_sharded and shards_layout == ("dp", None, "tp")
    # n = 6, tp = 2 on a fresh grid: the n axis is split
    _, grid2 = _grids(4, 2)
    _, _, n_sharded2 = tmesh._layouts(grid2, 6, S)
    assert n_sharded2
    jgrid, _ = _grids(2, 4)
    assert jmesh._layouts(jgrid, 14, S)[2] == n_sharded


def test_tp_must_divide_shard_len():
    _, grid = _grids(2, 4)
    with pytest.raises(ValueError, match="divide shard_len"):
        tmesh._layouts(grid, 6, 1023 * 3)  # 3069 % 4 != 0
    with pytest.raises(ValueError):
        tmesh.data_plane_mesh(8, tp=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="divide shard_len"):
        tmesh.make_gf_apply_step(grid, 4, 4, 1023 * 3)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tmesh.make_put_step(grid, 4, 2, 1020)


# ---- the feeder's grid route ---------------------------------------------


def _feeder(grid, mesh_min_items=1, k=10, m=4):
    from garage_tpu_torch.block.codec import ErasureCodec
    from garage_tpu_torch.block.feeder import DeviceFeeder

    class Tpu:
        pass

    tpu = Tpu()
    tpu.mesh_min_items = mesh_min_items
    return DeviceFeeder(codec=ErasureCodec(k, m, device="cpu"),
                        device="cpu", grid=grid, tpu_cfg=tpu)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_feeder_grid_route_matches_one_device_route(dp, tp):
    """With the grid route on for every batch (mesh_min_items = 1), each
    encode, parity-check, decode and repair batch takes the grid steps
    (mesh_batches counts them all) and returns the one-device route's
    bytes."""
    k, m = 10, 4
    rng = np.random.default_rng(dp * 10 + tp)
    # odd sizes: shard lengths that pad up to the grid's byte parts
    blocks = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(3000, 9000, 6)]
    grid = tmesh.data_plane_mesh(tp=tp, devices=["cpu"] * (dp * tp))

    async def drive(feeder):
        try:
            stripes = await asyncio.gather(*(feeder.encode(b)
                                             for b in blocks))
            bad = [list(s) for s in stripes]
            bad[3][k + 1] = bytes([bad[3][k + 1][0] ^ 1]) + bad[3][k + 1][1:]
            checks = await feeder.parity_check(bad)
            present = tuple(range(2, 2 + k))
            decoded = await asyncio.gather(*(
                feeder.decode(present, [s[i] for i in present], len(b))
                for s, b in zip(stripes, blocks)))
            repaired = await asyncio.gather(*(
                feeder.repair(present, (0, k + 1), [s[i] for i in present])
                for s in stripes))
            return (stripes, checks, decoded, repaired), dict(feeder.stats)
        finally:
            await feeder.stop()

    one, one_stats = asyncio.run(drive(_feeder(None)))
    split, stats = asyncio.run(drive(_feeder(grid)))
    assert one_stats["mesh_batches"] == 0
    assert stats["mesh_batches"] == stats["device_batches"] > 0
    assert split == one
    stripes, checks, decoded, repaired = split
    assert checks == [i != 3 for i in range(len(blocks))]
    assert decoded == blocks
    assert [bytes(x) for x in stripes[0][k:]] == [
        bytes(p) for p in jrs.encode_np(k, m, jrs.split_stripe(blocks[0], k))]
    for s, r in zip(stripes, repaired):
        assert r == {0: s[0], k + 1: s[k + 1]}


def test_backend_takes_the_grid_from_mesh_min_items():
    """A batch of fewer than mesh_min_items items keeps the one-device
    launches; one of at least that many pads its stripes up to dp and
    its shard length up to tp vector widths, and goes through the grid."""
    from garage_tpu_torch.block.codec import ErasureCodec
    from garage_tpu_torch.block.device_backend import TorchDeviceBackend

    k, m = 4, 2
    grid = tmesh.data_plane_mesh(tp=2, devices=["cpu"] * 4)
    be = TorchDeviceBackend(codec=ErasureCodec(k, m, device="cpu"),
                            device="cpu", grid=grid, mesh_min_items=3)
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
              for _ in range(3)]

    def run_op(items):
        return be.readback("encode", be.compute(
            "encode", be.stage("encode", items)))

    small = run_op(blocks[:2])
    assert be.stats["mesh_batches"] == 0
    staged = be.stage("encode", blocks)
    assert tuple(staged[2][3].shape) == (4, k, 256)  # dp = 2, 2 x 2 x 16 B
    big = be.readback("encode", be.compute("encode", staged))
    assert be.stats["mesh_batches"] == 1
    assert big[:2] == small
    assert [bytes(x) for x in big[2][k:]] == [
        bytes(p) for p in jrs.encode_np(k, m, jrs.split_stripe(blocks[2], k))]
