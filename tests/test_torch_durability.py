"""The durability plane of the port held against the JAX package's, on
the CPU: the same blocks, made from one seed, go into an erasure(4,2)
cluster of 6 JAX nodes and one of 6 port nodes (`device="cpu"`); the
same forged, wrong-length, rotted-header and double-corrupted shards are
planted in both; one deep-scrub pass and then the resync of a node whose
data directory was wiped must give the same counters on both and shard
files byte-equal to each other and to the originals. Last, port nodes
scrub and repair the shard files the JAX nodes wrote.

The clusters come from tests/test_block.py `make_block_cluster`: the JAX
package's module as it is, and the port's version of it
(tests/test_torch_copies.py `port_helper`)."""

from __future__ import annotations

import asyncio
import importlib
import os
import shutil

import numpy as np
import pytest

import test_block as jax_block
from test_torch_copies import port_helper

SEED = 20261017
K, M = 4, 2
SIZES = (150_000, 200_000, 180_000, 180_000, 123_456, 100_000)
# (block, part, how): what is planted in both clusters
PLANT = ((0, 1, "forge"), (1, 5, "forge"), (2, 3, "length"),
         (3, 2, "header"), (4, 2, "forge"), (4, 4, "forge"))
# block 0, 1, 2 and 4 are corrupt (4 twice, in one data and one parity
# shard); block 3 has a wrong header over the right payload
WANT = {"corruptions": 4, "deep_checked": 6, "deep_repaired": 4,
        "header_repaired": 1}
WIPED = 5  # the node whose data directory goes


@pytest.fixture(scope="module", autouse=True)
def _native_crc():
    """Both packages frame shards with crc32c once their native library
    is loaded and with zlib crc32 before: load both, so that both write
    the same shard files."""
    from garage_tpu import native as jax_native
    from garage_tpu_torch import native

    assert jax_native.available() and native.available()


def _blocks():
    rng = np.random.default_rng(SEED)
    return [rng.bytes(n) for n in SIZES]


def _shards(managers, hashes) -> dict:
    """{(block, part): shard file bytes} over every node."""
    out = {}
    for m in managers:
        for b, h in enumerate(hashes):
            for part in m.local_parts(h):
                out[b, part] = m.read_local_shard(h, part)
    return out


def _holder(managers, h, part):
    return next(m for m in managers if part in m.local_parts(h))


def _plant(mod, managers, hashes, plant) -> None:
    for b, part, how in plant:
        m = _holder(managers, hashes[b], part)
        payload, plen = mod.unpack_shard(m.read_local_shard(hashes[b], part))
        if how == "forge":
            payload = bytes(x ^ 0xA5 for x in payload[:128]) + payload[128:]
        elif how == "length":
            payload, plen = payload + bytes(512), 999_999
        else:
            plen = 999_999
        m.write_local_shard(hashes[b], part, mod.pack_shard(payload, plen))


async def _held(managers, hashes) -> None:
    for _ in range(200):
        if all(sorted(i for m in managers for i in m.local_parts(h))
               == list(range(K + M)) for h in hashes):
            return
        await asyncio.sleep(0.02)
    raise AssertionError("not every shard was stored")


async def _scrub(mod, managers, hashes) -> dict:
    """One deep-scrub pass: every node scrubs every block it holds (each
    stripe's leader gathers and parity-checks it) -> summed counters."""
    block = importlib.import_module(
        mod.BlockManager.__module__.rsplit(".", 1)[0])
    ScrubWorker = block.ScrubWorker
    out = dict.fromkeys(WANT, 0)
    for m in managers:
        sw = ScrubWorker(m)
        out["corruptions"] += await sw.scrub_batch(list(hashes))
        for key in ("deep_checked", "deep_repaired", "header_repaired"):
            out[key] += getattr(sw, key)
    return out


async def _durability(mod, tmp_path, blocks) -> dict:
    """Write, plant, scrub, wipe one node, resync it: -> the counters,
    the shard files after the scrub and after the resync, and the files'
    paths (their node and DataLayout path)."""
    net, systems, managers, tasks = await mod.make_block_cluster(
        tmp_path, n=K + M, rf=3, erasure=(K, M))
    try:
        hashes = [mod.blake2sum(b) for b in blocks]
        for h, b in zip(hashes, blocks):
            await managers[0].rpc_put_block(h, b)
        await _held(managers, hashes)
        for m in managers:  # every holder references every block
            m.db.transaction(lambda tx, m=m: [m.rc.block_incref(tx, h)
                                              for h in hashes])
        original = _shards(managers, hashes)
        _plant(mod, managers, hashes, PLANT)
        counters = await _scrub(mod, managers, hashes)
        scrubbed = _shards(managers, hashes)
        clean = await _scrub(mod, managers, hashes)

        victim = managers[WIPED]
        lost = {(b, p) for b, h in enumerate(hashes)
                for p in victim.local_parts(h)}
        shutil.rmtree(str(tmp_path / f"node{WIPED}" / "data"))
        assert not any(victim.local_parts(h) for h in hashes)
        for h in hashes:
            await victim.resync.resync_block(h)
        rebuilt = _shards([victim], hashes)
        for h, b in zip(hashes, blocks):
            assert await managers[1].rpc_get_block(h) == b
        files = {(b, p): m._find(h, [f".s{p}"]) for m in managers
                 for b, h in enumerate(hashes) for p in m.local_parts(h)}
        return {"counters": counters, "clean": clean, "original": original,
                "scrubbed": scrubbed, "lost": lost, "rebuilt": rebuilt,
                "files": files, "hashes": hashes}
    finally:
        await mod.stop_all(systems, tasks)


@pytest.fixture(scope="module")
def ref(_native_crc, tmp_path_factory) -> dict:
    """The JAX nodes' run of the scenario, shared by the tests below."""
    return jax_block.run(_durability(
        jax_block, tmp_path_factory.mktemp("jax"), _blocks()))


def test_scrub_and_resync_match_the_jax_package(ref, tmp_path):
    port_block = port_helper("test_block")
    got = jax_block.run(_durability(port_block, tmp_path, _blocks()))
    assert ref["hashes"] == got["hashes"]
    assert ref["counters"] == WANT
    assert got["counters"] == ref["counters"]
    assert got["clean"] == ref["clean"] == dict(
        WANT, corruptions=0, deep_repaired=0, header_repaired=0)
    # every repaired shard file is the one the PUT wrote
    assert ref["original"] == got["original"]
    assert got["scrubbed"] == ref["scrubbed"] == ref["original"]
    # the wiped node's shards are rebuilt byte for byte
    assert len(got["lost"]) == len(SIZES)
    assert set(got["rebuilt"]) == got["lost"]
    assert all(got["rebuilt"][key] == ref["original"][key]
               for key in got["lost"])
    assert all(ref["rebuilt"][key] == ref["original"][key]
               for key in ref["lost"])


def test_port_scrubs_shard_files_the_jax_package_wrote(ref, tmp_path):
    """The JAX nodes write and stop; each port node of a new cluster gets
    the JAX nodes' shard files (by the port's placement), and one forged
    shard among them is found and repaired."""
    blocks = _blocks()
    port_block = port_helper("test_block")

    async def main():
        net, systems, managers, tasks = await port_block.make_block_cluster(
            tmp_path, n=K + M, rf=3, erasure=(K, M))
        try:
            hashes = ref["hashes"]
            layout = systems[0].layout_helper.current()
            for b, h in enumerate(hashes):
                placement = port_block.shard_nodes_of(layout, h, K + M)
                for part, node in enumerate(placement):
                    m = next(m for m in managers if m.system.id == node)
                    dst = m.data_layout.block_path(h, f".s{part}")
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copyfile(ref["files"][b, part], dst)
            assert _shards(managers, hashes) == ref["original"]
            _plant(port_block, managers, hashes, ((1, 0, "forge"),))
            counters = await _scrub(port_block, managers, hashes)
            assert counters == dict(WANT, corruptions=1, deep_repaired=1,
                                    header_repaired=0)
            assert _shards(managers, hashes) == ref["original"]
            for h, b in zip(hashes, blocks):
                assert await managers[2].rpc_get_block(h) == b
        finally:
            await port_block.stop_all(systems, tasks)

    jax_block.run(main())
