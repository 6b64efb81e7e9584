"""The port's feeder router and host route (garage_tpu_torch.block.feeder,
modes "off" and "auto") against the JAX package's, on the CPU, at zero
tolerance: every output is bytes or a bool.

- Byte parity: the same seeded inputs go through a JAX feeder and a port
  feeder for every op (hash, hash_with_md5 and its ETag, sha256_hex on
  buffers and span lists, encode, encode_put, verify_blocks,
  parity_check, decode, repair), in "off" and in "auto" with the device
  winning (the port's device is "cpu": the kernels' plain versions; the
  JAX package's is XLA on the CPU) and with the host winning (the inline
  fast path).
- Routing: `_plan_batch` returns the same legs in both packages for the
  same recorded rates, knobs, clock and batch, below, at and above each
  routing floor, with and without a due trial.
- Config: both packages read the same `[tpu]` section into their
  feeders alike.
- The port's own rules: a feeder, block manager or node built without a
  mode stays on the device under GARAGE_TPU_DEVICE=off; in "auto" a
  failed or hung device group fails its callers, never re-runs on the
  host, and a negative probe raises.
- One counterpart for each JAX test the port does not run
  (test_torch_copies.NOT_RUN), named in COUNTERPARTS.
- The JAX package's GL03 fixtures of test_cache_tier, linted by the
  port's analyzer as files of the port's tree.
"""

from __future__ import annotations

import asyncio
import hashlib
import inspect
import itertools
import os
import time

import numpy as np
import pytest
import torch

from garage_tpu import native as jnative
from garage_tpu.block.codec import ErasureCodec as JCodec
from garage_tpu.block.feeder import DeviceFeeder as JFeeder
from garage_tpu.block.feeder import _Item as JItem
from garage_tpu.model.garage import Garage as JGarage
from garage_tpu.ops import rs as jrs
from garage_tpu.utils.config import read_config as jread_config
from garage_tpu_torch import native as tnative
from garage_tpu_torch.block.codec import ErasureCodec
from garage_tpu_torch.block.device_backend import (StubDeviceBackend,
                                                   TorchDeviceBackend)
from garage_tpu_torch.block.feeder import DeviceFeeder, _Item
from garage_tpu_torch.model.garage import Garage
from garage_tpu_torch.utils.config import read_config
from test_torch_copies import NOT_RUN, _defined_tests, port_helper

# tier-1 runs several pytest workers per machine: one torch thread each
torch.set_num_threads(1)

K, M = 4, 2

# JAX test the port does not run -> the test here (or "file::test") that
# holds the port's behaviour instead
COUNTERPARTS = {
    "test_pipeline_hang_reruns_all_inflight_host_side":
        "test_auto_hang_fails_every_inflight_batch",
    "test_hash_md5_hang_fallback_advances_etag_exactly_once":
        "test_hash_md5_hang_advances_no_etag_twice",
    "test_mesh_sharded_encode_matches_host":
        "test_torch_parallel.py::test_feeder_grid_route_matches_one_device_"
        "route",
    "test_decode_hang_reruns_host_every_future_resolves":
        "test_auto_decode_hang_resolves_every_future",
    "test_recompiles_flat_across_mixed_erasure_patterns":
        "test_one_launch_shape_across_erasure_patterns",
    "test_rs_decode_repair_share_one_jit_across_patterns":
        "test_one_launch_shape_across_erasure_patterns",
    "test_feeder_hash_md5_device_failure_fallback_etag_correct":
        "test_device_failure_reaches_the_caller",
    "test_probe_cache_poison_and_require_override":
        "test_auto_negative_probe_raises",
    "test_feeder_sha256_host_floor_when_alone":
        "test_lone_stream_sha256_route_by_mode",
}

# the JAX package's GL03 fixtures of test_cache_tier
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "test_cache_tier.py")) as _f:
    GL03_TESTS = sorted(t for t in _defined_tests(_f.read())
                        if t.startswith("test_gl03_"))

PERF_OPS = ("hash", "encode", "decode", "parity", "sha256")


@pytest.fixture(scope="module", autouse=True)
def _native_loaded():
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C toolchain for the native libraries")


def _blocks(n, seed, size=50_000):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _stripe(block: bytes) -> list[bytes]:
    data = jrs.split_stripe(block, K)
    return [bytes(s) for s in data] + [bytes(p)
                                       for p in jrs.encode_np(K, M, data)]


def _seed_rates(f, winner: str) -> None:
    fast, slow = (1 << 30, 1 << 20)
    for op in PERF_OPS:
        f._record(op, "device", fast if winner == "device" else slow, 1.0)
        f._record(op, "host", slow if winner == "device" else fast, 1.0)


def _feeders(route: str, monkeypatch):
    """(JAX feeder, port feeder) for `route`: "off", or "auto" with the
    device ("auto_device") or the host ("auto_host") winning on recorded
    rates; the device route has no floor."""
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    mode = "off" if route == "off" else "auto"
    ref = JFeeder(codec=JCodec(K, M, use_jax=False), mode=mode)
    port = DeviceFeeder(codec=ErasureCodec(K, M, device="cpu"), mode=mode,
                        device="cpu")
    if mode == "auto":
        winner = route.split("_")[1]
        for f in (ref, port):
            f._device_ok = True  # the JAX "device" is the CPU platform
            _seed_rates(f, winner)
            f.device_min_items = f.device_min_decode_items = 1
            f.device_min_bytes = f.device_min_decode_bytes = 0
    return ref, port


async def _both(ref, port, fn):
    try:
        return (await asyncio.gather(*fn(ref)),
                await asyncio.gather(*fn(port)))
    finally:
        await ref.stop()
        await port.stop()


ROUTES = ["off", "auto_device", "auto_host"]


def _check_route(port, route: str, n: int) -> None:
    if route == "auto_device":
        assert port.stats["device_items"] == n, port.stats
        assert port.stats["host_items"] == 0
    else:
        assert port.stats["device_items"] == 0, port.stats
        assert port.stats["host_items"] == n
    assert port.stats["device_fallbacks"] == 0


# ---- byte parity against the JAX package ---------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_hash_matches_reference(route, monkeypatch):
    ref, port = _feeders(route, monkeypatch)
    blocks = _blocks(4, 1)
    a, b = asyncio.run(_both(ref, port,
                             lambda f: [f.hash(x) for x in blocks]))
    assert a == b == [tnative.blake3(x) for x in blocks]
    _check_route(port, route, 4)


@pytest.mark.parametrize("route", ROUTES)
def test_hash_with_md5_matches_reference(route, monkeypatch):
    ref, port = _feeders(route, monkeypatch)
    blocks = _blocks(4, 2)
    ref.active_streams = port.active_streams = 4
    jmd5 = [jnative.Md5() for _ in blocks]
    tmd5 = [tnative.Md5() for _ in blocks]

    def calls(f):
        accs = jmd5 if f is ref else tmd5
        return [f.hash_with_md5(x, a) for x, a in zip(blocks, accs)]

    a, b = asyncio.run(_both(ref, port, calls))
    assert a == b == [tnative.blake3(x) for x in blocks]
    etags = [hashlib.md5(x).hexdigest() for x in blocks]
    assert [m.hexdigest() for m in jmd5] == [m.hexdigest()
                                             for m in tmd5] == etags
    _check_route(port, route, 4)


@pytest.mark.parametrize("route", ROUTES)
def test_sha256_hex_matches_reference(route, monkeypatch):
    ref, port = _feeders(route, monkeypatch)
    blob = _blocks(1, 3, size=90_000)[0]
    msgs = [blob, [memoryview(blob)[:40_000], memoryview(blob)[40_000:]],
            blob[:1000], [b"ab", b"", b"cd"]]
    ref.active_streams = port.active_streams = 4
    a, b = asyncio.run(_both(ref, port,
                             lambda f: [f.sha256_hex(x) for x in msgs]))
    want = [hashlib.sha256(blob).hexdigest()] * 2 + [
        hashlib.sha256(blob[:1000]).hexdigest(),
        hashlib.sha256(b"abcd").hexdigest()]
    assert a == b == want
    if route == "off":  # "off" hashes every chunk on the host
        assert port.stats["host_items"] == 4
    else:
        _check_route(port, route, 4)


@pytest.mark.parametrize("route", ROUTES)
def test_encode_matches_reference(route, monkeypatch):
    ref, port = _feeders(route, monkeypatch)
    blocks = _blocks(3, 4, size=30_001)
    a, b = asyncio.run(_both(ref, port,
                             lambda f: [f.encode(x) for x in blocks]))
    assert a == b == [_stripe(x) for x in blocks]
    _check_route(port, route, 3)


@pytest.mark.parametrize("route", ROUTES)
def test_encode_put_matches_reference(route, monkeypatch):
    ref, port = _feeders(route, monkeypatch)
    blocks = _blocks(3, 5, size=40_003)
    a, b = asyncio.run(_both(
        ref, port, lambda f: [f.encode_put(x, prefix=b"\x00")
                              for x in blocks]))
    assert [[bytes(p) for p in parts] for parts in a] == \
        [[bytes(p) for p in parts] for parts in b]
    _check_route(port, route, 3)


@pytest.mark.parametrize("route", ROUTES)
def test_verify_blocks_matches_reference(route, monkeypatch):
    ref, port = _feeders(route, monkeypatch)
    blocks = _blocks(3, 6)
    items = [(tnative.blake3(blocks[0]), blocks[0]),
             (b"\x00" * 32, blocks[1]),
             (tnative.blake3(blocks[2]), blocks[2])]
    a, b = asyncio.run(_both(ref, port,
                             lambda f: [f.verify_blocks(items)]))
    assert a == b == [[True, False, True]]
    _check_route(port, route, 3)


@pytest.mark.parametrize("route", ROUTES)
def test_parity_check_matches_reference(route, monkeypatch):
    ref, port = _feeders(route, monkeypatch)
    stripes = [_stripe(x) for x in _blocks(3, 7, size=20_000)]
    bad = list(stripes[1])
    bad[K + 1] = bytes(x ^ 0x5A for x in bad[K + 1])
    stripes[1] = bad
    a, b = asyncio.run(_both(ref, port,
                             lambda f: [f.parity_check(stripes)]))
    assert a == b == [[True, False, True]]
    _check_route(port, route, 3)


@pytest.mark.parametrize("route", ROUTES)
def test_decode_matches_reference(route, monkeypatch):
    ref, port = _feeders(route, monkeypatch)
    blocks = _blocks(3, 8, size=30_000)
    patterns = [(1, 2, 3, 4), (0, 2, 4, 5), (2, 3, 4, 5)]
    items = []
    for x, present in zip(blocks, patterns):
        st = _stripe(x)
        items.append((present, [st[i] for i in present], len(x)))
    a, b = asyncio.run(_both(ref, port,
                             lambda f: [f.decode(*it) for it in items]))
    assert a == b == blocks
    _check_route(port, route, 3)


@pytest.mark.parametrize("route", ROUTES)
def test_repair_matches_reference(route, monkeypatch):
    ref, port = _feeders(route, monkeypatch)
    blocks = _blocks(3, 9, size=30_000)
    cases = [((1, 2, 3, 4), (0,)), ((0, 1, 2, 5), (3, 4)),
             ((0, 1, 3, 4), (2, 5))]
    items, want = [], []
    for x, (present, missing) in zip(blocks, cases):
        st = _stripe(x)
        items.append((present, missing, [st[i] for i in present]))
        want.append({mi: st[mi] for mi in missing})
    a, b = asyncio.run(_both(ref, port,
                             lambda f: [f.repair(*it) for it in items]))
    assert a == b == want
    _check_route(port, route, 3)


# ---- routing decisions against the JAX package ---------------------------


def _items(cls, op: str, n: int, size: int) -> list:
    rng = np.random.default_rng(n * 1000 + size)
    blobs = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
             for _ in range(n)]
    if op == "hash":
        datas = blobs
    elif op == "encode_put":
        datas = [(b"\x00", x) for x in blobs]
    elif op == "sha256":
        datas = [[x[:size // 2], x[size // 2:]] for x in blobs]
    elif op == "parity_check":
        datas = [[x[j::K + M] for j in range(K + M)] for x in blobs]
    elif op == "decode":
        datas = [((1, 2, 3, 4), [x[j::K] for j in range(K)], size)
                 for x in blobs]
    else:  # repair
        datas = [((0, 1, 2, 3), (4,), [x[j::K] for j in range(K)])
                 for x in blobs]
    return [cls(op, d, None) for d in datas]


FLOOR_ITEMS, FLOOR_BYTES = 4, 64_000


@pytest.mark.parametrize("due", [False, True], ids=["steady", "trial_due"])
@pytest.mark.parametrize("winner", ["device", "host"])
@pytest.mark.parametrize("n,size", [(1, 1000), (FLOOR_ITEMS - 1, 1000),
                                    (FLOOR_ITEMS, 1000),
                                    (FLOOR_ITEMS + 5, 1000),
                                    (1, FLOOR_BYTES), (2, FLOOR_BYTES)],
                         ids=["one", "below_items", "at_items",
                              "above_items", "at_bytes", "above_bytes"])
@pytest.mark.parametrize("op", ["hash", "encode_put", "sha256",
                                "parity_check", "decode", "repair"])
def test_plan_batch_matches_reference(op, n, size, winner, due,
                                      monkeypatch):
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    now = 5_000.0
    monkeypatch.setattr(time, "monotonic", lambda: now)
    plans = []
    for feeder, item in ((JFeeder(codec=JCodec(K, M, use_jax=False),
                                  mode="auto"), JItem),
                         (DeviceFeeder(codec=ErasureCodec(K, M, device="cpu"),
                                       mode="auto", device="cpu"), _Item)):
        feeder._device_ok = True
        feeder.device_min_items = feeder.device_min_decode_items = \
            FLOOR_ITEMS
        feeder.device_min_bytes = feeder.device_min_decode_bytes = \
            FLOOR_BYTES
        feeder.trial_max_items, feeder.trial_items_cap = 2, 3
        feeder.trial_max_bytes = 1500
        _seed_rates(feeder, winner)
        for perf_op in PERF_OPS:
            feeder._last_explore[perf_op] = now - (1e9 if due else 0.0)
        plans.append(feeder._plan_batch(_items(item, op, n, size)))
    assert plans[0] == plans[1]


def test_plan_batch_while_calibrating_and_forced_trial(monkeypatch):
    """Calibration still running keeps every batch on the host; the
    inline path's forced device trial runs on the device once."""
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    plans = []
    for feeder, item in ((JFeeder(codec=JCodec(K, M, use_jax=False),
                                  mode="auto"), JItem),
                         (DeviceFeeder(codec=ErasureCodec(K, M, device="cpu"),
                                       mode="auto", device="cpu"), _Item)):
        feeder._device_ok = True
        _seed_rates(feeder, "device")
        batch = _items(item, "hash", 8, 1 << 20)
        feeder._calibrating = True
        calibrating = feeder._plan_batch(batch)
        feeder._calibrating = False
        feeder._force_device["hash"] = True
        forced = feeder._plan_batch(batch)
        plans.append((calibrating, forced, feeder._plan_batch(batch)))
    assert plans[0] == plans[1]
    assert plans[1][0][0][3] == "host"
    # the trial slice grows to trial_max_bytes (4 MiB): 4 of 8 items
    assert [(len(leg[2]), leg[3]) for leg in plans[1][1]] == [
        (4, "device"), (4, "host")]


# ---- [tpu] readings from one file -----------------------------------------

_CONFIG = """
metadata_dir = "{tmp}/meta"
data_dir = "{tmp}/data"
replication_factor = 1
rpc_bind_addr = "127.0.0.1:0"

[metadata]
db_engine = "memory"

[tpu]
{tpu}
"""

_TPU = ("batch_blocks = 16\ninflight_batches = 2\nbatch_timeout_s = 45\n"
        "batch_linger_ms = 2\npad_buckets = [2, 8, 32]\nmesh_min_items = 6\n"
        "device_min_bytes = 123456\ndevice_min_items = 3\n"
        "device_min_decode_bytes = 65536\ndevice_min_decode_items = 2\n"
        "trial_max_items = 1\ntrial_items_cap = 5\ntrial_max_bytes = 999\n"
        'device_backend = "stub"\n')

_KNOBS = ("max_batch", "inflight_batches", "batch_timeout", "batch_linger",
          "pad_buckets", "mesh_min_items", "device_min_bytes",
          "device_min_items", "device_min_decode_bytes",
          "device_min_decode_items", "trial_max_items", "trial_items_cap",
          "trial_max_bytes")


@pytest.mark.parametrize("enable", [True, False])
def test_tpu_section_reads_like_the_reference(enable, tmp_path):
    feeders = []
    for sub, reader, cls, kw in (("jax", jread_config, JGarage, {}),
                                 ("port", read_config, Garage,
                                  {"device": "cpu"})):
        d = tmp_path / sub
        d.mkdir()
        (d / "garage.toml").write_text(_CONFIG.format(
            tmp=d, tpu=_TPU + f"enable = {str(enable).lower()}\n"))
        feeders.append(cls(reader(str(d / "garage.toml")),
                           **kw).block_manager.feeder)
    ref, port = feeders
    assert {k: getattr(port, k) for k in _KNOBS} == \
        {k: getattr(ref, k) for k in _KNOBS}
    assert port._backend_is_stub() and ref._backend_is_stub()
    if not enable:
        assert port.mode == ref.mode == "off"
    else:  # the port's default: "require", where the JAX package's is auto
        assert port.mode == "require"


# ---- the port's own rules --------------------------------------------------


def test_no_mode_stays_on_the_device_under_env_off(tmp_path, monkeypatch):
    """GARAGE_TPU_DEVICE=off (which tests/conftest.py exports) downgrades
    only an explicit "auto": a feeder, a block manager and a node built
    without a mode put every item through the device route."""
    monkeypatch.setenv("GARAGE_TPU_DEVICE", "off")
    assert DeviceFeeder(device="cpu").mode == "require"
    assert DeviceFeeder(mode="auto", device="cpu").mode == "off"
    blocks = _blocks(3, 10, size=100_000)
    block_mod = port_helper("test_block")

    async def go():
        net, systems, managers, tasks = await block_mod.make_block_cluster(
            tmp_path, n=6, rf=3, erasure=(K, M))
        try:
            m0 = managers[0]
            for x in blocks:
                h = await m0.hash_block(x)
                await m0.rpc_put_block(h, x)
                assert await m0.rpc_get_block(h, cacheable=False) == x
            return [m.feeder for m in managers]
        finally:
            await block_mod.stop_all(systems, tasks)

    feeders = asyncio.run(go())
    f0 = feeders[0]
    assert f0.mode == "require"
    assert f0.stats["device_items"] >= 6, f0.stats
    assert f0.stats["inline_items"] == f0.stats["host_items"] == 0
    assert all(f.mode == "require" for f in feeders)
    assert sum(f.stats["host_items"] for f in feeders) == 0
    g = Garage(read_config(_write_config(tmp_path / "node", "")),
               device="cpu")
    assert g.block_manager.feeder.mode == "require"


def _write_config(d, tpu: str) -> str:
    d.mkdir(parents=True, exist_ok=True)
    (d / "garage.toml").write_text(_CONFIG.format(tmp=d, tpu=tpu))
    return str(d / "garage.toml")


def test_enable_false_node_runs_on_the_host(tmp_path):
    """`[tpu] enable = false` on device "cuda": a host-only node whose
    codec is on the CPU and whose feeder touches no device."""
    g = Garage(read_config(_write_config(tmp_path, "enable = false\n")),
               device="cuda")
    f = g.block_manager.feeder
    assert f.mode == "off" and f._backend is None
    blob = _blocks(1, 11)[0]

    async def go():
        try:
            return await f.hash(blob)
        finally:
            await f.stop()

    assert asyncio.run(go()) == tnative.blake3(blob)
    assert f._backend is None
    assert f.stats["device_items"] == 0 and f.stats["inline_items"] == 1


def _hang_feeder(mode: str, monkeypatch, max_batch: int = 4,
                 codec=None) -> tuple[DeviceFeeder, StubDeviceBackend]:
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    stub = StubDeviceBackend(None, fixed_s=0.01)
    stub.hang_stage = "compute"
    f = DeviceFeeder(codec=codec, mode=mode, max_batch=max_batch,
                     backend=stub, device="cpu")
    f._device_ok = True
    f.batch_timeout = 1.0
    _seed_rates(f, "device")
    f.device_min_items = f.device_min_decode_items = 1
    return f, stub


def test_auto_hang_fails_every_inflight_batch(monkeypatch):
    """A device hang with two batches in flight in "auto": both fail
    their callers (the sibling at once, not after its own watchdog), no
    item is re-run on the host, the device stays in use, and the next
    batch runs on a fresh pipeline generation."""
    f, _stub = _hang_feeder("auto", monkeypatch)
    blobs = _blocks(8, 12, size=65536)

    async def go():
        t0 = time.perf_counter()
        res = await asyncio.gather(*[f.hash(b) for b in blobs],
                                   return_exceptions=True)
        wall = time.perf_counter() - t0
        after = await asyncio.gather(*[f.hash(b) for b in blobs[:4]])
        await f.stop()
        return res, wall, after

    res, wall, after = asyncio.run(go())
    assert all(isinstance(r, RuntimeError) and "hung" in str(r)
               for r in res), res
    assert wall < 2 * f.batch_timeout + 1.0
    assert f._device_ok is True and f.mode == "auto"
    assert after == [tnative.blake3(b) for b in blobs[:4]]
    assert f.stats["device_items"] == 4
    assert f.stats["host_items"] == f.stats["inline_items"] == 0
    assert f.stats["device_fallbacks"] == 0


@pytest.mark.parametrize("mode", ["require", "auto"])
def test_hash_md5_hang_advances_no_etag_twice(mode, monkeypatch):
    """hash_md5 batches two deep, the device hung: every caller gets an
    error or its digest, and each ETag chain advanced at most once: not
    at all for a failed item (no host re-run follows)."""
    f, _stub = _hang_feeder(mode, monkeypatch, max_batch=2)
    f.active_streams = 4
    blobs = _blocks(4, 13, size=4096)
    accs = [tnative.Md5() for _ in blobs]

    async def go():
        res = await asyncio.gather(*[f.hash_with_md5(b, a)
                                     for b, a in zip(blobs, accs)],
                                   return_exceptions=True)
        await f.stop()
        return res

    res = asyncio.run(go())
    assert all(isinstance(r, RuntimeError) for r in res), res
    for r, b, a in zip(res, blobs, accs):
        assert a.hexdigest() == hashlib.md5(b"").hexdigest()
    assert f.stats["device_fallbacks"] == 0
    assert f.stats["host_items"] == 0


def test_auto_decode_hang_resolves_every_future(monkeypatch):
    """Decode batches two deep in "auto", the device hung: every future
    resolves, with the hang's error; nothing is credited to the device
    or re-run on the host."""
    codec = ErasureCodec(K, M, device="cpu")
    f, _stub = _hang_feeder("auto", monkeypatch, max_batch=2, codec=codec)
    blocks = _blocks(4, 14, size=20_000)
    present = (1, 2, 3, 4)

    async def go():
        jobs = []
        for b in blocks:
            st = _stripe(b)
            jobs.append(f.decode(present, [st[i] for i in present], len(b)))
        res = await asyncio.wait_for(
            asyncio.gather(*jobs, return_exceptions=True), 10)
        await f.stop()
        return res

    res = asyncio.run(go())
    assert all(isinstance(r, RuntimeError) for r in res), res
    assert f.stats["decode_device_items"] == 0
    assert f.stats["host_items"] == f.stats["device_fallbacks"] == 0


class _BrokenBackend:
    """A staged backend whose transfer stage always raises."""

    name = "torch"

    def __init__(self):
        self.calls = 0

    def stage(self, op, blobs):
        self.calls += 1
        raise RuntimeError("device lost")


@pytest.mark.parametrize("mode", ["require", "auto"])
def test_device_failure_reaches_the_caller(mode, monkeypatch):
    """A failing device hash_md5 group: the callers get the device's
    error, the MD5 chains have not moved, no host re-run happens."""
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    be = _BrokenBackend()
    f = DeviceFeeder(mode=mode, backend=be, device="cpu")
    f._device_ok = True
    _seed_rates(f, "device")
    f.device_min_items = 1
    f.active_streams = 2
    blobs = _blocks(2, 15, size=4096)
    accs = [tnative.Md5() for _ in blobs]

    async def go():
        res = await asyncio.gather(*[f.hash_with_md5(b, a)
                                     for b, a in zip(blobs, accs)],
                                   return_exceptions=True)
        await f.stop()
        return res

    res = asyncio.run(go())
    assert be.calls >= 1
    assert all(isinstance(r, RuntimeError) and "device lost" in str(r)
               for r in res), res
    assert [a.hexdigest() for a in accs] == [hashlib.md5(b"").hexdigest()] * 2
    assert f.stats["device_fallbacks"] == f.stats["host_items"] == 0


def test_auto_negative_probe_raises(monkeypatch):
    """"auto" on a CUDA device that is not there raises to the caller,
    as "require" does, and runs nothing on the host."""
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    f = DeviceFeeder(codec=ErasureCodec(K, M, device="cpu"), mode="auto",
                     device="cuda:99")
    block = _blocks(1, 16)[0]

    async def go():
        try:
            for call in (lambda: f.hash(block),
                         lambda: f.encode_put(block, prefix=b"\x00"),
                         lambda: f.verify_blocks([(b"\x00" * 32, block)])):
                with pytest.raises(RuntimeError, match="probe failed"):
                    await call()
        finally:
            await f.stop()

    asyncio.run(go())
    assert f._device_ok is None and f.mode == "auto"
    assert f.stats["host_items"] == f.stats["inline_items"] == 0


def test_auto_calibration_failure_fails_later_requests(monkeypatch):
    """A device leg that fails calibration makes every later request of
    the "auto" feeder raise; it does not send them to the host."""
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    f = DeviceFeeder(mode="auto", backend=_BrokenBackend(), device="cpu")
    blob = _blocks(1, 17)[0]

    async def go():
        try:
            with pytest.raises(RuntimeError):
                for _ in range(400):  # until calibration has failed
                    await f.hash(blob)
                    await asyncio.sleep(0.01)
        finally:
            await f.stop()

    asyncio.run(go())
    assert f._device_err is not None and not f._calibrating
    assert "device lost" in str(f._device_err)


def test_auto_calibration_measures_both_routes(monkeypatch):
    """A positive probe in "auto" starts calibration in a worker thread:
    it records both routes' rates for hash, encode and decode through
    the port's backend, and production batches take the host until it
    ends."""
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    f = DeviceFeeder(codec=ErasureCodec(K, M, device="cpu"), mode="auto",
                     device="cpu")
    blob = _blocks(1, 18)[0]

    async def go():
        try:
            assert await f.hash(blob) == tnative.blake3(blob)
            for _ in range(3000):
                if not f._calibrating:
                    break
                await asyncio.sleep(0.05)
        finally:
            await f.stop()

    asyncio.run(go())
    assert not f._calibrating and f._device_err is None
    rates = f.perf_summary()
    for op in ("hash", "encode", "decode"):
        assert rates[f"{op}/device"] > 0 and rates[f"{op}/host"] > 0, rates
    assert isinstance(f._get_backend(), TorchDeviceBackend)
    assert f.stats["device_fallbacks"] == 0


@pytest.mark.parametrize("mode", ["require", "auto", "off"])
def test_lone_stream_sha256_route_by_mode(mode, monkeypatch):
    """A lone stream's chunk digest: kernel S2 in "require" (the port's
    rule), the host in "auto" and "off" (the JAX package's)."""
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    f = DeviceFeeder(mode=mode, device="cpu")
    if mode == "auto":
        f._device_ok = True
        _seed_rates(f, "device")
    blob = _blocks(1, 19, size=100_000)[0]

    async def go():
        try:
            assert f.active_streams == 0
            return await f.sha256_hex(blob)
        finally:
            await f.stop()

    assert asyncio.run(go()) == hashlib.sha256(blob).hexdigest()
    on_device = mode == "require"
    assert f.stats["device_items"] == int(on_device)
    assert f.stats["host_items"] == int(not on_device)


def test_one_launch_shape_across_erasure_patterns():
    """Decode batches of 9 erasure patterns at one shape, then repairs
    of 1 and 2 missing shards: one launch shape per (output rows, k), so
    `recompiles` stays flat across patterns (the matrices are data)."""
    f = DeviceFeeder(codec=ErasureCodec(K, M, device="cpu"),
                     mode="require", device="cpu")
    block = _blocks(1, 20, size=40_000)[0]
    st = _stripe(block)
    patterns = list(itertools.combinations(range(K + M), K))[:9]

    async def go():
        loop = asyncio.get_running_loop()
        try:
            for present in patterns:
                shards = [st[i] for i in present]
                batch = [_Item("decode", (present, shards, len(block)),
                               loop.create_future()) for _ in range(4)]
                assert await f._run_batch_staged(batch) == [block] * 4
                assert f.stats["recompiles"] == 1, present
            batch = []
            for missing in [(0,), (3,), (5,), (0, 1), (2, 5)]:
                present = tuple(i for i in range(K + M)
                                if i not in missing)[:K]
                batch.append(_Item("repair", (present, missing,
                                              [st[i] for i in present]),
                                   loop.create_future()))
            got = await f._run_batch_staged(batch)
            assert got == [{mi: st[mi] for mi in it.data[1]}
                           for it in batch]
        finally:
            await f.stop()

    asyncio.run(go())
    shapes = {s for s in f._get_backend()._shapes if s[0] == "gf"}
    # (op, items, output rows, k, shard length, grid): rows 1, 2 and k
    assert sorted(s[2] for s in shapes) == [1, 2, K]
    assert all(s[3] == K for s in shapes)
    assert f.stats["recompiles"] == 3
    assert f.stats["decode_device_items"] == 4 * len(patterns) + 5


@pytest.mark.parametrize("test", GL03_TESTS)
def test_gl03_verdicts_on_port_paths(test):
    """The JAX package's GL03 fixtures, linted by the port's analyzer
    (garage_tpu_torch.analysis) as files of the port's tree: the same
    verdicts."""
    import textwrap

    import test_cache_tier

    from garage_tpu_torch.analysis import analyze_source, default_rules

    def lint(src: str, rel_path: str):
        assert rel_path.startswith("garage_tpu_torch/"), rel_path
        ctx = analyze_source(textwrap.dedent(src), default_rules(),
                             rel_path=rel_path)
        return sorted({v.rule for v in ctx.violations if v.active})

    assert len(GL03_TESTS) == 6
    src = inspect.getsource(getattr(test_cache_tier, test))
    assert '"garage_tpu/' in src
    ns = dict(vars(test_cache_tier), _lint=lint)
    exec(compile(src.replace('"garage_tpu/', '"garage_tpu_torch/'),
                 test_cache_tier.__file__, "exec"), ns)
    ns[test]()


def test_every_test_not_run_has_a_counterpart():
    here = os.path.dirname(os.path.abspath(__file__))
    named = {t for suite in NOT_RUN.values() for t in suite}
    assert named == set(COUNTERPARTS)
    for target in COUNTERPARTS.values():
        if "::" in target:
            path, fn = target.split("::")
            with open(os.path.join(here, path)) as fh:
                assert f"def {fn}(" in fh.read(), target
        else:
            assert callable(globals().get(target)), target
