"""The loop meter of the port's tracer (garage_tpu_torch/utils/tracing.py
LoopMeter), its shared clock with the spans, the feeder's queue-wait and
stage-wait counters, and the benchmark's readers of both
(portbench/metrics/).

The meter's layer map is the package's own in the benchmark; here two
small modules written under a temporary directory stand for two layers
(a synthetic map, `rules` and `root`), so that a known split of the
loop's time can be set up and timed independently."""

from __future__ import annotations

import asyncio
import importlib.util
import os
import sys
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from garage_tpu_torch import native as tnative  # noqa: E402
from garage_tpu_torch.block.device_backend import \
    StubDeviceBackend  # noqa: E402
from garage_tpu_torch.block.feeder import DeviceFeeder  # noqa: E402
from garage_tpu_torch.utils import tracing  # noqa: E402
from garage_tpu_torch.utils.tracing import span, tracer  # noqa: E402
from portbench import harness  # noqa: E402

MOD_A = '''
import time


def work(n):
    s = 0
    for i in range(n):
        s += i * i
    return s


def block(seconds):
    time.sleep(seconds)
'''

MOD_B = '''
import os


def writes(path, n, size=1 << 16):
    buf = b"x" * size
    with open(path, "wb") as f:
        for _ in range(n):
            f.write(buf)
            f.flush()
            os.fsync(f.fileno())
'''


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def layers(tmp_path):
    """Two modules of a synthetic program root: mod_a is "frontend",
    mod_b "blockmgr" -> (mod_a, mod_b, rules, root)."""
    root = tmp_path / "lm_pkg"
    root.mkdir()
    (root / "mod_a.py").write_text(MOD_A)
    (root / "mod_b.py").write_text(MOD_B)
    a = _load(str(root / "mod_a.py"), f"lm_mod_a_{id(tmp_path)}")
    b = _load(str(root / "mod_b.py"), f"lm_mod_b_{id(tmp_path)}")
    rules = [(a.__file__, "frontend"), (b.__file__, "blockmgr")]
    return a, b, rules, str(root) + os.sep


@pytest.fixture(autouse=True)
def clean_tracer():
    was = tracer.enabled
    tracer.ring.clear()
    yield
    tracer.stop_meter()
    tracer.enabled = was
    tracer.ring.clear()


def _metered(body, rules, root):
    """Run `body()` on a fresh loop under a meter with the given map;
    -> (body's result, the loop.window and loop.stall records)."""
    async def main():
        assert tracer.start_meter(rules=rules, root=root) is not None
        try:
            return await body()
        finally:
            tracer.stop_meter()

    out = asyncio.run(main())
    recs = list(tracer.ring)
    return (out, [r for r in recs if r["name"] == "loop.window"],
            [r for r in recs if r["name"] == "loop.stall"])


def _total(windows, key):
    return sum(w["attrs"][key] for w in windows)


def test_known_split_at_the_default_switch_interval(layers, tmp_path):
    """For 3 s the loop alternates pure-Python work (mod_a) and blocking
    file writes (mod_b), at CPython's default 5 ms switch interval with
    another thread wanting the GIL; the meter's split of the busy time
    between the two layers is within 10 points of the split the loop
    thread times itself, and the six layers add up to the busy time."""
    a, b, rules, root = layers
    path = str(tmp_path / "w.bin")
    old = sys.getswitchinterval()
    sys.setswitchinterval(0.005)
    stop = threading.Event()

    def hog():
        while not stop.is_set():
            sum(i for i in range(2000))

    th = threading.Thread(target=hog, daemon=True)

    async def body():
        ta = tb = 0.0
        end = time.perf_counter() + 3.0
        while time.perf_counter() < end:
            t0 = time.perf_counter()
            a.work(60000)
            t1 = time.perf_counter()
            b.writes(path, 1)
            t2 = time.perf_counter()
            ta += t1 - t0
            tb += t2 - t1
            await asyncio.sleep(0)
        return ta, tb

    th.start()
    try:
        (ta, tb), windows, _ = _metered(body, rules, root)
    finally:
        stop.set()
        th.join()
        sys.setswitchinterval(old)
    busy = _total(windows, "busy_us")
    us = {name: _total(windows, "us." + name) for name in tracing.LAYERS}
    assert sum(us.values()) == busy
    assert all(w["attrs"]["busy_us"] == sum(
        w["attrs"]["us." + n] for n in tracing.LAYERS) for w in windows)
    # the two parts are the loop's work: the rest is the loop's glue
    assert us["frontend"] + us["blockmgr"] >= 0.9 * busy, us
    got = us["frontend"] / (us["frontend"] + us["blockmgr"])
    want = ta / (ta + tb)
    assert abs(got - want) <= 0.10, (got, want, us)


def test_a_blocked_loop_gives_a_stall_and_its_lag(layers):
    """A 100 ms block in mod_a.block: a loop.stall of at least 90 ms
    naming that function and its layer, and a heartbeat at least 90 ms
    late."""
    a, _b, rules, root = layers

    async def body():
        await asyncio.sleep(0.05)
        a.block(0.1)
        await asyncio.sleep(0.05)

    _, windows, stalls = _metered(body, rules, root)
    mine = [s for s in stalls if s["attrs"]["func"].endswith("mod_a:block")]
    assert mine, stalls
    assert max(s["dur_us"] for s in mine) >= 90_000
    assert mine[0]["attrs"]["layer"] == "frontend"
    assert max(w["attrs"]["lag_us_max"] for w in windows) >= 90_000
    assert _total(windows, "beats") >= 5


def test_records_are_root_spans_the_otlp_exporter_takes(layers):
    from garage_tpu_torch.utils.otlp import span_to_otlp

    a, _b, rules, root = layers

    async def body():
        a.block(0.01)
        await asyncio.sleep(0.02)

    _, windows, stalls = _metered(body, rules, root)
    for r in windows + stalls:
        assert r["parent"] is None and r["trace"] and r["span"]
        out = span_to_otlp(r)
        assert out["name"] == r["name"] and out["attributes"]


def test_a_span_and_a_stall_share_one_clock(layers):
    """A span and the loop.stall around the same blocking call agree on
    their start and end within 2 ms, and start_us is wall-clock us."""
    a, _b, rules, root = layers
    tracer.enabled = True

    async def body():
        await asyncio.sleep(0.02)
        t = time.time()
        with span("loopmeter.block"):
            a.block(0.05)
        await asyncio.sleep(0.02)
        return t

    t_wall, _windows, stalls = _metered(body, rules, root)
    sp = [r for r in tracer.ring if r["name"] == "loopmeter.block"][0]
    st = [s for s in stalls if s["attrs"]["func"].endswith("mod_a:block")][0]
    assert abs(sp["start_us"] - st["start_us"]) <= 2000, (sp, st)
    assert abs((sp["start_us"] + sp["dur_us"])
               - (st["start_us"] + st["dur_us"])) <= 2000, (sp, st)
    assert abs(sp["start_us"] - t_wall * 1e6) <= 2000


def test_tracing_off_starts_no_thread_no_heartbeat_no_hook():
    """Tracing off: no extra thread, no scheduled heartbeat, no selector
    hook, no monitoring tool and no record; enable() in the loop starts
    all of it and disable() takes all of it away again."""
    mon = sys.monitoring
    tracer.enabled = False

    def state(loop):
        return (threading.active_count(),
                "select" in loop._selector.__dict__,
                "close" in loop.__dict__,
                sum(1 for h in loop._scheduled if not h.cancelled()),
                mon.get_tool(mon.PROFILER_ID))

    async def body():
        loop = asyncio.get_running_loop()
        before = state(loop)
        with span("off"):
            await asyncio.sleep(0.03)
        during = state(loop)
        tracer.enable()
        on = state(loop)
        await asyncio.sleep(0.03)
        tracer.disable()
        after = state(loop)
        return before, during, on, after

    before, during, on, after = asyncio.run(body())
    assert before == during == (before[0], False, False, 0, None)
    assert not tracer.ring or all(
        r["name"] in ("loop.window", "loop.stall") for r in tracer.ring)
    assert on[1:] == (True, True, 1, tracing.LoopMeter.NAME)
    assert on[0] == before[0]  # the meter runs no thread
    assert after == before
    # off again, and outside any loop enable() starts no meter
    tracer.ring.clear()
    asyncio.run(asyncio.sleep(0.03))
    assert not tracer.ring
    tracer.enable()
    assert tracer.meter is None
    tracer.disable()


def test_the_meter_stops_with_its_loop(layers):
    _a, _b, rules, root = layers

    async def body():
        return tracer.start_meter(rules=rules, root=root)

    m = asyncio.run(body())
    assert m is not None and not m.running and tracer.meter is None
    assert sys.monitoring.get_tool(sys.monitoring.PROFILER_ID) is None


def _stub_feeder(fixed_s: float, max_batch: int) -> DeviceFeeder:
    f = DeviceFeeder(mode="require", max_batch=max_batch,
                     backend=StubDeviceBackend(None, fixed_s=fixed_s),
                     device="cpu")
    f._device_ok = True
    return f


def test_feeder_waits_grow_behind_a_slow_stage(monkeypatch):
    """Eight one-item batches behind a stub device whose every stage
    takes 20 ms: each item waits in the queue for an in-flight slot and
    each staged job for its stage thread, and both counters say so."""
    monkeypatch.delenv("GARAGE_TPU_DEVICE", raising=False)
    f = _stub_feeder(0.02, max_batch=1)
    blobs = [bytes([i]) * 4096 for i in range(8)]

    async def go():
        try:
            return await asyncio.gather(*[f.hash(b) for b in blobs])
        finally:
            await f.stop()

    out = asyncio.run(go())
    assert out == [tnative.blake3(b) for b in blobs]
    st = f.stats
    assert st["queued_items"] == 8 and st["stage_jobs"] == 24, st
    # inflight_batches slots of 3 x 20 ms stages: the later items wait
    # for tens of ms in the queue, and jobs for their stage thread
    assert st["queue_wait_us"] / st["queued_items"] >= 10_000, st
    assert st["stage_wait_us"] / st["stage_jobs"] >= 2_000, st
    assert "op_busy_s" not in f.pipeline_stats()


def test_feeder_inline_items_add_no_wait():
    tnative.available()
    f = DeviceFeeder(mode="off", device="cpu")
    blob = b"\x07" * 4096

    async def go():
        try:
            return await f.hash(blob)
        finally:
            await f.stop()

    assert asyncio.run(go()) == tnative.blake3(blob)
    st = f.stats
    assert st["inline_items"] == 1
    assert st["queued_items"] == st["queue_wait_us"] == 0
    assert st["stage_jobs"] == st["stage_wait_us"] == 0


def _window(busy, idle, lag_sum=0, beats=0, **us):
    attrs = {"busy_us": busy, "idle_us": idle, "meter_us": 1, "events": 0,
             "lag_us_sum": lag_sum, "beats": beats, "lag_us_max": 0}
    for name in tracing.LAYERS:
        attrs["us." + name] = us.get(name, 0)
    return {"name": "loop.window", "trace": "t", "span": "s",
            "parent": None, "start_us": 0, "dur_us": busy + idle,
            "attrs": attrs}


def _run_data(spans=(), feeder=None):
    return harness.RunData(op="put", seconds=10.0, records=[], setup_s=1.0,
                           spec={}, cfg={}, spans=list(spans),
                           feeder=dict(feeder or {}))


READERS = {
    "loop.busy_share.put": 60.0,
    "loop.runtime_share.put": 10.0,
    "frontend.loop_share.put": 5.0,
    "tables.loop_share.put": 25.0,
    "blockmgr.loop_share.put": 15.0,
    "loop.lag_ms.put": 1.5,
    "feeder.queue_wait_ms.put": 2.5,
    "staging.stage_wait_ms.put": 0.75,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_hand_built_run(name):
    spans = [
        _window(400_000, 100_000, lag_sum=30_000, beats=20,
                frontend=50_000, tables=150_000, blockmgr=100_000,
                runtime=60_000, feeder=20_000, other=20_000),
        _window(200_000, 300_000, lag_sum=15_000, beats=10,
                frontend=0, tables=100_000, blockmgr=50_000,
                runtime=40_000, feeder=5_000, other=5_000),
        {"name": "block.put", "trace": "t", "span": "x", "parent": None,
         "start_us": 0, "dur_us": 5, "attrs": {}},
    ]
    feeder = {"queued_items": 4, "queue_wait_us": 10_000,
              "stage_jobs": 8, "stage_wait_us": 6_000, "items": 4}
    read = harness.reader(name)
    assert read(_run_data(spans, feeder)) == pytest.approx(READERS[name])
    # a run of a program that has no loop meter or no such counters
    assert read(_run_data([spans[2]], {"items": 4})) is None
    assert read(_run_data()) is None


def test_share_readers_add_up_to_the_busy_share():
    windows = [_window(700, 300, frontend=100, tables=200, blockmgr=150,
                       feeder=50, runtime=120, other=80)]
    d = _run_data(windows)
    parts = sum(harness.reader(n)(d) for n in (
        "frontend.loop_share.put", "tables.loop_share.put",
        "blockmgr.loop_share.put", "loop.runtime_share.put"))
    rest = 100.0 * (50 + 80) / 1000
    assert parts + rest == pytest.approx(
        harness.reader("loop.busy_share.put")(d))
