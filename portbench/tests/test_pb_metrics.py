"""The metric readers and the roofline arithmetic, on made-up runs."""

import json
import os

import pytest

from portbench import harness, roofline, traffic

ROOT = harness.ROOT


def data(records, op="put", seconds=10.0, **kw):
    spec = traffic.load("put_signed" if op == "put" else "get_degraded")
    cfg = harness.load_config("ec10_4")
    return harness.RunData(op=op, seconds=seconds, records=records,
                           setup_s=12.5, spec=spec, cfg=cfg, **kw)


def test_put_rate_divides_the_window_work_by_its_seconds():
    recs = [[0, 0.0, 1.0, 4_000_000, 200, True],
            [1, 0.5, 9.9, 6_000_000, 200, True],
            # straddles the close: 1 s of its 1.4 s inside the window
            [2, 9.0, 10.4, 7_000_000, 200, True],
            # straddles the opening (started in the ramp): half inside
            [3, -1.0, 1.0, 2_000_000, 200, True],
            # wholly in the ramp, or failed: none of the window's work
            [4, -3.0, -1.0, 9_000_000, 200, True],
            [5, 1.0, 2.0, 5_000_000, 500, None]]
    got = harness.reader("put_gbps")(data(recs))
    assert got == pytest.approx(16_000_000 / 10.0 / 1e9)


def test_get_rate_counts_only_verified_bodies():
    recs = [[0, 0.0, 1.0, 3_000_000, 200, True],
            [1, 0.0, 1.0, 3_000_000, 200, False],
            [2, 0.0, 1.0, 3_000_000, 404, False]]
    got = harness.reader("get_gbps")(data(recs, op="get", seconds=2.0))
    assert got == pytest.approx(3_000_000 / 2.0 / 1e9)


def test_p95_counts_failures_as_slowest():
    p95 = harness.reader("put_p95_ms")
    ok = [[i, 0.0, (i + 1) / 1000, 1, 200, True] for i in range(100)]
    assert p95(data(ok)) == pytest.approx(95.0)
    # requests started in the ramp are not the window's
    ramp = [[300 + i, -5.0, 1.0, 1, 200, True] for i in range(50)]
    assert p95(data(ok + ramp)) == pytest.approx(95.0)
    # 5 failures among 100 requests sit above every success: the 95th
    # is the slowest success left; a sixth failure reaches it
    failed = [[100 + i, 0.0, 0.001, 1, 503, None] for i in range(6)]
    assert p95(data(ok[:95] + failed[:5])) == pytest.approx(95.0)
    assert p95(data(ok[:94] + failed)) == 1e9
    # requests still in flight at the close count with their full time
    late = [[200 + i, 9.0, 19.0, 1, 200, True] for i in range(6)]
    assert p95(data(ok[:94] + late)) == pytest.approx(10_000.0)


def test_setup_is_process_start_to_window_start():
    assert harness.reader("setup_s")(data([])) == 12.5


def test_span_readers():
    spans = [
        {"name": "http.request", "trace": "a", "dur_us": 1000,
         "attrs": {"method": "PUT"}},
        {"name": "http.request", "trace": "b", "dur_us": 3000,
         "attrs": {"method": "GET"}},
        {"name": "s3.put.first_read_and_lookup", "trace": "a",
         "dur_us": 100},
        {"name": "s3.put.chunk_read", "trace": "a", "dur_us": 300},
        {"name": "s3.put.chunk_read", "trace": "b", "dur_us": 999},
        {"name": "s3.put.flush_meta", "trace": "a", "dur_us": 2500},
        {"name": "block.put", "trace": "a", "dur_us": 7000},
        {"name": "block.put", "trace": "a", "dur_us": 9000},
    ]
    d = data([], spans=spans)
    assert harness.reader("frontend.chunk_read_share.put")(d) == \
        pytest.approx(40.0)
    assert harness.reader("tables.flush_meta_ms.put")(d) == 2.5
    assert harness.reader("blockmgr.put_block_ms.put")(d) == 8.0
    assert harness.reader("tables.flush_meta_ms.put")(data([])) is None


def test_counter_readers():
    d = data([], feeder={"items": 30, "batches": 12},
             stage_busy={"h2d": 1.0, "compute": 2.0, "d2h": 1.0})
    assert harness.reader("feeder.items_per_batch.put")(d) == 2.5
    assert harness.reader("staging.copy_share.put")(d) == 50.0
    assert harness.reader("feeder.items_per_batch.put")(data([])) is None


def test_device_readers_read_nothing_without_a_trace():
    for name in ("kernels_roofline.put", "device.idle_share.put"):
        assert harness.reader(name)(data([])) is None
    dev = {"busy_s": 0.5, "window_s": 10.0, "kernel_s": 0.4}
    d = data([], device=dev, op_items={"hash_md5": 100, "sha256": 1000,
                                       "encode_put": 100})
    assert harness.reader("device.idle_share.put")(d) == pytest.approx(95.0)
    share = harness.reader("kernels_roofline.put")(d)
    assert 0 < share < 100


def test_roofline_least_time_comes_from_shapes_alone():
    spec = traffic.load("put_signed")
    cfg = harness.load_config("ec10_4")
    per = roofline.per_item_s(spec, cfg)
    assert set(per) == {"hash_md5", "encode_put", "sha256"}
    # a full 1 MiB block through G1 is bound by its bytes: 14 shards of
    # 104,858 B read or written once
    s = -(-((1 << 20) + 1) // 10)
    assert s == 104858
    assert roofline.g1_s(s, 10, 4) == pytest.approx(14 * s / 3.35e12)
    # a 64 KiB chunk through S2: 1,025 compressions of 1,407 lane
    # instructions at 33.5 T lane instructions/s
    assert roofline.s2_s(65536) == pytest.approx(1025 * 1407 / 33.5e12)
    # the same counts give the same least time, whoever ran them
    items = {"hash_md5": 7, "encode_put": 7, "sha256": 40, "other": 3}
    assert roofline.least_s(items, spec, cfg) == pytest.approx(
        7 * per["hash_md5"] + 7 * per["encode_put"] + 40 * per["sha256"])
    assert roofline.least_s({"other": 3}, spec, cfg) is None
    rep = harness.load_config("rep3")
    assert set(roofline.per_item_s(spec, rep)) == {"hash_md5", "sha256"}
    get = roofline.per_item_s(traffic.load("get_degraded"), cfg)
    assert set(get) == {"decode"}


def test_b3_compressions():
    # one 1 KiB chunk: 16 blocks, no parent; two chunks: 32 + 1 parent
    one = roofline.b3_s(1024) * roofline.LANE_OPS_PER_S
    two = roofline.b3_s(2048) * roofline.LANE_OPS_PER_S
    assert one == pytest.approx(16 * roofline.B3_OPS_PER_COMPRESSION)
    assert two == pytest.approx(33 * roofline.B3_OPS_PER_COMPRESSION)


def test_every_metric_of_the_manifest_has_a_reader():
    m = harness.load_manifest()
    for entry in m["end_to_end"] + m["per_layer"]:
        assert callable(harness.reader(entry["name"]))
    assert os.path.exists(os.path.join(ROOT, "BENCHMARK.json"))
    json.dumps(m)


def test_device_busy_is_the_union_of_device_intervals(tmp_path):
    from portbench import devtrace

    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "spin_kernel(long)",
         "ts": 1000.0, "dur": 5.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 990.0, "dur": 3.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "sha256_rows(...)",
         "ts": 2000.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 2050.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "sha256_rows(...)",
         "ts": 3000.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
         "ts": 2000.0, "dur": 999.0}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    dev, host = devtrace.device_events(str(path))
    assert devtrace.clock_offset(dev, host, 900.0) == 90.0
    b = devtrace.busy([e for e in dev
                       if devtrace.CALIBRATION_KERNEL not in e[3]],
                      1500.0, 3030.0)
    # 2000-2150 overlapped, then 3000-3030 inside the window: 180 us
    assert b["busy_s"] == pytest.approx(180e-6)
    assert b["by_kernel"] == {"sha256_rows": pytest.approx(130e-6)}
    assert b["gaps"] == [(1500.0, 2000.0), (2150.0, 3000.0)]
    spans = [{"name": "rpc.call", "start_us": 2400.0, "dur_us": 800.0},
             {"name": "http.request", "start_us": 1000.0, "dur_us": 5000.0}]
    named = devtrace.name_gaps(b["gaps"], spans, 0.0)
    assert named == [["rpc.call x1, http.request x1",
                      pytest.approx(850e-6)],
                     ["http.request x1", pytest.approx(500e-6)]]
