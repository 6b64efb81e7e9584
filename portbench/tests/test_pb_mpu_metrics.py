"""The readers of the multipart and replicate spans
(portbench/metrics/mpu.complete_ms.put.py, mpu.ref_repoint_share.put.py
and blockmgr.write_replicas_ms.put.py) on hand-built span records: their
arithmetic, a re-point counted only inside a Complete the window holds,
and nothing read from a run whose program emits no such span."""

import pytest

from portbench import harness

NEW = ("mpu.complete_ms.put", "mpu.ref_repoint_share.put",
       "blockmgr.write_replicas_ms.put")


def _span(name, dur_us, span="s", parent=None, **attrs):
    return {"name": name, "trace": "t", "span": span, "parent": parent,
            "start_us": 0, "dur_us": dur_us, "attrs": attrs}


def _run(spans):
    return harness.RunData(op="put", seconds=51.0, records=[], setup_s=1.0,
                           spec={}, cfg={}, spans=list(spans))


SPANS = [
    _span("s3.mpu.complete", 4_000, span="c1", parts=2, blocks=20),
    _span("s3.mpu.ref_repoint", 3_000, span="r1", parent="c1", blocks=20),
    _span("s3.mpu.complete", 2_000, span="c2", parts=1, blocks=4),
    _span("s3.mpu.ref_repoint", 500, span="r2", parent="c2", blocks=4),
    # the re-point of a Complete that straddles the window's close: the
    # window holds it, not its Complete
    _span("s3.mpu.ref_repoint", 9_000, span="r3", parent="c3", blocks=90),
    _span("block.write_replicas", 1_500, span="w1", copies=3, quorum=2),
    _span("block.write_replicas", 2_500, span="w2", copies=3, quorum=2),
    _span("block.write_replicas", 5_000, span="w3", copies=3, quorum=2),
    _span("block.put", 70_000, span="p1"),
    _span("s3.mpu.put_part", 90_000, span="u1", part=1, size=16 << 20),
]

WANT = {
    "mpu.complete_ms.put": (4_000 + 2_000) / 2 / 1e3,
    "mpu.ref_repoint_share.put": 100.0 * (3_000 + 500) / (4_000 + 2_000),
    "blockmgr.write_replicas_ms.put": (1_500 + 2_500 + 5_000) / 3 / 1e3,
}


@pytest.mark.parametrize("name", NEW)
def test_reader_arithmetic(name):
    assert harness.reader(name)(_run(SPANS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_without_its_spans(name):
    # the parent program has no such span: the reader returns None, and
    # the result line leaves the metric out
    others = [s for s in SPANS if s["name"] in ("block.put",
                                                "s3.mpu.put_part")]
    assert harness.reader(name)(_run(others)) is None
    assert harness.reader(name)(_run([])) is None


def test_a_repoint_outside_every_complete_reads_zero_share():
    spans = [_span("s3.mpu.complete", 1_000, span="c1"),
             _span("s3.mpu.ref_repoint", 800, span="r", parent="cX")]
    assert harness.reader("mpu.ref_repoint_share.put")(_run(spans)) == 0.0


def test_the_manifest_lists_the_readers_for_the_cell():
    m = harness.load_manifest()
    traced = {x["name"] for x in harness.metrics_of(
        m, "rep3.put_multipart_16m", True)}
    assert set(NEW) <= traced
    assert {x["name"] for x in harness.metrics_of(
        m, "rep3.put_multipart_16m", False)} == {"put_gbps", "setup_s"}
    assert not set(NEW) & {x["name"] for x in harness.metrics_of(
        m, "ec10_4.put_unsigned", True)}
