"""Whole runs on the CPU, at a size a test holds: the port's nodes with
their kernels' plain torch versions, the load generator, the window and
the check. A cell, a traffic mix and a metric that exist only in a
temporary copy of the manifest and of the data files are found by name;
the run loads neither JAX nor the JAX package; the control and each
fault the cells can have make `correct` false; and run.py refuses to
run without a card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from conftest import ROOT, small_bench

RUN = r"""
import asyncio, json, sys, time
sys.path.insert(0, {root!r})
from portbench import harness
t = time.time()
manifest = json.load(open({manifest!r}))
r = asyncio.run(harness.run({cell!r}, {seed}, {seconds}, {trace}, t,
                            device="cpu", fault={fault!r}, manifest=manifest,
                            bench_root={bench!r}, check_bytes=4 << 20))
print(json.dumps({{"result": r, "modules": sorted(
    {{m.split(".")[0] for m in sys.modules}})}}))
"""


def cpu_run(tmp_path, cell, *, fault=None, trace=False, seconds=4.0,
            extra_cell=None, extra_files=None):
    bench = small_bench(str(tmp_path / "bench"))
    manifest = harness.load_manifest()
    if cell not in {w["name"] for w in manifest["workloads"]} \
            and not extra_cell:
        # a pairing of a configuration and a mix that the manifest does
        # not measure (their files are there): run it all the same
        config, mix = cell.split(".")
        manifest["workloads"].append({"name": cell, "config": config,
                                      "traffic": mix, "chips": 1,
                                      "why": "a test's cell"})
    if extra_cell:
        manifest["workloads"].append(extra_cell["workload"])
        manifest["per_layer"].extend(extra_cell.get("per_layer", []))
        for m in manifest["end_to_end"]:
            if "workloads" in m and m["name"] in extra_cell.get("e2e", ()):
                m["workloads"].append(extra_cell["workload"]["name"])
    for rel, text in (extra_files or {}).items():
        with open(os.path.join(bench, rel), "w") as f:
            f.write(text)
    mpath = str(tmp_path / "BENCHMARK.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    code = RUN.format(root=ROOT, manifest=mpath, cell=cell, seed=2**31 + 11,
                      seconds=seconds, trace=trace, fault=fault, bench=bench)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


NEW_CELL = {
    "workload": {"name": "rep3.put_small", "config": "rep3",
                 "traffic": "put_small", "chips": 1,
                 "why": "a cell that only the test's manifest has"},
    "e2e": ("put_gbps",),
    "per_layer": [{"name": "feeder.hash_items.put", "unit": "items",
                   "better": "higher", "source": "program_counter",
                   "layer": "feeder queue and batching",
                   "moves": "put_gbps",
                   "workloads": ["rep3.put_small"]}],
}
NEW_FILES = {
    "traffic/put_small.json": json.dumps({
        "op": "put", "payload": "unsigned", "clients": 4,
        "size_min": 4096, "size_max": 262144,
        "strata": 8}),
    "metrics/feeder.hash_items.put.py": (
        "def read(r):\n"
        "    n = r.op_items.get('hash_md5', 0)\n"
        "    return float(n) if n else None\n"),
}


def test_a_cell_found_only_by_name_runs_and_proves_correct(tmp_path):
    out = cpu_run(tmp_path, "rep3.put_small", extra_cell=NEW_CELL,
                  extra_files=NEW_FILES)
    r = out["result"]
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"put_gbps", "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "checks"
    # the independence check, by whole top-level names
    assert not {"jax", "jaxlib", "flax", "garage_tpu"} & set(out["modules"])
    assert "garage_tpu_torch" in out["modules"]


def test_traced_run_reads_the_new_metric(tmp_path):
    out = cpu_run(tmp_path, "rep3.put_small", trace=True,
                  extra_cell=NEW_CELL, extra_files=NEW_FILES)
    r = out["result"]
    assert r["correct"] is True, r["checks"]
    # device metrics read nothing on the CPU and are left out
    # only the metric whose workloads name the new cell
    assert set(r["metrics"]) == {"feeder.hash_items.put"}


MULTIPART_CELL = {
    "workload": {"name": "ec10_4.put_multipart_16m", "config": "ec10_4",
                 "traffic": "put_multipart_16m", "chips": 1,
                 "why": "a multipart cell that only the test's manifest has"},
    "e2e": ("put_gbps",),
}


# the multipart mix as small_bench cuts it, its parts sent as signed
# aws-chunked bodies
SIGNED_MULTIPART = {"traffic/put_multipart_signed.json": json.dumps({
    "op": "put", "payload": "signed", "chunk": 65536, "clients": 4,
    "size_min": 256 << 10, "size_max": 2 << 20, "strata": 8, "ramp_s": 1,
    "multipart": {"threshold": 256 << 10, "part_size": 256 << 10}})}


@pytest.mark.parametrize("payload", ["unsigned", "signed"])
def test_a_multipart_cell_found_only_by_name_proves_correct(tmp_path,
                                                            payload):
    """A configuration file, a traffic file and a manifest entry are all
    a multipart cell needs; parts go as the mix's payload says."""
    cell = {**MULTIPART_CELL, "workload": dict(MULTIPART_CELL["workload"])}
    files = None
    if payload == "signed":
        cell["workload"].update(name="ec10_4.put_multipart_signed",
                                traffic="put_multipart_signed")
        files = SIGNED_MULTIPART
    out = cpu_run(tmp_path, cell["workload"]["name"], extra_cell=cell,
                  extra_files=files)
    r = out["result"]
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"put_gbps", "setup_s"}
    assert r["metrics"]["put_gbps"]["value"] > 0
    assert r["checks"]["objects_checked"]["value"] >= 1
    w = r["window"]
    assert w["uploads"] >= 1 and w["uploads_completed"] == w["uploads"]
    assert w["parts"] >= 2 * w["uploads"]  # 2-8 parts an object here
    assert len(w["complete_s"]) == w["uploads"]
    assert w["completed_in_window_gbps"] >= 0
    rb = w["readback"]
    assert rb["ok"] is True and rb["parts"] >= 2 and rb["status"] == 200
    if payload == "signed":
        assert r["checks"]["forged_accepted"]["value"] == 0
    assert not {"jax", "jaxlib", "flax", "garage_tpu"} & set(out["modules"])


@pytest.mark.parametrize("cell,fault", [
    ("ec10_4.put_multipart_16m", "control"),
    ("ec10_4.put_multipart_16m", "noop_put"),
    ("ec10_4.put_multipart_16m", "half_batch"),
    ("ec10_4.put_multipart_16m", "flip"),
    ("ec10_4.put_multipart_16m", "mpu_drop_part"),
    ("ec10_4.put_unsigned", "control"),
    ("ec10_4.put_unsigned", "noop_put"),
    ("ec10_4.put_unsigned", "half_batch"),
    ("ec10_4.put_unsigned", "flip"),
    ("rep3.put_signed", "control"),
    ("rep3.put_signed", "noop_put"),
    ("rep3.put_signed", "half_batch"),
    ("rep3.put_signed", "flip"),
    ("ec10_4.get_degraded", "control"),
    ("ec10_4.get_degraded", "half_batch"),
    ("ec10_4.get_degraded", "flip"),
])
def test_control_and_faults_come_out_not_correct(tmp_path, cell, fault):
    r = cpu_run(tmp_path, cell, fault=fault, seconds=6.0)["result"]
    assert r["correct"] is False, (fault, r["checks"])


def test_the_stored_blocks_check_the_sound_degraded_read(tmp_path):
    r = cpu_run(tmp_path, "ec10_4.get_degraded", seconds=4.0)["result"]
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["objects_checked"]["value"] >= 1


def test_no_card_means_no_result():
    cell = harness.load_manifest()["workloads"][0]["name"]
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         cell, "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
