"""One run of one cell: set-up, the window, the check, the result line.

Everything is found by name: the cell's entry in BENCHMARK.json names
its configuration (portbench/configs/<config>.json) and traffic mix
(portbench/traffic/<traffic>.json); each metric it reports is a reader
in portbench/metrics/<metric>.py. Every file the run writes (node data
and metadata, spans, the profiler's trace) goes under one directory in
TMPDIR, removed at the end."""

from __future__ import annotations

import asyncio
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

from portbench import check, devtrace, faults, traffic, window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUCKET = "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "garage_tpu")
# bytes of acknowledged objects the stored-block check reads back
CHECK_BYTES = 64 << 20


class RunError(Exception):
    pass


def load_manifest(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise RunError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["name"] = name
    return cfg


def metrics_of(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def reader(name: str, root: str = HERE):
    """The `read` function of portbench/metrics/<name>.py."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class RunData:
    """What a metric's reader reads."""
    op: str
    seconds: float
    records: list
    setup_s: float
    spec: dict
    cfg: dict
    spans: list = field(default_factory=list)
    feeder: dict = field(default_factory=dict)
    stage_busy: dict = field(default_factory=dict)
    op_items: dict = field(default_factory=dict)
    device: dict | None = None


def _sum_stats(feeders) -> tuple[dict, dict, dict]:
    stats: dict = {}
    stages: dict = {}
    items: dict = {}
    for f in feeders:
        for k, v in f.stats.items():
            stats[k] = stats.get(k, 0) + v
        pl = f.pipeline_stats()
        for k, v in pl["busy_s"].items():
            stages[k] = stages.get(k, 0.0) + v
        for k, v in pl["op_items"].items():
            items[k] = items.get(k, 0) + v
    return stats, stages, items


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a.get(k, 0) for k in b}


class LoadGenProc:
    """The load generator's process and its line protocol."""

    proc = None

    async def start(self, params: dict) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "portbench.loadgen", cwd=ROOT, env=env,
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
            limit=1 << 28)
        await self.send(params)
        await self.expect("ready")

    async def send(self, obj: dict) -> None:
        self.proc.stdin.write((json.dumps(obj) + "\n").encode())
        await self.proc.stdin.drain()

    async def expect(self, event: str, timeout: float = 900.0) -> dict:
        line = await asyncio.wait_for(self.proc.stdout.readline(), timeout)
        if not line:
            raise RunError(f"load generator ended before {event!r}")
        msg = json.loads(line)
        if msg.get("event") != event:
            raise RunError(f"load generator sent {msg.get('event')!r}, "
                           f"expected {event!r}")
        return msg

    async def close(self) -> None:
        if self.proc is not None and self.proc.returncode is None:
            try:
                await self.send({"cmd": "quit"})
                await asyncio.wait_for(self.proc.wait(), 60)
            except (OSError, asyncio.TimeoutError):
                self.proc.kill()
                await self.proc.wait()


class Profiler:
    """torch.profiler on the card's activity, started before the ramp
    and stopped once the window has drained (its start and stop hold
    the event loop for seconds, so never with a request in flight),
    with a calibration kernel that ties its clock to the wall clock;
    the summary reads the window's stretch of the trace alone."""

    def __init__(self, work: str):
        self.path = os.path.join(work, "trace.json")

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.wall_us = time.time() * 1e6
        torch.cuda._sleep(1000)

    def stop(self) -> None:
        self.prof.stop()

    def summary(self, spans: list, w0_us: float,
                seconds: float) -> dict | None:
        """-> the device's time in the window [w0_us, + seconds] (wall
        clock), or None where the trace cannot be placed on it."""
        self.prof.export_chrome_trace(self.path)
        dev, host = devtrace.device_events(self.path)
        os.unlink(self.path)
        offset = devtrace.clock_offset(dev, host, self.wall_us)
        if offset is None:
            return None
        lo = w0_us + offset
        b = devtrace.busy([e for e in dev
                           if devtrace.CALIBRATION_KERNEL not in e[3]],
                          lo, lo + seconds * 1e6)
        return {"busy_s": b["busy_s"], "window_s": seconds,
                "kernel_s": b["by_cat"].get("kernel", 0.0),
                "by_cat": b["by_cat"], "by_kernel": b["by_kernel"],
                "gaps": devtrace.name_gaps(b["gaps"], spans, offset)}


def read_spans(path: str, lo_us: float, hi_us: float) -> list:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            s = json.loads(line)
            if s["start_us"] >= lo_us and s["start_us"] + s["dur_us"] <= hi_us:
                out.append(s)
    return out


def _acked_puts(records: list, uploads: list, plan) -> list:
    """The units of the stored-block check in a PUT mix: each
    acknowledged PutObject, and each part of a completed upload (the
    port cuts every part into blocks of its own)."""
    uploaded = {u[0] for u in uploads}
    units = [("put", r[0], r[3]) for r in records
             if r[4] == 200 and r[0] not in uploaded]
    for i, size, _n, status, *_ in uploads:
        if status == 200:
            units += [("part", (i, n), s) for n, s in
                      enumerate(plan.part_sizes(size), 1)]
    return units


def _multipart_summary(uploads: list, seconds: float,
                       readback: dict | None) -> dict:
    """What a multipart mix adds to the result's "window": its uploads,
    each Complete's seconds, sorted, the bytes of the uploads completed
    inside the window over its seconds (GB/s), and the read-back."""
    sent = [u for u in uploads if u[3] is not None]
    done = [u for u in uploads if u[3] == 200 and 0 <= u[6] <= seconds]
    return {"uploads": len(uploads),
            "uploads_completed": sum(1 for u in uploads if u[3] == 200),
            "parts": sum(u[2] for u in uploads),
            "complete_s": sorted(u[6] - u[5] for u in sent),
            "completed_in_window_gbps":
                sum(u[1] for u in done) / 1e9 / seconds,
            "readback": readback}


async def run(cell_name: str, seed: int, seconds: float, trace: bool,
              t_start_wall: float, device: str = "cuda",
              fault: str | None = None, manifest: dict | None = None,
              check_bytes: int = CHECK_BYTES, bench_root: str = HERE) -> dict:
    """One run -> the result line's object (with "checks" last).
    `bench_root` holds configs/, traffic/ and metrics/."""
    manifest = manifest if manifest is not None else load_manifest()
    cell = cell_of(manifest, cell_name)
    cfg = load_config(cell["config"], bench_root)
    spec = traffic.load(cell["traffic"], bench_root)
    wanted = metrics_of(manifest, cell_name, trace)
    readers = {m["name"]: reader(m["name"], bench_root) for m in wanted}
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        return await _run(cell, cfg, spec, seed, seconds, trace,
                          t_start_wall, device, fault, wanted, readers,
                          work, check_bytes)
    finally:
        shutil.rmtree(work, ignore_errors=True)


async def _run(cell, cfg, spec, seed, seconds, trace, t_start_wall, device,
               fault, wanted, readers, work, check_bytes) -> dict:
    import torch

    from garage_tpu_torch import native
    from garage_tpu_torch.utils import tracing

    from portbench.cluster import Cluster

    if device == "cuda":
        from garage_tpu_torch.ops import _build

        _build.build_all()
    # the host library the nodes use for MD5 lanes, CRC-32C and the
    # inline paths: built (or loaded) before the window, never in it
    native.available()
    cluster = Cluster(os.path.join(work, "nodes"), cfg, device)
    gen = LoadGenProc()
    plan = traffic.Plan(spec, seed)
    out: dict = {}
    try:
        t0 = time.monotonic()
        await cluster.start()
        out["boot_s"] = time.monotonic() - t0
        out["settle_s"] = await cluster.settle()
        port = await cluster.serve_s3()
        key_id, secret = await cluster.key_and_bucket(BUCKET)
        cluster.deployed_intervals()
        await gen.start({"traffic": spec, "seed": seed, "host": "127.0.0.1",
                         "port": port, "key_id": key_id, "secret": secret,
                         "region": cluster.garages[0].config.s3_region,
                         "bucket": BUCKET})
        fill_bad = 0
        if plan.fill_count:
            await gen.send({"cmd": "fill"})
            filled = await gen.expect("filled")
            out["fill_s"] = filled["seconds"]
            fill_bad = len(filled["bad"])
            for i in range(cfg["nodes"] - spec.get("stop_nodes", 0),
                           cfg["nodes"]):
                await cluster.stop_node(i)
        if fault:
            faults.install(fault, cluster, spec)
        t0 = time.monotonic()
        await gen.send({"cmd": "warm"})
        await gen.expect("warmed")
        out["warm_s"] = time.monotonic() - t0
        if device == "cuda":
            torch.cuda.synchronize()
        span_path = os.path.join(work, "spans.jsonl")
        prof = Profiler(work) if trace and device == "cuda" else None
        if trace:
            tracing.tracer.enable(span_path)
            if prof:
                prof.start()
        await gen.send({"cmd": "window", "seconds": seconds,
                        "ramp": spec.get("ramp_s", 0.0)})
        started = await gen.expect("window_start",
                                   120 + spec.get("ramp_s", 0.0))
        live = [f for f, up in zip(cluster.feeders(), cluster.alive) if up]
        before = _sum_stats(live)
        await gen.expect("window_end", seconds + 120)
        after = _sum_stats(live)
        done = await gen.expect("window_done", 900)
        if trace:
            if prof:
                prof.stop()
            tracing.tracer.disable()
        if device == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        forged, readback = [], None
        if spec.get("multipart"):
            await gen.send({"cmd": "readback"})
            readback = await gen.expect("read_back", 900)
            del readback["event"]
        if spec.get("payload") == "signed":
            await gen.send({"cmd": "probe"})
            forged = (await gen.expect("probed"))["statuses"]
        await gen.close()
        tracing.tracer.flush()
        w0 = started["wall"] * 1e6
        spans = (read_spans(span_path, w0, w0 + seconds * 1e6)
                 if trace else [])
        data = RunData(
            op=spec["op"], seconds=seconds, records=done["records"],
            setup_s=started["wall"] - t_start_wall, spec=spec, cfg=cfg,
            spans=spans,
            feeder=_delta(before[0], after[0]),
            stage_busy=_delta(before[1], after[1]),
            op_items=_delta(before[2], after[2]),
            device=prof.summary(spans, w0, seconds) if prof else None)
    finally:
        await gen.close()
        await cluster.stop()
    # the reference runs once the program's state is freed
    uploads = done["uploads"]
    acked = (_acked_puts(data.records, uploads, plan)
             if spec["op"] == "put" else
             [("fill", j, plan.fill_size(j)) for j in range(plan.fill_count)])
    t0 = time.monotonic()
    picked = check.sample(acked, seed, check_bytes)
    data_dirs = [cluster.data_dir(i) for i in range(cfg["nodes"])]
    stored = check.stored(cfg, plan, picked, data_dirs)
    out["check_s"] = time.monotonic() - t0
    recs = data.records
    readback_bad = int(readback is not None and readback["index"] is not None
                       and not readback["ok"])
    checks = {
        "failed": sum(1 for r in recs if r[4] != 200) + fill_bad
        + sum(1 for u in uploads if u[3] != 200),
        "etag_bad": sum(1 for r in recs if r[4] == 200 and r[5] is False)
        if spec["op"] == "put" else 0,
        "get_bad": (sum(1 for r in recs if r[4] == 200 and r[5] is False)
                    if spec["op"] == "get" else 0) + readback_bad,
        "blocks_unfound": stored["blocks_unfound"],
        "shards_bad": stored["shards_bad"],
        "blocks_below_quorum": stored["blocks_below_quorum"],
    }
    if spec.get("payload") == "signed":
        checks["forged_accepted"] = sum(1 for s in forged if s == 200)
    limits = {k: 0 for k in checks}
    checks["objects_checked"] = len(picked)
    limits["objects_checked"] = 1  # at least: an empty check proves nothing
    correct = all(checks[k] <= limits[k] for k in limits
                  if k != "objects_checked") and checks["objects_checked"] >= 1
    metrics = {}
    for m in wanted:
        v = readers[m["name"]](data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": 1,
           "memory_peak_bytes": out.get("memory_peak_bytes", 0)}
    in_window = window.started(recs, seconds)
    result = {"correct": correct, "attempted": len(in_window),
              "failed": sum(1 for r in in_window if r[4] != 200),
              "metrics": metrics, "device": dev}
    if data.device is not None:
        dev["busy_s"] = data.device["busy_s"]
        dev["window_s"] = data.device["window_s"]
        ops = sorted(data.device["by_kernel"].items(),
                     key=lambda kv: -kv[1])[:8]
        ops += [[f"[{c}]", s] for c, s in data.device["by_cat"].items()
                if c != "kernel"]
        result["breakdown"] = {
            "device_ops": [list(x) for x in
                           sorted(ops, key=lambda kv: -kv[1])[:10]],
            "idle_gaps": data.device["gaps"]}
    result["window"] = {"requests": len(recs),
                        "started_in_window": len(in_window),
                        "drained_s": done["drained_s"],
                        **{k: out[k] for k in ("boot_s", "settle_s",
                                               "fill_s", "warm_s", "check_s")
                           if k in out},
                        "blocks_checked": stored["blocks_checked"]}
    if spec.get("multipart"):
        result["window"].update(
            _multipart_summary(uploads, seconds, readback))
    result["checks"] = {k: {"value": checks[k],
                            "limit": limits[k],
                            "bound": "min" if k == "objects_checked"
                            else "max"} for k in checks}
    return result
