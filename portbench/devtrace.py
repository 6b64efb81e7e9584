"""Reduction of a torch.profiler trace of the window: device busy time
(a frozen copy of chip_smoke.py's `device_busy`: the union of the card's
kernel, copy and memset intervals), kernel seconds by name, and the
longest idle gaps, named by the host spans open across them."""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALIBRATION_KERNEL = "spin"  # torch.cuda._sleep's kernel


def device_events(path: str) -> tuple[list, list]:
    """-> (device events sorted by start, host runtime events) of a
    chrome trace, as (start us, end us, cat, name)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        t0 = float(e["ts"])
        item = (t0, t0 + float(e.get("dur", 0.0)), e.get("cat"),
                e.get("name", ""), (e.get("args") or {}).get("correlation"))
        if e.get("cat") in DEVICE_CATS:
            dev.append(item)
        elif e.get("cat") == "cuda_runtime":
            host.append(item)
    dev.sort()
    return dev, host


def busy(dev: list, lo: float, hi: float) -> dict:
    """Union of the device intervals (us) clipped to [lo, hi], their
    sums by category, kernel seconds by name and the idle gaps between
    them."""
    total, end = 0.0, lo
    by_cat: dict = {}
    by_kernel: dict = {}
    gaps: list = []
    for t0, t1, cat, name, _ in dev:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 <= t0:
            continue
        if t0 > end:
            gaps.append((end, t0))
        total += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_cat[cat] = by_cat.get(cat, 0.0) + (t1 - t0) / 1e6
        if cat == "kernel":
            key = name.split("(")[0]
            by_kernel[key] = by_kernel.get(key, 0.0) + (t1 - t0) / 1e6
    if hi > end:
        gaps.append((end, hi))
    return {"busy_s": total / 1e6, "by_cat": by_cat, "by_kernel": by_kernel,
            "gaps": gaps}


def clock_offset(dev: list, host: list, wall_us: float) -> float | None:
    """Trace clock minus wall clock (us), from the calibration kernel
    launched at `wall_us`: its launch's runtime event, else the kernel
    itself."""
    for t0, _t1, cat, name, corr in dev:
        if cat == "kernel" and CALIBRATION_KERNEL in name:
            launch = [h for h in host if corr is not None and h[4] == corr]
            return (launch[0][0] if launch else t0) - wall_us
    return None


def name_gaps(gaps: list, spans: list, offset: float | None,
              top: int = 10) -> list:
    """The `top` longest idle gaps, each named by the host spans open
    across its middle (innermost names, by count), as [name, seconds]."""
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:top]
    out = []
    for g0, g1 in longest:
        name = "host spans not aligned"
        if offset is not None:
            mid = (g0 + g1) / 2 - offset
            open_ = [s["name"] for s in spans
                     if s["start_us"] <= mid <= s["start_us"] + s["dur_us"]]
            counts: dict = {}
            for n in open_:
                counts[n] = counts.get(n, 0) + 1
            name = (", ".join(f"{n} x{c}" for n, c in sorted(
                counts.items(), key=lambda kv: -kv[1])[:4])
                if counts else "no host span open")
        out.append([name, (g1 - g0) / 1e6])
    return out
