"""Copy of garage_tpu/utils/metrics.py: import paths rewritten, issue and PR tags dropped.

Lightweight in-process metrics: labeled counters + duration stats.

Ref parity: src/util/metrics.rs + the per-subsystem metric modules
(rpc/metrics.rs, table/metrics.rs, block/metrics.rs,
api/common/generic_server.rs). The reference uses OpenTelemetry; this
build keeps a dependency-free registry that the admin /metrics endpoint
renders in Prometheus text format. Durations aggregate as
count / sum / max so rates and averages are derivable.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Iterator, Optional

# The metric naming contract: <subsystem>_<snake_case>. The static rule
# GL07 (garage_tpu/analysis/) enforces it at review time on literal
# names; this runtime check enforces the SAME regex at registration
# time so a dynamically formatted name (f"qos_{key}") that escapes the
# static net still fails fast in debug mode. Keep the two in lockstep:
# the analyzer imports this regex.
METRIC_NAME_RE = re.compile(
    r"^(api|qos|cache|chaos|rpc|block|table|resync|resize|scrub|s3|meta"
    r"|gateway|feeder)_[a-z0-9_]+$")

# Debug-mode strictness: on under GARAGE_METRICS_STRICT=1 (the test
# suite sets it), off in production — a bad metric name must never
# take down a serving node. "0"/"false"/"no" disable explicitly.
STRICT_METRIC_NAMES = os.environ.get(
    "GARAGE_METRICS_STRICT", "").lower() not in ("", "0", "false", "no")


class _Series:
    __slots__ = ("count", "total", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        # (name, labels-tuple) -> _Series
        self._series: dict[tuple, _Series] = {}

    def _get(self, name: str, labels: tuple) -> _Series:
        key = (name, labels)
        s = self._series.get(key)
        if s is None:
            if STRICT_METRIC_NAMES and not METRIC_NAME_RE.match(name):
                raise ValueError(
                    f"metric name {name!r} violates the naming scheme "
                    f"{METRIC_NAME_RE.pattern!r} (GL07); use a static "
                    "<subsystem>_<snake_case> name")
            with self._lock:
                s = self._series.setdefault(key, _Series())
        return s

    def inc(self, name: str, value: float = 1, **labels) -> None:
        s = self._get(name, tuple(sorted(labels.items())))
        s.count += 1
        s.total += value
        s.max = max(s.max, value)

    def observe(self, name: str, seconds: float, **labels) -> None:
        self.inc(name, seconds, **labels)

    def timer(self, name: str, **labels) -> "_Timer":
        return _Timer(self, name, labels)

    def totals(self, name: str, **match) -> tuple[int, float]:
        """Aggregate (count, sum) across every series of `name` whose
        labels include all of `match` (qos governor latency source)."""
        count, total = 0, 0.0
        want = set((k, str(v)) for k, v in match.items())
        for (n, labels), s in list(self._series.items()):
            if n != name:
                continue
            if want and not want.issubset(
                    (k, str(v)) for k, v in labels):
                continue
            count += s.count
            total += s.total
        return count, total

    def series(self, name: str) -> list[tuple[dict, int, float, float]]:
        """Every series of `name` as (labels, count, sum, max) — the
        admin API's per-label readouts (e.g. resize_phase_seconds by
        phase) without reaching into internals."""
        return [(dict(labels), s.count, s.total, s.max)
                for (n, labels), s in list(self._series.items())
                if n == name]

    def render(self) -> Iterator[str]:
        """Prometheus text lines: <name>_count, <name>_sum, <name>_max."""
        # snapshot under the lock: render runs in a scrape worker thread
        # while the loop (and the compaction thread) insert new series
        with self._lock:
            items = sorted(self._series.items())
        seen_help = set()
        for (name, labels), s in items:
            if name not in seen_help:
                seen_help.add(name)
                yield f"# TYPE {name}_count counter"
            lab = ",".join(f'{k}="{v}"' for k, v in labels)
            suffix = f"{{{lab}}}" if lab else ""
            yield f"{name}_count{suffix} {s.count}"
            yield f"{name}_sum{suffix} {s.total:.6f}"
            yield f"{name}_max{suffix} {s.max:.6f}"


class _Timer:
    __slots__ = ("reg", "name", "labels", "t0")

    def __init__(self, reg: MetricsRegistry, name: str, labels: dict):
        self.reg = reg
        self.name = name
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.reg.observe(self.name, time.perf_counter() - self.t0,
                         **self.labels)
        return False


_global: Optional[MetricsRegistry] = None


def registry() -> MetricsRegistry:
    """Process-wide registry (one server process = one node)."""
    global _global
    if _global is None:
        _global = MetricsRegistry()
    return _global
