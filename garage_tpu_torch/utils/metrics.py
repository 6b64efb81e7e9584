"""In-process metrics registry: labeled counters with count / sum / max
(the subset of the JAX package's utils/metrics.py that the block data
path uses)."""

from __future__ import annotations

import threading
from typing import Optional


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

    def inc(self, name: str, value: float = 1, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            s = self._series.setdefault(key, _Series())
            s.count += 1
            s.total += value
            s.max = max(s.max, value)


_global: Optional[MetricsRegistry] = None


def registry() -> MetricsRegistry:
    """Process-wide registry (one server process = one node)."""
    global _global
    if _global is None:
        _global = MetricsRegistry()
    return _global
