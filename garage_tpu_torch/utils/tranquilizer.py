"""Copy of garage_tpu/utils/tranquilizer.py: import paths rewritten, issue and PR tags dropped.

Tranquilizer: adaptive throttle for background workers.

Ref parity: src/util/tranquilizer.rs:21-78 — after each unit of work taking
`d` seconds, sleep `tranquility × avg(d)` so a worker with tranquility t uses
at most 1/(t+1) of a core/disk.
"""

from __future__ import annotations

import time
from collections import deque


class Tranquilizer:
    def __init__(self, max_observations: int = 10):
        self._obs: deque[float] = deque(maxlen=max_observations)
        self._last_start: float | None = None

    def reset(self) -> None:
        self._last_start = time.monotonic()

    def tranquilize_duration(self, tranquility: int) -> float:
        """Record the duration since reset(); return how long to sleep."""
        if self._last_start is None:
            return 0.0
        d = time.monotonic() - self._last_start
        self._obs.append(d)
        self._last_start = None
        if not self._obs or tranquility <= 0:
            return 0.0
        avg = sum(self._obs) / len(self._obs)
        return tranquility * avg
