"""Arithmetic over the load generator's request records
[index, start s, end s, bytes, status, verified], times from the
window's opening."""

from __future__ import annotations


def started(records: list, seconds: float) -> list:
    """The requests started inside the window."""
    return [r for r in records if 0.0 <= r[1] < seconds]


def in_window_bytes(records: list, seconds: float,
                    verified: bool = False) -> float:
    """Bytes of the successful requests (and, with `verified`, checked
    ones), each weighted by the share of its time inside [0, seconds]."""
    total = 0.0
    for _i, t0, t1, size, status, ok in records:
        if status != 200 or (verified and ok is not True):
            continue
        inside = min(t1, seconds) - max(t0, 0.0)
        if inside > 0:
            total += size * inside / (t1 - t0)
    return total
