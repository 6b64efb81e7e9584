"""Staged backend: host-to-device plus device-to-host stage seconds over
all three stages' seconds in the window (pipeline_stats), in %."""


def read(r):
    b = r.stage_busy
    total = b.get("h2d", 0.0) + b.get("compute", 0.0) + b.get("d2h", 0.0)
    if total <= 0:
        return None
    return 100.0 * (b.get("h2d", 0.0) + b.get("d2h", 0.0)) / total
