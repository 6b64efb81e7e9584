"""Staged backend: the mean time a staged job waited for its stage
thread in the window, from its submit to the thread's claim
(DeviceFeeder.stats stage_wait_us over stage_jobs), ms."""


def read(r):
    n = r.feeder.get("stage_jobs", 0)
    if n <= 0:
        return None
    return r.feeder.get("stage_wait_us", 0) / n / 1e3
