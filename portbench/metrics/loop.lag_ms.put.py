"""Host event loop: the mean lag of the loop meter's 10 ms heartbeat in
the window (how long a callback that fell due waited for the loop),
from the loop.window records of the port's loop meter: the sum of
lag_us_sum over the sum of beats, ms."""


def read(r):
    w = [s["attrs"] for s in r.spans if s["name"] == "loop.window"]
    beats = sum(a["beats"] for a in w)
    if beats <= 0:
        return None
    return sum(a["lag_us_sum"] for a in w) / beats / 1e3
