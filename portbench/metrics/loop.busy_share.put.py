"""Host event loop: the share of its time in the window that it was
busy (outside the selector's select() and the meter's own work), from
the loop.window records of the port's loop meter: the sum of busy_us
over the sum of busy_us + idle_us, in %."""


def read(r):
    w = [s["attrs"] for s in r.spans if s["name"] == "loop.window"]
    total = sum(a["busy_us"] + a["idle_us"] for a in w)
    if total <= 0:
        return None
    return 100.0 * sum(a["busy_us"] for a in w) / total
