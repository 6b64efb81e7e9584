"""Tables and RPC (table/, rpc/, net/, db/, model/): their share of the
host event loop's time in the window, from the loop.window records of
the port's loop meter: the sum of us.tables over the sum of busy_us +
idle_us, in %."""


def read(r):
    w = [s["attrs"] for s in r.spans if s["name"] == "loop.window"]
    total = sum(a["busy_us"] + a["idle_us"] for a in w)
    if total <= 0:
        return None
    return 100.0 * sum(a["us.tables"] for a in w) / total
