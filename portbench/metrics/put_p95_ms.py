"""95th percentile (nearest rank) of the latency of every PutObject
started in the window, those still in flight at its close waited for;
a failed or refused request counts as slower than any success."""

import math

from portbench.window import started


def read(r):
    recs = started(r.records, r.seconds)
    if r.op != "put" or not recs:
        return None
    lat = sorted((rec[2] - rec[1]) * 1e3 if rec[4] == 200 else math.inf
                 for rec in recs)
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    return p95 if math.isfinite(p95) else 1e9
