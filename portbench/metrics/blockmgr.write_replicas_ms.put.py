"""BlockManager: mean block.write_replicas span (a whole block sent to
each of its replica nodes until the write quorum has stored it), ms."""


def read(r):
    d = [s["dur_us"] for s in r.spans
         if s["name"] == "block.write_replicas"]
    return sum(d) / len(d) / 1e3 if d else None
