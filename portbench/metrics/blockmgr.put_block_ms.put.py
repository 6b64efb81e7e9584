"""BlockManager: mean block.put span (encode, shard framing, fan-out to
the nodes and their write quorum), ms."""


def read(r):
    d = [s["dur_us"] for s in r.spans if s["name"] == "block.put"]
    return sum(d) / len(d) / 1e3 if d else None
