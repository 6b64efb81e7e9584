"""Tables and RPC: mean s3.put.flush_meta span (a PUT's quorum writes
of its version and block-reference rows), ms."""


def read(r):
    d = [s["dur_us"] for s in r.spans if s["name"] == "s3.put.flush_meta"]
    return sum(d) / len(d) / 1e3 if d else None
