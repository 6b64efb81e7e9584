"""Bytes of GetObject bodies returned (200) and equal to the object
PUT, over the window's seconds; 1 GB = 1e9 B. A GET that straddles the
window's opening or close counts with the share of its time inside it
(as put_gbps)."""

from portbench.window import in_window_bytes


def read(r):
    if r.op != "get":
        return None
    return in_window_bytes(r.records, r.seconds, verified=True) \
        / r.seconds / 1e9
