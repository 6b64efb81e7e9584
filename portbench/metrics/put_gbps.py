"""Bytes of PutObject bodies acknowledged (200), over the window's
seconds; 1 GB = 1e9 B. A PUT that straddles the window's opening or
close counts with the share of its time inside the window: the 10
requests in flight at the close carry a fifth of the window's bytes,
the large objects most, and counting them whole or not at all would
swing the rate with where the close falls."""

from portbench.window import in_window_bytes


def read(r):
    if r.op != "put":
        return None
    return in_window_bytes(r.records, r.seconds) / r.seconds / 1e9
