"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card, in %."""


def read(r):
    if r.device is None or r.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.device["busy_s"] / r.device["window_s"])
