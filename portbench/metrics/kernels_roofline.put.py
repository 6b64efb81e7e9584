"""Kernels: the least device time of the window's device items (their
counts by op from the feeders, each item's least time from the mix's
shapes, portbench/roofline.py) over the kernel time of the window's
device trace, in %."""

from portbench import roofline


def read(r):
    if r.device is None or r.device["kernel_s"] <= 0:
        return None
    least = roofline.least_s(r.op_items, r.spec, r.cfg)
    if least is None:
        return None
    return 100.0 * least / r.device["kernel_s"]
