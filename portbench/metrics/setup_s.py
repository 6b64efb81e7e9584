"""Process start to the window's start: imports, the kernels' build or
load, the cluster's boot, the cell's set-up and the warm-up."""


def read(r):
    return r.setup_s
