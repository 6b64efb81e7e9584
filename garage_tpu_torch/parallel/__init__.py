"""Multi-device data-plane parallelism: device grids and the composite
encode / put / scrub / repair steps (ported from the JAX package's
parallel/).

  dp  — the batch of stripes, split evenly over the grid's rows
  tp  — within a stripe: the byte axis for the GF(2^8) work (each byte
        column is independent), whole shards for hashing

A grid is a (dp, tp) table of torch devices (`data_plane_mesh`); each
step is a launch sequence of the port's kernels (G1, G2, B3) on every
grid cell, each cell on its own CUDA stream, with the parts gathered
back to the caller's device. The same device may fill several cells:
a one-card machine runs the split logic on a grid of repeated devices.
"""

from .mesh import (  # noqa: F401
    Grid,
    data_plane_mesh,
    make_encode_step,
    make_gf_apply_step,
    make_parity_check_step,
    make_put_step,
    make_repair_step,
    make_scrub_step,
)
