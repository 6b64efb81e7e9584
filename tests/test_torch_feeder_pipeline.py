"""The JAX package's tests/test_feeder_pipeline.py, run against the
port: the staged pipeline's overlap over the stub backend, the stage
executor's cancelled jobs, stop() with batches in flight, the padded
launches of the port's backend (device="cpu": the kernels' plain
versions) and their shape count (`recompiles`), the stub backend's
require gate, the `[tpu]` knobs and /v1/s3/tuning.

The reference file is read as text and executed here with the import
rewrite of tests/test_torch_copies.py (`load_reference_suite`); it is
never imported or changed. The edits put the feeders and codecs it
builds on the CPU. The tests it does not run here are in
test_torch_copies.NOT_RUN, with their counterparts in
tests/test_torch_router.py.
"""

from test_torch_copies import load_reference_suite

load_reference_suite(
    "test_feeder_pipeline", globals(),
    edits=[("ErasureCodec(4, 2, use_jax=False)",
            'ErasureCodec(4, 2, device="cpu")', 3),
           ("DeviceFeeder(", 'DeviceFeeder(device="cpu", ', 13)])
