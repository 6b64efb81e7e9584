"""The JAX package's tests/test_feeder_decode.py, run against the port:
batched RS decode and repair through the port feeder's staged device
route (device="cpu": kernel G1's plain version) across every erasure
pattern, the stub backend's degraded-GET live gate on a cluster of port
nodes, the deep-scrub gather window, the decode routing floors (config,
/v1/s3/tuning, "auto") and a malformed item failing only its caller.

The reference file, and the block-cluster helpers it takes from
tests/test_block.py, are read as text and executed here with the import
and sibling-helper rewrite of tests/test_torch_copies.py
(`load_reference_suite`); neither is imported or changed. The edits put
the feeders and codecs it builds on the CPU. The tests it does not run
here are in test_torch_copies.NOT_RUN, with their counterparts in
tests/test_torch_router.py.
"""

from test_torch_copies import load_reference_suite

load_reference_suite(
    "test_feeder_decode", globals(),
    edits=[("ErasureCodec(k, m, use_jax=False)",
            'ErasureCodec(k, m, device="cpu")', 6),
           ("DeviceFeeder(", 'DeviceFeeder(device="cpu", ', 9)])
