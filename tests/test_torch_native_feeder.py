"""The JAX package's tests/test_native_feeder.py, run against the port:
the native C kernels (the port's copy of `native/`) against the port's
BLAKE3, GF and RS code, the feeder's host route ("off") and device
route ("require", device="cpu": the kernels' plain versions) for hash,
encode, verify, MD5 lanes and parity check, the router's capped and
adaptive exploration trials, and an erasure PUT/GET on a loopback
cluster of port nodes (`import bench` takes the port's `_build_cluster`,
test_torch_copies.PORT_BENCH).

The reference file is read as text and executed here with the import
rewrite of tests/test_torch_copies.py (`load_reference_suite`); it is
never imported or changed. The edits put the feeders, codecs and
batched BLAKE3 it builds on the CPU. The tests it does not run here are
in test_torch_copies.NOT_RUN, with their counterparts in
tests/test_torch_router.py.
"""

from test_torch_copies import load_reference_suite

load_reference_suite(
    "test_native_feeder", globals(),
    edits=[("ErasureCodec(4, 2, use_jax=False)",
            'ErasureCodec(4, 2, device="cpu")', 5),
           ("DeviceFeeder(", 'DeviceFeeder(device="cpu", ', 10),
           ("treehash.blake3_many(msgs)",
            'treehash.blake3_many(msgs, device="cpu")')])
