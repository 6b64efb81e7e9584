"""The JAX package's multi-process gateway suite (tests/test_gateway.py),
run against the port: the lease broker, the cache ring, the block
manager's cache-router seam (on the port's BlockManager with
device="cpu"), the worker config derivation, the /metrics relabel, and
the two forked drills, where the store is
`garage_tpu_torch.cli.server --device cpu` with jax and garage_tpu
blocked and its supervisor starts `garage_tpu_torch.gateway.worker`
processes on the same device.

The reference file, and the block-cluster helpers it takes from
tests/test_block.py, are read as text and executed here with the import
and sibling-helper rewrite of tests/test_torch_copies.py
(`load_reference_suite`); neither is imported or changed. The forked
server is the port's S3 suite's (tests/test_torch_s3_api.py `Server`).
"""

from test_torch_copies import load_reference_suite

load_reference_suite(
    "test_gateway", globals(),
    edits=[("from test_s3_api import Server",
            "from test_torch_s3_api import Server")])
