"""The JAX package's tests/test_tracing.py, run against the port's span
system, its JSONL and OTLP exporters, and a trace id carried over RPC
between port nodes: the reference's `import bench` takes the port's
`_build_cluster` (test_torch_copies.PORT_BENCH: port BlockManagers with
`device_mode="off"` over the port's System, on the loopback transport).

The reference file is read as text and executed here with the import
rewrite of tests/test_torch_copies.py (`load_reference_suite`); it is
never imported or changed.
"""

from test_torch_copies import load_reference_suite

load_reference_suite("test_tracing", globals())
