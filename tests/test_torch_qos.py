"""The JAX package's tests/test_qos.py, run against the port's QoS
engine, limiter and governor, and its admin /v1/qos surface on clusters
of port nodes (`Garage(device="cpu")` on the loopback transport).

The reference file, and the cluster helpers it takes from
tests/test_model.py, are read as text and executed here with the import
and sibling-helper rewrite of tests/test_torch_copies.py
(`load_reference_suite`); neither is imported or changed.
"""

from test_torch_copies import load_reference_suite

load_reference_suite("test_qos", globals())
