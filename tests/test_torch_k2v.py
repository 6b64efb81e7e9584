"""The JAX package's K2V suite (tests/test_k2v.py), run against the
port's K2V tables on clusters of port nodes (`Garage(device="cpu")` on
the loopback transport).

The reference file, and the cluster helpers it takes from
tests/test_model.py, are read as text and executed here with the import
rewrite of tests/test_torch_copies.py (`load_reference_suite`); neither
is imported or changed.
"""

from test_torch_copies import load_reference_suite

_model: dict = {}
load_reference_suite(
    "test_model", _model,
    edits=[("status_interval=0.2, ping_interval=0.2))",
            'status_interval=0.2, ping_interval=0.2, device="cpu"))')])
make_garage_cluster = _model["make_garage_cluster"]
stop_all = _model["stop_all"]
wait_until = _model["wait_until"]

load_reference_suite(
    "test_k2v", globals(),
    edits=[("from test_model import make_garage_cluster, stop_all, "
            "wait_until  # noqa",
            "pass  # the port's cluster helpers are bound above")])
