"""The JAX package's tests/test_lsm.py, run against the port.

The reference file is read as text and executed here with the import
rewrite of tests/test_torch_copies.py (`load_reference_suite`); it is
neither imported nor changed. The port's lsm engine leaves no tombstone
where nothing older holds the key: tests/test_torch_lsm_tombstones.py
holds that against the JAX package's engine.
"""

from test_torch_copies import load_reference_suite

load_reference_suite("test_lsm", globals())
