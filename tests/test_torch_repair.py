"""The JAX package's tests/test_repair.py, run against the port.

The reference file, and the sibling helpers it imports, are read as
text and executed here with the import and sibling-helper rewrite of
tests/test_torch_copies.py (`load_reference_suite`); none is imported
or changed.
"""

from test_torch_copies import load_reference_suite

load_reference_suite("test_repair", globals())
