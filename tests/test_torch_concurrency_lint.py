"""The JAX package's tests/test_concurrency_lint.py, run against the port's
garage-lint (`garage_tpu_torch.analysis`).

The reference file is read as text and executed here with the import
rewrite of tests/test_torch_copies.py (`load_reference_suite`) and its
path rewrite: every fixture's "garage_tpu/..." path, and every file of
the tree the suite reads, is the port's.
"""

from test_torch_copies import load_reference_suite

load_reference_suite("test_concurrency_lint", globals(), paths=True)
