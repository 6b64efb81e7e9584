"""The JAX package's tests/test_static_analysis.py, run against the
port's garage-lint (`garage_tpu_torch.analysis`) on the port's tree.

The reference file is read as text and executed here with the import
rewrite of tests/test_torch_copies.py (`load_reference_suite`) and its
path rewrite: every fixture's "garage_tpu/..." path names the port's
tree, so the loaded `test_tree_has_zero_non_baselined_violations` and
`test_cli_runs_clean_json` lint `garage_tpu_torch/` (with the harness
files of the port's CLI default: `chip_smoke.py` in the place of
`bench.py`) and are the port's tier-1 lint gate, under the reference's
own 30 s budget.
"""

from test_torch_copies import load_reference_suite

load_reference_suite(
    "test_static_analysis", globals(), paths=True,
    edits=[('"bench.py"))', '"chip_smoke.py"))')])
