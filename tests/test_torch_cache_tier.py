"""The JAX package's tests/test_cache_tier.py, run against the port's
cluster cache tier (block/cache_tier.py) on erasure clusters of port
nodes (`device="cpu"`).

The reference file, and the block-cluster helpers it takes from
tests/test_block.py, are read as text and executed here with the import
and sibling-helper rewrite of tests/test_torch_copies.py
(`load_reference_suite`); neither is imported or changed. Its GL03 lint
tests run against the port's analyzer (garage_tpu_torch.analysis).
"""

from test_torch_copies import load_reference_suite

load_reference_suite("test_cache_tier", globals())
