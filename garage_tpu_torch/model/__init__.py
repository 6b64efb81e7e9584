"""Copy of garage_tpu/model/__init__.py: import paths rewritten, issue and PR tags dropped.

Application model layer: schemas + the Garage composition root.

Ref parity: src/model/ (garage.rs, s3/*, bucket_table.rs, key_table.rs,
index_counter.rs, permission.rs).
"""

from .bucket_alias_table import BucketAlias, BucketAliasTable
from .bucket_table import Bucket, BucketParams, BucketTable, is_valid_bucket_name
from .garage import Garage, parse_addr, parse_peer
from .index_counter import CounterEntry, IndexCounter
from .key_table import Key, KeyParams, KeyTable
from .permission import BucketKeyPerm

__all__ = [
    "Bucket", "BucketAlias", "BucketAliasTable", "BucketKeyPerm",
    "BucketParams", "BucketTable", "CounterEntry", "Garage", "IndexCounter",
    "Key", "KeyParams", "KeyTable", "is_valid_bucket_name", "parse_addr",
    "parse_peer",
]
