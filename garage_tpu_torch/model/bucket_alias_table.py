"""Copy of garage_tpu/model/bucket_alias_table.py: import paths rewritten, issue and PR tags dropped.

Global bucket aliases (full-copy control table).

Ref parity: src/model/bucket_alias_table.rs. An alias is a human name
pointing (Lww) at a bucket id or None (deleted).
"""

from __future__ import annotations

from typing import Optional

from ..table.schema import Entry, TableSchema
from ..utils.crdt import Lww
from .bucket_table import is_valid_bucket_name


class BucketAlias(Entry):
    VERSION_MARKER = b"GTals01"

    def __init__(self, name: str, state: Lww):
        self.name = name
        self.state = state  # Lww[Optional[bucket_id bytes]]

    @staticmethod
    def new(name: str, bucket_id: Optional[bytes],
            ts: Optional[int] = None) -> Optional["BucketAlias"]:
        if not is_valid_bucket_name(name):
            return None
        return BucketAlias(name, Lww.new(bucket_id, ts))

    @property
    def is_deleted(self) -> bool:
        return self.state.value is None

    @property
    def bucket_id(self) -> Optional[bytes]:
        return self.state.value

    def partition_key(self) -> bytes:
        return b""

    def sort_key(self) -> bytes:
        return self.name.encode()

    def merge(self, other: "BucketAlias") -> "BucketAlias":
        return BucketAlias(self.name, self.state.merge(other.state))

    def pack(self):
        return [self.name, self.state.ts, self.state.value]

    @classmethod
    def unpack(cls, o) -> "BucketAlias":
        v = bytes(o[2]) if o[2] is not None else None
        return cls(o[0], Lww(o[1], v))


class BucketAliasTable(TableSchema):
    TABLE_NAME = "bucket_alias"
    ENTRY = BucketAlias

    def matches_filter(self, entry: BucketAlias, flt) -> bool:
        if flt is None or flt.get("deleted", "any") == "any":
            return True
        return entry.is_deleted == (flt["deleted"] == "deleted")
