"""Copy of garage_tpu/model/bucket_table.py: import paths rewritten, issue and PR tags dropped.

Bucket table (full-copy control table).

Ref parity: src/model/bucket_table.rs. A bucket is identified by a
random uuid; its params are a CRDT aggregate of authorized keys, global
and key-local aliases, and Lww'd website / CORS / lifecycle / quota
configs. Deletion is a Deletable tombstone (a deleted bucket id is
never reused).

Plain-structure config payloads (travel inside Lww registers):
  website:   {"index_document": str, "error_document": str|None}
  cors:      [{"id","max_age_seconds","allow_origins","allow_methods",
               "allow_headers","expose_headers"}]
  lifecycle: [{"id","enabled","filter":{"prefix","size_gt","size_lt"},
               "abort_incomplete_mpu_days","expiration"}]
  quotas:    {"max_size": int|None, "max_objects": int|None}
"""

from __future__ import annotations

from typing import Optional

from ..table.schema import Entry, TableSchema
from ..utils.crdt import Crdt, CrdtMap, Deletable, Lww, LwwMap, now_msec
from ..utils.data import gen_uuid
from .permission import BucketKeyPerm


class BucketParams(Crdt):
    def __init__(self, creation_date: Optional[int] = None,
                 authorized_keys: Optional[CrdtMap] = None,
                 aliases: Optional[LwwMap] = None,
                 local_aliases: Optional[LwwMap] = None,
                 website_config: Optional[Lww] = None,
                 cors_config: Optional[Lww] = None,
                 lifecycle_config: Optional[Lww] = None,
                 quotas: Optional[Lww] = None):
        self.creation_date = creation_date if creation_date is not None else now_msec()
        self.authorized_keys = authorized_keys or CrdtMap()  # key_id -> perm
        self.aliases = aliases or LwwMap()  # alias -> bool
        self.local_aliases = local_aliases or LwwMap()  # (key_id, alias) -> bool
        self.website_config = website_config or Lww.new(None)
        self.cors_config = cors_config or Lww.new(None)
        self.lifecycle_config = lifecycle_config or Lww.new(None)
        self.quotas = quotas or Lww.new({"max_size": None, "max_objects": None})

    def __eq__(self, other):
        return isinstance(other, BucketParams) and self.pack() == other.pack()

    def merge(self, o: "BucketParams") -> "BucketParams":
        return BucketParams(
            min(self.creation_date, o.creation_date),
            self.authorized_keys.merge(o.authorized_keys),
            self.aliases.merge(o.aliases),
            self.local_aliases.merge(o.local_aliases),
            self.website_config.merge(o.website_config),
            self.cors_config.merge(o.cors_config),
            self.lifecycle_config.merge(o.lifecycle_config),
            self.quotas.merge(o.quotas),
        )

    def pack(self):
        return [
            self.creation_date,
            [[k, p.pack()] for k, p in self.authorized_keys.items()],
            [[k, lww.ts, lww.value] for k, lww in self.aliases.items_lww()],
            [[list(k), lww.ts, lww.value]
             for k, lww in self.local_aliases.items_lww()],
            self.website_config.pack(),
            self.cors_config.pack(),
            self.lifecycle_config.pack(),
            self.quotas.pack(),
        ]

    @classmethod
    def unpack(cls, o) -> "BucketParams":
        return cls(
            o[0],
            CrdtMap({k: BucketKeyPerm.unpack(p) for k, p in o[1]}),
            LwwMap({k: Lww(ts, v) for k, ts, v in o[2]}),
            LwwMap({tuple(k): Lww(ts, v) for k, ts, v in o[3]}),
            Lww.unpack(o[4]),
            Lww.unpack(o[5]),
            Lww.unpack(o[6]),
            Lww.unpack(o[7]),
        )


class Bucket(Entry):
    VERSION_MARKER = b"GTbkt01"

    def __init__(self, id: bytes, state: Deletable):
        self.id = id
        self.state = state  # Deletable[BucketParams]

    @staticmethod
    def new() -> "Bucket":
        return Bucket(gen_uuid(), Deletable.present(BucketParams()))

    @property
    def is_deleted(self) -> bool:
        return self.state.is_deleted

    @property
    def params(self) -> Optional[BucketParams]:
        return self.state.value

    def partition_key(self) -> bytes:
        return self.id

    def sort_key(self) -> bytes:
        return b""

    def merge(self, other: "Bucket") -> "Bucket":
        return Bucket(self.id, self.state.merge(other.state))

    def pack(self):
        return [self.id,
                self.params.pack() if self.params is not None else None]

    @classmethod
    def unpack(cls, o) -> "Bucket":
        params = BucketParams.unpack(o[1]) if o[1] is not None else None
        return cls(
            bytes(o[0]),
            Deletable.present(params) if params is not None
            else Deletable.deleted(),
        )

    # ---- convenience for API/CLI layers --------------------------------

    def with_params(self, params: BucketParams) -> "Bucket":
        return Bucket(self.id, Deletable.present(params))

    def authorized(self, key_id: str) -> BucketKeyPerm:
        if self.params is None:
            return BucketKeyPerm.no_permissions()
        return (self.params.authorized_keys.get(key_id)
                or BucketKeyPerm.no_permissions())


class BucketTable(TableSchema):
    TABLE_NAME = "bucket"
    ENTRY = Bucket

    def matches_filter(self, entry: Bucket, flt) -> bool:
        if flt is None or flt.get("deleted", "any") == "any":
            return True
        want_deleted = flt["deleted"] == "deleted"
        return entry.is_deleted == want_deleted


def is_valid_bucket_name(name: str) -> bool:
    """AWS bucket-name rules (ref: bucket_alias_table.rs:83-98).
    ASCII-only: lowercase letters, digits, dots, hyphens."""
    if not (3 <= len(name) <= 63):
        return False
    if not all(("a" <= c <= "z") or ("0" <= c <= "9") or c in ".-"
               for c in name):
        return False
    first, last = name[0], name[-1]
    if not (("a" <= first <= "z") or ("0" <= first <= "9")):
        return False
    if not (("a" <= last <= "z") or ("0" <= last <= "9")):
        return False
    if all(("0" <= c <= "9") or c == "." for c in name):  # looks like an IP
        return False
    if name.startswith("xn--") or name.endswith("-s3alias"):
        return False
    return ".." not in name
