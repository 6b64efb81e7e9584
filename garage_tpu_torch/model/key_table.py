"""Copy of garage_tpu/model/key_table.py: import paths rewritten, issue and PR tags dropped.

API key table (full-copy control table).

Ref parity: src/model/key_table.rs. A key is "GK" + 12 hex bytes with a
32-hex-byte secret; params hold the name, create-bucket permission,
per-bucket grants, and key-local bucket aliases.
"""

from __future__ import annotations

import os
from typing import Optional

from ..table.schema import Entry, TableSchema
from ..utils.crdt import Crdt, CrdtMap, Deletable, Lww, LwwMap
from .permission import BucketKeyPerm


class KeyParams(Crdt):
    def __init__(self, secret_key: str, name: Optional[Lww] = None,
                 allow_create_bucket: Optional[Lww] = None,
                 authorized_buckets: Optional[CrdtMap] = None,
                 local_aliases: Optional[LwwMap] = None):
        self.secret_key = secret_key
        self.name = name or Lww.new("")
        self.allow_create_bucket = allow_create_bucket or Lww.new(False)
        self.authorized_buckets = authorized_buckets or CrdtMap()  # bucket_id -> perm
        self.local_aliases = local_aliases or LwwMap()  # alias -> bucket_id|None

    def __eq__(self, other):
        return isinstance(other, KeyParams) and self.pack() == other.pack()

    def merge(self, o: "KeyParams") -> "KeyParams":
        return KeyParams(
            self.secret_key,
            self.name.merge(o.name),
            self.allow_create_bucket.merge(o.allow_create_bucket),
            self.authorized_buckets.merge(o.authorized_buckets),
            self.local_aliases.merge(o.local_aliases),
        )

    def pack(self):
        return [
            self.secret_key,
            self.name.pack(),
            self.allow_create_bucket.pack(),
            [[k, p.pack()] for k, p in self.authorized_buckets.items()],
            [[k, lww.ts, lww.value] for k, lww in self.local_aliases.items_lww()],
        ]

    @classmethod
    def unpack(cls, o) -> "KeyParams":
        return cls(
            o[0],
            Lww.unpack(o[1]),
            Lww.unpack(o[2]),
            CrdtMap({bytes(k): BucketKeyPerm.unpack(p) for k, p in o[3]}),
            LwwMap({k: Lww(ts, bytes(v) if v is not None else None)
                    for k, ts, v in o[4]}),
        )


class Key(Entry):
    VERSION_MARKER = b"GTkey01"

    def __init__(self, key_id: str, state: Deletable):
        self.key_id = key_id
        self.state = state  # Deletable[KeyParams]

    @staticmethod
    def new(name: str = "") -> "Key":
        key_id = "GK" + os.urandom(12).hex()
        secret = os.urandom(32).hex()
        params = KeyParams(secret)
        params.name = Lww.new(name)
        return Key(key_id, Deletable.present(params))

    @staticmethod
    def import_key(key_id: str, secret_key: str, name: str = "") -> "Key":
        if len(key_id) != 26 or not key_id.startswith("GK"):
            raise ValueError("invalid key id (GK + 24 hex chars)")
        bytes.fromhex(key_id[2:])
        if len(secret_key) != 64:
            raise ValueError("invalid secret key (64 hex chars)")
        bytes.fromhex(secret_key)
        params = KeyParams(secret_key)
        params.name = Lww.new(name)
        return Key(key_id, Deletable.present(params))

    @staticmethod
    def deleted(key_id: str) -> "Key":
        return Key(key_id, Deletable.deleted())

    @property
    def is_deleted(self) -> bool:
        return self.state.is_deleted

    @property
    def params(self) -> Optional[KeyParams]:
        return self.state.value

    def bucket_permissions(self, bucket_id: bytes) -> BucketKeyPerm:
        if self.params is None:
            return BucketKeyPerm.no_permissions()
        return (self.params.authorized_buckets.get(bucket_id)
                or BucketKeyPerm.no_permissions())

    def allow_read(self, bucket_id: bytes) -> bool:
        return self.bucket_permissions(bucket_id).allow_read

    def allow_write(self, bucket_id: bytes) -> bool:
        return self.bucket_permissions(bucket_id).allow_write

    def allow_owner(self, bucket_id: bytes) -> bool:
        return self.bucket_permissions(bucket_id).allow_owner

    def partition_key(self) -> bytes:
        return b""

    def sort_key(self) -> bytes:
        return self.key_id.encode()

    def merge(self, other: "Key") -> "Key":
        return Key(self.key_id, self.state.merge(other.state))

    def pack(self):
        return [self.key_id,
                self.params.pack() if self.params is not None else None]

    @classmethod
    def unpack(cls, o) -> "Key":
        params = KeyParams.unpack(o[1]) if o[1] is not None else None
        return cls(o[0], Deletable.present(params) if params is not None
                   else Deletable.deleted())


class KeyTable(TableSchema):
    TABLE_NAME = "key"
    ENTRY = Key

    def matches_filter(self, entry: Key, flt) -> bool:
        if flt is None:
            return True
        if "matches" in flt:
            pat = flt["matches"].lower()
            if entry.is_deleted:
                return False
            return (entry.key_id.lower().startswith(pat)
                    or (entry.params is not None
                        and entry.params.name.value.lower() == pat))
        want = flt.get("deleted", "any")
        if want == "any":
            return True
        return entry.is_deleted == (want == "deleted")
