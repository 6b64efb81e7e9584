"""Copy of garage_tpu/model/s3/object_table.py: import paths rewritten, issue and PR tags dropped.

Object table: the S3 namespace (bucket_id, key) -> versions.

Ref parity: src/model/s3/object_table.rs. An Object is the list of its
versions ordered by (timestamp, uuid); each version is Uploading /
Complete / Aborted; complete data is a DeleteMarker, Inline bytes
(< inline threshold) or FirstBlock (block list in the version table).
Merge keeps CRDT semantics: Aborted dominates a version's state,
Complete dominates Uploading, and versions older than the newest
Complete one are dropped.

The `updated()` trigger (ref: object_table.rs:547-645):
  1. updates the bucket's object counters,
  2. propagates dropped/aborted versions to the version table
     (tombstones, which cascade to block_refs),
  3. deletes MPU entries for finished multipart uploads.
"""

from __future__ import annotations

from typing import Optional

from ...table.schema import Entry, TableSchema
from ...utils.crdt import now_msec
from .mpu_table import MultipartUpload
from .version_table import BACKLINK_OBJECT, Version

# ObjectVersionState kinds
ST_UPLOADING = "uploading"
ST_COMPLETE = "complete"
ST_ABORTED = "aborted"

# ObjectVersionData kinds
DATA_DELETE_MARKER = "delete_marker"
DATA_INLINE = "inline"
DATA_FIRST_BLOCK = "first_block"

# counter names (ref: object_table.rs:16-18)
OBJECTS = "objects"
UNFINISHED_UPLOADS = "unfinished_uploads"
BYTES = "bytes"


class ObjectVersionMeta:
    """ref: ObjectVersionMeta {headers, size, etag}."""

    __slots__ = ("headers", "size", "etag")

    def __init__(self, headers: dict, size: int, etag: str):
        self.headers = dict(headers)  # content-type + user meta
        self.size = size
        self.etag = etag

    def pack(self):
        return [sorted(self.headers.items()), self.size, self.etag]

    @classmethod
    def unpack(cls, o):
        return cls(dict(o[0]), o[1], o[2])


class ObjectVersionData:
    """DeleteMarker | Inline(meta, bytes) | FirstBlock(meta, hash)."""

    __slots__ = ("kind", "meta", "blob")

    def __init__(self, kind: str, meta: Optional[ObjectVersionMeta] = None,
                 blob: bytes = b""):
        self.kind = kind
        self.meta = meta  # None only for delete markers
        self.blob = blob  # inline bytes, or 32-byte first-block hash

    @staticmethod
    def delete_marker() -> "ObjectVersionData":
        return ObjectVersionData(DATA_DELETE_MARKER)

    @staticmethod
    def inline(meta: ObjectVersionMeta, data: bytes) -> "ObjectVersionData":
        return ObjectVersionData(DATA_INLINE, meta, data)

    @staticmethod
    def first_block(meta: ObjectVersionMeta, hash32: bytes) -> "ObjectVersionData":
        return ObjectVersionData(DATA_FIRST_BLOCK, meta, hash32)

    def pack(self):
        return [self.kind, self.meta.pack() if self.meta else None, self.blob]

    @classmethod
    def unpack(cls, o):
        meta = ObjectVersionMeta.unpack(o[1]) if o[1] is not None else None
        return cls(o[0], meta, bytes(o[2]))

    def merge(self, other: "ObjectVersionData") -> "ObjectVersionData":
        # honest writers never produce different Complete data for one
        # version uuid; break ties deterministically (ref: AutoCrdt max)
        import msgpack

        return self if msgpack.packb(self.pack()) >= msgpack.packb(other.pack()) \
            else other


class ObjectVersionState:
    """Uploading{multipart, headers} | Complete(data) | Aborted."""

    __slots__ = ("kind", "multipart", "headers", "data")

    def __init__(self, kind: str, multipart: bool = False,
                 headers: Optional[dict] = None,
                 data: Optional[ObjectVersionData] = None):
        self.kind = kind
        self.multipart = multipart
        self.headers = dict(headers) if headers else {}
        self.data = data

    @staticmethod
    def uploading(headers: dict, multipart: bool = False) -> "ObjectVersionState":
        return ObjectVersionState(ST_UPLOADING, multipart, headers)

    @staticmethod
    def complete(data: ObjectVersionData) -> "ObjectVersionState":
        return ObjectVersionState(ST_COMPLETE, data=data)

    @staticmethod
    def aborted() -> "ObjectVersionState":
        return ObjectVersionState(ST_ABORTED)

    def merge(self, other: "ObjectVersionState") -> "ObjectVersionState":
        """ref: object_table.rs ObjectVersionState::merge — Aborted wins;
        Complete beats Uploading; two Completes merge data."""
        if self.kind == ST_ABORTED or other.kind == ST_ABORTED:
            return ObjectVersionState.aborted()
        if self.kind == ST_COMPLETE and other.kind == ST_COMPLETE:
            return ObjectVersionState.complete(self.data.merge(other.data))
        if self.kind == ST_COMPLETE:
            return self
        if other.kind == ST_COMPLETE:
            return other
        return self  # both uploading

    def pack(self):
        return [self.kind, self.multipart, sorted(self.headers.items()),
                self.data.pack() if self.data else None]

    @classmethod
    def unpack(cls, o):
        data = ObjectVersionData.unpack(o[3]) if o[3] is not None else None
        return cls(o[0], bool(o[1]), dict(o[2]), data)


class ObjectVersion:
    __slots__ = ("uuid", "timestamp", "state")

    def __init__(self, uuid: bytes, timestamp: int, state: ObjectVersionState):
        self.uuid = uuid
        self.timestamp = timestamp
        self.state = state

    def cmp_key(self) -> tuple:
        return (self.timestamp, self.uuid)

    @property
    def is_complete(self) -> bool:
        return self.state.kind == ST_COMPLETE

    @property
    def is_data(self) -> bool:
        """Complete and not a delete marker."""
        return (self.state.kind == ST_COMPLETE
                and self.state.data.kind != DATA_DELETE_MARKER)

    def is_uploading(self, check_multipart: Optional[bool] = None) -> bool:
        if self.state.kind != ST_UPLOADING:
            return False
        return check_multipart is None or self.state.multipart == check_multipart

    def pack(self):
        return [self.uuid, self.timestamp, self.state.pack()]

    @classmethod
    def unpack(cls, o):
        return cls(bytes(o[0]), o[1], ObjectVersionState.unpack(o[2]))


class Object(Entry):
    VERSION_MARKER = b"GTobj01"

    def __init__(self, bucket_id: bytes, key: str,
                 versions: Optional[list[ObjectVersion]] = None):
        self.bucket_id = bucket_id
        self.key = key
        self.versions = sorted(versions or [], key=ObjectVersion.cmp_key)

    def partition_key(self) -> bytes:
        return self.bucket_id

    def sort_key(self) -> bytes:
        return self.key.encode()

    def merge(self, other: "Object") -> "Object":
        """ref: object_table.rs Crdt for Object."""
        by_key = {v.cmp_key(): ObjectVersion(v.uuid, v.timestamp, v.state)
                  for v in self.versions}
        for ov in other.versions:
            k = ov.cmp_key()
            if k in by_key:
                by_key[k] = ObjectVersion(
                    ov.uuid, ov.timestamp, by_key[k].state.merge(ov.state)
                )
            else:
                by_key[k] = ov
        versions = [by_key[k] for k in sorted(by_key)]
        # drop versions older than the last complete one
        last_complete = None
        for i, v in enumerate(versions):
            if v.is_complete:
                last_complete = i
        if last_complete is not None:
            versions = versions[last_complete:]
        return Object(self.bucket_id, self.key, versions)

    def last_complete(self) -> Optional[ObjectVersion]:
        for v in reversed(self.versions):
            if v.is_complete:
                return v
        return None

    def last_data(self) -> Optional[ObjectVersion]:
        """Newest complete non-delete-marker version (what GET serves)."""
        v = self.last_complete()
        return v if v is not None and v.is_data else None

    def version(self, uuid: bytes) -> Optional[ObjectVersion]:
        for v in self.versions:
            if v.uuid == uuid:
                return v
        return None

    def pack(self):
        return [self.bucket_id, self.key, [v.pack() for v in self.versions]]

    @classmethod
    def unpack(cls, o):
        return cls(bytes(o[0]), o[1], [ObjectVersion.unpack(v) for v in o[2]])

    # ---- counted item (ref: object_table.rs:652-688) -------------------

    def counter_partition_key(self) -> bytes:
        return self.bucket_id

    def counter_sort_key(self) -> bytes:
        return b""

    def counts(self) -> list[tuple[str, int]]:
        n_objects = 1 if any(v.is_data for v in self.versions) else 0
        n_uploading = sum(1 for v in self.versions if v.is_uploading())
        n_bytes = sum(
            v.state.data.meta.size
            for v in self.versions
            if v.is_complete and v.state.data.meta is not None
        )
        return [(OBJECTS, n_objects), (UNFINISHED_UPLOADS, n_uploading),
                (BYTES, n_bytes)]


class ObjectTable(TableSchema):
    TABLE_NAME = "object"
    ENTRY = Object

    def __init__(self, version_table, mpu_table, object_counter):
        self.version_table = version_table
        self.mpu_table = mpu_table
        self.object_counter = object_counter

    def updated(self, tx, old: Optional[Object], new: Optional[Object]) -> None:
        """ref: object_table.rs:547-645."""
        self.object_counter.count(tx, old, new)
        if old is None or new is None:
            return
        new_by_key = {v.cmp_key(): v for v in new.versions}
        for v in old.versions:
            nv = new_by_key.get(v.cmp_key())
            # dropped or newly-aborted versions delete their block list
            delete_version = nv is None or (
                nv.state.kind == ST_ABORTED and v.state.kind != ST_ABORTED
            )
            if delete_version:
                self.version_table.queue_insert(
                    tx,
                    Version.new(v.uuid,
                                (BACKLINK_OBJECT, old.bucket_id, old.key),
                                deleted=True),
                )
            # finished/aborted multipart uploads delete their MPU entry
            if v.is_uploading(check_multipart=True):
                delete_mpu = nv is None or nv.state.kind != ST_UPLOADING
                if delete_mpu:
                    self.mpu_table.queue_insert(
                        tx,
                        MultipartUpload.new(v.uuid, v.timestamp,
                                            old.bucket_id, old.key,
                                            deleted=True),
                    )

    def matches_filter(self, entry: Object, flt) -> bool:
        if flt is None:
            return True
        t = flt.get("type")
        if t == "data":
            return any(v.is_data for v in entry.versions)
        if t == "uploading":
            cm = flt.get("multipart")
            return any(v.is_uploading(cm) for v in entry.versions)
        return True


def object_upload_version(bucket_id: bytes, key: str, uuid: bytes,
                          headers: dict, multipart: bool = False,
                          timestamp: Optional[int] = None) -> Object:
    """A fresh single-version Object in Uploading state (PUT step 1)."""
    ts = timestamp if timestamp is not None else now_msec()
    return Object(bucket_id, key, [
        ObjectVersion(uuid, ts, ObjectVersionState.uploading(headers, multipart))
    ])
