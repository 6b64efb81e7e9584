"""Copy of garage_tpu/model/s3/mpu_table.py: import paths rewritten, issue and PR tags dropped.

Multipart upload table.

Ref parity: src/model/s3/mpu_table.rs. One row per upload id; parts are
a CRDT map keyed by (part_number, timestamp) so a re-uploaded part gets
a newer timestamp and both records coexist until Complete picks the
newest. The `updated()` trigger propagates deletion to the version
table; the counter tracks uploads/parts/bytes per bucket.
"""

from __future__ import annotations

from typing import Optional

from ...table.schema import Entry, TableSchema
from ...utils.crdt import Bool, Crdt, CrdtMap, now_msec
from .version_table import BACKLINK_MPU, Version

UPLOADS = "uploads"
PARTS = "parts"
BYTES = "bytes"


class MpuPart(Crdt):
    """ref: MpuPart {version, etag, size} (checksum folded into etag
    handling at the API layer)."""

    __slots__ = ("version", "etag", "size")

    def __init__(self, version: bytes, etag: Optional[str] = None,
                 size: Optional[int] = None):
        self.version = version
        self.etag = etag
        self.size = size

    def pack(self):
        return [self.version, self.etag, self.size]

    @classmethod
    def unpack(cls, o):
        return cls(bytes(o[0]), o[1], o[2])

    def merge(self, other: "MpuPart") -> "MpuPart":
        # commutative max-merge of every field (ref mpu_table.rs:150-167
        # max-merges etag/size; version is included here so two gateways
        # colliding on the same (part, ts) key still converge)
        def mx(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return max(a, b)

        return MpuPart(max(self.version, other.version),
                       mx(self.etag, other.etag), mx(self.size, other.size))

    def __eq__(self, other):
        return isinstance(other, MpuPart) and self.pack() == other.pack()


class MultipartUpload(Entry):
    VERSION_MARKER = b"GTmpu01"

    def __init__(self, upload_id: bytes, timestamp: int, deleted: Bool,
                 parts: CrdtMap, bucket_id: bytes, key: str):
        self.upload_id = upload_id
        self.timestamp = timestamp
        self.deleted = deleted
        self.parts = parts  # (part_number, ts) -> MpuPart
        self.bucket_id = bucket_id
        self.key = key

    @staticmethod
    def new(upload_id: bytes, timestamp: int, bucket_id: bytes, key: str,
            deleted: bool = False) -> "MultipartUpload":
        return MultipartUpload(upload_id, timestamp, Bool(deleted),
                               CrdtMap(), bucket_id, key)

    def next_timestamp(self, part_number: int) -> int:
        """ref: mpu_table.rs:92-103."""
        prev = [k[1] for k, _ in self.parts.items() if k[0] == part_number]
        return max(now_msec(), (max(prev) + 1) if prev else 0)

    def partition_key(self) -> bytes:
        return self.upload_id

    def sort_key(self) -> bytes:
        return b""

    def is_tombstone(self) -> bool:
        return self.deleted.value

    def merge(self, other: "MultipartUpload") -> "MultipartUpload":
        deleted = self.deleted.merge(other.deleted)
        parts = CrdtMap() if deleted.value else self.parts.merge(other.parts)
        return MultipartUpload(self.upload_id, self.timestamp, deleted,
                               parts, self.bucket_id, self.key)

    def pack(self):
        return [
            self.upload_id, self.timestamp, self.deleted.value,
            [[k[0], k[1], p.pack()] for k, p in self.parts.items()],
            self.bucket_id, self.key,
        ]

    @classmethod
    def unpack(cls, o):
        parts = CrdtMap({(pn, ts): MpuPart.unpack(p) for pn, ts, p in o[3]})
        return cls(bytes(o[0]), o[1], Bool(bool(o[2])), parts,
                   bytes(o[4]), o[5])

    # ---- counted item (ref: mpu_table.rs:227-260) ----------------------

    def counter_partition_key(self) -> bytes:
        return self.bucket_id

    def counter_sort_key(self) -> bytes:
        return b""

    def counts(self) -> list[tuple[str, int]]:
        uploads = 0 if self.deleted.value else 1
        part_numbers = {k[0] for k, _ in self.parts.items()}
        bytes_ = sum(p.size or 0 for _, p in self.parts.items())
        return [(UPLOADS, uploads), (PARTS, len(part_numbers)),
                (BYTES, bytes_)]


class MultipartUploadTable(TableSchema):
    TABLE_NAME = "multipart_upload"
    ENTRY = MultipartUpload

    def __init__(self, version_table, mpu_counter):
        self.version_table = version_table
        self.mpu_counter = mpu_counter

    def updated(self, tx, old: Optional[MultipartUpload],
                new: Optional[MultipartUpload]) -> None:
        """Deletion propagates to the part versions
        (ref: mpu_table.rs updated)."""
        self.mpu_counter.count(tx, old, new)
        if old is None or new is None:
            return
        if new.deleted.value and not old.deleted.value:
            for _, part in old.parts.items():
                self.version_table.queue_insert(
                    tx,
                    Version.new(part.version, (BACKLINK_MPU, old.upload_id),
                                deleted=True),
                )

    def matches_filter(self, entry: MultipartUpload, flt) -> bool:
        if flt is None or flt.get("deleted", "any") == "any":
            return True
        return entry.is_tombstone() == (flt["deleted"] == "deleted")
