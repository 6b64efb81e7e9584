"""Copy of garage_tpu/model/s3/version_table.py: import paths rewritten, issue and PR tags dropped.

Object version table: the block list of one upload.

Ref parity: src/model/s3/version_table.rs. A Version is keyed by its
uuid; `blocks` maps (part_number, offset) -> (block hash, size). The
`updated()` trigger propagates deletion to the block_ref table (one
tombstone per referenced block) via the async insert queue.
"""

from __future__ import annotations

from typing import Optional

from ...table.schema import Entry, TableSchema
from ...utils.crdt import Bool, CrdtMap
from .block_ref_table import BlockRef

# backlink kinds
BACKLINK_OBJECT = "object"
BACKLINK_MPU = "mpu"


class Version(Entry):
    VERSION_MARKER = b"GTver01"

    def __init__(self, uuid: bytes, deleted: Bool, blocks: CrdtMap,
                 backlink: tuple):
        self.uuid = uuid
        self.deleted = deleted
        # (part_number, offset) -> (hash, size); values max-merge, which
        # is a no-op for honest writers (same block content)
        self.blocks = blocks
        # ("object", bucket_id, key) | ("mpu", upload_id)
        self.backlink = backlink

    @staticmethod
    def new(uuid: bytes, backlink: tuple, deleted: bool = False) -> "Version":
        return Version(uuid, Bool(deleted), CrdtMap(), backlink)

    def with_block(self, part_number: int, offset: int, hash32: bytes,
                   size: int) -> "Version":
        return Version(self.uuid, self.deleted,
                       self.blocks.put((part_number, offset), (hash32, size)),
                       self.backlink)

    def partition_key(self) -> bytes:
        return self.uuid

    def sort_key(self) -> bytes:
        return b""

    def is_tombstone(self) -> bool:
        return self.deleted.value

    def merge(self, other: "Version") -> "Version":
        deleted = self.deleted.merge(other.deleted)
        if deleted.value:
            blocks = CrdtMap()
        else:
            blocks = self.blocks.merge(other.blocks)
        return Version(self.uuid, deleted, blocks, self.backlink)

    # ---- helpers (ref: version_table.rs:97-123) ------------------------

    def has_part_number(self, pn: int) -> bool:
        return any(k[0] == pn for k, _ in self.blocks.items())

    def n_parts(self) -> int:
        pns = {k[0] for k, _ in self.blocks.items()}
        return max(pns) if pns else 0

    def total_size(self) -> int:
        return sum(size for _, (_, size) in self.blocks.items())

    def pack(self):
        bl = list(self.backlink)
        return [
            self.uuid,
            self.deleted.value,
            [[k[0], k[1], h, s] for k, (h, s) in self.blocks.items()],
            bl,
        ]

    @classmethod
    def unpack(cls, o) -> "Version":
        blocks = CrdtMap({(pn, off): (bytes(h), s) for pn, off, h, s in o[2]})
        bl = o[3]
        backlink = ((BACKLINK_OBJECT, bytes(bl[1]), bl[2])
                    if bl[0] == BACKLINK_OBJECT
                    else (BACKLINK_MPU, bytes(bl[1])))
        return cls(bytes(o[0]), Bool(bool(o[1])), blocks, backlink)


class VersionTable(TableSchema):
    TABLE_NAME = "version"
    ENTRY = Version

    def __init__(self, block_ref_table):
        self.block_ref_table = block_ref_table

    def updated(self, tx, old: Optional[Version],
                new: Optional[Version]) -> None:
        """Deletion propagates to block_ref tombstones
        (ref: version_table.rs:178-201)."""
        if old is None or new is None:
            return
        if new.deleted.value and not old.deleted.value:
            for _, (h, _size) in old.blocks.items():
                self.block_ref_table.queue_insert(
                    tx, BlockRef.new(h, old.uuid, deleted=True)
                )

    def matches_filter(self, entry: Version, flt) -> bool:
        if flt is None or flt.get("deleted", "any") == "any":
            return True
        return entry.is_tombstone() == (flt["deleted"] == "deleted")
