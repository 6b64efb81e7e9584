"""Copy of garage_tpu/model/s3/block_ref_table.py: import paths rewritten, issue and PR tags dropped.

Block reference table — the joint between metadata and block store.

Ref parity: src/model/s3/block_ref_table.rs. One row per (block hash,
version uuid); the `updated()` trigger calls block_incref/block_decref
on the local BlockManager inside the same transaction, so a block's
local refcount exactly tracks the non-deleted refs stored on this node.

Erasure divergence (no reference analogue): when block data is striped
over k+m shard holders, block_ref rows must reach ALL holders — each
holder's local rc drives fetch/rebuild/delete of its shard. So
BlockRefReplication widens the storage set to the shard placement
(shard_nodes_of), which is exactly aligned with the ring position of the
partition key because 32-byte keys index the ring identically
(table/schema.py partition_hash).
"""

from __future__ import annotations

from typing import Optional

from ...table.replication import (SyncPartition, TableShardedReplication,
                                  partition_first_hash)
from ...table.schema import Entry, TableSchema, tree_key
from ...utils.crdt import Bool


class BlockRef(Entry):
    VERSION_MARKER = b"GTbrf01"

    def __init__(self, block: bytes, version: bytes, deleted: Bool):
        self.block = block  # hash of the referenced data block
        self.version = version  # uuid of the object version holding it
        self.deleted = deleted

    @staticmethod
    def new(block: bytes, version: bytes, deleted: bool = False) -> "BlockRef":
        return BlockRef(block, version, Bool(deleted))

    def partition_key(self) -> bytes:
        return self.block

    def sort_key(self) -> bytes:
        return self.version

    def is_tombstone(self) -> bool:
        return self.deleted.value

    def merge(self, other: "BlockRef") -> "BlockRef":
        return BlockRef(self.block, self.version,
                        self.deleted.merge(other.deleted))

    def pack(self):
        return [self.block, self.version, self.deleted.value]

    @classmethod
    def unpack(cls, o) -> "BlockRef":
        return cls(bytes(o[0]), bytes(o[1]), Bool(bool(o[2])))


class BlockRefTable(TableSchema):
    TABLE_NAME = "block_ref"
    ENTRY = BlockRef

    def __init__(self, block_manager):
        self.block_manager = block_manager

    def updated(self, tx, old: Optional[BlockRef],
                new: Optional[BlockRef]) -> None:
        """ref: block_ref_table.rs:63-83."""
        block = (old or new).block
        was = old is not None and not old.deleted.value
        is_now = new is not None and not new.deleted.value
        if is_now and not was:
            self.block_manager.block_incref(tx, block)
        if was and not is_now:
            self.block_manager.block_decref(tx, block)

    def matches_filter(self, entry: BlockRef, flt) -> bool:
        if flt is None or flt.get("deleted", "any") == "any":
            return True
        return entry.is_tombstone() == (flt["deleted"] == "deleted")


def block_ref_recount_fn(block_ref_table):
    """CalculateRefcount for BlockRc.recalculate: count non-deleted refs
    of a block in the local store (ref: block_ref_table.rs:88-125)."""

    def count(hash32: bytes) -> int:
        from ...table.data import _prefix_upper_bound

        data = block_ref_table.data
        prefix = tree_key(hash32, b"")
        n = 0
        # end-bounded: an unbounded iter materializes the whole tail of
        # the block_ref tree per call, turning a full rc repair O(N^2)
        for _k, raw in data.store.iter(start=prefix,
                                       end=_prefix_upper_bound(prefix)):
            if not data.decode_stored(raw).is_tombstone():
                n += 1
        return n

    return count


class BlockRefReplication(TableShardedReplication):
    """Widens block_ref replication to every erasure shard holder.

    With replicate-N codecs (width == metadata rf) this degenerates to
    plain sharded replication, so it is safe to use unconditionally for
    the block_ref table."""

    def __init__(self, system, read_quorum: int, write_quorum: int,
                 width: int):
        super().__init__(system, read_quorum, write_quorum)
        self.width = width

    def _placement(self, version, hash32: bytes) -> list[bytes]:
        from ...block.codec import shard_nodes_of

        return shard_nodes_of(version, hash32, self.width)

    def storage_nodes(self, hash32):
        return self._placement(self._helper.current(), hash32)

    def read_nodes(self, hash32):
        return self._placement(self._helper.read_version(), hash32)

    def write_sets(self, hash32):
        sets = []
        for v in self._helper.versions_for_writes():
            s = self._placement(v, hash32)
            if s and s not in sets:
                sets.append(s)
        return sets

    def sync_partitions(self):
        # shard placement is constant across one ring partition (it only
        # depends on partition_of(hash)), so the per-partition storage
        # sets are the placements of the partition's first hash
        out = []
        for p in range(256):
            fh = partition_first_hash(p)
            sets = []
            for v in self._helper.versions_for_writes():
                s = self._placement(v, fh)
                if s and s not in sets:
                    sets.append(s)
            out.append(SyncPartition(p, fh, sets))
        return out
