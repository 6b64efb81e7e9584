"""Copy of garage_tpu/table/schema.py: import paths rewritten, issue and PR tags dropped.

Table schemas: typed CRDT entries keyed by (partition key, sort key).

Ref parity: src/table/schema.rs:71-103. An entry is a CRDT (merge) that
is also Migratable (versioned encoding); the schema binds entry type to
a table name and provides the `updated()` transactional trigger that
propagates changes to other tables (e.g. object -> version -> block_ref).
"""

from __future__ import annotations

from typing import Optional, Type

from ..utils import migrate
from ..utils.data import Hash, blake2sum


class Entry(migrate.Migratable):
    """A table row. Subclasses define partition_key/sort_key and CRDT
    merge; encoding comes from Migratable (pack/unpack + VERSION_MARKER).
    ref: table/schema.rs Entry trait."""

    def partition_key(self) -> bytes:
        raise NotImplementedError

    def sort_key(self) -> bytes:
        raise NotImplementedError

    def merge(self, other: "Entry") -> "Entry":
        raise NotImplementedError

    def is_tombstone(self) -> bool:
        """Fully-deleted entries are GC candidates (ref: schema.rs:34)."""
        return False


def partition_hash(pk: bytes) -> Hash:
    """Ring position of a partition key. 32-byte keys (uuids, block
    hashes) are already uniformly random and index the ring directly —
    crucially this co-locates block_ref rows with their block's shard
    placement (ref: table/schema.rs PartitionKey: identity for
    FixedBytes32, blake2 for String). Row keys written before this rule
    existed (pre-model-layer dev databases) are not migrated."""
    if len(pk) == 32:
        return pk
    return blake2sum(pk)


def tree_key(pk: bytes, sk: bytes) -> bytes:
    """On-disk row key: hash(P) ++ P-len ++ P ++ S so rows group by ring
    partition first (the Merkle trie and sync walk this prefix order)
    while remaining unambiguous for any P/S byte strings.
    ref: table/data.rs tree_key (hash(P) ++ S)."""
    return partition_hash(pk) + len(pk).to_bytes(4, "big") + pk + sk


def split_tree_key(key: bytes) -> tuple[bytes, bytes]:
    """Inverse of tree_key: -> (pk, sk)."""
    plen = int.from_bytes(key[32:36], "big")
    return key[36:36 + plen], key[36 + plen:]


class TableSchema:
    """Binds a table name to an entry type + triggers.
    ref: table/schema.rs:71."""

    TABLE_NAME: str = "?"
    ENTRY: Type[Entry] = Entry

    def decode_entry(self, raw: bytes) -> Entry:
        return migrate.decode(self.ENTRY, raw)

    def encode_entry(self, entry: Entry) -> bytes:
        return migrate.encode(entry)

    def updated(self, tx, old: Optional[Entry], new: Optional[Entry]) -> None:
        """Transactional trigger run inside the db transaction that
        applied the change (ref: schema.rs:86-95). `tx` is the open
        db Transaction; raise TxAbort to reject the write."""

    def matches_filter(self, entry: Entry, flt) -> bool:
        """Server-side filter for get_range (ref: schema.rs:97)."""
        return True
