"""Copy of garage_tpu/model/k2v/item_table.py: import paths rewritten, issue and PR tags dropped.

K2V item table: DVVS (dotted version vector set) entries.

Ref parity: src/model/k2v/item_table.rs. An item is addressed by
(bucket, partition_key, sort_key) and holds, per writer node, a
DvvsEntry {t_discard, values: [(t, value-or-None)]}. Writes discard
every version covered by the supplied causality token and append a new
timestamped value; concurrent writes on different nodes coexist as
conflicting values until a later write with a merged token discards
them. `None` is the Deleted marker (ref DvvsValue::Deleted).

Table partition key bytes = bucket_id ++ partition_key (utf-8) — blake2
of that matches the reference's K2VItemPartition::hash (blake2 over the
same concatenation).
"""

from __future__ import annotations

from typing import Optional

from ...table.schema import Entry, TableSchema
from .causality import CausalContext, make_node_id

ENTRIES = "entries"
CONFLICTS = "conflicts"
VALUES = "values"
BYTES = "bytes"


def partition_pk(bucket_id: bytes, partition_key: str) -> bytes:
    return bucket_id + partition_key.encode()


class DvvsEntry:
    __slots__ = ("t_discard", "values")

    def __init__(self, t_discard: int = 0,
                 values: Optional[list] = None):
        self.t_discard = t_discard
        self.values: list[tuple[int, Optional[bytes]]] = values or []

    def max_time(self) -> int:
        return max([self.t_discard] + [t for t, _ in self.values])

    def discard(self) -> None:
        self.values = [(t, v) for t, v in self.values if t > self.t_discard]

    def merge(self, other: "DvvsEntry") -> "DvvsEntry":
        out = DvvsEntry(max(self.t_discard, other.t_discard),
                        list(self.values))
        out.discard()
        t_max = out.max_time()
        for t, v in other.values:
            if t > t_max:
                out.values.append((t, v))
        return out

    def pack(self):
        return [self.t_discard, [[t, v] for t, v in self.values]]

    @classmethod
    def unpack(cls, o):
        return cls(o[0], [(t, bytes(v) if v is not None else None)
                          for t, v in o[1]])


class K2VItem(Entry):
    VERSION_MARKER = b"GTk2v01"

    def __init__(self, bucket_id: bytes, partition_key: str, sort_key: str,
                 items: Optional[dict[int, DvvsEntry]] = None):
        self.bucket_id = bucket_id
        self.partition_key_str = partition_key
        self.sort_key_str = sort_key
        self.items: dict[int, DvvsEntry] = items or {}

    # ---- DVVS ops (ref: item_table.rs:71-133) --------------------------

    def update(self, this_node: bytes, context: Optional[CausalContext],
               new_value: Optional[bytes], node_ts: int) -> int:
        """Apply one write; returns the new local timestamp."""
        if context is not None:
            for node, t_discard in context.vector_clock.items():
                e = self.items.get(node)
                if e is not None:
                    e.t_discard = max(e.t_discard, t_discard)
                else:
                    self.items[node] = DvvsEntry(t_discard)
        for e in self.items.values():
            e.discard()
        node_id = make_node_id(this_node)
        e = self.items.setdefault(node_id, DvvsEntry())
        t_new = max(e.max_time() + 1, node_ts + 1)
        e.values.append((t_new, new_value))
        return t_new

    def causal_context(self) -> CausalContext:
        return CausalContext({n: e.max_time()
                              for n, e in self.items.items()})

    def values(self) -> list[Optional[bytes]]:
        out: list[Optional[bytes]] = []
        for _, e in sorted(self.items.items()):
            for _, v in e.values:
                if v not in out:
                    out.append(v)
        return out

    def live_values(self) -> list[bytes]:
        return [v for v in self.values() if v is not None]

    # ---- Entry interface ----------------------------------------------

    def partition_key(self) -> bytes:
        return partition_pk(self.bucket_id, self.partition_key_str)

    def sort_key(self) -> bytes:
        return self.sort_key_str.encode()

    def is_tombstone(self) -> bool:
        vals = self.values()
        return all(v is None for v in vals)

    def merge(self, other: "K2VItem") -> "K2VItem":
        items = dict(self.items)
        for node, e2 in other.items.items():
            e1 = items.get(node)
            items[node] = e1.merge(e2) if e1 is not None else \
                DvvsEntry(e2.t_discard, list(e2.values))
        return K2VItem(self.bucket_id, self.partition_key_str,
                       self.sort_key_str, items)

    def pack(self):
        return [self.bucket_id, self.partition_key_str, self.sort_key_str,
                [[n, e.pack()] for n, e in sorted(self.items.items())]]

    @classmethod
    def unpack(cls, o):
        return cls(bytes(o[0]), o[1], o[2],
                   {n: DvvsEntry.unpack(e) for n, e in o[3]})

    # ---- counted item (ref: item_table.rs counts) ----------------------

    def counter_partition_key(self) -> bytes:
        return self.bucket_id

    def counter_sort_key(self) -> bytes:
        return self.partition_key_str.encode()

    def counts(self) -> list[tuple[str, int]]:
        vals = self.values()
        n_values = sum(1 for v in vals if v is not None)
        return [
            (ENTRIES, 0 if self.is_tombstone() else 1),
            (CONFLICTS, 1 if n_values > 1 else 0),
            (VALUES, n_values),
            (BYTES, sum(len(v) for v in vals if v is not None)),
        ]


class K2VItemTable(TableSchema):
    TABLE_NAME = "k2v_item"
    ENTRY = K2VItem

    def __init__(self, counter: Optional[object] = None,
                 subscriptions: Optional[object] = None):
        self.counter = counter
        self.subscriptions = subscriptions

    def updated(self, tx, old: Optional[K2VItem],
                new: Optional[K2VItem]) -> None:
        if self.counter is not None:
            self.counter.count(tx, old, new)
        if self.subscriptions is not None and new is not None:
            item = new
            tx.on_commit(lambda: self.subscriptions.notify(item))

    def matches_filter(self, entry: K2VItem, flt) -> bool:
        if flt is None:
            return True
        kind = flt.get("type") if isinstance(flt, dict) else None
        if kind == "item":
            if flt.get("conflicts_only") and len(entry.live_values()) < 2:
                return False
            if not flt.get("tombstones") and entry.is_tombstone():
                return False
            return True
        return True
