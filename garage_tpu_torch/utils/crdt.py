"""Copy of garage_tpu/utils/crdt.py: import paths rewritten, issue and PR tags dropped.

CRDT library: merge-based conflict-free replicated data types.

Ref parity: src/util/crdt/ (crdt.rs:19-59 Crdt trait; lww.rs Lww; lww_map.rs
LwwMap; map.rs Map; bool.rs Bool; deletable.rs Deletable).

A Crdt value supports `merge(other)` which must be commutative, associative
and idempotent. All table entries are CRDTs; replica divergence is resolved by
merging, never by coordination.

Values here are immutable-by-convention: merge() returns a NEW value. (The
reference mutates in place; a functional style composes better with the
msgpack encoding and with property tests.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Generic, Iterator, Optional, Tuple, TypeVar

T = TypeVar("T")
K = TypeVar("K")
V = TypeVar("V")


class Crdt:
    """Base protocol. merge must be commutative/associative/idempotent."""

    def merge(self, other: "Crdt") -> "Crdt":
        raise NotImplementedError


def merge_auto(a: Any, b: Any) -> Any:
    """Merge two values: CRDTs merge; plain Ord values take the max.

    ref: AutoCrdt (src/util/crdt/crdt.rs:43-59) — max-merge via Ord for
    primitives, recursive merge for CRDT members.
    """
    if isinstance(a, Crdt):
        return a.merge(b)
    if a == b:
        return a
    try:
        return max(a, b)
    except TypeError:
        # unordered values (dicts, mixed types): deterministic tie-break
        # so merge stays commutative
        return max(a, b, key=repr)


def now_msec() -> int:
    return int(time.time() * 1000)


@dataclass(frozen=True)
class Lww(Crdt, Generic[T]):
    """Last-write-wins register: (timestamp, value); ties break on value.

    ref: src/util/crdt/lww.rs:41-114. As in the reference, `update` bumps the
    timestamp to max(now, ts+1) so a node with a slow clock still wins over
    its own previous write.
    """

    ts: int
    value: T

    @staticmethod
    def new(value: T, ts: Optional[int] = None) -> "Lww[T]":
        return Lww(now_msec() if ts is None else ts, value)

    def update(self, value: T) -> "Lww[T]":
        return Lww(max(now_msec(), self.ts + 1), value)

    # Migrate-friendly plain encoding
    def pack(self, pack_value=lambda v: v) -> list:
        return [self.ts, pack_value(self.value)]

    @staticmethod
    def unpack(raw: list, unpack_value=lambda v: v) -> "Lww":
        return Lww(raw[0], unpack_value(raw[1]))

    def merge(self, other: "Lww[T]") -> "Lww[T]":
        if other.ts > self.ts:
            return other
        if other.ts == self.ts:
            # deterministic tie-break: merge values (max for plain values)
            return Lww(self.ts, merge_auto(self.value, other.value))
        return self


@dataclass(frozen=True)
class Bool(Crdt):
    """True-wins boolean. ref: src/util/crdt/bool.rs"""

    value: bool

    def merge(self, other: "Bool") -> "Bool":
        return Bool(self.value or other.value)


class LwwMap(Crdt, Generic[K, V]):
    """Map of K -> Lww[V]; per-key last-write-wins, no deletion (use a
    tombstone value such as None/Deletable). ref: src/util/crdt/lww_map.rs.

    Stored as an immutable dict; iteration order is sorted key order to keep
    encodings canonical.
    """

    __slots__ = ("_items",)

    def __init__(self, items: Optional[dict] = None):
        self._items: dict = dict(items) if items else {}

    @staticmethod
    def from_item(k: K, lww: Lww) -> "LwwMap":
        return LwwMap({k: lww})

    def get(self, k: K) -> Optional[V]:
        lww = self._items.get(k)
        return lww.value if lww is not None else None

    def get_lww(self, k: K) -> Optional[Lww]:
        return self._items.get(k)

    def insert(self, k: K, value: V) -> "LwwMap":
        prev = self._items.get(k)
        lww = prev.update(value) if prev is not None else Lww.new(value)
        d = dict(self._items)
        d[k] = lww
        return LwwMap(d)

    def items(self) -> Iterator[Tuple[K, V]]:
        for k in sorted(self._items):
            yield k, self._items[k].value

    def items_lww(self) -> Iterator[Tuple[K, Lww]]:
        for k in sorted(self._items):
            yield k, self._items[k]

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, k: K) -> bool:
        return k in self._items

    def __eq__(self, other) -> bool:
        return isinstance(other, LwwMap) and self._items == other._items

    def merge(self, other: "LwwMap") -> "LwwMap":
        d = dict(self._items)
        for k, lww in other._items.items():
            mine = d.get(k)
            d[k] = lww if mine is None else mine.merge(lww)
        return LwwMap(d)


class CrdtMap(Crdt, Generic[K, V]):
    """Map of K -> V where V is itself merged on conflict (grow-only keys).

    ref: src/util/crdt/map.rs — used e.g. for Version.blocks.
    """

    __slots__ = ("_items",)

    def __init__(self, items: Optional[dict] = None):
        self._items: dict = dict(items) if items else {}

    def put(self, k: K, v: V) -> "CrdtMap":
        d = dict(self._items)
        mine = d.get(k)
        d[k] = v if mine is None else merge_auto(mine, v)
        return CrdtMap(d)

    def get(self, k: K) -> Optional[V]:
        return self._items.get(k)

    def items(self) -> Iterator[Tuple[K, V]]:
        for k in sorted(self._items):
            yield k, self._items[k]

    def clear(self) -> "CrdtMap":
        return CrdtMap()

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, k) -> bool:
        return k in self._items

    def __eq__(self, other) -> bool:
        return isinstance(other, CrdtMap) and self._items == other._items

    def merge(self, other: "CrdtMap") -> "CrdtMap":
        d = dict(self._items)
        for k, v in other._items.items():
            mine = d.get(k)
            d[k] = v if mine is None else merge_auto(mine, v)
        return CrdtMap(d)


@dataclass(frozen=True)
class Deletable(Crdt, Generic[T]):
    """Present(value) or Deleted; Deleted wins over Present on merge when
    timestamps are handled by an enclosing Lww. ref: src/util/crdt/deletable.rs
    (there, deletion wins; value merge otherwise).
    """

    value: Optional[T]  # None = deleted

    @staticmethod
    def present(v: T) -> "Deletable[T]":
        return Deletable(v)

    @staticmethod
    def deleted() -> "Deletable[T]":
        return Deletable(None)

    @property
    def is_deleted(self) -> bool:
        return self.value is None

    def merge(self, other: "Deletable[T]") -> "Deletable[T]":
        if self.value is None or other.value is None:
            return Deletable(None)
        return Deletable(merge_auto(self.value, other.value))
