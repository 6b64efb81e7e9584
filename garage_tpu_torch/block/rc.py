"""Copy of garage_tpu/block/rc.py: import paths rewritten, issue and PR tags dropped.

Block reference counts.

Ref parity: src/block/rc.rs. The block_ref table trigger calls
block_incref/block_decref inside ITS transaction; the rc states are
Present{count} / Deletable{at} (GC delay so late readers finish) /
Absent. `recalculate_rc` rebuilds a count from the registered
CalculateRefcount callbacks (repair path, rc.rs:83-130).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

BLOCK_GC_DELAY = 600.0  # ref: block/manager.rs:51


class BlockRc:
    def __init__(self, db, gc_delay: float = BLOCK_GC_DELAY):
        self.db = db
        self.tree = db.open_tree("block_local_rc")
        self.gc_delay = gc_delay
        self.calculate_cbs: list[Callable[[bytes], int]] = []

    # values: b"C" + u64 count   | b"D" + f64 deletable-at-unixtime
    @staticmethod
    def _pack_count(n: int) -> bytes:
        return b"C" + n.to_bytes(8, "big")

    @staticmethod
    def _pack_deletable(at: float) -> bytes:
        return b"D" + int(at * 1000).to_bytes(8, "big")

    @classmethod
    def parse(cls, raw: Optional[bytes]) -> tuple[str, float]:
        """-> ("absent", 0) | ("present", count) | ("deletable", at)."""
        if raw is None:
            return ("absent", 0)
        if raw[:1] == b"C":
            return ("present", int.from_bytes(raw[1:], "big"))
        return ("deletable", int.from_bytes(raw[1:], "big") / 1000.0)

    # ---- transactional ops (called from table triggers) ----------------

    def block_incref(self, tx, hash32: bytes) -> bool:
        """Returns True if the block became newly needed
        (absent/deletable -> present), so the caller queues a resync
        fetch (ref: rc.rs:38-58)."""
        state, v = self.parse(tx.get(self.tree, hash32))
        if state == "present":
            tx.insert(self.tree, hash32, self._pack_count(int(v) + 1))
            return False
        tx.insert(self.tree, hash32, self._pack_count(1))
        # both absent->present and deletable->present need a resync
        # examination (ref rc.rs: old_rc.is_zero() covers Deletable too)
        return True

    def block_decref(self, tx, hash32: bytes) -> bool:
        """Returns True if the block became deletable (count hit 0), so
        the caller queues a resync to offload/delete (ref: rc.rs:60-81)."""
        state, v = self.parse(tx.get(self.tree, hash32))
        if state != "present":
            return state == "deletable"
        n = int(v) - 1
        if n > 0:
            tx.insert(self.tree, hash32, self._pack_count(n))
            return False
        tx.insert(self.tree, hash32,
                  self._pack_deletable(time.time() + self.gc_delay))
        return True

    # ---- queries -------------------------------------------------------

    def get(self, hash32: bytes) -> tuple[str, float]:
        return self.parse(self.tree.get(hash32))

    def is_needed(self, hash32: bytes) -> bool:
        return self.get(hash32)[0] == "present"

    def is_deletable_now(self, hash32: bytes) -> bool:
        state, at = self.get(hash32)
        return state == "deletable" and time.time() >= at

    def clear_deletable(self, hash32: bytes) -> None:
        def body(tx):
            state, _ = self.parse(tx.get(self.tree, hash32))
            if state == "deletable":
                tx.remove(self.tree, hash32)

        self.db.transaction(body)

    def all_hashes(self):
        for k, _ in self.tree.iter():
            yield k

    # ---- repair (ref: rc.rs:83-130) ------------------------------------

    def register_calculator(self, cb: Callable[[bytes], int]) -> None:
        self.calculate_cbs.append(cb)

    def recalculate(self, hash32: bytes) -> int:
        count = sum(cb(hash32) for cb in self.calculate_cbs)

        def body(tx):
            state, v = self.parse(tx.get(self.tree, hash32))
            if count > 0:
                tx.insert(self.tree, hash32, self._pack_count(count))
            elif state == "present":
                tx.insert(self.tree, hash32,
                          self._pack_deletable(time.time() + self.gc_delay))

        self.db.transaction(body)
        return count
