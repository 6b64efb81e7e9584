"""Copy of garage_tpu/table/data.py: import paths rewritten, issue and PR tags dropped.

TableData: node-local table storage with CRDT merge-on-write.

Ref parity: src/table/data.rs. Every mutation happens inside a db
transaction: decode incoming entry, merge with what's stored, run the
schema's `updated()` trigger, append the row to the Merkle todo queue,
and (for tombstones, on the partition leader) enqueue a GC entry.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Iterator, Optional

from ..db import Db, TxAbort
from ..utils.data import blake2sum
from .replication import TableReplication
from .schema import Entry, TableSchema, partition_hash, tree_key

log = logging.getLogger("garage_tpu_torch.table.data")


def _prefix_upper_bound(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every string with this prefix,
    or None if the prefix is all 0xFF (no upper bound)."""
    b = bytearray(prefix)
    while b:
        if b[-1] != 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return None


class TableData:
    def __init__(self, db: Db, schema: TableSchema, replication: TableReplication,
                 system_id: bytes):
        self.db = db
        self.schema = schema
        self.replication = replication
        self.system_id = system_id
        name = schema.TABLE_NAME
        self.name = name
        self.store = db.open_tree(f"table:{name}")
        self.merkle_todo = db.open_tree(f"{name}:merkle_todo")
        self.merkle_tree = db.open_tree(f"{name}:merkle_tree")
        self.gc_todo = db.open_tree(f"{name}:gc_todo")
        self.insert_queue = db.open_tree(f"{name}:insert_queue")
        self.merkle_todo_notify = threading.Event()
        self.insert_queue_notify = threading.Event()
        from .gc import TABLE_GC_DELAY

        self.gc_delay = TABLE_GC_DELAY  # tunable (tests, config)
        # listeners called (outside the tx) after local changes; used by
        # k2v-style subscriptions and tests
        self.changed_hooks: list[Callable[[Entry], None]] = []
        # table_size accounting (see size_bytes)
        self._bytes_base: Optional[int] = None
        self._bytes_delta = 0

    # ---- reads ---------------------------------------------------------

    def read_entry(self, pk: bytes, sk: bytes) -> Optional[bytes]:
        return self.store.get(tree_key(pk, sk))

    def decode_stored(self, raw: bytes) -> Entry:
        return self.schema.decode_entry(raw)

    def read_range(self, pk: bytes, start_sk: Optional[bytes], flt,
                   limit: int, reverse: bool = False,
                   prefix_sk: Optional[bytes] = None,
                   end_sk: Optional[bytes] = None) -> list[bytes]:
        """Rows of one partition key, from start_sk, filtered, ≤ limit.
        `prefix_sk` bounds both ends to sort keys with that prefix (so a
        reverse scan without an explicit start begins at the prefix's
        upper bound, not at it); `end_sk` is an exclusive stop bound.
        ref: table/data.rs read_range + k2v range semantics.

        Streams from a BOUNDED cursor: the engine is asked for
        at most ~limit rows per batch, never the whole partition tail —
        on a bucket with a million keys the old unbounded iter()
        materialized every row after the start key just to return the
        first page."""
        lo, hi, prefix = self._range_bounds(pk, start_sk, reverse,
                                            prefix_sk, end_sk)
        out = []
        while len(out) < limit:
            # filtered scans over-fetch a little so sparse matches don't
            # degenerate into per-row engine calls
            want = (limit - len(out)) if flt is None \
                else max(limit - len(out), 64)
            if not reverse:
                batch = list(self.store.iter(start=lo, end=hi,
                                             limit=want))
            else:
                batch = list(self.store.iter(start=lo, end=hi,
                                             reverse=True, limit=want))
            for k, v in batch:
                if not k.startswith(prefix):
                    return out
                if flt is None:
                    # unfiltered pages skip the per-row decode entirely
                    out.append(v)
                elif self.schema.matches_filter(
                        self.schema.decode_entry(v), flt):
                    out.append(v)
                if len(out) >= limit:
                    return out
            if len(batch) < want:
                break
            if not reverse:
                lo = batch[-1][0] + b"\x00"
            else:
                hi = batch[-1][0]
        return out

    def _range_bounds(self, pk: bytes, start_sk: Optional[bytes],
                      reverse: bool, prefix_sk: Optional[bytes],
                      end_sk: Optional[bytes]
                      ) -> tuple[bytes, Optional[bytes], bytes]:
        """(lo, hi, partition prefix) engine bounds shared by
        read_range and read_range_raw."""
        prefix = tree_key(pk, b"")
        part_end = _prefix_upper_bound(prefix)
        lo, hi = prefix, part_end
        if prefix_sk is not None:
            lo = tree_key(pk, prefix_sk)
            hi = _prefix_upper_bound(lo) or part_end
        if not reverse:
            if start_sk is not None:
                lo = max(lo, tree_key(pk, start_sk))
            if end_sk is not None:
                hi = min(hi, tree_key(pk, end_sk))
        else:
            # reverse: start_sk = inclusive upper start; end_sk =
            # exclusive lower stop (keys must stay > end_sk)
            if start_sk is not None:
                hi = min(hi, tree_key(pk, start_sk) + b"\x00")
            if end_sk is not None:
                lo = max(lo, tree_key(pk, end_sk) + b"\x00")
        return lo, hi, prefix

    def read_range_raw(self, pk: bytes, start_sk: Optional[bytes],
                       limit: int, prefix_sk: Optional[bytes] = None,
                       end_sk: Optional[bytes] = None
                       ) -> tuple[list[tuple[bytes, bytes]],
                                  Optional[bytes]]:
        """Raw-cursor page: up to `limit` (sort_key, raw row)
        pairs of one partition, forward order, NO per-row decode — the
        sort key comes straight off the engine key, so callers that
        page a range (k2v poll_range) advance their cursor without
        decoding a single row they end up skipping. Returns
        (rows, next_start_sk): next_start_sk is the sort key to resume
        AFTER the last returned row, or None when the range is
        exhausted."""
        lo, hi, prefix = self._range_bounds(pk, start_sk, False,
                                            prefix_sk, end_sk)
        rows: list[tuple[bytes, bytes]] = []
        plen = len(prefix)
        while len(rows) < limit:
            want = limit - len(rows)
            batch = list(self.store.iter(start=lo, end=hi, limit=want))
            for k, v in batch:
                if not k.startswith(prefix):
                    return rows, None
                rows.append((k[plen:], v))
            if len(batch) < want:
                return rows, None
            lo = batch[-1][0] + b"\x00"
        return rows, (rows[-1][0] + b"\x00" if rows else None)

    def iter_all(self) -> Iterator[tuple[bytes, bytes]]:
        return self.store.iter()

    # ---- writes --------------------------------------------------------

    def update_entry(self, raw: bytes) -> Optional[Entry]:
        """Merge one incoming encoded entry; returns the new merged entry
        if the stored value changed, else None. ref: data.rs:178-268."""
        entry = self.schema.decode_entry(raw)
        return self.update_entry_decoded(entry)

    def update_entry_decoded(self, entry: Entry) -> Optional[Entry]:
        return self._apply_row(
            entry.partition_key(), entry.sort_key(),
            lambda tx, old: old.merge(entry) if old is not None else entry,
        )

    def update_entry_with(self, pk: bytes, sk: bytes, fn) -> Optional[Entry]:
        """Read-modify-write one row inside a single transaction with the
        full trigger/merkle path: `fn(tx, old_entry_or_None) -> Entry`.
        ref: table/data.rs update_entry_with (K2V's local insert uses it
        so the DVVS update + local-timestamp bump commit atomically)."""
        return self._apply_row(pk, sk, fn)

    def _apply_row(self, pk: bytes, sk: bytes, produce) -> Optional[Entry]:
        """The one commit path for local row changes:
        `produce(tx, old_or_None) -> new` runs inside the transaction,
        then store write + merkle todo + updated() trigger + gc todo +
        changed hooks. `produce` MAY mutate the decoded old entry and
        return it — the trigger's `old` is re-decoded from the stored
        bytes so counter deltas never alias old and new."""
        new = self.db.transaction(
            lambda tx: self._apply_row_in(tx, pk, sk, produce))
        self._after_commit([new])
        return new

    def _apply_row_in(self, tx, pk: bytes, sk: bytes,
                      produce) -> Optional[Entry]:
        k = tree_key(pk, sk)
        old_raw = tx.get(self.store, k)
        old_for_fn = (self.schema.decode_entry(old_raw)
                      if old_raw is not None else None)
        new = produce(tx, old_for_fn)
        new_raw = self.schema.encode_entry(new)
        if old_raw == new_raw:
            return None
        old = (self.schema.decode_entry(old_raw)
               if old_raw is not None else None)
        tx.insert(self.store, k, new_raw)
        delta = len(new_raw) - (len(old_raw) if old_raw is not None
                                else -len(k))
        tx.on_commit(lambda: self._apply_bytes_delta(delta))
        tx.insert(self.merkle_todo, k, blake2sum(new_raw))
        self.schema.updated(tx, old, new)
        self._maybe_gc_todo(tx, new, k, new_raw)
        return new

    def _after_commit(self, news: list) -> None:
        for new in news:
            if new is None:
                continue
            self.merkle_todo_notify.set()
            for h in self.changed_hooks:
                try:
                    h(new)
                except Exception:
                    log.exception("changed hook failed")

    # entries per transaction in update_many: each row is ~4 tiny
    # statements, so per-row BEGIN/COMMIT dominated the replica write
    # path (quorum "update" RPC, anti-entropy push, queue flush) under
    # PUT load; 32 amortize it while bounding db-lock hold time
    _UPDATE_TX_STEP = 32

    def update_many(self, raws: list[bytes]) -> int:
        n = 0
        for i in range(0, len(raws), self._UPDATE_TX_STEP):
            chunk = raws[i:i + self._UPDATE_TX_STEP]

            def body(tx, chunk=chunk):
                out = []
                for raw in chunk:
                    entry = self.schema.decode_entry(raw)
                    out.append(self._apply_row_in(
                        tx, entry.partition_key(), entry.sort_key(),
                        lambda t, old, e=entry:
                            old.merge(e) if old is not None else e))
                return out

            news = self.db.transaction(body)
            self._after_commit(news)
            n += sum(1 for x in news if x is not None)
        return n

    def _maybe_gc_todo(self, tx, new: Entry, k: bytes,
                       new_raw: bytes) -> None:
        """Tombstones get a GC-todo entry on the partition leader
        (ref: data.rs:242-257)."""
        if not new.is_tombstone():
            return
        ph = partition_hash(new.partition_key())
        nodes = self.replication.storage_nodes(ph)
        if nodes and nodes[0] == self.system_id:
            from .gc import GcTodoEntry

            GcTodoEntry.new(k, blake2sum(new_raw), delay=self.gc_delay).save(
                tx, self.gc_todo
            )

    def delete_if_equal_hash(self, k: bytes, vhash: bytes) -> bool:
        """Remove row k only if its stored encoding hashes to vhash
        (phase 3 of GC; ref: data.rs:280-310)."""

        def body(tx):
            cur = tx.get(self.store, k)
            if cur is None or blake2sum(cur) != vhash:
                return False
            old = self.schema.decode_entry(cur)
            tx.remove(self.store, k)
            freed = len(cur) + len(k)
            tx.on_commit(lambda: self._apply_bytes_delta(-freed))
            tx.insert(self.merkle_todo, k, b"")
            self.schema.updated(tx, old, None)
            return True

        changed = self.db.transaction(body)
        if changed:
            self.merkle_todo_notify.set()
        return changed

    # ---- async insert queue (ref: table/queue.rs) ----------------------

    def queue_insert(self, tx, entry: Entry) -> None:
        """Enqueue an entry for asynchronous insertion via the normal
        quorum path; called from inside `updated()` triggers so the
        enqueue commits atomically with the triggering write. Keyed by
        the full row key; a second enqueue for the same row CRDT-merges
        into the pending one (ref: data.rs:322-336)."""
        k = tree_key(entry.partition_key(), entry.sort_key())
        cur = tx.get(self.insert_queue, k)
        if cur is not None:
            entry = self.schema.decode_entry(cur).merge(entry)
        tx.insert(self.insert_queue, k, self.schema.encode_entry(entry))
        tx.on_commit(self.insert_queue_notify.set)

    # ---- stats ---------------------------------------------------------

    def stats(self) -> dict:
        return {
            "rows": len(self.store),
            "merkle_todo": len(self.merkle_todo),
            "gc_todo": len(self.gc_todo),
            "insert_queue": len(self.insert_queue),
        }

    def _apply_bytes_delta(self, delta: int) -> None:
        # on_commit only: a rolled-back tx must not skew the metric
        self._bytes_delta += delta

    def size_bytes(self) -> int:
        """Approximate stored bytes (keys + encoded rows) for the
        table_size metric family (ref: table/metrics.rs:132 table_size).
        Baseline is computed by one scan on first call; afterwards the
        commit paths maintain an incremental delta via on_commit."""
        if self._bytes_base is None:
            # batched cursor walk — a single full scan would hold the
            # db lock (and materialize the whole table) for its whole
            # duration. Consistency: if any commit lands mid-scan (the
            # delta moved), retry once; a second dirty pass settles for
            # the approximation (the metric is approximate by design).
            for _attempt in range(2):
                d0 = self._bytes_delta
                base = 0
                cursor = None
                while True:
                    batch = list(self.store.iter(start=cursor, limit=4096))
                    for k, v in batch:
                        base += len(k) + len(v)
                    if len(batch) < 4096:
                        break
                    cursor = batch[-1][0] + b"\x00"
                if self._bytes_delta == d0:
                    break
            self._bytes_base = base - d0
        return self._bytes_base + self._bytes_delta
