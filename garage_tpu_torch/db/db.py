"""Copy of garage_tpu/db/db.py: import paths rewritten, issue and PR tags dropped.

KV facade + sqlite/memory engines.

Ref parity: src/db/lib.rs:28-432 (Db, Tree, Transaction, TxResult, on_commit),
src/db/sqlite_adapter.rs, src/db/open.rs:65-125 (engine selection).

Concurrency model: engine calls are synchronous and guarded by an RLock; the
asyncio server calls them directly (ops are sub-millisecond) or via
asyncio.to_thread for bulk scans. Transactions are serializable: one writer at
a time (the RLock), like the reference's LMDB single-writer model.
"""

from __future__ import annotations

import bisect
import os
import shutil
import sqlite3
import threading
from typing import Callable, Iterator, Optional, Tuple


# "previous value unknown" sentinel for _Engine.put/delete's `prev`
# hint: the Tree/Transaction facades have ALWAYS just read the old
# value when they write, and an engine that needs existence for live-
# count bookkeeping (lsm) can skip a full source walk when it is told.
PREV_UNKNOWN = object()


class TxAbort(Exception):
    """Raise inside a transaction body to roll back. ref: db/lib.rs TxError::Abort."""

    def __init__(self, value=None):
        self.value = value


def blocking_api(fn):
    """Marker for synchronous, potentially-blocking API functions.

    garage-lint's GL10 reads this (the decorator, or a `blocking_api =
    True` class attribute) instead of guessing from receiver names: a
    non-awaited call that resolves to a marked function is a blocking
    atom when reached from an async frame without a to_thread hop.
    Runtime no-op beyond the attribute (satellite)."""
    fn.__blocking_api__ = True
    return fn


class Db:
    # every public method runs engine code under the Db lock — sqlite
    # or LSM I/O that must never run directly on the event loop
    blocking_api = True

    def __init__(self, engine: "_Engine"):
        self._engine = engine
        self._lock = threading.RLock()
        self._trees: dict[str, Tree] = {}

    @property
    def engine_name(self) -> str:
        return self._engine.NAME

    def open_tree(self, name: str) -> "Tree":
        with self._lock:
            t = self._trees.get(name)
            if t is None:
                self._engine.ensure_tree(name)
                t = Tree(self, name)
                self._trees[name] = t
            return t

    def list_trees(self) -> list[str]:
        return self._engine.list_trees()

    def transaction(self, body: Callable[["Transaction"], object]):
        """Run `body(tx)`; commit on return, roll back on TxAbort/exception.
        Returns body's return value; TxAbort re-raises after rollback.
        on_commit hooks registered via tx.on_commit run after a successful
        commit (ref: db/lib.rs:322)."""
        with self._lock:
            tx = Transaction(self._engine)
            self._engine.begin()
            try:
                result = body(tx)
            except BaseException:
                self._engine.rollback()
                raise
            self._engine.commit()
            for hook in tx._hooks:
                hook()
            return result

    def snapshot(self, to_dir: str) -> None:
        """Engine-level hot copy. ref: db/lib.rs snapshot, model/snapshot.rs."""
        with self._lock:
            self._engine.snapshot(to_dir)

    def engine_stats(self) -> dict:
        """Per-engine internals for operators (admin GET /v1/metadata +
        the meta_* gauges): segment counts, WAL size, compaction
        backlog for lsm; file size for sqlite; row totals everywhere."""
        with self._lock:
            return self._engine.stats()

    def close(self) -> None:
        with self._lock:
            self._engine.close()


class Tree:
    """A named keyspace with ordered byte keys. ref: db/lib.rs:98-270."""

    # sqlite/LSM I/O under the Db lock: blocking by contract (GL10)
    blocking_api = True

    def __init__(self, db: Db, name: str):
        self._db = db
        self._e = db._engine
        self.name = name

    def get(self, key: bytes) -> Optional[bytes]:
        with self._db._lock:
            return self._e.get(self.name, key)

    def insert(self, key: bytes, value: bytes) -> Optional[bytes]:
        """Returns previous value (the reference returns the old value)."""
        with self._db._lock:
            self._e.begin()
            try:
                old = self._e.get(self.name, key)
                self._e.put(self.name, key, value, prev=old)
            except BaseException:
                self._e.rollback()
                raise
            self._e.commit()
            return old

    def remove(self, key: bytes) -> Optional[bytes]:
        with self._db._lock:
            self._e.begin()
            try:
                old = self._e.get(self.name, key)
                if old is not None:
                    self._e.delete(self.name, key, prev=old)
            except BaseException:
                self._e.rollback()
                raise
            self._e.commit()
            return old

    def clear(self) -> None:
        with self._db._lock:
            self._e.begin()
            self._e.clear(self.name)
            self._e.commit()

    def __len__(self) -> int:
        with self._db._lock:
            return self._e.length(self.name)

    def first(self) -> Optional[Tuple[bytes, bytes]]:
        for kv in self.iter():
            return kv
        return None

    def get_gt(self, key: bytes) -> Optional[Tuple[bytes, bytes]]:
        for kv in self.iter(start=key + b"\x00", limit=1):
            return kv
        return None

    def iter(self, start: Optional[bytes] = None, end: Optional[bytes] = None,
             reverse: bool = False,
             limit: Optional[int] = None) -> Iterator[Tuple[bytes, bytes]]:
        """Ordered scan over [start, end). Materialized per-call to stay
        consistent under concurrent writes; pass `limit` for cursor-style
        batch walks so a batch never materializes the whole tail."""
        with self._db._lock:
            items = self._e.range(self.name, start, end, reverse, limit)
        return iter(items)


class Transaction:
    """Operations inside Db.transaction(); sees its own writes.
    ref: db/lib.rs:272-384 (ITx)."""

    # runs inside Db.transaction's engine critical section (GL10)
    blocking_api = True

    def __init__(self, engine: "_Engine"):
        self._e = engine
        self._hooks: list[Callable[[], None]] = []

    def get(self, tree: Tree, key: bytes) -> Optional[bytes]:
        return self._e.get(tree.name, key)

    def insert(self, tree: Tree, key: bytes, value: bytes) -> Optional[bytes]:
        old = self._e.get(tree.name, key)
        self._e.put(tree.name, key, value, prev=old)
        return old

    def remove(self, tree: Tree, key: bytes) -> Optional[bytes]:
        old = self._e.get(tree.name, key)
        if old is not None:
            self._e.delete(tree.name, key, prev=old)
        return old

    def length(self, tree: Tree) -> int:
        return self._e.length(tree.name)

    def range(self, tree: Tree, start: Optional[bytes] = None,
              end: Optional[bytes] = None, reverse: bool = False,
              limit: Optional[int] = None):
        return self._e.range(tree.name, start, end, reverse, limit)

    def on_commit(self, hook: Callable[[], None]) -> None:
        self._hooks.append(hook)


# ---------------------------------------------------------------- engines


class _Engine:
    NAME = "?"

    def ensure_tree(self, name: str) -> None: ...
    def list_trees(self) -> list[str]: ...
    def get(self, tree: str, key: bytes) -> Optional[bytes]: ...

    # `prev` is a hint: the stored value (None = absent) the caller just
    # read under the same lock, or PREV_UNKNOWN
    def put(self, tree: str, key: bytes, value: bytes,
            prev=PREV_UNKNOWN) -> None: ...
    def delete(self, tree: str, key: bytes, prev=PREV_UNKNOWN) -> None: ...
    def clear(self, tree: str) -> None: ...
    def length(self, tree: str) -> int: ...
    def range(self, tree, start, end, reverse, limit=None) -> list: ...
    def begin(self) -> None: ...
    def commit(self) -> None: ...
    def rollback(self) -> None: ...
    def snapshot(self, to_dir: str) -> None: ...
    def close(self) -> None: ...

    def stats(self) -> dict:
        return {"engine": self.NAME}


class MemEngine(_Engine):
    """Sorted in-memory store for tests and the deterministic sim harness."""

    NAME = "memory"

    def __init__(self):
        # tree -> (dict, sorted key list)
        self._data: dict[str, dict[bytes, bytes]] = {}
        self._keys: dict[str, list[bytes]] = {}
        self._undo: list | None = None
        self._depth = 0

    def ensure_tree(self, name):
        if name not in self._data:
            self._data[name] = {}
            self._keys[name] = []

    def list_trees(self):
        return list(self._data)

    def get(self, tree, key):
        return self._data[tree].get(key)

    def put(self, tree, key, value, prev=PREV_UNKNOWN):
        d = self._data[tree]
        if self._undo is not None:
            self._undo.append((tree, key, d.get(key)))
        if key not in d:
            bisect.insort(self._keys[tree], key)
        d[key] = value

    def delete(self, tree, key, prev=PREV_UNKNOWN):
        d = self._data[tree]
        if key in d:
            if self._undo is not None:
                self._undo.append((tree, key, d[key]))
            del d[key]
            ks = self._keys[tree]
            i = bisect.bisect_left(ks, key)
            if i < len(ks) and ks[i] == key:
                ks.pop(i)

    def clear(self, tree):
        if self._undo is not None:
            for k, v in self._data[tree].items():
                self._undo.append((tree, k, v))
        self._data[tree] = {}
        self._keys[tree] = []

    def length(self, tree):
        return len(self._data[tree])

    def range(self, tree, start, end, reverse, limit=None):
        ks = self._keys[tree]
        lo = bisect.bisect_left(ks, start) if start is not None else 0
        hi = bisect.bisect_left(ks, end) if end is not None else len(ks)
        sel = ks[lo:hi]
        if reverse:
            sel = list(reversed(sel))
        if limit is not None:
            sel = sel[:limit]
        d = self._data[tree]
        return [(k, d[k]) for k in sel]

    def begin(self):
        self._depth += 1
        if self._depth == 1:
            self._undo = []

    def commit(self):
        self._depth -= 1
        if self._depth == 0:
            self._undo = None

    def rollback(self):
        self._depth -= 1
        if self._depth == 0 and self._undo is not None:
            for tree, key, old in reversed(self._undo):
                if old is None:
                    self._no_undo_delete(tree, key)
                else:
                    self._no_undo_put(tree, key, old)
            self._undo = None

    def _no_undo_put(self, tree, key, value):
        d = self._data[tree]
        if key not in d:
            bisect.insort(self._keys[tree], key)
        d[key] = value

    def _no_undo_delete(self, tree, key):
        d = self._data[tree]
        if key in d:
            del d[key]
            ks = self._keys[tree]
            i = bisect.bisect_left(ks, key)
            if i < len(ks) and ks[i] == key:
                ks.pop(i)

    def stats(self):
        return {"engine": self.NAME, "trees": len(self._data),
                "rows": sum(len(d) for d in self._data.values())}

    def snapshot(self, to_dir):
        # dev/test engine: dump all trees as one msgpack file so the
        # snapshot workers + CLI behave uniformly across engines
        import msgpack
        import os

        os.makedirs(to_dir, exist_ok=True)
        payload = {t: list(self._data[t].items()) for t in self._data}
        tmp = os.path.join(to_dir, "memdb.msgpack.tmp")
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(payload, use_bin_type=True))
        os.replace(tmp, os.path.join(to_dir, "memdb.msgpack"))

    def close(self):
        pass


class SqliteEngine(_Engine):
    """sqlite3-backed engine; one SQL table per tree.
    ref: src/db/sqlite_adapter.rs."""

    NAME = "sqlite"

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     isolation_level=None)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(
            "PRAGMA synchronous=%s" % ("FULL" if fsync else "OFF"))
        self._depth = 0
        self._stats_cache: Optional[dict] = None
        self._stats_at = 0.0

    @staticmethod
    def _tbl(name: str) -> str:
        return '"tree_%s"' % name.replace('"', '""')

    def ensure_tree(self, name):
        self._conn.execute(
            f"CREATE TABLE IF NOT EXISTS {self._tbl(name)} "
            "(k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID")

    def list_trees(self):
        rows = self._conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name LIKE 'tree_%'").fetchall()
        return [r[0][5:] for r in rows]

    def get(self, tree, key):
        row = self._conn.execute(
            f"SELECT v FROM {self._tbl(tree)} WHERE k=?", (key,)).fetchone()
        return row[0] if row else None

    def put(self, tree, key, value, prev=PREV_UNKNOWN):
        self._conn.execute(
            f"INSERT INTO {self._tbl(tree)}(k,v) VALUES(?,?) "
            "ON CONFLICT(k) DO UPDATE SET v=excluded.v", (key, value))

    def delete(self, tree, key, prev=PREV_UNKNOWN):
        self._conn.execute(f"DELETE FROM {self._tbl(tree)} WHERE k=?", (key,))

    def clear(self, tree):
        self._conn.execute(f"DELETE FROM {self._tbl(tree)}")

    def length(self, tree):
        return self._conn.execute(
            f"SELECT COUNT(*) FROM {self._tbl(tree)}").fetchone()[0]

    def range(self, tree, start, end, reverse, limit=None):
        q = f"SELECT k, v FROM {self._tbl(tree)}"
        conds, params = [], []
        if start is not None:
            conds.append("k >= ?")
            params.append(start)
        if end is not None:
            conds.append("k < ?")
            params.append(end)
        if conds:
            q += " WHERE " + " AND ".join(conds)
        q += " ORDER BY k" + (" DESC" if reverse else "")
        if limit is not None:
            q += " LIMIT ?"
            params.append(limit)
        return self._conn.execute(q, params).fetchall()

    def begin(self):
        self._depth += 1
        if self._depth == 1:
            self._conn.execute("BEGIN IMMEDIATE")

    def commit(self):
        self._depth -= 1
        if self._depth == 0:
            self._conn.execute("COMMIT")

    def rollback(self):
        self._depth -= 1
        if self._depth == 0:
            self._conn.execute("ROLLBACK")

    def snapshot(self, to_dir):
        os.makedirs(to_dir, exist_ok=True)
        dest = os.path.join(to_dir, os.path.basename(self.path))
        dst = sqlite3.connect(dest)
        try:
            self._conn.backup(dst)
        finally:
            dst.close()

    def stats(self):
        # the row total is a COUNT(*) scan per tree — O(all rows) while
        # holding the Db lock. /metrics scrapes every few seconds, so
        # cache it; file size stays live (stat() is cheap)
        import time

        now = time.monotonic()
        if self._stats_cache is None or now - self._stats_at >= 10.0:
            trees = self.list_trees()
            self._stats_cache = {
                "engine": self.NAME, "trees": len(trees),
                "rows": sum(self.length(t) for t in trees)}
            self._stats_at = now
        st = dict(self._stats_cache)
        try:
            st["file_bytes"] = os.path.getsize(self.path)
        except OSError:
            st["file_bytes"] = 0
        return st

    def close(self):
        self._conn.close()


@blocking_api
def open_db(path: str, engine: str = "sqlite", fsync: bool = False) -> Db:
    """ref: src/db/open.rs:65-125 (engine selection; `[metadata]
    db_engine = sqlite|memory|lsm`)."""
    if engine == "sqlite":
        return Db(SqliteEngine(os.path.join(path, "db.sqlite")
                               if not path.endswith(".sqlite") else path,
                               fsync=fsync))
    if engine == "memory":
        return Db(MemEngine())
    if engine == "lsm":
        from .lsm import LsmEngine

        return Db(LsmEngine(os.path.join(path, "db.lsm")
                            if not path.endswith(".lsm") else path,
                            fsync=fsync))
    raise ValueError(f"unknown db engine {engine!r} (sqlite|memory|lsm)")
