"""The port's lsm engine writes a tombstone only where a run older than
the active memtable holds the deleted key live (garage_tpu_torch/db/
lsm.py). Held here against the JAX package's engine, which keeps a
tombstone for every delete: on seeded random sequences of writes,
deletes, transactions (committed and rolled back), flushes, compactions,
frozen snapshots and reopenings (clean or abandoned), both engines read
the same rows, counts and values at every step; and queue-like trees,
whose keys are deleted soon after they are written, leave their
memtables empty.
"""

from __future__ import annotations

import random

import pytest

from garage_tpu.db import TxAbort as RefTxAbort
from garage_tpu.db import open_db as ref_open_db
from garage_tpu_torch.db import TxAbort, open_db

TREES = ("rows", "todo")


def _mem(db, tree: str):
    return db._engine._trees[tree].mem


def _state(db) -> dict:
    out = {}
    for name in TREES:
        t = db.open_tree(name)
        out[name] = (list(t.iter()), len(t),
                     list(t.iter(start=b"k05", end=b"k20", reverse=True)))
    return out


class _Pair:
    """The port's engine and the JAX package's, driven alike."""

    def __init__(self, root):
        self.root = root
        self.open()

    def open(self):
        self.dbs = (open_db(str(self.root / "port"), engine="lsm"),
                    ref_open_db(str(self.root / "ref"), engine="lsm"))

    def close(self, clean: bool):
        if clean:
            for d in self.dbs:
                d.close()
        self.open()

    def each(self, fn):
        for d in self.dbs:
            fn(d)

    def check(self, rng):
        port, ref = self.dbs
        assert _state(port) == _state(ref)
        for name in TREES:
            for _ in range(8):
                k = b"k%02d" % rng.randrange(40)
                assert port.open_tree(name).get(k) == \
                    ref.open_tree(name).get(k)


def _value(rng) -> bytes:
    return b"v%d" % rng.randrange(1 << 30)


@pytest.mark.parametrize("seed", range(8))
def test_reads_match_reference_engine_under_random_ops(tmp_path, seed):
    rng = random.Random(seed)
    pair = _Pair(tmp_path)
    snaps = []
    for _ in range(400):
        op = rng.random()
        name = rng.choice(TREES)
        k = b"k%02d" % rng.randrange(40)
        v = _value(rng)
        if op < 0.35:
            pair.each(lambda d: d.open_tree(name).insert(k, v))
        elif op < 0.65:
            pair.each(lambda d: d.open_tree(name).remove(k))
        elif op < 0.78:
            ops = [(rng.random() < 0.5, rng.choice(TREES),
                    b"k%02d" % rng.randrange(40), _value(rng))
                   for _ in range(rng.randrange(1, 6))]
            abort = rng.random() < 0.4

            def tx_body(d, exc):
                def body(tx):
                    for put, tn, tk, tv in ops:
                        t = d.open_tree(tn)
                        if put:
                            tx.insert(t, tk, tv)
                        else:
                            tx.remove(t, tk)
                    if abort:
                        raise exc()
                return body

            for d, exc in zip(pair.dbs, (TxAbort, RefTxAbort)):
                if abort:
                    with pytest.raises(exc):
                        d.transaction(tx_body(d, exc))
                else:
                    d.transaction(tx_body(d, exc))
        elif op < 0.84:
            pair.each(lambda d: d._engine.flush())
        elif op < 0.89:
            pair.each(lambda d: d._engine.compact_once())
        elif op < 0.94:
            # a frozen memtable: an older run that is not a segment
            snaps.append([d._engine.iter_snapshot(name) for d in pair.dbs])
        else:
            for its in snaps:
                for it in its:
                    it.close()
            snaps = []
            pair.close(clean=rng.random() < 0.5)
        pair.check(rng)
    for its in snaps:
        for it in its:
            it.close()


def test_queue_tree_leaves_no_tombstones(tmp_path):
    """Keys written and deleted while no older run holds them leave the
    memtable empty, so a scan from the tree's start walks nothing."""
    d = open_db(str(tmp_path), engine="lsm")
    t = d.open_tree("todo")
    for i in range(2000):
        t.insert(b"q%06d" % i, b"x")
        if i >= 10:
            t.remove(b"q%06d" % (i - 10))
    assert len(t) == 10
    assert len(_mem(d, "todo").d) == 10
    assert [k for k, _ in t.iter()] == [b"q%06d" % i
                                        for i in range(1990, 2000)]


def test_delete_of_key_in_segment_keeps_tombstone(tmp_path):
    d = open_db(str(tmp_path), engine="lsm")
    t = d.open_tree("rows")
    t.insert(b"a", b"1")
    t.insert(b"b", b"2")
    d._engine.flush()
    t.remove(b"a")
    assert _mem(d, "rows").d == {b"a": None}
    assert t.get(b"a") is None and len(t) == 1
    # abandoned without close: the WAL's delete masks the segment again
    d2 = open_db(str(tmp_path), engine="lsm")
    t2 = d2.open_tree("rows")
    assert t2.get(b"a") is None and list(t2.iter()) == [(b"b", b"2")]
    assert _mem(d2, "rows").d == {b"a": None}
    d2.close()


def test_delete_of_key_in_frozen_memtable_keeps_tombstone(tmp_path):
    d = open_db(str(tmp_path), engine="lsm")
    t = d.open_tree("rows")
    t.insert(b"a", b"1")
    it = d._engine.iter_snapshot("rows")
    t.remove(b"a")
    assert _mem(d, "rows").d == {b"a": None}
    assert t.get(b"a") is None
    assert list(it) == [(b"a", b"1")]


def test_rollback_restores_dropped_key(tmp_path):
    d = open_db(str(tmp_path), engine="lsm")
    t = d.open_tree("rows")
    t.insert(b"a", b"1")

    def body(tx):
        tx.remove(t, b"a")
        assert tx.get(t, b"a") is None
        assert b"a" not in _mem(d, "rows").d
        raise TxAbort()

    with pytest.raises(TxAbort):
        d.transaction(body)
    assert t.get(b"a") == b"1" and len(t) == 1
    assert list(t.iter()) == [(b"a", b"1")]
