"""Copy of garage_tpu/table/merkle.py: import paths rewritten, issue and PR tags dropped.

Merkle trie per table partition, driving anti-entropy sync.

Ref parity: src/table/merkle.rs. A background worker drains the
merkle_todo queue (row key -> new item hash, or empty = deleted) and
folds each change up a 256-ary trie stored in the `{table}:merkle_tree`
db tree. Node kinds mirror the reference (merkle.rs:55-67): Empty,
Leaf(row key, item-hash), Intermediate(children).

The trie descends along the bytes of blake2(row key) — fixed 32 bytes,
so no key is ever a prefix of another — while leaves carry the full row
key (merkle.rs:131-247, `key.next_key(khash)`). Intermediates that drop
to a single leaf child collapse upward, so the trie shape is a pure
function of the stored key set: equal content ⇒ equal root hash on
every replica, regardless of write order.

Trie storage keys: 2-byte big-endian partition ++ khash prefix.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..utils import migrate
from ..utils.background import Worker, WState
from ..utils.data import blake2sum
from .data import TableData

log = logging.getLogger("garage_tpu_torch.table.merkle")

EMPTY, LEAF, INTERMEDIATE = 0, 1, 2
EMPTY_HASH = b"\x00" * 32


class MerkleNode:
    """ref: merkle.rs:55-67."""

    __slots__ = ("kind", "key", "hash", "children")

    def __init__(self, kind: int, key: bytes = b"", h: bytes = b"",
                 children: Optional[list] = None):
        self.kind = kind
        self.key = key  # LEAF: full row key
        self.hash = h  # LEAF: item hash
        self.children = children or []  # INTERMEDIATE: [(byte, child-hash)]

    @classmethod
    def empty(cls) -> "MerkleNode":
        return cls(EMPTY)

    @classmethod
    def leaf(cls, key: bytes, h: bytes) -> "MerkleNode":
        return cls(LEAF, key=key, h=h)

    @classmethod
    def intermediate(cls, children: list) -> "MerkleNode":
        return cls(INTERMEDIATE, children=sorted(children))

    def is_empty(self) -> bool:
        return self.kind == EMPTY

    def child(self, byte: int) -> Optional[bytes]:
        for b, h in self.children:
            if b == byte:
                return h
        return None

    def with_child(self, byte: int, h: Optional[bytes]) -> "MerkleNode":
        ch = [(b, x) for b, x in self.children if b != byte]
        if h is not None:
            ch.append((byte, h))
        if not ch:
            return MerkleNode.empty()
        return MerkleNode.intermediate(ch)

    def pack(self) -> bytes:
        if self.kind == EMPTY:
            o = [EMPTY]
        elif self.kind == LEAF:
            o = [LEAF, self.key, self.hash]
        else:
            o = [INTERMEDIATE, [[b, h] for b, h in self.children]]
        return migrate.msgpack.packb(o, use_bin_type=True)

    @classmethod
    def unpack(cls, raw: Optional[bytes]) -> "MerkleNode":
        if raw is None:
            return cls.empty()
        o = migrate.msgpack.unpackb(raw, raw=True)
        if o[0] == EMPTY:
            return cls.empty()
        if o[0] == LEAF:
            return cls.leaf(o[1], o[2])
        return cls.intermediate([(b, h) for b, h in o[1]])

    def node_hash(self) -> bytes:
        """Hash of this (sub)tree; the empty tree hashes to zeros."""
        if self.kind == EMPTY:
            return EMPTY_HASH
        return blake2sum(self.pack())


def node_key(partition: int, prefix: bytes) -> bytes:
    return partition.to_bytes(2, "big") + prefix


def _group_by_byte(items: list, i: int) -> list:
    """Group khash-sorted items by khash[i] (consecutive runs)."""
    out: list = []
    cur_b = -1
    for it in items:
        b = it[1][i]
        if b != cur_b:
            out.append((b, []))
            cur_b = b
        out[-1][1].append(it)
    return out


class MerkleUpdater(Worker):
    """Drains merkle_todo into the trie (ref: merkle.rs worker).
    Batched: todo rows fold into the trie one walk per subtree
    (update_batch), not one root-to-leaf walk per row."""

    BATCH = 1024

    def __init__(self, data: TableData):
        self.data = data
        self.name = f"{data.name} merkle"

    # ---- trie read api (used by sync) ----------------------------------

    def read_node(self, partition: int, prefix: bytes) -> MerkleNode:
        return MerkleNode.unpack(
            self.data.merkle_tree.get(node_key(partition, prefix))
        )

    def root_hash(self, partition: int) -> bytes:
        return self.read_node(partition, b"").node_hash()

    def leaf_rows(self, partition: int, prefix: bytes,
                  limit: int = 1 << 30) -> list[bytes]:
        """Row keys of all leaves under a trie prefix (ref: sync.rs uses
        the subtree itself to enumerate items to push)."""
        out: list[bytes] = []
        stack = [prefix]
        while stack and len(out) < limit:
            p = stack.pop()
            n = self.read_node(partition, p)
            if n.kind == LEAF:
                out.append(n.key)
            elif n.kind == INTERMEDIATE:
                stack.extend(p + bytes([b]) for b, _ in reversed(n.children))
        return out

    # ---- updates -------------------------------------------------------

    def _partition_of_row(self, row_key: bytes) -> int:
        # row keys start with blake2(P); replication decides how many
        # partition bits matter (sharded: top byte; fullcopy: single 0)
        return self.data.replication.partition_of(row_key[:32])

    def update_item(self, row_key: bytes, new_hash: bytes) -> None:
        """Apply one todo entry (new_hash empty = row deleted), folding
        hashes up the trie inside one db transaction."""
        self.data.db.transaction(
            lambda tx: self._apply_one(tx, row_key, new_hash))

    def update_batch(self, todo: list[tuple[bytes, bytes]]) -> None:
        """Apply a batch of todo rows with ONE walk per touched subtree
        instead of one root-to-leaf walk per row: rows are grouped by
        partition, sorted by khash, and folded bottom-up, so a burst of
        inserts into one partition repacks/rehashes the root (and every
        shared upper node) once per batch instead of once per item.
        The resulting trie shape and hashes are identical to sequential
        `update_item` application (tests/test_table.py asserts it) —
        the shape stays a pure function of the key set."""
        by_part: dict[int, list] = {}
        for k, v in todo:
            by_part.setdefault(self._partition_of_row(k), []).append(
                (k, blake2sum(k), v if v else None))

        def body(tx):
            for partition, items in by_part.items():
                items.sort(key=lambda it: it[1])
                self._update_many_rec(tx, partition, b"", items)
            for k, v in todo:
                # only clear a todo entry unchanged since we read it
                # (a concurrent write may have requeued the row)
                if tx.get(self.data.merkle_todo, k) == v:
                    tx.remove(self.data.merkle_todo, k)

        self.data.db.transaction(body)

    def _update_many_rec(self, tx, partition: int, prefix: bytes,
                         items: list) -> Optional[bytes]:
        """Bulk form of _update_rec. `items` is [(row_key, khash,
        vhash|None)] sorted by khash, all sharing `prefix` in khash.
        Returns the node's new hash, EMPTY_HASH if it vanished, or None
        if unchanged."""
        i = len(prefix)
        k = node_key(partition, prefix)
        node = MerkleNode.unpack(tx.get(self.data.merkle_tree, k))

        if node.kind == INTERMEDIATE:
            changed = False
            for byte, group in _group_by_byte(items, i):
                sub = self._update_many_rec(
                    tx, partition, prefix + bytes([byte]), group)
                if sub is None:
                    continue
                node = node.with_child(byte,
                                       None if sub == EMPTY_HASH else sub)
                changed = True
            if not changed:
                return None
            if node.is_empty():
                tx.remove(self.data.merkle_tree, k)
                return EMPTY_HASH
            if len(node.children) == 1:
                # single child left: a leaf child pulls up (canonical
                # shape, same as _update_rec / merkle.rs:164-183)
                cb = node.children[0][0]
                ck = node_key(partition, prefix + bytes([cb]))
                child = MerkleNode.unpack(tx.get(self.data.merkle_tree, ck))
                if child.kind == LEAF:
                    tx.remove(self.data.merkle_tree, ck)
                    node = child
            tx.insert(self.data.merkle_tree, k, node.pack())
            return node.node_hash()

        # EMPTY or LEAF: the whole subtree is the final key set below;
        # compose it from the existing leaf (if any, not superseded by
        # an update) plus the batch's inserts, then build in place.
        final: list = []
        if node.kind == LEAF:
            upd = next((it for it in items if it[0] == node.key), None)
            if upd is None:
                final.append((node.key, blake2sum(node.key), node.hash))
            elif upd[2] is not None:
                final.append(upd)
        final.extend(it for it in items
                     if it[2] is not None
                     and not (node.kind == LEAF and it[0] == node.key))
        final.sort(key=lambda it: it[1])

        if not final:
            if node.kind == LEAF:
                tx.remove(self.data.merkle_tree, k)
                return EMPTY_HASH
            return None  # deletes of keys we never held
        if len(final) == 1:
            rk, _, vh = final[0]
            if node.kind == LEAF and node.key == rk and node.hash == vh:
                return None
            leaf = MerkleNode.leaf(rk, vh)
            tx.insert(self.data.merkle_tree, k, leaf.pack())
            return leaf.node_hash()
        # two or more keys: this node becomes an intermediate; the
        # subtrees below are built fresh (nothing deeper can exist
        # under an EMPTY/LEAF node)
        children = []
        for byte, group in _group_by_byte(final, i):
            sub = self._update_many_rec(
                tx, partition, prefix + bytes([byte]), group)
            children.append((byte, sub))
        inter = MerkleNode.intermediate(children)
        tx.insert(self.data.merkle_tree, k, inter.pack())
        return inter.node_hash()

    def _apply_one(self, tx, row_key: bytes, new_hash: bytes,
                   cache: Optional[dict] = None) -> None:
        partition = self._partition_of_row(row_key)
        khash = blake2sum(row_key)
        self._update_rec(tx, partition, b"", row_key, khash,
                         new_hash if new_hash else None, cache)
        # only clear the todo entry if it hasn't changed since we
        # read it (a concurrent write may have requeued the row)
        cur = tx.get(self.data.merkle_todo, row_key)
        if cur == (new_hash if new_hash else b""):
            tx.remove(self.data.merkle_todo, row_key)

    # ---- node access with an optional per-transaction cache: a batch
    # of todo rows re-walks the same top trie nodes (root + first
    # levels) for every row; caching raw node bytes inside the tx
    # removes those repeated SELECT/INSERT round trips ---------------

    def _nget(self, tx, cache, k: bytes):
        if cache is not None and k in cache:
            return cache[k]
        raw = tx.get(self.data.merkle_tree, k)
        if cache is not None:
            cache[k] = raw
        return raw

    def _nput(self, tx, cache, k: bytes, raw: bytes) -> None:
        tx.insert(self.data.merkle_tree, k, raw)
        if cache is not None:
            cache[k] = raw

    def _ndel(self, tx, cache, k: bytes) -> None:
        tx.remove(self.data.merkle_tree, k)
        if cache is not None:
            cache[k] = None

    def _update_rec(self, tx, partition: int, prefix: bytes, row_key: bytes,
                    khash: bytes, new_vhash: Optional[bytes],
                    cache: Optional[dict] = None) -> Optional[bytes]:
        """Returns the node's new hash (EMPTY_HASH if it vanished), or
        None if the subtree was unchanged. ref: merkle.rs:131-247."""
        i = len(prefix)
        k = node_key(partition, prefix)
        node = MerkleNode.unpack(self._nget(tx, cache, k))
        mutate: Optional[MerkleNode]

        if node.kind == EMPTY:
            mutate = MerkleNode.leaf(row_key, new_vhash) if new_vhash else None
        elif node.kind == INTERMEDIATE:
            byte = khash[i]
            sub = self._update_rec(tx, partition, prefix + bytes([byte]),
                                   row_key, khash, new_vhash, cache)
            if sub is None:
                mutate = None
            else:
                node = node.with_child(byte, None if sub == EMPTY_HASH else sub)
                if node.is_empty():
                    mutate = node
                elif len(node.children) == 1:
                    # single child left: if it's a leaf, pull it up
                    # (canonical shape; ref: merkle.rs:164-183)
                    cb = node.children[0][0]
                    ck = node_key(partition, prefix + bytes([cb]))
                    child = MerkleNode.unpack(self._nget(tx, cache, ck))
                    if child.kind == LEAF:
                        self._ndel(tx, cache, ck)
                        mutate = child
                    else:
                        mutate = node
                else:
                    mutate = node
        else:  # LEAF
            if node.key == row_key:
                if new_vhash is None:
                    mutate = MerkleNode.empty()
                elif node.hash == new_vhash:
                    mutate = None
                else:
                    mutate = MerkleNode.leaf(row_key, new_vhash)
            elif new_vhash is None:
                mutate = None  # deleting a key we don't hold here
            else:
                # split: push the existing leaf down one level, then
                # insert ours; shared khash bytes recurse further down
                exk = node.key
                exkhash = blake2sum(exk)
                sub1 = self._update_rec(tx, partition,
                                        prefix + bytes([exkhash[i]]),
                                        exk, exkhash, node.hash, cache)
                inter = MerkleNode.intermediate([(exkhash[i], sub1)])
                sub2 = self._update_rec(tx, partition,
                                        prefix + bytes([khash[i]]),
                                        row_key, khash, new_vhash, cache)
                mutate = inter.with_child(khash[i], sub2)

        if mutate is None:
            return None
        if mutate.is_empty():
            self._ndel(tx, cache, k)
            return EMPTY_HASH
        self._nput(tx, cache, k, mutate.pack())
        return mutate.node_hash()

    # ---- worker loop ---------------------------------------------------

    # rows per db transaction: the batched walk amortizes the upper
    # trie levels across the whole step, so bigger steps cut the
    # per-row cost further — 256 balances that against db-lock hold
    # time (the PUT path shares the lock)
    TX_STEP = 256

    async def work(self):
        import asyncio

        # bounded cursor read: a deep backlog (bulk load, resync storm)
        # must not be materialized whole just to take the first BATCH
        todo = await asyncio.to_thread(
            lambda: list(self.data.merkle_todo.iter(limit=self.BATCH)))
        if not todo:
            return WState.IDLE

        for i in range(0, len(todo), self.TX_STEP):
            await asyncio.to_thread(self.update_batch,
                                    todo[i:i + self.TX_STEP])
        return WState.BUSY

    async def wait_for_work(self):
        import asyncio

        while not len(self.data.merkle_todo):
            await asyncio.sleep(0.1)

    def info(self):
        from ..utils.background import WorkerInfo

        return WorkerInfo(name=self.name, queue_length=len(self.data.merkle_todo))
