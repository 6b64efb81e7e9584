"""Copy of garage_tpu/model/index_counter.py: import paths rewritten, issue and PR tags dropped.

Distributed index counters (objects / bytes / uploads per bucket).

Ref parity: src/model/index_counter.rs. Each counted table's `updated()`
trigger calls `IndexCounter.count(tx, old, new)` inside the same
transaction: the delta is applied to a node-local counter tree, and the
node's new totals are queued for insertion into a sharded counter table
whose entries CRDT-merge per (counter name, node id) with a timestamp —
so every node's contribution converges independently and the global
value is the sum of per-node values.

A counted entry implements:
    counter_partition_key() -> bytes
    counter_sort_key() -> bytes
    counts() -> list[(name, int)]
"""

from __future__ import annotations

from typing import Optional

import msgpack

from ..table.schema import Entry, TableSchema, tree_key
from ..table.table import Table
from ..utils.crdt import now_msec


class CounterEntry(Entry):
    """values: {name: {node_id(bytes): (ts, value)}}."""

    VERSION_MARKER = b"GTcnt01"

    def __init__(self, pk: bytes, sk: bytes, values: Optional[dict] = None):
        self.pk = pk
        self.sk = sk
        self.values: dict = values or {}

    def partition_key(self) -> bytes:
        return self.pk

    def sort_key(self) -> bytes:
        return self.sk

    def is_tombstone(self) -> bool:
        return all(
            v == 0
            for per_node in self.values.values()
            for _, v in per_node.values()
        )

    def merge(self, other: "CounterEntry") -> "CounterEntry":
        out = {n: dict(per) for n, per in self.values.items()}
        for name, per_node in other.values.items():
            mine = out.setdefault(name, {})
            for node, (ts, v) in per_node.items():
                if node not in mine or ts > mine[node][0]:
                    mine[node] = (ts, v)
        return CounterEntry(self.pk, self.sk, out)

    def filtered_values(self, nodes: list[bytes]) -> dict[str, int]:
        """Aggregate over storage nodes. Every replica of a partition
        counts the same rows, so the aggregate is max, not sum
        (ref: index_counter.rs:84-107)."""
        out: dict[str, int] = {}
        nodeset = set(nodes)
        for name, per_node in self.values.items():
            vals = [v for n, (_, v) in per_node.items() if n in nodeset]
            if vals:
                out[name] = max(vals)
        return out

    def pack(self):
        return [
            self.pk,
            self.sk,
            [
                [name, [[n, ts, v] for n, (ts, v) in sorted(per.items())]]
                for name, per in sorted(self.values.items())
            ],
        ]

    @classmethod
    def unpack(cls, o) -> "CounterEntry":
        values = {
            name: {bytes(n): (ts, v) for n, ts, v in per}
            for name, per in o[2]
        }
        return cls(bytes(o[0]), bytes(o[1]), values)


class CounterTable(TableSchema):
    ENTRY = CounterEntry

    def __init__(self, name: str):
        self.TABLE_NAME = name

    def matches_filter(self, entry, flt) -> bool:
        if flt is None:
            return True
        nodes = [bytes(n) for n in flt.get("nodes", [])]
        tomb = all(v == 0 for v in entry.filtered_values(nodes).values())
        want = flt.get("deleted", "any")
        if want == "deleted":
            return tomb
        if want == "not_deleted":
            return not tomb
        return True


class IndexCounter:
    """ref: index_counter.rs:165-252."""

    def __init__(self, system, replication, rpc_helper, db, name: str):
        self.this_node = system.id
        self.local_counter = db.open_tree(f"local_counter:{name}")
        self.table = Table(CounterTable(name), replication, rpc_helper, db)

    def spawn_workers(self, runner) -> None:
        self.table.spawn_workers(runner)

    def count(self, tx, old, new) -> None:
        """Apply the old→new delta inside the caller's transaction."""
        src = old if old is not None else new
        pk, sk = src.counter_partition_key(), src.counter_sort_key()
        deltas: dict[str, int] = {}
        for k, v in (old.counts() if old is not None else []):
            deltas[k] = deltas.get(k, 0) - v
        for k, v in (new.counts() if new is not None else []):
            deltas[k] = deltas.get(k, 0) + v

        k = tree_key(pk, sk)
        raw = tx.get(self.local_counter, k)
        local: dict[str, tuple[int, int]] = {}
        if raw is not None:
            local = {name: (ts, v) for name, ts, v in msgpack.unpackb(raw)}
        now = now_msec()
        for name, inc in deltas.items():
            ts, v = local.get(name, (0, 0))
            local[name] = (max(ts + 1, now), v + inc)
        tx.insert(
            self.local_counter, k,
            msgpack.packb([[n, ts, v] for n, (ts, v) in sorted(local.items())]),
        )
        entry = CounterEntry(
            pk, sk,
            {name: {self.this_node: tv} for name, tv in local.items()},
        )
        self.table.queue_insert(tx, entry)

    def recount(self, data) -> int:
        """OFFLINE repair: rebuild this node's local counters from a
        full scan of the counted table, replacing whatever incremental
        state drifted (ref: src/garage/repair/offline.rs:11 +
        index_counter.rs recalculation). Returns the number of counter
        rows rewritten. MUST run with the server stopped — a concurrent
        live count() landing between the scan and the rewrite would be
        overwritten by stale totals whose fresher timestamp then wins
        the CRDT merge cluster-wide. The repair-offline CLI enforces
        this with the meta-dir flock (utils/lockfile.py) that a running
        server holds for its lifetime. The rewritten counter-table
        entries gossip out through normal anti-entropy at next boot."""
        agg: dict[tuple[bytes, bytes], dict[str, int]] = {}
        key_of: dict[bytes, tuple[bytes, bytes]] = {}
        for _k, raw in data.iter_all():
            e = data.decode_stored(raw)
            pksk = (e.counter_partition_key(), e.counter_sort_key())
            key_of[tree_key(*pksk)] = pksk
            d = agg.setdefault(pksk, {})
            for name, v in e.counts():
                d[name] = d.get(name, 0) + v
        # stale local-counter rows (counted rows all gone) get zeroed;
        # tree keys are invertible, so no table row is needed
        from ..table.schema import split_tree_key

        stale: list[tuple[bytes, tuple[bytes, bytes]]] = [
            (k, split_tree_key(k))
            for k, _ in self.local_counter.iter() if k not in key_of
        ]
        now = now_msec()
        n = 0
        todo = [(tree_key(*pksk), pksk) for pksk in agg] + stale
        for key, pksk in todo:
            counts = agg.get(pksk, {})

            def body(tx, key=key, counts=counts):
                raw = tx.get(self.local_counter, key)
                local = {}
                if raw is not None:
                    local = {name: (ts, v)
                             for name, ts, v in msgpack.unpackb(raw)}
                names = set(local) | set(counts)
                for name in names:
                    ts, _old = local.get(name, (0, 0))
                    local[name] = (max(ts + 1, now), counts.get(name, 0))
                tx.insert(self.local_counter, key, msgpack.packb(
                    [[nm, ts, v] for nm, (ts, v) in sorted(local.items())]))
                return local

            local = self.table.data.db.transaction(body)
            self.table.data.update_entry_decoded(CounterEntry(
                pksk[0], pksk[1],
                {name: {self.this_node: tv}
                 for name, tv in local.items()}))
            n += 1
        return n

    async def read(self, pk: bytes, sk: bytes,
                   nodes: list[bytes]) -> dict[str, int]:
        e = await self.table.get(pk, sk)
        return e.filtered_values(nodes) if e is not None else {}
