"""Copy of garage_tpu/table/gc.py: import paths rewritten, issue and PR tags dropped.

3-phase tombstone garbage collection.

Ref parity: src/table/gc.rs. Tombstones (fully-deleted CRDT entries) can
only be dropped once every storage node holds them — otherwise a replica
that missed the deletion would resurrect the entry on the next sync. The
protocol (gc.rs:73-275):

  1. the partition leader waits TABLE_GC_DELAY after the tombstone lands,
  2. pushes the tombstone to ALL storage nodes ("update" + mark "save"),
  3. then asks all nodes to delete-if-equal-hash, so a concurrent newer
     write is never clobbered.

RPC ops on endpoint "garage_tpu/table_gc:{name}":
  {op: "update", entries}   -> push tombstones + remember them
  {op: "delete_if_eq", items: [(key, vhash)..]}
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..net.message import PRIO_BACKGROUND
from ..utils.background import Worker, WState

log = logging.getLogger("garage_tpu_torch.table.gc")

TABLE_GC_DELAY = 24 * 3600.0
TABLE_GC_BATCH_SIZE = 1024


class GcTodoEntry:
    """Row in the gc_todo tree, keyed by (deadline ms ++ row key).
    ref: gc.rs GcTodoEntry."""

    def __init__(self, deadline_ms: int, row_key: bytes, value_hash: bytes):
        self.deadline_ms = deadline_ms
        self.row_key = row_key
        self.value_hash = value_hash

    @classmethod
    def new(cls, row_key: bytes, value_hash: bytes,
            delay: float = TABLE_GC_DELAY) -> "GcTodoEntry":
        return cls(int((time.time() + delay) * 1000), row_key, value_hash)

    def todo_key(self) -> bytes:
        return self.deadline_ms.to_bytes(8, "big") + self.row_key

    def save(self, tx, gc_todo_tree) -> None:
        tx.insert(gc_todo_tree, self.todo_key(), self.value_hash)

    @classmethod
    def parse(cls, k: bytes, v: bytes) -> "GcTodoEntry":
        return cls(int.from_bytes(k[:8], "big"), k[8:], v)


class TableGc(Worker):
    def __init__(self, table, delay: float = TABLE_GC_DELAY):
        self.table = table
        self.data = table.data
        self.name = f"{table.name} gc"
        self.delay = delay
        self.endpoint = table.system.netapp.endpoint(
            f"garage_tpu/table_gc:{table.name}"
        ).set_handler(self._handle)

    async def work(self):
        now_ms = int(time.time() * 1000)

        def collect() -> list[GcTodoEntry]:
            batch: list[GcTodoEntry] = []
            for k, v in self.data.gc_todo.iter():
                e = GcTodoEntry.parse(k, v)
                if e.deadline_ms > now_ms:
                    break
                batch.append(e)
                if len(batch) >= TABLE_GC_BATCH_SIZE:
                    break
            return batch

        batch = await asyncio.to_thread(collect)
        if not batch:
            return WState.IDLE
        await self.gc_batch(batch)
        return WState.BUSY

    async def wait_for_work(self):
        await asyncio.sleep(60.0)

    async def gc_batch(self, batch: list[GcTodoEntry]) -> None:
        """Group by storage-node set, then run the 2 RPC phases.
        ref: gc.rs:152-275."""
        me = self.table.system.id
        # drop entries whose row changed since (no longer that tombstone);
        # per-entry sqlite read + digest runs off the event loop (GL01)
        from ..utils.data import blake2sum

        def filter_live() -> list[GcTodoEntry]:
            out: list[GcTodoEntry] = []
            for e in batch:
                cur = self.data.store.get(e.row_key)
                if cur is None or blake2sum(cur) != e.value_hash:
                    self.data.gc_todo.remove(e.todo_key())
                else:
                    out.append(e)
            return out

        live = await asyncio.to_thread(filter_live)

        by_nodes: dict[tuple, list[GcTodoEntry]] = {}
        for e in live:
            nodes = tuple(sorted(self.data.replication.storage_nodes(e.row_key[:32])))
            by_nodes.setdefault(nodes, []).append(e)

        for nodes, entries in by_nodes.items():
            raws = await asyncio.to_thread(
                lambda es=entries: [self.data.store.get(e.row_key)
                                    for e in es])
            pairs = [(e, r) for e, r in zip(entries, raws) if r is not None]
            if not pairs:
                continue
            try:
                # phase 2: make sure every node stores the tombstone
                for n in nodes:
                    if n != me:
                        await self.endpoint.call(
                            n, {"op": "update",
                                "entries": [r for _, r in pairs]},
                            PRIO_BACKGROUND,
                        )
                # phase 3: delete-if-equal everywhere (including locally)
                items = [(e.row_key, e.value_hash) for e, _ in pairs]
                for n in nodes:
                    if n == me:
                        await asyncio.to_thread(self._delete_if_eq, items)
                    else:
                        await self.endpoint.call(
                            n, {"op": "delete_if_eq", "items": items},
                            PRIO_BACKGROUND,
                        )
                await asyncio.to_thread(
                    lambda ps=pairs: [
                        self.data.gc_todo.remove(e.todo_key())
                        for e, _ in ps])
            except Exception as ex:
                log.info("%s: gc batch failed (will retry): %s", self.name, ex)

    def _delete_if_eq(self, items) -> None:
        for key, vhash in items:
            self.data.delete_if_equal_hash(key, vhash)

    async def _handle(self, from_node: bytes, payload, stream):
        op = payload["op"]
        if op == "update":
            await asyncio.to_thread(self.data.update_many, payload["entries"])
            return {"ok": True}
        if op == "delete_if_eq":
            await asyncio.to_thread(self._delete_if_eq, payload["items"])
            return {"ok": True}
        raise ValueError(f"unknown gc op {op!r}")
