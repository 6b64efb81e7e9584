"""Copy of garage_tpu/table/table.py: import paths rewritten, issue and PR tags dropped.

Table: quorum-replicated CRDT table operations.

Ref parity: src/table/table.rs. insert/insert_many write encoded entries
to every live write set with per-set quorum (layout transitions are
covered by writing to old+new sets under the ack lock); get/get_range
read-quorum from the ring, CRDT-merge the responses, and schedule a
background read-repair when replicas disagree.

RPC ops (payload dicts on endpoint "garage_tpu/table:{name}"):
  {op: "update", entries: [raw,..]}
  {op: "read_entry", pk, sk}
  {op: "read_range", pk, start_sk, limit, reverse}
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ..net.message import PRIO_NORMAL
from ..rpc.rpc_helper import RequestStrategy, RpcHelper
from ..utils.error import QuorumError
from .data import TableData
from .merkle import MerkleUpdater
from .replication import TableFullReplication, TableReplication
from .schema import Entry, TableSchema, partition_hash

log = logging.getLogger("garage_tpu_torch.table")

# gateway-node control-table read cache: staleness bound (seconds) for
# full-copy rows read over RPC by a node that holds no local copy. The
# bound mirrors what storage nodes already tolerate (anti-entropy lag);
# a worker's OWN writes invalidate immediately.
GATEWAY_READ_TTL = 2.0
GATEWAY_READ_CACHE_MAX = 1024

_MISS = object()


class Table:
    def __init__(self, schema: TableSchema, replication: TableReplication,
                 rpc_helper: RpcHelper, db):
        self.schema = schema
        self.replication = replication
        self.rpc = rpc_helper
        self.system = rpc_helper.system
        self.data = TableData(db, schema, replication, self.system.id)
        self.merkle = MerkleUpdater(self.data)
        self.name = schema.TABLE_NAME
        self.endpoint = self.system.netapp.endpoint(
            f"garage_tpu/table:{self.name}"
        ).set_handler(self._handle)
        # background read-repair tasks (kept so tests/shutdown can drain)
        self._repairs: set[asyncio.Task] = set()
        # (pk, sk) -> (expiry, entry|None); only populated on gateway
        # nodes reading full-copy tables over RPC (see _get_traced)
        self._control_cache: dict[tuple, tuple[float, Optional[Entry]]] \
            = {}
        # (pk, sk) -> monotonic time of this node's last completed
        # write: a read that BEGAN before that write may carry the
        # pre-write row and must not repopulate the cache
        self._control_inval: dict[tuple, float] = {}

    def spawn_workers(self, runner) -> None:
        from .gc import TableGc
        from .queue import InsertQueueWorker
        from .sync import TableSyncer

        self.syncer = TableSyncer(self)
        runner.spawn_worker(self.merkle)
        runner.spawn_worker(self.syncer)
        runner.spawn_worker(TableGc(self))
        runner.spawn_worker(InsertQueueWorker(self))

    # ---- client ops ----------------------------------------------------

    def _control_cache_get(self, key: tuple):
        hit = self._control_cache.get(key)
        if hit is None:
            return _MISS
        expiry, entry = hit
        if expiry < time.monotonic():
            del self._control_cache[key]
            return _MISS
        return entry

    def _control_cache_put(self, key: tuple, entry: Optional[Entry],
                           read_started: float) -> None:
        if self._control_inval.get(key, -1.0) >= read_started:
            # this node completed a write to the key after the read
            # began: the fetched row may predate the write — caching it
            # would break read-your-writes for a full TTL
            return
        if len(self._control_cache) >= GATEWAY_READ_CACHE_MAX:
            # wholesale reset beats tracking LRU for a cache this small
            # and this short-lived
            self._control_cache.clear()
        self._control_cache[key] = (time.monotonic() + GATEWAY_READ_TTL,
                                    entry)

    def _control_invalidate(self, key: tuple) -> None:
        # fencing only exists where the cache does: gateway nodes
        # reading a full-copy table over RPC. Everywhere else —
        # including the hot sharded-table bulk-insert path and storage
        # nodes' control writes — this must stay O(1) and must not
        # accumulate state (an unconditional record would grow the
        # inval map with every insert and rebuild it per write once
        # past the cap).
        rep = self.replication
        if not isinstance(rep, TableFullReplication) \
                or self.rpc.system.id in rep.storage_nodes(b""):
            return
        self._control_cache.pop(key, None)
        now = time.monotonic()
        if len(self._control_inval) >= GATEWAY_READ_CACHE_MAX:
            # entries only matter for one TTL: prune instead of growing
            self._control_inval = {
                k: t for k, t in self._control_inval.items()
                if t > now - GATEWAY_READ_TTL}
        self._control_inval[key] = now

    async def insert(self, entry: Entry) -> None:
        """ref: table/table.rs:106-144."""
        from ..utils.metrics import registry
        from ..utils.tracing import span

        registry().inc("table_put_total", table=self.name)
        async with span("table.insert", table=self.name):
            await self._insert_traced(entry)
        # read-your-writes through the gateway control cache: this
        # node's own mutation must be visible on its next read. Runs
        # AFTER the quorum write, and also fences concurrent reads
        # that began before it (they must not repopulate the cache
        # with the pre-write row — see _control_cache_put).
        self._control_invalidate(
            (entry.partition_key(), entry.sort_key()))

    async def _insert_traced(self, entry: Entry) -> None:
        raw = self.schema.encode_entry(entry)
        ph = partition_hash(entry.partition_key())
        with self.replication.write_lock():
            sets = self.replication.write_sets(ph)
            # lint: ignore[GL06] write_lock is a layout-version PIN (refcount), not mutual exclusion; holding it across the quorum write IS the union-window contract (manager.rs:344)
            await self.rpc.try_write_many_sets(
                self.endpoint,
                sets,
                {"op": "update", "entries": [raw]},
                RequestStrategy(quorum=self.replication.write_quorum(),
                                prio=PRIO_NORMAL),
            )

    async def insert_many(self, entries: list[Entry]) -> None:
        """Batch insert: one RPC per node carrying all entries destined
        to it; per-write-set quorum accounting (ref: table.rs:164-285)."""
        if not entries:
            return
        with self.replication.write_lock():
            per_node: dict[bytes, list[bytes]] = {}
            all_sets: list[list[bytes]] = []
            seen_sets: set[tuple] = set()
            for e in entries:
                raw = self.schema.encode_entry(e)
                ph = partition_hash(e.partition_key())
                sets = self.replication.write_sets(ph)
                # each entry goes once per node, even when the node sits
                # in several (old+new) write sets (ref: table.rs:198-236)
                dest = {n for s in sets for n in s}
                for s in sets:
                    key = tuple(sorted(s))
                    if key not in seen_sets:
                        seen_sets.add(key)
                        all_sets.append(s)
                for n in dest:
                    per_node.setdefault(n, []).append(raw)
            # lint: ignore[GL06] write_lock is a layout-version PIN (refcount), not mutual exclusion; holding it across the quorum write IS the union-window contract (manager.rs:344)
            await self.rpc.try_write_many_sets(
                self.endpoint,
                all_sets,
                None,
                RequestStrategy(quorum=self.replication.write_quorum(),
                                prio=PRIO_NORMAL),
                make_payload=lambda n: {"op": "update",
                                        "entries": per_node.get(n, [])},
            )
        # after the quorum write, same fencing as insert()
        for e in entries:
            self._control_invalidate(
                (e.partition_key(), e.sort_key()))

    async def get(self, pk: bytes, sk: bytes,
                  consistency=None) -> Optional[Entry]:
        """Read-quorum get with CRDT merge + background read-repair.
        ref: table.rs:287-361.

        `consistency=ConsistencyMode.DEGRADED` is the
        per-request escape hatch for zone partitions: serve from any
        one surviving replica instead of failing the consistent
        quorum. The merge/read-repair machinery still runs on whatever
        replicas answered."""
        from ..utils.metrics import registry
        from ..utils.tracing import span

        registry().inc("table_get_total", table=self.name)
        async with span("table.get", table=self.name):
            return await self._get_traced(pk, sk, consistency)

    async def _get_traced(self, pk: bytes, sk: bytes,
                          consistency=None) -> Optional[Entry]:
        ph = partition_hash(pk)
        nodes = self.replication.read_nodes(ph)
        # Gateway node reading a full-copy (control) table: it holds no
        # local copy, so every auth/bucket resolve would cost an RPC to
        # the holders — on an API worker that is 4+ round-trips per S3
        # request for rows that change rarely. A short-TTL read-through
        # cache bounds staleness to GATEWAY_READ_TTL seconds, the same
        # order as the anti-entropy lag storage nodes already tolerate.
        gateway_remote = (isinstance(self.replication,
                                     TableFullReplication)
                          and self.rpc.system.id not in nodes)
        read_started = time.monotonic()
        if gateway_remote:
            hit = self._control_cache_get((pk, sk))
            if hit is not _MISS:
                return hit
        resps = await self.rpc.try_call_many(
            self.endpoint,
            nodes,
            {"op": "read_entry", "pk": pk, "sk": sk},
            RequestStrategy(quorum=self.replication.read_quorum(),
                            consistency=consistency),
        )
        ret: Optional[Entry] = None
        raws = []
        for r in resps:
            raw = r.get("entry")
            raws.append(raw)
            if raw is not None:
                e = self.schema.decode_entry(raw)
                ret = e if ret is None else ret.merge(e)
        if ret is not None:
            merged_raw = self.schema.encode_entry(ret)
            if any(r != merged_raw for r in raws):
                self._spawn_repair([ret])
        if gateway_remote:
            self._control_cache_put((pk, sk), ret, read_started)
        return ret

    async def get_range(self, pk: bytes, start_sk: Optional[bytes] = None,
                        flt=None, limit: int = 100,
                        reverse: bool = False,
                        prefix_sk: Optional[bytes] = None,
                        end_sk: Optional[bytes] = None,
                        consistency=None) -> list[Entry]:
        """ref: table.rs:363-483. `consistency` as in get()."""
        ph = partition_hash(pk)
        nodes = self.replication.read_nodes(ph)
        resps = await self.rpc.try_call_many(
            self.endpoint,
            nodes,
            {"op": "read_range", "pk": pk, "start_sk": start_sk,
             "limit": limit, "reverse": reverse, "filter": flt,
             "prefix_sk": prefix_sk, "end_sk": end_sk},
            RequestStrategy(quorum=self.replication.read_quorum(),
                            consistency=consistency),
        )
        by_key: dict[tuple, Entry] = {}
        raw_seen: dict[tuple, set] = {}
        appearances: dict[tuple, int] = {}
        for r in resps:
            for raw in r.get("entries", []):
                e = self.schema.decode_entry(raw)
                kk = (e.partition_key(), e.sort_key())
                by_key[kk] = e if kk not in by_key else by_key[kk].merge(e)
                raw_seen.setdefault(kk, set()).add(raw)
                appearances[kk] = appearances.get(kk, 0) + 1
        # repair keys whose replicas returned divergent values or that
        # some replica was missing entirely (ref: table.rs:449-471; the
        # missing-entry check is approximate near the limit boundary,
        # where absence may just mean "past that replica's window")
        to_repair = [
            e for kk, e in by_key.items()
            if len(raw_seen[kk]) > 1 or appearances[kk] < len(resps)
        ]
        if to_repair:
            self._spawn_repair(to_repair)
        out = sorted(by_key.values(),
                     key=lambda e: e.sort_key(), reverse=reverse)
        return out[:limit]

    def _spawn_repair(self, entries: list[Entry]) -> None:
        async def repair():
            try:
                await self.insert_many(entries)
            except Exception as e:
                log.debug("%s read-repair failed: %s", self.name, e)

        t = asyncio.create_task(repair())
        self._repairs.add(t)
        t.add_done_callback(self._repairs.discard)

    # ---- local (trigger-path) ops --------------------------------------

    def queue_insert(self, tx, entry: Entry) -> None:
        self.data.queue_insert(tx, entry)

    def queue_insert_local(self, entry: Entry) -> bytes:
        """Durable local enqueue outside any caller transaction: one
        tiny local tx instead of a quorum RPC (the reference's hot PUT
        path queues version/block_ref rows this way, put.rs:545; the
        InsertQueueWorker batch-propagates with quorum). Returns the
        queue row key so the caller can target its flush."""
        from .schema import tree_key

        self.data.db.transaction(
            lambda tx: self.data.queue_insert(tx, entry))
        return tree_key(entry.partition_key(), entry.sort_key())

    async def propagate_queue_batch(self, batch: list) -> None:
        """One drain step shared by InsertQueueWorker and
        flush_insert_queue: insert_many through the quorum path, then
        remove each queue row only if unchanged (a concurrent enqueue
        CRDT-merges into the pending row; the merged value stays queued
        for the next pass)."""
        entries = [self.schema.decode_entry(v) for _, v in batch]
        await self.insert_many(entries)

        def body(tx):
            for k, v in batch:
                if tx.get(self.data.insert_queue, k) == v:
                    tx.remove(self.data.insert_queue, k)

        await asyncio.to_thread(self.data.db.transaction, body)

    async def flush_insert_queue(self, keys=None) -> None:
        """Quorum-propagate queued rows AS OF NOW — only those whose
        queue key is in `keys` when given (a request flushes ITS rows
        before its final Complete insert, not the whole shared backlog).
        A single snapshot — later enqueues are the next flush's (or the
        worker's) problem, so sustained load cannot starve a caller."""
        from .queue import BATCH_SIZE

        def read_snapshot():
            if keys is None:
                return list(self.data.insert_queue.iter())
            # O(|keys|) lookups, not an O(backlog) scan per request
            return [(k, v) for k in keys
                    if (v := self.data.insert_queue.get(k)) is not None]

        snapshot = await asyncio.to_thread(read_snapshot)
        for i in range(0, len(snapshot), BATCH_SIZE):
            await self.propagate_queue_batch(snapshot[i:i + BATCH_SIZE])

    async def get_local(self, pk: bytes, sk: bytes) -> Optional[Entry]:
        # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
        raw = self.data.read_entry(pk, sk)
        return self.schema.decode_entry(raw) if raw is not None else None

    # ---- server side ---------------------------------------------------

    async def _handle(self, from_node: bytes, payload, stream):
        op = payload["op"]
        if op == "update":
            await asyncio.to_thread(self.data.update_many, payload["entries"])
            return {"ok": True}
        if op == "read_entry":
            # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
            raw = self.data.read_entry(payload["pk"], payload["sk"])
            return {"entry": raw}
        if op == "read_range":
            entries = await asyncio.to_thread(
                self.data.read_range,
                payload["pk"], payload.get("start_sk"), payload.get("filter"),
                payload.get("limit", 100), payload.get("reverse", False),
                payload.get("prefix_sk"), payload.get("end_sk"),
            )
            return {"entries": entries}
        raise ValueError(f"unknown table op {op!r}")


def queue_insert_local_many(items: list) -> list[bytes]:
    """queue_insert_local for rows spanning TABLES that share one db,
    in a single transaction — the PUT path enqueues a version and a
    block_ref row per block, and one tx instead of two halves the
    BEGIN/COMMIT cost on its hottest metadata step. `items` is
    [(table, entry)]; returns the queue row keys."""
    from .schema import tree_key

    db = items[0][0].data.db

    def body(tx):
        for t, e in items:
            t.data.queue_insert(tx, e)

    db.transaction(body)
    return [tree_key(e.partition_key(), e.sort_key()) for _, e in items]
