"""Copy of garage_tpu/table/sync.py: import paths rewritten, issue and PR tags dropped.

Anti-entropy: Merkle-tree sync between partition replicas.

Ref parity: src/table/sync.rs. Every ANTI_ENTROPY_INTERVAL (and after a
layout change), each partition this node stores is compared with the
other replicas: exchange root checksums, recursively descend differing
trie nodes, push missing/newer items. Partitions this node no longer
stores are offloaded (send everything to the new owners, then delete
locally). Completion of a sync round for a layout version reports
`sync_table_until` so the layout's sync trackers advance and old
versions can be garbage-collected.

RPC ops on endpoint "garage_tpu/table_sync:{name}":
  {op: "root_ck", partition}            -> {hash}
  {op: "get_node", partition, prefix}   -> {node}   (packed MerkleNode)
  {op: "items", entries: [raw..]}       -> {ok}
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..net.message import PRIO_BACKGROUND
from ..utils.background import Worker, WState
from .merkle import INTERMEDIATE, LEAF, MerkleNode

log = logging.getLogger("garage_tpu_torch.table.sync")

ANTI_ENTROPY_INTERVAL = 600.0
FAILED_ROUND_RETRY = 5.0  # a partial round blocks layout-sync progress


class TableSyncer(Worker):
    def __init__(self, table, interval: float = ANTI_ENTROPY_INTERVAL):
        self.table = table
        self.data = table.data
        self.merkle = table.merkle
        self.name = f"{table.name} sync"
        self.interval = interval
        self.endpoint = table.system.netapp.endpoint(
            f"garage_tpu/table_sync:{table.name}"
        ).set_handler(self._handle)
        self._last_sync = 0.0
        self._layout_version = None
        self.rounds_done = 0
        self._fail_streak = 0
        # seconds slept between partitions during a round; the qos
        # governor maps its pressure onto this during a rebalance so
        # anti-entropy storms yield to foreground p99 (resize: a layout
        # change triggers a round of EVERY table on EVERY node at once)
        self.tranquility = 0.0
        # one sync source per table: the node's layout sync tracker
        # advances at the minimum across every registered layer
        self._sync_source = f"table:{table.name}"
        lm = getattr(table.system, "layout_manager", None)
        if lm is not None:
            lm.register_sync_source(self._sync_source)

    # ---- worker --------------------------------------------------------

    async def work(self):
        # trigger on the layout VERSION, not the full gossip digest:
        # the digest covers the CRDT ack/sync trackers, which tick on
        # every gossip round of a layout transition — digest-triggered
        # rounds made every syncer on every node re-walk all 256
        # partitions continuously for the whole transition window
        # (measured as the dominant foreground-p99 cost of a resize)
        version = self.table.system.layout_helper.current().version
        due = (
            time.monotonic() - self._last_sync >= self.interval
            or version != self._layout_version
        )
        if not due:
            return WState.IDLE
        self._layout_version = version
        all_ok = await self.sync_all_partitions()
        self.rounds_done += 1
        if all_ok:
            # lint: ignore[GL12] one syncer worker per table owns _last_sync; BackgroundRunner serializes a worker's work() frames
            self._last_sync = time.monotonic()
            self._fail_streak = 0
        else:
            # a failed round never reported sync_until_from, and with
            # the digest already recorded nothing would retry it until
            # the 600 s interval — mid-resize that wedges the whole
            # cluster's sync convergence on one dropped RPC. Retry soon,
            # but back off exponentially toward the full interval: a
            # peer that stays down for an hour must not cost every
            # replica a doomed root_ck RPC per partition every 5 s.
            retry = min(self.interval,
                        FAILED_ROUND_RETRY * (2 ** self._fail_streak))
            self._fail_streak += 1
            self._last_sync = time.monotonic() - self.interval + retry
        return WState.IDLE

    async def wait_for_work(self):
        await asyncio.sleep(1.0)

    def add_full_sync(self) -> None:
        """Force a full anti-entropy round on the next worker tick
        (ref: table/sync.rs add_full_sync, CLI `repair tables`)."""
        self._last_sync = 0.0

    async def sync_all_partitions(self) -> bool:
        me = self.table.system.id
        # pin the version we're syncing against BEFORE the round; a layout
        # change mid-round must not get credit for this round's work
        round_version = self.table.system.layout_helper.current().version
        all_ok = True
        for sp in self.table.replication.sync_partitions():
            if self.tranquility > 0:
                # governed yield: background anti-entropy paces itself
                # so foreground requests interleave
                await asyncio.sleep(self.tranquility)
            stored_here = any(me in s for s in sp.storage_sets)
            try:
                if stored_here:
                    for s in sp.storage_sets:
                        for peer in s:
                            if peer != me:
                                await self.sync_partition_with(sp.partition, peer)
                else:
                    await self.offload_partition(sp)
            except Exception as e:
                all_ok = False
                log.info("%s: sync partition %d failed: %s",
                         self.name, sp.partition, e)
        # advance the sync tracker ONLY on a fully clean round — a partial
        # round must not let the cluster GC a layout version whose
        # replicas never received their data (ref: sync.rs:520-567)
        lm = getattr(self.table.system, "layout_manager", None)
        if all_ok and lm is not None:
            lm.sync_until_from(self._sync_source, round_version)
        return all_ok

    # ---- pairwise merkle sync (push) -----------------------------------

    async def sync_partition_with(self, partition: int, peer: bytes) -> None:
        """Push items the peer is missing/behind on (ref: sync.rs:275-405)."""
        empty, my_root = await asyncio.to_thread(
            lambda: (self.merkle.read_node(partition, b"").is_empty(),
                     self.merkle.root_hash(partition)))
        if empty:
            # nothing to push from an empty partition — and sync is
            # push-based, so the peer's own round covers the reverse
            # direction. With 256 partitions x every table x every
            # node re-walked on each layout change, skipping the empty
            # ones is the difference between a resize round of ~10^2
            # and ~10^5 RPCs on a sparse table.
            return
        resp = await self.endpoint.call(
            peer, {"op": "root_ck", "partition": partition}, PRIO_BACKGROUND
        )
        their_root = resp[0]["hash"]
        if their_root == my_root:
            return
        await self._descend(partition, b"", peer)

    async def _descend(self, partition: int, prefix: bytes, peer: bytes) -> None:
        mine = await asyncio.to_thread(self.merkle.read_node,
                                       partition, prefix)
        if mine.is_empty():
            return
        resp = await self.endpoint.call(
            peer, {"op": "get_node", "partition": partition, "prefix": prefix},
            PRIO_BACKGROUND,
        )
        theirs = MerkleNode.unpack(resp[0]["node"])
        if mine.node_hash() == theirs.node_hash():
            return
        if mine.kind != INTERMEDIATE:  # LEAF: push the single item
            await self._push_items_under(partition, prefix, peer)
            return
        if theirs.kind == LEAF or theirs.is_empty():
            # they have at most one item under this prefix: push subtree
            await self._push_items_under(partition, prefix, peer)
            return
        for byte, child_hash in mine.children:
            if theirs.child(byte) != child_hash:
                await self._descend(partition, prefix + bytes([byte]), peer)

    async def _push_items_under(self, partition: int, prefix: bytes,
                                peer: bytes) -> None:
        """Push every row under a trie prefix; the trie's own leaves
        enumerate them (ref: sync.rs walks the merkle subtree)."""
        def read_rows():
            row_keys = self.merkle.leaf_rows(partition, prefix)
            return [v for v in (self.data.store.get(k)
                                for k in row_keys)
                    if v is not None]

        items = await asyncio.to_thread(read_rows)
        for i in range(0, len(items), 64):
            await self.endpoint.call(
                peer, {"op": "items", "entries": items[i:i + 64]},
                PRIO_BACKGROUND,
            )

    # ---- offload (ref: sync.rs:164-265) --------------------------------

    async def offload_partition(self, sp) -> None:
        """This node no longer stores sp: push everything to the new
        owners, then delete locally."""
        me = self.table.system.id
        new_owners = [n for s in sp.storage_sets for n in s if n != me]
        if not new_owners:
            return
        while True:
            batch = await asyncio.to_thread(self._partition_rows, sp, 256)
            if not batch:
                return
            keys, vals = zip(*batch)
            for peer in dict.fromkeys(new_owners):
                await self.endpoint.call(
                    peer, {"op": "items", "entries": list(vals)},
                    PRIO_BACKGROUND,
                )
            # delete only rows unchanged since we read them
            def body(tx):
                freed = 0
                for k, v in batch:
                    if tx.get(self.data.store, k) == v:
                        tx.remove(self.data.store, k)
                        tx.insert(self.data.merkle_todo, k, b"")
                        freed += len(k) + len(v)
                if freed:
                    tx.on_commit(
                        lambda: self.data._apply_bytes_delta(-freed))

            await asyncio.to_thread(self.data.db.transaction, body)
            self.data.merkle_todo_notify.set()

    def _partition_rows(self, sp, limit: int) -> list[tuple[bytes, bytes]]:
        out = []
        for k, v in self.data.store.iter(start=sp.first_hash):
            if self.data.replication.partition_of(k[:32]) != sp.partition:
                break
            out.append((k, v))
            if len(out) >= limit:
                break
        return out

    # ---- server --------------------------------------------------------

    async def _handle(self, from_node: bytes, payload, stream):
        op = payload["op"]
        if op == "root_ck":
            h = await asyncio.to_thread(self.merkle.root_hash,
                                        payload["partition"])
            return {"hash": h}
        if op == "get_node":
            n = await asyncio.to_thread(self.merkle.read_node,
                                        payload["partition"],
                                        payload["prefix"])
            return {"node": n.pack()}
        if op == "items":
            await asyncio.to_thread(self.data.update_many, payload["entries"])
            return {"ok": True}
        raise ValueError(f"unknown sync op {op!r}")
