"""Copy of garage_tpu/model/k2v/rpc.py: import paths rewritten, issue and PR tags dropped.

K2V RPC: insert routing + poll subscriptions.

Ref parity: src/model/k2v/rpc.rs. Inserts are NOT applied by the API
gateway node: they are routed to one of the partition's storage nodes
(quorum 1) which applies the DVVS update under its *own* node id — this
keeps vector clocks bounded by the replication factor instead of growing
with every gateway that ever handled a write. The storage node then
propagates the merged item through the normal table quorum write.

PollItem long-polling (ref rpc.rs:206-260, sub.rs): the API node asks
every storage node to wake it when the item's causal context becomes
newer than the client's token; first non-empty response wins.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ...net.message import PRIO_NORMAL
from ...table.schema import partition_hash
from ...utils.crdt import now_msec
from .causality import CausalContext
from .item_table import K2VItem, partition_pk

log = logging.getLogger("garage_tpu_torch.model.k2v")

_TIMESTAMP_KEY = b"timestamp"


class PeerPollTimeout(Exception):
    """A storage node answered 'nothing changed within your window' —
    distinct from a transport timeout reaching that node."""


class SubscriptionManager:
    """Wakes local pollers when an item changes (ref: k2v/sub.rs).

    notify() can fire from worker threads (table updates apply via
    asyncio.to_thread), so wakeups go through call_soon_threadsafe on
    the loop captured at subscribe time, and the registry is
    lock-protected."""

    def __init__(self):
        import threading

        self._events: dict[tuple, list] = {}  # key -> [(loop, Event)]
        self._lock = threading.Lock()

    def _key(self, item: K2VItem) -> tuple:
        return (item.bucket_id, item.partition_key_str, item.sort_key_str)

    def notify(self, item: K2VItem) -> None:
        with self._lock:
            waiters = self._events.pop(self._key(item), [])
            # partition-level subscribers (PollRange) wake on ANY item
            # change in the partition
            waiters += self._events.pop(
                (item.bucket_id, item.partition_key_str, None), [])
        for loop, ev in waiters:
            loop.call_soon_threadsafe(ev.set)

    def subscribe(self, bucket_id: bytes, pk: str, sk: str) -> asyncio.Event:
        ev = asyncio.Event()
        loop = asyncio.get_running_loop()
        with self._lock:
            self._events.setdefault((bucket_id, pk, sk), []).append(
                (loop, ev))
        return ev

    def unsubscribe(self, bucket_id: bytes, pk: str, sk: str,
                    ev: asyncio.Event) -> None:
        with self._lock:
            lst = self._events.get((bucket_id, pk, sk))
            if not lst:
                return
            self._events[(bucket_id, pk, sk)] = [
                (lp, e) for lp, e in lst if e is not ev]
            if not self._events[(bucket_id, pk, sk)]:
                del self._events[(bucket_id, pk, sk)]


class K2VRpcHandler:
    def __init__(self, system, db, item_table, subscriptions):
        self.system = system
        self.item_table = item_table
        self.subscriptions = subscriptions
        self.local_timestamp = db.open_tree("k2v_local_timestamp")
        self.endpoint = system.netapp.endpoint("garage_tpu/k2v").set_handler(
            self._handle)

    # ---- public interface (API server calls these) ---------------------

    def _storage_nodes(self, bucket_id: bytes, partition_key: str
                       ) -> list[bytes]:
        ph = partition_hash(partition_pk(bucket_id, partition_key))
        return sorted(self.item_table.replication.storage_nodes(ph))

    async def insert(self, bucket_id: bytes, partition_key: str,
                     sort_key: str, causal_context: Optional[CausalContext],
                     value: Optional[bytes]) -> None:
        who = self._storage_nodes(bucket_id, partition_key)
        payload = {
            "op": "insert",
            "bucket": bucket_id,
            "pk": partition_key,
            "sk": sort_key,
            "ct": (causal_context.serialize()
                   if causal_context is not None else None),
            "value": value,
        }
        await self._call_any(who, payload)

    async def insert_batch(self, bucket_id: bytes,
                           items: list[tuple[str, str,
                                             Optional[CausalContext],
                                             Optional[bytes]]]) -> None:
        by_nodes: dict[tuple, list] = {}
        for pk, sk, ct, value in items:
            who = tuple(self._storage_nodes(bucket_id, pk))
            by_nodes.setdefault(who, []).append(
                [pk, sk, ct.serialize() if ct is not None else None, value])
        await asyncio.gather(*[
            self._call_any(list(who), {"op": "insert_many",
                                       "bucket": bucket_id,
                                       "items": batch})
            for who, batch in by_nodes.items()
        ])

    async def _poll_first_success(self, who: list[bytes], payload,
                                  timeout: float, empty_key: str):
        """Fan out a poll RPC; first non-empty response wins. Returns
        None only for genuine peer-side timeouts — when every peer
        failed HARD (unreachable etc.) this raises so the API answers
        an error instead of disguising an outage as 'no changes'."""
        async def one(node):
            resp, _ = await self.endpoint.call(node, payload, PRIO_NORMAL,
                                               timeout=timeout + 10.0)
            if resp.get(empty_key) is None:
                # dedicated sentinel: on py3.11+ asyncio.TimeoutError IS
                # TimeoutError, so a transport timeout to an unreachable
                # node must not masquerade as a peer-side "no changes"
                raise PeerPollTimeout("poll timed out on peer")
            return resp

        tasks = [asyncio.create_task(one(n)) for n in who]
        saw_timeout = False
        errors: list[Exception] = []
        try:
            while tasks:
                done, tasks_set = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED)
                tasks = list(tasks_set)
                for t in done:
                    e = t.exception()
                    if e is None:
                        return t.result()
                    if isinstance(e, PeerPollTimeout):
                        saw_timeout = True
                    else:
                        errors.append(e)
            if saw_timeout:
                return None
            raise RuntimeError(
                f"poll failed on all {len(who)} storage nodes: "
                f"{errors[:2]}")
        finally:
            for t in tasks:
                t.cancel()

    async def poll_item(self, bucket_id: bytes, partition_key: str,
                        sort_key: str, causal_context: CausalContext,
                        timeout: float) -> Optional[K2VItem]:
        """Wait until the item is newer than `causal_context`; None on
        timeout. First storage node to see a newer version answers."""
        who = self._storage_nodes(bucket_id, partition_key)
        payload = {"op": "poll_item", "bucket": bucket_id,
                   "pk": partition_key, "sk": sort_key,
                   "ct": causal_context.serialize(),
                   "timeout_ms": int(timeout * 1000)}
        resp = await self._poll_first_success(who, payload, timeout,
                                              "item")
        if resp is None:
            return None
        from ...utils import migrate

        return migrate.decode(K2VItem, resp["item"])

    async def poll_range(self, bucket_id: bytes, partition_key: str,
                         prefix: Optional[str], start: Optional[str],
                         end: Optional[str], seen_str: Optional[str],
                         timeout: float):
        """Wait until any item in the range changes vs the seen marker;
        -> (changed items, new marker string) or None on timeout
        (ref: rpc.rs poll_range + seen.rs RangeSeenMarker)."""
        from .seen import RangeSeenMarker

        if RangeSeenMarker.parse(seen_str or "") is None:
            raise ValueError("bad seen marker")
        who = self._storage_nodes(bucket_id, partition_key)
        payload = {"op": "poll_range", "bucket": bucket_id,
                   "pk": partition_key, "prefix": prefix, "start": start,
                   "end": end, "seen": seen_str or "",
                   "timeout_ms": int(timeout * 1000)}
        resp = await self._poll_first_success(who, payload, timeout,
                                              "items")
        if resp is None:
            return None
        from ...utils import migrate

        items = [migrate.decode(K2VItem, raw) for raw in resp["items"]]
        return items, resp["seen"]

    _POLL_PAGE = 500
    _POLL_MAX_CHANGED = 1000

    def _range_changed(self, bucket_id: bytes, pk: str,
                       prefix: Optional[str], start: Optional[str],
                       end: Optional[str], marker) -> list[K2VItem]:
        """Scan the WHOLE range in pages — a one-page horizon would make
        items past it permanently invisible to pollers. Output is capped
        (the marker only advances for returned items, so the remainder
        re-surfaces immediately on the next poll).

        Raw-cursor scan: pages come from read_range_raw, so
        the sort key for the resume cursor and the marker lookup is
        sliced off the engine key — pagination never decodes. Each
        ROW still decodes once (honestly: the marker comparison needs
        the stored vector clock, which only the decoded item carries)
        — the real win is that the whole scan+decode loop runs in a
        worker thread (see _handle_poll_range), not on the event
        loop, because at a million keys it is exactly the blocking
        helper GL10 exists to catch."""
        data = self.item_table.data
        out: list[K2VItem] = []
        cursor = start.encode() if start else None
        while True:
            rows, next_cursor = data.read_range_raw(
                partition_pk(bucket_id, pk), cursor,
                self._POLL_PAGE,
                prefix_sk=prefix.encode() if prefix else None,
                end_sk=end.encode() if end else None)
            for sk, raw in rows:
                item = data.decode_stored(raw)
                if marker.is_new(sk.decode("utf-8", "replace"),
                                 item.causal_context()):
                    out.append(item)
                    if len(out) >= self._POLL_MAX_CHANGED:
                        return out
            if next_cursor is None:
                return out
            cursor = next_cursor

    async def _handle_poll_range(self, bucket_id: bytes, pk: str,
                                 prefix, start, end, seen_str: str,
                                 timeout: float):
        from .seen import RangeSeenMarker

        marker = RangeSeenMarker.parse(seen_str)
        if marker is None:
            raise ValueError("bad seen marker")
        deadline = time.monotonic() + timeout
        while True:
            ev = self.subscriptions.subscribe(bucket_id, pk, None)
            try:
                # off-loop: the scan walks and decodes the whole range
                # — at scale that is a multi-ms sqlite/LSM read +
                # decode burst that must not stall the event loop
                changed = await asyncio.to_thread(
                    self._range_changed, bucket_id, pk, prefix,
                    start, end, marker)
                if changed:
                    for item in changed:
                        marker.update(item.sort_key_str,
                                      item.causal_context())
                    return changed, marker.serialize()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                try:
                    await asyncio.wait_for(ev.wait(), remaining)
                except asyncio.TimeoutError:
                    return None
            finally:
                self.subscriptions.unsubscribe(bucket_id, pk, None, ev)

    # ---- local application --------------------------------------------

    async def _call_any(self, who: list[bytes], payload) -> None:
        """try_call_many with quorum 1 (ref: rpc.rs insert).

        hedge=False: this is a WRITE — a hedge against a slow-but-alive
        node would apply the insert under two node ids and surface
        duplicate DVVS siblings. Failover on error (at-least-once)
        stays, as in the reference."""
        from ...rpc.rpc_helper import RequestStrategy

        await self.item_table.rpc.try_call_many(
            self.endpoint, who, payload,
            RequestStrategy(quorum=1, prio=PRIO_NORMAL, timeout=30.0,
                            hedge=False),
        )

    def _local_insert(self, bucket_id: bytes, pk: str, sk: str,
                      ct_str: Optional[str],
                      value: Optional[bytes]) -> Optional[K2VItem]:
        """Apply the DVVS update locally under OUR node id, atomically
        with the monotonic local-timestamp bump, through the full
        trigger/merkle path (ref: rpc.rs local_insert)."""
        ct = CausalContext.parse(ct_str) if ct_str else None
        data = self.item_table.data

        def apply(tx, old):
            old_ts_raw = tx.get(self.local_timestamp, _TIMESTAMP_KEY)
            old_ts = (int.from_bytes(old_ts_raw, "big")
                      if old_ts_raw else 0)
            ent = old if old is not None else K2VItem(bucket_id, pk, sk)
            new_ts = ent.update(self.system.id, ct, value,
                                max(old_ts, now_msec()))
            tx.insert(self.local_timestamp, _TIMESTAMP_KEY,
                      new_ts.to_bytes(8, "big"))
            return ent

        return data.update_entry_with(partition_pk(bucket_id, pk),
                                      sk.encode(), apply)

    # ---- server side ---------------------------------------------------

    async def _handle(self, from_node, payload, stream):
        op = payload["op"]
        if op == "insert":
            # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
            item = self._local_insert(payload["bucket"], payload["pk"],
                                      payload["sk"], payload.get("ct"),
                                      payload.get("value"))
            if item is not None:
                await self.item_table.insert(item)
            return {"ok": True}
        if op == "insert_many":
            def apply_all():
                out = []
                for pk, sk, ct, value in payload["items"]:
                    item = self._local_insert(payload["bucket"], pk, sk,
                                              ct, value)
                    if item is not None:
                        out.append(item)
                return out

            # bulk transactions off the event loop (db.py convention)
            updated = await asyncio.to_thread(apply_all)
            for item in updated:
                await self.item_table.insert(item)
            return {"ok": True}
        if op == "poll_item":
            item = await self._handle_poll(
                payload["bucket"], payload["pk"], payload["sk"],
                payload["ct"], payload["timeout_ms"] / 1000.0)
            from ...utils import migrate

            return {"item": migrate.encode(item) if item else None}
        if op == "poll_range":
            res = await self._handle_poll_range(
                payload["bucket"], payload["pk"], payload.get("prefix"),
                payload.get("start"), payload.get("end"),
                payload.get("seen", ""), payload["timeout_ms"] / 1000.0)
            if res is None:
                return {"items": None, "seen": None}
            from ...utils import migrate

            items, seen = res
            return {"items": [migrate.encode(i) for i in items],
                    "seen": seen}
        raise ValueError(f"unknown k2v op {op!r}")

    async def _handle_poll(self, bucket_id: bytes, pk: str, sk: str,
                           ct_str: str, timeout: float
                           ) -> Optional[K2VItem]:
        ct = CausalContext.parse(ct_str)
        if ct is None:
            raise ValueError("bad causality token")
        deadline = time.monotonic() + timeout
        while True:
            ev = self.subscriptions.subscribe(bucket_id, pk, sk)
            try:
                # lint: ignore[GL10] measured: this single-row page-cached db op costs less than the to_thread handoff it would ride; scans and multi-row transactions do hop
                item = self._read_local(bucket_id, pk, sk)
                if item is not None and item.causal_context(
                        ).is_newer_than(ct):
                    return item
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                try:
                    await asyncio.wait_for(ev.wait(), remaining)
                except asyncio.TimeoutError:
                    return None
            finally:
                self.subscriptions.unsubscribe(bucket_id, pk, sk, ev)

    def _read_local(self, bucket_id: bytes, pk: str,
                    sk: str) -> Optional[K2VItem]:
        raw = self.item_table.data.read_entry(
            partition_pk(bucket_id, pk), sk.encode())
        return (self.item_table.data.decode_stored(raw)
                if raw is not None else None)
