"""Copy of garage_tpu/rpc/layout/manager.py: import paths rewritten, issue and PR tags dropped.

LayoutManager: persistence, gossip merge, broadcast, pull sync.

Ref parity: src/rpc/layout/manager.rs:21-381. Owns the LayoutHistory
CRDT: merges advertisements from peers (re-broadcasting on change),
serves pulls, persists every change, and exposes the LayoutHelper to
the table/block layers.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Optional

from ...utils.background import spawn
from ...utils.migrate import decode as migrate_decode, encode as migrate_encode
from ...utils.persister import Persister
from ..replication_mode import ReplicationMode
from .helper import LayoutHelper
from .history import LayoutHistory

log = logging.getLogger("garage_tpu_torch.rpc.layout")


class LayoutManager:
    def __init__(
        self,
        netapp,
        meta_dir: str,
        replication: ReplicationMode,
    ):
        self.netapp = netapp
        self.replication = replication
        self.persister: Persister = Persister(meta_dir, "cluster_layout", LayoutHistory)
        history = self.persister.load()
        if history is None:
            history = LayoutHistory.new(replication.factor)
        elif history.replication_factor != replication.factor:
            raise RuntimeError(
                f"persisted layout has replication_factor "
                f"{history.replication_factor}, config says {replication.factor}"
            )
        self.helper = LayoutHelper(history, netapp.id)
        self.ep = netapp.endpoint("garage_rpc/layout").set_handler(self._handle)
        self.on_change: list[Callable[[], None]] = []  # table syncers hook in
        # layout-versioned data layers (each table's syncer, the block
        # store) register here; the node's sync tracker advances to the
        # MINIMUM across sources — see register_sync_source
        self._sync_done: dict[str, int] = {}
        # broadcast debounce: during a transition every tracker tick
        # fires _changed, and an immediate full-history broadcast to
        # every peer per tick is an O(N^2) gossip storm on big
        # clusters — coalesce to at most one broadcast per interval
        self._bcast_interval = 0.1  # `[rpc] layout_debounce_ms` / 1000
        self._bcast_last = 0.0
        self._bcast_scheduled = False

    def set_broadcast_debounce(self, seconds: float) -> None:
        """Operator knob `[rpc] layout_debounce_ms` (Garage wires it at
        startup): the minimum spacing between full-history gossip
        waves. Raise on big clusters, lower for test convergence."""
        self._bcast_interval = max(0.0, seconds)

    @property
    def history(self) -> LayoutHistory:
        return self.helper.history

    def digest(self) -> bytes:
        return self.history.digest()

    # ---- local updates -------------------------------------------------

    def save(self) -> None:
        self.persister.save(self.history)

    def _changed(self) -> None:
        self.save()
        for cb in self.on_change:
            try:
                cb()
            except Exception:
                log.exception("layout on_change callback failed")
        spawn(self._broadcast_soon(), "layout-broadcast")

    async def _broadcast_soon(self) -> None:
        """Coalescing broadcast: back-to-back tracker changes ride one
        gossip wave instead of one full-history fan-out each."""
        if self._bcast_scheduled:
            return  # an in-flight wave will carry this change too
        self._bcast_scheduled = True
        try:
            wait = self._bcast_last + self._bcast_interval \
                - time.monotonic()
            if wait > 0:
                await asyncio.sleep(wait)
            # lint: ignore[GL12] _bcast_scheduled (checked on entry) admits at most one wave; the sleeping wave is the only writer of _bcast_last
            self._bcast_last = time.monotonic()
        finally:
            self._bcast_scheduled = False
        await self.broadcast()

    def merge_remote(self, raw: bytes) -> bool:
        remote = migrate_decode(LayoutHistory, raw)
        changed = self.history.merge(remote)
        # seeing a newer version may allow our own trackers to move
        self.helper.advance_ack()
        self.helper.advance_sync_ack()
        if changed:
            self._changed()
        return changed

    def apply_staged(self, version: Optional[int] = None) -> None:
        self.history.apply_staged_changes(version)
        self.helper.advance_ack()
        self._changed()

    async def apply_staged_async(self, version: Optional[int] = None) -> None:
        """apply_staged with the assignment computed in a worker
        thread: the max-flow + movement-minimization step is pure-CPU
        and can take SECONDS on an unlucky graph — a cluster resize
        must never freeze the event loop that is serving traffic (the
        whole point of a zero-downtime transition)."""
        staged = self.history.staging
        lv = await asyncio.to_thread(self.history.compute_staged_changes,
                                     version, staged)
        # install on the loop: a concurrent layout VERSION change while
        # the compute ran is rejected by install_version, and staging
        # mutated mid-compute is preserved (not cleared) for the next
        # apply
        self.history.install_version(lv, consumed=staged)
        if len(self.history.staging.roles):
            log.warning("layout roles were staged while the v%d "
                        "assignment computed; they remain staged — "
                        "run apply again to activate them", lv.version)
        self.helper.advance_ack()
        self._changed()

    def revert_staged(self) -> None:
        self.history.revert_staged_changes()
        self._changed()

    def register_sync_source(self, name: str) -> None:
        """A layer holding layout-versioned data (one per table syncer,
        one for the block store) registers here. The node's gossiped
        sync tracker then advances to the MINIMUM completed version
        across all sources — before this, any single table finishing
        its round advanced the tracker for the whole node, and the
        cluster could GC a layout version whose other layers were
        still migrating off it."""
        self._sync_done.setdefault(name, 0)

    def sync_until_from(self, name: str, version: int) -> None:
        """Source `name` has all its data for layout `version` in
        place locally; advance the node tracker as far as the slowest
        registered source allows."""
        if version > self._sync_done.get(name, 0):
            self._sync_done[name] = version
        self._report_sync(min(self._sync_done.values()))

    def sources_synced_through(self, version: int,
                               exclude: str = "") -> bool:
        """Whether every registered sync source other than `exclude`
        has reported `version` (vacuously true with none registered).
        The block layer gates its own report on this (resync.py
        maybe_report_synced): a block_ref row that lands AFTER blocks
        reported — but before its table's round finished — would
        otherwise be unprotected by the tracker, so blocks reporting
        before the tables is exactly the premature-report hazard."""
        return all(v >= version for name, v in self._sync_done.items()
                   if name != exclude)

    def sync_table_until(self, version: int) -> None:
        """Un-sourced report — single-layer deployments and tests that
        drive the tracker directly (ref: manager.rs:120-133)."""
        self._report_sync(version)

    def _report_sync(self, version: int) -> None:
        if self.helper.sync_until(version):
            self.helper.advance_sync_ack()
            if self.history.cleanup_old_versions():
                pass
            self._changed()

    # ---- gossip --------------------------------------------------------

    async def broadcast(self) -> None:
        raw = migrate_encode(self.history)
        peers = [p for p in self.netapp.conns.keys()]
        await asyncio.gather(
            *(self._advertise_one(p, raw) for p in peers), return_exceptions=True
        )

    async def _advertise_one(self, node: bytes, raw: bytes) -> None:
        try:
            await self.ep.call(node, {"op": "advertise", "layout": raw}, 0x20, timeout=10.0)
        except Exception as e:
            log.debug("layout advertise to %s failed: %s", node[:4].hex(), e)

    async def pull_from(self, node: bytes) -> bool:
        try:
            resp, _ = await self.ep.call(node, {"op": "pull"}, 0x20, timeout=10.0)
            if resp and resp.get("layout"):
                return self.merge_remote(resp["layout"])
        except Exception as e:
            log.debug("layout pull from %s failed: %s", node[:4].hex(), e)
        return False

    async def _handle(self, from_node, payload, stream):
        op = payload.get("op")
        if op == "pull":
            return {"layout": migrate_encode(self.history)}
        if op == "advertise":
            changed = self.merge_remote(payload["layout"])
            return {"changed": changed}
        raise ValueError(f"unknown layout op {op}")
