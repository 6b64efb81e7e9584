"""Copy of garage_tpu/rpc/layout/helper.py: import paths rewritten, issue and PR tags dropped.

LayoutHelper: version-aware read/write target selection + ack lock.

Ref parity: src/rpc/layout/helper.rs:30-49 and manager.rs:338-381. The
subtle core of layout transitions:

- writes go to the write sets of EVERY version >= ack_map_min, so no
  window exists where old and new quorums disagree;
- reads go to the newest version all storage nodes have synced, so a
  read quorum always intersects the write quorums that stored the data;
- a node only advances its ack tracker once its in-flight writes pinned
  to older versions drain (the ack lock), so the cluster never abandons
  a write set that still has writes in flight.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from .history import LayoutHistory, UpdateTrackers
from .version import LayoutVersion, partition_of


class LayoutHelper:
    def __init__(self, history: LayoutHistory, node_id: bytes):
        self.history = history
        self.node_id = node_id
        self._ack_inflight: dict[int, int] = {}  # layout version -> writes

    # ---- tracker mins --------------------------------------------------

    def _storage_nodes(self) -> set[bytes]:
        return self.history.all_storage_nodes()

    def ack_map_min(self) -> int:
        return UpdateTrackers.min_among(
            self.history.update_trackers.ack,
            self._storage_nodes(),
            self.history.min_stored(),
        )

    def sync_map_min(self) -> int:
        return UpdateTrackers.min_among(
            self.history.update_trackers.sync,
            self._storage_nodes(),
            self.history.min_stored(),
        )

    # ---- read/write target selection ----------------------------------

    def current(self) -> LayoutVersion:
        return self.history.current()

    def versions_for_writes(self) -> list[LayoutVersion]:
        amin = self.ack_map_min()
        return [v for v in self.history.versions if v.version >= amin]

    def read_version(self) -> LayoutVersion:
        """Newest version whose data migration is complete everywhere."""
        smin = self.sync_map_min()
        best = self.history.versions[0]
        for v in self.history.versions:
            if v.version <= smin:
                best = v
        return best

    def write_sets_of(self, hash32: bytes) -> list[list[bytes]]:
        """One write set per live version (ref: helper.rs write_sets_of)."""
        sets = []
        for v in self.versions_for_writes():
            s = v.nodes_of_hash(hash32)
            if s and s not in sets:
                sets.append(s)
        return sets

    def read_nodes_of(self, hash32: bytes) -> list[bytes]:
        return self.read_version().nodes_of_hash(hash32)

    def current_storage_nodes_of(self, hash32: bytes) -> list[bytes]:
        return self.current().nodes_of_hash(hash32)

    def storage_sets_of(self, partition: int) -> list[list[bytes]]:
        sets = []
        for v in self.versions_for_writes():
            s = v.nodes_of(partition)
            if s and s not in sets:
                sets.append(s)
        return sets

    def block_read_nodes_of(self, hash32: bytes) -> list[bytes]:
        """All candidate holders, newest layout first, then old versions
        (ref: rpc_helper.rs:570-619)."""
        out: list[bytes] = []
        p = partition_of(hash32)
        for v in reversed(self.history.versions + self.history.old_versions):
            for n in v.nodes_of(p):
                if n not in out:
                    out.append(n)
        return out

    # ---- ack lock ------------------------------------------------------

    @contextlib.contextmanager
    def write_lock(self):
        """Pin the current version set for the duration of a write; on
        release, advance our ack tracker as far as in-flight writes
        allow (ref: manager.rs:344-381)."""
        v = self.current().version
        self._ack_inflight[v] = self._ack_inflight.get(v, 0) + 1
        try:
            yield self.versions_for_writes()
        finally:
            self._ack_inflight[v] -= 1
            if self._ack_inflight[v] == 0:
                del self._ack_inflight[v]
            self.advance_ack()

    def advance_ack(self) -> bool:
        """ack[self] := oldest version still carrying in-flight writes,
        or the current version if none."""
        target = min(self._ack_inflight, default=self.current().version)
        return self.history.update_trackers.set_max("ack", self.node_id, target)

    # ---- sync trackers (driven by table/block syncers) -----------------

    def sync_until(self, version: int) -> bool:
        return self.history.update_trackers.set_max("sync", self.node_id, version)

    def advance_sync_ack(self) -> bool:
        return self.history.update_trackers.set_max(
            "sync_ack", self.node_id, self.sync_map_min()
        )
