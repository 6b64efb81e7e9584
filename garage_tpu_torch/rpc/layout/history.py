"""Copy of garage_tpu/rpc/layout/history.py: import paths rewritten, issue and PR tags dropped.

Layout history: live versions, update trackers, staged changes.

Ref parity: src/rpc/layout/history.rs + mod.rs:235-478. During a
rebalance several LayoutVersions are live at once: writes go to ALL
their write sets, reads prefer the newest. Three gossiped CRDT trackers
(per-node monotonic version counters) drive convergence:

  ack_map      — node acks version v: it directs writes to v's sets
  sync_map     — node has fully synced/offloaded its data for v
  sync_ack_map — node has seen that sync quorum was reached for v

Versions older than min(sync_ack) are garbage collected (kept in
old_versions, <= 5, for block lookups during long resyncs —
ref: mod.rs:235).
"""

from __future__ import annotations

from typing import Optional

from ...utils import crdt
from ...utils.data import blake2sum
from ...utils.migrate import Migratable, encode as migrate_encode
from .assign import compute_assignment
from .version import (
    LayoutVersion,
    NodeRole,
    pack_roles,
    unpack_roles,
)

OLD_VERSION_COUNT = 5


class UpdateTrackers:
    """Three per-node monotonic version maps; merge = pointwise max."""

    def __init__(self, ack=None, sync=None, sync_ack=None):
        self.ack: dict[bytes, int] = dict(ack or {})
        self.sync: dict[bytes, int] = dict(sync or {})
        self.sync_ack: dict[bytes, int] = dict(sync_ack or {})

    @staticmethod
    def _merge_map(a: dict, b: dict) -> dict:
        out = dict(a)
        for k, v in b.items():
            out[k] = max(out.get(k, 0), v)
        return out

    def merge(self, other: "UpdateTrackers") -> "UpdateTrackers":
        return UpdateTrackers(
            self._merge_map(self.ack, other.ack),
            self._merge_map(self.sync, other.sync),
            self._merge_map(self.sync_ack, other.sync_ack),
        )

    def set_max(self, which: str, node: bytes, version: int) -> bool:
        m = getattr(self, which)
        if m.get(node, 0) < version:
            m[node] = version
            return True
        return False

    @staticmethod
    def min_among(m: dict, nodes: set[bytes], min_version: int) -> int:
        return min((m.get(n, min_version) for n in nodes), default=min_version)

    def pack(self):
        return [
            sorted(self.ack.items()),
            sorted(self.sync.items()),
            sorted(self.sync_ack.items()),
        ]

    @classmethod
    def unpack(cls, raw):
        return cls(
            {bytes(k): v for k, v in raw[0]},
            {bytes(k): v for k, v in raw[1]},
            {bytes(k): v for k, v in raw[2]},
        )


class LayoutStaging:
    """Staged role changes + parameters, CRDT-merged across operators."""

    def __init__(self, parameters: Optional[crdt.Lww] = None, roles: Optional[crdt.LwwMap] = None):
        # parameters value: {"zone_redundancy": int | "maximum"}
        self.parameters = parameters or crdt.Lww.new({"zone_redundancy": "maximum"})
        self.roles = roles or crdt.LwwMap()

    def merge(self, other: "LayoutStaging") -> "LayoutStaging":
        return LayoutStaging(
            self.parameters.merge(other.parameters),
            self.roles.merge(other.roles),
        )

    def pack(self):
        return [self.parameters.pack(), pack_roles(self.roles)]

    @classmethod
    def unpack(cls, raw):
        return cls(crdt.Lww.unpack(raw[0]), unpack_roles(raw[1]))


class LayoutHistory(Migratable):
    VERSION_MARKER = b"GTlayh01"

    def __init__(
        self,
        replication_factor: int,
        versions: Optional[list[LayoutVersion]] = None,
        old_versions: Optional[list[LayoutVersion]] = None,
        update_trackers: Optional[UpdateTrackers] = None,
        staging: Optional[LayoutStaging] = None,
    ):
        self.replication_factor = replication_factor
        self.versions = versions or []
        self.old_versions = old_versions or []
        self.update_trackers = update_trackers or UpdateTrackers()
        self.staging = staging or LayoutStaging()

    @classmethod
    def new(cls, replication_factor: int) -> "LayoutHistory":
        v0 = LayoutVersion(0, replication_factor, "maximum", crdt.LwwMap(), [], b"", 0)
        return cls(replication_factor, versions=[v0])

    # ---- queries -------------------------------------------------------

    def current(self) -> LayoutVersion:
        return self.versions[-1]

    def min_stored(self) -> int:
        return self.versions[0].version

    def get_version(self, v: int) -> Optional[LayoutVersion]:
        for lv in self.versions:
            if lv.version == v:
                return lv
        for lv in self.old_versions:
            if lv.version == v:
                return lv
        return None

    def all_storage_nodes(self) -> set[bytes]:
        out = set()
        for v in self.versions:
            out |= v.storage_nodes()
        return out

    def all_nongateway_nodes(self) -> set[bytes]:
        return self.all_storage_nodes()

    def digest(self) -> bytes:
        """Digest for gossip comparison. Excludes old_versions: they are
        node-local bookkeeping (never merged), so including them would
        make digests permanently diverge between nodes and re-send the
        full layout on every status exchange."""
        import msgpack

        o = self.pack()
        del o["old"]
        return blake2sum(msgpack.packb(o, use_bin_type=True))

    # ---- staging -------------------------------------------------------

    def stage_role(self, node: bytes, role: Optional[NodeRole]) -> None:
        self.staging = LayoutStaging(
            self.staging.parameters, self.staging.roles.insert(node, role)
        )

    def stage_parameters(self, zone_redundancy) -> None:
        self.staging = LayoutStaging(
            self.staging.parameters.update({"zone_redundancy": zone_redundancy}),
            self.staging.roles,
        )

    def staged_roles(self) -> crdt.LwwMap:
        """Current roles with staged changes applied on top."""
        return self.current().roles.merge(self.staging.roles)

    def compute_staged_changes(self, version: Optional[int] = None,
                               staging: Optional["LayoutStaging"] = None,
                               ) -> LayoutVersion:
        """Compute the next LayoutVersion (max-flow assignment) from
        current roles + staged changes WITHOUT installing it — pure
        CPU work, safe to run in a worker thread so an expensive
        assignment never blocks the serving loop (ref: history.rs:270).
        Off-loop callers MUST pass the `staging` snapshot they pinned:
        reading the live self.staging from the worker thread would tear
        against a concurrent stage call — and install_version's
        `consumed` check only protects the clear, not the compute
        input."""
        if staging is None:
            staging = self.staging
        next_version = self.current().version + 1
        if version is not None and version != next_version:
            raise ValueError(
                f"expected version {next_version}, operator said {version} "
                "(layout changed concurrently?)"
            )
        roles = self.current().roles.merge(staging.roles)
        zr = staging.parameters.value.get("zone_redundancy", "maximum")
        node_id_vec, ring, psize = compute_assignment(
            list(roles.items()), self.replication_factor, zr, prev=self.current()
        )
        return LayoutVersion(
            next_version, self.replication_factor, zr, roles,
            node_id_vec, ring, psize,
        )

    def install_version(self, lv: LayoutVersion,
                        consumed: Optional[LayoutStaging] = None) -> None:
        """Append a computed LayoutVersion; refuses a stale compute
        (layout changed while the assignment ran). Staging is cleared
        only when it is still the `consumed` snapshot the compute read
        — a role staged DURING an off-loop compute must survive into
        the next apply, not be silently discarded."""
        if lv.version != self.current().version + 1:
            raise ValueError(
                f"computed layout v{lv.version} is stale: current is "
                f"v{self.current().version} (layout changed concurrently)")
        self.versions.append(lv)
        if consumed is None or consumed is self.staging:
            self.staging = LayoutStaging(
                crdt.Lww.new({"zone_redundancy": lv.zone_redundancy}),
                crdt.LwwMap(),
            )
        # else: staging changed mid-compute — keep it whole (already-
        # applied entries make the next apply a cheap near-no-op; a
        # lost staged role would be unrecoverable)
        self.cleanup_old_versions()

    def apply_staged_changes(self, version: Optional[int] = None) -> None:
        """Synchronous compute + install. ref: history.rs:270."""
        staged = self.staging
        self.install_version(self.compute_staged_changes(version),
                             consumed=staged)

    def revert_staged_changes(self) -> None:
        # drop staged PARAMETERS too: reverting restores the current
        # version's zone_redundancy, not whatever was staged
        zr = self.current().zone_redundancy
        self.staging = LayoutStaging(crdt.Lww.new({"zone_redundancy": zr}), crdt.LwwMap())

    # ---- merge + GC ----------------------------------------------------

    def merge(self, other: "LayoutHistory") -> bool:
        """CRDT merge; returns True if anything changed."""
        changed = False
        known = {v.version for v in self.versions}
        if other.versions:
            # adopt versions newer than ours
            for v in other.versions:
                if v.version not in known and v.version > self.current().version:
                    self.versions.append(v)
                    changed = True
            self.versions.sort(key=lambda v: v.version)
        merged_trackers = self.update_trackers.merge(other.update_trackers)
        if (
            merged_trackers.ack != self.update_trackers.ack
            or merged_trackers.sync != self.update_trackers.sync
            or merged_trackers.sync_ack != self.update_trackers.sync_ack
        ):
            self.update_trackers = merged_trackers
            changed = True
        merged_staging = self.staging.merge(other.staging)
        if (
            merged_staging.parameters != self.staging.parameters
            or merged_staging.roles != self.staging.roles
        ):
            self.staging = merged_staging
            changed = True
        if self.cleanup_old_versions():
            changed = True
        return changed

    def cleanup_old_versions(self) -> bool:
        """Drop versions fully sync-acked by every storage node; leading
        invalid versions (no storage nodes, e.g. the empty bootstrap v0)
        go as soon as a valid one exists (ref: history.rs:79-115)."""
        changed = False
        if self.current().storage_nodes():
            # invalid leading versions (no storage nodes) are discarded
            # outright, not archived — they hold no data anyone reads
            # (ref: history.rs:80-89)
            while len(self.versions) > 1 and not self.versions[0].storage_nodes():
                self.versions.pop(0)
                changed = True
        while len(self.versions) > 1:
            v = self.versions[0].version
            # only the CURRENT version's nodes gate GC: nodes removed by a
            # newer layout are being discarded and must not pin old
            # versions forever (ref: history.rs:94-108 ASSUMPTION)
            nodes = self.current().storage_nodes()
            min_sync_ack = UpdateTrackers.min_among(
                self.update_trackers.sync_ack, nodes, self.min_stored()
            )
            if nodes and min_sync_ack > v:
                self.old_versions.append(self.versions.pop(0))
                changed = True
            else:
                break
        while len(self.old_versions) > OLD_VERSION_COUNT:
            self.old_versions.pop(0)
            changed = True
        return changed

    # ---- serialization -------------------------------------------------

    def pack(self):
        return {
            "rf": self.replication_factor,
            "versions": [v.pack() for v in self.versions],
            "old": [v.pack() for v in self.old_versions],
            "trackers": self.update_trackers.pack(),
            "staging": self.staging.pack(),
        }

    @classmethod
    def unpack(cls, o):
        return cls(
            o["rf"],
            [LayoutVersion.unpack(v) for v in o["versions"]],
            [LayoutVersion.unpack(v) for v in o["old"]],
            UpdateTrackers.unpack(o["trackers"]),
            LayoutStaging.unpack(o["staging"]),
        )
