"""Copy of garage_tpu/zones/health.py: import paths rewritten, issue and PR tags dropped.

Per-zone health derived from peering state.

Dynamo-style zone awareness (DeCandia et al., SOSP'07) starts with
knowing which failure domains are reachable. Every node already tracks
per-peer liveness three ways — the connection state machine
(net/peering.py `_Peer.state`), the consecutive-failed-ping counter,
and the circuit breakers in `PeerHealthTracker` — so zone health is a
pure derivation over data the system gossips anyway; no new protocol.

A node counts as DOWN when any of the three signals says so: it is not
connected, its breaker is open, or it has missed two consecutive pings
(half the disconnect threshold — pings fail well before the peering
layer tears the link down, and a severed link can flap through
reconnect-then-die cycles where the conn state alone looks healthy).

Zone state rolls up its member nodes:

- UP           every member node is up
- DEGRADED     some but not all member nodes are down
- PARTITIONED  every member node is down (the whole failure domain is
               unreachable — from THIS observer's side of the cut)

The local node is always up from its own point of view, so the local
zone can never report PARTITIONED — matching the drill's expectation
that each surviving node sees the severed zone partitioned while the
severed zone's own nodes see everyone ELSE that way.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, Optional

# A node is suspected down after this many consecutive failed pings —
# half of peering's FAILED_PING_THRESHOLD (4), because zone state must
# move before the peering layer gives up on the link entirely.
SUSPECT_FAILED_PINGS = 2


class ZoneState(Enum):
    UP = "up"
    DEGRADED = "degraded"
    PARTITIONED = "partitioned"


def layout_zone_resolver(layout_manager) -> Callable[[bytes], Optional[str]]:
    """node_id -> zone name per the CURRENT layout version (None when
    the node has no storage role there). The chaos injector's
    `partition_zone` fault and the cache tier's per-zone ring both key
    off this — one shared definition of "which zone is node X in"."""

    def resolve(node: bytes) -> Optional[str]:
        role = layout_manager.history.current().node_role(node)
        if role is None or not role.zone:
            return None
        return role.zone

    return resolve


class ZoneHealth:
    """Zone-state tracker hung off `System` (rpc/system.py).

    Stateless by design: every read derives from the live layout +
    peering structures, so there is no refresh loop to schedule and no
    staleness beyond the peering ping interval itself — `GET /v1/zones`
    reflects a zone partition as soon as the pings that detect it fail.
    """

    def __init__(self, system):
        self.system = system

    # ---- membership -----------------------------------------------------

    def zone_of(self, node: bytes) -> Optional[str]:
        role = self.system.layout_manager.history.current().node_role(node)
        if role is None or not role.zone:
            return None
        return role.zone

    def local_zone(self) -> Optional[str]:
        return self.zone_of(self.system.id)

    def zone_nodes(self) -> dict[str, list[bytes]]:
        """zone -> storage nodes of the current layout version, sorted
        for stable output."""
        layout = self.system.layout_manager.history.current()
        zones: dict[str, list[bytes]] = {}
        for node in layout.storage_nodes():
            role = layout.node_role(node)
            if role is None or not role.zone:
                continue
            zones.setdefault(role.zone, []).append(node)
        for members in zones.values():
            members.sort()
        return zones

    # ---- liveness -------------------------------------------------------

    def node_down(self, node: bytes) -> bool:
        system = self.system
        if node == system.id:
            return False
        if not system.is_up(node):
            return True
        peering = system.peering
        peer = peering.peers.get(node)
        if peer is not None and peer.failed_pings >= SUSPECT_FAILED_PINGS:
            return True
        return peering.health.breaker_state(node) == "open"

    # ---- rollup ---------------------------------------------------------

    def zone_state(self, zone: str) -> Optional[ZoneState]:
        members = self.zone_nodes().get(zone)
        if not members:
            return None
        down = sum(1 for n in members if self.node_down(n))
        if down == 0:
            return ZoneState.UP
        if down == len(members):
            return ZoneState.PARTITIONED
        return ZoneState.DEGRADED

    def partitioned_zones(self) -> set[str]:
        return {z for z, st in self._states().items()
                if st == ZoneState.PARTITIONED}

    def _states(self) -> dict[str, ZoneState]:
        out = {}
        for zone, members in self.zone_nodes().items():
            down = sum(1 for n in members if self.node_down(n))
            if down == 0:
                out[zone] = ZoneState.UP
            elif down == len(members):
                out[zone] = ZoneState.PARTITIONED
            else:
                out[zone] = ZoneState.DEGRADED
        return out

    def snapshot(self) -> dict:
        """The `GET /v1/zones` body: per-zone state + member liveness,
        plus which zone the reporting node sits in (zone state is
        observer-relative by nature — a severed zone sees the rest of
        the world partitioned, not itself)."""
        zones = []
        for zone, members in sorted(self.zone_nodes().items()):
            down = [n for n in members if self.node_down(n)]
            if not down:
                state = ZoneState.UP
            elif len(down) == len(members):
                state = ZoneState.PARTITIONED
            else:
                state = ZoneState.DEGRADED
            zones.append({
                "zone": zone,
                "state": state.value,
                "nodes": len(members),
                "nodesUp": len(members) - len(down),
                "downNodes": [n.hex() for n in down],
            })
        return {"localZone": self.local_zone(), "zones": zones}
