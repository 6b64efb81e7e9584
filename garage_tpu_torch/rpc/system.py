"""Copy of garage_tpu/rpc/system.py: import paths rewritten, issue and PR tags dropped.

System: membership, node status gossip, cluster health.

Ref parity: src/rpc/system.rs:87-965. Owns the node identity key, the
peering manager, the layout manager, the persisted peer list, the
status-exchange loop (every 10 s), and ClusterHealth computation from
per-partition quorum counts.
"""

from __future__ import annotations

import asyncio
import logging
import os
import platform
import shutil
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from ..net import NetApp, PeeringManager
from ..net.message import PRIO_HIGH
from ..net.netapp import gen_node_key, node_key_from_bytes, node_key_to_bytes
from ..net.peering import PeerConnState
from ..utils.background import spawn
from ..utils.migrate import Migratable
from ..utils.persister import Persister
from .layout.manager import LayoutManager
from .layout.version import N_PARTITIONS
from .replication_mode import ConsistencyMode, ReplicationMode

log = logging.getLogger("garage_tpu_torch.rpc.system")

STATUS_EXCHANGE_INTERVAL = 10.0
DISCOVERY_INTERVAL = 60.0


class ClusterHealthStatus(Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    UNAVAILABLE = "unavailable"


@dataclass
class ClusterHealth:
    """ref: src/rpc/system.rs:150-179"""

    status: ClusterHealthStatus
    known_nodes: int
    connected_nodes: int
    storage_nodes: int
    storage_nodes_up: int
    partitions: int
    partitions_quorum: int
    partitions_all_ok: int


@dataclass
class NodeStatus:
    hostname: str = ""
    replication_factor: int = 0
    layout_digest: bytes = b""
    meta_disk_avail: Optional[tuple[int, int]] = None  # (avail, total)
    data_disk_avail: Optional[tuple[int, int]] = None

    def pack(self):
        return {
            "hostname": self.hostname,
            "rf": self.replication_factor,
            "layout": self.layout_digest,
            "meta_disk": self.meta_disk_avail,
            "data_disk": self.data_disk_avail,
        }

    @classmethod
    def unpack(cls, o):
        return cls(
            o.get("hostname", ""),
            o.get("rf", 0),
            bytes(o.get("layout", b"")),
            tuple(o["meta_disk"]) if o.get("meta_disk") else None,
            tuple(o["data_disk"]) if o.get("data_disk") else None,
        )


@dataclass
class KnownNode:
    id: bytes
    addr: Optional[tuple]
    is_up: bool
    last_seen_secs_ago: Optional[float]
    status: Optional[NodeStatus]


class PeerList(Migratable):
    """Persisted peer addresses for rediscovery after restart."""

    VERSION_MARKER = b"GTpeers1"

    def __init__(self, peers: Optional[list] = None):
        self.peers = peers or []  # [(node_id, addr_tuple)]

    def pack(self):
        return [[n, list(a)] for n, a in self.peers]

    @classmethod
    def unpack(cls, raw):
        return cls([(bytes(n), tuple(a)) for n, a in raw])


def load_or_gen_node_key(meta_dir: str):
    """ref: src/rpc/system.rs:181-238 (key in metadata dir)."""
    os.makedirs(meta_dir, exist_ok=True)
    path = os.path.join(meta_dir, "node_key")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return node_key_from_bytes(f.read())
    key = gen_node_key()
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(node_key_to_bytes(key))
    return key


class System:
    """Membership manager + composition point for the rpc layer."""

    def __init__(
        self,
        netapp: NetApp,
        replication: ReplicationMode,
        meta_dir: str,
        data_dirs: Optional[list[str]] = None,
        bootstrap_peers: Optional[list] = None,
        status_interval: float = STATUS_EXCHANGE_INTERVAL,
        ping_interval: Optional[float] = None,
        discovery: Optional[list] = None,
        discovery_interval: float = 60.0,
    ):
        self.netapp = netapp
        self.replication = replication
        self.meta_dir = meta_dir
        self.data_dirs = data_dirs or []
        self.id = netapp.id
        self.status_interval = status_interval

        os.makedirs(meta_dir, exist_ok=True)
        self.peer_list_persister = Persister(meta_dir, "peer_list", PeerList)
        self._last_persisted_peers: Optional[list] = None
        persisted = self.peer_list_persister.load()
        bootstrap = list(bootstrap_peers or [])
        if persisted is not None:
            bootstrap += [(addr, nid) for nid, addr in persisted.peers]
        kwargs = {}
        if ping_interval is not None:
            kwargs = {"ping_interval": ping_interval, "retry_interval": ping_interval}
        self.peering = PeeringManager(netapp, bootstrap, **kwargs)

        self.discovery = list(discovery or [])
        self.discovery_interval = discovery_interval

        self.layout_manager = LayoutManager(netapp, meta_dir, replication)
        self.node_status: dict[bytes, tuple[float, NodeStatus]] = {}

        # per-zone health rollup (garage_tpu/zones/): stateless
        # derivation over peering + layout, serves GET /v1/zones and
        # the zone-aware quorum strategy's partitioned-zone checks
        from ..zones import ZoneHealth

        self.zone_health = ZoneHealth(self)

        self.ep = netapp.endpoint("garage_rpc/system").set_handler(self._handle)
        netapp.on_connected.append(self._on_peer_connected)
        self._stop = asyncio.Event()
        self._tasks: list[asyncio.Task] = []

    @property
    def layout_helper(self):
        return self.layout_manager.helper

    # ---- lifecycle -----------------------------------------------------

    async def run(self) -> None:
        if self.netapp.bind_addr is not None and self.netapp.local_net is None:
            await self.netapp.listen()
        self._tasks = [
            asyncio.create_task(self.peering.run()),
            asyncio.create_task(self._status_exchange_loop()),
        ]
        if self.discovery:
            self._tasks.append(
                asyncio.create_task(self._discovery_loop()))
        for t in self._tasks:
            # supervised service loops (cancelled right below on stop):
            # not leaks for the runtime sanitizer's teardown check
            t._garage_background = True
        await self._stop.wait()
        await self.peering.stop()
        for t in self._tasks:
            t.cancel()
        await self.netapp.shutdown()

    async def stop(self) -> None:
        self._stop.set()

    # ---- status gossip -------------------------------------------------

    def local_status(self) -> NodeStatus:
        def disk(path_list):
            tot = avail = 0
            for p in path_list:
                try:
                    u = shutil.disk_usage(p)
                    tot += u.total
                    avail += u.free
                except OSError:
                    pass
            return (avail, tot) if tot else None

        return NodeStatus(
            hostname=platform.node(),
            replication_factor=self.replication.factor,
            layout_digest=self.layout_manager.digest(),
            meta_disk_avail=disk([self.meta_dir]),
            data_disk_avail=disk(self.data_dirs),
        )

    async def _discovery_loop(self) -> None:
        """Publish ourself and pull peers from external providers
        (Consul catalog / Kubernetes CRDs; ref: rpc/system.rs:627
        discovery_loop). Providers are advisory: failures log and the
        loop keeps going on bootstrap + gossip."""
        while True:
            addr = self.netapp.public_addr
            for prov in self.discovery:
                name = type(prov).__name__
                try:
                    if addr is not None:
                        await prov.register(self.id, addr)
                    for peer_addr, nid in await prov.get_peers():
                        if nid == self.id or (nid is None
                                              and peer_addr == addr):
                            continue
                        self.peering.add_peer(tuple(peer_addr), nid)
                except Exception as e:
                    log.info("discovery via %s failed: %s", name, e)
            await asyncio.sleep(self.discovery_interval)

    async def _status_exchange_loop(self) -> None:
        while True:
            try:
                await self._advertise_status()
            except Exception:
                log.exception("status exchange failed")
            await asyncio.sleep(self.status_interval)

    async def _advertise_status(self) -> None:
        status = self.local_status().pack()
        peers = list(self.netapp.conns.keys())

        async def one(p):
            try:
                resp, _ = await self.ep.call(
                    p, {"op": "status", "status": status}, PRIO_HIGH, timeout=10.0
                )
                if resp.get("layout") is not None:
                    self.layout_manager.merge_remote(resp["layout"])
            except Exception as e:
                log.debug("status exchange with %s failed: %s", p[:4].hex(), e)

        await asyncio.gather(*(one(p) for p in peers))
        self._persist_peer_list()

    def _persist_peer_list(self) -> None:
        peers = sorted(
            (p.id, p.addr)
            for p in self.peering.peers.values()
            if p.id != self.id and p.addr is not None
        )
        # skip the write+fsync+rename when membership hasn't changed (this
        # runs on the 10 s status-exchange loop)
        if peers == self._last_persisted_peers:
            return
        self.peer_list_persister.save(PeerList(peers))
        self._last_persisted_peers = peers

    def _on_peer_connected(self, peer_id: bytes, incoming: bool) -> None:
        # push our layout to newly connected peers so they converge fast
        async def push():
            try:
                await self.layout_manager.pull_from(peer_id)
                raw = None
                from ..utils.migrate import encode as menc

                raw = menc(self.layout_manager.history)
                await self.layout_manager._advertise_one(peer_id, raw)
            except Exception as e:
                log.debug("layout push to %s failed: %s",
                          peer_id[:4].hex(), e)

        spawn(push(), "layout-push-on-connect")

    # ---- rpc handler ---------------------------------------------------

    async def _handle(self, from_node, payload, stream):
        op = payload.get("op")
        if op == "status":
            st = NodeStatus.unpack(payload["status"])
            self.node_status[from_node] = (time.monotonic(), st)
            reply = {}
            if st.layout_digest != self.layout_manager.digest():
                from ..utils.migrate import encode as menc

                reply["layout"] = menc(self.layout_manager.history)
            return reply
        if op == "get_known_nodes":
            return {
                "nodes": [
                    [n.id, list(n.addr) if n.addr else None, n.is_up]
                    for n in self.get_known_nodes()
                ]
            }
        if op == "connect":
            addr = tuple(payload["addr"])
            pid = payload.get("id")
            await self.netapp.try_connect(addr, bytes(pid) if pid else None)
            return {}
        raise ValueError(f"unknown system op {op}")

    # ---- queries -------------------------------------------------------

    def is_up(self, node: bytes) -> bool:
        if node == self.id:
            return True
        p = self.peering.peers.get(node)
        return p is not None and p.state == PeerConnState.CONNECTED

    def get_known_nodes(self) -> list[KnownNode]:
        out = []
        for p in self.peering.get_peer_list():
            status = self.node_status.get(p.id)
            out.append(
                KnownNode(
                    id=p.id,
                    addr=p.addr,
                    is_up=(p.id == self.id) or p.state == PeerConnState.CONNECTED,
                    last_seen_secs_ago=(
                        time.monotonic() - p.last_seen if p.last_seen else None
                    ),
                    status=status[1] if status else None,
                )
            )
        return out

    def health(self) -> ClusterHealth:
        """ref: src/rpc/system.rs:430-510."""
        history = self.layout_manager.history
        storage_nodes = history.all_storage_nodes()
        storage_up = {n for n in storage_nodes if self.is_up(n)}

        rq = self.replication.read_quorum
        wq = self.replication.write_quorum
        quorum_ok = 0
        all_ok = 0
        for p in range(N_PARTITIONS):
            sets = [v.nodes_of(p) for v in history.versions]
            sets = [s for s in sets if s]
            if not sets:
                continue
            ups = [sum(1 for n in s if self.is_up(n)) for s in sets]
            if all(u >= wq for u in ups) and any(u >= rq for u in ups):
                quorum_ok += 1
            if all(u == len(s) for u, s in zip(ups, sets)):
                all_ok += 1

        peers = self.peering.get_peer_list()
        connected = sum(
            1 for p in peers if p.state in (PeerConnState.CONNECTED, PeerConnState.OURSELF)
        )
        if not history.current().ring_assignment_data:
            status = ClusterHealthStatus.UNAVAILABLE
        elif quorum_ok == N_PARTITIONS:
            status = (
                ClusterHealthStatus.HEALTHY
                if all_ok == N_PARTITIONS and len(storage_up) == len(storage_nodes)
                else ClusterHealthStatus.DEGRADED
            )
        else:
            status = ClusterHealthStatus.UNAVAILABLE
        return ClusterHealth(
            status=status,
            known_nodes=len(peers),
            connected_nodes=connected,
            storage_nodes=len(storage_nodes),
            storage_nodes_up=len(storage_up),
            partitions=N_PARTITIONS,
            partitions_quorum=quorum_ok,
            partitions_all_ok=all_ok,
        )
