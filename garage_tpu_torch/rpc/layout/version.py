"""Copy of garage_tpu/rpc/layout/version.py: import paths rewritten, issue and PR tags dropped.

One version of the cluster layout: roles + ring assignment.

Ref parity: src/rpc/layout/mod.rs:37-94,240-287 and version.rs:101-130.
256 partitions = top 8 bits of the blake2 item hash; the ring is a flat
array of node indices, replication_factor entries per partition.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ...utils import crdt
from ...utils.migrate import Migratable

PARTITION_BITS = 8
N_PARTITIONS = 1 << PARTITION_BITS


def partition_of(hash32: bytes) -> int:
    """Top 8 bits of the item/block hash (ref: layout/version.rs:101)."""
    return hash32[0]


@dataclass
class NodeRole:
    """Operator-assigned role of a node (ref: layout/mod.rs:84-94).
    capacity None = gateway node: serves APIs, stores nothing."""

    zone: str = ""
    capacity: Optional[int] = None
    tags: list = field(default_factory=list)

    def pack(self):
        return [self.zone, self.capacity, list(self.tags)]

    @classmethod
    def unpack(cls, raw):
        return cls(raw[0], raw[1], list(raw[2]))


def pack_roles(roles: crdt.LwwMap) -> list:
    """LwwMap[node_id -> NodeRole|None] to plain structure."""
    return [
        [k, lww.ts, None if lww.value is None else lww.value.pack()]
        for k, lww in roles.items_lww()
    ]


def unpack_roles(raw: list) -> crdt.LwwMap:
    return crdt.LwwMap(
        {
            bytes(k): crdt.Lww(ts, None if v is None else NodeRole.unpack(v))
            for k, ts, v in raw
        }
    )


class LayoutVersion(Migratable):
    """Immutable once created; new versions come from apply_staged."""

    VERSION_MARKER = b"GTlayv01"

    def __init__(
        self,
        version: int,
        replication_factor: int,
        zone_redundancy,  # int or "maximum"
        roles: crdt.LwwMap,
        node_id_vec: list[bytes],
        ring_assignment_data: bytes,
        partition_size: int,
    ):
        self.version = version
        self.replication_factor = replication_factor
        self.zone_redundancy = zone_redundancy
        self.roles = roles  # node_id -> Lww[NodeRole|None] (None = removed)
        self.node_id_vec = node_id_vec
        self.ring_assignment_data = ring_assignment_data
        self.partition_size = partition_size

    # ---- queries -------------------------------------------------------

    def nodes_of(self, partition: int) -> list[bytes]:
        """Storage nodes of a partition, in ring order
        (ref: layout/version.rs:117)."""
        rf = self.replication_factor
        if len(self.ring_assignment_data) != N_PARTITIONS * rf:
            return []
        base = partition * rf
        return [
            self.node_id_vec[self.ring_assignment_data[base + i]] for i in range(rf)
        ]

    def nodes_of_hash(self, hash32: bytes) -> list[bytes]:
        return self.nodes_of(partition_of(hash32))

    def storage_nodes(self) -> set[bytes]:
        """Nodes with a storage role (capacity set) in this version."""
        return {
            n
            for n, r in self.roles.items()
            if r is not None and r.capacity is not None
        }

    def all_nodes(self) -> set[bytes]:
        """Every node with a role (incl. gateways)."""
        return {n for n, r in self.roles.items() if r is not None}

    def node_role(self, node: bytes) -> Optional[NodeRole]:
        return self.roles.get(node)

    # ---- serialization -------------------------------------------------

    def pack(self):
        return {
            "version": self.version,
            "rf": self.replication_factor,
            "zr": self.zone_redundancy,
            "roles": pack_roles(self.roles),
            "nodes": list(self.node_id_vec),
            "ring": self.ring_assignment_data,
            "psize": self.partition_size,
        }

    @classmethod
    def unpack(cls, o):
        return cls(
            o["version"],
            o["rf"],
            o["zr"],
            unpack_roles(o["roles"]),
            [bytes(n) for n in o["nodes"]],
            bytes(o["ring"]),
            o["psize"],
        )
