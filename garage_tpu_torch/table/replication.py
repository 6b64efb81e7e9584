"""Copy of garage_tpu/table/replication.py: import paths rewritten, issue and PR tags dropped.

Replication strategies: which nodes store which partition.

Ref parity: src/table/replication/ (parameters.rs:5-43, sharded.rs:16-83,
fullcopy.rs:21-73). Sharded tables follow the ring (layout write sets +
ack-locked transitions); full-copy tables live on every node (control
plane: buckets, keys) with local reads and n-1 write quorum.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..rpc.layout.version import partition_of

if TYPE_CHECKING:
    from ..rpc.system import System


class TableReplication:
    """ref: table/replication/parameters.rs:5-43."""

    def storage_nodes(self, hash32: bytes) -> list[bytes]:
        raise NotImplementedError

    def read_nodes(self, hash32: bytes) -> list[bytes]:
        raise NotImplementedError

    def read_quorum(self) -> int:
        raise NotImplementedError

    def write_sets(self, hash32: bytes) -> list[list[bytes]]:
        raise NotImplementedError

    def write_quorum(self) -> int:
        raise NotImplementedError

    def partition_of(self, hash32: bytes) -> int:
        return partition_of(hash32)

    def sync_partitions(self) -> list["SyncPartition"]:
        raise NotImplementedError

    # the ack lock context for writes; default: no-op
    def write_lock(self):
        import contextlib

        return contextlib.nullcontext()


class SyncPartition:
    """One unit of anti-entropy work (ref: parameters.rs SyncPartition)."""

    __slots__ = ("partition", "first_hash", "storage_sets")

    def __init__(self, partition: int, first_hash: bytes, storage_sets: list[list[bytes]]):
        self.partition = partition
        self.first_hash = first_hash
        self.storage_sets = storage_sets


def partition_first_hash(partition: int) -> bytes:
    """Smallest 32-byte hash in a ring partition (top 8 bits)."""
    return bytes([partition]) + b"\x00" * 31


class TableShardedReplication(TableReplication):
    """Ring-based sharding with quorum R/W (ref: sharded.rs:16-83)."""

    def __init__(self, system: "System", read_quorum: int, write_quorum: int):
        self.system = system
        self._rq = read_quorum
        self._wq = write_quorum

    @property
    def _helper(self):
        return self.system.layout_helper

    def storage_nodes(self, hash32):
        return self._helper.current_storage_nodes_of(hash32)

    def read_nodes(self, hash32):
        return self._helper.read_nodes_of(hash32)

    def read_quorum(self):
        return self._rq

    def write_sets(self, hash32):
        return self._helper.write_sets_of(hash32)

    def write_quorum(self):
        return self._wq

    def write_lock(self):
        return self._helper.write_lock()

    def sync_partitions(self):
        out = []
        for p in range(256):
            fh = partition_first_hash(p)
            out.append(SyncPartition(p, fh, self._helper.storage_sets_of(p)))
        return out


class TableFullReplication(TableReplication):
    """Every (non-gateway) node stores everything; local reads.
    ref: fullcopy.rs:21-73."""

    def __init__(self, system: "System"):
        self.system = system

    def _all_nodes(self) -> list[bytes]:
        nodes = self.system.layout_helper.history.all_nongateway_nodes()
        if not nodes:
            return [self.system.id]
        return sorted(nodes)

    def storage_nodes(self, hash32):
        return self._all_nodes()

    def read_nodes(self, hash32):
        # reads are served locally: a STORAGE node always has a full
        # copy. A gateway node (capacity-less; e.g. a multi-process
        # gateway API worker) holds none — it reads from the holders
        # over RPC instead of answering from its empty local table.
        nodes = self._all_nodes()
        if self.system.id in nodes:
            return [self.system.id]
        return nodes

    def read_quorum(self):
        return 1

    def write_sets(self, hash32):
        return [self._all_nodes()]

    def write_quorum(self):
        # tolerate one lagging node, like the reference (fullcopy.rs:59:
        # n - 1, so a new node joining doesn't block all control writes)
        n = len(self._all_nodes())
        return max(1, n - 1)

    def partition_of(self, hash32):
        # single logical partition: the whole keyspace (fullcopy.rs:67)
        return 0

    def sync_partitions(self):
        # one big "partition" 0 covering the whole keyspace
        return [SyncPartition(0, b"\x00" * 32, [self._all_nodes()])]
