"""Copy of garage_tpu/table/__init__.py: import paths rewritten, issue and PR tags dropped.

Replicated CRDT table engine.

Ref parity: src/table/ (SURVEY.md §2.5). Tables are the metadata plane:
entries are CRDTs keyed by (partition key, sort key); writes are
quorum-replicated to the ring write sets; reads quorum-merge and
read-repair in the background; a per-partition Merkle trie drives
anti-entropy sync; tombstones are garbage-collected with a 3-phase
protocol that cannot resurrect deleted data.
"""

from .schema import Entry, TableSchema  # noqa: F401
from .replication import (  # noqa: F401
    TableReplication,
    TableShardedReplication,
    TableFullReplication,
)
from .data import TableData  # noqa: F401
from .merkle import MerkleUpdater, MerkleNode  # noqa: F401
from .table import Table  # noqa: F401
from .sync import TableSyncer  # noqa: F401
from .gc import TableGc  # noqa: F401
from .queue import InsertQueueWorker  # noqa: F401
