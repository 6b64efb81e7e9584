"""Copy of garage_tpu/rpc/layout/__init__.py: import paths rewritten, issue and PR tags dropped.

Cluster layout: the partition ring and its optimal assignment.

Ref parity: src/rpc/layout/ (SURVEY.md §2.4). 256 partitions (top 8 bits
of the blake2 item hash) are assigned to storage nodes by a max-flow
computation that provably maximizes the feasible partition size under
zone-redundancy constraints, then minimizes data movement from the
previous layout by cancelling negative-cost cycles. Multiple layout
versions stay live during a rebalance; CRDT update trackers gossip each
node's ack/sync progress and drive old-version garbage collection.
"""

from .version import LayoutVersion, NodeRole, PARTITION_BITS, N_PARTITIONS  # noqa: F401
from .history import LayoutHistory, UpdateTrackers, LayoutStaging  # noqa: F401
from .helper import LayoutHelper  # noqa: F401
from .manager import LayoutManager  # noqa: F401
from .transition import ResizeOrchestrator, ResizeReport, ResizeStuck  # noqa: F401
