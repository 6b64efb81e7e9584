"""Copy of garage_tpu/rpc/__init__.py: import paths rewritten, issue and PR tags dropped.

Membership, cluster layout, and quorum RPC.

Ref parity: src/rpc/ (SURVEY.md §2.4). The layer that turns the net/
transport mesh into a cluster: gossip-based membership (system.py), the
partition ring with max-flow optimal assignment (layout/), quorum call
orchestration (rpc_helper.py), and the replication-mode plugin boundary
(replication_mode.py) — extended here with the erasure(k, m) mode whose
math runs on TPU (ops/rs.py).
"""

from .replication_mode import ConsistencyMode, ReplicationMode  # noqa: F401
from .system import System  # noqa: F401
from .rpc_helper import RpcHelper, RequestStrategy  # noqa: F401
