"""Copy of garage_tpu/model/k2v/__init__.py: import paths rewritten, issue and PR tags dropped.

K2V: causally-consistent key-key-value store (model layer).

Ref parity: src/model/k2v/ — DVVS item table (item_table.py), vector
clocks / causality tokens (causality.py), insert-routing RPC + poll
subscriptions (rpc.py).
"""

from .causality import CausalContext, make_node_id, vclock_gt, vclock_max
from .item_table import DvvsEntry, K2VItem, K2VItemTable, partition_pk
from .rpc import K2VRpcHandler, SubscriptionManager

__all__ = [
    "CausalContext", "DvvsEntry", "K2VItem", "K2VItemTable",
    "K2VRpcHandler", "SubscriptionManager", "make_node_id",
    "partition_pk", "vclock_gt", "vclock_max",
]
