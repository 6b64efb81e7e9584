"""Copy of garage_tpu/zones/__init__.py: import paths rewritten, issue and PR tags dropped.

Zones as a first-class subsystem.

The reference system is geo-distributed object storage: zones are the
failure domain the layout spreads replicas across (PAPER.md,
`rpc/layout/assign.py`). This package makes that domain visible at
runtime instead of being only a placement label:

- `ZoneHealth` (health.py) derives per-zone state — up / degraded /
  partitioned — from the peering data every node already gossips, and
  backs the admin `GET /v1/zones` endpoint.
- The zone-aware quorum strategy lives in `rpc/rpc_helper.py`
  (`RequestStrategy.consistency` / zone-span write verification); the
  per-zone cache-tier ring in `block/cache_tier.py`; the
  `partition_zone` chaos fault in `chaos/injector.py`. This package
  holds the shared zone-membership logic they all consume.
"""

from .health import ZoneHealth, ZoneState, layout_zone_resolver

__all__ = ["ZoneHealth", "ZoneState", "layout_zone_resolver"]
