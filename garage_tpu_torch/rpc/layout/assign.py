"""Copy of garage_tpu/rpc/layout/assign.py: import paths rewritten, issue and PR tags dropped.

Optimal partition assignment via max-flow + movement minimization.

Ref parity: src/rpc/layout/version.rs:281-400 (orchestration). Same
guarantees, independent implementation:

1. The optimal partition size is found by binary search: size s is
   feasible iff a flow network routes N_PARTITIONS * rf units through
   Source -> partition (cap rf) -> (partition, zone) (cap rf-zr+1)
   -> node (cap 1 per partition; floor(capacity/s) total) -> Sink.
   Larger s = fewer partitions per node; the max feasible s uses the
   cluster's capacity most evenly under the zone constraint.
2. With s fixed, data movement is minimized by giving cost 0 to
   (partition -> node) edges present in the previous layout and cost 1
   to new ones, then cancelling negative cycles until the flow is
   min-cost.
3. Zone spread is maximized BEYOND the zone_redundancy floor: the
   (partition -> zone) edge is split into a cap-1 cost-0 slot plus a
   cap-(rf-zr+1-1) slot costing SPREAD_COST per doubled replica, with
   SPREAD_COST > the largest possible total movement cost so the
   min-cost pass lexicographically prefers one-replica-per-zone
   placements and only then minimizes movement. Without this, a
   6-node/3-zone rf=3 zr=2 cluster legally doubles two replicas of
   every partition into one zone — losing that zone then kills
   R=2/W=2 quorums even though zone_redundancy=2 was satisfied.

`check_against_naive` (tests/test_layout.py) mirrors the reference's
optimality test: the computed partition size must be >= a naive greedy
assignment's.
"""

from __future__ import annotations

from typing import Optional

from .graph import FlowGraph
from .version import N_PARTITIONS, LayoutVersion, NodeRole

SRC, SINK = "src", "sink"

# Cost of placing a second/third replica of a partition into a zone
# that already holds one. Movement cost totals at most
# N_PARTITIONS * rf (= 768 at rf 3), so any value above that makes
# spread maximization strictly dominate movement minimization.
SPREAD_COST = 1024


class LayoutError(Exception):
    pass


def _zone_redundancy_value(zone_redundancy, zones: list[str], rf: int) -> int:
    if zone_redundancy == "maximum":
        return min(rf, len(zones))
    zr = int(zone_redundancy)
    if zr < 1 or zr > rf:
        raise LayoutError(f"zone_redundancy {zr} out of range 1..{rf}")
    return zr


def _build_graph(
    storage: list[tuple[bytes, NodeRole]],
    zones: list[str],
    rf: int,
    zr: int,
    size: int,
    prev_edges: Optional[set[tuple[int, int]]] = None,
) -> FlowGraph:
    g = FlowGraph()
    per_zone_cap = rf - zr + 1
    costed = prev_edges is not None
    for p in range(N_PARTITIONS):
        g.add_edge(SRC, ("p", p), rf)
        for z in set(z for z in zones):
            if costed and per_zone_cap > 1:
                # parallel edges: the first replica in a zone is free,
                # every doubled one costs SPREAD_COST — min-cost flow
                # then spreads replicas across zones whenever capacity
                # allows, with zr still the hard feasibility floor
                g.add_edge(("p", p), ("pz", p, z), 1, 0)
                g.add_edge(("p", p), ("pz", p, z), per_zone_cap - 1,
                           SPREAD_COST)
            else:
                g.add_edge(("p", p), ("pz", p, z), per_zone_cap)
    for i, (node, role) in enumerate(storage):
        for p in range(N_PARTITIONS):
            cost = 0 if costed and (p, i) in prev_edges else 1
            g.add_edge(("pz", p, role.zone), ("n", i), 1, cost if costed else 0)
        g.add_edge(("n", i), SINK, role.capacity // size if size > 0 else 0)
    return g


def compute_assignment(
    roles_items: list[tuple[bytes, Optional[NodeRole]]],
    rf: int,
    zone_redundancy,
    prev: Optional[LayoutVersion] = None,
) -> tuple[list[bytes], bytes, int]:
    """Returns (node_id_vec, ring_assignment_data, partition_size).

    roles_items: (node_id, role) pairs; role None or capacity None are
    excluded from storage (gateways).
    """
    storage = [
        (node, role)
        for node, role in roles_items
        if role is not None and role.capacity is not None
    ]
    storage.sort(key=lambda kv: kv[0])
    if len(storage) < rf:
        raise LayoutError(
            f"not enough storage nodes: {len(storage)} < replication factor {rf}"
        )
    zones = sorted({role.zone for _, role in storage})
    zr = _zone_redundancy_value(zone_redundancy, zones, rf)
    if len(zones) < zr:
        raise LayoutError(f"only {len(zones)} zones < zone redundancy {zr}")

    # previous assignment as (partition, storage-index) pairs for
    # movement minimization
    prev_edges: set[tuple[int, int]] = set()
    if prev is not None and prev.ring_assignment_data:
        index_of = {node: i for i, (node, _) in enumerate(storage)}
        for p in range(N_PARTITIONS):
            for node in prev.nodes_of(p):
                i = index_of.get(node)
                if i is not None:
                    prev_edges.add((p, i))

    target = N_PARTITIONS * rf

    def feasible(size: int) -> bool:
        g = _build_graph(storage, zones, rf, zr, size)
        return g.max_flow(SRC, SINK) == target

    # binary search the largest feasible partition size; coarsened to
    # ~2^12 candidate sizes so the number of max-flow runs stays bounded
    # (sub-unit precision of the partition size has no operational value)
    hi = sum(role.capacity for _, role in storage) // target + 1
    unit = max(1, hi >> 12)
    lo = 1
    if not feasible(lo):
        raise LayoutError("cluster capacity too small for even one byte per partition")
    lo_u, hi_u = 0, hi // unit
    while lo_u < hi_u:
        mid = (lo_u + hi_u + 1) // 2
        if feasible(max(1, mid * unit)):
            lo_u = mid
        else:
            hi_u = mid - 1
    size = max(1, lo_u * unit)

    # min-movement flow at the optimal size
    g = _build_graph(storage, zones, rf, zr, size, prev_edges)
    if g.max_flow(SRC, SINK) != target:
        raise LayoutError("internal: optimal size infeasible on costed graph")
    g.cancel_negative_cycles()

    # extract assignment
    node_id_vec = [node for node, _ in storage]
    ring = bytearray()
    for p in range(N_PARTITIONS):
        chosen = []
        for i, (node, role) in enumerate(storage):
            # find the (pz -> n) edge for this partition/node
            for e in g.adj[g.vertex(("pz", p, role.zone))]:
                if e % 2 == 0 and g.to[e] == g.vertex(("n", i)) and g.flow_on(e) > 0:
                    chosen.append(i)
                    break
        if len(chosen) != rf:
            raise LayoutError(f"partition {p}: assigned {len(chosen)} != rf {rf}")
        ring.extend(chosen)
    return node_id_vec, bytes(ring), size
