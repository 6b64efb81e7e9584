"""Copy of garage_tpu/rpc/layout/graph.py: import paths rewritten, issue and PR tags dropped.

Flow-network algorithms for layout assignment.

Ref parity: src/rpc/layout/graph_algo.rs:14-405, re-implemented from the
textbook algorithms (Dinic blocking-flow max-flow; Bellman-Ford
negative-cycle cancellation for min-cost refinement). Graphs are small —
O(256 + 256*zones + nodes) vertices — so pure Python is plenty; this is
operator-triggered control-plane work, not the data plane.
"""

from __future__ import annotations

from collections import deque
from typing import Hashable


class FlowGraph:
    """Integer-capacity flow network with optional per-edge costs."""

    def __init__(self):
        self.ids: dict[Hashable, int] = {}
        self.adj: list[list[int]] = []  # vertex -> edge indices
        self.to: list[int] = []
        self.cap: list[int] = []
        self.cost: list[int] = []

    def vertex(self, key: Hashable) -> int:
        v = self.ids.get(key)
        if v is None:
            v = self.ids[key] = len(self.adj)
            self.adj.append([])
        return v

    def add_edge(self, u: Hashable, v: Hashable, cap: int, cost: int = 0) -> int:
        """Returns the forward edge index; the reverse edge is index^1."""
        ui, vi = self.vertex(u), self.vertex(v)
        e = len(self.to)
        self.to.extend([vi, ui])
        self.cap.extend([cap, 0])
        self.cost.extend([cost, -cost])
        self.adj[ui].append(e)
        self.adj[vi].append(e + 1)
        return e

    def flow_on(self, e: int) -> int:
        """Units pushed over forward edge e (== residual of its twin)."""
        return self.cap[e + 1] if e % 2 == 0 else self.cap[e]

    # ---- Dinic max-flow ------------------------------------------------

    def max_flow(self, s: Hashable, t: Hashable) -> int:
        si, ti = self.vertex(s), self.vertex(t)
        total = 0
        n = len(self.adj)
        while True:
            level = [-1] * n
            level[si] = 0
            q = deque([si])
            while q:
                u = q.popleft()
                for e in self.adj[u]:
                    v = self.to[e]
                    if self.cap[e] > 0 and level[v] < 0:
                        level[v] = level[u] + 1
                        q.append(v)
            if level[ti] < 0:
                return total
            it = [0] * n

            def dfs(u: int, pushed: int) -> int:
                if u == ti:
                    return pushed
                while it[u] < len(self.adj[u]):
                    e = self.adj[u][it[u]]
                    v = self.to[e]
                    if self.cap[e] > 0 and level[v] == level[u] + 1:
                        got = dfs(v, min(pushed, self.cap[e]))
                        if got > 0:
                            self.cap[e] -= got
                            self.cap[e ^ 1] += got
                            return got
                    it[u] += 1
                return 0

            while True:
                pushed = dfs(si, 1 << 62)
                if pushed == 0:
                    break
                total += pushed

    # ---- negative-cycle cancellation ----------------------------------

    def cancel_negative_cycles(self) -> int:
        """Repeatedly find negative-cost cycles in the residual graph
        and push flow around them. Returns total cost reduction.
        Terminates because each batch strictly reduces the (integer)
        total cost.

        The old one-cycle-per-full-Bellman-Ford version was measured at
        70+ SECONDS of event-loop-blocking CPU on an unlucky 5-node
        resize (129 cycles x O(V*E) each): every pred-graph sweep now
        harvests ALL vertex-disjoint cycles, and detection fires on the
        first pass whose relaxations close a pred loop instead of after
        |V| full passes."""
        reduced = 0
        while True:
            cycles = self._find_negative_cycles()
            if not cycles:
                return reduced
            for cyc in cycles:
                # vertex-disjoint cycles cannot share an edge or its
                # twin (twins share both endpoints), so batch-mates
                # never consume each other's residual capacity
                push = min(self.cap[e] for e in cyc)
                for e in cyc:
                    self.cap[e] -= push
                    self.cap[e ^ 1] += push
                reduced += -sum(self.cost[e] for e in cyc) * push

    def _find_negative_cycles(self) -> list[list[int]]:
        """Bellman-Ford from a virtual all-zeros super-source with
        early detection: a cycle formed by the predecessor pointers at
        ANY point during relaxation is a negative cycle (the standard
        invariant — dist only decreases, so a pred loop sums < 0), so
        the pred graph is swept after every pass and every
        vertex-disjoint cycle found is returned at once. [] once no
        negative cycle remains."""
        n = len(self.adj)
        dist = [0] * n
        pred = [-1] * n
        nedge = len(self.to)
        for _ in range(n + 1):
            updated = False
            for e in range(nedge):
                if self.cap[e] <= 0:
                    continue
                u = self.to[e ^ 1]
                d = dist[u] + self.cost[e]
                v = self.to[e]
                if d < dist[v]:
                    dist[v] = d
                    pred[v] = e
                    updated = True
            if not updated:
                return []
            cycles = self._pred_cycles(pred)
            if cycles:
                return cycles
        return []  # |V|+1 updating passes without a pred loop: cannot
        # happen with integer costs, but fail closed rather than spin

    def _pred_cycles(self, pred: list[int]) -> list[list[int]]:
        """All vertex-disjoint cycles in the predecessor graph, each as
        its residual-edge list ({pred[x] for x on the loop}). Iteration
        is in vertex-index order, so results are deterministic."""
        n = len(self.adj)
        color = [0] * n  # 0 unvisited / 1 on current walk / 2 done
        out: list[list[int]] = []
        for start in range(n):
            if color[start] or pred[start] < 0:
                continue
            path: list[int] = []
            v = start
            while True:
                if color[v] == 1:
                    # v repeats inside the current walk: pred loop.
                    # Disjointness is structural: the pred graph is
                    # functional (≤1 pred edge per vertex), so cycles
                    # can't share a vertex, and a harvested loop's
                    # vertices are colored 2 below — later walks break
                    # before re-reaching them.
                    loop = path[path.index(v):]
                    cyc = [pred[x] for x in loop]
                    # the invariant guarantees negativity; the check
                    # guards termination against any edge case (a
                    # zero-cost loop would spin forever)
                    if sum(self.cost[e] for e in cyc) < 0:
                        out.append(cyc)
                    break
                if color[v] == 2 or pred[v] < 0:
                    break
                color[v] = 1
                path.append(v)
                v = self.to[pred[v] ^ 1]
            for x in path:
                color[x] = 2
        return out
