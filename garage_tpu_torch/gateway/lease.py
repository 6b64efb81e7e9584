"""Copy of garage_tpu/gateway/lease.py: import paths rewritten, issue and PR tags dropped.

BudgetLease broker: rents each gateway worker a share of the node's
qos budgets (req/s and bytes/s) and rebalances by observed demand.

Conservation is the contract: **Σ granted ≤ budget at all times**,
including mid-rebalance and across worker death. It holds by
construction, not by periodic correction:

  * a lease only GROWS out of `pool_free` (budget minus everything
    currently granted) at the moment the owning worker renews;
  * a lease SHRINKS the instant its owner renews (the worker applies
    the smaller rate before the broker hands the difference to anyone
    else — renew() is the only place a grant changes, and the returned
    Lease is what the worker enforces);
  * death / TTL expiry returns the whole grant to the pool — a dead
    worker is not admitting, so the budget is genuinely free.

Rebalance law: each dimension's desired share is a demand-proportional
split of the budget above a per-worker floor (`min_share` of the fair
share). The floor is the demand-discovery mechanism: an idle worker
keeps a trickle leased so the first burst it receives is admitted and
shows up as demand, which the next renew converts into real budget.
Convergence therefore takes ~2 renew rounds: one for the cold workers
to shrink to their floor (freeing pool), one for the hot worker to
absorb the freed budget.

Demand smoothing (EWMA) lives in the broker, not the workers: workers
report raw observed rates and the broker owns the time constant, so a
worker restart cannot reset the signal. The broker is deliberately
synchronous and clock-injected — the same object is driven by the
supervisor's RPC handler in production and by a fake clock in tests —
and is the piece cluster-wide distributed rate limiting will lift
verbatim (each NODE then leases from a gossiped global budget the way
each worker leases from the node budget here).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..utils import sanitizer

# EWMA weight for one demand sample (per renew interval)
DEMAND_ALPHA = 0.3


@dataclass
class Lease:
    """One worker's current rental. `None` rates mean that dimension is
    unlimited (no node budget configured)."""

    worker: str
    rps: Optional[float]
    bytes_per_s: Optional[float]
    seq: int
    ttl_s: float

    def to_dict(self) -> dict:
        return {"worker": self.worker, "rps": self.rps,
                "bytes_per_s": self.bytes_per_s, "seq": self.seq,
                "ttl_s": self.ttl_s}


class _Dimension:
    """Per-dimension (rps / bytes) grant ledger."""

    def __init__(self, total: Optional[float]):
        self.total = total
        self.granted: dict[str, float] = {}
        self.demand: dict[str, float] = {}

    def drop(self, worker: str) -> None:
        self.granted.pop(worker, None)
        self.demand.pop(worker, None)

    def observe(self, worker: str, sample: float) -> None:
        prev = self.demand.get(worker)
        self.demand[worker] = (max(0.0, sample) if prev is None else
                               prev + DEMAND_ALPHA * (sample - prev))

    def renew(self, worker: str, min_share: float,
              expected: int) -> Optional[float]:
        if self.total is None:
            self.granted.pop(worker, None)
            return None
        live = set(self.granted) | {worker}
        n = max(len(live), expected, 1)
        fair = self.total / n
        floor = min(fair, min_share * fair)
        spread = self.total - n * floor
        dsum = sum(self.demand.get(w, 0.0) for w in live)
        if dsum > 0:
            desired = floor + spread * self.demand.get(worker, 0.0) / dsum
        else:
            desired = fair
        cur = self.granted.get(worker, 0.0)
        if desired <= cur:
            # shrink applies NOW: the worker sees the smaller rate in
            # this renew's reply, before the freed budget can be
            # re-granted to anyone else
            grant = desired
        else:
            # growth only out of what is provably unallocated
            pool_free = self.total - sum(self.granted.values())
            grant = min(desired, cur + max(0.0, pool_free))
        self.granted[worker] = grant
        return grant

    @property
    def conservation_ok(self) -> bool:
        if self.total is None:
            return True
        # float-tolerant: grants are sums of budget fractions.
        # tuple() first: read from the /metrics scrape THREAD while
        # renews mutate on the loop — the C-level copy is atomic under
        # the GIL, a Python-level iteration is not
        return sum(tuple(self.granted.values())) \
            <= self.total * (1 + 1e-9)


class BudgetLeaseBroker:
    def __init__(self, total_rps: Optional[float] = None,
                 total_bytes_per_s: Optional[float] = None, *,
                 min_share: float = 0.05, ttl_s: float = 3.0,
                 expected_workers: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.min_share = min_share
        self.ttl_s = ttl_s
        self.expected_workers = max(1, int(expected_workers))
        self._rps = _Dimension(total_rps)
        self._bps = _Dimension(total_bytes_per_s)
        self._expiry: dict[str, float] = {}
        self._seq = 0
        self.renews = 0
        self.revokes = 0
        self.expiries = 0
        # Σ leases ≤ budget re-checked at every loop teardown under
        # GARAGE_SANITIZE=1 (no-op when disarmed)
        sanitizer.track_conservation(self)

    # ---- configuration -------------------------------------------------

    def set_totals(self, rps: Optional[float] = ...,
                   bytes_per_s: Optional[float] = ...) -> None:
        """Runtime budget change (admin POST /v1/qos). A raised budget
        is handed out as workers renew; a lowered one is reclaimed
        shrink-first (renew() never grows a grant while Σ exceeds the
        new total, because pool_free is negative)."""
        if rps is not ...:
            self._rps.total = rps
        if bytes_per_s is not ...:
            self._bps.total = bytes_per_s

    # ---- lease lifecycle -----------------------------------------------

    def renew(self, worker: str, demand_rps: float = 0.0,
              demand_bytes_per_s: float = 0.0) -> Lease:
        """Grant/refresh `worker`'s lease. Also serves as join (first
        renew) — there is deliberately no separate acquire verb."""
        self.expire()
        self._rps.observe(worker, demand_rps)
        self._bps.observe(worker, demand_bytes_per_s)
        rps = self._rps.renew(worker, self.min_share,
                              self.expected_workers)
        bps = self._bps.renew(worker, self.min_share,
                              self.expected_workers)
        self._expiry[worker] = self.clock() + self.ttl_s
        self._seq += 1
        self.renews += 1
        return Lease(worker, rps, bps, self._seq, self.ttl_s)

    def revoke(self, worker: str) -> None:
        """Worker death: the grant drains straight back to the pool (a
        dead process admits nothing, so the budget is really free)."""
        if worker in self._expiry or worker in self._rps.granted \
                or worker in self._bps.granted:
            self.revokes += 1
        self._rps.drop(worker)
        self._bps.drop(worker)
        self._expiry.pop(worker, None)

    def expire(self) -> list[str]:
        """Reclaim leases whose owner went silent past the TTL (hung
        worker: its loop is not admitting either, symmetrical with
        revoke). Called on every renew and by the supervisor monitor."""
        now = self.clock()
        dead = [w for w, t in self._expiry.items() if t < now]
        for w in dead:
            self._rps.drop(w)
            self._bps.drop(w)
            del self._expiry[w]
            self.expiries += 1
        return dead

    # ---- surface -------------------------------------------------------

    @property
    def conservation_ok(self) -> bool:
        return self._rps.conservation_ok and self._bps.conservation_ok

    def granted(self, worker: str) -> tuple[Optional[float],
                                            Optional[float]]:
        return (self._rps.granted.get(worker),
                self._bps.granted.get(worker))

    def state(self) -> dict:
        def dim(d: _Dimension) -> dict:
            # dict() snapshots are GIL-atomic: state() is read from the
            # /metrics scrape thread while renew/revoke mutate the live
            # dicts on the event loop
            granted = dict(d.granted)
            demand = dict(d.demand)
            return {
                "total": d.total,
                "granted": {w: round(v, 3) for w, v in granted.items()},
                "demand": {w: round(v, 3) for w, v in demand.items()},
                "pool_free": (None if d.total is None else
                              round(d.total - sum(granted.values()), 3)),
            }

        return {
            "rps": dim(self._rps), "bytes_per_s": dim(self._bps),
            "ttl_s": self.ttl_s, "min_share": self.min_share,
            "expected_workers": self.expected_workers,
            "conservation_ok": self.conservation_ok,
            "renews": self.renews, "revokes": self.revokes,
            "expiries": self.expiries,
        }
