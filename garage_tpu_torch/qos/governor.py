"""Copy of garage_tpu/qos/governor.py: import paths rewritten, issue and PR tags dropped.

Feedback-driven background-work governor.

The fixed `Tranquilizer` tranquility of resync/scrub workers is blind
to foreground latency: a deep-scrub storm keeps hammering the disks and
event loop while users wait, and an idle cluster still crawls through
repair at the configured trickle. This worker closes the loop:

  sample    per-interval mean of foreground request latency — the
            `api_request_duration_seconds` series (every S3/K2V/admin
            request) plus the foreground-priority slice of
            `rpc_request_duration_seconds` (net dispatch path; resync
            and scrub RPCs travel PRIO_BACKGROUND and are excluded so
            the governor never chases its own tail).
  smooth    EWMA so one slow request doesn't whipsaw the workers.
  control   integral controller on `pressure` in [0, 1]: latency above
            target pushes pressure up (background yields), below target
            bleeds it off (background sprints); no foreground traffic
            at all decays it toward 0.
  actuate   pressure maps linearly onto each worker's tranquility
            range: scrub tranquility in [scrub_min, scrub_max]
            (a duration multiplier, repair.py) and resync tranquility
            in [resync_min, resync_max] (an inter-item delay in
            seconds, resync.py).

While enabled the governor OWNS those two tranquilities — with one
exception: an explicit operator `worker set resync-tranquility` /
`scrub-tranquility` places a manual hold on that knob (operators
outrank the loop). Retune the *bounds* via admin `/v1/qos`, disable
the whole loop with `worker set qos-governor 0`, or re-enable with
`... 1` (which also clears manual holds).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from ..utils.background import Throttled, Worker, WorkerInfo
from ..utils.metrics import registry

log = logging.getLogger("garage_tpu_torch.qos")


def foreground_latency_totals() -> tuple[int, float]:
    """(count, total_seconds) of foreground work since process start."""
    reg = registry()
    c1, t1 = reg.totals("api_request_duration_seconds")
    c2, t2 = reg.totals("rpc_request_duration_seconds", bg="0")
    return c1 + c2, t1 + t2


class GovernorWorker(Worker):
    name = "qos governor"

    # integral gain per step, and the cap on one step's |pressure| move
    GAIN = 0.25
    MAX_STEP = 0.5
    # pressure decay per idle interval (no foreground samples at all)
    IDLE_DECAY = 0.15
    EWMA_ALPHA = 0.3
    # pressure push per queued writer at the block byte-semaphore (a
    # LEADING signal: writers park there before any latency sample can
    # show the overload), capped at one MAX_STEP per interval
    QUEUE_GAIN = 0.1
    QUEUE_REF_DEPTH = 5  # depth at which the queue signal saturates
    # pressure push from the resync/rebalance backlog while foreground
    # traffic is active: a deep backlog means rebalance pushes/fetches
    # are competing with users for the same links and disks, so
    # background work yields BEFORE the latency EWMA shows the damage.
    # When the cluster is foreground-idle the idle decay wins instead
    # and the rebalance sprints.
    RESYNC_GAIN = 0.3  # max push per interval, at backlog saturation
    RESYNC_REF_BACKLOG = 256.0  # `[qos] resync_backlog_ref`
    # pressure maps onto the table syncers' per-partition sleep too: a
    # layout change triggers an anti-entropy round of every table on
    # every node at once, and unthrottled rounds were the dominant
    # foreground-p99 cost of a resize. Default for the
    # `[table] sync_tranquility_max` knob (ctor overrides).
    TABLE_SYNC_TRANQ_MAX = 0.05  # s/partition at pressure 1.0
    # lsm compaction pacing: seconds of sleep between merge steps at
    # pressure 1.0 (db/lsm.py LsmMaintenanceWorker). A merge step is a
    # burst of disk+CPU, so it yields harder than per-item work does.
    LSM_COMPACT_TRANQ_MAX = 5.0
    # cache-tier hint prefetch pacing (block/cache_tier.py):
    # seconds of sleep before each background prefetch decode at
    # pressure 1.0 — a prefetch is a speculative gather+decode, so it
    # yields to foreground latency like resync does
    PREFETCH_TRANQ_MAX = 2.0

    def __init__(self, garage, interval: float = 2.0,
                 target_latency: float = 0.05,
                 scrub_range: tuple[float, float] = (1.0, 30.0),
                 resync_range: tuple[float, float] = (0.0, 2.0),
                 sample_fn: Optional[Callable[[], tuple[int, float]]] = None,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 resync_backlog_fn: Optional[Callable[[], int]] = None,
                 resync_backlog_ref: Optional[float] = None,
                 table_sync_tranq_max: Optional[float] = None):
        self.garage = garage
        self.interval = interval
        self.target_latency = target_latency
        self.scrub_range = scrub_range
        self.resync_range = resync_range
        self.sample_fn = sample_fn or foreground_latency_totals
        self.queue_depth_fn = queue_depth_fn
        self.resync_backlog_fn = resync_backlog_fn
        self.resync_backlog_ref = float(resync_backlog_ref
                                        or self.RESYNC_REF_BACKLOG)
        self.table_sync_tranq_max = float(
            self.TABLE_SYNC_TRANQ_MAX if table_sync_tranq_max is None
            else table_sync_tranq_max)
        self.enabled = True
        self.pressure = 0.0
        self.ewma: Optional[float] = None
        self.last_queue_depth = 0
        self.last_resync_backlog = 0
        self._last: Optional[tuple[int, float]] = None
        self.adjustments = 0

    def _queue_depth(self) -> int:
        """Writers parked at the block manager's byte-semaphore."""
        if self.queue_depth_fn is not None:
            return self.queue_depth_fn()
        bm = getattr(self.garage, "block_manager", None)
        sem = getattr(bm, "_ram_sem", None)
        return sem.queue_depth() if sem is not None else 0

    def _resync_backlog(self) -> int:
        """Blocks queued for resync and due NOW — during a cluster
        resize this IS the rebalance backlog. Future-due entries
        (error backoff, breaker deferrals) are excluded: they are not
        competing with foreground traffic."""
        if self.resync_backlog_fn is not None:
            return self.resync_backlog_fn()
        bm = getattr(self.garage, "block_manager", None)
        resync = getattr(bm, "resync", None)
        qlen = getattr(resync, "due_len", None) \
            or getattr(resync, "queue_len", None)
        # getattr-soft: governor tests run against stub resyncs
        return qlen() if callable(qlen) else 0

    # ---- control step (synchronous, unit-testable) ---------------------

    def step(self) -> None:
        count, total = self.sample_fn()
        if self._last is None:
            self._last = (count, total)
            return
        dc = count - self._last[0]
        dt = total - self._last[1]
        self._last = (count, total)
        if dc > 0:
            lat = dt / dc
            self.ewma = (lat if self.ewma is None
                         else self.ewma + self.EWMA_ALPHA * (lat - self.ewma))
            err = self.ewma / self.target_latency - 1.0
            move = max(-self.MAX_STEP, min(self.MAX_STEP, self.GAIN * err))
            self.pressure = max(0.0, min(1.0, self.pressure + move))
        else:
            # cluster is foreground-idle: let background work sprint
            self.pressure = max(0.0, self.pressure - self.IDLE_DECAY)
        # queue-depth signal (ROADMAP "governor signal breadth"): byte-
        # semaphore waiters mean the write path is ALREADY saturated,
        # even if the latency EWMA hasn't caught up — push background
        # work back before users feel it
        self.last_queue_depth = depth = self._queue_depth()
        if depth > 0:
            move = min(self.MAX_STEP,
                       self.QUEUE_GAIN * min(depth, self.QUEUE_REF_DEPTH))
            self.pressure = min(1.0, self.pressure + move)
        # resync-backlog signal: rebalance yields to
        # foreground p99 while users are active; with no foreground
        # traffic the idle decay above already lets it sprint
        self.last_resync_backlog = backlog = self._resync_backlog()
        if backlog > 0 and dc > 0:
            move = min(self.MAX_STEP,
                       self.RESYNC_GAIN
                       * min(backlog / self.resync_backlog_ref, 1.0))
            self.pressure = min(1.0, self.pressure + move)
        self._apply()

    def _apply(self) -> None:
        bm = getattr(self.garage, "block_manager", None)
        if bm is None:
            return
        u = self.pressure
        # a manual `worker set <x>-tranquility` holds that knob until
        # the governor is explicitly re-enabled (`worker set
        # qos-governor 1` clears the holds) — operators outrank the
        # control loop
        if not getattr(bm.resync, "tranquility_manual", False):
            lo, hi = self.resync_range
            bm.resync.tranquility = lo + u * (hi - lo)
        sw = getattr(bm, "scrub_worker", None)
        if sw is not None and not getattr(sw.state, "tranquility_manual",
                                          False):
            lo, hi = self.scrub_range
            # in-memory only: the scrub worker persists its state at
            # each batch/pass boundary anyway, and a persister write per
            # governor tick would be pure write amplification
            sw.state.tranquility = lo + u * (hi - lo)
        all_tables = getattr(self.garage, "all_tables", None)
        if callable(all_tables):
            tranq = u * self.table_sync_tranq_max
            for t in all_tables():
                syncer = getattr(t, "syncer", None)
                if syncer is not None:
                    syncer.tranquility = tranq
        # lsm compaction yields to foreground latency the same way the
        # table syncers do (db/lsm.py LsmMaintenanceWorker)
        lm = getattr(self.garage, "lsm_maintenance", None)
        if lm is not None:
            lm.tranquility = u * self.LSM_COMPACT_TRANQ_MAX
        # cache-tier hint prefetch yields like resync: speculative
        # decodes must never compete with the foreground reads they
        # exist to speed up
        tier = getattr(bm, "cache_tier", None)
        if tier is not None:
            tier.prefetch_tranquility = u * self.PREFETCH_TRANQ_MAX
        self.adjustments += 1
        registry().inc("qos_governor_pressure", self.pressure)

    # ---- worker protocol -----------------------------------------------

    async def work(self):
        if self.enabled:
            self.step()
        return Throttled(self.interval)

    async def wait_for_work(self):
        import asyncio

        await asyncio.sleep(self.interval)

    def info(self) -> WorkerInfo:
        ewma_ms = f"{self.ewma * 1000:.1f}ms" if self.ewma else "-"
        return WorkerInfo(
            name=self.name,
            progress=(f"pressure {self.pressure:.2f}, ewma {ewma_ms}"
                      + ("" if self.enabled else " (disabled)")),
        )

    def state(self) -> dict:
        return {
            "enabled": self.enabled,
            "pressure": round(self.pressure, 4),
            "ewma_latency_s": (round(self.ewma, 6)
                               if self.ewma is not None else None),
            "queue_depth": self.last_queue_depth,
            "resync_backlog": self.last_resync_backlog,
            "target_latency_s": self.target_latency,
            "scrub_range": list(self.scrub_range),
            "resync_range": list(self.resync_range),
            "adjustments": self.adjustments,
        }
