"""Copy of garage_tpu/rpc/layout/transition.py: import paths rewritten, issue and PR tags dropped.

Resize orchestrator: stage -> apply -> ack -> sync -> commit, live.

The layout layer (manager/history/helper) makes a cluster resize SAFE —
writes go to the union of every live version's write sets, reads to the
newest fully-synced version — but nothing in the tree actually DROVE a
transition end to end. This module is that driver (tentpole):
it sequences one staged change through its four phases against live
traffic and reports where a stuck transition is stuck.

Phases (all observed through the gossiped CRDT trackers, so the
orchestrator runs identically over TCP or the in-process loopback
cluster used by tests/bench):

  apply    compute the new LayoutVersion from the staged roles
           (max-flow assignment) and broadcast it.
  ack      every storage node directs writes to the new version's
           write sets: ack_map_min >= v. Until then writes fan out to
           BOTH versions' sets (helper.write_sets_of) — the
           union-quorum window where no request may fail for lack of a
           stable layout.
  sync     every storage node has migrated its data: sync_map_min >= v.
           Per node that means every registered sync source — each
           table's anti-entropy round AND the block store's rebalance
           backlog — reports completion (LayoutManager.sync_until_from
           takes the minimum across sources).
  commit   the superseded version is GC'd (min_stored >= v) once
           sync_ack converges; block reads still consult old_versions
           for stragglers.

The orchestrator never mutates remote nodes directly: staging is a
CRDT merge, progress is gossip. Its only powers are local staging,
apply, broadcast nudges, and patience.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Optional

from ...utils.metrics import registry
from .version import NodeRole

log = logging.getLogger("garage_tpu_torch.rpc.layout.transition")


@dataclass
class ResizeReport:
    """What one transition did and how long each phase took."""

    version: int = 0
    phase_seconds: dict = field(default_factory=dict)  # phase -> s
    laggards: dict = field(default_factory=dict)  # phase -> [node hex]
    completed: bool = False

    @property
    def total_seconds(self) -> float:
        return sum(self.phase_seconds.values())


class ResizeStuck(TimeoutError):
    """A phase did not converge in time; names the phase and the nodes
    whose trackers are behind, so the operator knows WHOM to kick."""

    def __init__(self, phase: str, version: int, laggards: list[str]):
        super().__init__(
            f"resize to layout v{version} stuck in phase {phase!r}; "
            f"lagging nodes: {', '.join(laggards) or '(none visible)'}")
        self.phase = phase
        self.version = version
        self.laggards = laggards


class ResizeOrchestrator:
    """Drives one staged layout change on a coordinator node's System."""

    def __init__(self, system, poll_s: float = 0.05):
        self.system = system
        self.lm = system.layout_manager
        self.helper = system.layout_manager.helper
        self.poll_s = poll_s

    # ---- staging (thin sugar over the CRDT staging map) -----------------

    def stage_add(self, node_id: bytes, zone: str, capacity: int) -> None:
        self.lm.history.stage_role(
            node_id, NodeRole(zone=zone, capacity=capacity))

    def stage_remove(self, node_id: bytes) -> None:
        self.lm.history.stage_role(node_id, None)

    # ---- the transition -------------------------------------------------

    async def apply(self, version: Optional[int] = None) -> int:
        """Apply staged changes -> new version, broadcast. Returns the
        new version number (operators pass the expected one to refuse
        racing a concurrent change). The assignment computation runs
        off the event loop — an unlucky movement-minimization graph
        costs seconds of CPU, and freezing the serving loop for it
        would BE the downtime this orchestrator exists to avoid."""
        await self.lm.apply_staged_async(version)
        return self.helper.current().version

    async def run(self, timeout: float = 60.0,
                  expect_version: Optional[int] = None) -> ResizeReport:
        """Apply the staged change and wait out all four phases."""
        report = ResizeReport()
        t0 = time.monotonic()
        report.version = v = await self.apply(expect_version)
        dt = time.monotonic() - t0
        report.phase_seconds["apply"] = dt
        # recorded like the wait phases below so the admin /v1/resize
        # readout shows all four phases, not just the waits
        registry().observe("resize_phase_seconds", dt, phase="apply")
        for phase, waiter in (("ack", self.wait_acked),
                              ("sync", self.wait_synced),
                              ("commit", self.wait_committed)):
            t0 = time.monotonic()
            await waiter(v, timeout)
            dt = time.monotonic() - t0
            report.phase_seconds[phase] = dt
            registry().observe("resize_phase_seconds", dt, phase=phase)
        report.completed = True
        registry().inc("resize_transitions_completed")
        log.info("layout v%d transition complete in %.2fs "
                 "(ack %.2fs, sync %.2fs, commit %.2fs)",
                 v, report.total_seconds,
                 report.phase_seconds["ack"],
                 report.phase_seconds["sync"],
                 report.phase_seconds["commit"])
        return report

    async def wait_acked(self, version: int, timeout: float = 30.0) -> None:
        await self._wait(
            "ack", version,
            lambda: self.helper.ack_map_min() >= version,
            lambda: self._laggards("ack", version), timeout)

    async def wait_synced(self, version: int, timeout: float = 60.0) -> None:
        await self._wait(
            "sync", version,
            lambda: self.helper.sync_map_min() >= version,
            lambda: self._laggards("sync", version), timeout)

    async def wait_committed(self, version: int,
                             timeout: float = 60.0) -> None:
        await self._wait(
            "commit", version,
            lambda: self.lm.history.min_stored() >= version,
            lambda: self._laggards("sync_ack", version), timeout)

    # ---- internals ------------------------------------------------------

    def _laggards(self, tracker: str, version: int) -> list[str]:
        m = getattr(self.lm.history.update_trackers, tracker)
        out = []
        for n in sorted(self.lm.history.all_storage_nodes()):
            if m.get(n, self.lm.history.min_stored()) < version:
                out.append(n.hex()[:8])
        return out

    async def _wait(self, phase: str, version: int, cond, laggards,
                    timeout: float) -> None:
        deadline = time.monotonic() + timeout
        next_nudge = 0.0
        while not cond():
            now = time.monotonic()
            if now >= deadline:
                raise ResizeStuck(phase, version, laggards())
            if now >= next_nudge:
                # gossip converges on its own via the status exchange;
                # the nudge just shortens the tail (and costs nothing
                # when everyone already agrees)
                await self.lm.broadcast()
                next_nudge = now + max(self.poll_s * 10, 0.5)
            await asyncio.sleep(self.poll_s)
