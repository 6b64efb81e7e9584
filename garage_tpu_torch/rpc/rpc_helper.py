"""Copy of garage_tpu/rpc/rpc_helper.py: import paths rewritten, issue and PR tags dropped.

RpcHelper: quorum call orchestration, self-healing.

Ref parity: src/rpc/rpc_helper.rs:160-766. The transport-agnostic quorum
engine:

- `call`: one node, with timeout + metrics.
- `try_call_many`: N nodes, return at `quorum` successes. Adaptive send:
  issue only `quorum` requests first (preferring self/same-zone/low-ping
  nodes), adding replacements as errors come in; or all at once.
- `try_write_many_sets`: write to multiple quorum sets during layout
  transitions; succeeds when EVERY set reaches its write quorum;
  remaining requests continue in the background. Idempotent writes may
  opt into HEDGED backup pushes (strategy.hedge=True): a quorum-key
  still unanswered past its holder's observed p95 gets the same call
  re-issued, and the first landing wins — GL02 keeps every such
  opt-in justified (content-addressed shard puts qualify, CRDT
  inserts do not).
- `QuorumSetResultTracker`: the bookkeeping shared by both.
- `HedgedRace`: the shared hedged-wait loop. The hedge logic used to
  exist in three near-copies (here, block `_get_replicate`, erasure
  `_gather_parts`) and the shard-write hedge would have made four;
  the budget, rate-cap token draw, win accounting and loser cleanup
  now live in this one class, and callers keep only their success
  predicate and replacement policy.

Beyond the reference, every call feeds the shared per-peer health
tracker (net/peering.py PeerHealthTracker) and reads it back:

- **Adaptive timeouts**: a peer with enough samples gets
  clamp(p99 * 4) instead of the flat default (the flat value stays the
  ceiling, and the default when no samples exist).
- **Circuit breakers**: request_order ranks peers whose breaker is
  open/exhausted behind healthy ones, so a known-broken peer stops
  being everyone's first choice; half-open peers get a bounded probe
  budget to prove recovery.
- **Hedged reads** (Dean & Barroso, CACM 2013): with
  send_all_at_once=False, if no in-flight request completes within the
  peers' observed p95, a backup request is launched at the next-ranked
  node instead of waiting out an error or timeout. First success wins,
  losers are cancelled, and a global token bucket caps the hedge rate.
- **Named errors**: every transport failure is wrapped so the surfaced
  message carries the peer id and endpoint (`QuorumError.errors`
  entries included) — a bare `TimeoutError` gives operators nothing.
- **Zone-aware quorums** (garage_tpu/zones/): request_order
  already prefers same-zone peers, so reads are local-zone-first and
  hedges naturally spill cross-zone; on top of that, nodes sitting in
  a zone `ZoneHealth` reports PARTITIONED sort dead last even while
  their conn state flaps through reconnect churn. Writes pre-verify
  that every quorum set actually spans the layout's `zone_redundancy`
  zones and raise the typed `ZoneSpanError` when placement can't — a
  mis-spread set would otherwise "succeed" W=2 inside one failure
  domain. A per-request `ConsistencyMode.DEGRADED` override on
  `RequestStrategy` lets a caller serve a read from whatever zones
  survive a partition (effective quorum 1, Dynamo-style sloppy read)
  without flipping the whole cluster out of consistent mode.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..net.message import PRIO_NORMAL
from ..utils.error import QuorumError, RpcError, ZoneSpanError
from ..utils.metrics import registry
from .replication_mode import ConsistencyMode
from .system import System


def _consume_task_result(t: asyncio.Task) -> None:
    if t.cancelled():
        return
    e = t.exception()
    if e is not None:
        logging.getLogger(__name__).debug("straggler rpc failed: %s", e)

log = logging.getLogger("garage_tpu_torch.rpc.helper")

DEFAULT_TIMEOUT = 30.0
# at most this many hedges augment one try_call_many call (the global
# token bucket in PeerHealthTracker caps the cluster-wide rate on top)
MAX_HEDGES_PER_CALL = 2


class HedgedRace:
    """One hedged fan-out (Dean & Barroso hedging, shared engine).

    Owns the pending-task map, the hedge-delay FIRST_COMPLETED wait,
    the per-call hedge budget, the global rate-cap token draw, the
    launch/win metrics and loser cleanup. Callers supply a launch
    callback (what a hedge actually issues: next-ranked node for reads,
    a re-issued call for idempotent writes) and decide success from the
    completed tasks themselves.

    Works with health=None (bare test stubs): hedging simply stays off
    and wait() degrades to a plain FIRST_COMPLETED."""

    def __init__(self, health, label: str, *,
                 enabled: Optional[bool] = None,
                 max_hedges: int = MAX_HEDGES_PER_CALL):
        self.health = health
        self.label = label
        self.hedging = health is not None and bool(
            enabled if enabled is not None else health.hedging_enabled)
        self.max_hedges = max_hedges
        self.hedges = 0
        self.pending: dict[asyncio.Task, tuple[Any, bool]] = {}

    def launch(self, key, coro, hedged: bool = False) -> asyncio.Task:
        t = asyncio.create_task(coro)
        self.pending[t] = (key, hedged)
        return t

    def take_hedge(self) -> bool:
        """Draw one hedge: per-call budget, then the cluster-wide token
        bucket. A refused token disables hedging for the rest of this
        race (plain waits from here on) — exactly the old inline
        behavior."""
        if not self.hedging or self.hedges >= self.max_hedges:
            return False
        if not self.health.try_take_hedge():
            self.hedging = False
            return False
        self.hedges += 1
        registry().inc("rpc_hedge_launched", endpoint=self.label)
        return True

    async def wait(self, can_hedge: bool, launch_hedge=None,
                   hedge_nodes=None) -> list:
        """One FIRST_COMPLETED round over the pending tasks.

        If nothing lands within the peers' observed-p95 hedge delay and
        a hedge is allowed, launch_hedge() is invoked (after the token
        draw) and [] is returned for this round. Otherwise the
        completed tasks are popped and returned as (key, hedged, task)
        triples — the caller inspects results and reports wins via
        note_success()."""
        can = (self.hedging and can_hedge and launch_hedge is not None
               and self.hedges < self.max_hedges)
        if can:
            nodes = (hedge_nodes if hedge_nodes is not None
                     else [k for k, _ in self.pending.values()])
            timeout = self.health.hedge_delay(nodes)
        else:
            timeout = None
        done, _ = await asyncio.wait(
            self.pending.keys(), return_when=asyncio.FIRST_COMPLETED,
            timeout=timeout,
        )
        if not done:
            # hedge-delay elapsed with everything still in flight:
            # back up (if the global rate cap still has budget)
            if self.take_hedge():
                launch_hedge()
            return []
        out = []
        for t in done:
            key, hedged = self.pending.pop(t)
            out.append((key, hedged, t))
        return out

    def note_success(self, hedged: bool) -> None:
        if hedged and self.health is not None:
            self.health.record_hedge_win()
            registry().inc("rpc_hedge_win", endpoint=self.label)

    def cancel_pending(self, cancel: bool = True) -> None:
        """Consume-then-cancel every straggler (or just consume when
        the caller wants writes to converge in the background)."""
        for t in self.pending:
            # consume first: a task that completed with an error
            # between the last wait and this cleanup is immune to
            # cancel and would log "never retrieved"
            t.add_done_callback(_consume_task_result)
            if cancel:
                t.cancel()


def named_rpc_error(e: Exception, node: bytes, endpoint_path: str) -> RpcError:
    """Wrap a transport/handler error so the surfaced message names the
    peer and endpoint. The original exception rides along as __cause__
    and the structured fields as attributes."""
    who = node.hex()[:8] if node else "?"
    err = RpcError(
        f"{endpoint_path} -> node {who}: {type(e).__name__}: {e}")
    err.node = node
    err.endpoint = endpoint_path
    err.__cause__ = e
    return err


@dataclass
class RequestStrategy:
    """ref: rpc_helper.rs RequestStrategy."""

    quorum: int = 1
    prio: int = PRIO_NORMAL
    timeout: float = DEFAULT_TIMEOUT
    send_all_at_once: bool = False
    interrupt_stragglers: bool = True  # reads cancel; writes let them finish
    # None = the cluster-wide default (PeerHealthTracker.hedging_enabled);
    # True/False forces it for this call (bench A/B, writes that must
    # never duplicate)
    hedge: Optional[bool] = None
    # per-request consistency override: DEGRADED lets THIS
    # read serve from the surviving zones during a zone partition
    # (effective quorum 1) while the cluster default stays consistent;
    # None = use strategy.quorum as given
    consistency: Optional[ConsistencyMode] = None
    # required distinct zones per write set: None = derive from the
    # current layout's zone_redundancy; 0 = skip the check explicitly
    zone_span: Optional[int] = None


class QuorumSetResultTracker:
    """Per-set success/failure accounting over possibly-overlapping quorum
    sets (ref: rpc_helper.rs:665-766)."""

    def __init__(self, sets: list[list[bytes]], quorum: int):
        self.sets = sets
        self.quorum = quorum
        self.nodes: list[bytes] = []
        seen = set()
        for s in sets:
            for n in s:
                if n not in seen:
                    seen.add(n)
                    self.nodes.append(n)
        self.successes: dict[bytes, Any] = {}
        self.failures: dict[bytes, Exception] = {}

    def success(self, node: bytes, resp) -> None:
        self.successes[node] = resp
        # a hedged retry can land after its sibling attempt failed; the
        # key IS written, so the stale failure must not keep counting
        # against the set (a key in both maps inflates the failure
        # count and can raise a spurious QuorumError)
        self.failures.pop(node, None)

    def failure(self, node: bytes, err: Exception) -> None:
        if node not in self.successes:
            self.failures[node] = err

    def set_counts(self) -> list[tuple[int, int]]:
        """(successes, failures) per set."""
        return [
            (
                sum(1 for n in s if n in self.successes),
                sum(1 for n in s if n in self.failures),
            )
            for s in self.sets
        ]

    def all_quorums_ok(self) -> bool:
        return all(ok >= self.quorum for ok, _ in self.set_counts())

    def too_many_failures(self) -> bool:
        return any(
            fail > len(s) - self.quorum
            for s, (_, fail) in zip(self.sets, self.set_counts())
        )

    def quorum_error(self) -> QuorumError:
        return QuorumError(
            quorum=self.quorum,
            sets=len(self.sets),
            ok=len(self.successes),
            total=len(self.nodes),
            errors=[str(e) for e in self.failures.values()],
        )


class RpcHelper:
    def __init__(self, system: System):
        self.system = system
        self.netapp = system.netapp

    def health(self):
        """The shared PeerHealthTracker, or None on bare test stubs."""
        peering = getattr(self.system, "peering", None)
        return getattr(peering, "health", None)

    # ---- node ordering (ref: rpc_helper.rs:621-660) --------------------

    def request_order(self, nodes: list[bytes]) -> list[bytes]:
        """self first; then nodes in partitioned zones last, breaker
        state (open/exhausted peers behind healthy), same-zone, ping.

        The same-zone rank is what makes reads local-zone-FIRST: the
        initial `quorum` launches land in-zone whenever enough local
        replicas exist, and hedges walk the order into other zones only
        when the local ones stall — cross-WAN reads are the fallback,
        not the default. The partitioned-zone rank (zones/health.py)
        exists because a severed link flaps: reconnect succeeds, the
        first frame dies, and for that window conn state + breaker both
        look healthy while every call into the zone will fail."""
        my_zone = None
        role = self.system.layout_helper.current().node_role(self.netapp.id)
        if role is not None:
            my_zone = role.zone
        health = self.health()
        zone_health = getattr(self.system, "zone_health", None)
        dead_zones = (zone_health.partitioned_zones()
                      if zone_health is not None else set())
        now = time.monotonic()

        def key(n: bytes):
            if n == self.netapp.id:
                return (0, 0, 0, 0, 0.0)
            role = self.system.layout_helper.current().node_role(n)
            same_zone = role is not None and my_zone is not None and role.zone == my_zone
            partitioned = (role is not None and bool(role.zone)
                           and role.zone in dead_zones)
            ping = self.system.peering.ping_avg(n)
            connected = self.system.is_up(n)
            brk = health.breaker_rank(n, now) if health is not None else 0
            return (
                1,
                1 if partitioned else 0,
                brk,
                1 if (same_zone and connected) else (2 if connected else 3),
                ping if ping is not None else 1.0,
            )

        return sorted(nodes, key=key)

    # ---- single call ---------------------------------------------------

    async def _tracked_call(
        self,
        endpoint,
        node: bytes,
        payload,
        prio: int,
        timeout: Optional[float],
        stream=None,
    ):
        """endpoint.call with the self-healing bookkeeping: adaptive
        per-peer timeout, half-open probe accounting, success/failure
        recording, and peer+endpoint-named errors. Returns the raw
        (resp, reply_stream) pair."""
        health = self.health()
        if health is not None:
            timeout = health.call_timeout(node, timeout)
            health.note_launch(node)
        t0 = time.monotonic()
        try:
            resp, rstream = await endpoint.call(
                node, payload, prio, stream=stream, timeout=timeout
            )
        except asyncio.CancelledError:
            # a cancelled hedge loser is not a peer failure
            raise
        except Exception as e:
            if health is not None:
                health.record_failure(node, time.monotonic() - t0)
            raise named_rpc_error(e, node, endpoint.path) from e
        if health is not None:
            health.record_success(node, time.monotonic() - t0)
        return resp, rstream

    async def call(
        self,
        endpoint,
        node: bytes,
        payload,
        prio: int = PRIO_NORMAL,
        timeout: float = DEFAULT_TIMEOUT,
        stream=None,
    ):
        resp, rstream = await self._tracked_call(
            endpoint, node, payload, prio, timeout, stream=stream
        )
        return (resp, rstream) if rstream is not None else resp

    # ---- try_call_many (ref: rpc_helper.rs:290-411) --------------------

    async def try_call_many(
        self,
        endpoint,
        nodes: list[bytes],
        payload,
        strategy: RequestStrategy,
        make_payload: Optional[Callable[[bytes], Any]] = None,
    ) -> list:
        """Returns >= quorum successful responses or raises QuorumError.

        With send_all_at_once=False the adaptive send is HEDGED: when no
        in-flight request completes within the peers' observed p95, the
        next-ranked node gets a backup request immediately — a hung peer
        costs one hedge delay, not its whole timeout. First success
        wins; with interrupt_stragglers the losers are cancelled."""
        quorum = strategy.quorum
        if strategy.consistency == ConsistencyMode.DEGRADED and quorum > 1:
            # per-request sloppy read: any one replica answers — the
            # caller chose availability over read-your-writes for THIS
            # request (a zone is partitioned and the consistent quorum
            # would need it)
            registry().inc("rpc_degraded_read", endpoint=endpoint.path)
            quorum = 1
        if quorum > len(nodes):
            raise QuorumError(quorum, 1, 0, len(nodes), ["not enough nodes"])
        order = self.request_order(list(nodes))
        race = HedgedRace(
            self.health(), endpoint.path,
            enabled=(False if strategy.send_all_at_once
                     else strategy.hedge))
        successes: list = []
        errors: list[Exception] = []
        next_i = 0

        def launch_one(hedged: bool = False):
            nonlocal next_i
            node = order[next_i]
            next_i += 1
            pl = make_payload(node) if make_payload else payload
            race.launch(node, self._tracked_call(
                endpoint, node, pl, strategy.prio, strategy.timeout),
                hedged)

        n_initial = len(order) if strategy.send_all_at_once else min(quorum, len(order))
        for _ in range(n_initial):
            launch_one()
        try:
            while len(successes) < quorum:
                if not race.pending:
                    raise QuorumError(
                        quorum, 1, len(successes), len(nodes), [str(e) for e in errors]
                    )
                done = await race.wait(
                    can_hedge=next_i < len(order),
                    launch_hedge=lambda: launch_one(hedged=True))
                for node, hedged, t in done:
                    try:
                        resp, _stream = t.result()
                        successes.append((node, resp))
                        race.note_success(hedged)
                    except Exception as e:
                        errors.append(e)
                        if next_i < len(order):
                            launch_one()
            return [r for _, r in successes]
        finally:
            # interrupt_stragglers: reads cancel the losers; writes are
            # left running so replicas converge — either way the result
            # is consumed so a late failure doesn't log "never
            # retrieved"
            race.cancel_pending(cancel=strategy.interrupt_stragglers)

    # ---- zone-span verification -----------------------------

    def _verify_zone_span(self, endpoint, write_sets, strategy,
                          node_of) -> None:
        """Pre-flight: every write set must span the required number of
        distinct zones, else raise the typed ZoneSpanError BEFORE any
        replica is written. `strategy.zone_span` overrides (0 = skip);
        None derives the requirement from the current layout's
        zone_redundancy. Conservative by design: a set containing a
        node with no zone in the current layout (old-version member
        mid-transition, zoneless test stub) is skipped rather than
        failed — the check exists to catch mis-spread placement, not to
        wedge transitions. A DEGRADED-override write also skips it: the
        caller already chose availability over placement guarantees."""
        if strategy.zone_span == 0 \
                or strategy.consistency == ConsistencyMode.DEGRADED:
            return
        layout = self.system.layout_helper.current()
        required = strategy.zone_span
        if required is None:
            zr = getattr(layout, "zone_redundancy", None)
            if zr == "maximum":
                all_zones = set()
                for n in layout.storage_nodes():
                    role = layout.node_role(n)
                    if role is not None and role.zone:
                        all_zones.add(role.zone)
                required = min(layout.replication_factor, len(all_zones))
            elif isinstance(zr, int):
                required = zr
            else:
                return
        if required <= 1:
            return
        for s in write_sets:
            zones = set()
            for key in s:
                role = layout.node_role(node_of(key))
                if role is None or not role.zone:
                    zones = None
                    break
                zones.add(role.zone)
            if zones is None:
                continue
            if len(zones) < required:
                registry().inc("rpc_zone_span_reject",
                               endpoint=endpoint.path)
                raise ZoneSpanError(required, len(zones), sorted(zones),
                                    len(s))

    # ---- try_write_many_sets (ref: rpc_helper.rs:413-538) --------------

    async def try_write_many_sets(
        self,
        endpoint,
        write_sets: list[list],
        payload,
        strategy: RequestStrategy,
        make_payload: Optional[Callable[[Any], Any]] = None,
        make_stream: Optional[Callable[[Any], Any]] = None,
        make_call: Optional[Callable[[Any], Any]] = None,
    ) -> QuorumSetResultTracker:
        """Write to every set with per-set quorum; left-over requests keep
        running in the background after success (so all replicas converge
        without blocking the caller).

        Set entries are opaque quorum keys — normally node ids, but e.g.
        the erasure block path uses (node, shard_index) tuples with a
        `make_call` that issues the per-key RPC itself.

        strategy.hedge=True opts the write into BACKUP PUSHES: a quorum
        key still unanswered past its holder's observed p95 gets the
        same call re-issued, first landing wins. Only idempotent writes
        may opt in (content-addressed shard/block puts); GL02 flags
        every hedge=True site so the justification is reviewable, and
        the `[rpc] hedge_writes` knob can disable the behavior
        cluster-wide."""
        tracker = QuorumSetResultTracker(write_sets, strategy.quorum)
        if not tracker.nodes:
            # empty/unassigned layout: fail fast instead of hanging on a
            # future no task will ever resolve
            raise tracker.quorum_error()
        result = asyncio.get_event_loop().create_future()
        health = self.health()

        def node_of(key) -> bytes:
            # quorum keys are node ids, or (node, shard_index) tuples on
            # the erasure path
            return key[0] if isinstance(key, tuple) else key

        self._verify_zone_span(endpoint, write_sets, strategy, node_of)

        async def one(key, hedged: bool = False):
            t0 = time.monotonic()
            try:
                if make_call is not None:
                    resp, _ = await make_call(key)
                else:
                    pl = make_payload(key) if make_payload else payload
                    st = make_stream(key) if make_stream else None
                    resp, _ = await endpoint.call(
                        key, pl, strategy.prio, stream=st,
                        timeout=strategy.timeout
                    )
                if health is not None:
                    health.record_success(node_of(key),
                                          time.monotonic() - t0)
                if hedged and key not in tracker.successes:
                    race.note_success(True)
                tracker.success(key, resp)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if health is not None:
                    health.record_failure(node_of(key),
                                          time.monotonic() - t0)
                if not isinstance(e, RpcError) \
                        or not hasattr(e, "node"):
                    e = named_rpc_error(e, node_of(key), endpoint.path)
                # a hedged attempt is a bonus try: its failure must not
                # count against the key while the original is still in
                # flight (same invariant as read hedges — "losers are
                # not counted as failures"), or a fast-failing backup
                # raises a spurious QuorumError on a write the original
                # lands moments later
                if not hedged:
                    tracker.failure(key, e)
            if not result.done():
                if tracker.all_quorums_ok():
                    result.set_result(True)
                elif tracker.too_many_failures():
                    result.set_exception(tracker.quorum_error())

        # writes default to UNHEDGED (hedge=None stays off): only an
        # explicit, GL02-audited hedge=True — and the cluster knob —
        # arm the backup pushes
        race = HedgedRace(
            health, endpoint.path,
            enabled=(strategy.hedge is True and health is not None
                     and health.write_hedging_enabled))

        async def hedge_backups():
            """Re-issue the slowest still-pending write once it is past
            its holder's observed p95 — the write-path analog of the
            read hedge. The re-issued call races its sibling; the
            tracker keeps whichever lands (idempotent by contract)."""
            while not result.done() and race.hedging \
                    and race.hedges < race.max_hedges:
                waiting = [k for k in tracker.nodes
                           if k not in tracker.successes
                           and k not in tracker.failures]
                if not waiting:
                    return
                await asyncio.sleep(
                    health.hedge_delay(node_of(k) for k in waiting))
                if result.done():
                    return
                still = [k for k in waiting
                         if k not in tracker.successes
                         and k not in tracker.failures]
                if not still:
                    continue
                if not race.take_hedge():
                    return
                ht = asyncio.create_task(one(still[0], hedged=True))
                ht._garage_background = True  # same write-behind rule
                tasks.append(ht)

        tasks = [asyncio.create_task(one(n)) for n in tracker.nodes]
        for t in tasks:
            # on quorum success the stragglers deliberately keep
            # writing in the background (write-behind to the rest of
            # the set) — not leaks for the sanitizer
            t._garage_background = True
        hedge_task = (asyncio.create_task(hedge_backups())
                      if race.hedging else None)
        try:
            await result
            return tracker
        except BaseException:
            for t in tasks:
                t.cancel()
            raise
        finally:
            if hedge_task is not None:
                hedge_task.add_done_callback(_consume_task_result)
                hedge_task.cancel()
        # on success, remaining tasks continue in background by design
