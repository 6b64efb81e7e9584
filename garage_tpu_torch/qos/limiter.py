"""Copy of garage_tpu/qos/limiter.py: import paths rewritten, issue and PR tags dropped.

Token buckets, a bounded concurrency gate, and the QosEngine that
composes them into the node's admission-control plane.

Design rules:

  * A limiter NEVER queues unboundedly. Each acquire states the most it
    is willing to wait; if granting would exceed that, the request is
    shed immediately with a `SlowDown` carrying the earliest time a
    retry could succeed (`Retry-After`).
  * Buckets admit debt: a granted-but-waiting acquire subtracts its
    tokens up front (tokens go negative), which makes grants FIFO-fair
    under concurrency without a waiter queue — later acquires see the
    debt and compute a longer wait.
  * Unset limits cost nothing: every check short-circuits on None, so a
    node with no [qos] config behaves exactly as before.

Clock injection (`clock=`) keeps the refill math unit-testable without
sleeping.
"""

from __future__ import annotations

import asyncio
import contextvars
import math
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils import sanitizer

# identity of the request currently executing on this task, set by the
# API frontends once auth resolves (api/s3/api_server.py). Charges deep
# in the stack (block reads, chunk shaping) read it so per-key fairness
# works without threading a key argument through every seam; tasks
# spawned by a request (readahead prefetch) inherit it by contextvar
# copy semantics.
CURRENT_QOS_KEY: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("garage_qos_key", default=None)


class SlowDown(Exception):
    """Admission denied: the caller should retry after `retry_after`
    seconds. API frontends translate this into `503 SlowDown` (S3) /
    a JSON 503 (K2V, admin) with a `Retry-After` header."""

    def __init__(self, retry_after: float, scope: str = "global"):
        self.retry_after = max(retry_after, 0.0)
        self.scope = scope
        super().__init__(
            f"admission denied ({scope}); retry after "
            f"{self.retry_after:.2f}s")

    def header_value(self) -> str:
        # Retry-After is integer seconds; never advertise 0 (clients
        # would busy-spin the shed path)
        return str(max(1, math.ceil(self.retry_after)))


class TokenBucket:
    """Token bucket over an arbitrary unit (requests, bytes).

    `rate` tokens refill per second up to `burst`. acquire(n) grants
    immediately when tokens cover n; otherwise the caller owes a wait of
    deficit/rate seconds — granted (as debt) when within `max_wait`,
    shed otherwise. Single-event-loop discipline: no lock is needed
    because there is no await between the read and the debit.
    """

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.configure(rate, burst)
        sanitizer.track_conservation(self)  # no-op unless armed

    @property
    def conservation_ok(self) -> bool:
        """Clamp invariant: refund/refill can never bank more than one
        burst — a violation means tokens were minted, not returned
        (checked at loop teardown under GARAGE_SANITIZE=1)."""
        return self.tokens <= self.burst * (1 + 1e-9)

    def configure(self, rate: float, burst: Optional[float] = None) -> None:
        """Runtime retune; preserves the current fill fraction so a
        limit change mid-traffic neither forgives debt nor confiscates
        saved burst."""
        old_frac = None
        if getattr(self, "rate", None):
            old_frac = self.tokens / self.burst if self.burst else 1.0
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else float(rate)
        self.tokens = (self.burst if old_frac is None
                       else old_frac * self.burst)
        self._t_last = self.clock()

    def _refill(self) -> None:
        now = self.clock()
        dt = now - self._t_last
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
            self._t_last = now

    def wait_for(self, n: float) -> float:
        """Seconds until n tokens could be granted (0 = grantable now).
        Pure query — does not debit."""
        self._refill()
        if self.tokens >= n:
            return 0.0
        return (n - self.tokens) / self.rate if self.rate > 0 else math.inf

    def try_acquire(self, n: float = 1.0) -> bool:
        """Grant n tokens iff available right now (no debt)."""
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def refund(self, n: float) -> None:
        """Return tokens a multi-stage admission debited before a later
        stage shed the request — the budget must not be consumed by
        work that never happened."""
        self.tokens = min(self.burst, self.tokens + n)

    async def acquire(self, n: float = 1.0, max_wait: float = 0.0,
                      scope: str = "global") -> float:
        """Grant n tokens, sleeping up to max_wait for refill; raises
        SlowDown when the bounded wait would be exceeded. Returns the
        seconds actually waited (0.0 on the fast path)."""
        wait = self.wait_for(n)
        if wait <= 0:
            self.tokens -= n
            return 0.0
        if wait > max_wait:
            raise SlowDown(wait, scope)
        self.tokens -= n  # debt: reserves our slot FIFO-fairly
        try:
            await asyncio.sleep(wait)
        except BaseException:
            # cancelled mid-wait (client gave up): the work never
            # happened, so the reservation must not leak
            self.tokens += n
            raise
        return wait


class ConcurrencyLimiter:
    """Bounded in-flight gate with a bounded wait queue.

    At most `limit` holders; at most `max_queue` waiters beyond that —
    the next arrival is shed with a Retry-After estimated from the
    recent mean hold time (so clients back off roughly one service
    time, not a constant guess).
    """

    def __init__(self, limit: int, max_queue: int = 0):
        self.active = 0
        self._waiters: list[asyncio.Future] = []
        self._hold_ewma = 0.05  # seconds; seeded at a plausible value
        self.configure(limit, max_queue)

    def configure(self, limit: int, max_queue: int = 0) -> None:
        self.limit = int(limit)
        self.max_queue = int(max_queue)
        # a raised limit must take effect NOW, not after the waiter
        # queue happens to drain: hand the new headroom to the queue
        self._wake_waiters()

    def _wake_waiters(self) -> None:
        while self._waiters and self.active < self.limit:
            fut = self._waiters.pop(0)
            if not fut.cancelled():
                self.active += 1  # transfer the slot with the wakeup
                fut.set_result(None)

    @property
    def queued(self) -> int:
        return len(self._waiters)

    async def acquire(self, scope: str = "global") -> None:
        if not self._waiters and self.active < self.limit:
            self.active += 1
            return
        if len(self._waiters) >= self.max_queue:
            # every queued waiter ahead of us needs ~one service time
            raise SlowDown(self._hold_ewma * (len(self._waiters) + 1),
                           scope)
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        try:
            # the slot is transferred INSIDE release() (active stays
            # accounted), so a fast-path arrival in the handoff window
            # can never oversubscribe the limit
            await fut
        except BaseException:
            if fut in self._waiters:
                self._waiters.remove(fut)
            elif fut.done() and not fut.cancelled():
                self.release(0.0)  # slot was handed to us; give it back
            raise

    def release(self, held_seconds: float) -> None:
        if held_seconds > 0:
            self._hold_ewma += 0.2 * (held_seconds - self._hold_ewma)
        self.active -= 1
        self._wake_waiters()


@dataclass
class QosLimits:
    """Runtime-tunable limit set. None disables that limiter."""

    global_rps: Optional[float] = None
    global_burst: Optional[float] = None  # default: 1s of rate
    global_bytes_per_s: Optional[float] = None
    global_bytes_burst: Optional[float] = None
    per_key_rps: Optional[float] = None
    per_bucket_rps: Optional[float] = None
    max_concurrent: Optional[int] = None
    max_queue: int = 64
    # the bounded wait an admission may spend queued before shedding
    max_wait_s: float = 0.5
    # deficit round-robin across per-key queues when the bytes bucket
    # is contended (see DeficitRoundRobin below)
    fair_keys: bool = True

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


# per-key / per-bucket bucket maps are capped; beyond this the
# least-recently-used scope's bucket is dropped (it re-creates full,
# i.e. one free burst — acceptable, bounded memory is not)
SCOPE_CACHE_MAX = 1024


# bounded per-entity shed maps: beyond this many distinct keys/buckets
# new entities aggregate under "(other)" — an attacker spraying key ids
# must not grow operator-facing state without bound
SHED_ENTITY_MAX = 256


@dataclass
class QosCounters:
    admitted: int = 0
    shed: int = 0
    queued_waits: int = 0
    queued_seconds: float = 0.0
    shaped_bytes: int = 0
    # bytes the node was ASKED to move (declared at admission or shaped
    # mid-stream), admitted or not: this is offered load, the demand
    # signal the gateway lease broker rebalances worker budgets by
    offered_bytes: int = 0
    shed_by_scope: dict = field(default_factory=dict)
    # WHO is being shed, not just how much (ROADMAP "503 retry
    # ergonomics"): per-key and per-bucket shed counts, surfaced top-N
    # through GET /v1/qos. Only scoped sheds are attributable — global
    # sheds happen before identity is resolved, by design.
    shed_by_key: dict = field(default_factory=dict)
    shed_by_bucket: dict = field(default_factory=dict)

    def count_entity(self, table: dict, name: str) -> None:
        if name not in table and len(table) >= SHED_ENTITY_MAX:
            name = "(other)"
        table[name] = table.get(name, 0) + 1

    @staticmethod
    def _top(table: dict, n: int) -> list[list]:
        return [[k, v] for k, v in sorted(table.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def to_dict(self, top_n: int = 10) -> dict:
        return {
            "admitted": self.admitted, "shed": self.shed,
            "queued_waits": self.queued_waits,
            "queued_seconds": round(self.queued_seconds, 6),
            "shaped_bytes": self.shaped_bytes,
            "offered_bytes": self.offered_bytes,
            "shed_by_scope": dict(self.shed_by_scope),
            "top_shed_keys": self._top(self.shed_by_key, top_n),
            "top_shed_buckets": self._top(self.shed_by_bucket, top_n),
        }


class DeficitRoundRobin:
    """Per-key fairness inside one shared TokenBucket (Shreedhar &
    Varghese deficit round-robin, applied to the qos bytes budget).

    Uncontended, this is invisible: a submit with no queued work and a
    bucket that can grant right now takes the fast path (one
    try_acquire, no task, no future). Under contention, draws queue
    per-key and a pump task drains the queues round-robin: each sweep
    credits every active key one `quantum` of deficit and releases that
    key's FIFO head(s) while the deficit and the bucket cover them — so
    K backlogged keys each get ~1/K of the drain rate regardless of how
    much one of them has queued (the bounded-share property pinned by
    tests/test_gateway.py).

    Never sheds: shaping applies to requests that were already
    admitted (the concurrency limiter bounds how many of those exist,
    which bounds the queues). Cancellation-safe: a waiter abandoned
    mid-queue is skipped at grant time and its bytes are never drawn.
    `sleep` is injectable so tests drive the pump on a fake clock.
    """

    def __init__(self, bucket: TokenBucket, quantum: float = 64 * 1024,
                 sleep=asyncio.sleep):
        self.bucket = bucket
        self.quantum = float(quantum)
        self.sleep = sleep
        # key -> FIFO of (nbytes, future); OrderedDict = round-robin
        # order (a drained key re-registers at the tail)
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._deficit: dict[str, float] = {}
        self._pump_task: Optional[asyncio.Task] = None
        self.granted = 0
        self.sweeps = 0

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def fair_wait_units(self, key: str) -> float:
        """Tokens a NEW arrival of `key` must expect to see drawn
        before its own grant under round-robin: everything already
        queued for ITS key plus ~one quantum per competing key (one
        rotation round). Deliberately NOT the whole cross-key backlog
        — that is what the round-robin shields the arrival from, and a
        shed estimate priced on it would let one flooding key 503
        every fresh key the DRR would serve almost immediately."""
        q = self._queues.get(key)
        own = sum(n for n, _ in q) if q else 0.0
        others = len(self._queues) - (1 if q else 0)
        return own + others * self.quantum

    async def submit(self, key: str, n: float) -> None:
        if not self._queues and self.bucket.try_acquire(n):
            return  # fast path: no backlog, tokens on hand
        fut = asyncio.get_running_loop().create_future()
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
            self._deficit.setdefault(key, 0.0)
        q.append((float(n), fut))
        if self._pump_task is None or self._pump_task.done():
            from ..utils.background import spawn

            self._pump_task = spawn(self._pump(), "qos-drr-pump")
        try:
            await fut
        except BaseException:
            # abandoned waiter: leave the entry in place (cheap), the
            # pump skips cancelled futures without drawing their bytes
            raise

    async def _pump(self) -> None:
        # rotating round-robin: each iteration visits the HEAD key and
        # moves it to the tail, so after a token-exhaustion sleep the
        # next refill goes to the NEXT key in the circle, not back to
        # the same front-runner — this rotation is what makes one
        # refill-sized trickle still split evenly across keys
        while self._queues:
            key = next(iter(self._queues))
            self._queues.move_to_end(key)
            q = self._queues[key]
            # deficit grows one quantum per visit, capped so an idle
            # spell cannot bank unbounded burst (but always enough to
            # eventually cover the key's largest queued draw)
            self._deficit[key] = min(
                self._deficit[key] + self.quantum,
                self.quantum + max((n for n, _ in q), default=0.0))
            blocked: Optional[float] = None
            while q:
                n, fut = q[0]
                if fut.cancelled():
                    q.popleft()
                    continue
                if n > self._deficit[key]:
                    break  # deficit-capped: more credit next visit
                if not self.bucket.try_acquire(n):
                    blocked = n
                    break
                q.popleft()
                self._deficit[key] -= n
                self.granted += 1
                if not fut.done():
                    fut.set_result(None)
            if not q:
                del self._queues[key]
                del self._deficit[key]
            self.sweeps += 1
            if blocked is not None:
                # out of tokens: sleep until the blocked head could be
                # granted; the rotation already put us at the tail, so
                # the refill is offered to the next key first
                await self.sleep(max(self.bucket.wait_for(blocked),
                                     0.001))


class QosEngine:
    """The node's admission-control plane.

    API frontends call `admit()` (global stage: rps + declared bytes +
    concurrency) around each request and `admit_scoped()` (per-key /
    per-bucket rps) once identity is known. The PUT streaming path
    calls `shape_bytes()` per block for bodies whose length was unknown
    at admission. All stages raise SlowDown on shed.
    """

    def __init__(self, limits: Optional[QosLimits] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.counters = QosCounters()
        self._req_bucket: Optional[TokenBucket] = None
        self._bytes_bucket: Optional[TokenBucket] = None
        self._conc: Optional[ConcurrencyLimiter] = None
        self._key_buckets: dict[str, TokenBucket] = {}
        self._bucket_buckets: dict[str, TokenBucket] = {}
        self._fair: Optional[DeficitRoundRobin] = None
        self._fair_req: Optional[DeficitRoundRobin] = None
        self.limits = QosLimits()
        self.set_limits(limits or QosLimits())

    # ---- configuration -------------------------------------------------

    def set_limits(self, limits: QosLimits) -> None:
        self.limits = limits
        if limits.global_rps is not None:
            burst = limits.global_burst or limits.global_rps
            if self._req_bucket is None:
                self._req_bucket = TokenBucket(limits.global_rps, burst,
                                               clock=self.clock)
            else:
                self._req_bucket.configure(limits.global_rps, burst)
        else:
            self._req_bucket = None
        if limits.global_bytes_per_s is not None:
            burst = limits.global_bytes_burst or limits.global_bytes_per_s
            if self._bytes_bucket is None:
                self._bytes_bucket = TokenBucket(
                    limits.global_bytes_per_s, burst, clock=self.clock)
            else:
                self._bytes_bucket.configure(limits.global_bytes_per_s,
                                             burst)
        else:
            self._bytes_bucket = None
        if self._bytes_bucket is not None and limits.fair_keys:
            if self._fair is None or self._fair.bucket \
                    is not self._bytes_bucket:
                self._fair = DeficitRoundRobin(self._bytes_bucket)
        else:
            self._fair = None
        # per-key DRR for the REQUEST-RATE bucket too (
        # satellite; an earlier change landed the bytes bucket only): same engine,
        # same CURRENT_QOS_KEY identity, quantum = 1 request so
        # backlogged keys alternate grants strictly
        if self._req_bucket is not None and limits.fair_keys:
            if self._fair_req is None or self._fair_req.bucket \
                    is not self._req_bucket:
                self._fair_req = DeficitRoundRobin(self._req_bucket,
                                                   quantum=1.0)
        else:
            self._fair_req = None
        if limits.max_concurrent is not None:
            if self._conc is None:
                self._conc = ConcurrencyLimiter(limits.max_concurrent,
                                                limits.max_queue)
            else:
                self._conc.configure(limits.max_concurrent,
                                     limits.max_queue)
        else:
            self._conc = None
        # retune per-scope buckets in place; drop them when disabled
        if limits.per_key_rps is None:
            self._key_buckets.clear()
        else:
            for b in self._key_buckets.values():
                b.configure(limits.per_key_rps, limits.per_key_rps)
        if limits.per_bucket_rps is None:
            self._bucket_buckets.clear()
        else:
            for b in self._bucket_buckets.values():
                b.configure(limits.per_bucket_rps, limits.per_bucket_rps)

    def update_limits(self, changes: dict) -> None:
        """Partial runtime update (admin `/v1/qos` POST): unknown keys
        raise, `null` clears a limit."""
        cur = self.limits.to_dict()
        for k, v in changes.items():
            if k not in cur:
                raise ValueError(f"unknown qos limit {k!r}")
            cur[k] = v
        lim = QosLimits(**cur)
        if lim.max_wait_s is None or lim.max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        self.set_limits(lim)

    # ---- admission stages ----------------------------------------------

    def _record_shed(self, scope: str) -> None:
        self.counters.shed += 1
        by = self.counters.shed_by_scope
        by[scope] = by.get(scope, 0) + 1
        from ..utils.metrics import registry

        registry().inc("qos_shed_requests", scope=scope)

    def _record_wait(self, waited: float) -> None:
        if waited > 0:
            self.counters.queued_waits += 1
            self.counters.queued_seconds += waited

    def admit(self, api: str, nbytes: Optional[int] = None) -> "_Admission":
        """Global stage: `async with qos.admit("s3", nbytes): ...` —
        rps + declared-bytes buckets on enter, the concurrency slot
        held for the request's lifetime."""
        return _Admission(self, api, nbytes)

    async def _admit_request(self, lim: QosLimits) -> float:
        """Global request-rate draw. With `fair_keys` on and a request
        identity in hand (the S3/K2V frontends seed CURRENT_QOS_KEY
        from the request's CLAIMED key id before admission — fairness
        needs a stable queue key, not a verified one; enforcement
        still uses the verified identity in admit_scoped), contended
        grants drain through the per-key deficit round-robin: K
        backlogged keys each get ~1/K of the request rate instead of
        whoever queued first. The bounded-wait shed contract is
        unchanged — the estimated wait (bucket deficit plus the fair
        queue ahead of us) beyond max_wait_s sheds immediately.
        Returns seconds waited."""
        b = self._req_bucket
        fair = self._fair_req
        key = CURRENT_QOS_KEY.get() if fair is not None else None
        if fair is None or key is None:
            return await b.acquire(1.0, max_wait=lim.max_wait_s,
                                   scope="global")
        # shed bound priced at what ROUND-ROBIN will actually make this
        # arrival wait (its own key's queue + one rotation), not the
        # whole cross-key backlog — a flooding key throttles itself at
        # the bound while a fresh key still admits
        wait = b.wait_for(1.0 + fair.fair_wait_units(key))
        if wait > lim.max_wait_s:
            raise SlowDown(wait, "global")
        t0 = self.clock()
        await fair.submit(key, 1.0)
        return self.clock() - t0

    async def admit_scoped(self, key_id: Optional[str] = None,
                           bucket: Optional[str] = None) -> None:
        """Per-key / per-bucket request-rate stage (called once auth and
        bucket resolution are done)."""
        lim = self.limits
        kb = None
        try:
            if key_id is not None and lim.per_key_rps is not None:
                kb = self._scope_bucket(self._key_buckets, key_id,
                                        lim.per_key_rps)
                self._record_wait(await kb.acquire(
                    1.0, max_wait=lim.max_wait_s, scope="key"))
            if bucket is not None and lim.per_bucket_rps is not None:
                b = self._scope_bucket(self._bucket_buckets, bucket,
                                       lim.per_bucket_rps)
                try:
                    self._record_wait(await b.acquire(
                        1.0, max_wait=lim.max_wait_s, scope="bucket"))
                except SlowDown:
                    if kb is not None:
                        kb.refund(1.0)  # key grant unused: hand it back
                    raise
        except SlowDown as e:
            self._record_shed(e.scope)
            # attribute the shed to the identity it hit: both entities
            # recorded when known — "this key is being shed on this
            # bucket" is exactly what the operator is debugging
            if key_id is not None:
                self.counters.count_entity(self.counters.shed_by_key,
                                           key_id)
            if bucket is not None:
                self.counters.count_entity(self.counters.shed_by_bucket,
                                           bucket)
            raise

    def _scope_bucket(self, cache: dict, key: str,
                      rate: float) -> TokenBucket:
        b = cache.pop(key, None)
        if b is None:
            b = TokenBucket(rate, rate, clock=self.clock)
            if len(cache) >= SCOPE_CACHE_MAX:
                cache.pop(next(iter(cache)))
        cache[key] = b  # re-insert = move to MRU position
        return b

    async def shape_bytes(self, n: int, key: Optional[str] = None) -> None:
        """Mid-stream byte shaping for bodies whose length was unknown
        at admission (chunked uploads) and for block reads served from
        cache or store: never sheds — the request was already accepted
        and aborting it would waste the work done — it just slows the
        read loop to the configured byte rate.

        With `fair_keys` on and an identity in hand (the `key` argument
        or the request's CURRENT_QOS_KEY contextvar), contended draws
        go through the deficit round-robin so every active key gets an
        equal share of the drain instead of whoever queued first."""
        b = self._bytes_bucket
        if b is None or n <= 0:
            return
        self.counters.shaped_bytes += n
        self.counters.offered_bytes += n
        fair = self._fair
        if fair is not None:
            if key is None:
                key = CURRENT_QOS_KEY.get()
            if key is not None:
                await fair.submit(key, float(n))
                return
        wait = b.wait_for(float(n))
        b.tokens -= float(n)
        if wait > 0:
            await asyncio.sleep(wait)

    # ---- surface -------------------------------------------------------

    def state(self) -> dict:
        return {
            "limits": self.limits.to_dict(),
            "counters": self.counters.to_dict(),
            "in_flight": self._conc.active if self._conc else None,
            "queued": self._conc.queued if self._conc else None,
        }


class _Admission:
    """Context manager: rps + declared-bytes buckets on enter, the
    concurrency slot held until exit."""

    __slots__ = ("eng", "api", "nbytes", "_holding", "_t0")

    def __init__(self, eng: QosEngine, api: str, nbytes: Optional[int]):
        self.eng = eng
        self.api = api
        self.nbytes = nbytes
        self._holding = False

    async def __aenter__(self):
        eng, lim = self.eng, self.eng.limits
        from ..utils.metrics import registry

        # offered load is counted whether or not admission succeeds:
        # the gateway lease broker rebalances worker budgets by what
        # was ASKED of each worker, and a shedding worker is exactly
        # the one whose lease needs to grow
        if self.nbytes:
            eng.counters.offered_bytes += self.nbytes
        # stages debited so far, refunded when a LATER stage sheds —
        # a rejected request must not consume the budgets it passed
        debits: list = []
        try:
            if eng._req_bucket is not None:
                eng._record_wait(await eng._admit_request(lim))
                debits.append((eng._req_bucket, 1.0))
            if eng._bytes_bucket is not None and self.nbytes:
                eng._record_wait(await eng._bytes_bucket.acquire(
                    float(self.nbytes), max_wait=lim.max_wait_s,
                    scope="bytes"))
                debits.append((eng._bytes_bucket, float(self.nbytes)))
            if eng._conc is not None:
                await eng._conc.acquire(scope="concurrency")
                self._holding = True
        except SlowDown as e:
            for bucket, n in debits:
                bucket.refund(n)
            eng._record_shed(e.scope)
            raise
        self._t0 = time.perf_counter()
        eng.counters.admitted += 1
        registry().inc("qos_admitted_requests", api=self.api)
        return self

    async def __aexit__(self, *exc):
        if self._holding:
            self.eng._conc.release(time.perf_counter() - self._t0)
        return False
