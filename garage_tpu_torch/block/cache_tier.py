"""Copy of garage_tpu/block/cache_tier.py: import paths rewritten, issue and PR tags dropped.

Cluster-wide read cache tier: turn N node-local decoded-
block caches into ONE cluster cache.

an earlier change gave every node a decoded-block cache and an earlier change sharded it across
gateway workers — but both stop at the process/node boundary, so N
cluster nodes still pay N cold erasure decodes (k-shard gather +
GF(2^8) matmul + verify) for the same hot block and hold N duplicate
copies. This module is the cross-NODE lane:

  * **Owner routing** — every cacheable block hash has one OWNER node,
    chosen by rendezvous hashing (gateway/ring.py's weight function,
    shared so the worker and cluster layers can never disagree) over
    the roster, FILTERED through the shared PeerHealthTracker: a node
    whose circuit breaker is open drops out of the ring, so a degraded
    owner remaps its share to the next-highest weight instead of
    blackholing reads (Karger et al., "Web Caching with Consistent
    Hashing"). The roster is PER ZONE: a storage node's
    ring is the current layout's storage nodes IN ITS OWN ZONE, so a
    hot-block probe is an intra-zone hop, never a cross-WAN one, and a
    cold zone warms from its own decode instead of a cross-zone shm
    miss. Each zone therefore holds one decoded copy of its hot set —
    deliberate: a WAN round-trip costs more than the decode it would
    save, and a zone partition must not sever the cache lane. A node
    with NO zone (gateway worker, zoneless test rig) falls back to the
    global ring, which is also the pre-zone behavior when every node
    shares one zone.
  * **Single-hop probe** — a non-owner read first issues
    `rpc_cache_probe` to the owner: a read-only, hedge-safe op that
    answers from the owner's RAM cache and NEVER touches the store
    (one hop by construction, no probe chains). A hit returns the
    decoded payload — zero shard gathers and zero decodes anywhere in
    the cluster — verified against the content address before it is
    served, the same end-to-end integrity rule as every other remote
    read. A miss (or an unreachable owner) falls back to today's local
    path, and the decoded result is then write-through-inserted AT THE
    OWNER (`rpc_cache_insert`, background, bounded in flight) so the
    next reader cluster-wide wins. Non-owners do not fill their local
    cache — one decoded copy per cluster, not per node.
  * **Hot-hash hints** — each node's top-N cache keys by hit count
    (BlockCache.top_keys) piggyback on the existing peering pings
    (net/peering.py hint hooks; ~32 B per hash, bounded both ways).
    Hints are INTRA-ZONE like the ring: a hint arriving
    from a peer in another zone is dropped on receipt, so is_hot()
    reflects this ZONE's hot set and a background probe gated on it
    never targets a cross-WAN owner.
    The hint set tells BACKGROUND readers which blocks are worth a
    probe: resync's replicate fetches route through the tier only for
    hinted-hot hashes, so a rebalance enumeration of a million cold
    blocks never sprays a million wasted probe RPCs (the
    lease/hint-based hot-set placement shape of Nishtala et al.,
    NSDI'13).

an earlier change adds the COLD-herd machinery on top of the hot-path routing:

  * **Probe singleflight leases** — a probe that misses at the owner
    MINTS a lease (ProbeLeaseTable): the first prober becomes the
    holder, decodes via its store path and write-through-inserts;
    every concurrent prober — remote via the `cache_probe` wait-mode,
    local via the owner's own lease check in rpc_get_block — parks on
    the owner for a bounded wait (`[block] cache_lease_wait_ms`) and
    is woken by the insert's arrival. The wait is budgeted INSIDE the
    probe's flat PROBE_TIMEOUT_S, never stacked on top, so a dead or
    blackholed lease holder can never push a GET past the pre-lease
    worst case: waiters time out, fall back to the store path, and
    the expired lease is reaped. This is the memcache lease shape of
    Nishtala et al. (NSDI'13) on the rendezvous ring — a cold flash
    crowd pays O(blocks) decodes cluster-wide, not O(blocks x nodes).
  * **Hint-driven prefetch** — the owner ACTS on an inbound hint for a
    block it doesn't hold: a bounded background queue decodes it ahead
    of the herd (<= `[block] cache_prefetch_inflight` concurrent, one
    governor-paced sleep per fetch), converting the first herd into a
    warm probe hit. Hints are zone-filtered BEFORE the prefetch
    trigger sees them, and the fetch itself is the owner's local store
    path — prefetch can neither be triggered by nor fetch across a
    zone boundary.
  * **Packed-bytes segment** — a second byte-budgeted cache
    (`manager.packed_cache`, keyed (hash, kind=packed)) holding the
    EXACT on-disk packed bytes an erasure decode reassembles. That
    dissolves the old byte-deterministic-recompression restriction:
    shard rebuilds (`resync._rebuild_shard`) and scrub stripe repairs
    re-encode straight from cached packed bytes — zero shard-gather
    RPCs on a warm rebuild — and degraded GETs serve from it before
    gathering. Probes carry a `kinds` list so one RPC checks both
    segments; the packed segment rides the same zone ring.

What deliberately does NOT route through the tier: SSE-C payloads
(`cacheable=False` skips lookup, probe, lease and insert end to end —
the GL03 taint rule audits the `cache_tier_probe`/`cache_tier_insert`
seam, `probe_full` included); and scrub's VERIFY passes (their whole
job is to touch the disks the cache exists to avoid — only the repair
leg, which needs ground-truth packed bytes, rides the tier).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict
from typing import Optional

from ..gateway.ring import rendezvous_owner
from ..net.message import PRIO_BACKGROUND, PRIO_NORMAL
from ..utils.metrics import registry

log = logging.getLogger("garage_tpu_torch.block.cache_tier")

# hints remembered per node (hash -> last-seen monotonic time); beyond
# this the oldest hint is dropped — an attacker-spun key space must not
# grow this map without bound
HINT_MAX = 1024
HINT_TTL_S = 120.0
# hashes carried per ping (outbound) and accepted per ping (inbound)
HINT_TOP_N = 16
HINT_ACCEPT_MAX = 64
# a probe is a RAM lookup plus one payload transfer; the flat budget
# is deliberately TIGHT so a blackholed owner (no RST, packets
# dropped) costs foreground GETs seconds — not tens of seconds — for
# the handful of failures it takes to open its breaker and drop it
# out of the ring. The rpc helper's adaptive per-peer timeout
# (clamp(p99*4), floor 1 s) tightens under this once samples exist; a
# legitimately slow transfer that gets cut off just falls back to the
# local decode path, which is the safe direction.
PROBE_TIMEOUT_S = 2.0
# concurrent background owner-insert pushes; beyond this the push is
# skipped (the next reader warms the owner instead) — a decode burst
# must not turn into an unbounded RPC fan-out of MiB-scale payloads
INSERT_INFLIGHT_MAX = 8
# lease wait default (`[block] cache_lease_wait_ms`): ≈ the observed
# p95 of a 1 MiB erasure gather+decode on the loopback bench — long
# enough that the holder's insert usually lands, short enough that a
# dead holder costs less than the decode the wait tried to save
LEASE_WAIT_MS_DEFAULT = 250.0
# a lease the holder never resolves expires after this multiple of the
# wait bound: waiters have all timed out by then, and the NEXT prober
# must be able to mint a fresh lease instead of parking forever behind
# a corpse
LEASE_TTL_FACTOR = 4.0
# leases outstanding per owner; beyond this a miss answers plainly (no
# lease, no wait) — an attacker-spun key space must not grow the table
LEASE_MAX = 512
# the lease wait must fit INSIDE the probe's flat timeout with room
# for the transfer of the woken payload — a wait that consumed the
# whole RPC budget would turn every wake into a caller-side timeout,
# stacking the wait on top of the budget instead of inside it
PROBE_WAIT_MARGIN_S = 0.5
# hint-driven prefetch: queue bound and per-fetch governor pacing cap
PREFETCH_QUEUE_MAX = 64
PREFETCH_INFLIGHT_DEFAULT = 2


class _Lease:
    __slots__ = ("holder", "deadline", "event")

    def __init__(self, holder: bytes, deadline: float):
        self.holder = holder
        self.deadline = deadline
        self.event = asyncio.Event()


class ProbeLeaseTable:
    """Owner-side singleflight ledger: one live lease per missing hash.

    The first prober to miss mints (becoming the holder); concurrent
    probers park on the lease's event with a bounded wait and re-check
    the cache on wake. The holder's write-through insert resolves the
    lease; a holder that dies (SIGKILL, cancel, partition) simply never
    resolves, waiters time out within their own budget, and the lease
    is reaped at its TTL so the next prober re-mints.

    Conservation invariant (GARAGE_SANITIZE=1, checked at every loop
    teardown): no waiter stays parked once the handlers that parked it
    completed, and every minted lease is accounted resolved, expired,
    or still live — a leak here means probers parking forever behind a
    lease nobody can resolve."""

    def __init__(self, wait_ms: float = LEASE_WAIT_MS_DEFAULT):
        self.wait_ms = float(wait_ms)
        self._leases: dict[bytes, _Lease] = {}
        self._waiters = 0
        self.minted = 0
        self.resolved = 0
        self.expired = 0
        self.waits = 0
        self.wait_hits = 0
        self.wait_timeouts = 0
        from ..utils import sanitizer

        sanitizer.track_conservation(self)  # no-op unless armed

    @property
    def depth(self) -> int:
        return len(self._leases)

    @property
    def ttl_s(self) -> float:
        return max(0.05, self.wait_ms / 1000.0 * LEASE_TTL_FACTOR)

    def _reap(self, now: float) -> None:
        for h in [h for h, ls in self._leases.items()
                  if ls.deadline <= now]:
            ls = self._leases.pop(h)
            ls.event.set()  # wake anyone parked behind the corpse
            self.expired += 1
            registry().inc("cache_lease_expired")

    def live(self, hash32: bytes) -> bool:
        self._reap(time.monotonic())
        return hash32 in self._leases

    def mint(self, hash32: bytes, holder: bytes) -> bool:
        """True when the caller became the lease holder (no live lease
        existed and the table had room). Synchronous — no await between
        the live check and the insert, so concurrent probe handlers on
        one loop elect exactly one holder."""
        now = time.monotonic()
        self._reap(now)
        if hash32 in self._leases or len(self._leases) >= LEASE_MAX \
                or self.wait_ms <= 0:
            return False
        self._leases[hash32] = _Lease(holder, now + self.ttl_s)
        self.minted += 1
        registry().inc("cache_lease_minted")
        return True

    def resolve(self, hash32: bytes) -> None:
        """The awaited bytes arrived (owner-side insert): wake every
        parked prober. No-op without a live lease."""
        ls = self._leases.pop(hash32, None)
        if ls is not None:
            ls.event.set()
            self.resolved += 1
            registry().inc("cache_lease_resolved")

    async def wait(self, hash32: bytes, wait_s: float) -> bool:
        """Park behind the live lease for at most wait_s; -> True when
        woken by a resolve (the caller re-checks the cache), False on
        timeout or when no lease is live (mint raced away / already
        resolved — re-check either way, the cache is the truth)."""
        ls = self._leases.get(hash32)
        if ls is None or wait_s <= 0:
            return False
        self.waits += 1
        registry().inc("cache_lease_wait")
        self._waiters += 1
        try:
            await asyncio.wait_for(ls.event.wait(), wait_s)
            self.wait_hits += 1
            registry().inc("cache_lease_wait_hit")
            return True
        except asyncio.TimeoutError:
            self.wait_timeouts += 1
            registry().inc("cache_lease_wait_timeout")
            self._reap(time.monotonic())
            return False
        finally:
            self._waiters -= 1

    @property
    def conservation_ok(self) -> bool:
        self._reap(time.monotonic())
        return (self._waiters == 0
                and self.minted == self.resolved + self.expired
                + len(self._leases))

    def __repr__(self) -> str:
        return (f"<ProbeLeaseTable depth={len(self._leases)} "
                f"waiters={self._waiters} minted={self.minted} "
                f"resolved={self.resolved} expired={self.expired}>")


class ProbeResult:
    """One probe's answer across both segments + the lease verdict."""

    __slots__ = ("plain", "packed", "lease", "timed_out")

    def __init__(self, plain=None, packed=None, lease=False,
                 timed_out=False):
        self.plain = plain        # decoded payload (verified) or None
        self.packed = packed      # exact on-disk packed bytes or None
        self.lease = lease        # this prober holds the decode lease
        self.timed_out = timed_out  # parked behind a lease, then lost


class ClusterCacheTier:
    """Router + hint book installed on BlockManager (`manager.cache_tier`)
    when `[block] cache_tier` is on and the node has a cluster system."""

    def __init__(self, manager, hint_top_n: int = HINT_TOP_N,
                 lease_wait_ms: float = LEASE_WAIT_MS_DEFAULT,
                 prefetch_inflight: int = PREFETCH_INFLIGHT_DEFAULT):
        self.manager = manager
        self.enabled = True
        self.hint_top_n = int(hint_top_n)
        # hash -> last-seen time, LRU-ordered (move_to_end on refresh)
        self._hints: "OrderedDict[bytes, float]" = OrderedDict()
        self._insert_inflight = 0
        # owner-side singleflight leases (`[block] cache_lease_wait_ms`;
        # 0 disables the wait-mode entirely — probes answer flat misses)
        self.leases = ProbeLeaseTable(lease_wait_ms)
        # hint-driven prefetch: bounded FIFO of owned-but-cold hinted
        # hashes, drained by <= prefetch_inflight background tasks, one
        # governor-paced sleep per fetch (qos/governor.py writes
        # prefetch_tranquility the same way it writes resync/scrub
        # tranquility)
        self.prefetch_inflight = max(0, int(prefetch_inflight))
        self.prefetch_tranquility = 0.0
        self._prefetch_q: "OrderedDict[bytes, None]" = OrderedDict()
        self._prefetch_running = 0
        self.prefetched = 0
        self.prefetch_skips = 0
        self.prefetch_drops = 0
        self.prefetch_errors = 0
        self.probes = 0
        self.probe_hits = 0
        self.probe_misses = 0
        self.probe_fails = 0
        self.probe_corrupt = 0
        self.probe_packed_hits = 0
        self.lease_grants = 0
        self.lease_wait_hits = 0
        self.lease_wait_timeouts = 0
        self.remote_hit_bytes = 0
        self.inserts_pushed = 0
        self.insert_skips = 0
        self.hints_sent = 0
        self.hints_seen = 0
        self.cross_zone_probes = 0
        self.hints_dropped_cross_zone = 0

    @property
    def lease_wait_ms(self) -> float:
        return self.leases.wait_ms

    @lease_wait_ms.setter
    def lease_wait_ms(self, v: float) -> None:
        self.leases.wait_ms = float(v)

    def probe_wait_ms(self) -> float:
        """The wait a prober may ask the owner for: the configured
        lease wait, clamped INSIDE the flat probe timeout minus the
        transfer margin — the satellite contract that a blackholed
        lease holder can never push a GET past the pre-lease worst
        case (probe timeout + one store read)."""
        budget = (PROBE_TIMEOUT_S - PROBE_WAIT_MARGIN_S) * 1000.0
        return max(0.0, min(self.leases.wait_ms, budget))

    # ---- ring -----------------------------------------------------------

    def _health(self):
        return self.manager.rpc.health()

    def _zone_of(self, node: bytes) -> Optional[str]:
        role = self.manager.system.layout_helper.current().node_role(node)
        if role is None or not role.zone:
            return None
        return role.zone

    def members(self) -> list[bytes]:
        """Live ring membership: the current layout's storage nodes IN
        THIS NODE'S ZONE (the whole cluster when this node has no zone
        — gateway worker, zoneless rig; with every node in one zone the
        two are the same roster), minus open-breaker peers (a degraded
        owner drops OUT of the ring — its share remaps — instead of
        blackholing probes). Breaker state is a local observation, so
        two nodes can briefly disagree on ownership while a breaker is
        open; the tier is a cache, so the cost is a duplicate fill,
        never a wrong answer. Zone membership comes from the shared
        layout, so all nodes of a zone DO agree on the zone roster."""
        system = self.manager.system
        me = system.id
        nodes = sorted(
            system.layout_helper.current().storage_nodes())
        my_zone = self._zone_of(me)
        if my_zone is not None:
            # per-zone ring: hot-block probes stay
            # intra-zone; a zoneless node in the roster is unreachable
            # as "same zone" and drops out too
            nodes = [n for n in nodes
                     if n == me or self._zone_of(n) == my_zone]
        health = self._health()
        if health is None:
            return nodes
        now = time.monotonic()
        return [n for n in nodes
                if n == me or health.breaker_state(n, now) != "open"]

    def owner_of(self, hash32: bytes) -> Optional[bytes]:
        """Remote owner to probe, or None when this node should serve
        locally (it owns the hash, routing is moot, or the tier is
        off). A node OUTSIDE the roster (gateway worker, draining node)
        still probes owners — it just never owns anything itself."""
        if not self.enabled or self.manager.cache.max_bytes <= 0:
            return None
        members = self.members()
        me = self.manager.system.id
        if not members or (len(members) == 1 and members[0] == me):
            return None
        owner = rendezvous_owner(members, hash32)
        if owner is None or owner == me:
            return None
        return owner

    def local_owner(self, hash32: bytes) -> bool:
        """True when a real multi-node ring elects THIS node the
        hash's cache owner — the gateway-worker shortcut's test: a
        local GET on the owner can serve straight from its own cache
        ring slot instead of paying a loopback router hop. Distinct
        from owns(): moot routing (tier off, lone member) is False
        here — the shortcut only fires when the ring genuinely routed
        the hash home."""
        if not self.enabled or self.manager.cache.max_bytes <= 0:
            return False
        members = self.members()
        if len(members) < 2:
            return False
        return rendezvous_owner(members, hash32) == self.manager.system.id

    def owns(self, hash32: bytes) -> bool:
        """Whether this node should hold the cached copy (True when
        routing is moot — an unrouted cache owns everything it sees)."""
        if not self.enabled or self.manager.cache.max_bytes <= 0:
            return True
        members = self.members()
        if len(members) < 2:
            return True
        owner = rendezvous_owner(members, hash32)
        return owner is None or owner == self.manager.system.id

    # ---- probe / insert (the cross-node seam) ---------------------------

    async def probe(self, owner: bytes, hash32: bytes,
                    cacheable: bool = True) -> Optional[bytes]:
        """Single-hop read-only probe of the owner's DECODED cache; ->
        decoded payload (content-verified) or None (miss / owner
        unreachable / failed verification). Never raises: a tier
        failure must degrade to the local path, not fail the read.
        `cacheable` is the same GL03 audit flag as the rpc_get_block
        seam — SSE-C state must pass cacheable=False, which makes the
        probe a no-op (an SSE-C hash is never even ASKED about across
        nodes). Lease-free and plain-only: the background callers
        (hint-gated resync) must not park behind a foreground herd's
        lease; the GET path's full form is probe_full."""
        res = await self.probe_full(owner, hash32, cacheable=cacheable,
                                    kinds=("plain",), wait=False)
        return res.plain

    async def probe_packed(self, owner: bytes,
                           hash32: bytes) -> Optional[bytes]:
        """Exact on-disk packed bytes from the owner's packed segment,
        or None — the rebuild/repair lane (verified by unpack+content
        check before returning). Lease-free: rebuilds are background
        work and fall straight back to the shard gather."""
        res = await self.probe_full(owner, hash32, cacheable=True,
                                    kinds=("packed",), wait=False)
        return res.packed

    async def probe_full(self, owner: bytes, hash32: bytes,
                         cacheable: bool = True,
                         kinds=("plain",), wait: bool = True
                         ) -> ProbeResult:
        """One probe RPC across the owner's requested segments, with
        the lease protocol engaged when `wait` is True:

          * a hit answers (plain or packed — packed is unpacked and
            verified here, so .plain is served either way);
          * a miss with no live lease MINTS one for this prober
            (.lease=True: the caller MUST decode and write-through,
            that insert is what wakes the parked herd);
          * a miss behind a live lease PARKS at the owner for at most
            probe_wait_ms() — budgeted inside the flat RPC timeout,
            never stacked — then re-checks; a timeout answers
            .timed_out=True and the caller falls back to the store
            WITHOUT pushing (the holder's insert is presumed in
            flight; N more MiB pushes are the waste leases kill).

        Never raises. `cacheable` is the GL03 audit flag; SSE-C state
        passes cacheable=False and nothing crosses the wire."""
        if not cacheable:
            return ProbeResult()
        self.probes += 1
        m = self.manager
        my_zone = self._zone_of(m.system.id)
        if my_zone is not None and self._zone_of(owner) != my_zone:
            # the per-zone ring makes this structurally unreachable for
            # storage nodes; the counter is the drill's assertion that
            # it STAYS that way (a regression here turns every hot read
            # into a WAN round-trip)
            self.cross_zone_probes += 1
            registry().inc("cache_tier_cross_zone_probe")
        wait_ms = self.probe_wait_ms() if wait else 0.0
        try:
            resp = await m.rpc.call(
                m.endpoint, owner,
                {"op": "cache_probe", "hash": hash32,
                 "kinds": list(kinds), "wait_ms": wait_ms,
                 "lease": bool(wait and wait_ms > 0)},
                PRIO_NORMAL, timeout=PROBE_TIMEOUT_S)
            if not isinstance(resp, dict):
                resp = {}
            data = resp.get("data")
        except Exception as e:
            self.probe_fails += 1
            registry().inc("cache_tier_probe_fail")
            log.debug("cache probe of %s at %s failed: %s",
                      hash32[:4].hex(), owner[:4].hex(), e)
            return ProbeResult()
        if data is None:
            self.probe_misses += 1
            registry().inc("cache_tier_probe_miss")
            if resp.get("lease"):
                self.lease_grants += 1
                registry().inc("cache_lease_granted")
                return ProbeResult(lease=True)
            if resp.get("waited"):
                self.lease_wait_timeouts += 1
                return ProbeResult(timed_out=True)
            return ProbeResult()
        kind = resp.get("kind", "plain")
        verified = await asyncio.to_thread(self._verify_probe, data,
                                           hash32, kind)
        if verified is None:
            self.probe_corrupt += 1
            registry().inc("cache_tier_probe_corrupt")
            log.warning("cache probe of %s at %s returned corrupt "
                        "%s payload; falling back to the store",
                        hash32[:4].hex(), owner[:4].hex(), kind)
            return ProbeResult()
        if resp.get("waited"):
            self.lease_wait_hits += 1
        self.probe_hits += 1
        if kind == "packed":
            self.probe_packed_hits += 1
            registry().inc("cache_tier_probe_packed_hit")
        self.remote_hit_bytes += len(data)
        registry().inc("cache_tier_probe_hit")
        registry().inc("cache_tier_remote_hit_bytes", len(data))
        if kind == "packed":
            return ProbeResult(plain=verified, packed=data)
        return ProbeResult(plain=data)

    @staticmethod
    def _verify_probe(data, hash32: bytes, kind: str):
        """End-to-end integrity off-loop: a remote payload is served
        only after it re-derives the content address (the store read
        paths all verify remote bytes; the tier must not be the one
        lane that trusts the wire). -> the decoded plain payload, or
        None on verification failure. Packed bytes verify through
        unpack + DataBlock.verify — the content address covers the
        plain bytes, so the unpack is the verification."""
        try:
            if kind == "packed":
                from .block import DataBlock

                blk = DataBlock.unpack(data)
                blk.verify(hash32)
                return blk.plain_bytes()
            from ..utils.data import content_hash_matches

            return data if content_hash_matches(data, hash32) else None
        except Exception as e:
            log.debug("probe payload failed %s verification for %s: %s",
                      kind, hash32[:4].hex(), e)
            return None

    def insert_at(self, owner: bytes, hash32: bytes, data,
                  kind: str = "plain") -> None:
        """Write-through at the owner after a local miss-decode: fire a
        bounded background push so the NEXT reader — on any node —
        probe-hits instead of re-decoding. Never blocks the caller.
        kind="packed" targets the owner's packed-bytes segment (exact
        on-disk bytes; the rebuild/repair lane's currency)."""
        if self._insert_inflight >= INSERT_INFLIGHT_MAX:
            self.insert_skips += 1
            return
        self._insert_inflight += 1
        from ..utils.background import spawn

        spawn(self._push_insert(owner, hash32, data, kind),
              "cache-tier-insert")

    async def _push_insert(self, owner: bytes, hash32: bytes,
                           data, kind: str = "plain") -> None:
        # background lane: a MiB-scale push over a slow link may
        # legitimately outlive the tight foreground probe budget
        m = self.manager
        try:
            await m.endpoint.call(
                owner, {"op": "cache_insert", "hash": hash32,
                        "data": data, "kind": kind},
                PRIO_BACKGROUND, timeout=15.0)
            self.inserts_pushed += 1
            registry().inc("cache_tier_insert_push")
        except Exception as e:
            log.debug("cache insert push of %s to %s failed: %s",
                      hash32[:4].hex(), owner[:4].hex(), e)
        finally:
            self._insert_inflight -= 1

    # ---- hot-hash hints (peering ping piggyback) ------------------------

    def hot_hashes(self) -> list[bytes]:
        """Outbound hint payload: this node's hottest cached hashes."""
        out = self.manager.cache.top_keys(self.hint_top_n) \
            if self.enabled else []
        self.hints_sent += len(out)
        return out

    def note_hints(self, from_node: bytes, hashes) -> None:
        """Inbound hints from a peer's ping. Bounded both ways: at most
        HINT_ACCEPT_MAX per ping, at most HINT_MAX remembered. Filtered
        to THIS zone on receipt (the outbound ping payload is shared by
        all peers, so the receive side is where intra-zone hint gossip
        is enforced): another zone's hot set must not make is_hot()
        send our background reads probing across the WAN."""
        my_zone = self._zone_of(self.manager.system.id)
        if my_zone is not None and self._zone_of(from_node) != my_zone:
            self.hints_dropped_cross_zone += 1
            registry().inc("cache_tier_hint_drop_cross_zone")
            return
        now = time.monotonic()
        for h in list(hashes)[:HINT_ACCEPT_MAX]:
            if not isinstance(h, bytes) or len(h) != 32:
                continue
            self._hints[h] = now
            self._hints.move_to_end(h)
            self.hints_seen += 1
            # prefetch trigger sits AFTER the zone filter above, so a
            # cross-zone hint can never reach it — and the fetch itself
            # is this node's own store path, so nothing is fetched
            # across a zone boundary either (satellite conformance)
            self._maybe_prefetch(h)
        while len(self._hints) > HINT_MAX:
            self._hints.popitem(last=False)

    # ---- hint-driven prefetch --------------------------------

    def _maybe_prefetch(self, hash32: bytes) -> None:
        """A peer says hash32 is hot; if WE own it and don't hold it,
        queue a background decode so the first herd probe-hits instead
        of minting a lease. Queue is bounded (drops counted), drained
        by <= prefetch_inflight tasks, each fetch governor-paced."""
        if self.prefetch_inflight <= 0 or not self.enabled:
            return
        if not self.local_owner(hash32):
            # local_owner (not owns): a moot ring (lone member, tier
            # off) "owns" everything but has no herd to pre-warm for —
            # prefetch only when a real ring routed the hash HERE
            return
        if self.manager.cache.contains(hash32) \
                or hash32 in self._prefetch_q:
            self.prefetch_skips += 1
            return
        if len(self._prefetch_q) >= PREFETCH_QUEUE_MAX:
            self.prefetch_drops += 1
            registry().inc("cache_prefetch_drop")
            return
        self._prefetch_q[hash32] = None
        registry().inc("cache_prefetch_queued")
        self._kick_prefetch()

    def _kick_prefetch(self) -> None:
        from ..utils.background import spawn

        while self._prefetch_running < self.prefetch_inflight \
                and self._prefetch_q:
            # count BEFORE spawn: a second hint arriving before the
            # drainer's first tick must not over-spawn past the bound
            self._prefetch_running += 1
            spawn(self._prefetch_drain(), "cache-tier-prefetch")

    async def _prefetch_drain(self) -> None:
        m = self.manager
        try:
            while self._prefetch_q:
                h, _ = self._prefetch_q.popitem(last=False)
                if not self.owns(h) or m.cache.contains(h):
                    self.prefetch_skips += 1
                    continue
                if self.prefetch_tranquility > 0:
                    # governor pacing: same tranquility discipline as
                    # resync/scrub — client pressure stretches the
                    # inter-fetch gap instead of competing for disk
                    await asyncio.sleep(self.prefetch_tranquility)
                try:
                    # route=False: the owner decodes via its OWN store
                    # path (intra-zone by placement) and the read fill
                    # lands in this cache because owns(h) is True;
                    # charge=False: prefetch is the node's own bet, not
                    # a client read, so it must not count against any
                    # api quota
                    data = await m.rpc_get_block(h, route=False,
                                                 charge=False)
                    if data is not None:
                        self.prefetched += 1
                        registry().inc("cache_prefetch_done")
                except Exception as e:
                    self.prefetch_errors += 1
                    registry().inc("cache_prefetch_error")
                    log.debug("prefetch of %s failed: %s",
                              h[:4].hex(), e)
        finally:
            self._prefetch_running -= 1

    def is_hot(self, hash32: bytes) -> bool:
        """Whether any peer recently advertised hash32 as hot — the
        gate background reads (resync fetches) use before spending a
        probe RPC on a block that is overwhelmingly likely cold."""
        t = self._hints.get(hash32)
        if t is None:
            return False
        if time.monotonic() - t > HINT_TTL_S:
            del self._hints[hash32]
            return False
        return True

    # ---- surface --------------------------------------------------------

    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "zone": self._zone_of(self.manager.system.id),
            "members": len(self.members()),
            "cross_zone_probes": self.cross_zone_probes,
            "hints_dropped_cross_zone": self.hints_dropped_cross_zone,
            "hints_known": len(self._hints),
            "hint_top_n": self.hint_top_n,
            "probes": self.probes,
            "probe_hits": self.probe_hits,
            "probe_misses": self.probe_misses,
            "probe_fails": self.probe_fails,
            "probe_corrupt": self.probe_corrupt,
            "probe_packed_hits": self.probe_packed_hits,
            "remote_hit_bytes": self.remote_hit_bytes,
            "inserts_pushed": self.inserts_pushed,
            "insert_skips": self.insert_skips,
            "hints_seen": self.hints_seen,
            # lease singleflight
            "lease_wait_ms": self.leases.wait_ms,
            "lease_depth": self.leases.depth,
            "lease_minted": self.leases.minted,
            "lease_resolved": self.leases.resolved,
            "lease_expired": self.leases.expired,
            "lease_waits": self.leases.waits,
            "lease_wait_hits_local": self.leases.wait_hits,
            "lease_wait_timeouts_local": self.leases.wait_timeouts,
            "lease_grants": self.lease_grants,
            "lease_wait_hits": self.lease_wait_hits,
            "lease_wait_timeouts": self.lease_wait_timeouts,
            # hint-driven prefetch
            "prefetch_inflight_max": self.prefetch_inflight,
            "prefetch_queue": len(self._prefetch_q),
            "prefetch_running": self._prefetch_running,
            "prefetched": self.prefetched,
            "prefetch_skips": self.prefetch_skips,
            "prefetch_drops": self.prefetch_drops,
            "prefetch_errors": self.prefetch_errors,
        }
