"""Copy of garage_tpu/net/peering.py: import paths rewritten, issue and PR tags dropped.

Full-mesh peering: pings, peer exchange, failure detection, reconnect.

Ref parity: src/net/peering.rs:23-615. Same state machine
(Ourself/Connected/Trying/Waiting/Abandonned), ping every 15 s carrying a
hash of the known peer list (pull the list on mismatch), failure
declared after 4 failed pings of 10 s each, reconnect with backoff.
Ping RTT stats feed the rpc layer's request ordering
(src/rpc/rpc_helper.rs:621-660).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from ..utils.background import spawn
from ..utils.data import blake2sum
from ..utils.metrics import registry
from .message import PRIO_HIGH
from .netapp import NetApp

log = logging.getLogger("garage_tpu_torch.net.peering")

PING_INTERVAL = 15.0
PING_TIMEOUT = 10.0
FAILED_PING_THRESHOLD = 4
CONN_RETRY_INTERVAL = 30.0
CONN_MAX_RETRIES = 10

# ---- per-peer RPC health (consumed by rpc/rpc_helper.py) ----------------
#
# Dean & Barroso, "The Tail at Scale" (CACM 2013): at scale the slow
# outliers dominate user-visible latency, and the fix is to stop
# treating every peer as equally healthy. This tracker is the shared
# observation point: every RpcHelper call records its outcome here
# (RpcHelper instances are per-subsystem, PeeringManager is per-node),
# and three consumers read it back —
#   * request_order deprioritizes peers whose circuit breaker is open,
#   * per-call timeouts derive from the peer's observed p99 instead of
#     the flat 30 s default,
#   * hedged reads fire a backup request after the peer's observed p95
#     instead of waiting for an error.

HEALTH_WINDOW = 128        # latency samples kept per peer (ring)
HEALTH_MIN_SAMPLES = 8     # below this, flat defaults stay in force
ERR_ALPHA = 0.2            # EWMA step for the error-rate estimate
BREAKER_FAILURES = 5       # consecutive failures that open the breaker
BREAKER_COOLDOWN = 5.0     # open -> half-open after this many seconds
BREAKER_HALF_OPEN_PROBES = 2  # in-flight probe budget while half-open
ADAPTIVE_MULT = 4.0        # adaptive timeout = clamp(p99 * this)
ADAPTIVE_MIN_S = 1.0       # never time out faster than this
HEDGE_DELAY_MIN = 0.01
HEDGE_DELAY_MAX = 5.0
HEDGE_DELAY_DEFAULT = 0.25  # hedge delay before any samples exist
HEDGE_BUCKET_CAP = 16.0    # burst budget of the global hedge limiter


class PeerHealth:
    """One peer's health: EWMA error rate + a fixed-size latency ring
    (order statistics over 128 floats are exact and cheap — a real
    quantile sketch buys nothing at this window size) + breaker state."""

    __slots__ = ("err_ewma", "lat", "_idx", "samples", "consec_failures",
                 "breaker", "opened_at", "probes_in_flight")

    def __init__(self):
        self.err_ewma = 0.0
        self.lat: list[float] = []
        self._idx = 0
        self.samples = 0
        self.consec_failures = 0
        self.breaker = "closed"  # closed | open | half_open
        self.opened_at = 0.0
        self.probes_in_flight = 0

    def observe_latency(self, dt: float) -> None:
        if len(self.lat) < HEALTH_WINDOW:
            self.lat.append(dt)
        else:
            self.lat[self._idx] = dt
            self._idx = (self._idx + 1) % HEALTH_WINDOW
        self.samples += 1

    def quantile(self, q: float) -> Optional[float]:
        if not self.lat:
            return None
        s = sorted(self.lat)
        return s[min(len(s) - 1, int(q * len(s)))]


class PeerHealthTracker:
    """Cluster-wide health map + the three-state circuit breaker and
    the global hedge budget. All methods are event-loop-synchronous."""

    def __init__(self):
        self.peers: dict[bytes, PeerHealth] = {}
        self.hedging_enabled = True
        # backup pushes for IDEMPOTENT writes (erasure shard puts are
        # content-addressed, so a duplicate landing is a no-op); the
        # `[rpc] hedge_writes` knob — writes additionally need an
        # explicit per-call hedge=True opt-in, audited by GL02
        self.write_hedging_enabled = True
        self.adaptive_timeout_enabled = True
        self.hedge_rate = 8.0  # sustained hedges/s across all calls
        self._hedge_tokens = HEDGE_BUCKET_CAP
        self._hedge_t = time.monotonic()
        self.hedges_launched = 0
        self.hedge_wins = 0
        self.breaker_opens = 0
        self.breaker_closes = 0

    def configure(self, hedging: Optional[bool] = None,
                  hedge_rate: Optional[float] = None,
                  adaptive_timeout: Optional[bool] = None,
                  write_hedging: Optional[bool] = None) -> None:
        if hedging is not None:
            self.hedging_enabled = bool(hedging)
        if hedge_rate is not None:
            self.hedge_rate = max(0.0, float(hedge_rate))
        if adaptive_timeout is not None:
            self.adaptive_timeout_enabled = bool(adaptive_timeout)
        if write_hedging is not None:
            self.write_hedging_enabled = bool(write_hedging)

    def reset(self) -> None:
        """Drop all observations (bench A/B legs must not inherit the
        previous leg's breakers and quantiles)."""
        self.peers.clear()
        self._hedge_tokens = HEDGE_BUCKET_CAP
        self._hedge_t = time.monotonic()

    def _peer(self, node: bytes) -> PeerHealth:
        p = self.peers.get(node)
        if p is None:
            p = self.peers[node] = PeerHealth()
        return p

    # ---- outcome recording --------------------------------------------

    def record_success(self, node: bytes,
                       latency: Optional[float] = None) -> None:
        p = self._peer(node)
        p.err_ewma *= 1.0 - ERR_ALPHA
        p.consec_failures = 0
        if p.probes_in_flight > 0:
            p.probes_in_flight -= 1
        if latency is not None:
            p.observe_latency(latency)
        if p.breaker != "closed":
            p.breaker = "closed"
            p.probes_in_flight = 0
            self.breaker_closes += 1
            registry().inc("rpc_breaker_transition", to="closed")

    def record_failure(self, node: bytes,
                       latency: Optional[float] = None) -> None:
        p = self._peer(node)
        p.err_ewma = (1.0 - ERR_ALPHA) * p.err_ewma + ERR_ALPHA
        p.consec_failures += 1
        if p.probes_in_flight > 0:
            p.probes_in_flight -= 1
        if latency is not None:
            # timed-out calls land here with their full elapsed time:
            # failures must push the observed tail UP so the adaptive
            # timeout backs off instead of spiraling tighter
            p.observe_latency(latency)
        if p.breaker == "half_open" or (
                p.breaker == "closed"
                and p.consec_failures >= BREAKER_FAILURES):
            p.breaker = "open"
            p.opened_at = time.monotonic()
            p.probes_in_flight = 0
            self.breaker_opens += 1
            registry().inc("rpc_breaker_transition", to="open")

    def record_ping_ok(self, node: bytes) -> None:
        """A successful ping: no latency sample (ping RTTs are not
        data-RPC latencies), but it clears the consecutive-failure
        count and closes a half-open breaker — on an idle cluster no
        data call will ever come along to probe a recovered peer, and
        it must not sit deprioritized forever. A peer that answers
        pings but hangs data RPCs re-opens after the next failures."""
        p = self.peers.get(node)
        if p is None:
            return
        p.consec_failures = 0
        if self.breaker_state(node) == "half_open":
            p.breaker = "closed"
            p.probes_in_flight = 0
            self.breaker_closes += 1
            registry().inc("rpc_breaker_transition", to="closed")

    # ---- breaker reads -------------------------------------------------

    def breaker_state(self, node: bytes,
                      now: Optional[float] = None) -> str:
        p = self.peers.get(node)
        if p is None:
            return "closed"
        if p.breaker == "open":
            if (now if now is not None else time.monotonic()) \
                    - p.opened_at >= BREAKER_COOLDOWN:
                p.breaker = "half_open"
                p.probes_in_flight = 0
                registry().inc("rpc_breaker_transition", to="half_open")
        return p.breaker

    def breaker_rank(self, node: bytes,
                     now: Optional[float] = None) -> int:
        """Ordering penalty for request_order: 0 closed, 1 half-open
        with probe budget left, 2 half-open exhausted, 3 open."""
        st = self.breaker_state(node, now)
        if st == "closed":
            return 0
        if st == "half_open":
            p = self.peers[node]
            return 1 if p.probes_in_flight < BREAKER_HALF_OPEN_PROBES \
                else 2
        return 3

    def note_launch(self, node: bytes) -> None:
        """Count a call launched at a half-open peer against its probe
        budget (budget-exhausted peers rank behind healthy ones)."""
        p = self.peers.get(node)
        if p is not None and p.breaker == "half_open":
            p.probes_in_flight += 1

    # ---- derived knobs -------------------------------------------------

    def call_timeout(self, node: bytes,
                     flat: Optional[float]) -> Optional[float]:
        """Adaptive per-call timeout: clamp(p99 * 4) once the peer has
        enough samples; the caller's flat value is both the default and
        the ceiling (adaptation only ever tightens)."""
        if flat is None or not self.adaptive_timeout_enabled:
            return flat
        p = self.peers.get(node)
        if p is None or p.samples < HEALTH_MIN_SAMPLES:
            return flat
        q = p.quantile(0.99)
        if q is None:
            return flat
        return min(flat, max(ADAPTIVE_MIN_S, q * ADAPTIVE_MULT))

    def hedge_delay(self, nodes) -> float:
        """How long to wait on the in-flight request(s) before launching
        a backup: the worst observed p95 among them, lightly padded."""
        worst = None
        for n in nodes:
            p = self.peers.get(n)
            if p is None or p.samples < HEALTH_MIN_SAMPLES:
                continue
            q = p.quantile(0.95)
            if q is not None and (worst is None or q > worst):
                worst = q
        if worst is None:
            return HEDGE_DELAY_DEFAULT
        return min(HEDGE_DELAY_MAX, max(HEDGE_DELAY_MIN, worst * 1.5))

    def try_take_hedge(self) -> bool:
        """Global hedge-rate cap (token bucket): hedging bounds tail
        latency at a few percent extra load, but only if something
        bounds the hedges themselves."""
        now = time.monotonic()
        self._hedge_tokens = min(
            HEDGE_BUCKET_CAP,
            self._hedge_tokens + (now - self._hedge_t) * self.hedge_rate)
        self._hedge_t = now
        if self._hedge_tokens >= 1.0:
            self._hedge_tokens -= 1.0
            self.hedges_launched += 1
            return True
        return False

    def record_hedge_win(self) -> None:
        self.hedge_wins += 1

    # ---- observability -------------------------------------------------

    def stats(self) -> dict:
        return {
            "hedges_launched": self.hedges_launched,
            "hedge_wins": self.hedge_wins,
            "breaker_opens": self.breaker_opens,
            "breaker_closes": self.breaker_closes,
            "hedging_enabled": self.hedging_enabled,
            "write_hedging_enabled": self.write_hedging_enabled,
            "adaptive_timeout_enabled": self.adaptive_timeout_enabled,
        }

    def peer_state(self) -> dict:
        out = {}
        for node, p in self.peers.items():
            out[node.hex()[:16]] = {
                "breaker": self.breaker_state(node),
                "error_rate": round(p.err_ewma, 4),
                "samples": p.samples,
                "p50_s": p.quantile(0.50),
                "p95_s": p.quantile(0.95),
                "p99_s": p.quantile(0.99),
            }
        return out


class PeerConnState(Enum):
    OURSELF = "ourself"
    CONNECTED = "connected"
    TRYING = "trying"
    WAITING = "waiting"
    ABANDONNED = "abandonned"


@dataclass
class PeerInfo:
    id: bytes
    addr: Optional[tuple]
    state: PeerConnState
    last_seen: Optional[float] = None
    ping_avg: Optional[float] = None
    ping_max: Optional[float] = None


@dataclass
class _Peer:
    id: bytes
    addr: Optional[tuple] = None
    state: PeerConnState = PeerConnState.WAITING
    next_retry: float = 0.0
    retries: int = 0
    failed_pings: int = 0
    last_seen: Optional[float] = None
    pings: list = field(default_factory=list)  # last RTTs

    def record_ping(self, rtt: float) -> None:
        self.pings.append(rtt)
        if len(self.pings) > 10:
            self.pings.pop(0)
        self.last_seen = time.monotonic()
        self.failed_pings = 0


class PeeringManager:
    """Keeps this node connected to every known peer."""

    def __init__(
        self,
        netapp: NetApp,
        bootstrap: list,
        ping_interval: float = PING_INTERVAL,
        ping_timeout: float = PING_TIMEOUT,
        retry_interval: float = CONN_RETRY_INTERVAL,
    ):
        self.netapp = netapp
        self.ping_interval = ping_interval
        self.ping_timeout = ping_timeout
        self.retry_interval = retry_interval
        # hot-hash hint piggyback (block/cache_tier.py): the
        # cluster cache tier registers a provider (this node's hottest
        # cache keys) and a sink (a peer's hints). The peering layer
        # stays block-agnostic — hints are opaque byte strings riding
        # the pings it already sends, in BOTH directions (request and
        # reply), so a hint set converges in ~one ping interval.
        self.hint_provider = None  # () -> list[bytes]
        self.hint_sink = None      # (from_node: bytes, hints) -> None
        # shared per-peer rpc health (breakers, latency quantiles);
        # PeeringManager is the one per-node object every RpcHelper
        # can reach through system.peering
        self.health = PeerHealthTracker()
        self.peers: dict[bytes, _Peer] = {
            netapp.id: _Peer(netapp.id, netapp.public_addr, PeerConnState.OURSELF)
        }
        # bootstrap addresses whose node id we don't know yet; moved into
        # self.peers once a connection reveals the id (kept separate — an
        # in-band key prefix would collide with real 32-byte ids)
        self.pending: dict[tuple, _Peer] = {}
        for entry in bootstrap:
            addr, pid = (entry, None) if not _is_pair(entry) else entry
            self.add_peer(tuple(addr) if addr else None, pid)

        self.ep_ping = netapp.endpoint("garage_net/peering:ping").set_handler(self._h_ping)
        self.ep_list = netapp.endpoint("garage_net/peering:list").set_handler(self._h_list)
        self.ep_hello = netapp.endpoint("garage_net/peering:hello").set_handler(self._h_hello)
        netapp.on_connected.append(self._on_connected)
        netapp.on_disconnected.append(self._on_disconnected)
        self._stop = asyncio.Event()

    # ---- public --------------------------------------------------------

    def get_peer_list(self) -> list[PeerInfo]:
        out = []
        for p in self.peers.values():
            if p.addr is None and p.id != self.netapp.id:
                # inbound connection that never announced a public addr:
                # a transient RPC client (operator CLI), not a cluster
                # member — keep it out of membership, gossip and metrics
                # (ref: only Hello-announcing nodes enter the peer list,
                # src/net/netapp.rs:440-470)
                continue
            avg = sum(p.pings) / len(p.pings) if p.pings else None
            mx = max(p.pings) if p.pings else None
            out.append(PeerInfo(p.id, p.addr, p.state, p.last_seen, avg, mx))
        return out

    def ping_avg(self, node: bytes) -> Optional[float]:
        p = self.peers.get(node)
        return (sum(p.pings) / len(p.pings)) if p and p.pings else None

    def add_peer(self, addr, pid: Optional[bytes] = None) -> None:
        if pid == self.netapp.id:
            return
        if pid is None:
            if addr is not None and addr not in self.pending:
                self.pending[addr] = _Peer(None, addr)
            return
        if pid in self.peers:
            if addr is not None:
                self.peers[pid].addr = addr
        else:
            self.peers[pid] = _Peer(pid, addr)
        if addr is not None:
            self.pending.pop(addr, None)

    async def stop(self) -> None:
        self._stop.set()

    # ---- loops ---------------------------------------------------------

    async def run(self) -> None:
        ping_task = asyncio.create_task(self._ping_loop())
        conn_task = asyncio.create_task(self._connect_loop())
        # supervised (cancelled below): not leaks for the sanitizer
        ping_task._garage_background = True
        conn_task._garage_background = True
        await self._stop.wait()
        ping_task.cancel()
        conn_task.cancel()

    async def _ping_loop(self) -> None:
        while True:
            await asyncio.sleep(self.ping_interval * random.uniform(0.8, 1.2))
            self.netapp._ordered.prune()
            targets = [
                p for p in self.peers.values() if p.state == PeerConnState.CONNECTED
            ]
            await asyncio.gather(*(self._ping_one(p) for p in targets))

    def _hot_hints(self) -> list:
        if self.hint_provider is None:
            return []
        try:
            return list(self.hint_provider())
        except Exception as e:
            log.debug("hint provider failed: %s", e)
            return []

    def _take_hints(self, from_node: bytes, payload: dict) -> None:
        hot = payload.get("hot")
        if not hot or self.hint_sink is None:
            return
        try:
            self.hint_sink(from_node, hot)
        except Exception as e:
            log.debug("hint sink failed: %s", e)

    async def _ping_one(self, peer: _Peer) -> None:
        t0 = time.monotonic()
        try:
            payload = {"hash": self._peer_list_hash()}
            hot = self._hot_hints()
            if hot:
                payload["hot"] = hot
            resp, _ = await self.ep_ping.call(
                peer.id, payload, PRIO_HIGH, timeout=self.ping_timeout
            )
            peer.record_ping(time.monotonic() - t0)
            self.health.record_ping_ok(peer.id)
            self._take_hints(peer.id, resp)
            if resp.get("hash") != self._peer_list_hash():
                await self._pull_peer_list(peer.id)
        except Exception:
            peer.failed_pings += 1
            # a failed ping is a health failure too (no latency sample:
            # ping RTTs are not data-RPC latencies) — enough failed
            # pings open the breaker even with no data traffic flowing
            self.health.record_failure(peer.id)
            if peer.failed_pings >= FAILED_PING_THRESHOLD:
                log.info("peer %s failed %d pings, disconnecting", peer.id[:4].hex(), peer.failed_pings)
                conn = self.netapp.conns.get(peer.id)
                if conn is not None:
                    await conn.close()

    async def _connect_loop(self) -> None:
        while True:
            now = time.monotonic()
            for peer in list(self.peers.values()) + list(self.pending.values()):
                if (
                    peer.state == PeerConnState.WAITING
                    and peer.next_retry <= now
                    and peer.addr is not None
                ):
                    peer.state = PeerConnState.TRYING
                    spawn(self._try_connect(peer), "peer-connect")
            await asyncio.sleep(min(1.0, self.retry_interval / 10))

    async def _try_connect(self, peer: _Peer) -> None:
        try:
            got = await self.netapp.try_connect(peer.addr, peer.id)
            if peer.id is None:
                # learned the real id for a bootstrap addr
                self.pending.pop(peer.addr, None)
                self.add_peer(peer.addr, got)
                p2 = self.peers.get(got)
                if p2 is not None:
                    p2.state = PeerConnState.CONNECTED
        except Exception as e:
            log.debug("connect to %s failed: %s", peer.addr, e)
            peer.retries += 1
            if peer.retries >= CONN_MAX_RETRIES:
                peer.state = PeerConnState.ABANDONNED
            else:
                peer.state = PeerConnState.WAITING
                backoff = self.retry_interval * min(2 ** (peer.retries - 1), 8)
                peer.next_retry = time.monotonic() + backoff * random.uniform(0.8, 1.2)

    # ---- netapp callbacks ---------------------------------------------

    def _on_connected(self, peer_id: bytes, incoming: bool) -> None:
        p = self.peers.get(peer_id)
        if p is None:
            p = self.peers[peer_id] = _Peer(peer_id)
        p.state = PeerConnState.CONNECTED
        p.retries = 0
        p.failed_pings = 0
        p.last_seen = time.monotonic()
        if not incoming:
            # tell the acceptor our public address (ref Hello message,
            # src/net/netapp.rs:440-470)
            spawn(self._send_hello(peer_id), "peer-hello")

    async def _send_hello(self, peer_id: bytes) -> None:
        try:
            await self.ep_hello.call(
                peer_id, {"addr": list(self.netapp.public_addr or ())}, PRIO_HIGH, timeout=10.0
            )
        except Exception as e:
            log.debug("hello to %s failed: %s", peer_id[:4].hex(), e)

    def _on_disconnected(self, peer_id: bytes) -> None:
        p = self.peers.get(peer_id)
        if p is None:
            return
        if p.addr is None:
            # transient client gone: forget it, nothing to reconnect to
            del self.peers[peer_id]
            return
        if p.state == PeerConnState.CONNECTED:
            p.state = PeerConnState.WAITING
            p.next_retry = time.monotonic() + self.retry_interval * random.uniform(0.5, 1.0)

    # ---- rpc handlers --------------------------------------------------

    def _peer_list_hash(self) -> bytes:
        # covers exactly what _h_list serves (id+addr known), so hash
        # equality <=> list equality and pings don't re-pull forever
        items = sorted(
            (p.id, tuple(p.addr))
            for p in self.peers.values()
            if p.addr is not None
        )
        return blake2sum(repr(items).encode())

    async def _h_ping(self, from_node, payload, stream):
        p = self.peers.get(from_node)
        if p is not None:
            p.last_seen = time.monotonic()
        self._take_hints(from_node, payload)
        out = {"hash": self._peer_list_hash()}
        hot = self._hot_hints()
        if hot:
            out["hot"] = hot
        return out

    async def _h_list(self, from_node, payload, stream):
        return {
            "peers": [
                [p.id, list(p.addr)]
                for p in self.peers.values()
                if p.addr is not None
            ]
        }

    async def _h_hello(self, from_node, payload, stream):
        addr = payload.get("addr")
        if addr:
            self.add_peer(tuple(addr), from_node)
            p = self.peers.get(from_node)
            if p is not None:
                p.addr = tuple(addr)
        return {}

    async def _pull_peer_list(self, node: bytes) -> None:
        try:
            resp, _ = await self.ep_list.call(node, {}, PRIO_HIGH, timeout=self.ping_timeout)
            for pid, addr in resp.get("peers", []):
                self.add_peer(tuple(addr) if addr else None, bytes(pid))
        except Exception as e:
            log.debug("peer-list pull from %s failed: %s",
                      node[:4].hex(), e)


def _is_pair(entry) -> bool:
    return (
        isinstance(entry, (tuple, list))
        and len(entry) == 2
        and (entry[1] is None or isinstance(entry[1], bytes))
        and isinstance(entry[0], (tuple, list))
    )
