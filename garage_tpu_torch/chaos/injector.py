"""Copy of garage_tpu/chaos/injector.py: import paths rewritten, issue and PR tags dropped.

Deterministic, seeded fault injection behind named seams.

Yuan et al. (OSDI 2014, "Simple Testing Can Prevent Most Critical
Failures") found that the majority of catastrophic distributed-system
failures are triggered by error-handling paths that were never
exercised. This module makes those paths exercisable: the net, disk and
rpc layers each carry a named injection seam that is a no-op unless a
fault is armed, and tests/benches arm precisely-scoped faults against
them.

Design rules:

- **No-op fast path.** Every seam starts with `if injector.ACTIVE is
  None: <nothing>` — one module-attribute load and an identity check.
  `ACTIVE` is only non-None while at least one fault is armed, so a
  production node that never touches the chaos API pays a single
  pointer compare per seam crossing.
- **Deterministic.** One `random.Random(seed)` drives every probability
  draw and every bit-rot position. Under a single event loop the draw
  order is the event order, so a fixed seed + fixed workload replays
  the same faults. Faults with `prob=1.0` and a `count` budget are
  deterministic regardless of draw order.
- **Scoped.** A fault fires only where its scope matches: `node` (hex
  prefix of the LOCAL node id — which store's disk), `peer` (hex prefix
  of the REMOTE node id — which link/target), `endpoint` (rpc path
  prefix), `hash_prefix` (block hash hex prefix). Empty scope fields
  match everything.
- **Budgeted + counted.** `count` caps how many times a fault fires;
  every firing increments the `fired` counter on the spec AND a
  `chaos_fault_fired{kind=...}` series in the metrics registry, so a
  test can assert injection actually happened (a chaos test that
  silently injects nothing proves nothing).

Fault kinds:

  net_delay       sleep `delay_s` before a frame is sent
  net_drop        silently discard the frame (send- or recv-side)
  net_disconnect  kill the connection (ConnectionError out of the seam)
  net_slow        bandwidth drip: sleep nbytes / `rate_bps` per frame
  disk_read_error raise OSError(EIO) out of a local block/shard read
  disk_write_error raise OSError(EIO) out of a local block/shard write
  disk_torn_write persist only the first half of the written bytes
  disk_bitrot     flip one bit of the bytes read from the store
  rpc_error       raise RpcError instead of issuing the call
  rpc_hang        the call never completes: sleep out the caller's full
                  timeout, then raise asyncio.TimeoutError (exactly the
                  caller-visible shape of a hung peer)
  partition_zone  sever every CROSS-zone link of the zone named by the
                  `zone` scope field: a frame whose two
                  endpoints straddle the zone boundary dies with
                  ConnectionError in both directions, while intra-zone
                  links — inside AND outside the named zone — stay up.
                  Zone membership comes from the controller's
                  `zone_resolver` (installed from the layout by the
                  composition root; nodes it can't resolve are never
                  matched). This is the whole-failure-domain drill the
                  single-link net_disconnect can't express.

The controller is process-global (`arm()`/`disarm()`); a live node also
exposes it through admin `GET/POST /v1/chaos` and the `[chaos]` config
section arms it at boot.
"""

from __future__ import annotations

import asyncio
import errno
import random
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..utils.metrics import registry

NET_KINDS = ("net_delay", "net_drop", "net_disconnect", "net_slow")
ZONE_KINDS = ("partition_zone",)
DISK_READ_KINDS = ("disk_read_error", "disk_bitrot")
DISK_WRITE_KINDS = ("disk_write_error", "disk_torn_write")
RPC_KINDS = ("rpc_error", "rpc_hang")
ALL_KINDS = (NET_KINDS + ZONE_KINDS + DISK_READ_KINDS
             + DISK_WRITE_KINDS + RPC_KINDS)

_HANG_FALLBACK = 3600.0  # a hang with no caller timeout still ends


class ChaosError(OSError):
    """Injected disk error; distinct type so logs name the injection."""

    def __init__(self, what: str):
        super().__init__(errno.EIO, f"chaos: injected {what}")


@dataclass
class FaultSpec:
    """One armed fault. Scope fields are hex/path prefixes; empty
    matches everything."""

    kind: str
    prob: float = 1.0
    count: Optional[int] = None  # firing budget; None = unlimited
    node: str = ""        # local node id hex prefix (disk faults)
    peer: str = ""        # remote node id hex prefix (net/rpc faults)
    endpoint: str = ""    # rpc endpoint path prefix
    hash_prefix: str = ""  # block hash hex prefix (disk faults)
    zone: str = ""        # partitioned zone name (partition_zone)
    delay_s: float = 0.05
    rate_bps: float = 1 << 20
    id: int = 0
    fired: int = 0

    def exhausted(self) -> bool:
        return self.count is not None and self.fired >= self.count

    def to_dict(self) -> dict:
        return {
            "id": self.id, "kind": self.kind, "prob": self.prob,
            "count": self.count, "node": self.node, "peer": self.peer,
            "endpoint": self.endpoint, "hash_prefix": self.hash_prefix,
            "zone": self.zone,
            "delay_s": self.delay_s, "rate_bps": self.rate_bps,
            "fired": self.fired, "exhausted": self.exhausted(),
        }


class ChaosController:
    """Holds the armed fault set and evaluates seam crossings."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.faults: list[FaultSpec] = []
        # node_id -> zone name (or None): installed by the composition
        # root / test harness from the layout (zones/health.py
        # layout_zone_resolver) so partition_zone faults can tell which
        # side of a frame sits in the named zone. Resolution only runs
        # while a partition_zone fault is armed.
        self.zone_resolver = None
        self._next_id = 1
        # seam-crossing evaluation happens on the event loop; arming
        # can come from admin handlers on the same loop or from test
        # threads — guard list mutation only
        self._lock = threading.Lock()
        self.total_fired = 0

    # ---- management ----------------------------------------------------

    def add(self, spec: FaultSpec) -> FaultSpec:
        if spec.kind not in ALL_KINDS:
            raise ValueError(f"unknown fault kind {spec.kind!r} "
                             f"(kinds: {', '.join(ALL_KINDS)})")
        if not 0.0 <= spec.prob <= 1.0:
            raise ValueError("prob must be in [0, 1]")
        with self._lock:
            spec.id = self._next_id
            self._next_id += 1
            self.faults.append(spec)
        return spec

    def remove(self, fault_id: int) -> bool:
        with self._lock:
            n = len(self.faults)
            self.faults = [f for f in self.faults if f.id != fault_id]
            return len(self.faults) != n

    def clear(self) -> None:
        with self._lock:
            self.faults = []

    def reseed(self, seed: int) -> None:
        """Fresh seed = fresh experiment: the rng AND the fired
        counters restart so runs are comparable."""
        self.seed = seed
        self.rng = random.Random(seed)
        self.total_fired = 0
        for f in self.faults:
            f.fired = 0

    def state(self) -> dict:
        return {
            "enabled": ACTIVE is self,
            "seed": self.seed,
            "total_fired": self.total_fired,
            "faults": [f.to_dict() for f in self.faults],
        }

    # ---- matching ------------------------------------------------------

    def _fire(self, kinds, node: bytes = b"", peer: bytes = b"",
              endpoint: str = "", hash32: bytes = b"",
              zone_pair=None) -> Optional[FaultSpec]:
        """First armed, in-scope, in-budget fault of one of `kinds`
        whose probability draw passes — with its fired counter already
        advanced. Runs under the lock: disk seams cross from
        asyncio.to_thread worker threads while net/rpc seams run on
        the event loop, and both the count budget and the seeded draw
        order must survive that.

        `zone_pair` is (local_zone, peer_zone) as resolved by the net
        seam — a partition_zone fault matches only when both sides
        resolved and EXACTLY ONE of them sits in the named zone (the
        cross-zone links of that zone; intra-zone traffic anywhere
        stays untouched)."""
        node_hex = node.hex() if node else ""
        peer_hex = peer.hex() if peer else ""
        hash_hex = hash32.hex() if hash32 else ""
        with self._lock:
            for f in self.faults:
                if f.kind not in kinds or f.exhausted():
                    continue
                if f.kind in ZONE_KINDS:
                    if not f.zone or zone_pair is None:
                        continue
                    lz, pz = zone_pair
                    if lz is None or pz is None:
                        continue
                    if (lz == f.zone) == (pz == f.zone):
                        continue
                if f.node and not node_hex.startswith(f.node):
                    continue
                if f.peer and not peer_hex.startswith(f.peer):
                    continue
                if f.endpoint and not endpoint.startswith(f.endpoint):
                    continue
                if f.hash_prefix \
                        and not hash_hex.startswith(f.hash_prefix):
                    continue
                if f.prob < 1.0 and self.rng.random() >= f.prob:
                    continue
                f.fired += 1
                self.total_fired += 1
                registry().inc("chaos_fault_fired", kind=f.kind)
                if f.exhausted():
                    _maybe_deactivate()
                return f
        return None

    # ---- seams ---------------------------------------------------------

    async def net_frame(self, direction: str, local: bytes, peer: bytes,
                        nbytes: int) -> bool:
        """Net seam, called per frame from Conn send/recv. Returns False
        when the frame must be DROPPED; may sleep (delay/slow) or raise
        ConnectionError (disconnect / partition_zone)."""
        zone_pair = None
        if self.zone_resolver is not None and local and peer \
                and any(f.kind in ZONE_KINDS for f in self.faults):
            zone_pair = (self.zone_resolver(local),
                         self.zone_resolver(peer))
        f = self._fire(NET_KINDS + ZONE_KINDS, node=local, peer=peer,
                       zone_pair=zone_pair)
        if f is None:
            return True
        if f.kind == "net_delay":
            await asyncio.sleep(f.delay_s)
            return True
        if f.kind == "net_slow":
            await asyncio.sleep(nbytes / max(f.rate_bps, 1.0))
            return True
        if f.kind == "net_drop":
            return False
        if f.kind == "partition_zone":
            raise ConnectionError(
                f"chaos: zone {f.zone} partitioned ({direction})")
        raise ConnectionError(
            f"chaos: injected disconnect ({direction})")

    async def rpc_call(self, endpoint: str, node: bytes,
                       timeout: Optional[float]) -> None:
        """RPC seam, called before a call is issued. May raise RpcError
        (rpc_error) or consume the caller's whole timeout and raise
        asyncio.TimeoutError (rpc_hang — the caller-visible shape of a
        peer that accepted the request and went silent)."""
        f = self._fire(RPC_KINDS, peer=node, endpoint=endpoint)
        if f is None:
            return
        if f.kind == "rpc_error":
            from ..utils.error import RpcError

            raise RpcError(f"chaos: injected rpc error on {endpoint}")
        await asyncio.sleep(timeout if timeout else _HANG_FALLBACK)
        raise asyncio.TimeoutError(
            f"chaos: injected hang on {endpoint} "
            f"(consumed {timeout}s timeout)")

    def disk_read(self, node: bytes, hash32: bytes, raw: bytes) -> bytes:
        """Disk read seam: raw bytes as read from the store. May raise
        ChaosError (EIO) or return the bytes with one bit flipped —
        downstream checksum/content verification is expected to catch
        the rot, exactly as it must for real media decay."""
        f = self._fire(DISK_READ_KINDS, node=node, hash32=hash32)
        if f is None:
            return raw
        if f.kind == "disk_read_error":
            raise ChaosError("read error")
        if not raw:
            return raw
        with self._lock:  # seeded draw order vs concurrent seams
            pos = self.rng.randrange(len(raw))
            bit = 1 << self.rng.randrange(8)
        rotted = bytearray(raw)
        rotted[pos] ^= bit
        return bytes(rotted)

    def disk_write(self, node: bytes, hash32: bytes, content) -> bytes:
        """Disk write seam: bytes about to be persisted. May raise
        ChaosError (EIO) or return a torn (half-length) image."""
        f = self._fire(DISK_WRITE_KINDS, node=node, hash32=hash32)
        if f is None:
            return content
        if f.kind == "disk_write_error":
            raise ChaosError("write error")
        return bytes(memoryview(content)[: len(content) // 2])


# ---- process-global arming ----------------------------------------------

# The seams read this ONE attribute. None = chaos fully disabled.
ACTIVE: Optional[ChaosController] = None

_controller = ChaosController()


def controller() -> ChaosController:
    """The process-global controller (exists even while disarmed, so
    admin GET /v1/chaos can always report state)."""
    return _controller


def arm(seed: Optional[int] = None) -> ChaosController:
    """Enable the seams. Optionally reseed for a deterministic run."""
    global ACTIVE
    if seed is not None:
        _controller.reseed(seed)
    ACTIVE = _controller
    return _controller


def disarm(clear: bool = True) -> None:
    """Back to the no-op fast path; by default also drop armed faults."""
    global ACTIVE
    ACTIVE = None
    if clear:
        _controller.clear()


def _maybe_deactivate() -> None:
    """When every armed fault has exhausted its budget, drop back to
    the no-op fast path automatically — a finished chaos experiment
    must not keep taxing the hot paths."""
    global ACTIVE
    if ACTIVE is not None and ACTIVE.faults \
            and all(f.exhausted() for f in ACTIVE.faults):
        ACTIVE = None
