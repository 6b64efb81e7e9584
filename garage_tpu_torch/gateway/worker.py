"""Gateway worker process: `python -m garage_tpu_torch.gateway.worker`
(ported from the JAX package's gateway/worker.py).

Each worker is an API-only Garage node: no capacity (it never appears
in the layout, so no table partition or block is ever placed on it), a
`memory` metadata engine (workers hold no durable state — everything
authoritative lives in the store node, reached over the existing
loopback `net/` RPC transport), and its own node key under
`{metadata_dir}/gateway/worker{i}` so a respawn reconnects as the same
peer. The S3/K2V/web frontends bind the SAME ports as every sibling
via SO_REUSEPORT — the kernel balances accepted connections across
workers, giving the node one accept loop, one SigV4/chunk-hash thread
pool and one GIL **per core** instead of per node.

The worker's qos global buckets are not configured limits but LEASES:
`GatewayWorkerClient` renews a share of the node budget from the
supervisor's broker every `lease_interval_s`, reporting observed
demand (offered req/s and bytes/s EWMA'd broker-side) so hot workers
grow and idle ones shrink to the floor. If the supervisor goes silent
past the lease TTL the worker clamps itself to `min_share` of its last
grant — a partitioned worker must fail toward admitting less than its
share, never more.

The same client implements the worker-sharded read cache: each renew
carries the live roster, cacheable block hashes are owned by
rendezvous hash over it (ring.py), and a non-owner forwards the read
to the owner over worker-to-worker RPC instead of decoding its own
duplicate copy. SSE-C payloads never route (cacheable=False skips the
router entirely) and the forwarding worker charges its own lease for
the bytes (the owner serves uncharged).

What differs from the JAX package: the worker's block math runs on the
torch device given by `--device` (the store node's: "cuda" unless
"cpu"), through its own DeviceFeeder; a worker whose device cannot be
reached fails its boot before it says hello, so the supervisor reports
it not ready and nothing serves on the CPU in its place. A worker of a
`[tpu] enable = false` node runs its feeder host-only ("off"), as the
JAX package's does, and reaches no device. Several workers
on one card each hold their own CUDA context; the card time-slices
their kernels (no MPS daemon is started here). A worker's node key and
lockfile live under its own metadata dir; the lockfile is an flock the
kernel drops when a killed worker exits, and a respawn that still finds
it held retries for a few seconds.
"""

from __future__ import annotations

import argparse
import asyncio
import copy
import logging
import os
import signal
import time
from typing import Optional

from ..net.message import PRIO_NORMAL
from ..utils.background import spawn
from ..utils.config import Config, read_config
from . import GATEWAY_RPC_PATH
from .ring import CacheRing

log = logging.getLogger("garage_tpu_torch.gateway.worker")


def derive_worker_config(cfg: Config, index: int, workers: int,
                         store_peer: str) -> Config:
    """The worker's view of the node config: API knobs inherited
    verbatim, state and background work stripped, per-process RAM
    budgets divided by the worker count so the NODE totals what the
    operator configured.

    On a CUDA node each worker also costs device memory that no config
    key divides: its own CUDA context (a few hundred MiB on an H100,
    taken at boot), the kernel libraries loaded into it, and the feeder
    backend's staging (block/device_backend.py): page-locked host
    batches of up to `[tpu] batch_blocks` blocks and their device
    copies, per batch in flight (`[tpu] inflight_batches`)."""
    w = copy.deepcopy(cfg)
    w.metadata_dir = os.path.join(cfg.metadata_dir, "gateway",
                                  f"worker{index}")
    w.data_dir = []
    w.db_engine = "memory"
    w.rpc_bind_addr = "127.0.0.1:0"  # ephemeral; netapp fixes up
    w.rpc_public_addr = None
    w.bootstrap_peers = [store_peer]
    w.admin_api_bind_addr = None  # admin stays on the supervisor
    w.metadata_auto_snapshot_interval = None
    w.qos = copy.deepcopy(cfg.qos)
    w.qos.governor = False  # nothing background to govern here
    # leased budgets arrive with the first hello, BEFORE the frontends
    # bind; starting from None (unlimited) is safe because no port is
    # accepting yet
    w.qos.global_rps = None
    w.qos.global_bytes_per_s = None
    # the concurrency gate is a node-wide memory/latency bound like the
    # rate budgets: split it statically so N workers cannot hold N× the
    # configured in-flight requests (per-key/per-bucket rates stay
    # per-worker approximations — documented in README)
    if cfg.qos.max_concurrent is not None:
        w.qos.max_concurrent = max(1, cfg.qos.max_concurrent
                                   // max(1, workers))
    w.qos.max_queue = max(1, cfg.qos.max_queue // max(1, workers))
    # no external discovery per worker — the store node already
    # advertises the cluster
    w.consul_http_addr = None
    w.kubernetes_namespace = None
    n = max(1, workers)
    w.block_ram_buffer_max = max(1 << 20, cfg.block_ram_buffer_max // n)
    base_cache = (cfg.block_read_cache_max_bytes
                  if cfg.block_read_cache_max_bytes is not None
                  else cfg.block_ram_buffer_max // 4)
    w.block_read_cache_max_bytes = base_cache // n
    return w


class GatewayWorkerClient:
    """Lease client + cache router + runtime-knob receiver, all over
    the one `garage_tpu/gateway` endpoint."""

    def __init__(self, garage, index: int, store_id: bytes,
                 gw_cfg, admin_http=None):
        self.garage = garage
        self.index = index
        self.store_id = store_id
        self.gw_cfg = gw_cfg
        self.endpoint = garage.system.netapp.endpoint(
            GATEWAY_RPC_PATH).set_handler(self._handle)
        self.ring = CacheRing(garage.system.id)
        # zero-copy shm forwards (gateway/shm.py): the owner side
        # publishes payloads into its ring, the forwarding side maps
        # every sibling's ring read-only. `[gateway] shm_forwards =
        # false` is the kill switch — both stay None and every forward
        # carries bytes over the socket.
        self.shm = None
        self.shm_reader = None
        if getattr(gw_cfg, "shm_forwards", False):
            from .shm import ShmReader, ShmRing, ring_path

            try:
                # the worker's own metadata_dir is stable per index and
                # unique per cluster — exactly the ring-path key a
                # respawn must reuse and parallel clusters must not
                # share. Forwarders never derive paths: the reference
                # in the RPC reply carries the owner's path verbatim.
                self.shm = ShmRing(
                    ring_path(garage.config.metadata_dir, index),
                    gw_cfg.shm_ring_bytes, gw_cfg.shm_lease_s)
                self.shm_reader = ShmReader()
            except OSError as e:
                log.warning("shm forwards disabled (ring create "
                            "failed): %s", e)
        self.interval = gw_cfg.lease_interval_s
        self.lease: Optional[dict] = None
        self._last_ok = time.monotonic()
        self._clamped = False
        self._prev_sample = (time.monotonic(), 0.0, 0)
        self._renew_task: Optional[asyncio.Task] = None
        self._stopped = False
        # render /metrics for the supervisor's aggregation without
        # binding an HTTP port of our own
        if admin_http is None:
            from ..admin.http import AdminHttpServer

            admin_http = AdminHttpServer(garage)
        self._admin = admin_http

    # ---- lease protocol ------------------------------------------------

    def _demand_sample(self) -> tuple[float, float]:
        """Observed offered load since the last renew: requests/s
        (admitted + shed — a shedding worker is exactly the one whose
        lease must grow) and bytes/s."""
        c = self.garage.qos.counters
        now = time.monotonic()
        t0, req0, by0 = self._prev_sample
        req1 = float(c.admitted + c.shed)
        by1 = c.offered_bytes
        self._prev_sample = (now, req1, by1)
        dt = max(now - t0, 1e-3)
        return (req1 - req0) / dt, (by1 - by0) / dt

    async def _renew_once(self, op: str = "renew") -> None:
        d_rps, d_bps = self._demand_sample()
        resp, _ = await self.endpoint.call(
            self.store_id,
            {"op": op, "index": self.index,
             "demand_rps": d_rps, "demand_bps": d_bps},
            PRIO_NORMAL, timeout=max(2.0, self.interval * 2))
        self._apply(resp)
        self._last_ok = time.monotonic()
        self._clamped = False

    def _apply(self, resp: dict) -> None:
        lease = resp.get("lease") or {}
        self.lease = lease
        self.interval = float(resp.get("interval_s", self.interval))
        rps = lease.get("rps")
        bps = lease.get("bytes_per_s")
        self.garage.qos.update_limits({
            "global_rps": rps, "global_burst": rps,
            "global_bytes_per_s": bps, "global_bytes_burst": bps,
        })
        members = []
        for entry in resp.get("roster", []):
            _, hexid, addr = (entry + [None])[:3]
            nid = bytes.fromhex(hexid)
            members.append(nid)
            if nid != self.garage.system.id and addr:
                # seed the sibling's address so the peering connect
                # loop dials it NOW — cache forwards must not wait for
                # the ping-driven peer exchange to converge
                self.garage.system.peering.add_peer(tuple(addr), nid)
        if resp.get("cache_shard") and len(members) > 1:
            self.ring.set_members(members)
            self.garage.block_manager.cache_router = self
        else:
            self.garage.block_manager.cache_router = None

    def _clamp_to_floor(self) -> None:
        """Supervisor silent past the lease TTL: shrink to min_share of
        the last grant. Fail toward admitting LESS than our share."""
        if self._clamped or not self.lease:
            return
        self._clamped = True
        frac = self.gw_cfg.min_share
        rps = self.lease.get("rps")
        bps = self.lease.get("bytes_per_s")
        self.garage.qos.update_limits({
            "global_rps": rps * frac if rps is not None else None,
            "global_bytes_per_s": bps * frac if bps is not None
            else None,
        })
        log.warning("worker %d lease expired without renewal; "
                    "clamped to %.0f%% of last grant", self.index,
                    frac * 100)

    async def start(self, deadline_s: float = 60.0) -> None:
        """Connect to the store and obtain the first lease; the caller
        binds the frontends only after this returns."""
        deadline = time.monotonic() + deadline_s
        while True:
            try:
                await self._renew_once(op="hello")
                break
            except Exception as e:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"worker {self.index}: no lease from store "
                        f"after {deadline_s:.0f}s: {e}") from e
                await asyncio.sleep(0.2)
        self._renew_task = spawn(self._renew_loop(),
                                 f"gateway-lease-renew-{self.index}")

    async def _renew_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.interval)
            try:
                # lint: ignore[GL12] single-task loop — only this coroutine calls _renew_once, so its lease/_last_ok writes never interleave with the except-path reads
                await self._renew_once()
            except Exception as e:
                log.debug("lease renew failed: %s", e)
                ttl = (self.lease or {}).get("ttl_s",
                                             self.gw_cfg.lease_ttl_s)
                if time.monotonic() - self._last_ok > ttl:
                    self._clamp_to_floor()

    def stop(self) -> None:
        self._stopped = True
        if self._renew_task is not None:
            self._renew_task.cancel()
        if self.shm is not None:
            self.shm.close()

    # ---- cache router (BlockManager.cache_router duck-type) ------------

    def owner_of(self, hash32: bytes) -> Optional[bytes]:
        return self.ring.owner_of(hash32)

    def owns(self, hash32: bytes) -> bool:
        return self.ring.owns(hash32)

    async def forward(self, owner: bytes, hash32: bytes):
        """Read a cacheable block through its owner worker; None means
        'serve it yourself' (owner unreachable). The owner answers with
        a shm reference when it can (gateway/shm.py) — the payload then
        never crosses the socket: we map the owner's ring and hand the
        memoryview straight down the zero-copy HTTP write path. A
        reference that fails validation (wrapped ring, stale epoch)
        falls back to one explicit socket re-fetch."""
        from ..utils.metrics import registry

        try:
            resp, _ = await self.endpoint.call(
                owner, {"op": "cache_get", "hash": hash32},
                PRIO_NORMAL, timeout=10.0)
            if not isinstance(resp, dict):
                resp = {}
            ref = resp.get("shm")
            if ref is not None and self.shm_reader is not None:
                mv = self.shm_reader.get(ref, hash32)
                if mv is not None:
                    registry().inc("cache_tier_shm_forward")
                    registry().inc("gateway_cache_forward_ok")
                    return mv
                registry().inc("cache_tier_shm_fallback")
                resp, _ = await self.endpoint.call(
                    owner, {"op": "cache_get", "hash": hash32,
                            "no_shm": True},
                    PRIO_NORMAL, timeout=10.0)
                if not isinstance(resp, dict):
                    resp = {}
            data = resp.get("data")
            if data is not None:
                registry().inc("gateway_cache_forward_ok")
                return data
        except Exception as e:
            log.debug("cache forward to %s failed: %s",
                      owner[:4].hex(), e)
        registry().inc("gateway_cache_forward_fail")
        return None

    # ---- RPC handler ---------------------------------------------------

    async def _handle(self, from_node, payload, stream):
        from ..admin.http import (apply_chaos_spec, apply_s3_tuning,
                                  s3_tuning_state)

        op = payload.get("op")
        if op == "ping":
            return {"ok": True, "index": self.index}
        if op == "cache_get":
            from ..utils.metrics import registry
            from .shm import SHM_MIN_BYTES

            h = payload["hash"]
            data = await self.garage.block_manager.rpc_get_block(
                h, cacheable=True, route=False, charge=False)
            registry().inc("gateway_cache_forward_served")
            # zero-copy reply: publish once into our shm ring and ship
            # the tiny reference instead of the payload. Small payloads
            # and a lease-exhausted ring take the socket as before.
            if self.shm is not None and not payload.get("no_shm") \
                    and len(data) >= SHM_MIN_BYTES:
                ref = self.shm.publish(h, data)
                if ref is not None:
                    registry().inc("cache_tier_shm_publish")
                    return {"shm": ref}
            return {"data": data}
        if op == "metrics":
            text = await asyncio.to_thread(self._admin.render_metrics)
            return {"text": text}
        if op == "tuning":
            return apply_s3_tuning(self.garage, payload.get("spec") or {})
        if op == "tuning_state":
            return s3_tuning_state(self.garage)
        if op == "qos":
            self.garage.qos.update_limits(payload.get("spec") or {})
            return self.garage.qos.state()
        if op == "qos_state":
            return self.garage.qos.state()
        if op == "chaos":
            return apply_chaos_spec(payload.get("spec") or {})
        from ..utils.error import RpcError

        raise RpcError(f"unknown gateway worker op {op!r}")


def _boot_device(device: str) -> None:
    """Reach the worker's device before any hello: a CUDA device gets
    its context now. Raises if the device cannot be reached."""
    from .. import resolve_device
    from ..block.feeder import probe_device

    dev = resolve_device(device)
    res = probe_device(dev)
    if not res["ok"]:
        raise RuntimeError(f"gateway worker device {device}: "
                           f"{res['error']}")
    if dev.type == "cuda":
        import torch

        torch.empty(1, device=dev)


async def run_worker(cfg_path: str, index: int, workers: int,
                     store: str, device: str = "cuda") -> None:
    from ..utils.runtime import tune

    tune()
    cfg = await asyncio.to_thread(read_config, cfg_path)
    if cfg.tpu.enable:  # `enable = false`: host-only, no device to reach
        await asyncio.to_thread(_boot_device, device)
    from ..model.garage import parse_peer

    store_addr, store_id = parse_peer(store)
    if store_id is None:
        raise ValueError("--store must be '<hex node id>@host:port'")
    wcfg = derive_worker_config(cfg, index, workers, store)
    os.makedirs(wcfg.metadata_dir, exist_ok=True)
    from ..utils import lockfile

    deadline = time.monotonic() + 10.0
    while True:
        try:
            lock_fd = lockfile.acquire(wcfg.metadata_dir, "server")
            break
        except lockfile.AlreadyLocked:
            # a killed predecessor still exiting (a CUDA context takes
            # a moment to tear down): its flock goes with its last fd
            if time.monotonic() > deadline:
                raise
            await asyncio.sleep(0.2)
    try:
        await _run_worker_locked(cfg, wcfg, index, store_id, device)
    finally:
        # released on EVERY exit (GL11): a worker that dies during
        # boot must not wedge its per-index lockfile for the respawn
        # (the an earlier change orphan-worker failure shape)
        lockfile.release(lock_fd)


async def _run_worker_locked(cfg, wcfg, index: int, store_id: bytes,
                             device: str) -> None:
    from ..model.garage import Garage

    garage = Garage(wcfg, device=device)
    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for name in ("SIGINT", "SIGTERM", "SIGHUP"):
        sig = getattr(signal, name, None)
        if sig is None:
            continue
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass

    # API-only: gossip + RPC listen, but no table/block/scrub workers —
    # the store node keeps all background work
    system_task = asyncio.create_task(garage.run(spawn_workers=False))
    client = GatewayWorkerClient(garage, index, store_id, cfg.gateway)
    await client.start()

    from ..api.s3.api_server import S3ApiServer
    from ..model.garage import parse_addr

    servers = []
    s3 = None
    if cfg.s3_api_bind_addr:
        s3 = S3ApiServer(garage)
        await s3.start(*parse_addr(cfg.s3_api_bind_addr),
                       reuse_port=True)
        servers.append(s3)
    if cfg.k2v_api_bind_addr:
        from ..api.k2v.api_server import K2VApiServer

        k2v = K2VApiServer(garage)
        await k2v.start(*parse_addr(cfg.k2v_api_bind_addr),
                        reuse_port=True)
        servers.append(k2v)
    if cfg.web_bind_addr:
        from ..web.server import WebServer

        web = WebServer(garage, s3)
        await web.start(*parse_addr(cfg.web_bind_addr), reuse_port=True)
        servers.append(web)

    log.info("gateway worker %d up (node %s, store %s)", index,
             garage.system.id.hex()[:16], store_id.hex()[:16])
    await stop.wait()
    log.info("gateway worker %d shutting down", index)
    client.stop()
    for s in servers:
        await s.stop()
    await garage.stop()
    system_task.cancel()


def main() -> None:
    p = argparse.ArgumentParser(prog="garage_tpu_torch.gateway.worker")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--index", type=int, required=True)
    p.add_argument("--workers", type=int, required=True)
    p.add_argument("--store", required=True,
                   help="store node as '<hex id>@host:port'")
    p.add_argument("--device", default="cuda",
                   help='torch device of the block math: the store '
                   'node\'s ("cuda" by default, or "cpu")')
    p.add_argument("--log-level",
                   default=os.environ.get("RUST_LOG", "info"))
    args = p.parse_args()
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format=f"%(asctime)s %(levelname)s [w{args.index}] "
               "%(name)s: %(message)s",
    )
    asyncio.run(run_worker(args.config, args.index, args.workers,
                           args.store, args.device))


if __name__ == "__main__":
    main()
