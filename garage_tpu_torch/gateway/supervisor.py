"""Gateway supervisor: runs inside the store node process (ported from
the JAX package's gateway/supervisor.py).

Starts N worker processes (`python -m garage_tpu_torch.gateway.worker`),
each an API-only Garage node binding the frontend ports with
SO_REUSEPORT, and then:

  * brokers qos budget leases over the `garage_tpu/gateway` RPC
    endpoint (workers renew every `[gateway] lease_interval_s`; the
    broker rebalances by observed demand — lease.py);
  * respawns crashed workers, rate-limited by `respawn_backoff_s`, and
    drains a dead worker's lease straight back into the pool;
  * hands every renew the live worker roster, which is what the
    worker-sharded read cache hashes block ownership over (ring.py);
  * fans runtime-knob writes (tuning/qos/chaos) out to all workers and
    pulls their /metrics renders for the aggregated exposition.

Worker identity is stable across respawns: worker i keeps its node key
under `{metadata_dir}/gateway/worker{i}`, so a respawned process
reconnects as the same peer and the roster (hence cache ownership)
does not churn.

What differs from the JAX package: the workers run on the store node's
torch `device` (`--device` on their command line): a CUDA store starts
CUDA workers, which never move to the CPU, and a "cpu" store CPU
workers. Each worker is a fresh interpreter (`subprocess.Popen`: fork
and exec, never a bare fork, whose child could not use a CUDA context
the store holds) with its own CUDA context and feeder on the card.
Before it starts them, a CUDA supervisor builds every kernel library
once (`ops._build.build_all`), so that N workers do not each run the
same nvcc jobs at their first launch; a `[tpu] enable = false` node
(host-only) builds none.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..net.message import PRIO_NORMAL
from ..utils.background import spawn
from ..utils.error import RpcError
from . import GATEWAY_RPC_PATH
from .lease import BudgetLeaseBroker

log = logging.getLogger("garage_tpu_torch.gateway.supervisor")


def resolve_workers(configured: int) -> int:
    """0 = auto(cpu_count); 1 = single-process (no supervisor)."""
    if configured == 0:
        return os.cpu_count() or 1
    return max(1, int(configured))


@dataclass
class WorkerProc:
    index: int
    proc: Optional[subprocess.Popen] = None
    node_id: Optional[bytes] = None
    restarts: int = 0
    last_spawn: float = field(default_factory=time.monotonic)
    ready: bool = False  # first hello received since (re)spawn

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None


class GatewaySupervisor:
    def __init__(self, garage, config_path: str,
                 n_workers: Optional[int] = None, device="cuda"):
        self.garage = garage
        self.config_path = config_path
        # the workers' torch device: the store node's
        self.device = str(device)
        cfg = garage.config
        self.gw_cfg = cfg.gateway
        self.n = n_workers if n_workers is not None \
            else resolve_workers(self.gw_cfg.workers)
        self.broker = BudgetLeaseBroker(
            cfg.qos.global_rps, cfg.qos.global_bytes_per_s,
            min_share=self.gw_cfg.min_share,
            ttl_s=self.gw_cfg.lease_ttl_s,
            expected_workers=self.n)
        self.endpoint = garage.system.netapp.endpoint(
            GATEWAY_RPC_PATH).set_handler(self._handle)
        self.workers: dict[int, WorkerProc] = {}
        self.restarts_total = 0
        self._stopping = False
        self._monitor_task: Optional[asyncio.Task] = None
        # runtime knobs fanned out since boot, replayed to a respawned
        # worker on its hello — a fresh process starts from the on-disk
        # config and would otherwise silently diverge from its siblings
        # (tuning/qos merge by key; chaos is an ordered log, compacted
        # at each clear=True spec)
        self._knob_state: dict[str, dict] = {"tuning": {}, "qos": {}}
        self._chaos_log: list[dict] = []
        garage.gateway_supervisor = self

    # ---- lifecycle -----------------------------------------------------

    def _store_peer(self) -> str:
        host, _, port = self.garage.config.rpc_bind_addr.rpartition(":")
        host = host.strip("[]")
        if host in ("0.0.0.0", "::", ""):
            host = "127.0.0.1"  # workers are always on this host
        return f"{self.garage.system.id.hex()}@{host}:{port}"

    def _spawn(self, index: int) -> None:
        wp = self.workers.setdefault(index, WorkerProc(index))
        argv = [sys.executable, "-m", "garage_tpu_torch.gateway.worker",
                "--config", self.config_path,
                "--index", str(index), "--workers", str(self.n),
                "--store", self._store_peer(), "--device", self.device]
        # inherit stdout/stderr: worker logs land next to the store's.
        # Workers never print the harness "ready" line — the supervisor
        # announces readiness only once every worker has said hello.
        wp.proc = subprocess.Popen(argv)
        wp.last_spawn = time.monotonic()
        wp.ready = False
        log.info("gateway worker %d spawned (pid %d)", index, wp.proc.pid)

    async def start(self, ready_timeout: float = 120.0) -> None:
        for bind in (self.garage.config.s3_api_bind_addr,
                     self.garage.config.k2v_api_bind_addr,
                     self.garage.config.web_bind_addr):
            if bind and bind.startswith("/"):
                raise RuntimeError(
                    "[gateway] workers > 1 requires TCP frontend binds "
                    "(SO_REUSEPORT does not apply to unix sockets): "
                    f"{bind}")
        if torch.device(self.device).type == "cuda" \
                and self.garage.config.tpu.enable:
            # one build for every worker, off the loop
            from ..ops import _build

            await asyncio.to_thread(_build.build_all)
        for i in range(self.n):
            await asyncio.to_thread(self._spawn, i)
        self._monitor_task = spawn(self._monitor_loop(),
                                   "gateway-supervisor-monitor")
        deadline = time.monotonic() + ready_timeout
        while time.monotonic() < deadline:
            if all(wp.ready for wp in self.workers.values()):
                log.info("gateway up: %d workers ready", self.n)
                return
            await asyncio.sleep(0.1)
        missing = [i for i, wp in self.workers.items() if not wp.ready]
        # failed startup must not orphan forked workers: they hold the
        # SO_REUSEPORT frontend port and their per-index lockfiles, and
        # would wedge every subsequent start of this node
        await self.stop()
        raise RuntimeError(f"gateway workers {missing} not ready after "
                           f"{ready_timeout:.0f}s")

    async def _monitor_loop(self) -> None:
        backoff = max(0.1, self.gw_cfg.respawn_backoff_s)
        while not self._stopping:
            await asyncio.sleep(0.25)
            self.broker.expire()
            for wp in self.workers.values():
                if self._stopping or wp.alive:
                    continue
                if wp.ready:
                    # just noticed the death: drain the lease back to
                    # the pool immediately — the budget must not sit
                    # idle in a corpse while the survivors shed
                    wp.ready = False
                    self.broker.revoke(f"w{wp.index}")
                    log.warning(
                        "gateway worker %d died (pid %s), lease drained",
                        wp.index, wp.pid)
                if time.monotonic() - wp.last_spawn >= backoff:
                    wp.restarts += 1
                    self.restarts_total += 1
                    # fork+exec off the loop: a slow spawn (cold page
                    # cache, cgroup pressure) must not stall the
                    # supervisor's own frontends
                    await asyncio.to_thread(self._spawn, wp.index)

    async def stop(self) -> None:
        self._stopping = True
        if self._monitor_task is not None:
            self._monitor_task.cancel()
        for wp in self.workers.values():
            if wp.alive:
                wp.proc.send_signal(signal.SIGTERM)
        for wp in self.workers.values():
            if wp.proc is not None:
                try:
                    await asyncio.to_thread(wp.proc.wait, 10)
                except subprocess.TimeoutExpired:
                    wp.proc.kill()

    # ---- worker RPC (lease protocol) -----------------------------------

    async def _handle(self, from_node, payload, stream):
        op = payload.get("op")
        if op in ("hello", "renew"):
            idx = int(payload["index"])
            wp = self.workers.get(idx)
            if wp is not None:
                newly_ready = not wp.ready
                wp.node_id = from_node
                wp.ready = True
                if newly_ready and (self._chaos_log
                                    or any(self._knob_state.values())):
                    # respawned (or late) worker: bring it up to the
                    # knob state its siblings already carry, off the
                    # hello path so the lease reply is not delayed
                    spawn(self._replay_knobs(wp),
                          f"gateway-knob-replay-{idx}")
            lease = self.broker.renew(
                f"w{idx}",
                float(payload.get("demand_rps", 0.0)),
                float(payload.get("demand_bps", 0.0)))
            return {
                "lease": lease.to_dict(),
                "roster": self.roster(),
                "interval_s": self.gw_cfg.lease_interval_s,
                "cache_shard": bool(self.gw_cfg.cache_shard),
            }
        raise RpcError(f"unknown gateway op {op!r}")

    def roster(self) -> list[list]:
        """Alive workers with known node ids, [(index, node_id hex,
        rpc addr|None)] — the membership the worker-sharded cache
        hashes over. Addresses (learned from each worker's peering
        hello) let siblings dial each other immediately instead of
        waiting out the ping-driven peer exchange."""
        peers = self.garage.system.peering.peers
        out = []
        for wp in sorted(self.workers.values(), key=lambda w: w.index):
            if not (wp.alive and wp.node_id is not None and wp.ready):
                continue
            p = peers.get(wp.node_id)
            addr = list(p.addr) if p is not None and p.addr else None
            out.append([wp.index, wp.node_id.hex(), addr])
        return out

    # ---- fan-out -------------------------------------------------------

    async def _replay_knobs(self, wp: WorkerProc) -> None:
        ops: list[tuple[str, dict]] = []
        for knob in ("tuning", "qos"):
            if self._knob_state[knob]:
                ops.append((knob, dict(self._knob_state[knob])))
        ops.extend(("chaos", s) for s in list(self._chaos_log))
        for op, spec in ops:
            try:
                await self.endpoint.call(
                    wp.node_id, {"op": op, "spec": spec}, PRIO_NORMAL,
                    timeout=10.0)
            except Exception as e:
                log.warning("knob replay (%s) to worker %d failed: %s",
                            op, wp.index, e)

    def _record_knobs(self, payload: dict) -> None:
        op, spec = payload.get("op"), payload.get("spec")
        if not isinstance(spec, dict) or not spec:
            return
        if op in ("tuning", "qos"):
            self._knob_state[op].update(spec)
        elif op == "chaos":
            if spec.get("clear"):
                self._chaos_log.clear()
            self._chaos_log.append(dict(spec))

    async def fanout(self, payload: dict, timeout: float = 10.0) -> dict:
        """Send one op to every ready worker; per-worker result or
        {"error": ...} — a worker mid-respawn must not fail the whole
        operator call. Knob-writing ops are recorded for replay to
        future respawns."""
        self._record_knobs(payload)
        async def one(wp: WorkerProc):
            try:
                resp, _ = await self.endpoint.call(
                    wp.node_id, payload, PRIO_NORMAL, timeout=timeout)
                return wp.index, resp
            except Exception as e:
                return wp.index, {"error": str(e)}

        targets = [wp for wp in self.workers.values()
                   if wp.alive and wp.node_id is not None and wp.ready]
        results = await asyncio.gather(*(one(wp) for wp in targets))
        return {idx: resp for idx, resp in results}

    # ---- surface -------------------------------------------------------

    def state(self) -> dict:
        # list() snapshot: state() runs on the /metrics scrape thread
        # while _spawn (loop) can insert into self.workers
        workers = sorted(list(self.workers.values()),
                         key=lambda w: w.index)
        return {
            "enabled": True,
            "workers_configured": self.n,
            "workers_alive": sum(1 for wp in workers if wp.alive),
            "restarts_total": self.restarts_total,
            "workers": [{
                "index": wp.index, "pid": wp.pid, "alive": wp.alive,
                "ready": wp.ready, "restarts": wp.restarts,
                "node": (wp.node_id.hex()[:16] if wp.node_id else None),
                "lease": dict(zip(("rps", "bytes_per_s"),
                                  self.broker.granted(f"w{wp.index}"))),
            } for wp in workers],
            "broker": self.broker.state(),
        }
