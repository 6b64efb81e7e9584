"""The cell's deployment: `nodes` garage_tpu_torch nodes in this process
on the port's loopback transport, one storage role each in one zone
(the pattern of chip_smoke.py's PortCluster), node 0 serving S3 over
loopback HTTP. The configuration file's "garage", "qos" and "tpu"
objects are the fields of the port's Config, QosConfig and TpuConfig."""

from __future__ import annotations

import asyncio
import os
import time


class Cluster:
    def __init__(self, root: str, cfg: dict, device: str):
        from garage_tpu_torch.net import LocalNetwork

        self.root, self.cfg, self.device = root, cfg, device
        self.n = cfg["nodes"]
        self.net = LocalNetwork()
        self.garages: list = []
        self.tasks: list = []
        self.alive: list = []
        self.s3 = None

    def data_dir(self, i: int) -> str:
        return os.path.join(self.root, f"node{i:02d}", "data")

    def _config(self, i: int):
        from garage_tpu_torch.utils.config import (Config, DataDir,
                                                   QosConfig, TpuConfig)

        d = os.path.join(self.root, f"node{i:02d}")
        return Config(metadata_dir=os.path.join(d, "meta"),
                      data_dir=[DataDir(path=self.data_dir(i))],
                      qos=QosConfig(**self.cfg.get("qos", {})),
                      tpu=TpuConfig(**self.cfg.get("tpu", {})),
                      **self.cfg["garage"])

    def _node_key(self, i: int) -> None:
        """A fixed identity for node i (the 32 raw bytes of its key, where
        the node reads them at boot): every run builds the same ring and
        the same layout, so runs differ in their traffic only."""
        import hashlib

        meta = os.path.join(self.root, f"node{i:02d}", "meta")
        os.makedirs(meta, exist_ok=True)
        with open(os.path.join(meta, "node_key"), "wb") as f:
            f.write(hashlib.sha256(b"portbench node %d" % i).digest())

    async def _wait(self, cond, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise RuntimeError(f"cluster: timeout waiting for {what}")
            await asyncio.sleep(0.05)

    async def start(self) -> None:
        from garage_tpu_torch.model.garage import Garage
        from garage_tpu_torch.rpc.layout import NodeRole

        for i in range(self.n):
            self._node_key(i)
            g = Garage(self._config(i), local_net=self.net,
                       status_interval=1.0, ping_interval=2.0,
                       device=self.device)
            self.garages.append(g)
            self.tasks.append(asyncio.create_task(g.run()))
            self.alive.append(True)
        g0 = self.garages[0]
        for g in self.garages[1:]:
            await g.netapp.try_connect(g0.netapp.public_addr, g0.system.id)
            g.system.peering.add_peer(g0.netapp.public_addr, g0.system.id)
        await self._wait(lambda: all(len(g.netapp.conns) >= self.n - 1
                                     for g in self.garages), 120, "mesh")
        lm = g0.system.layout_manager
        for g in self.garages:
            lm.history.stage_role(g.system.id,
                                  NodeRole(zone="dc1", capacity=1 << 40))
        self.layout_applied = time.monotonic()
        lm.apply_staged(None)
        await self._wait(lambda: all(
            g.system.layout_manager.history.current().version == 1
            for g in self.garages), 120, "layout v1")

    def deployed_intervals(self) -> None:
        """From here on every node gossips at the program's defaults, as a
        deployment does: status exchange every 10 s, pings every 15 s,
        connection retries every 30 s. The nodes boot at 1 s and 2 s, so
        that the mesh and the layout converge in seconds; the window does
        not pay for that."""
        from garage_tpu_torch.net.peering import (CONN_RETRY_INTERVAL,
                                                  PING_INTERVAL)
        from garage_tpu_torch.rpc.system import STATUS_EXCHANGE_INTERVAL

        for g in self.garages:
            g.system.status_interval = STATUS_EXCHANGE_INTERVAL
            g.system.peering.ping_interval = PING_INTERVAL
            g.system.peering.retry_interval = CONN_RETRY_INTERVAL

    def syncers(self) -> list:
        return [t.syncer for g, up in zip(self.garages, self.alive) if up
                for t in g.all_tables()]

    async def settle(self, timeout: float = 240.0) -> float:
        """Wait for the anti-entropy round that the layout's application
        starts on every table of every node (every syncer walks its 256
        partitions with each peer) to end: a deployment serves at that
        steady state, not in the storm after a bootstrap. -> seconds
        waited. The port offers no public reading of a syncer's rounds,
        so this reads TableSyncer's `_layout_version` and `_last_sync`
        (PERF.md lists them among what the yardstick depends on)."""
        t = time.monotonic()
        version = self.garages[0].system.layout_helper.current().version

        def done() -> bool:
            return all(s._layout_version == version
                       and s._last_sync >= self.layout_applied
                       for s in self.syncers())
        await self._wait(done, timeout, "the tables' first anti-entropy "
                         "round")
        return time.monotonic() - t

    async def serve_s3(self) -> int:
        from garage_tpu_torch.api.s3.api_server import S3ApiServer

        self.s3 = S3ApiServer(self.garages[0])
        await self.s3.start("127.0.0.1", 0)
        return self.s3.http.bound_port

    async def key_and_bucket(self, bucket: str) -> tuple[str, str]:
        """A key with read and write on a new bucket, through node 0's
        admin RPC operations."""
        from garage_tpu_torch.admin.rpc import AdminRpcHandler

        admin = AdminRpcHandler(self.garages[0])
        k = await admin.op_key_new({"name": "bench"})
        await admin.op_bucket_create({"name": bucket})
        await admin.op_bucket_allow({"bucket": bucket, "key": k["key_id"],
                                     "read": True, "write": True})
        return k["key_id"], k["secret_key"]

    async def stop_node(self, i: int) -> None:
        """A node goes away: its transport first, then its Garage."""
        g = self.garages[i]
        self.alive[i] = False
        self.net.nodes.pop(g.system.id, None)
        await g.netapp.shutdown()
        await g.stop()
        self.tasks[i].cancel()
        await asyncio.gather(self.tasks[i], return_exceptions=True)

    def feeders(self) -> list:
        return [g.block_manager.feeder for g in self.garages]

    async def stop(self) -> None:
        if self.s3 is not None:
            await self.s3.stop()
        live = [self.garages[i] for i, up in enumerate(self.alive) if up]
        for g in live:
            await g.netapp.shutdown()
        await asyncio.gather(*(g.stop() for g in live))
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)
