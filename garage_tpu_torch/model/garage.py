"""Garage: the composition root that turns the libraries into a node
(ported from the JAX package's model/garage.py).

What differs from the JAX package: Garage takes a torch `device`
("cuda" unless the caller asks for "cpu") and hands it to the
BlockManager. The config file format is the JAX package's, so one
garage.toml serves both packages. `[tpu] enable = false` builds the
host-only node (feeder mode "off") on any device, as in the JAX package;
`enable = true` gives feeder mode "require", where the JAX package's is
"auto" (block/feeder.py says why). The feeder honours every other
`[tpu]` key but `platform` (a JAX platform pin), which is named in one
warning when set (`check_tpu_section`); the routing floors, trial caps
and `device_backend` act in "auto" as there.

Ref parity: src/model/garage.rs:37-334. Opens the db, builds the
System/NetApp, the BlockManager, and all tables with their replication
parameters (data: read quorum 1; metadata: full quorums; control:
full-copy), wires the block_ref -> block rc trigger chain and the rc
recalculator, and spawns every background worker.

Replication parameter table (ref: garage.rs:154-170):
  data (block refs)   sharded, R=1-ish .. erasure-widened placement
  meta (obj/ver/mpu)  sharded, R/W from replication mode
  control (bucket/key/alias)  full-copy
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
from typing import Optional

from ..block.layout import DataDir as LayoutDataDir
from ..block.layout import DataLayout
from ..block.manager import BlockManager
from ..db import open_db
from ..net import NetApp
from ..rpc.layout.manager import LayoutManager  # noqa: F401 (re-export)
from ..rpc.replication_mode import ReplicationMode
from ..rpc.rpc_helper import RpcHelper
from ..rpc.system import System, load_or_gen_node_key
from ..table.replication import (TableFullReplication,
                                 TableShardedReplication)
from ..table.table import Table
from ..utils.background import BackgroundRunner, BgVars
from ..utils.config import Config, TpuConfig
from ..utils.persister import Persister
from .bucket_alias_table import BucketAliasTable
from .bucket_table import BucketTable
from .index_counter import IndexCounter
from .key_table import KeyTable
from .s3.block_ref_table import (BlockRefReplication, BlockRefTable,
                                 block_ref_recount_fn)
from .s3.mpu_table import MultipartUploadTable
from .s3.object_table import ObjectTable
from .s3.version_table import VersionTable

log = logging.getLogger("garage_tpu_torch.model")


def parse_addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host.strip("[]"), int(port))


# [tpu] keys the port acts on: all of TpuConfig but `platform`, a JAX
# platform pin with no counterpart on a CUDA node
_TPU_HONOURED = ("enable", "batch_blocks", "inflight_batches",
                 "device_min_bytes", "device_min_items",
                 "device_min_decode_bytes", "device_min_decode_items",
                 "trial_max_items", "trial_items_cap", "trial_max_bytes",
                 "pad_buckets", "mesh_min_items", "device_backend",
                 "batch_timeout_s", "batch_linger_ms")


def check_tpu_section(tpu: TpuConfig) -> list[str]:
    """The `[tpu]` keys set to a non-default value that the port
    ignores."""
    default = TpuConfig()
    return sorted(f.name for f in dataclasses.fields(TpuConfig)
                  if f.name not in _TPU_HONOURED
                  and getattr(tpu, f.name) != getattr(default, f.name))


def parse_peer(s: str) -> tuple[tuple[str, int], Optional[bytes]]:
    """"<hex node id>@host:port" or "host:port" -> (addr, id|None)."""
    if "@" in s:
        nid, _, addr = s.partition("@")
        return parse_addr(addr), bytes.fromhex(nid)
    return parse_addr(s), None


class Garage:
    def __init__(self, config: Config, local_net=None,
                 status_interval: Optional[float] = None,
                 ping_interval: Optional[float] = None,
                 device="cuda"):
        ignored = check_tpu_section(config.tpu)
        if ignored:
            log.warning("[tpu] keys with no meaning on the port, ignored: "
                        "%s", ", ".join(ignored))
        self.config = config
        self.bg_vars = BgVars()
        from ..utils.data import set_content_hash_algo

        set_content_hash_algo(config.block_hash_algo)
        from .. import native

        native.warm_async()  # build the C kernels off the event loop
        os.makedirs(config.metadata_dir, exist_ok=True)
        for d in config.data_dirs:
            os.makedirs(d.path, exist_ok=True)

        # ---- db (ref: garage.rs:95-116) --------------------------------
        db_path = os.path.join(config.metadata_dir, "db")
        self.db = open_db(db_path, engine=config.db_engine,
                          fsync=config.metadata_fsync)

        # ---- identity / net (ref: garage.rs:118-130, system.rs) --------
        netid = (bytes.fromhex(config.rpc_secret) if config.rpc_secret
                 else b"garage-tpu-insecure-dev")
        privkey = load_or_gen_node_key(config.metadata_dir)
        bind = parse_addr(config.rpc_bind_addr)
        public = (parse_addr(config.rpc_public_addr)
                  if config.rpc_public_addr else bind)
        self.netapp = NetApp(netid, privkey, bind_addr=bind, public_addr=public)
        if local_net is not None:
            local_net.register(self.netapp)

        self.replication = ReplicationMode.parse(
            config.replication_factor, config.consistency_mode,
            config.erasure_coding,
        )
        bootstrap = [(a, i) for a, i in map(parse_peer, config.bootstrap_peers)]
        kwargs = {}
        if status_interval is not None:
            kwargs["status_interval"] = status_interval
        if ping_interval is not None:
            kwargs["ping_interval"] = ping_interval
        from ..rpc.discovery import providers_from_config

        self.system = System(
            self.netapp, self.replication, config.metadata_dir,
            data_dirs=[d.path for d in config.data_dirs],
            bootstrap_peers=bootstrap,
            discovery=providers_from_config(config), **kwargs,
        )
        self.system.layout_manager.set_broadcast_debounce(
            config.rpc_layout_debounce_ms / 1000.0)
        rpc = RpcHelper(self.system)
        self.rpc = rpc
        rm = self.replication

        # ---- replication parameters (ref: garage.rs:154-170) -----------
        meta_rep = TableShardedReplication(
            self.system, rm.read_quorum, rm.write_quorum
        )
        control_rep = TableFullReplication(self.system)
        # block_ref rows must reach every shard holder (erasure widens
        # the placement beyond rf; see BlockRefReplication docstring)
        block_ref_rep = BlockRefReplication(
            self.system, rm.read_quorum, rm.write_quorum, rm.storage_width
        )

        # ---- block manager (ref: garage.rs:172-176) --------------------
        self.data_layout = self._load_data_layout(config)
        self.block_manager = BlockManager(
            self.system, self.db, self.data_layout,
            compression=config.compression_level is not None,
            fsync=config.data_fsync,
            device=device,
            device_mode="require" if config.tpu.enable else "off",
            device_batch_blocks=config.tpu.batch_blocks,
            tpu_cfg=config.tpu,
            ram_buffer_max=config.block_ram_buffer_max,
            read_cache_max_bytes=config.block_read_cache_max_bytes,
            resync_breaker_aware=config.block_resync_breaker_aware,
            cache_tier=config.block_cache_tier,
            cache_tier_hint_top_n=config.block_cache_tier_hint_top_n,
            cache_lease_wait_ms=config.block_cache_lease_wait_ms,
            cache_prefetch_inflight=config.block_cache_prefetch_inflight,
            cache_packed_max_bytes=config.block_cache_packed_max_bytes,
        )

        # ---- tables (ref: garage.rs:178-248) ---------------------------
        self.bucket_table = Table(BucketTable(), control_rep, rpc, self.db)
        self.bucket_alias_table = Table(BucketAliasTable(), control_rep, rpc,
                                        self.db)
        self.key_table = Table(KeyTable(), control_rep, rpc, self.db)

        self.block_ref_table = Table(
            BlockRefTable(self.block_manager), block_ref_rep, rpc, self.db
        )
        self.version_table = Table(
            VersionTable(self.block_ref_table), meta_rep, rpc, self.db
        )
        self.mpu_counter = IndexCounter(self.system, meta_rep, rpc, self.db,
                                        "bucket_mpu_counter")
        self.mpu_table = Table(
            MultipartUploadTable(self.version_table, self.mpu_counter),
            meta_rep, rpc, self.db,
        )
        self.object_counter = IndexCounter(self.system, meta_rep, rpc, self.db,
                                           "bucket_object_counter")
        self.object_table = Table(
            ObjectTable(self.version_table, self.mpu_table,
                        self.object_counter),
            meta_rep, rpc, self.db,
        )

        # ---- K2V (ref: garage.rs:206-248 + model/k2v/) -----------------
        from .k2v.item_table import K2VItemTable
        from .k2v.rpc import K2VRpcHandler, SubscriptionManager

        self.k2v_subscriptions = SubscriptionManager()
        self.k2v_counter = IndexCounter(self.system, meta_rep, rpc, self.db,
                                        "k2v_index_counter")
        self.k2v_item_table = Table(
            K2VItemTable(self.k2v_counter, self.k2v_subscriptions),
            meta_rep, rpc, self.db,
        )
        self.k2v_rpc = K2VRpcHandler(self.system, self.db,
                                     self.k2v_item_table,
                                     self.k2v_subscriptions)

        # rc recalculation from the block_ref store (ref: garage.rs:252-256)
        self.block_manager.rc.register_calculator(
            block_ref_recount_fn(self.block_ref_table)
        )

        # ---- qos admission control (qos/) ------------------------------
        from ..qos import QosEngine
        from ..qos.limiter import QosLimits

        qc = config.qos
        self.qos = QosEngine(QosLimits(
            global_rps=qc.global_rps, global_burst=qc.global_burst,
            global_bytes_per_s=qc.global_bytes_per_s,
            global_bytes_burst=qc.global_bytes_burst,
            per_key_rps=qc.per_key_rps,
            per_bucket_rps=qc.per_bucket_rps,
            max_concurrent=qc.max_concurrent, max_queue=qc.max_queue,
            max_wait_s=qc.max_wait_s, fair_keys=qc.fair_keys,
        ))
        # foreground block-read bytes (cache hit AND store miss alike)
        # consume the qos bytes budget (shape_bytes never sheds, it
        # just paces): GET/copy traffic is priced evenly wherever it is
        # served from, and a hot set cannot ride the cache past the
        # configured byte rate
        self.block_manager.read_qos_charge = self.qos.shape_bytes
        self.qos_governor = None  # spawned in spawn_workers
        self.lsm_maintenance = None  # spawned in spawn_workers (lsm only)

        # ---- self-healing rpc knobs ([rpc] section) --------------------
        self.system.peering.health.configure(
            hedging=config.rpc_hedging,
            hedge_rate=config.rpc_hedge_rate,
            adaptive_timeout=config.rpc_adaptive_timeout,
            write_hedging=config.rpc_hedge_writes,
        )

        # ---- fault injection ([chaos] section) -------------------------
        # boot-time arming for chaos experiments / CI; runtime control
        # stays available through admin GET/POST /v1/chaos either way.
        # The zone resolver is installed unconditionally (cheap: one
        # attribute write) so a partition_zone fault armed later via
        # admin POST /v1/chaos can resolve frame endpoints to zones —
        # every node converges on the same layout, so any node's view
        # serves the process-global controller.
        from ..chaos import controller as chaos_controller
        from ..zones import layout_zone_resolver

        chaos_controller().zone_resolver = layout_zone_resolver(
            self.system.layout_manager)
        if config.chaos.enable:
            from ..chaos import FaultSpec, arm

            chaos = arm(seed=config.chaos.seed)
            for spec in config.chaos.faults:
                chaos.add(FaultSpec(**dict(spec)))

        # one global lock serializing bucket/key/alias mutations
        # (ref: garage.rs:61 bucket_lock + helper/locked.rs)
        self.bucket_lock = asyncio.Lock()

        self.runner = BackgroundRunner()
        self._run_task: Optional[asyncio.Task] = None

    def _load_data_layout(self, config: Config) -> DataLayout:
        multi = len(config.data_dirs) > 1
        dirs = []
        for d in config.data_dirs:
            if d.read_only or (multi and d.capacity is None):
                # multi-HDD entries without a declared capacity are
                # read-only (utils/config.py DataDir semantics; the
                # reference rejects them at config parse)
                cap = 0
            else:
                cap = d.capacity or 1  # single dir: proportion is moot
            dirs.append(LayoutDataDir(d.path, cap))
        if not dirs:
            dirs = [LayoutDataDir(os.path.join(config.metadata_dir, "data"), 1)]
        persister = Persister(config.metadata_dir, "data_layout", DataLayout)
        self._data_layout_persister = persister
        prev = persister.load()
        if prev is None:
            lay = DataLayout.initialize(dirs)
        elif ([d.path for d in prev.dirs] != [d.path for d in dirs]
              or [d.capacity for d in prev.dirs] != [d.capacity for d in dirs]):
            lay = prev.update_dirs(dirs)  # rebalance worker migrates files
        else:
            return prev
        persister.save(lay)
        return lay

    # ---- lifecycle (ref: garage/server.rs:30-120) ----------------------

    def all_tables(self) -> list[Table]:
        return [
            self.bucket_table, self.bucket_alias_table, self.key_table,
            self.object_table, self.version_table, self.block_ref_table,
            self.mpu_table, self.object_counter.table, self.mpu_counter.table,
            self.k2v_item_table, self.k2v_counter.table,
        ]

    def spawn_workers(self, scrub: bool = True) -> None:
        """ref: model/garage.rs:282-334 spawn_workers."""
        for t in self.all_tables():
            t.spawn_workers(self.runner)
        self.block_manager.spawn_workers(self.runner, scrub=scrub)
        self.block_manager.register_bg_vars(self.bg_vars)
        if self.db.engine_name == "lsm":
            # background size-tiered compaction, paced by the governor
            # exactly like resync/scrub (README "Metadata at scale")
            from ..db.lsm import LsmMaintenanceWorker

            self.lsm_maintenance = LsmMaintenanceWorker(self.db)
            self.runner.spawn_worker(self.lsm_maintenance)
        qc = self.config.qos
        if qc.governor:
            from ..qos import GovernorWorker

            self.qos_governor = GovernorWorker(
                self, interval=qc.governor_interval,
                target_latency=qc.governor_target_latency,
                scrub_range=(qc.scrub_tranquility_min,
                             qc.scrub_tranquility_max),
                resync_range=(qc.resync_tranquility_min,
                              qc.resync_tranquility_max),
                resync_backlog_ref=qc.resync_backlog_ref,
                table_sync_tranq_max=self.config.table_sync_tranquility_max,
            )
            self.runner.spawn_worker(self.qos_governor)
            gov = self.qos_governor

            bm = self.block_manager

            def set_gov(v):
                gov.enabled = v.lower() in ("1", "true", "yes")
                if gov.enabled:
                    # re-enabling hands the tranquility knobs back from
                    # any manual `worker set` override
                    bm.resync.tranquility_manual = False
                    sw = getattr(bm, "scrub_worker", None)
                    if sw is not None:
                        sw.state.tranquility_manual = False
                        sw.persister.save(sw.state)

            self.bg_vars.register_rw("qos-governor",
                                     lambda: int(gov.enabled), set_gov)
        from .s3.lifecycle_worker import LifecycleWorker

        self.runner.spawn_worker(LifecycleWorker(self))
        if self.config.metadata_auto_snapshot_interval:
            from .snapshot import AutoSnapshotWorker

            self.runner.spawn_worker(AutoSnapshotWorker(
                self, self.config.metadata_auto_snapshot_interval))

    async def run(self, spawn_workers: bool = True) -> None:
        """Start listening + gossip + workers; returns when stop() is
        called."""
        if spawn_workers:
            self.spawn_workers()
        await self.system.run()

    async def stop(self) -> None:
        await self.runner.shutdown()
        await self.block_manager.stop()
        await self.system.stop()
        self.db.close()
