"""Copy of garage_tpu/model/repair.py: import paths rewritten, issue and PR tags dropped.

Online repair procedures.

Ref parity: src/garage/repair/online.rs:29-390. Each procedure is a
background worker that walks one local table store with a cursor and
fixes dangling references left by crashes or missed trigger runs:

- RepairVersions: a live Version whose backing object version no longer
  exists (or is Aborted) is tombstoned, which cascades to block refs.
- RepairBlockRefs: a live BlockRef whose Version is gone/deleted is
  tombstoned, releasing the block's refcount.
- RepairMpu: a live MultipartUpload whose object no longer shows the
  upload is tombstoned (parts cleared).
- BlockRcRepair: recomputes every block's refcount from the block_ref
  store (ref: repair/online.rs BlockRcRepair + block/rc.rs:83-130).
- RepairTables: queues a full anti-entropy pass on every table.

Launchable from the CLI (`repair <what>`) through the admin RPC.
"""

from __future__ import annotations

import logging

from ..utils.background import Worker, WorkerInfo, WState
from .s3.mpu_table import MultipartUpload
from .s3.object_table import ST_ABORTED
from .s3.version_table import BACKLINK_OBJECT, Version

log = logging.getLogger("garage_tpu_torch.model.repair")

BATCH = 64


class _TableRepairWorker(Worker):
    """Cursor walk over one table's local store; `process(entry)` returns
    True when it repaired something (ref: online.rs TableRepairWorker)."""

    def __init__(self, garage, table):
        self.garage = garage
        self.table = table
        self.name = f"{table.name} repair"
        self._pos = b""
        self.counter = 0
        self.repairs = 0
        self.done = False

    async def work(self):
        import asyncio

        store = self.table.data.store
        batch = await asyncio.to_thread(
            lambda: list(store.iter(
                start=self._pos + b"\x00" if self._pos else None,
                limit=BATCH)))
        if not batch:
            log.info("%s: finished, examined %d, fixed %d", self.name,
                     self.counter, self.repairs)
            self.done = True
            return WState.DONE
        for key, raw in batch:
            entry = self.table.data.decode_stored(raw)
            if await self.process(entry):
                self.repairs += 1
            self.counter += 1
            self._pos = key
        return WState.BUSY

    async def process(self, entry) -> bool:
        raise NotImplementedError

    def info(self):
        return WorkerInfo(name=self.name,
                          progress=f"{self.counter} ({self.repairs})")


class RepairVersions(_TableRepairWorker):
    def __init__(self, garage):
        super().__init__(garage, garage.version_table)

    async def process(self, version: Version) -> bool:
        if version.deleted.value:
            return False
        if version.backlink[0] == BACKLINK_OBJECT:
            _, bucket_id, key = version.backlink
            obj = await self.garage.object_table.get(
                bucket_id, key.encode() if isinstance(key, str) else key)
            exists = obj is not None and any(
                v.uuid == version.uuid and v.state.kind != ST_ABORTED
                for v in obj.versions)
        else:
            upload_id = version.backlink[1]
            mpu = await self.garage.mpu_table.get(upload_id, b"")
            exists = mpu is not None and not mpu.deleted.value
        if exists:
            return False
        log.info("repair versions: tombstoning %s", version.uuid.hex()[:8])
        await self.garage.version_table.insert(
            Version.new(version.uuid, version.backlink, deleted=True))
        return True


class RepairBlockRefs(_TableRepairWorker):
    def __init__(self, garage):
        super().__init__(garage, garage.block_ref_table)

    async def process(self, block_ref) -> bool:
        if block_ref.deleted.value:
            return False
        v = await self.garage.version_table.get(block_ref.version, b"")
        if v is not None and not v.deleted.value:
            return False
        from .s3.block_ref_table import BlockRef

        log.info("repair block refs: tombstoning ref %s -> %s",
                 block_ref.block.hex()[:8], block_ref.version.hex()[:8])
        await self.garage.block_ref_table.insert(
            BlockRef.new(block_ref.block, block_ref.version, deleted=True))
        return True


class RepairMpu(_TableRepairWorker):
    def __init__(self, garage):
        super().__init__(garage, garage.mpu_table)

    async def process(self, mpu: MultipartUpload) -> bool:
        if mpu.deleted.value:
            return False
        obj = await self.garage.object_table.get(
            mpu.bucket_id,
            mpu.key.encode() if isinstance(mpu.key, str) else mpu.key)
        exists = obj is not None and any(
            v.uuid == mpu.upload_id and v.is_uploading(check_multipart=True)
            for v in obj.versions)
        if exists:
            return False
        log.info("repair mpu: tombstoning upload %s",
                 mpu.upload_id.hex()[:8])
        tomb = MultipartUpload.new(mpu.upload_id, mpu.timestamp,
                                   mpu.bucket_id, mpu.key, deleted=True)
        await self.garage.mpu_table.insert(tomb)
        return True


class BlockRcRepair(Worker):
    """Recalculate every block's refcount from the block_ref store
    (ref: online.rs BlockRcRepair)."""

    def __init__(self, garage):
        self.garage = garage
        self.name = "block rc repair"
        self._cursor = b""
        self.counter = 0
        self.done = False

    async def work(self):
        import asyncio

        rc = self.garage.block_manager.rc
        hashes = await asyncio.to_thread(
            lambda: [h[0] for h in rc.tree.iter(
                start=self._cursor + b"\x00" if self._cursor else None,
                limit=BATCH)])
        if not hashes:
            log.info("block rc repair: finished, %d recalculated",
                     self.counter)
            self.done = True
            return WState.DONE
        for h in hashes:
            await asyncio.to_thread(rc.recalculate, h)
            self.counter += 1
            self._cursor = h
        return WState.BUSY

    def info(self):
        return WorkerInfo(name=self.name, progress=str(self.counter))


def launch_repair(garage, what: str):
    """Spawn the requested repair worker (ref: online.rs
    launch_online_repair). Returns a short description."""
    runner = garage.runner
    if what == "tables":
        for t in garage.all_tables():
            t.syncer.add_full_sync()
        return "full table sync queued on all tables"
    if what == "versions":
        runner.spawn_worker(RepairVersions(garage))
    elif what == "block-refs":
        runner.spawn_worker(RepairBlockRefs(garage))
    elif what == "mpu":
        runner.spawn_worker(RepairMpu(garage))
    elif what == "block-rc":
        runner.spawn_worker(BlockRcRepair(garage))
    elif what == "blocks":
        from ..block.repair import RepairWorker

        runner.spawn_worker(RepairWorker(garage.block_manager))
    elif what == "rebalance":
        from ..block.repair import RebalanceWorker

        runner.spawn_worker(RebalanceWorker(garage.block_manager))
    else:
        raise ValueError(f"unknown repair procedure {what!r}")
    return f"{what} repair worker launched"
