"""Copy of garage_tpu/model/snapshot.py: import paths rewritten, issue and PR tags dropped.

Metadata DB snapshots + auto-snapshot worker.

Ref parity: src/model/snapshot.rs:17-140. `snapshot_metadata` hot-copies
the metadata database (engine-level Db.snapshot) into a timestamped
directory under `metadata_snapshots_dir` (default
`{metadata_dir}/snapshots`), keeping the 2 most recent. The
AutoSnapshotWorker runs it on `metadata_auto_snapshot_interval` with the
reference's first-run-at-half-interval and ±20% jitter.
"""

from __future__ import annotations

import asyncio
import datetime
import logging
import os
import random
import shutil
import threading
import time

from ..utils.background import Worker, WorkerInfo, WState

log = logging.getLogger("garage_tpu_torch.model.snapshot")

KEEP_SNAPSHOTS = 2

_snapshot_lock = threading.Lock()


def snapshots_dir(config) -> str:
    d = getattr(config, "metadata_snapshots_dir", None)
    return d or os.path.join(config.metadata_dir, "snapshots")


def snapshot_metadata(garage) -> str:
    """Take one snapshot; returns its path. Blocking — run in a thread.
    Raises if another snapshot is in progress (ref: snapshot.rs
    SNAPSHOT_MUTEX try_lock)."""
    if not _snapshot_lock.acquire(blocking=False):
        raise RuntimeError("another snapshot is already in progress")
    try:
        base = snapshots_dir(garage.config)
        os.makedirs(base, exist_ok=True)
        stamp = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H-%M-%SZ")
        path = os.path.join(base, stamp)
        log.info("snapshotting metadata db to %s", path)
        garage.db.snapshot(path)
        _cleanup(base)
        return path
    finally:
        _snapshot_lock.release()


def _cleanup(base: str) -> None:
    try:
        entries = sorted(e for e in os.listdir(base) if len(e) > 8)
    except OSError:
        return
    for name in entries[:-KEEP_SNAPSHOTS] if len(entries) > KEEP_SNAPSHOTS \
            else []:
        p = os.path.join(base, name)
        try:
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.remove(p)
        except OSError as e:
            log.error("failed to clean old snapshot %s: %s", p, e)


class AutoSnapshotWorker(Worker):
    def __init__(self, garage, interval: float):
        self.garage = garage
        self.name = "metadata auto-snapshot"
        self.interval = interval
        # first snapshot at half the interval (ref: snapshot.rs:103)
        self._next = time.monotonic() + interval / 2

    async def work(self):
        if time.monotonic() < self._next:
            return WState.IDLE
        await asyncio.to_thread(snapshot_metadata, self.garage)
        # lint: ignore[GL12] single snapshot worker task owns _next; BackgroundRunner never runs two work() frames of one worker concurrently
        self._next = time.monotonic() + self.interval * (
            1.0 + random.random() / 5.0)
        return WState.IDLE

    async def wait_for_work(self):
        await asyncio.sleep(max(1.0, self._next - time.monotonic()))

    def info(self):
        return WorkerInfo(
            name=self.name,
            progress=f"next in {max(0, self._next - time.monotonic()):.0f}s",
        )
