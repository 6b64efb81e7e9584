"""Copy of garage_tpu/model/s3/lifecycle_worker.py: import paths rewritten, issue and PR tags dropped.

Lifecycle worker: daily pass applying bucket lifecycle rules.

Ref parity: src/model/s3/lifecycle_worker.rs:36-380. Once per UTC day
the worker walks the local object table in key order (cursor-batched so
a batch never scans the whole tail), and for every object applies the
owning bucket's enabled rules:

- Expiration (AfterDays n / AtDate d): the current data version is
  replaced by a delete marker when old enough and the size filter
  matches.
- AbortIncompleteMultipartUpload (DaysAfterInitiation n): uploading
  versions older than n days flip to Aborted; the object-table trigger
  chain then tombstones their version rows and drops block refs.

Only `last_completed` (an ISO date) persists across restarts — a crash
mid-pass restarts the day's walk from the front, which is idempotent.
Buckets with no enabled rules are skipped wholesale by jumping the
cursor past the bucket's key range.
"""

from __future__ import annotations

import datetime
import logging

from ...table.data import _prefix_upper_bound
from ...table.schema import tree_key
from ...utils import migrate
from ...utils.background import Throttled, Worker, WorkerInfo, WState
from ...utils.crdt import now_msec
from ...utils.data import gen_uuid
from ...utils.persister import Persister
from .object_table import (Object, ObjectVersion, ObjectVersionData,
                           ObjectVersionState, ST_COMPLETE, ST_UPLOADING)

log = logging.getLogger("garage_tpu_torch.model.lifecycle")

BATCH = 100


def _date_of_msec(ts: int) -> datetime.date:
    return datetime.datetime.fromtimestamp(
        ts / 1000, datetime.timezone.utc).date()


def next_date(ts: int) -> datetime.date:
    """The day after the version's timestamp — a version expires N days
    after the *end* of its creation day (ref: lifecycle_worker.rs
    next_date)."""
    return _date_of_msec(ts) + datetime.timedelta(days=1)


def today() -> datetime.date:
    return datetime.datetime.now(datetime.timezone.utc).date()


class LifecycleState(migrate.Migratable):
    VERSION_MARKER = b"GTlfc01"

    def __init__(self, last_completed: str = ""):
        self.last_completed = last_completed  # ISO date or ""

    def pack(self):
        return [self.last_completed]

    @classmethod
    def unpack(cls, o):
        return cls(*o)


class LifecycleWorker(Worker):
    def __init__(self, garage):
        self.garage = garage
        self.name = "object lifecycle"
        self.persister = Persister(garage.config.metadata_dir,
                                   "lifecycle_state", LifecycleState)
        st = self.persister.load() or LifecycleState()
        self._running_date = None  # date of the in-progress pass
        self._next_start = b""  # next tree key to scan from (inclusive)
        self._last_completed = (
            datetime.date.fromisoformat(st.last_completed)
            if st.last_completed else None)
        self._expired = 0
        self._aborted = 0
        self._bucket_cache: tuple[bytes, object] | None = None

    def _due(self) -> bool:
        return self._last_completed is None or self._last_completed < today()

    async def work(self):
        if self._running_date is None:
            if not self._due():
                return WState.IDLE
            self._running_date = today()
            self._next_start = b""
            self._expired = self._aborted = 0
            log.info("lifecycle pass starting for %s", self._running_date)

        import asyncio

        store = self.garage.object_table.data.store
        batch = await asyncio.to_thread(
            lambda: list(store.iter(start=self._next_start or None,
                                    limit=BATCH)))
        if not batch:
            log.info("lifecycle pass for %s done: %d expired, %d mpu "
                     "aborted", self._running_date, self._expired,
                     self._aborted)
            self._last_completed = self._running_date
            self._running_date = None
            self.persister.save(LifecycleState(
                self._last_completed.isoformat()))
            return WState.IDLE
        for key, raw in batch:
            obj = self.garage.object_table.data.decode_stored(raw)
            skip_bucket = await self._process(obj)
            self._next_start = key + b"\x00"
            if skip_bucket:
                # rows group by hash(bucket) ++ bucket ++ key, so jumping
                # to the bucket's tree-key prefix upper bound skips the
                # whole bucket (ref: lifecycle_worker.rs Skip::SkipBucket)
                bound = _prefix_upper_bound(tree_key(obj.bucket_id, b""))
                if bound is not None:
                    self._next_start = max(self._next_start, bound)
                break
        return Throttled(0.01)

    async def _process(self, obj: Object) -> bool:
        """Apply rules to one object; True => skip rest of the bucket."""
        if not any(v.is_data or v.state.kind == ST_UPLOADING
                   for v in obj.versions):
            return False
        bucket = await self._get_bucket(obj.bucket_id)
        if bucket is None or bucket.params is None:
            return True
        rules = bucket.params.lifecycle_config.value or []
        if not any(r.get("enabled", True) for r in rules):
            return True
        now_date = self._running_date
        for rule in rules:
            if not rule.get("enabled", True):
                continue
            flt = rule.get("filter") or {}
            pfx = flt.get("prefix")
            if pfx and not obj.key.startswith(pfx):
                continue
            exp = rule.get("expiration")
            if exp is not None:
                cur = obj.last_data()
                if cur is not None and self._size_ok(cur, flt):
                    if isinstance(exp, int):
                        due = (now_date - next_date(cur.timestamp)
                               ).days >= exp
                    else:
                        try:
                            due = now_date >= datetime.date.fromisoformat(exp)
                        except ValueError:
                            log.warning("bad lifecycle date %r in bucket "
                                        "%s", exp, obj.bucket_id.hex()[:8])
                            due = False
                    if due:
                        marker = Object(obj.bucket_id, obj.key, [
                            ObjectVersion(
                                gen_uuid(),
                                max(now_msec(), cur.timestamp + 1),
                                ObjectVersionState.complete(
                                    ObjectVersionData.delete_marker()))])
                        await self.garage.object_table.insert(marker)
                        self._expired += 1
            abort_days = rule.get("abort_incomplete_mpu_days")
            if abort_days is not None:
                aborted = [
                    ObjectVersion(v.uuid, v.timestamp,
                                  ObjectVersionState.aborted())
                    for v in obj.versions
                    if v.state.kind == ST_UPLOADING
                    and (now_date - next_date(v.timestamp)).days
                    >= abort_days
                ]
                if aborted:
                    await self.garage.object_table.insert(
                        Object(obj.bucket_id, obj.key, aborted))
                    self._aborted += len(aborted)
        return False

    @staticmethod
    def _size_ok(version, flt: dict) -> bool:
        if version.state.kind != ST_COMPLETE:
            return False
        size = version.state.data.meta.size \
            if version.state.data.meta is not None else 0
        if flt.get("size_gt") is not None and not size > flt["size_gt"]:
            return False
        if flt.get("size_lt") is not None and not size < flt["size_lt"]:
            return False
        return True

    async def _get_bucket(self, bucket_id: bytes):
        if self._bucket_cache is not None \
                and self._bucket_cache[0] == bucket_id:
            return self._bucket_cache[1]
        b = await self.garage.bucket_table.get(bucket_id, b"")
        # lint: ignore[GL12] single lifecycle worker task owns this 1-entry cache; a racing fill would only re-cache the other bucket and the id check above re-fetches on mismatch
        self._bucket_cache = (bucket_id, b)
        return b

    async def wait_for_work(self):
        import asyncio

        await asyncio.sleep(60.0)

    def info(self):
        return WorkerInfo(
            name=self.name,
            progress=(self._next_start[:4].hex() if self._running_date
                      else (self._last_completed.isoformat()
                            if self._last_completed else "never")),
        )
