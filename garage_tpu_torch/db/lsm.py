"""Log-structured merge engine for metadata at millions of keys (ported
from the JAX package's db/lsm.py).

No reference analogue (the reference ships LMDB + sqlite behind the
same `db/` seam; this build's third engine targets the workload the
ROADMAP names "Metadata at millions of objects"): sqlite's B-tree pays
a read-modify-write per UPSERT, while S3 metadata at scale is
insert-mostly with long ordered scans — exactly the LSM sweet spot.

Layout on disk (one directory per db):

  wal.log            committed-transaction log: every commit appends one
                     length+crc framed msgpack batch; replayed on open.
                     Truncated only at flush-all, so every WAL record is
                     strictly newer than every segment.
  MANIFEST           msgpack: per-tree segment lists (newest first),
                     per-tree live-key counts, next segment id.
                     Rewritten atomically (tmp + rename) at every flush
                     and compaction.
  seg-<id>.sst       immutable sorted run: data blocks (msgpack entry
                     lists, ~32 KiB) + footer with a sparse first-key
                     block index and a bloom filter. Tombstones are
                     stored (value=None) so newer runs mask older ones;
                     a merge that includes the tree's oldest run drops
                     them for good.

Concurrency model matches the other engines: all calls arrive under the
Db RLock, synchronous. Durability: commits are flushed to the OS always
(a crashed *process* loses nothing); `fsync=True` (metadata_fsync)
additionally fsyncs the WAL per commit and segments/manifest per flush,
matching sqlite's synchronous=FULL semantics.

Snapshot iterators: `iter_snapshot()` freezes the active memtable
(pointer swap, not copy) and takes refcounts on the current segment
list; flushes and compactions proceed underneath while the iterator
streams a stable view. Compaction defers file unlink until the last
reader releases its ref (POSIX would allow unlinking open files, but
the refcount also keeps Windows/tests honest and bounds disk use
explicitly).

Background maintenance: `LsmMaintenanceWorker` (spawned by Garage when
db_engine="lsm") runs one `compact_once()` step per tick off the event
loop, pacing itself by `tranquility` — the qos governor maps foreground
pressure onto it exactly like resync/scrub, so a compaction storm
yields to user latency and sprints when the node is idle. Inline
backpressure: a flush that leaves a tree with an excessive segment
count runs merges synchronously so an idle-loop-less process (bench,
CLI) cannot accumulate unbounded runs.

What differs from the JAX package: a delete writes a tombstone only
where a run older than the active memtable (a frozen memtable or a
segment) holds the key live; otherwise it drops the key from the
memtable outright, since there is nothing to mask. Queue-like trees
(merkle todo, insert queue, resync queue) insert a key and delete it
soon after, and every scan from their start walked the tombstones of
all keys deleted since the last flush: a cost that grew through a run
until the 8 MiB flush, on worker threads that hold the interpreter
lock. Reads, counts, the WAL and its replay are unchanged.
"""

from __future__ import annotations

import bisect
import logging
import os
import struct
import threading
import zlib
from typing import Iterator, Optional, Tuple

import msgpack

from .db import PREV_UNKNOWN

log = logging.getLogger("garage_tpu_torch.db.lsm")

# ---- tuning constants (see README "Metadata at scale") -----------------

BLOCK_BYTES = 16 * 1024          # target data-block size in a segment
BLOOM_BITS_PER_KEY = 10          # ~1% false positives at K=5
BLOOM_K = 5
MEMTABLE_MAX_BYTES = 8 * 1024 * 1024   # flush-all threshold (sum of trees)
TIER_FANIN = 4                   # merge when a tier holds this many runs
MAX_SEGMENTS_HARD = 24           # inline-compact above this (backpressure)
BLOCK_CACHE_BLOCKS = 1024         # decoded blocks cached engine-wide

_MAGIC = b"GTLSM1\x00\x00"
_WAL_HDR = struct.Struct("<II")  # payload length, crc32


class Bloom:
    __slots__ = ("nbits", "bits")

    def __init__(self, nbits: int, bits: bytearray):
        self.nbits = nbits
        self.bits = bits

    @classmethod
    def build(cls, keys) -> "Bloom":
        nbits = max(64, len(keys) * BLOOM_BITS_PER_KEY)
        b = cls(nbits, bytearray((nbits + 7) // 8))
        for k in keys:
            h1 = zlib.crc32(k)
            h2 = zlib.adler32(k) | 1
            for i in range(BLOOM_K):
                pos = (h1 + i * h2) % nbits
                b.bits[pos >> 3] |= 1 << (pos & 7)
        return b

    def might_contain(self, key: bytes) -> bool:
        h1 = zlib.crc32(key)
        h2 = zlib.adler32(key) | 1
        nbits = self.nbits
        bits = self.bits
        for i in range(BLOOM_K):
            pos = (h1 + i * h2) % nbits
            if not bits[pos >> 3] >> (pos & 7) & 1:
                return False
        return True


class Segment:
    """One immutable sorted run, mmap-free random access via the sparse
    index. `refs` counts the manifest (1) plus live snapshot iterators;
    `drop()` marks it dead and the last `release()` unlinks it."""

    __slots__ = ("path", "seg_id", "f", "index", "bloom", "count",
                 "min_key", "max_key", "data_bytes", "refs", "_dead",
                 "_lock")

    def __init__(self, path: str, seg_id: int):
        self.path = path
        self.seg_id = seg_id
        self.f = open(path, "rb")
        self.f.seek(-16, os.SEEK_END)
        tail = self.f.read(16)
        if tail[8:] != _MAGIC:
            raise ValueError(f"bad segment magic in {path}")
        (flen,) = struct.unpack("<q", tail[:8])
        self.f.seek(-16 - flen, os.SEEK_END)
        foot = msgpack.unpackb(self.f.read(flen), raw=True)
        # index: [[first_key, offset, length], ...] ascending
        self.index = [(bytes(k), o, ln) for k, o, ln in foot[b"index"]]
        self.bloom = Bloom(foot[b"nbits"], bytearray(foot[b"bloom"]))
        self.count = foot[b"count"]
        self.min_key = bytes(foot[b"min"])
        self.max_key = bytes(foot[b"max"])
        self.data_bytes = foot[b"bytes"]
        self.refs = 1
        self._dead = False
        self._lock = threading.Lock()

    # refcounting -----------------------------------------------------

    def acquire(self) -> "Segment":
        with self._lock:
            self.refs += 1
        return self

    def release(self) -> None:
        with self._lock:
            self.refs -= 1
            gone = self.refs == 0 and self._dead
        if gone:
            self._close_unlink()

    def drop(self) -> None:
        """Release the manifest's reference (the constructor's ref=1)
        and mark the segment dead; the file disappears once the last
        snapshot reader releases too."""
        with self._lock:
            self._dead = True
            self.refs -= 1
            gone = self.refs == 0
        if gone:
            self._close_unlink()

    def _close_unlink(self) -> None:
        try:
            self.f.close()
        except Exception as e:
            log.debug("segment close failed for %s: %s", self.path, e)
        try:
            os.unlink(self.path)
        except OSError as e:
            log.debug("segment unlink failed for %s: %s", self.path, e)

    def close(self) -> None:
        try:
            self.f.close()
        except Exception as e:
            log.debug("segment close failed for %s: %s", self.path, e)

    # reads -----------------------------------------------------------

    def _block_at(self, i: int, cache) -> list:
        _, off, ln = self.index[i]
        ck = (self.path, off)
        blk = cache.get(ck)
        if blk is None:
            # positioned read: the unlocked compaction build iterates
            # victim segments from a worker thread while lock-holding
            # foreground gets read the same Segment — a shared seek
            # cursor would interleave
            if hasattr(os, "pread"):
                raw = os.pread(self.f.fileno(), ln, off)
            else:
                with self._lock:
                    self.f.seek(off)
                    raw = self.f.read(ln)
            blk = [(bytes(k), None if v is None else bytes(v))
                   for k, v in msgpack.unpackb(raw, raw=True)]
            cache.put(ck, blk)
        return blk

    def _block_index_for(self, key: bytes) -> int:
        """Index of the block that could contain `key` (-1 if before
        the first block)."""
        lo, hi = 0, len(self.index)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.index[mid][0] <= key:
                lo = mid + 1
            else:
                hi = mid
        return lo - 1

    def get(self, key: bytes, cache) -> tuple:
        """(found, value|None-tombstone). Bloom-filtered."""
        if key < self.min_key or key > self.max_key \
                or not self.bloom.might_contain(key):
            return (False, None)
        bi = self._block_index_for(key)
        if bi < 0:
            return (False, None)
        blk = self._block_at(bi, cache)
        lo = bisect.bisect_left(blk, (key,))
        if lo < len(blk) and blk[lo][0] == key:
            return (True, blk[lo][1])
        return (False, None)

    def iter_from(self, start: Optional[bytes], cache,
                  reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        """Yield (key, value|None) from `start` (inclusive forward /
        inclusive-upper reverse) in scan order. The entry position
        inside the first block is bisected, not scanned — a seek is
        O(log block), which is what makes delimiter skip-scan cheap."""
        n = len(self.index)
        if not reverse:
            bi = 0 if start is None else max(0, self._block_index_for(start))
            for i in range(bi, n):
                blk = self._block_at(i, cache)
                j = 0 if start is None or i != bi \
                    else bisect.bisect_left(blk, (start,))
                for e in range(j, len(blk)):
                    yield blk[e]
        else:
            bi = n - 1 if start is None else self._block_index_for(start)
            for i in range(bi, -1, -1):
                blk = self._block_at(i, cache)
                j = len(blk) if start is None or i != bi \
                    else bisect.bisect_left(blk, (start + b"\x00",))
                for e in range(j - 1, -1, -1):
                    yield blk[e]


class _BlockCache:
    """Tiny FIFO-ish cache of decoded data blocks, engine-wide. Locked:
    the compaction build thread and lock-holding foreground reads share
    it."""

    def __init__(self, cap: int = BLOCK_CACHE_BLOCKS):
        self.cap = cap
        self._d: dict = {}
        self._lock = threading.Lock()

    def get(self, k):
        with self._lock:
            return self._d.get(k)

    def put(self, k, v) -> None:
        with self._lock:
            if len(self._d) >= self.cap:
                # drop the oldest insertion (dicts preserve order)
                self._d.pop(next(iter(self._d)))
            self._d[k] = v

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


class _Memtable:
    """Sorted in-memory run: dict + sorted key list. Values of None are
    tombstones (mask older runs)."""

    __slots__ = ("d", "keys", "bytes")

    def __init__(self):
        self.d: dict[bytes, Optional[bytes]] = {}
        self.keys: list[bytes] = []
        self.bytes = 0

    def put(self, key: bytes, value: Optional[bytes]) -> None:
        if key in self.d:
            old = self.d[key]
            self.bytes -= len(old) if old is not None else 0
        else:
            bisect.insort(self.keys, key)
            self.bytes += len(key)
        self.d[key] = value
        self.bytes += len(value) if value is not None else 0

    def drop(self, key: bytes) -> None:
        """Forget `key`, leaving no tombstone."""
        if key not in self.d:
            return
        old = self.d.pop(key)
        self.bytes -= len(key) + (len(old) if old is not None else 0)
        i = bisect.bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            self.keys.pop(i)

    def get(self, key: bytes) -> tuple:
        if key in self.d:
            return (True, self.d[key])
        return (False, None)

    def iter_from(self, start: Optional[bytes],
                  reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        ks = self.keys
        if not reverse:
            i = 0 if start is None else bisect.bisect_left(ks, start)
            for j in range(i, len(ks)):
                k = ks[j]
                yield k, self.d[k]
        else:
            i = len(ks) if start is None else bisect.bisect_right(ks, start)
            for j in range(i - 1, -1, -1):
                k = ks[j]
                yield k, self.d[k]


class _TreeState:
    __slots__ = ("name", "mem", "frozen", "segments", "count")

    def __init__(self, name: str):
        self.name = name
        self.mem = _Memtable()
        self.frozen: list[_Memtable] = []   # newest first
        self.segments: list[Segment] = []   # newest first
        self.count = 0                      # live keys

    def sources(self):
        """All runs, newest first (merge precedence order)."""
        return [self.mem, *self.frozen, *self.segments]


_ABSENT = object()  # undo sentinel: key was not in the memtable


def _merged_iter(sources, start, reverse, cache):
    """K-way merge over runs in precedence order (sources[0] newest).
    Yields (key, value|None) — the newest record per key, tombstones
    included (callers filter)."""
    live = [s for s in sources
            if (len(s.index) if isinstance(s, Segment) else len(s.d))]
    if len(live) == 1:  # fully-compacted common case: no heap at all
        src = live[0]
        yield from (src.iter_from(start, cache, reverse)
                    if isinstance(src, Segment)
                    else src.iter_from(start, reverse))
        return
    iters = []
    for prio, src in enumerate(live):
        if isinstance(src, Segment):
            it = src.iter_from(start, cache, reverse)
        else:
            it = src.iter_from(start, reverse)
        iters.append((prio, it))
    import heapq

    heap = []
    for prio, it in iters:
        for k, v in it:
            heap.append(((k if not reverse else _RevKey(k)), prio, v, it))
            break
    heapq.heapify(heap)
    last_key = None
    while heap:
        sk, prio, v, it = heapq.heappop(heap)
        k = sk.k if reverse else sk
        if k != last_key:
            last_key = k
            yield k, v
        for nk, nv in it:
            heapq.heappush(
                heap, ((nk if not reverse else _RevKey(nk)), prio, nv, it))
            break


class _RevKey:
    """Inverts byte-key ordering for reverse merge heaps."""

    __slots__ = ("k",)

    def __init__(self, k: bytes):
        self.k = k

    def __lt__(self, other) -> bool:
        return self.k > other.k

    def __eq__(self, other) -> bool:
        return self.k == other.k


class LsmEngine:
    """Engine contract: see db.py `_Engine`. Selected via
    `[metadata] db_engine = "lsm"`."""

    NAME = "lsm"

    def __init__(self, path: str, fsync: bool = False,
                 memtable_max_bytes: int = MEMTABLE_MAX_BYTES):
        self.dir = path
        self.fsync = fsync
        self.memtable_max_bytes = memtable_max_bytes
        os.makedirs(path, exist_ok=True)
        self._trees: dict[str, _TreeState] = {}
        self._next_seg = 1
        self._cache = _BlockCache()
        self._depth = 0
        self._txops: list = []      # ops since begin (for the WAL batch)
        self._undo: list = []       # inverse ops (for rollback)
        self.flushes = 0
        self.compactions = 0
        self._load_manifest()
        self._gc_orphan_segments()
        self._wal_path = os.path.join(path, "wal.log")
        self._replay_wal()
        self._wal = open(self._wal_path, "ab")

    # ---- manifest / recovery ----------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "MANIFEST")

    def _load_manifest(self) -> None:
        p = self._manifest_path()
        if not os.path.exists(p):
            return
        with open(p, "rb") as f:
            m = msgpack.unpackb(f.read(), raw=True)
        self._next_seg = m[b"next_seg"]
        for name_b, info in m[b"trees"].items():
            name = name_b.decode()
            ts = _TreeState(name)
            ts.count = info[b"count"]
            for seg_id in info[b"segments"]:
                sp = os.path.join(self.dir, f"seg-{seg_id}.sst")
                ts.segments.append(Segment(sp, seg_id))
            self._trees[name] = ts

    def _write_manifest(self) -> None:
        m = {
            "next_seg": self._next_seg,
            "trees": {
                name: {"count": ts.count,
                       "segments": [s.seg_id for s in ts.segments]}
                for name, ts in self._trees.items()
            },
        }
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(m, use_bin_type=True))
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())
        if self.fsync:
            # power-loss safety (fsync=True claims sqlite FULL parity):
            # persist the DIRECTORY entries — the rename above and any
            # seg-*.sst created since the last manifest — before the
            # caller truncates the WAL; without this a power cut can
            # leave a manifest naming a segment whose dirent never hit
            # disk (unopenable db) or revert to the old manifest after
            # the WAL reset (silent loss)
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def _gc_orphan_segments(self) -> None:
        """Segment files written by a flush/compaction that crashed
        before its manifest rename are invisible garbage: delete them
        (their content is still covered by the WAL / old segments)."""
        live = {s.seg_id for ts in self._trees.values()
                for s in ts.segments}
        for fn in os.listdir(self.dir):
            if not (fn.startswith("seg-") and fn.endswith(".sst")):
                continue
            try:
                sid = int(fn[4:-4])
            except ValueError:
                continue
            if sid not in live:
                try:
                    os.unlink(os.path.join(self.dir, fn))
                except OSError:
                    pass

    def _replay_wal(self) -> None:
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, "rb") as f:
            data = f.read()
        pos = 0
        replay_drops: list[Segment] = []
        while pos + _WAL_HDR.size <= len(data):
            ln, crc = _WAL_HDR.unpack_from(data, pos)
            body = data[pos + _WAL_HDR.size: pos + _WAL_HDR.size + ln]
            if len(body) < ln or zlib.crc32(body) != crc:
                break  # torn tail from a crash mid-append: stop here
            pos += _WAL_HDR.size + ln
            for op in msgpack.unpackb(body, raw=True):
                kind = op[0]
                tree = op[1].decode()
                if kind == b"e":
                    self._trees.setdefault(tree, _TreeState(tree))
                    continue
                ts = self._trees.setdefault(tree, _TreeState(tree))
                if kind == b"p":
                    self._apply_put(ts, bytes(op[2]),
                                    None if op[3] is None else bytes(op[3]))
                elif kind == b"c":
                    replay_drops.extend(self._apply_clear(ts))
        if pos < len(data):
            # torn tail: truncate it away, or commits acknowledged after
            # this recovery would be appended BEYOND the garbage and be
            # unreachable to the next replay (silent loss)
            log.warning("lsm %s: truncating torn WAL tail at %d (%d bytes"
                        " discarded)", self.dir, pos, len(data) - pos)
            with open(self._wal_path, "r+b") as f:
                f.truncate(pos)
        if replay_drops:
            # a replayed clear drops segments: persist the new (empty)
            # segment list BEFORE unlinking, so a crash here never
            # leaves the manifest pointing at deleted files
            self._write_manifest()
            for s in replay_drops:
                s.drop()

    # ---- primitive state changes (shared by live path + replay) ------

    def _exists(self, ts: _TreeState, key: bytes) -> bool:
        for src in ts.sources():
            if isinstance(src, Segment):
                found, v = src.get(key, self._cache)
            else:
                found, v = src.get(key)
            if found:
                return v is not None
        return False

    def _older_live(self, ts: _TreeState, key: bytes) -> bool:
        """Whether a run older than the active memtable holds `key`
        live: the one case where a delete needs a tombstone."""
        for src in ts.frozen:
            found, v = src.get(key)
            if found:
                return v is not None
        for seg in ts.segments:
            found, v = seg.get(key, self._cache)
            if found:
                return v is not None
        return False

    def _apply_put(self, ts: _TreeState, key: bytes,
                   value: Optional[bytes],
                   known_existed: Optional[bool] = None) -> int:
        """Set/tombstone one key; returns the live-count delta.
        `known_existed` skips the source walk when the caller just read
        the key under the same lock (the Tree/Transaction facades
        always do — an UPDATE-heavy workload like the merkle trie would
        otherwise pay a redundant bloom+block lookup per write)."""
        existed = self._exists(ts, key) if known_existed is None \
            else known_existed
        if value is None and not self._older_live(ts, key):
            ts.mem.drop(key)
        else:
            ts.mem.put(key, value)
        delta = (0 if existed else 1) if value is not None \
            else (-1 if existed else 0)
        ts.count += delta
        return delta

    def _apply_clear(self, ts: _TreeState) -> list:
        """Reset a tree's in-memory state; returns the detached
        segments — the CALLER drops them after persisting the manifest
        (unlink-after-manifest ordering)."""
        old_segs = ts.segments
        ts.mem = _Memtable()
        ts.frozen = []
        ts.segments = []
        ts.count = 0
        return old_segs

    # ---- engine contract ---------------------------------------------

    def ensure_tree(self, name: str) -> None:
        if name in self._trees:
            return
        self._trees[name] = _TreeState(name)
        # record outside any tx frame: tree creation survives rollback
        # (sqlite DDL behaves the same under its autocommit CREATE)
        self._wal_append([("e", name)])

    def list_trees(self) -> list[str]:
        return list(self._trees)

    def get(self, tree: str, key: bytes) -> Optional[bytes]:
        ts = self._trees[tree]
        for src in ts.sources():
            if isinstance(src, Segment):
                found, v = src.get(key, self._cache)
            else:
                found, v = src.get(key)
            if found:
                return v
        return None

    def put(self, tree: str, key: bytes, value: bytes,
            prev=PREV_UNKNOWN) -> None:
        ts = self._trees[tree]
        undo_prev = ts.mem.d.get(key, _ABSENT)
        known = None if prev is PREV_UNKNOWN else prev is not None
        delta = self._apply_put(ts, key, value, known_existed=known)
        if self._depth:
            self._txops.append(("p", tree, key, value))
            self._undo.append(("p", ts, key, undo_prev, delta))
        else:  # autocommit (never happens via db.py, which always frames)
            self._wal_append([("p", tree, key, value)])

    def delete(self, tree: str, key: bytes, prev=PREV_UNKNOWN) -> None:
        ts = self._trees[tree]
        undo_prev = ts.mem.d.get(key, _ABSENT)
        known = None if prev is PREV_UNKNOWN else prev is not None
        delta = self._apply_put(ts, key, None, known_existed=known)
        if self._depth:
            self._txops.append(("p", tree, key, None))
            self._undo.append(("p", ts, key, undo_prev, delta))
        else:
            self._wal_append([("p", tree, key, None)])

    def clear(self, tree: str) -> None:
        ts = self._trees[tree]
        old_mem, old_frozen, old_segs, old_count = \
            ts.mem, ts.frozen, ts.segments, ts.count
        ts.mem = _Memtable()
        ts.frozen = []
        ts.segments = []
        ts.count = 0
        if self._depth:
            self._txops.append(("c", tree))
            # defer unlinking to commit — a rollback restores the list
            self._txops.append(("__drop__", old_segs))
            self._undo.append(("c", ts, old_mem, old_frozen, old_segs,
                               old_count))
        else:
            self._wal_append([("c", tree)])
            # manifest first, unlink after: a crash in between leaves
            # orphan files (GC'd on open), never a dangling manifest
            self._write_manifest()
            for s in old_segs:
                s.drop()

    def length(self, tree: str) -> int:
        return self._trees[tree].count

    def range(self, tree: str, start, end, reverse, limit=None) -> list:
        out = []
        # reverse: start descending at `end` (exclusive — the k >= end
        # skip below removes the single boundary hit), stop below start
        scan_start = start if not reverse else end
        it = _merged_iter(self._trees[tree].sources(), scan_start,
                          reverse, self._cache)
        for k, v in it:
            if not reverse:
                if end is not None and k >= end:
                    break
            else:
                if end is not None and k >= end:
                    continue
                if start is not None and k < start:
                    break
            if v is None:
                continue
            out.append((k, v))
            if limit is not None and len(out) >= limit:
                break
        return out

    # transactions -----------------------------------------------------

    def begin(self) -> None:
        self._depth += 1

    def commit(self) -> None:
        self._depth -= 1
        if self._depth:
            return
        ops = [o for o in self._txops if o[0] != "__drop__"]
        drops = [o for o in self._txops if o[0] == "__drop__"]
        self._txops = []
        self._undo = []
        if ops:
            self._wal_append(ops)
        if any(segs for _, segs in drops):
            # a committed clear() detached segments: persist the new
            # segment list BEFORE unlinking (a crash in between leaves
            # orphan files, which open-time GC removes — the reverse
            # order would leave a manifest naming deleted files and an
            # unopenable db)
            self._write_manifest()
        for _, segs in drops:
            for s in segs:
                s.drop()
        self._maybe_flush()

    def rollback(self) -> None:
        self._depth -= 1
        if self._depth:
            return
        for entry in reversed(self._undo):
            if entry[0] == "p":
                _, ts, key, prev, delta = entry
                ts.count -= delta
                if prev is _ABSENT:
                    # remove the key from the memtable again
                    if key in ts.mem.d:
                        old = ts.mem.d.pop(key)
                        ts.mem.bytes -= len(key) + (len(old) if old else 0)
                        i = bisect.bisect_left(ts.mem.keys, key)
                        if i < len(ts.mem.keys) and ts.mem.keys[i] == key:
                            ts.mem.keys.pop(i)
                else:
                    ts.mem.put(key, prev)
            else:  # clear
                _, ts, mem, frozen, segments, count = entry
                ts.mem, ts.frozen, ts.segments, ts.count = \
                    mem, frozen, segments, count
        self._txops = []
        self._undo = []

    def _wal_append(self, ops: list) -> None:
        body = msgpack.packb(ops, use_bin_type=True)
        self._wal.write(_WAL_HDR.pack(len(body), zlib.crc32(body)) + body)
        self._wal.flush()
        if self.fsync:
            os.fsync(self._wal.fileno())

    # ---- flush -------------------------------------------------------

    def _mem_bytes(self) -> int:
        return sum(ts.mem.bytes + sum(m.bytes for m in ts.frozen)
                   for ts in self._trees.values())

    def _maybe_flush(self) -> None:
        if self._mem_bytes() >= self.memtable_max_bytes:
            self.flush()
            # inline backpressure: a process without the maintenance
            # worker (bench, CLI) must not accumulate unbounded runs
            for name, ts in self._trees.items():
                while len(ts.segments) > MAX_SEGMENTS_HARD:
                    if not self._compact_tree(name):
                        break

    def flush(self) -> None:
        """Write every non-empty memtable (active + frozen) as one new
        segment per tree, persist the manifest, then reset the WAL —
        every surviving WAL byte would now be redundant."""
        wrote = False
        for ts in self._trees.values():
            runs = [ts.mem, *ts.frozen]
            if not any(m.d for m in runs):
                continue
            seg = self._write_segment_from_runs(runs)
            ts.segments.insert(0, seg)
            ts.mem = _Memtable()
            ts.frozen = []
            wrote = True
        if not wrote:
            return
        self.flushes += 1
        self._write_manifest()
        self._wal.close()
        self._wal = open(self._wal_path, "wb")
        if self.fsync:
            os.fsync(self._wal.fileno())

    def _write_segment_from_runs(self, runs) -> Segment:
        entries = _merged_iter(runs, None, False, self._cache)
        return self._write_segment(entries)

    def _write_segment(self, entries, seg_id: Optional[int] = None) -> Segment:
        """`entries` yields (key, value|None) ascending; tombstones are
        kept (the caller pre-filters when they may drop). `seg_id` must
        be pre-allocated (under the Db lock) when called from the
        unlocked compaction build — drawing from _next_seg here would
        race a concurrent foreground flush onto the same file."""
        if seg_id is None:
            seg_id = self._next_seg
            self._next_seg += 1
        path = os.path.join(self.dir, f"seg-{seg_id}.sst")
        try:
            return self._write_segment_file(path, seg_id, entries)
        except BaseException:
            # a build that dies mid-write must not leave a partial
            # .sst around (orphan GC only runs at open)
            try:
                os.unlink(path)
            except OSError:
                pass
            raise

    def _write_segment_file(self, path, seg_id, entries) -> Segment:
        index = []
        keys = []
        count = 0
        data_bytes = 0
        min_key = max_key = None
        with open(path, "wb") as f:
            block: list = []
            bsize = 0

            def flush_block():
                nonlocal bsize
                if not block:
                    return
                raw = msgpack.packb(block, use_bin_type=True)
                index.append((block[0][0], f.tell(), len(raw)))
                f.write(raw)
                block.clear()
                bsize = 0

            for k, v in entries:
                if min_key is None:
                    min_key = k
                max_key = k
                keys.append(k)
                if v is not None:
                    count += 1
                    data_bytes += len(k) + len(v)
                block.append((k, v))
                bsize += len(k) + (len(v) if v is not None else 0) + 8
                if bsize >= BLOCK_BYTES:
                    flush_block()
            flush_block()
            bloom = Bloom.build(keys)
            foot = msgpack.packb({
                "index": [[k, o, ln] for k, o, ln in index],
                "bloom": bytes(bloom.bits),
                "nbits": bloom.nbits,
                "count": count,
                "min": min_key or b"",
                "max": max_key or b"",
                "bytes": data_bytes,
            }, use_bin_type=True)
            f.write(foot)
            f.write(struct.pack("<q", len(foot)) + _MAGIC)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        return Segment(path, seg_id)

    # ---- compaction ---------------------------------------------------

    def compaction_backlog(self) -> int:
        """Mergeable-run pressure: segments beyond one fully-compacted
        run per tier, summed over trees. The governor-paced worker
        drains this; /v1/metadata and meta_* gauges report it."""
        total = 0
        for ts in self._trees.values():
            if len(ts.segments) >= TIER_FANIN:
                total += len(ts.segments) - 1
        return total

    def _pick_compaction(self) -> Optional[str]:
        worst, worst_n = None, TIER_FANIN - 1
        for name, ts in self._trees.items():
            if len(ts.segments) > worst_n:
                worst, worst_n = name, len(ts.segments)
        return worst

    def compact_once(self) -> bool:
        """One size-tiered merge step; returns True if work was done."""
        name = self._pick_compaction()
        if name is None:
            return False
        return self._compact_tree(name)

    def compact_full(self) -> None:
        """Merge every tree down to a single run (read-optimized state:
        range scans take the no-heap fast path). Maximum write
        amplification — for bulk-load finalization and benches, not the
        steady-state worker."""
        self.flush()
        for name, ts in self._trees.items():
            while len(ts.segments) > 1:
                self._compact_tree(name)

    def _compact_tree(self, name: str) -> bool:
        plan = self._plan_compaction(name)
        if plan is None:
            return False
        try:
            seg = self._build_compaction(plan)
        except BaseException:
            self._abort_compaction(plan)
            raise
        return self._commit_compaction(plan, seg)

    # The three-phase split exists for the maintenance worker: plan and
    # commit run under the Db lock in O(ms); build — the actual merge,
    # seconds at scale — runs UNLOCKED over the pinned immutable inputs
    # so foreground metadata ops never stall behind a compaction.

    def _plan_compaction(self, name: str) -> Optional[tuple]:
        ts = self._trees[name]
        segs = ts.segments
        if len(segs) < 2:
            return None
        # size-tiered: merge the longest contiguous run (newest..older)
        # of segments whose sizes stay within 4x of the run's smallest;
        # fall back to the oldest TIER_FANIN when nothing tiers up.
        best = None
        for i in range(len(segs) - 1):
            lo = hi = segs[i].data_bytes + 1
            j = i
            while j + 1 < len(segs):
                nxt = segs[j + 1].data_bytes + 1
                lo2, hi2 = min(lo, nxt), max(hi, nxt)
                if hi2 > 4 * lo2:
                    break
                lo, hi = lo2, hi2
                j += 1
            if j - i + 1 >= TIER_FANIN and (best is None
                                            or j - i + 1 > best[1]):
                best = (i, j - i + 1)
        if best is not None:
            run_start, run_len = best
        else:
            run_len = min(TIER_FANIN, len(segs))
            run_start = len(segs) - run_len
        victims = segs[run_start:run_start + run_len]
        includes_oldest = run_start + run_len == len(segs)
        for s in victims:
            s.acquire()  # pin the inputs for the unlocked build
        # allocate the output's id HERE, under the Db lock — the build
        # runs unlocked, and drawing from _next_seg there would race a
        # foreground flush onto the same seg file
        seg_id = self._next_seg
        self._next_seg += 1
        return (name, victims, includes_oldest, seg_id)

    def _build_compaction(self, plan: tuple) -> Segment:
        _, victims, includes_oldest, seg_id = plan
        merged = _merged_iter(victims, None, False, self._cache)
        if includes_oldest:
            # nothing older can resurrect these keys: drop tombstones
            merged = ((k, v) for k, v in merged if v is not None)
        return self._write_segment(merged, seg_id=seg_id)

    def _abort_compaction(self, plan: tuple) -> None:
        for s in plan[1]:
            s.release()

    def _commit_compaction(self, plan: tuple, new_seg: Segment) -> bool:
        name, victims, includes_oldest, _seg_id = plan
        ts = self._trees.get(name)
        if ts is None or any(v not in ts.segments for v in victims):
            # a clear() raced the build: the merge output is stale
            new_seg.drop()
            self._abort_compaction(plan)
            return False
        run_start = ts.segments.index(victims[0])
        if includes_oldest and new_seg.count == 0:
            # everything merged away (pure-tombstone runs): keep nothing
            replacement: list[Segment] = []
            new_seg.drop()
        else:
            replacement = [new_seg]
        ts.segments = ts.segments[:run_start] + replacement \
            + ts.segments[run_start + len(victims):]
        self._write_manifest()
        for s in victims:
            s.release()  # the plan's pin
            s.drop()     # the manifest's ref
        self.compactions += 1
        return True

    # ---- snapshots ----------------------------------------------------

    def iter_snapshot(self, tree: str, start: Optional[bytes] = None,
                      end: Optional[bytes] = None) -> "SnapshotIterator":
        """A stable, streaming view of the tree as of now: freezes the
        active memtable (pointer swap) and refs the current segments.
        Flushes/compactions proceed underneath; the caller must close()
        (or exhaust) the iterator to release the segment refs."""
        ts = self._trees[tree]
        if ts.mem.d:
            ts.frozen.insert(0, ts.mem)
            ts.mem = _Memtable()
        sources = [*ts.frozen, *[s.acquire() for s in ts.segments]]
        return SnapshotIterator(sources, start, end, self._cache)

    def snapshot(self, to_dir: str) -> None:
        """Hot copy: flush, then link/copy manifest + segments. The
        result opens as a standalone lsm db."""
        import shutil

        self.flush()
        os.makedirs(to_dir, exist_ok=True)
        dest = os.path.join(to_dir, os.path.basename(self.dir.rstrip("/")))
        os.makedirs(dest, exist_ok=True)
        self._write_manifest()
        shutil.copy2(self._manifest_path(), os.path.join(dest, "MANIFEST"))
        for ts in self._trees.values():
            for s in ts.segments:
                tgt = os.path.join(dest, os.path.basename(s.path))
                if not os.path.exists(tgt):
                    try:
                        os.link(s.path, tgt)
                    except OSError:
                        shutil.copy2(s.path, tgt)

    # ---- stats / lifecycle -------------------------------------------

    def stats(self) -> dict:
        return {
            "engine": self.NAME,
            "trees": len(self._trees),
            "segments": sum(len(ts.segments)
                            for ts in self._trees.values()),
            "compaction_backlog": self.compaction_backlog(),
            "wal_bytes": self._wal_size(),
            "memtable_bytes": self._mem_bytes(),
            "flushes": self.flushes,
            "compactions": self.compactions,
            "rows": sum(ts.count for ts in self._trees.values()),
        }

    def _wal_size(self) -> int:
        try:
            return os.path.getsize(self._wal_path)
        except OSError:
            return 0

    def close(self) -> None:
        self.flush()
        self._wal.close()
        for ts in self._trees.values():
            for s in ts.segments:
                s.close()


class SnapshotIterator:
    """Streaming merged view over frozen runs; releases segment refs on
    close/exhaustion. Iterates (key, value) with tombstones filtered."""

    def __init__(self, sources, start, end, cache):
        self._segments = [s for s in sources if isinstance(s, Segment)]
        self._it = _merged_iter(sources, start, False, cache)
        self._end = end
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        for k, v in self._it:
            if self._end is not None and k >= self._end:
                break
            if v is None:
                continue
            return k, v
        self.close()
        raise StopIteration

    def close(self) -> None:
        if not self._done:
            self._done = True
            for s in self._segments:
                s.release()

    def __del__(self):
        self.close()


class LsmMaintenanceWorker:
    """Background size-tiered compaction, governor-paced.

    Worker-protocol duck type (utils/background.Worker): one
    compact_once() step per tick in a thread (the merge is pure disk +
    CPU and must not block the event loop); `tranquility` seconds of
    sleep between steps is OWNED by the qos governor, exactly like the
    table syncers' pacing — compaction yields to foreground latency and
    sprints on an idle node."""

    def __init__(self, db):
        self.db = db
        self.name = "lsm compaction"
        self.tranquility = 0.0
        self.steps = 0

    def _engine(self) -> Optional[LsmEngine]:
        e = getattr(self.db, "_engine", None)
        return e if isinstance(e, LsmEngine) else None

    async def work(self):
        import asyncio

        from ..utils.background import WState

        e = self._engine()
        if e is None:
            return WState.DONE
        if self.tranquility > 0:
            await asyncio.sleep(self.tranquility)

        # plan (locked, ms) -> build (UNLOCKED: the merge reads only
        # pinned immutable segments) -> commit (locked, ms) — a
        # multi-second merge never stalls foreground metadata ops
        def plan():
            with self.db._lock:
                name = e._pick_compaction()
                return e._plan_compaction(name) if name else None

        p = await asyncio.to_thread(plan)
        if p is None:
            return WState.IDLE
        try:
            seg = await asyncio.to_thread(e._build_compaction, p)
        except BaseException:
            with self.db._lock:
                e._abort_compaction(p)
            raise

        def commit() -> bool:
            with self.db._lock:
                return e._commit_compaction(p, seg)

        did = await asyncio.to_thread(commit)
        if did:
            self.steps += 1
            from ..utils.metrics import registry

            registry().inc("meta_compaction_steps")
            return WState.BUSY
        return WState.IDLE

    async def wait_for_work(self):
        import asyncio

        await asyncio.sleep(1.0)

    def info(self):
        from ..utils.background import WorkerInfo

        e = self._engine()
        backlog = e.compaction_backlog() if e is not None else 0
        return WorkerInfo(name=self.name, queue_length=backlog,
                          progress=f"{self.steps} merges")
