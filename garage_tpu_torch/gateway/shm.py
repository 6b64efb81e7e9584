"""Copy of garage_tpu/gateway/shm.py: import paths rewritten, issue and PR tags dropped.

Zero-copy intra-node cache forwards: a shared-memory
segment ring replacing the loopback-socket payload copy.

an earlier change's worker-sharded cache forwards every MiB-scale payload over a
loopback socket: the owner worker serializes it, the kernel copies it
twice, the forwarding worker deserializes it — three-plus copies per
forward of bytes that already sit in the owner's page-addressable RAM.
This module makes the payload cross the process boundary through one
mmap'd file instead:

  * The OWNER worker keeps one `ShmRing` — a file in /dev/shm (tmpfs;
    falls back to the metadata dir when absent), mmap'd, carved into a
    circular log of variable-size slots. `publish(hash, payload)`
    writes the payload ONCE and returns a tiny reference
    {path, off, seq, len} that rides the RPC reply instead of the
    bytes. A hash already published reuses its live slot — a hot block
    is written once per lease, not once per forward.
  * The FORWARDING worker keeps a `ShmReader` — a cache of mmaps keyed
    by ring path. `get(ref)` validates the slot header (magic, seq,
    hash, length) and returns a memoryview over the mapped payload:
    the bytes go from the owner's one write straight into the HTTP
    response ('s zero-copy write path slices memoryviews natively).

Safety protocol: the reference only exists AFTER publish() returned,
and the RPC round trip orders the reply after the write — a reader can
never see a torn slot at serve-start. The remaining hazard is REUSE
while a slow client still streams the mapped bytes; the ring never
rewrites a slot before its lease (`[gateway] shm_lease_s`, default
60 s) expires, and when the ring cannot host a payload without
breaking that promise, publish() returns None and the forward falls
back to the socket path (`cache_tier_shm_fallback` counts how often).
`[gateway] shm_forwards = false` is the kill switch: no ring is
created and every forward carries bytes over the socket as before.

Ring files are keyed by (cluster metadata dir, worker index), so a
respawned worker reopens the SAME inode its siblings already map —
their existing mmaps keep working — and stale references from the
previous incarnation fail the seq check (seqs start from a fresh
random epoch) instead of serving garbage.
"""

from __future__ import annotations

import hashlib
import logging
import mmap
import os
import struct
import threading
import time
from collections import deque
from typing import Optional

log = logging.getLogger("garage_tpu_torch.gateway.shm")

MAGIC = b"GTSM"
# magic(4) pad(4) seq(8) length(8) hash(32) = 56, padded to 64
HEADER = struct.Struct("<4s4xQQ32s")
SLOT_ALIGN = 64
HEADER_SIZE = 64
# payloads below this aren't worth a second mmap lookup on the reader
# side; the socket copy of a few KiB costs less than it saves
SHM_MIN_BYTES = 64 * 1024


def ring_path(metadata_dir: str, index: int) -> str:
    """Stable per-(cluster, worker) ring path: respawns reuse the same
    inode, parallel test clusters never collide."""
    tag = hashlib.blake2b(os.path.abspath(metadata_dir).encode(),
                          digest_size=8).hexdigest()
    base = "/dev/shm" if os.path.isdir("/dev/shm") else metadata_dir
    return os.path.join(base, f"garage-gw-{tag}-w{index}.ring")


class ShmRing:
    """Owner-side publisher: bump-pointer circular log with leased,
    never-rewritten-early slots."""

    def __init__(self, path: str, size: int, lease_s: float = 60.0):
        self.path = path
        self.size = max(int(size), HEADER_SIZE * 16)
        self.lease_s = float(lease_s)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # O_CREAT without O_TRUNC: a respawned owner reuses the inode
        # its siblings already map (ftruncate to the same size is a
        # no-op on contents)
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            fresh = os.fstat(fd).st_size != self.size
            os.ftruncate(fd, self.size)
            self._mm = mmap.mmap(fd, self.size)
        finally:
            os.close(fd)
        if fresh:
            # prefault a FRESH ring once (one boot-time memset):
            # without this every first-touch publish pays a page fault
            # per 4 KiB, which measured SLOWER than the socket copy it
            # replaces. A crash-respawn reopening the existing inode
            # must NOT do this — siblings may still be streaming leased
            # slots out of their mappings, and zeroing would corrupt
            # those in-flight responses (the pages are already resident
            # from the previous incarnation anyway).
            self._mm[:] = bytes(self.size)
        # seq epoch: random per incarnation so references minted by a
        # previous process life can never validate against new content
        self._seq = int.from_bytes(os.urandom(6), "big") << 16
        self._head = 0  # next write offset
        # oldest-first records of live slots: (off, total_len, seq,
        # lease_deadline_monotonic)
        self._live: deque = deque()
        # hash -> (off, payload_len, seq, deadline): a hot block is
        # written once per lease window, not once per forward
        self._by_hash: dict[bytes, tuple] = {}
        self._lock = threading.Lock()
        self.published = 0
        self.reused = 0
        self.fallbacks = 0

    def _expire(self, now: float) -> None:
        while self._live and self._live[0][3] <= now:
            self._live.popleft()
        # prune hash-index entries whose slot expired (amortized: only
        # when the index clearly outgrew the live set)
        if len(self._by_hash) > 4 * len(self._live) + 16:
            live_seqs = {s for _o, _n, s, _d in self._live}
            self._by_hash = {h: v for h, v in self._by_hash.items()
                             if v[2] in live_seqs}

    def publish(self, hash32: bytes, payload) -> Optional[dict]:
        """Write `payload` into the ring; -> reference dict or None
        when the ring cannot host it without rewriting a leased slot
        (caller falls back to the socket)."""
        mv = memoryview(payload)
        n = mv.nbytes
        total = HEADER_SIZE + n
        total += (-total) % SLOT_ALIGN
        if total > self.size:
            self.fallbacks += 1
            return None
        now = time.monotonic()
        with self._lock:
            self._expire(now)
            hit = self._by_hash.get(hash32)
            if hit is not None:
                off, plen, seq, deadline = hit
                if deadline > now and plen == n:
                    self.reused += 1
                    return {"path": self.path, "off": off, "seq": seq,
                            "len": n}
            off = self._allocate(total, now)
            if off is None:
                self.fallbacks += 1
                return None
            seq = self._seq = self._seq + 1
            deadline = now + self.lease_s
            self._mm[off + HEADER_SIZE:off + HEADER_SIZE + n] = mv
            self._mm[off:off + HEADER.size] = HEADER.pack(
                MAGIC, seq, n, bytes(hash32))
            self._live.append((off, total, seq, deadline))
            self._by_hash[hash32] = (off, n, seq, deadline)
            self.published += 1
            return {"path": self.path, "off": off, "seq": seq, "len": n}

    def _allocate(self, total: int, now: float) -> Optional[int]:
        """Bump-pointer allocation that never overwrites a leased slot.
        Slots are written in ring order, so the live region is at most
        two runs — [tail, size) from before the last wrap and [0, head)
        after it — and the free space is exactly the gap from head
        forward (in ring order) to the tail. None = a still-leased slot
        is in the way (the caller falls back to the socket)."""
        if not self._live:
            if self._head + total > self.size:
                self._head = 0
            start = self._head
            self._head = start + total
            return start
        tail = self._live[0][0]
        h = self._head
        if h > tail:
            # free: [h, size) then, wrapping, [0, tail)
            if h + total <= self.size:
                self._head = h + total
                return h
            if total <= tail:
                self._head = total
                return 0
            return None
        if h < tail and total <= tail - h:
            self._head = h + total
            return h
        return None  # head has caught the leased tail: ring is full

    def stats(self) -> dict:
        with self._lock:
            return {"published": self.published, "reused": self.reused,
                    "fallbacks": self.fallbacks,
                    "live_slots": len(self._live),
                    "size": self.size}

    def close(self) -> None:
        """Clean shutdown: unlink the ring file so repeated ephemeral
        clusters (tests, benches, CI) don't accumulate resident tmpfs
        rings. A CRASHED owner never gets here, which is exactly when
        the inode must survive for the respawn to reuse; readers
        holding a mapping of an unlinked ring remap on their next
        validation failure (ShmReader.get)."""
        with self._lock:
            try:
                self._mm.close()
            except (BufferError, ValueError):
                pass  # a live exported view pins the map; tmpfs reclaims
            try:
                os.unlink(self.path)
            except OSError:
                pass


class ShmReader:
    """Forwarder-side mapper. Mmaps are cached per path and NEVER
    closed while the process lives — a memoryview handed into an HTTP
    response must outlive any eviction policy, and the ring paths are
    bounded by the worker count."""

    def __init__(self):
        # path -> (mmap, st_ino): the inode lets a validation failure
        # detect that the owner recreated the ring (clean stop +
        # respawn unlinks and recreates) and remap; the superseded
        # mmap object is simply dropped — live exported views pin it
        # until they die, then Python closes it
        self._maps: dict[str, tuple[mmap.mmap, int]] = {}
        self._lock = threading.Lock()

    def _open_map(self, path: str) -> Optional[tuple[mmap.mmap, int]]:
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                st = os.fstat(fd)
                mm = mmap.mmap(fd, st.st_size, prot=mmap.PROT_READ)
            finally:
                os.close(fd)
        except (OSError, ValueError) as e:
            log.debug("shm map of %s failed: %s", path, e)
            return None
        return mm, st.st_ino

    def _map(self, path: str, remap: bool = False):
        with self._lock:
            ent = self._maps.get(path)
            if ent is not None and not remap:
                return ent[0]
            if ent is not None and remap:
                try:
                    if os.stat(path).st_ino == ent[1]:
                        return ent[0]  # same inode: nothing to remap
                except OSError:
                    return ent[0]
            new = self._open_map(path)
            if new is None:
                return ent[0] if ent is not None else None
            self._maps[path] = new
            return new[0]

    def get(self, ref: dict, hash32: bytes) -> Optional[memoryview]:
        """Resolve a publish() reference -> memoryview over the mapped
        payload, or None when anything about the slot disagrees with
        the reference (wrapped ring, stale epoch, truncated file) —
        the caller re-fetches over the socket."""
        try:
            path, off = ref["path"], int(ref["off"])
            seq, n = int(ref["seq"]), int(ref["len"])
        except (KeyError, TypeError, ValueError):
            return None
        mm = self._map(path)
        for attempt in range(2):
            if mm is None or off < 0 or off + HEADER_SIZE + n > len(mm):
                return None
            magic, got_seq, got_len, got_hash = HEADER.unpack(
                bytes(mm[off:off + HEADER.size]))
            if magic == MAGIC and got_seq == seq and got_len == n \
                    and got_hash == bytes(hash32):
                return memoryview(mm)[off + HEADER_SIZE:
                                      off + HEADER_SIZE + n]
            if attempt == 0:
                # the owner may have recreated the ring since we
                # mapped it (clean-stop respawn): remap once if the
                # inode changed, else the reference is simply stale
                mm = self._map(path, remap=True)
        return None
