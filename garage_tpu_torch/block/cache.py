"""Copy of garage_tpu/block/cache.py: import paths rewritten, issue and PR tags dropped.

Hot-block read cache: a node-local, content-addressed RAM cache of
decoded block payloads.

The block store is content-addressed, so a cached payload can never be
stale — the hash IS the identity, and invalidation reduces to "drop the
entry when the node stops wanting to hold RAM for it" (delete/decref).
What a hit saves depends on the codec: replicate mode skips a disk read
+ content-hash verify (+ decompress); erasure mode skips the whole
k-shard gather over RPC, the GF(2^8) decode, and the verify.

Design (the CacheLib discipline named in an earlier change — cache what is
expensive to rebuild, admission-filter what is scanned once):

  * Byte-budget SLRU, two segments. New entries land in a PROBATION
    segment; only a re-reference promotes into the PROTECTED segment.
    The protected segment is capped at (100 - probation_pct)% of the
    budget and is never evicted by inserts — so one full-object
    streaming read (every block touched exactly once) churns through
    probation and cannot displace the hot set. Probation itself is
    elastic: it may use whatever the protected segment doesn't, so a
    cold cache still admits a full working set on first touch.
  * Overflowing the protected cap demotes its LRU entries back to the
    MRU end of probation (one more trip around before eviction),
    mirroring classic SLRU.
  * Oversize entries (> max_bytes // 8) are rejected outright: one
    giant block must not be able to flush a whole segment.
  * Write-through PUTs insert into probation like read fills — freshly
    written blocks are the hottest, but a bulk upload is still a scan
    and must not evict the protected set.

Thread-safety: a plain lock around every operation. Hits happen on the
event loop, but purges arrive from table-trigger commit hooks and
delete_local can be driven from worker threads; the critical sections
are a few dict moves, so the lock is never contended for long.

SSE-C exclusion is the CALLER's job (`cacheable=False` on the manager
seam): those payloads are ciphertext the node can re-derive only while
the client's key is in hand, and the conservative rule is to never let
them outlive the request in RAM.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional


class BlockCache:
    """Content-addressed byte-budget SLRU. max_bytes == 0 disables the
    cache entirely (every call is a cheap no-op and no stats move)."""

    def __init__(self, max_bytes: int, probation_pct: int = 20):
        self._lock = threading.Lock()
        # hash -> bytes; OrderedDict order = LRU (oldest first)
        self._prob: OrderedDict[bytes, bytes] = OrderedDict()
        self._prot: OrderedDict[bytes, bytes] = OrderedDict()
        self._prob_bytes = 0
        self._prot_bytes = 0
        # per-key hit counts for entries currently IN the cache — the
        # hot-hash hint source (cache_tier.py gossips the top-N over
        # peering pings). Bounded by construction: an entry leaves the
        # map when it leaves the cache.
        self._hits_by_key: dict[bytes, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0
        self.rejected = 0
        self.hit_bytes = 0
        self.configure(max_bytes=max_bytes, probation_pct=probation_pct)

    # ---- configuration -------------------------------------------------

    def configure(self, max_bytes: Optional[int] = None,
                  probation_pct: Optional[int] = None) -> None:
        """Runtime retune (admin POST /v1/s3/tuning). Shrinking the
        budget evicts immediately; 0 clears and disables."""
        with self._lock:
            if max_bytes is not None:
                if max_bytes < 0:
                    raise ValueError("max_bytes must be >= 0")
                self.max_bytes = int(max_bytes)
            if probation_pct is not None:
                if not 1 <= probation_pct <= 90:
                    raise ValueError("probation_pct must be in [1, 90]")
                self.probation_pct = int(probation_pct)
            self._prot_cap = self.max_bytes \
                * (100 - self.probation_pct) // 100
            self._max_entry = self.max_bytes // 8
            self._shed_protected()
            self._evict_to_budget()

    # ---- data path -----------------------------------------------------

    def get(self, hash32: bytes) -> Optional[bytes]:
        """-> decoded payload or None. A probation hit promotes to
        protected (second touch = proven hot); a protected hit moves to
        MRU."""
        if self.max_bytes <= 0:
            return None
        with self._lock:
            data = self._prot.get(hash32)
            if data is not None:
                self._prot.move_to_end(hash32)
                self.hits += 1
                self.hit_bytes += len(data)
                self._hits_by_key[hash32] = \
                    self._hits_by_key.get(hash32, 0) + 1
                return data
            data = self._prob.pop(hash32, None)
            if data is not None:
                self._prob_bytes -= len(data)
                self._prot[hash32] = data
                self._prot_bytes += len(data)
                self._shed_protected()
                self.hits += 1
                self.hit_bytes += len(data)
                self._hits_by_key[hash32] = \
                    self._hits_by_key.get(hash32, 0) + 1
                return data
            self.misses += 1
            return None

    def contains(self, hash32: bytes) -> bool:
        """Presence peek that moves NO stats and NO LRU order — the
        prefetch planner's "already warm?" check must not promote an
        entry or inflate the hit counters the hint gossip reads."""
        if self.max_bytes <= 0:
            return False
        with self._lock:
            return hash32 in self._prot or hash32 in self._prob

    def top_keys(self, n: int) -> list[bytes]:
        """The n hottest cached hashes by hit count (hint gossip
        payload). Only actually-hot entries qualify — a key with no
        second touch is noise, not a hint."""
        import heapq

        with self._lock:
            return heapq.nlargest(n, self._hits_by_key,
                                  key=self._hits_by_key.get)

    def insert(self, hash32: bytes, data) -> None:
        """Admit into probation (read-miss fill and PUT write-through
        both land here; promotion is earned by a re-reference)."""
        if self.max_bytes <= 0:
            return
        if not isinstance(data, bytes):
            data = bytes(data)  # cached objects must be immutable
        n = len(data)
        if n > self._max_entry:
            self.rejected += 1
            return
        with self._lock:
            if hash32 in self._prot or hash32 in self._prob:
                return  # content-addressed: same hash = same bytes
            self._prob[hash32] = data
            self._prob_bytes += n
            self.inserts += 1
            self._evict_to_budget()

    def discard(self, hash32: bytes) -> None:
        """Explicit purge (delete_local / rc decref): a ghost of a
        deleted block must not pin RAM."""
        with self._lock:
            self._hits_by_key.pop(hash32, None)
            data = self._prob.pop(hash32, None)
            if data is not None:
                self._prob_bytes -= len(data)
                return
            data = self._prot.pop(hash32, None)
            if data is not None:
                self._prot_bytes -= len(data)

    def clear(self) -> None:
        with self._lock:
            self._prob.clear()
            self._prot.clear()
            self._hits_by_key.clear()
            self._prob_bytes = self._prot_bytes = 0

    # ---- internals (lock held) -----------------------------------------

    def _shed_protected(self) -> None:
        """Demote protected LRU entries to probation MRU until the
        protected segment fits its cap."""
        while self._prot_bytes > self._prot_cap and self._prot:
            h, data = self._prot.popitem(last=False)
            self._prot_bytes -= len(data)
            self._prob[h] = data
            self._prob_bytes += len(data)

    def _evict_to_budget(self) -> None:
        """Probation pays first; protected is only evicted when the
        budget itself shrank below the protected segment."""
        while self._prob_bytes + self._prot_bytes > self.max_bytes \
                and self._prob:
            h, data = self._prob.popitem(last=False)
            self._prob_bytes -= len(data)
            self._hits_by_key.pop(h, None)
            self.evictions += 1
        while self._prob_bytes + self._prot_bytes > self.max_bytes \
                and self._prot:
            h, data = self._prot.popitem(last=False)
            self._prot_bytes -= len(data)
            self._hits_by_key.pop(h, None)
            self.evictions += 1

    # ---- surface -------------------------------------------------------

    @property
    def bytes_used(self) -> int:
        return self._prob_bytes + self._prot_bytes

    @property
    def entries(self) -> int:
        return len(self._prob) + len(self._prot)

    def stats(self) -> dict:
        """Counter snapshot for /metrics (`cache_*`) and the tuning
        API."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "inserts": self.inserts,
            "rejected": self.rejected,
            "hit_bytes": self.hit_bytes,
            "bytes": self.bytes_used,
            "protected_bytes": self._prot_bytes,
            "entries": self.entries,
            "max_bytes": self.max_bytes,
        }
