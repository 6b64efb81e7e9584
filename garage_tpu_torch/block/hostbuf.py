"""Copy of garage_tpu/block/hostbuf.py: import paths rewritten, issue and PR tags dropped.

Pinned host ingest buffers: the zero-copy landing zone of the PUT
path.

The S3 frontend used to re-materialize every PUT body several times
between the socket and the accelerator: the reader returned bytes, the
Chunker joined them into a block, DataBlock prepended its header,
split_stripe reshaped a padded copy, and the feeder's h2d stage packed
yet another padded batch. Each hop is a MiB-scale memcpy on the one
core that also runs the event loop — the r05 captures showed the RS
kernel idling at ~1% feed rate while the frontend shuffled bytes.

This module provides a small pool of PREALLOCATED flat buffers laid
out exactly as the erasure stripe the device consumes:

    [ scheme byte ][ body (block_size bytes) ][ zero tail ]
    '------------------ k * shard_len --------------------'

`rs.split_stripe(prefix + body, k)` is a zero-pad + row-major reshape,
so a full block landed in this layout IS the staged stripe: viewing the
flat buffer as (k, shard_len) is byte-identical to what the copy path
builds, and the feeder's h2d stage can `device_put` it directly. Socket
bytes are copied ONCE — into the leased buffer slice, by the body
reader's readinto1 — and every later stage (hashing, compression
probing, RS staging) reads views over the same memory.

Leases are loop-confined (acquired and released on the event loop
thread, like everything else in the PUT path). Exhaustion is
BACKPRESSURE, not allocation: acquire() parks the caller on a FIFO of
waiters until a release hands its buffer over, so a burst of PUTs
degrades to queueing instead of unbounded RAM. release() is idempotent
per lease, which keeps the abort paths simple: the request's finally,
a cancelled put task, and the conservation check can all release
without coordinating who got there first.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ..utils.metrics import registry


def stripe_shard_len(total: int, k: int) -> int:
    """ceil(total / k) — ops.rs.shard_len without the jax import (this
    module must stay importable from lightweight contexts)."""
    return (total + k - 1) // k


class BlockLease:
    """One leased buffer, valid until release(). Single-use: the pool
    hands out a fresh lease object per acquisition, so the released
    flag makes double-release a no-op instead of a recycle hazard."""

    __slots__ = ("pool", "buf", "k", "slen", "cap", "length", "released")

    def __init__(self, pool: "HostBufPool", buf: np.ndarray):
        self.pool = pool
        self.buf = buf  # flat uint8, k * slen; [0]=scheme, [1:1+cap]=body
        self.k = pool.k
        self.slen = pool.slen
        self.cap = pool.cap
        self.length = 0  # valid body bytes (set by the filler)
        self.released = False

    def __len__(self) -> int:
        return self.length

    @property
    def full(self) -> bool:
        return self.length == self.cap

    @property
    def total_len(self) -> int:
        """prefix byte + body — the packed stripe length pack_shard
        frames (what len(prefix + data) is on the copy path)."""
        return 1 + self.length

    def body_mv(self) -> memoryview:
        """Writable view of the whole body region (the reader's
        readinto1 target; the filler tracks its own offset)."""
        return memoryview(self.buf)[1:1 + self.cap]

    def view(self) -> memoryview:
        """The valid body bytes — what hashing/compression/parity read
        (and what bytes() materializes on the classic-path fallback)."""
        return memoryview(self.buf)[1:1 + self.length]

    def set_scheme(self, scheme: int) -> None:
        """Write the 1-byte DataBlock header in place (the prefix the
        copy path concatenates)."""
        self.buf[0] = scheme

    def stripe(self) -> np.ndarray:
        """(k, slen) view over the flat buffer — byte-identical to
        rs.split_stripe(prefix + body, k) for a FULL block (the tail
        past 1 + cap is kept zero for the life of the pool; see
        HostBufPool.__init__). Callers must check `full` first: a
        partial block's true shard length is smaller and takes the
        classic copy path."""
        return self.buf.reshape(self.k, self.slen)

    def release(self) -> None:
        self.pool.release(self)


class HostBufPool:
    """Fixed pool of `count` stripe-layout buffers for blocks of up to
    `block_size` body bytes split k ways. Loop-confined (no locks)."""

    def __init__(self, k: int, block_size: int, count: int):
        self.k = max(1, int(k))
        self.cap = int(block_size)
        self.slen = stripe_shard_len(1 + self.cap, self.k)
        self.count = max(1, int(count))
        # zeroed ONCE: body writes stay inside [1:1+cap] and the scheme
        # byte inside [0], so the reshape tail (< k bytes) remains zero
        # for the pool's lifetime — the invariant stripe() relies on
        self._free: deque[np.ndarray] = deque(
            np.zeros(self.k * self.slen, dtype=np.uint8)
            for _ in range(self.count))
        self._waiters: deque = deque()
        self._outstanding = 0

    def outstanding(self) -> int:
        """Leases issued and not yet released — the sanitizer
        conservation check asserts this returns to 0 after every
        request, abort paths included."""
        return self._outstanding

    def _issue(self, buf: np.ndarray) -> BlockLease:
        self._outstanding += 1
        return BlockLease(self, buf)

    def try_acquire(self) -> Optional[BlockLease]:
        if not self._free:
            return None
        return self._issue(self._free.popleft())

    async def acquire(self) -> BlockLease:
        """FIFO backpressure: when the pool is dry, park until a
        release hands this waiter a buffer directly (never allocates —
        a PUT burst queues instead of growing RAM)."""
        lease = self.try_acquire()
        if lease is not None:
            return lease
        import asyncio

        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        registry().inc("s3_ingest_buf_wait")
        return await fut

    def release(self, lease: BlockLease) -> None:
        if lease.released:
            return  # idempotent: abort paths release without electing an owner
        lease.released = True
        self._outstanding -= 1
        buf = lease.buf
        while self._waiters:
            fut = self._waiters.popleft()
            if fut.cancelled():
                continue
            fut.set_result(self._issue(buf))
            return
        self._free.append(buf)

    def stats(self) -> dict:
        return {"count": self.count, "free": len(self._free),
                "outstanding": self._outstanding,
                "waiters": len(self._waiters),
                "buf_bytes": self.k * self.slen}
