"""The port's PUT path returns the first block's ingest lease when the
object-table lookup beside that block's read fails.

save_stream (api/s3/put.py) reads the first block into a leased buffer
of the zero-copy ingest pool while it looks the key up in the object
table. When the lookup fails (a 503 from a node, or from a gateway
worker that has not reached its peers yet), the JAX package's text
raises without releasing that lease; after `[s3_api] ingest_buffers`
such failures every later PUT of the process waits for a lease forever.
The port releases it. Both packages run the same scenario here: a pool
of 2 buffers and a lookup that always fails."""

from __future__ import annotations

import asyncio
from types import SimpleNamespace

import pytest

from garage_tpu.api.s3 import put as jput
from garage_tpu.block.hostbuf import HostBufPool as JPool
from garage_tpu_torch.api.s3 import put as tput
from garage_tpu_torch.block.hostbuf import HostBufPool

BLOCK = 4096


class Body:
    """An aws-chunk-less request body of `n` bytes."""

    def __init__(self, n: int):
        self.left = n

    async def read(self, n: int) -> bytes:
        take = min(n, self.left)
        self.left -= take
        return b"x" * take


class LookupFailed(Exception):
    pass


def _garage(pool, failures: int = 1 << 30):
    """A node whose object-table lookup fails `failures` times, then
    finds no object."""
    left = [failures]

    async def get(bucket_id, key):
        await asyncio.sleep(0)
        left[0] -= 1
        if left[0] >= 0:
            raise LookupFailed("quorum not reached")
        return None

    return SimpleNamespace(
        config=SimpleNamespace(block_size=BLOCK, s3_ingest_buffers=2),
        qos=None,
        block_manager=SimpleNamespace(ingest_pool=lambda bs, n: pool),
        object_table=SimpleNamespace(get=get))


async def _put(mod, garage):
    return await mod.save_stream(garage, b"b" * 32, "key", {},
                                 Body(3 * BLOCK), content_length=3 * BLOCK)


def test_failed_lookup_returns_the_first_block_lease():
    pool = HostBufPool(2, BLOCK, 2)
    garage = _garage(pool)

    async def scenario():
        for _ in range(5):  # more failures than the pool has buffers
            with pytest.raises(LookupFailed):
                await asyncio.wait_for(_put(tput, garage), 10)
            assert pool.outstanding() == 0

    asyncio.run(scenario())


def test_the_jax_package_keeps_the_lease():
    """The divergence, pinned: the JAX package's save_stream leaves one
    lease out per failed lookup, so on a pool of 2 its third PUT, whose
    lookup succeeds, never gets a buffer for its first block."""
    pool = JPool(2, BLOCK, 2)
    garage = _garage(pool, failures=2)

    async def scenario():
        for _ in range(2):
            with pytest.raises(LookupFailed):
                await asyncio.wait_for(_put(jput, garage), 10)
        await asyncio.sleep(0.05)
        assert pool.outstanding() == 2
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(_put(jput, garage), 0.5)

    asyncio.run(scenario())
