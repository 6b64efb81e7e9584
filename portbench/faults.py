"""Faults planted under the timed path, for the control and for the
tests that see `correct` come out false (`--fault <name>`; the driver's
runs plant none). Each patches the running port in this process.

- control: breaks the configuration's write guarantee: width - quorum
  + 1 nodes acknowledge part writes without storing them, so every
  acknowledged block is held by fewer parts than the write quorum. For
  a read mix, whose guarantee is that any k of k + m shards rebuild a
  block, the decode applies no matrix: the surviving shards are taken
  for the data rows.
- noop_put: a step that returns its state unchanged: node 0's block
  write returns at once, storing and sending nothing.
- half_batch: half of each feeder batch left out: the second half of a
  device batch's items (rounded up) gets the first half's results, a
  batch of one the previous batch's.
- flip: an answer altered where it is produced: one bit of every
  output row of G1 (parity and decode) and of B3 (content hashes).
- mpu_drop_part: CompleteMultipartUpload leaves the last part's blocks
  out of the object's version and still reports the full ETag.
"""

from __future__ import annotations

import contextvars

NAMES = ("control", "noop_put", "half_batch", "flip", "mpu_drop_part")


def install(name: str, cluster, spec: dict) -> None:
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
    globals()[f"_{name}"](cluster, spec)


def _control(cluster, spec: dict) -> None:
    if spec["op"] == "get":
        _no_decode()
        return
    bm0 = cluster.garages[0].block_manager
    n = bm0.codec.width - bm0.codec.write_quorum + 1
    for g in cluster.garages[1:1 + n]:
        bm = g.block_manager
        bm.write_local_shard = lambda *a, **kw: None
        bm.write_local_payload = lambda *a, **kw: None


def _no_decode() -> None:
    from garage_tpu_torch.ops import rs

    def systematic(mats, shards):
        return shards[:, :mats.shape[1], :].contiguous()
    rs.gf_apply_batched = systematic


def _noop_put(cluster, spec: dict) -> None:
    async def stored_nothing(*a, **kw):
        return None
    cluster.garages[0].block_manager.rpc_put_block = stored_nothing


def _half_batch(cluster, spec: dict) -> None:
    for f in cluster.feeders():
        orig = f._staged_op
        last: dict = {}

        async def halved(op, blobs, orig=orig, last=last):
            out, busy = await orig(op, blobs)
            out = list(out)
            # the second half (rounded up) is never computed: its slots
            # hold what the previous batch of this op left there
            stale = last.get(op, out[0])
            last[op] = out[0]
            for j in range(len(out) // 2, len(out)):
                out[j] = stale if j == 0 else out[j - len(out) // 2]
            return out, busy
        f._staged_op = halved


def _flip_rows(t):
    import torch

    t = t.clone(memory_format=torch.contiguous_format)
    t.view(t.shape[0], -1)[:, 0] ^= 1
    return t


def _flip(cluster, spec: dict) -> None:
    from garage_tpu_torch.ops import rs, treehash

    for mod, name in ((rs, "encode"), (rs, "gf_apply_batched"),
                      (treehash, "hash_rows")):
        orig = getattr(mod, name)

        def flipped(*a, orig=orig, **kw):
            return _flip_rows(orig(*a, **kw))
        setattr(mod, name, flipped)


def _mpu_drop_part(cluster, spec: dict) -> None:
    from garage_tpu_torch.api.s3 import multipart
    from garage_tpu_torch.model.s3.version_table import Version
    from garage_tpu_torch.utils.crdt import CrdtMap

    completing = contextvars.ContextVar("completing", default=False)
    orig = multipart.handle_complete_multipart

    async def complete(ctx, req):
        token = completing.set(True)
        try:
            return await orig(ctx, req)
        finally:
            completing.reset(token)
    multipart.handle_complete_multipart = complete

    table = cluster.garages[0].version_table
    insert = table.insert

    async def insert_short(entry, *a, **kw):
        if completing.get() and isinstance(entry, Version) and entry.blocks:
            last = max(pn for (pn, _off), _v in entry.blocks.items())
            blocks = CrdtMap()
            for (pn, off), v in entry.blocks.items():
                if pn != last:
                    blocks = blocks.put((pn, off), v)
            entry = Version(entry.uuid, entry.deleted, blocks,
                            entry.backlink)
        return await insert(entry, *a, **kw)
    table.insert = insert_short
