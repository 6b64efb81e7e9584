"""BlockCodec: the replicate-N / erasure(k,m) plugin boundary (ported
from the JAX package's block/codec.py).

- ReplicateCodec(n): every part IS the whole block; any 1 part
  reconstructs.
- ErasureCodec(k, m): parts are Reed-Solomon GF(2^8) shards (ops/rs.py:
  Cauchy matrix); any k of k + m reconstruct. Writes are durable once
  `write_quorum` parts land.

What differs from the JAX package: `ErasureCodec.encode`/`encode_batch`
run the port's rs.encode on the codec's device — kernel G1 on "cuda"
(the default), its plain torch version on "cpu" — and never fall back
to numpy by themselves. `decode`, `repair_parts` and `parity_ok` stay
the reference's host-only single-stripe paths (numpy): the block
manager calls `decode` only for an all-systematic stripe (a pure
concat) and deep scrub's localization sweep uses them by design; the
batched device route for everything else is the feeder's.

Shard placement uses the ring: part i of a block in partition p goes to
the i-th distinct node walking the ring from p (`shard_nodes_of`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops import rs
from ..utils.data import content_hash_matches
from ..utils.error import MissingBlock
from .device_backend import bucket_items, round_vec


class BlockCodec:
    """width parts per block; any `read_need` reconstruct."""

    width: int
    read_need: int
    write_quorum: int

    def encode(self, data: bytes) -> list[bytes]:
        raise NotImplementedError

    def decode(self, parts: dict[int, bytes], plain_len: int) -> bytes:
        """parts: {part_index: bytes}, at least read_need of them."""
        raise NotImplementedError

    def parity_ok(self, parts: dict[int, bytes], hash32: bytes) -> bool:
        """Scrub check: do these parts reconstruct the block?"""
        raise NotImplementedError


class ReplicateCodec(BlockCodec):
    def __init__(self, n: int, write_quorum: int | None = None):
        self.width = n
        self.read_need = 1
        self.write_quorum = write_quorum if write_quorum is not None \
            else max(1, n // 2 + 1)

    def encode(self, data: bytes) -> list[bytes]:
        return [data] * self.width

    def decode(self, parts, plain_len):
        for _, b in sorted(parts.items()):
            return b
        raise MissingBlock(b"")

    def parity_ok(self, parts, hash32):
        return any(content_hash_matches(b, hash32) for b in parts.values())


class ErasureCodec(BlockCodec):
    """RS(k, m) striping; width parts per block, any k reconstruct."""

    def __init__(self, k: int, m: int, write_quorum: int | None = None,
                 device="cuda"):
        self.k, self.m = k, m
        self.width = k + m
        self.read_need = k
        # durable against m failures by default
        self.write_quorum = write_quorum if write_quorum is not None \
            else min(k + (m + 1) // 2, k + m)
        self.device = resolve_device(device)

    def encode(self, data: bytes) -> list[bytes]:
        return self.encode_batch([data])[0]

    def encode_batch(self, blocks: list[bytes]) -> list[list[bytes]]:
        """Encode many blocks in one device launch, shaped as the staged
        backend shapes its launches (items up the bucket ladder, shard
        length to the vector width); each part keeps its block's true
        shard length."""
        if not blocks:
            return []
        slens = [rs.shard_len(len(b), self.k) for b in blocks]
        bpad = bucket_items(len(blocks))
        batch = np.zeros((bpad, self.k, round_vec(max(slens))),
                         dtype=np.uint8)
        for i, b in enumerate(blocks):
            sh = rs.split_stripe(b, self.k)
            batch[i, :, : sh.shape[1]] = sh
        parity = rs.encode(self.k, self.m,
                           torch.from_numpy(batch).to(self.device)).cpu()
        parity = parity.numpy()
        return [[bytes(batch[i, j, :sl]) for j in range(self.k)]
                + [bytes(parity[i, j, :sl]) for j in range(self.m)]
                for i, sl in enumerate(slens)]

    def decode(self, parts: dict[int, bytes], plain_len: int) -> bytes:
        """Host-only single-stripe decode (numpy); the batched device
        route is the feeder's `decode` op."""
        if len(parts) < self.k:
            raise MissingBlock(b"")
        idx = tuple(sorted(parts.keys())[: self.k])
        shards = np.stack(
            [np.frombuffer(parts[i], dtype=np.uint8) for i in idx]
        )
        if all(i < self.k for i in idx):
            data = shards  # all-systematic: no math needed
        else:
            data = rs.decode_np(self.k, self.m, idx, shards)
        return rs.join_stripe(data, plain_len)

    def repair_parts(self, parts: dict[int, bytes],
                     missing: tuple[int, ...]) -> dict[int, bytes]:
        """Recompute lost shards from any k present ones (host-only; the
        batched device route is feeder.repair)."""
        idx = tuple(sorted(parts.keys())[: self.k])
        shards = np.stack(
            [np.frombuffer(parts[i], dtype=np.uint8) for i in idx]
        )
        out = rs.repair_np(self.k, self.m, idx, tuple(missing), shards)
        return {mi: bytes(out[j]) for j, mi in enumerate(missing)}

    def parity_ok(self, parts: dict[int, bytes], hash32: bytes) -> bool:
        """All width parts present and mutually consistent: systematic
        shards re-encode to the stored parity."""
        if len(parts) < self.k:
            return False
        try:
            data = np.stack(
                [np.frombuffer(parts[i], dtype=np.uint8) for i in range(self.k)]
            )
        except KeyError:
            # missing a systematic shard: decode then compare what exists
            try:
                idx = tuple(sorted(parts.keys())[: self.k])
                shards = np.stack(
                    [np.frombuffer(parts[i], dtype=np.uint8) for i in idx]
                )
                data = rs.decode_np(self.k, self.m, idx, shards)
            except Exception:
                return False
        parity = rs.encode_np(self.k, self.m, data)
        for i, p in parts.items():
            if i >= self.k and bytes(parity[i - self.k]) != p:
                return False
            if i < self.k and bytes(data[i]) != p:
                return False
        return True


def shard_nodes_of(layout_version, hash32: bytes, width: int) -> list[bytes]:
    """`width` distinct nodes for a block's parts: the ring nodes of its
    partition, then of successive partitions, dedup'd, in order. For
    replicate-n this equals nodes_of (width == rf). Deterministic given
    a layout version, so every node computes the same placement."""
    from ..rpc.layout.version import N_PARTITIONS, partition_of

    p0 = partition_of(hash32)
    out: list[bytes] = []
    for off in range(N_PARTITIONS):
        for n in layout_version.nodes_of((p0 + off) % N_PARTITIONS):
            if n not in out:
                out.append(n)
                if len(out) == width:
                    return out
    return out  # cluster smaller than width: best effort
