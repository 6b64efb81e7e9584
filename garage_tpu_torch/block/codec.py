"""ErasureCodec: the erasure(k, m) block codec of the port.

Parts are Reed-Solomon GF(2^8) shards (ops/rs.py: Cauchy matrix); any
k of k + m reconstruct. `encode`/`encode_batch` run the port's
rs.encode on the codec's device — kernel G1 on "cuda" (the default),
its plain torch version on "cpu" — and never fall back to numpy by
themselves. Decode, repair and parity checks run batched through the
feeder's ops; the JAX package's host-only single-stripe codec paths
and shard placement on nodes (`shard_nodes_of`) come with the block
manager and layout slices."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops import rs


class ErasureCodec:
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
        """Encode many blocks in one device launch (padded to the
        longest; each part keeps its block's true shard length)."""
        if not blocks:
            return []
        slens = [rs.shard_len(len(b), self.k) for b in blocks]
        smax = max(slens)
        batch = np.zeros((len(blocks), self.k, smax), dtype=np.uint8)
        for i, b in enumerate(blocks):
            sh = rs.split_stripe(b, self.k)
            batch[i, :, : sh.shape[1]] = sh
        parity = rs.encode(self.k, self.m,
                           torch.from_numpy(batch).to(self.device)).cpu()
        parity = parity.numpy()
        return [[bytes(batch[i, j, :sl]) for j in range(self.k)]
                + [bytes(parity[i, j, :sl]) for j in range(self.m)]
                for i, sl in enumerate(slens)]
