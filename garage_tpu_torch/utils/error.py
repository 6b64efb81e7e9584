"""Error types of the block data path (the subset of the JAX package's
utils/error.py that the port uses)."""

from __future__ import annotations


class GarageError(Exception):
    """Base error."""


class CorruptData(GarageError):
    def __init__(self, hash_: bytes):
        self.hash = hash_
        super().__init__(f"corrupt data for block {hash_.hex()[:16]}")

