"""Content hashes of the block data path (the subset of the JAX
package's utils/data.py that the port uses).

The block content hash is BLAKE3-256: its chunk tree batches onto the
GPU (ops/treehash.py); the native C library serves the host path and
the pure-Python tree is the last-resort fallback. blake2b-256 stays as
the legacy algorithm a content hash may still match."""

from __future__ import annotations

import hashlib

_b3_impl = None


def blake2sum(data: bytes) -> bytes:
    """blake2b-256 — the metadata/item hash."""
    return hashlib.blake2b(data, digest_size=32).digest()


def blake3sum(data: bytes) -> bytes:
    """BLAKE3-256 — the block content hash (native, else pure Python;
    both produce identical digests)."""
    global _b3_impl
    if _b3_impl is None:
        try:
            from ..native import blake3 as impl

            impl(b"")  # force build/load now, not mid-request
        except RuntimeError:
            from ..ops.treehash import blake3_py as impl
        _b3_impl = impl
    return _b3_impl(data)


def content_hash_matches(data: bytes, hash32: bytes) -> bool:
    """True if `data` hashes to `hash32` under BLAKE3 or, failing that,
    the legacy blake2 (stores migrated from blake2 stay readable)."""
    return blake3sum(data) == hash32 or blake2sum(data) == hash32
