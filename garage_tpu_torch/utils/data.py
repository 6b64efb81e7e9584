"""Copy of garage_tpu/utils/data.py: import paths rewritten, issue and PR tags dropped.

Core data types: 32-byte ids, hashes, hex codecs.

Ref parity: src/util/data.rs:9-177 (FixedBytes32 = Uuid = Hash, sha256sum,
blake2sum, fasthash, gen_uuid). Design difference: the block *content* hash in
this framework is a parallel tree hash (ops/treehash.py) so it can run batched
on TPU; blake2b-256 remains the metadata/item hash exactly like the reference.
"""

from __future__ import annotations

import hashlib
import os

# A FixedBytes32 is just `bytes` of length 32. We keep plain bytes (hashable,
# comparable, serializable) rather than a wrapper class; helpers below enforce
# the invariant where it matters.

Hash = bytes  # 32 bytes
Uuid = bytes  # 32 bytes

ZERO_HASH: Hash = b"\x00" * 32


def check32(b: bytes) -> bytes:
    if len(b) != 32:
        raise ValueError(f"expected 32 bytes, got {len(b)}")
    return b


def sha256sum(data: bytes) -> Hash:
    """ref: src/util/data.rs:114-122"""
    return hashlib.sha256(data).digest()


def blake2sum(data: bytes) -> Hash:
    """blake2b-256 — the metadata/item hash. ref: src/util/data.rs:124-132"""
    return hashlib.blake2b(data, digest_size=32).digest()


def blake3sum(data: bytes) -> Hash:
    """BLAKE3-256 — the block *content* hash. Chosen over the
    reference's sequential blake2 (src/util/data.rs:124-132) because its
    chunk tree batches onto the TPU (ops/treehash.py); the native C
    kernel serves the host path, the pure-Python tree is the last-resort
    fallback. All three produce identical digests (tests/test_treehash)."""
    global _b3_impl
    if _b3_impl is None:
        try:
            from ..native import blake3 as impl

            impl(b"")  # force build/load now, not mid-request
        except Exception:
            from ..ops.treehash import blake3_py as impl
        _b3_impl = impl
    return _b3_impl(data)


_b3_impl = None

# The CLUSTER-WIDE content-hash algorithm (process-global by design:
# content addresses must agree across every node, so per-instance algos
# make no sense — multiple in-process Garage instances share it, and
# set_content_hash_algo warns if configs disagree). "blake3" is the
# native default; "blake2" mirrors the reference for stores migrated
# from it. Verification paths try the configured algo first, then the
# other, so mixed-algo stores stay readable during a migration.
_CONTENT_ALGOS = {"blake3": blake3sum, "blake2": blake2sum}
_content_algo = "blake3"
_content_algo_pinned = False


def set_content_hash_algo(algo: str) -> None:
    global _content_algo, _content_algo_pinned
    if algo not in _CONTENT_ALGOS:
        raise ValueError(f"unknown content hash algo {algo!r}")
    if _content_algo_pinned and algo != _content_algo:
        import logging

        logging.getLogger("garage_tpu_torch.utils").warning(
            "content hash algo changed %s -> %s; in-process instances "
            "share one algorithm — mixed configs are a misconfiguration",
            _content_algo, algo)
    _content_algo = algo
    _content_algo_pinned = True


def content_hash(data: bytes) -> Hash:
    return _CONTENT_ALGOS[_content_algo](data)


def content_hash_matches(data: bytes, hash32: bytes) -> bool:
    """True if `data` hashes to `hash32` under the configured algo or,
    failing that, any other known algo (migration tolerance)."""
    if content_hash(data) == hash32:
        return True
    return any(fn(data) == hash32 for name, fn in _CONTENT_ALGOS.items()
               if name != _content_algo)


def fasthash(data: bytes) -> int:
    """Fast non-cryptographic 64-bit hash (ref xxh3: src/util/data.rs:134-143).

    xxhash is not available in this image; blake2b-8byte is the stand-in.
    Used only for in-memory sharding decisions, never persisted.
    """
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


def gen_uuid() -> Uuid:
    """Random 32-byte uuid. ref: src/util/data.rs:145-150"""
    return os.urandom(32)


def hex_of(h: bytes) -> str:
    return h.hex()


def hash_of_hex(s: str) -> Hash:
    return check32(bytes.fromhex(s))


def debug_short(h: bytes) -> str:
    """First 8 hex chars, for logs. ref: src/util/data.rs hexdump style."""
    return h[:4].hex()
