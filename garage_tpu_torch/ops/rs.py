"""Cauchy-Reed-Solomon (k, m) erasure codec, batched on the GPU.

Construction (copied from the JAX package's ops/rs.py): systematic
generator G (n x k, n = k + m) = [I_k ; C] with C the m x k Cauchy
matrix C[i, j] = 1 / (x_i + y_j), x_i = i, y_j = m + j over GF(2^8).
Every square submatrix of a Cauchy matrix is nonsingular, so any k of
the n shards reconstruct the stripe (MDS).

Shapes: a *stripe* is (k, shard_len) bytes of data producing (m,
shard_len) parity; the device ops take arbitrary leading batch dims as
torch uint8 tensors. Decode/repair matrices depend on *which* shards
survive; they are built host-side per erasure pattern (k x k inversion,
microseconds) and cached, and travel to the kernel as DATA: one build
of kernel G1 (ops/gf_kernel.py) serves every pattern. The device ops
run G1/G2 on CUDA tensors and their plain torch versions on CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import gf256, gf_kernel


@functools.lru_cache(maxsize=None)
def generator_matrix(k: int, m: int) -> np.ndarray:
    """(k+m, k) systematic generator over GF(2^8): identity over Cauchy."""
    if k < 1 or m < 0 or k + m > 256:
        raise ValueError(f"need 1 <= k, 0 <= m, k+m <= 256; got k={k} m={m}")
    x = np.arange(m, dtype=np.uint8)[:, None]  # parity row ids
    y = np.arange(m, m + k, dtype=np.uint8)[None, :]  # data col ids
    cauchy = gf256.gf_inv(x ^ y)
    return np.concatenate([np.eye(k, dtype=np.uint8), cauchy], axis=0)


@functools.lru_cache(maxsize=None)
def parity_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) Cauchy part of the generator."""
    return np.ascontiguousarray(generator_matrix(k, m)[k:])


@functools.lru_cache(maxsize=None)
def decode_matrix(k: int, m: int, present: tuple[int, ...]) -> np.ndarray:
    """(k, k) matrix mapping k surviving shards (rows `present` of G,
    ascending) back to the k data shards."""
    if len(present) != k:
        raise ValueError(f"need exactly k={k} shard indices, got {len(present)}")
    sub = generator_matrix(k, m)[list(present)]
    return gf256.gf_inv_matrix(sub)


@functools.lru_cache(maxsize=None)
def repair_matrix(
    k: int, m: int, present: tuple[int, ...], missing: tuple[int, ...]
) -> np.ndarray:
    """(len(missing), k) matrix rebuilding the `missing` shards directly
    from the k `present` ones (data and parity alike)."""
    g = generator_matrix(k, m)
    return gf256.gf_matmul(g[list(missing)], decode_matrix(k, m, present))


@functools.lru_cache(maxsize=None)
def decode_bitmat_t(k: int, m: int, present: tuple[int, ...]) -> np.ndarray:
    """(8k, 8k) int8 transposed bit-expansion of decode_matrix — the
    per-item DATA operand of the pattern-as-data batched kernel
    (gf_apply_batched). Host-side and lru-cached like the matrix
    itself: the inversion plus expansion is microseconds, and caching
    keys on the pattern tuple so a busy mixed-pattern read path builds
    each expansion once."""
    return gf256.bitmat_t_for(decode_matrix(k, m, present))


@functools.lru_cache(maxsize=None)
def repair_bitmat_t(k: int, m: int, present: tuple[int, ...],
                    missing: tuple[int, ...]) -> np.ndarray:
    """(8k, 8·len(missing)) int8 transposed bit-expansion of
    repair_matrix, for the batched repair launch."""
    return gf256.bitmat_t_for(repair_matrix(k, m, present, missing))


# ---------------------------------------------------------------------------
# Device (torch) paths — G1 / G2 on CUDA tensors, plain torch on CPU
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4096)
def _mat_on(mat_bytes: bytes, rows: int, cols: int,
            device: torch.device) -> torch.Tensor:
    """One coefficient matrix as a (1, rows, cols) uint8 tensor on
    `device`, cached by value (bounded: C(k+m, k) patterns at most per
    code, times the devices in use)."""
    mat = np.frombuffer(mat_bytes, dtype=np.uint8).reshape(1, rows, cols)
    return torch.from_numpy(mat.copy()).to(device)


def _apply(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Apply ONE matrix (r, k) to a (..., k, n) batch, the matrix
    broadcast over the batch (stride 0 in the kernel)."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    shape = tuple(x.shape)
    x3 = x.reshape((-1,) + shape[-2:])
    out = gf_kernel.gf_apply(_mat_on(mat.tobytes(), *mat.shape, x.device), x3)
    return out.reshape(shape[:-2] + tuple(out.shape[-2:]))


def encode(k: int, m: int, data: torch.Tensor) -> torch.Tensor:
    """data (..., k, n) uint8 -> parity (..., m, n) uint8."""
    return _apply(parity_matrix(k, m), data)


def decode(k: int, m: int, present: tuple[int, ...],
           shards: torch.Tensor) -> torch.Tensor:
    """shards (..., k, n) = surviving shard rows in ascending-index
    order -> data (..., k, n)."""
    return _apply(decode_matrix(k, m, tuple(present)), shards)


def repair(k: int, m: int, present: tuple[int, ...],
           missing: tuple[int, ...], shards: torch.Tensor) -> torch.Tensor:
    """shards (..., k, n) -> rebuilt missing shards
    (..., len(missing), n)."""
    return _apply(repair_matrix(k, m, tuple(present), tuple(missing)),
                  shards)


def gf_apply_batched(mats: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """Per-stripe GF maps, batched: mats (B, r, s) uint8 COEFFICIENT
    matrices (the JAX package passes their (B, 8s, 8r) bit expansions;
    weights.from_reference converts) + shards (B, s, n) uint8 ->
    (B, r, n) uint8. Pad rows carry zero matrices: zero output rows."""
    return gf_kernel.gf_apply(mats, shards)


def parity_check(k: int, m: int, stripes: torch.Tensor) -> torch.Tensor:
    """stripes (B, k+m, n) uint8 -> (B,) bool: stored parity equals
    parity re-derived from the data shards (the scrub detect pass, G2).
    A corrupt data shard flips every re-derived parity row, a corrupt
    parity row differs in itself: any single corruption is detected.
    Zero-padding stripes to a common n is safe: the code is linear."""
    pmat = np.ascontiguousarray(parity_matrix(k, m))
    return gf_kernel.gf_check(
        _mat_on(pmat.tobytes(), m, k, stripes.device), stripes)


# ---------------------------------------------------------------------------
# Host (numpy) reference + small-input fallback
# ---------------------------------------------------------------------------


def encode_np(k: int, m: int, data: np.ndarray) -> np.ndarray:
    """Table-lookup reference: data (k, n) -> parity (m, n)."""
    return gf256.gf_matmul(parity_matrix(k, m), np.asarray(data, dtype=np.uint8))


def decode_np(k: int, m: int, present: tuple[int, ...], shards: np.ndarray) -> np.ndarray:
    return gf256.gf_matmul(decode_matrix(k, m, present), np.asarray(shards, dtype=np.uint8))


def repair_np(k: int, m: int, present: tuple[int, ...],
              missing: tuple[int, ...], shards: np.ndarray) -> np.ndarray:
    """Host reference: rebuild the `missing` rows directly from the k
    `present` ones (one matmul by the precomposed repair matrix)."""
    return gf256.gf_matmul(repair_matrix(k, m, present, missing),
                           np.asarray(shards, dtype=np.uint8))


# ---------------------------------------------------------------------------
# Stripe layout helpers (byte-level, host)
# ---------------------------------------------------------------------------


def shard_len(block_len: int, k: int) -> int:
    return (block_len + k - 1) // k


def split_stripe(data: bytes, k: int) -> np.ndarray:
    """bytes -> (k, shard_len) uint8, zero-padded. Original length is
    metadata the block layer stores alongside (block/codec.py)."""
    n = shard_len(len(data), k)
    buf = np.zeros(k * n, dtype=np.uint8)
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.reshape(k, n)


def join_stripe(shards: np.ndarray, block_len: int) -> bytes:
    return np.asarray(shards, dtype=np.uint8).reshape(-1)[:block_len].tobytes()
