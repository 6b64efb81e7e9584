"""GF(2^8) arithmetic and the GF(2) bit-matrix formulation (torch port).

The field is GF(2^8) with the primitive polynomial 0x11D
(x^8 + x^4 + x^3 + x^2 + 1) — the polynomial used by most storage
erasure-coding libraries. alpha = 2 is a primitive element.

Two layers:

1. Host-side (numpy, copied from the JAX package): exp/log tables,
   vectorized mul/div, Gauss-Jordan matrix inversion. Used to
   build/invert generator matrices — tiny (k+m <= 256 square), so this
   never needs the device.

2. Plain torch: the *bit-matrix trick*. Multiplication by a constant c in
   GF(2^8) is linear over GF(2): writing a byte as a bit-vector
   b = (b0..b7), c*b = M_c @ b  (mod 2) where M_c is an 8x8 0/1 matrix
   whose column j holds the bits of c * x^j. A whole GF(2^8) matrix
   A (r x s) therefore expands to a GF(2) matrix bits(A) (8r x 8s), and

       A @ X  over GF(2^8)  ==  pack( bits(A) @ unpack(X)  mod 2 )

   which is an ordinary matmul + parity: encode/decode of arbitrarily
   wide stripes becomes one (N, 8s) @ (8s, 8r) matmul and an AND 1.
   These torch functions are the PLAIN versions of the CUDA kernel in
   csrc/gf256.cu (ops/gf_kernel.py): the CPU tests run them, and
   chip_smoke.py holds the kernel against them on the card. The kernel
   itself uses per-byte product tables, which a GPU serves from shared
   memory.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, primitive
GF_ORDER = 255  # multiplicative group order


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for alpha=2. exp is doubled to 510 entries so
    exp[log[a] + log[b]] needs no modular reduction."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(GF_ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    for i in range(GF_ORDER, 512):
        exp[i] = exp[i - GF_ORDER]
    log[0] = -1  # sentinel; callers must special-case zero
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a, b):
    """Element-wise GF(2^8) multiply; numpy arrays or scalars (uint8)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = GF_EXP[GF_LOG[a] + GF_LOG[b]]
    return np.where((a == 0) | (b == 0), np.uint8(0), out)


def gf_inv(a):
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("gf_inv(0)")
    return GF_EXP[GF_ORDER - GF_LOG[a]]


def gf_div(a, b):
    return gf_mul(a, gf_inv(b))


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Dense GF(2^8) matrix product (host-side, small matrices only)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    # (r, s, 1) x (1, s, c) -> sum over s with XOR reduction
    prod = gf_mul(a[:, :, None], b[None, :, :])
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_inv_matrix(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8). Raises if singular."""
    a = np.asarray(a, dtype=np.uint8)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"square matrix required, got {a.shape}")
    aug = np.concatenate([a.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv_rows = np.nonzero(aug[col:, col])[0]
        if piv_rows.size == 0:
            raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
        piv = col + int(piv_rows[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul(aug[col], gf_inv(aug[col, col]))
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] = aug[row] ^ gf_mul(aug[row, col], aug[col])
    return aug[:, n:]


# ---------------------------------------------------------------------------
# GF(2) bit-matrix expansion
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mul_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix M_c with (M_c @ bits(b)) % 2 == bits(c*b).

    Column j = bits of c * x^j (LSB-first bit order).
    """
    cols = []
    for j in range(8):
        p = int(gf_mul(c, 1 << j))
        cols.append([(p >> i) & 1 for i in range(8)])
    return np.array(cols, dtype=np.uint8).T  # columns stacked


def expand_bitmatrix(a: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix (r, s) to its GF(2) form (8r, 8s) uint8."""
    a = np.asarray(a, dtype=np.uint8)
    r, s = a.shape
    out = np.zeros((8 * r, 8 * s), dtype=np.uint8)
    for i in range(r):
        for j in range(s):
            out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = _mul_bitmatrix(int(a[i, j]))
    return out


# ---------------------------------------------------------------------------
# Plain torch bit matmul (the kernels' reference formulation)
# ---------------------------------------------------------------------------
#
# Sums of 0/1 products are <= 8s <= 2048, exact in float32, so the
# products run as float32 matmuls: torch has no integer matmul on CUDA,
# and the plain versions must run on the card for the kernel checks.


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., s, n) uint8 bytes -> (..., n, 8s) float32 bits (LSB-first).

    Axis order: for byte-position p, the bit vector is the concatenation
    over the s symbols of their 8 bits — matching expand_bitmatrix."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x[..., None] >> shifts) & 1  # (..., s, n, 8) uint8
    bits = bits.movedim(-3, -2)  # (..., n, s, 8)
    return bits.reshape(*bits.shape[:-2], -1).to(torch.float32)


def pack_bits(bits: torch.Tensor, r: int) -> torch.Tensor:
    """(..., n, 8r) 0/1 -> (..., r, n) uint8 bytes (LSB-first)."""
    bits = bits.reshape(*bits.shape[:-1], r, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    out = (bits * weights).sum(dim=-1).to(torch.uint8)
    return out.movedim(-1, -2)  # (..., r, n)


def bit_matmul_apply(bitmat_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply one GF(2^8) linear map to byte columns.

    bitmat_t: (8s, 8r) — expand_bitmatrix(A).T, A being (r, s).
    x:        (..., s, n) uint8.
    returns   (..., r, n) uint8 == A @ x over GF(2^8), per byte-position."""
    r8 = bitmat_t.shape[1]
    acc = unpack_bits(x) @ bitmat_t.to(torch.float32)  # (..., n, 8r)
    return pack_bits(acc.to(torch.int32) & 1, r8 // 8)


def bit_matmul_apply_batched(bitmats_t: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """Per-item GF(2^8) linear maps, the matrices as DATA.

    bitmats_t: (B, 8s, 8r) — expand_bitmatrix(A_i).T per item.
    x:         (B, s, n) uint8.
    returns    (B, r, n) uint8 == A_i @ x_i over GF(2^8)."""
    r8 = bitmats_t.shape[-1]
    acc = torch.bmm(unpack_bits(x), bitmats_t.to(torch.float32))
    return pack_bits(acc.to(torch.int32) & 1, r8 // 8)


def bitmat_t_for(a: np.ndarray) -> np.ndarray:
    """Constant operand for bit_matmul_apply: expand_bitmatrix(a).T as
    int8 (numpy; callers move it to their device)."""
    return expand_bitmatrix(a).T.astype(np.int8)


_MULBITS = np.stack([_mul_bitmatrix(c) for c in range(256)])  # (256, 8, 8)


def expand_bits_t(mats: torch.Tensor) -> torch.Tensor:
    """Coefficient matrices (B, r, s) uint8 -> their transposed bit
    expansions (B, 8s, 8r) int8, on the matrices' device: the torch
    twin of bitmat_t_for, batched (the plain gf_apply's operand)."""
    b, r, s = mats.shape
    table = torch.from_numpy(_MULBITS).to(mats.device)
    bits = table[mats.to(torch.int64)]  # (B, r, s, 8a, 8c)
    bits = bits.permute(0, 1, 3, 2, 4).reshape(b, 8 * r, 8 * s)
    return bits.transpose(1, 2).to(torch.int8)
