"""State carried across from the JAX package: its numpy operands turned
into the port's tensors, so a test can feed both sides identical inputs.

The JAX package hands its GF kernels bit-expanded matrices: the
transposed (8s, 8r) int8 expansion `gf256.bitmat_t_for(A)` for the XLA
path (one, or a (B, 8s, 8r) stack for the pattern-as-data path), and the
column-permuted (8r, 8k) expansion `pallas_gf._mat_bits_jk` for the
Pallas kernel. The port's kernel G1 takes the (r, k) GF(2^8)
coefficient matrices themselves; `from_reference` recovers them (column
0 of each 8x8 block M_c holds the bits of c) and checks that
re-expanding gives back the operand bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .ops import gf256


def _coeffs_from_bitmat_t(bitmat_t: np.ndarray) -> np.ndarray:
    """(…, 8s, 8r) transposed bit expansion -> (…, r, s) uint8."""
    bits = np.asarray(bitmat_t).astype(np.uint8) & 1
    s, r = bits.shape[-2] // 8, bits.shape[-1] // 8
    # row 8j + 0 of the transpose = column 0 of block (i, j)
    col0 = bits[..., 0::8, :].reshape(*bits.shape[:-2], s, r, 8)
    weights = (1 << np.arange(8)).astype(np.uint16)
    coeffs = (col0 * weights).sum(axis=-1).astype(np.uint8)  # (…, s, r)
    return np.ascontiguousarray(np.swapaxes(coeffs, -1, -2))


def _coeffs_from_mat_bits_jk(bits_jk: np.ndarray, k: int) -> np.ndarray:
    """(8r, 8k) with columns ordered j*k + s (bit j of symbol s) ->
    (r, k) uint8."""
    bits = np.asarray(bits_jk).astype(np.uint8) & 1
    r = bits.shape[0] // 8
    col0 = bits[:, :k].reshape(r, 8, k)  # columns 0*k + s
    weights = (1 << np.arange(8)).astype(np.uint16)[None, :, None]
    return (col0 * weights).sum(axis=1).astype(np.uint8)


def _check_expansion(coeffs: np.ndarray, want: np.ndarray, name: str) -> None:
    flat = coeffs.reshape(-1, *coeffs.shape[-2:])
    got = np.stack([gf256.bitmat_t_for(c) for c in flat]).reshape(want.shape)
    if not np.array_equal(got.astype(np.uint8), want.astype(np.uint8)):
        raise ValueError(f"{name}: not the bit expansion of a GF(2^8) matrix")


def from_reference(k: int, m: int, jax_side_arrays: dict,
                   device="cuda") -> dict:
    """Map the reference's numpy operands of an RS(k, m) code to the
    port's tensors on `device`, by name:

    - "bitmat_t*": (8k, 8r) or (B, 8k, 8r) -> (r, k) / (B, r, k) uint8
      coefficient matrices (the operand of rs.gf_apply_batched);
    - "mat_bits_jk*": (8r, 8k) -> (r, k) uint8;
    - anything else (stripes, shards, messages) -> a tensor of the same
      bytes.

    Raises when a bit matrix is not the expansion of a GF(2^8) matrix
    with k input symbols, or maps to more than k + m output rows."""
    dev = resolve_device(device)
    out = {}
    for name, arr in jax_side_arrays.items():
        arr = np.asarray(arr)
        if name.startswith(("bitmat_t", "mat_bits_jk")):
            if name.startswith("bitmat_t"):
                coeffs = _coeffs_from_bitmat_t(arr)
                _check_expansion(coeffs, arr, name)
            else:
                coeffs = _coeffs_from_mat_bits_jk(arr, k)
                perm = [s * 8 + j for j in range(8) for s in range(k)]
                _check_expansion(coeffs, arr[:, np.argsort(perm)].T, name)
            if coeffs.shape[-1] != k or coeffs.shape[-2] > k + m:
                raise ValueError(f"{name}: {coeffs.shape[-2:]} map does not "
                                 f"fit RS({k},{m})")
            out[name] = torch.from_numpy(coeffs).to(dev)
        else:
            out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    return out
