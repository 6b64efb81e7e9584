"""Kernels G1 (gf_apply) and G2 (gf_check): GF(2^8) matrix application
and the parity compare, hand-written CUDA (csrc/gf256.cu).

G1 replaces the JAX package's Pallas kernel (ops/pallas_gf.py:_kernel)
and its XLA twins (ops/gf256.py:bit_matmul_apply,
bit_matmul_apply_batched); G2 replaces ops/rs.py:_jit_parity_check.
Both are bound by memory: (k + r) * S bytes per item at 3.35 TB/s.

Each wrapper takes its kernel's plain torch version for a tensor on the
CPU, and only there; a CUDA tensor launches the kernel or raises. The
coefficient matrices are runtime operands — (B, r, k) per item, or
(1, r, k) broadcast — so one build serves every erasure pattern.
`launches` counts kernel launches per wrapper."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, gf256

launches = {"gf_apply": 0, "gf_check": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    "gt_gf_apply": [_P, _P, _I64, _P, _P, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, _I64, _P],
    "gt_gf_check": [_P, _P, _I64, _P, _P, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, _I64, _P],
}
MAX_ROWS = 16  # GF_MAX_ROWS in csrc/gf256.cu
VEC = 16  # bytes per thread step: the kernels need S % 16 == 0

_MUL = gf256.gf_mul(np.arange(256, dtype=np.uint8)[:, None],
                    np.arange(256, dtype=np.uint8)[None, :])  # (256, 256)
_mul_tables: dict[torch.device, torch.Tensor] = {}


def _mul_table(device: torch.device) -> torch.Tensor:
    """The full 64 KiB product table on `device` (row c = c * v)."""
    t = _mul_tables.get(device)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(_MUL).reshape(-1)).to(device)
        _mul_tables[device] = t
    return t


def _check_args(mats: torch.Tensor, x: torch.Tensor, k: int, r: int) -> None:
    if mats.dtype != torch.uint8 or x.dtype != torch.uint8:
        raise TypeError("gf kernels take uint8 matrices and data")
    if mats.device != x.device:
        raise ValueError(f"matrices on {mats.device}, data on {x.device}")
    if mats.dim() != 3 or mats.shape[0] not in (1, x.shape[0]) \
            or mats.shape[2] != k:
        raise ValueError(f"matrices {tuple(mats.shape)} do not fit data "
                         f"{tuple(x.shape)}")
    if not 1 <= r <= MAX_ROWS or r * k * 256 > 200 * 1024:
        raise ValueError(f"unsupported GF map {r}x{k}")


def _launch_args(mats: torch.Tensor):
    """Contiguous matrices and their per-item stride (0: broadcast)."""
    mats = mats.contiguous()
    stride = 0 if mats.shape[0] == 1 else mats.shape[1] * mats.shape[2]
    return mats, stride


def gf_apply_plain(mats: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain torch G1: the bit-matrix product of gf256.py."""
    bits_t = gf256.expand_bits_t(mats).expand(x.shape[0], -1, -1)
    return gf256.bit_matmul_apply_batched(bits_t, x)


def gf_apply(mats: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b] = mats[b or 0] (r, k) . x[b] (k, S) over GF(2^8):
    (B|1, r, k) u8, (B, k, S) u8 -> (B, r, S) u8."""
    b, k, s = x.shape
    r = mats.shape[1]
    _check_args(mats, x, k, r)
    if x.device.type == "cpu":
        return gf_apply_plain(mats, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    pad = -s % VEC
    xk = torch.nn.functional.pad(x, (0, pad)) if pad else x.contiguous()
    mats, stride = _launch_args(mats)
    out = torch.empty((b, r, s + pad), dtype=torch.uint8, device=x.device)
    lib = _build.load("gf256", _SIGNATURES)
    err = lib.gt_gf_apply(
        _mul_table(x.device).data_ptr(), mats.data_ptr(), stride,
        xk.data_ptr(), out.data_ptr(), b, k, r, s + pad,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gf_apply")
    launches["gf_apply"] += 1
    return out[..., :s] if pad else out


def gf_check_plain(mats: torch.Tensor, stripes: torch.Tensor) -> torch.Tensor:
    """Plain torch G2: re-encode rows [0, k) and compare with the rest."""
    m, k = mats.shape[1], mats.shape[2]
    parity = gf_apply_plain(mats, stripes[:, :k])
    return (parity == stripes[:, k:k + m]).flatten(1).all(dim=1)


def gf_check(mats: torch.Tensor, stripes: torch.Tensor) -> torch.Tensor:
    """(B|1, m, k) u8 parity matrices, (B, k + m, S) u8 stripes -> (B,)
    bool: True where the stored rows k..k+m equal mats . rows 0..k."""
    b, n, s = stripes.shape
    m, k = mats.shape[1], mats.shape[2]
    if n != k + m:
        raise ValueError(f"stripes {tuple(stripes.shape)} need {k + m} rows")
    _check_args(mats, stripes, k, m)
    if stripes.device.type == "cpu":
        return gf_check_plain(mats, stripes)
    if stripes.device.type != "cuda":
        raise ValueError(f"unsupported device {stripes.device}")
    pad = -s % VEC  # zero columns encode to zero parity: padding is safe
    st = (torch.nn.functional.pad(stripes, (0, pad)) if pad
          else stripes.contiguous())
    mats, stride = _launch_args(mats)
    flags = torch.zeros(b, dtype=torch.int32, device=stripes.device)
    lib = _build.load("gf256", _SIGNATURES)
    err = lib.gt_gf_check(
        _mul_table(stripes.device).data_ptr(), mats.data_ptr(), stride,
        st.data_ptr(), flags.data_ptr(), b, k, m, s + pad,
        torch.cuda.current_stream(stripes.device).cuda_stream)
    _build.check(err, "gf_check")
    launches["gf_check"] += 1
    return flags == 0
