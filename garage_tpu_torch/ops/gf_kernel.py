"""Kernels G1 (gf_apply) and G2 (gf_check): GF(2^8) matrix application
and the parity compare, hand-written CUDA (csrc/gf256.cu).

G1 replaces the JAX package's Pallas kernel (ops/pallas_gf.py:_kernel)
and its XLA twins (ops/gf256.py:bit_matmul_apply,
bit_matmul_apply_batched); G2 replaces ops/rs.py:_jit_parity_check.
Both are bound by memory: (k + r) * S bytes per item at 3.35 TB/s.
G1 computes on the tensor cores (int8 mma of 0/1 bit planes) over work
units of one (item, S-tile), the tile and the persistent grid planned
from the launch shape and the device by the library's own `gt_g1_plan`
(`g1_plan`; `last_plan` keeps the plan of the latest launch). One G1
launch takes at most MAX_ROWS output and MAX_K input rows; a larger map
(the decode of erasure(20,4)) runs as launches over slices of both, the
launches along k XORing their products into the output. G2 computes
the syndrome [A | I] . stripe on the tensor cores with the same
operands and planner (`g2_plan`; `last_check_plan`) and flags a stripe
where any syndrome bit is set (one byte per stripe, set to 1 by a
memset in the same entry and cleared by the kernel); it takes every
code with k + m <= 256, the rows of a code too tall for one launch
split over a few launches that clear the same bytes.

Each wrapper takes its kernel's plain torch version for a tensor on the
CPU, and only there; a CUDA tensor launches the kernel or raises. The
coefficient matrices are runtime operands — (B, r, k) per item, or
(1, r, k) broadcast — so one build serves every erasure pattern.
`launches` counts kernel launches per wrapper."""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, gf256

launches = {"gf_apply": 0, "gf_check": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    "gt_gf_apply": [_P, _I64, _P, _I64, _P, _I64, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, _I64, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, _P],
    "gt_g1_plan": [ctypes.c_int, ctypes.c_int, ctypes.c_int, _I64,
                   ctypes.c_int, _P],
    "gt_gf_check": [_P, _I64, _P, _I64, _P, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, _I64,
                    ctypes.c_int, ctypes.c_int, _P],
}
MAX_ROWS = 16  # GF_MAX_ROWS in csrc/gf256.cu: output rows of one G1 launch
MAX_K = 16  # input rows of one G1 launch: 4 * G1_MAX_KS in csrc/gf256.cu
VEC = 16  # the kernels need S % 16 == 0 (16-byte rows for bulk copies)
# G1's and G2's geometry at their latest launch: the launch shape and
# gt_g1_plan's tile, grid, units and shared memory
last_plan: dict = {}
last_check_plan: dict = {}


def _check_args(mats: torch.Tensor, x: torch.Tensor, k: int, r: int) -> None:
    if mats.dtype != torch.uint8 or x.dtype != torch.uint8:
        raise TypeError("gf kernels take uint8 matrices and data")
    if mats.device != x.device:
        raise ValueError(f"matrices on {mats.device}, data on {x.device}")
    if mats.dim() != 3 or mats.shape[0] not in (1, x.shape[0]) \
            or mats.shape[2] != k:
        raise ValueError(f"matrices {tuple(mats.shape)} do not fit data "
                         f"{tuple(x.shape)}")
    if r < 1 or k < 1:
        raise ValueError(f"unsupported GF map {r}x{k}")


def _launch_args(mats: torch.Tensor):
    """Contiguous matrices and their per-item stride (0: broadcast)."""
    mats = mats.contiguous()
    stride = 0 if mats.shape[0] == 1 else mats.shape[1] * mats.shape[2]
    return mats, stride


@functools.lru_cache(maxsize=1024)
def _plan(b: int, k: int, r: int, s: int, check: bool,
          device: torch.device) -> tuple[int, int, int, int, int]:
    plan = (ctypes.c_int * 5)()
    lib = _build.load("gf256", _SIGNATURES)
    with torch.cuda.device(device):
        _build.check(lib.gt_g1_plan(b, k, r, s, int(check), plan),
                     "g2_plan" if check else "g1_plan")
    return tuple(plan)


def g1_plan(b: int, k: int, r: int, s: int,
            device: torch.device) -> tuple[int, int, int, int]:
    """G1's (tile, grid, units, smem) for b items of (k <= MAX_K, s) ->
    (r <= MAX_ROWS, s) on `device`, from the library's planner
    (gt_g1_plan)."""
    return _plan(b, k, r, s, False, device)[:4]


def g2_plan(b: int, k: int, m: int, s: int,
            device: torch.device) -> tuple[int, int, int, int, int]:
    """G2's (rows, tile, grid, units, smem) for b stripes of k data rows
    and m parity rows of s bytes: `rows` is the most of the m syndrome
    rows one launch takes, and the rest of the plan that launch's
    (gt_g1_plan with check = 1)."""
    tile, grid, units, smem, rows = _plan(b, k, m, s, True, device)
    return rows, tile, grid, units, smem


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
    if xk.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("G1 rows must start 16-byte aligned (bulk copies)")
    lib = _build.load("gf256", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sp = s + pad
    for i in range(0, r, MAX_ROWS):  # output rows i .. i + ri
        ri = min(MAX_ROWS, r - i)
        for j in range(0, k, MAX_K):  # input rows j .. j + kj
            kj = min(MAX_K, k - j)
            mij, sij = ((mats, stride) if (ri, kj) == (r, k) else
                        _launch_args(mats[:, i:i + ri, j:j + kj]))
            tile, grid, units, smem = g1_plan(b, kj, ri, sp, x.device)
            err = lib.gt_gf_apply(
                mij.data_ptr(), sij, xk.data_ptr() + j * sp, k * sp,
                out.data_ptr() + i * sp, r * sp, b, kj, ri, sp, tile, grid,
                int(j > 0), stream)
            _build.check(err, "gf_apply")
            launches["gf_apply"] += 1
            last_plan.update(b=b, k=kj, r=ri, s=sp, tile=tile, grid=grid,
                             units=units, smem=smem)
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
    if st.data_ptr() % 16:
        raise ValueError("G2 rows must start 16-byte aligned (bulk copies)")
    sp = s + pad
    mats, stride = _launch_args(mats)
    ok = torch.empty(b, dtype=torch.bool, device=stripes.device)
    lib = _build.load("gf256", _SIGNATURES)
    stream = torch.cuda.current_stream(stripes.device).cuda_stream
    rows = g2_plan(b, k, m, sp, stripes.device)[0]
    for off in range(0, m, rows):  # syndrome rows off .. off + ri
        ri = min(rows, m - off)
        _, tile, grid, units, smem = g2_plan(b, k, ri, sp, stripes.device)
        err = lib.gt_gf_check(
            mats.data_ptr() + off * k, stride, st.data_ptr(), n * sp,
            ok.data_ptr(), int(off == 0), b, k, ri, off, sp, tile, grid,
            stream)
        _build.check(err, "gf_check")
        launches["gf_check"] += 1
        last_check_plan.update(b=b, k=k, r=ri, s=sp, tile=tile, grid=grid,
                               units=units, smem=smem, launches=-(-m // rows))
    return ok
