"""Batched SHA-256: host padding helpers, the plain torch version, and
the wrapper of kernel S2 (hand-written CUDA, csrc/sha256.cu).

S2 replaces the JAX package's ops/sha256.py:hash_rows (jitted by
hash_fn), the program behind the SigV4 aws-chunked verifier: every
client chunk of a STREAMING-AWS4-HMAC-SHA256-PAYLOAD body is signed
over its SHA-256, and chunk digests are independent across streams, so
concurrent PUTs' chunks batch into one launch (block/feeder.py
`sha256_hex`).

`hash_rows(msgs, nblocks)` takes (B, W) uint8 rows (W a multiple of 64)
that carry their own SHA padding (`pad_row_into`: data, 0x80, zeros,
64-bit big-endian bit length at the true end) and (B,) int32 true block
counts, and returns (B, 32) uint8 digests: the kernel on a CUDA tensor,
the plain torch version (`hash_rows_plain`) on a CPU tensor. Bytes past
a row's last active block are never read, so a group's row width is its
longest message's padded length and shorter rows need no zeroing there.
S2 is warp-specialised: per CTA of up to 32 messages a producer warp
stages blocks and computes the message schedule, a consumer warp runs
the rounds (csrc/sha256.cu); `chain_cycles` times the dependent chain
that bounds a message on the card.

Torch on the CPU has no shifts or adds on uint32, so the plain version
works in int64 masked to 32 bits; a rotate is a shift of the word
doubled into 64 bits. It is one torch op per step of a serial 64-round
chain, hence slow (seconds per 8 KiB row batch on a CPU): the kernel's
reference, no yardstick of speed.

The host halves (n_blocks_for, part_len, pad_row_into, digests_to_hex,
sha256_hex_py) are copies of the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from . import _build

# FIPS 180-4 constants
K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], dtype=np.uint32)

H0 = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)

BLOCK = 64  # compression block bytes


def n_blocks_for(length: int) -> int:
    """Blocks the padded message occupies: data + 0x80 + u64 bit
    length, rounded up to 64."""
    return (length + 9 + BLOCK - 1) // BLOCK


def part_len(data) -> int:
    """Length of one message: bytes/buffer, or a list/tuple of spans —
    the zero-copy aws-chunked path hands a client chunk as the spans it
    landed in the lease (contiguous there, but framed per socket read),
    and concatenating them host-side would be exactly the copy the
    ingest path exists to avoid."""
    if isinstance(data, (list, tuple)):
        return sum(len(p) for p in data)
    return len(data)


def pad_row_into(row: np.ndarray, data) -> int:
    """Write `data` + SHA padding into a ZEROED row of >= n_blocks*64
    bytes; -> the row's true block count. `data` may be bytes, any
    contiguous buffer (the zero-copy PUT path hands leased views), or a
    list/tuple of spans hashed as one message — the row IS the h2d
    staging buffer, so writing spans sequentially here is the one place
    scattered wire bytes become a device-shaped message for free."""
    off = 0
    for part in (data if isinstance(data, (list, tuple)) else (data,)):
        arr = np.frombuffer(part, dtype=np.uint8)
        row[off:off + arr.size] = arr
        off += arr.size
    nb = n_blocks_for(off)
    row[off] = 0x80
    end = nb * BLOCK
    row[end - 8:end] = np.frombuffer(
        (off * 8).to_bytes(8, "big"), dtype=np.uint8)
    return nb


def digests_to_hex(cvs) -> list[str]:
    """(B, 8) u32 digest words -> per-row lowercase hex."""
    arr = np.ascontiguousarray(np.asarray(cvs).astype(">u4"))
    rows = arr.view(np.uint8).reshape(arr.shape[0], 32)
    return [rows[i].tobytes().hex() for i in range(rows.shape[0])]


def sha256_hex_py(data) -> str:
    """Host oracle (accepts span lists like the device path)."""
    h = hashlib.sha256()
    for part in (data if isinstance(data, (list, tuple)) else (data,)):
        h.update(part)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Plain torch version (int64 lanes) — S2's reference formulation
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotr3(x, r1: int, r2: int, r3: int):
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) for int64 x in [0, 2^32):
    the word doubled into 64 bits rotates by a plain right shift."""
    x2 = x | (x << 32)
    return ((x2 >> r1) ^ (x2 >> r2) ^ (x2 >> r3)) & _M32


def _sigma(x, r1: int, r2: int, s: int):
    """Schedule sigma: rotr(x, r1) ^ rotr(x, r2) ^ (x >> s)."""
    x2 = x | (x << 32)
    return ((x2 >> r1) ^ (x2 >> r2) ^ (x >> s)) & _M32


def hash_rows_plain(msgs: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Plain torch S2: (B, W) u8 padded rows + (B,) i32 true block
    counts -> (B, 32) u8 digests."""
    b, width = msgs.shape
    dev = msgs.device
    nblocks = nblocks.to(torch.int64)
    nmax = int(nblocks.max()) if b else 0
    w = msgs[:, :nmax * BLOCK].to(torch.int64).reshape(b, nmax, 16, 4)
    words = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) \
        | w[..., 3]
    # message schedule for every block at once: (blocks, 64, B)
    sched = [words[:, :, t].T for t in range(16)]
    for t in range(16, 64):
        sched.append((sched[t - 16] + _sigma(sched[t - 15], 7, 18, 3)
                      + sched[t - 7] + _sigma(sched[t - 2], 17, 19, 10))
                     & _M32)
    kt = torch.tensor(K.astype(np.int64), device=dev)
    kw = [sched[t] + kt[t] for t in range(64)]  # (blocks, B) each
    h = [torch.full((b,), int(v), dtype=torch.int64, device=dev)
         for v in H0]
    for blk in range(nmax):
        a, bb, c, d, e, f, g, hh = h
        for t in range(64):
            t1 = hh + _rotr3(e, 6, 11, 25) + ((e & (f ^ g)) ^ g) \
                + kw[t][blk]
            t2 = _rotr3(a, 2, 13, 22) + ((a & bb) | (c & (a | bb)))
            hh, g, f, e = g, f, e, (d + t1) & _M32
            d, c, bb, a = c, bb, a, (t1 + t2) & _M32
        live = blk < nblocks
        h = [torch.where(live, (x + y) & _M32, x)
             for x, y in zip(h, (a, bb, c, d, e, f, g, hh))]
    words = torch.stack(h, dim=1)  # (B, 8)
    shifts = torch.tensor([24, 16, 8, 0], device=dev)
    return ((words[:, :, None] >> shifts) & 0xFF).to(torch.uint8) \
        .reshape(b, 32)


# ---------------------------------------------------------------------------
# Kernel S2 wrapper
# ---------------------------------------------------------------------------

launches = {"sha256_rows": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    "gt_sha256_rows": [_P, ctypes.c_longlong, _P, ctypes.c_int, _P, _P],
    "gt_sha256_chain_cycles": [_P, ctypes.c_int, _P],
}
def hash_rows(msgs: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256: (B, W) u8 padded rows + (B,) i32 block counts ->
    (B, 32) u8 digests; one S2 launch on a CUDA tensor."""
    if msgs.dtype != torch.uint8 or msgs.dim() != 2 \
            or msgs.shape[1] % BLOCK or msgs.shape[1] == 0:
        raise ValueError(f"rows must be (B, n*{BLOCK}) uint8, got "
                         f"{tuple(msgs.shape)} {msgs.dtype}")
    if nblocks.shape != (msgs.shape[0],) or nblocks.device != msgs.device:
        raise ValueError("one block count per row, on the rows' device")
    if msgs.device.type == "cpu":
        return hash_rows_plain(msgs, nblocks)
    if msgs.device.type != "cuda":
        raise ValueError(f"unsupported device {msgs.device}")
    b, width = msgs.shape
    msgs = msgs.contiguous()
    if msgs.data_ptr() % 16:
        raise ValueError("rows must start 16-byte aligned (vector loads)")
    nblocks = nblocks.to(torch.int32).contiguous()
    out = torch.empty((b, 32), dtype=torch.uint8, device=msgs.device)
    if b == 0:
        return out
    lib = _build.load("sha256", _SIGNATURES)
    err = lib.gt_sha256_rows(
        msgs.data_ptr(), width, nblocks.data_ptr(), b, out.data_ptr(),
        torch.cuda.current_stream(msgs.device).cuda_stream)
    _build.check(err, "sha256_rows")
    launches["sha256_rows"] += 1
    return out


CHAIN_STEPS = 4096


def chain_cycles(device: torch.device) -> float:
    """SM clock cycles of one step of S2's dependent chain (rotate ->
    LOP3 -> IADD3, the least a round can take through `e`), timed on the
    card by one thread with clock64 over CHAIN_STEPS dependent steps. Not a
    kernel of the path: it feeds S2's bound, and counts no launch."""
    out = torch.zeros(2, dtype=torch.int64, device=device)
    lib = _build.load("sha256", _SIGNATURES)
    _build.check(lib.gt_sha256_chain_cycles(
        out.data_ptr(), CHAIN_STEPS,
        torch.cuda.current_stream(device).cuda_stream), "sha256_chain_cycles")
    return int(out[0].item()) / CHAIN_STEPS
