"""Copy of garage_tpu/native/__init__.py: import paths rewritten, issue and PR tags dropped.

Native host kernels (C, built on first import, loaded via ctypes).

The framework's compute path is JAX/XLA on the accelerator; the runtime
around it keeps native-code hot spots on the host: BLAKE3 content
hashing and GF(2^8) RS math for when blocks are handled one at a time
(server PUT fallback, shard checksum verify, offline tools). Mirrors the
reference's use of native code for its data path (the reference is Rust
end to end; here C serves the same role behind a Python runtime).

Build: one `gcc -O3 -shared` invocation, cached by source hash under
_build/. If no toolchain is available the callers fall back to the pure
Python / numpy implementations (ops/treehash.py, ops/gf256.py) — slower
but identical results. Set GARAGE_TPU_NO_NATIVE=1 to force the fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "b3gf.c")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _build_and_load() -> Optional[ctypes.CDLL]:
    if os.environ.get("GARAGE_TPU_NO_NATIVE"):
        return None
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    build_dir = os.path.join(_HERE, "_build")
    so_path = os.path.join(build_dir, f"b3gf-{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(build_dir, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        for cc in ("cc", "gcc", "g++"):
            try:
                r = subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    capture_output=True,
                    timeout=120,
                )
            except (OSError, subprocess.TimeoutExpired):
                continue
            if r.returncode == 0:
                os.replace(tmp, so_path)
                break
        else:
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    lib.b3_hash.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.b3_hash_many.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.gf256_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.crc32c_update.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                  ctypes.c_uint64]
    lib.crc32c_update.restype = ctypes.c_uint32
    lib.crc64nvme_update.argtypes = [ctypes.c_uint64, ctypes.c_void_p,
                                     ctypes.c_uint64]
    lib.crc64nvme_update.restype = ctypes.c_uint64
    lib.rs_encode_block_packed.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.gt_md5_state_size.restype = ctypes.c_int
    lib.gt_md5_init.argtypes = [ctypes.c_void_p]
    lib.gt_md5_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64]
    lib.gt_md5_final_copy.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.gt_b3_md5_block.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_void_p, ctypes.c_char_p]
    lib.gt_md5_update_many.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.gt_b3_md5_many.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _tried:
        with _lock:
            if not _tried:
                _lib = _build_and_load()
                _tried = True
    return _lib


def available() -> bool:
    return _get() is not None


def loaded() -> bool:
    """True if the library is ALREADY built and loaded — never triggers
    a build (callers on latency-sensitive paths gate on this)."""
    return _lib is not None


def warm_async() -> None:
    """Kick the build/load in a daemon thread (server startup)."""
    threading.Thread(target=available, daemon=True,
                     name="native-build").start()


def _as_cdata(data):
    """Adapt a hash/encode input for a c_char_p parameter WITHOUT
    copying: bytes pass through; a writable buffer (a leased ingest
    view on the zero-copy PUT path) wraps as a ctypes char
    array over the same memory (pointer argtypes accept char arrays);
    a readonly non-bytes buffer falls back to one materialization."""
    if isinstance(data, bytes):
        return data
    mv = memoryview(data)
    if mv.readonly or mv.nbytes == 0:
        return mv.tobytes()
    return (ctypes.c_char * mv.nbytes).from_buffer(mv)


def blake3(data) -> bytes:
    """32-byte BLAKE3 digest (native; raises if the library is absent —
    use utils.data.blake3sum for the auto-fallback entry point).
    Accepts bytes or any contiguous buffer (hashing never copies)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = ctypes.create_string_buffer(32)
    c = _as_cdata(data)
    lib.b3_hash(c, len(c), out)
    return out.raw


def blake3_many(blobs: list[bytes]) -> list[bytes]:
    """Hash many messages in one native call (GIL released throughout)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(blobs)
    if n == 0:
        return []
    offs = np.zeros(n, dtype=np.int64)
    lens = np.array([len(b) for b in blobs], dtype=np.int64)
    if n > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    joined = b"".join(blobs)
    buf = (np.frombuffer(joined, dtype=np.uint8) if joined
           else np.zeros(1, dtype=np.uint8))
    out = np.empty((n, 32), dtype=np.uint8)
    lib.b3_hash_many(
        buf.ctypes.data, n, offs.ctypes.data, lens.ctypes.data,
        out.ctypes.data,
    )
    return [out[i].tobytes() for i in range(n)]


class Md5:
    """Streaming MD5 (S3 ETag chain) that can FUSE with the BLAKE3
    content hash: update_with_blake3() advances the MD5 state and
    returns the block's blake3 digest from ONE interleaved native pass
    (the PUT path otherwise walks every block twice). Falls back to
    hashlib when the native library is absent; duck-types the hashlib
    surface the PUT path uses (update/hexdigest)."""

    __slots__ = ("_st", "_h")

    def __init__(self):
        lib = _get()
        if lib is not None:
            self._st = ctypes.create_string_buffer(lib.gt_md5_state_size())
            lib.gt_md5_init(self._st)
            self._h = None
        else:
            self._st = None
            self._h = hashlib.md5()

    @property
    def fused(self) -> bool:
        return self._st is not None

    def update(self, data) -> None:
        if self._h is not None:
            self._h.update(data)
        else:
            c = _as_cdata(data)
            _lib.gt_md5_update(self._st, c, len(c))

    def update_with_blake3(self, data) -> bytes:
        """MD5-advance by `data` AND return blake3(data), single pass.
        Only valid when `fused` is True. Accepts bytes or a buffer
        view (the zero-copy PUT path hashes the leased buffer in
        place)."""
        out = ctypes.create_string_buffer(32)
        c = _as_cdata(data)
        _lib.gt_b3_md5_block(c, len(c), self._st, out)
        return out.raw

    def hexdigest(self) -> str:
        if self._h is not None:
            return self._h.hexdigest()
        out = ctypes.create_string_buffer(16)
        _lib.gt_md5_final_copy(self._st, out)
        return out.raw.hex()


def _md5_batch_args(items: list[tuple["Md5", bytes]]):
    """Items may carry bytes OR buffer views (leased ingest slices).
    Returns a keepalive list the caller MUST hold through the native
    call — it owns the char arrays the pointer array aims at."""
    n = len(items)
    keep = [_as_cdata(d) for _, d in items]
    ps = (ctypes.c_void_p * n)(*[
        ctypes.cast(ctypes.c_char_p(c) if isinstance(c, bytes) else c,
                    ctypes.c_void_p)
        for c in keep])
    lens = (ctypes.c_int64 * n)(*[len(c) for c in keep])
    sts = (ctypes.c_void_p * n)(
        *[ctypes.addressof(m._st) for m, _ in items])
    return n, ps, lens, sts, keep


def md5_update_many(items: list[tuple["Md5", bytes]]) -> None:
    """Advance many independent Md5 accumulators in one native call —
    8 AVX2 lanes in lockstep across items (multi-buffer MD5: the serial
    per-object ETag chain vectorizes ACROSS concurrent requests)."""
    if not items:
        return
    n, ps, lens, sts, keep = _md5_batch_args(items)
    _lib.gt_md5_update_many(n, ps, lens, sts)
    del keep


def b3_md5_many(items: list[tuple["Md5", bytes]]) -> list[bytes]:
    """Batched fused op: advance each accumulator (8-way across items)
    AND return each item's blake3 content hash."""
    if not items:
        return []
    n, ps, lens, sts, keep = _md5_batch_args(items)
    out = ctypes.create_string_buffer(32 * n)
    _lib.gt_b3_md5_many(n, ps, lens, sts, out)
    del keep
    return [out.raw[32 * i:32 * (i + 1)] for i in range(n)]


def _make_crc_table(poly: int, width: int) -> list:
    mask = (1 << width) - 1
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc & mask)
    return table


_CRC32C_TABLE = _make_crc_table(0x82F63B78, 32)
_CRC64NVME_TABLE = _make_crc_table(0x9A6C9329AC4BC9B5, 64)


def crc32c_py(data: bytes, crc: int = 0) -> int:
    """Pure-Python fallback (slow; last resort when no toolchain)."""
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc64nvme_py(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFFFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC64NVME_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFFFFFFFFFF


def crc32c(data, crc: int = 0) -> int:
    """Accepts bytes OR any buffer (memoryview over a shard payload —
    the validate path checksums without copying)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if isinstance(data, (bytes, bytearray)):
        return lib.crc32c_update(crc, data, len(data))
    a = np.frombuffer(data, dtype=np.uint8)
    return lib.crc32c_update(crc, a.ctypes.data if len(a) else None,
                             len(a))


def crc64nvme(data, crc: int = 0) -> int:
    """Accepts bytes OR any buffer (same contract as crc32c)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if isinstance(data, (bytes, bytearray)):
        return lib.crc64nvme_update(crc, data, len(data))
    a = np.frombuffer(data, dtype=np.uint8)
    return lib.crc64nvme_update(crc, a.ctypes.data if len(a) else None,
                                len(a))


SHARD_HDR_LEN = 16  # [magic 4][block_len u64 BE][crc32c u32 BE]


def rs_encode_packed(block: bytes, k: int, m: int, pmat: np.ndarray,
                     prefix: bytes = b"") -> list[memoryview]:
    """One GIL-released call: split the logical stream prefix||block into
    k shards, compute m parity shards (pmat = (m, k) GF(2^8) parity
    matrix), and return the k+m ready-to-send shard payloads in the
    block store's shard file format (crc32c flavor) as zero-copy views
    over one buffer. `prefix` carries the tiny DataBlock header so the
    caller never concatenates it onto the megabyte payload."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native library unavailable")
    cblock = _as_cdata(block)
    total = len(prefix) + len(cblock)
    shard_len = (total + k - 1) // k
    stride = SHARD_HDR_LEN + shard_len
    pmat = np.ascontiguousarray(pmat, dtype=np.uint8)
    out = np.empty((k + m) * stride, dtype=np.uint8)
    lib.rs_encode_block_packed(prefix, len(prefix), cblock, len(cblock),
                               k, m, pmat.ctypes.data, shard_len,
                               out.ctypes.data)
    view = memoryview(out.data).cast("B")
    return [view[i * stride:(i + 1) * stride] for i in range(k + m)]


def gf_matmul(mat: np.ndarray, x: np.ndarray) -> np.ndarray:
    """(r, s) @ (s, n) over GF(2^8) -> (r, n); native table kernel."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native library unavailable")
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    x = np.ascontiguousarray(x, dtype=np.uint8)
    r, s = mat.shape
    s2, n = x.shape
    if s != s2:
        raise ValueError(f"shape mismatch {mat.shape} @ {x.shape}")
    out = np.empty((r, n), dtype=np.uint8)
    lib.gf256_matmul(mat.ctypes.data, r, s, x.ctypes.data, n, out.ctypes.data)
    return out
