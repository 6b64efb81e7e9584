"""BLAKE3 tree hashing: pure-Python reference, plain torch batch, and
the wrapper of kernel B3 (hand-written CUDA, csrc/blake3.cu).

B3 replaces the JAX package's ops/treehash.py:hash_rows (with
_compress_lanes and the jitted hash_fn), the program that hashes every
block on PUT and on scrub. It is bound by the integer ALU: a 1 MiB row
is ~17.4 k compressions of ~680 32-bit instructions each; at small
batches by the dependent chain of 16 + ceil(log2 C) compressions.

`hash_rows(msgs, lengths)` takes (B, C*1024) zero-padded uint8 rows and
(B,) int32 lengths and returns (B, 32) uint8 digests: the kernel on a
CUDA tensor (one launch: a CTA per block of 32-128 chunks of a row, the
block's subtree merged in shared memory, the block roots by the row's
last CTA), the plain torch version
(`hash_rows_plain`) on a CPU tensor. `chain_cycles` times the dependent
chain that bounds a row on the card. Precondition, as in the JAX package: every row's length spans
exactly C chunks (pad rows are full-length zero messages). Torch on the
CPU has no shifts or adds on uint32 and int32 shifts are arithmetic, so
the plain version works in int64 masked to 32 bits.

`blake3_many(blobs, device)` is the synchronous batched entry point (the
JAX package's of the same name): one `hash_rows` launch per chunk-count
group on `device`.

The pure-Python implementation (blake3_py, copied from the JAX package)
is the test oracle and the host fallback for small inputs.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

CHUNK_LEN = 1024
BLOCK_LEN = 64
BLOCKS_PER_CHUNK = CHUNK_LEN // BLOCK_LEN  # 16


@functools.lru_cache(maxsize=None)
def _schedules() -> tuple[tuple[int, ...], ...]:
    """Message-word index schedule per round (permutation pre-applied)."""
    idx = list(range(16))
    out = [tuple(idx)]
    for _ in range(6):
        idx = [idx[p] for p in MSG_PERMUTATION]
        out.append(tuple(idx))
    return tuple(out)


# ---------------------------------------------------------------------------
# Pure-Python reference
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(v, a, b, c, d, mx, my):
    v[a] = (v[a] + v[b] + mx) & _M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & _M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def compress_py(h, m, counter: int, block_len: int, flags: int) -> list[int]:
    """One blake3 compression; returns the 8-word chaining value."""
    v = list(h) + list(IV[:4]) + [
        counter & _M32, (counter >> 32) & _M32, block_len, flags,
    ]
    for sched in _schedules():
        _g(v, 0, 4, 8, 12, m[sched[0]], m[sched[1]])
        _g(v, 1, 5, 9, 13, m[sched[2]], m[sched[3]])
        _g(v, 2, 6, 10, 14, m[sched[4]], m[sched[5]])
        _g(v, 3, 7, 11, 15, m[sched[6]], m[sched[7]])
        _g(v, 0, 5, 10, 15, m[sched[8]], m[sched[9]])
        _g(v, 1, 6, 11, 12, m[sched[10]], m[sched[11]])
        _g(v, 2, 7, 8, 13, m[sched[12]], m[sched[13]])
        _g(v, 3, 4, 9, 14, m[sched[14]], m[sched[15]])
    return [v[i] ^ v[i + 8] for i in range(8)]


def _words(block: bytes) -> list[int]:
    block = block.ljust(BLOCK_LEN, b"\x00")
    return [int.from_bytes(block[4 * i : 4 * i + 4], "little") for i in range(16)]


def _chunk_cv_py(chunk: bytes, counter: int, root: bool) -> list[int]:
    n_blocks = max(1, (len(chunk) + BLOCK_LEN - 1) // BLOCK_LEN)
    cv = list(IV)
    for b in range(n_blocks):
        piece = chunk[b * BLOCK_LEN : (b + 1) * BLOCK_LEN]
        flags = (CHUNK_START if b == 0 else 0) | (
            (CHUNK_END | (ROOT if root else 0)) if b == n_blocks - 1 else 0
        )
        cv = compress_py(cv, _words(piece), counter, len(piece), flags)
    return cv


def _parent_cv_py(left, right, root: bool) -> list[int]:
    m = list(left) + list(right)
    return compress_py(list(IV), m, 0, BLOCK_LEN, PARENT | (ROOT if root else 0))


def blake3_py(data: bytes) -> bytes:
    """Reference blake3 (default 32-byte digest)."""
    chunks = [data[i : i + CHUNK_LEN] for i in range(0, len(data), CHUNK_LEN)] or [b""]
    if len(chunks) == 1:
        cv = _chunk_cv_py(chunks[0], 0, root=True)
        return b"".join(w.to_bytes(4, "little") for w in cv)
    cvs = [_chunk_cv_py(c, i, root=False) for i, c in enumerate(chunks)]
    # Pairwise merge with odd tail carried — reproduces the spec tree
    # (left subtree = largest power of two < n) level by level.
    while len(cvs) > 2:
        nxt = [_parent_cv_py(cvs[i], cvs[i + 1], False) for i in range(0, len(cvs) - 1, 2)]
        if len(cvs) % 2:
            nxt.append(cvs[-1])
        cvs = nxt
    root = _parent_cv_py(cvs[0], cvs[1], root=True)
    return b"".join(w.to_bytes(4, "little") for w in root)


# ---------------------------------------------------------------------------
# Plain torch batch (int64 lanes) — B3's reference formulation
# ---------------------------------------------------------------------------
#
# Every independent hash unit (chunk of a row, then parent node of a
# tree level) is a lane — the trailing axis of every tensor: state is
# (8, L), messages (16, L), as in the JAX package's lane-major layout.


@functools.lru_cache(maxsize=1)
def _g_index() -> tuple[tuple[list[int], list[int]], ...]:
    """Per round, the message words of the column step's four G and of
    the diagonal step's four G: ((x, y) columns, (x, y) diagonals)."""
    return tuple(((list(s[0:8:2]), list(s[1:8:2])),
                  (list(s[8:16:2]), list(s[9:16:2])))
                 for s in _schedules())


def _compress_lanes(h, m, counter, block_len, flags):
    """h (8, L), m (16, L), counter/block_len/flags (L,) int64 -> (8, L).

    The state is four rows of four words, (4, 4, L): a column step is
    one G on rows a, b, c, d; a diagonal step is the same G after rows
    b, c, d turn left by 1, 2 and 3 words (and turn back after it), so
    each step is one set of tensor operations for all four G."""
    lanes = h.shape[1]
    v = torch.cat([h, torch.tensor(IV[:4], dtype=torch.int64,
                                   device=h.device)[:, None].expand(4, lanes),
                   torch.stack([counter.expand(lanes),
                                torch.zeros_like(h[0]),
                                block_len.expand(lanes),
                                flags.expand(lanes)])]).reshape(4, 4, lanes)
    a, b, c, d = v.unbind(0)

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & _M32

    def g(a, b, c, d, mx, my):
        a = (a + b + mx) & _M32
        d = rotr(d ^ a, 16)
        c = (c + d) & _M32
        b = rotr(b ^ c, 12)
        a = (a + b + my) & _M32
        d = rotr(d ^ a, 8)
        c = (c + d) & _M32
        b = rotr(b ^ c, 7)
        return a, b, c, d

    for (cx, cy), (dx, dy) in _g_index():
        a, b, c, d = g(a, b, c, d, m[cx], m[cy])
        b, c, d = (b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0))
        a, b, c, d = g(a, b, c, d, m[dx], m[dy])
        b, c, d = (b.roll(1, 0), c.roll(2, 0), d.roll(3, 0))
    return torch.cat([a ^ c, b ^ d])


def _iv_lanes(n: int, device) -> torch.Tensor:
    return torch.tensor(IV, dtype=torch.int64, device=device)[:, None] \
        .expand(8, n)


def hash_rows_plain(msgs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain torch B3: (B, C*1024) u8 + (B,) i32 -> (B, 32) u8 digests."""
    b, padded = msgs.shape
    c = padded // CHUNK_LEN
    dev = msgs.device
    lengths = lengths.to(torch.int64)
    live = torch.arange(padded, device=dev)[None, :] < lengths[:, None]
    w = (msgs * live).to(torch.int64).reshape(b, c, BLOCKS_PER_CHUNK, 16, 4)
    words = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    # (B, C, block, word) -> (block, word, B*C): lane = row-major chunk
    words = words.permute(2, 3, 0, 1).reshape(BLOCKS_PER_CHUNK, 16, b * c)
    counters = torch.arange(c, device=dev).repeat(b)  # (B*C,)
    chunk_lens = (lengths[:, None] - torch.arange(c, device=dev)[None, :]
                  * CHUNK_LEN).clamp(0, CHUNK_LEN).reshape(b * c)
    n_blocks = ((chunk_lens + BLOCK_LEN - 1) // BLOCK_LEN).clamp(min=1)
    cv = _iv_lanes(b * c, dev)
    # positions past every chunk's last block change nothing
    for pos in range(int(n_blocks.max())):
        blen = (chunk_lens - pos * BLOCK_LEN).clamp(0, BLOCK_LEN)
        is_end = n_blocks - 1 == pos
        flags = (CHUNK_START if pos == 0 else 0) + is_end.to(torch.int64) * (
            CHUNK_END | (ROOT if c == 1 else 0))
        new = _compress_lanes(cv, words[pos], counters, blen, flags)
        cv = torch.where(pos < n_blocks, new, cv)
    level = cv.reshape(8, b, c)
    while level.shape[2] > 1:
        n = level.shape[2]
        pairs = n // 2
        root = n == 2
        m = torch.cat([level[:, :, 0:2 * pairs:2], level[:, :, 1:2 * pairs:2]])
        one = torch.ones(b * pairs, dtype=torch.int64, device=dev)
        out = _compress_lanes(_iv_lanes(b * pairs, dev),
                              m.reshape(16, b * pairs), 0 * one,
                              BLOCK_LEN * one,
                              (PARENT | (ROOT if root else 0)) * one)
        out = out.reshape(8, b, pairs)
        level = torch.cat([out, level[:, :, n - 1:]], dim=2) if n % 2 else out
    words = level[:, :, 0].T  # (B, 8)
    shifts = torch.tensor([0, 8, 16, 24], device=dev)
    return ((words[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(b, 32)


# ---------------------------------------------------------------------------
# Kernel B3 wrapper
# ---------------------------------------------------------------------------

launches = {"blake3_rows": 0}
# launches by batch (rows per call), and the geometry of the latest one
batch_sizes: dict[int, int] = {}
last_plan: dict = {}

CHAIN_STEPS = 4096

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gt_blake3_rows": [_P, ctypes.c_longlong, _P, _I, _I, _P, _P, _P, _I, _I,
                       _P],
    "gt_b3_plan": [_I, _I, _P],
    "gt_blake3_chain_cycles": [_P, _I, _P],
}
# (device, stream) -> the rows' ticket counters: zero between launches
# (each row's last warp sets its counter back), so one buffer serves
# every launch on its stream; streams run concurrently, so each has its own
_tickets: dict[tuple, torch.Tensor] = {}
_tickets_lock = threading.Lock()


@functools.lru_cache(maxsize=1024)
def b3_plan(b: int, c: int,
            device: torch.device) -> tuple[int, int, int, int]:
    """B3's (warps per CTA, CTAs, blocks per row, small) for b rows of c
    chunks on `device`, from the library's planner (gt_b3_plan): a CTA
    hashes a block of 32 chunks per warp of one row; `small` (a warp per
    scheduler at most) picks the latency-bound instance."""
    plan = (ctypes.c_int * 4)()
    lib = _build.load("blake3", _SIGNATURES)
    with torch.cuda.device(device):
        _build.check(lib.gt_b3_plan(b, c, plan), "b3_plan")
    return tuple(plan)


def _tickets_for(b: int, device: torch.device, stream) -> torch.Tensor:
    key = (device, stream.cuda_stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None or t.numel() < b:
            # lint: ignore[GL15] the stream's ticket counters, grown only and reused by every launch on it: B3 reads the first b, so their size is no launch shape
            t = torch.zeros(max(b, 256), dtype=torch.int32, device=device)
            _tickets[key] = t
        return t


def hash_rows(msgs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Batched BLAKE3-256: (B, C*1024) u8 rows + (B,) i32 lengths ->
    (B, 32) u8 digests; one B3 launch (chunks and tree fused) on a CUDA
    tensor."""
    if msgs.dtype != torch.uint8 or msgs.dim() != 2 \
            or msgs.shape[1] % CHUNK_LEN or msgs.shape[1] == 0:
        raise ValueError(f"rows must be (B, C*{CHUNK_LEN}) uint8, got "
                         f"{tuple(msgs.shape)} {msgs.dtype}")
    if lengths.shape != (msgs.shape[0],) or lengths.device != msgs.device:
        raise ValueError("one length per row, on the rows' device")
    if msgs.device.type == "cpu":
        return hash_rows_plain(msgs, lengths)
    if msgs.device.type != "cuda":
        raise ValueError(f"unsupported device {msgs.device}")
    b, padded = msgs.shape
    c = padded // CHUNK_LEN
    msgs = msgs.contiguous()
    if msgs.data_ptr() % 16:
        raise ValueError("rows must start 16-byte aligned (vector loads)")
    lengths = lengths.to(torch.int32).contiguous()
    dev = msgs.device
    out = torch.empty((b, 8), dtype=torch.int32, device=dev)
    if b == 0:
        return out.view(torch.uint8)
    wpc, ctas, blocks, small = b3_plan(b, c, dev)
    stream = torch.cuda.current_stream(dev)
    roots = torch.empty(b * blocks * 8 if blocks > 1 else 8,
                        dtype=torch.int32, device=dev)
    tickets = _tickets_for(b, dev, stream)
    lib = _build.load("blake3", _SIGNATURES)
    err = lib.gt_blake3_rows(
        msgs.data_ptr(), padded, lengths.data_ptr(), b, c, roots.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), wpc, small, stream.cuda_stream)
    _build.check(err, "blake3_rows")
    launches["blake3_rows"] += 1
    batch_sizes[b] = batch_sizes.get(b, 0) + 1
    last_plan.update(b=b, c=c, warps_per_cta=wpc, ctas=ctas, blocks=blocks,
                     small=bool(small))
    return out.view(torch.uint8)  # little-endian words = digest bytes


def chain_cycles(device: torch.device) -> float:
    """SM clock cycles of one G step of B3's dependent chain (add -> xor ->
    rotate, four times, through one column, in the forms of the small-
    batch instance), timed on the card by one thread with clock64 over
    CHAIN_STEPS steps. A compression is 14 such steps in series. Not a
    kernel of the path: it feeds B3's bound, and counts no launch."""
    out = torch.zeros(2, dtype=torch.int64, device=device)
    lib = _build.load("blake3", _SIGNATURES)
    _build.check(lib.gt_blake3_chain_cycles(
        out.data_ptr(), CHAIN_STEPS,
        torch.cuda.current_stream(device).cuda_stream), "blake3_chain_cycles")
    return int(out[0].item()) / CHAIN_STEPS


def n_chunks_for(length: int) -> int:
    return max(1, (length + CHUNK_LEN - 1) // CHUNK_LEN)


def blake3_many(blobs: list, device="cuda") -> list[bytes]:
    """BLAKE3-256 of many byte strings: same-chunk-count groups hashed by
    one `hash_rows` call each on `device`, their rows padded up the
    feeder's bucket ladder (pad rows are full-length zero messages)."""
    from .. import resolve_device
    from ..block.device_backend import bucket_items

    dev = resolve_device(device)
    out: list = [None] * len(blobs)
    groups: dict[int, list[int]] = {}
    for i, blob in enumerate(blobs):
        groups.setdefault(n_chunks_for(len(blob)), []).append(i)
    for c, idxs in groups.items():
        b = bucket_items(len(idxs))
        buf = np.zeros((b, c * CHUNK_LEN), dtype=np.uint8)
        lengths = np.full(b, c * CHUNK_LEN, dtype=np.int32)
        for row, i in enumerate(idxs):
            arr = np.frombuffer(blobs[i], dtype=np.uint8)
            buf[row, :arr.size] = arr
            lengths[row] = arr.size
        digests = hash_rows(torch.from_numpy(buf).to(dev),
                            torch.from_numpy(lengths).to(dev)).cpu().numpy()
        for row, i in enumerate(idxs):
            out[i] = digests[row].tobytes()
    return out
