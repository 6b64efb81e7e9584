"""The plain reference the benchmark holds the port against: NumPy and
the standard library only, written from the published specifications,
sharing no code and no tables with the program.

- BLAKE3-256 (the block content hash; the BLAKE3 specification, 2020),
  vectorised over the 1 KiB chunks of many messages at once.
- CRC-32C (Castagnoli, reflected polynomial 0x82F63B78; RFC 3720 B.4),
  the checksum of the shard files, vectorised over many equal-length
  messages by its linearity.
- Reed-Solomon RS(k, m) over GF(2^8) with the primitive polynomial 0x11D
  and the systematic generator [I_k ; C], C[i][j] = 1 / (x_i + y_j) with
  x_i = i and y_j = m + j: the code the port stores erasure shards in.
- The ETag of a multipart upload (S3's rule): the MD5 of the parts'
  binary MD5s in part order, a dash, and the number of parts.
- The block and shard file formats the port writes: a block is packed as
  one scheme byte (0: stored plain) and the payload; an erasure shard
  file is 4 magic bytes ("GTS2": CRC-32C, "GTS3": zlib CRC-32), the
  packed length (8 bytes, big-endian), the checksum of the payload (4
  bytes, big-endian) and the payload, shard i of the zero-padded stripe
  of the packed block split in k rows; a replicated block is stored as
  its payload alone, under the hash's hex name.
"""

from __future__ import annotations

import hashlib
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# BLAKE3
# ---------------------------------------------------------------------------

_IV = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
               dtype=np.uint32)
_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
CHUNK_LEN, BLOCK_LEN = 1024, 64


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _compress(cv: list, m: list, counter: np.ndarray, block_len: np.ndarray,
              flags: np.ndarray) -> list:
    """The compression function on lanes: cv 8 arrays, m 16 arrays
    (uint32, one element a lane) -> the 8 chaining-value words."""
    n = counter.shape[0]
    s = list(cv) + [np.full(n, _IV[i], dtype=np.uint32) for i in range(4)] + [
        counter.astype(np.uint32),
        (counter >> np.uint64(32)).astype(np.uint32),
        block_len.astype(np.uint32), flags.astype(np.uint32)]
    m = list(m)

    def g(a, b, c, d, x, y):
        s[a] = s[a] + s[b] + x
        s[d] = _rotr(s[d] ^ s[a], 16)
        s[c] = s[c] + s[d]
        s[b] = _rotr(s[b] ^ s[c], 12)
        s[a] = s[a] + s[b] + y
        s[d] = _rotr(s[d] ^ s[a], 8)
        s[c] = s[c] + s[d]
        s[b] = _rotr(s[b] ^ s[c], 7)

    for r in range(7):
        g(0, 4, 8, 12, m[0], m[1])
        g(1, 5, 9, 13, m[2], m[3])
        g(2, 6, 10, 14, m[4], m[5])
        g(3, 7, 11, 15, m[6], m[7])
        g(0, 5, 10, 15, m[8], m[9])
        g(1, 6, 11, 12, m[10], m[11])
        g(2, 7, 8, 13, m[12], m[13])
        g(3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[i] for i in _PERM]
    return [s[i] ^ s[i + 8] for i in range(8)]


def blake3_many(messages: list) -> list[bytes]:
    """BLAKE3-256 of each message (bytes-like), computed together: every
    chunk of every message is a lane of one vectorised compression per
    block position, then the tree is reduced level by level."""
    if not messages:
        return []
    lens = [len(x) for x in messages]
    nchunks = [max(1, -(-n // CHUNK_LEN)) for n in lens]
    total = sum(nchunks)
    words = np.zeros((total, CHUNK_LEN // 4), dtype=np.uint32)
    clen = np.zeros(total, dtype=np.int64)
    counter = np.zeros(total, dtype=np.uint64)
    single = np.zeros(total, dtype=bool)
    row = 0
    for x, n, c in zip(messages, lens, nchunks):
        buf = np.zeros(c * CHUNK_LEN, dtype=np.uint8)
        buf[:n] = np.frombuffer(memoryview(x).cast("B"), dtype=np.uint8)
        words[row:row + c] = buf.view("<u4").reshape(c, CHUNK_LEN // 4)
        clen[row:row + c] = np.minimum(
            CHUNK_LEN, n - CHUNK_LEN * np.arange(c)).clip(0)
        counter[row:row + c] = np.arange(c, dtype=np.uint64)
        single[row:row + c] = c == 1
        row += c
    nblocks = np.maximum(1, -(-clen // BLOCK_LEN))
    cv = [np.full(total, _IV[i], dtype=np.uint32) for i in range(8)]
    for b in range(CHUNK_LEN // BLOCK_LEN):
        live = nblocks > b
        if not live.any():
            break
        last = nblocks == b + 1
        flags = (np.where(b == 0, CHUNK_START, 0)
                 + np.where(last, CHUNK_END, 0)
                 + np.where(last & single, ROOT, 0))
        blen = np.where(last, clen - BLOCK_LEN * b, BLOCK_LEN)
        m = [words[:, b * 16 + i] for i in range(16)]
        out = _compress(cv, m, counter, blen, flags)
        cv = [np.where(live, o, c) for o, c in zip(out, cv)]
    cvs = np.stack(cv, axis=1)  # (total, 8)
    # the tree: pairs of adjacent nodes at each level, an odd last node
    # carried up unchanged (the left-complete tree of the specification)
    levels, row = [], 0
    for c in nchunks:
        levels.append(cvs[row:row + c])
        row += c
    while True:
        pairs = [(i, len(lv) // 2) for i, lv in enumerate(levels)
                 if len(lv) > 1]
        if not pairs:
            break
        left = np.concatenate([levels[i][0:2 * p:2] for i, p in pairs])
        right = np.concatenate([levels[i][1:2 * p:2] for i, p in pairs])
        root = np.concatenate([np.full(p, len(levels[i]) == 2)
                               for i, p in pairs])
        n = left.shape[0]
        m = [left[:, i] for i in range(8)] + [right[:, i] for i in range(8)]
        iv = [np.full(n, _IV[i], dtype=np.uint32) for i in range(8)]
        out = np.stack(_compress(iv, m, np.zeros(n, dtype=np.uint64),
                                 np.full(n, BLOCK_LEN),
                                 PARENT + np.where(root, ROOT, 0)), axis=1)
        at = 0
        for i, p in pairs:
            lv = levels[i]
            nxt = out[at:at + p]
            at += p
            levels[i] = (np.concatenate([nxt, lv[-1:]]) if len(lv) % 2
                         else nxt)
    return [lv[0].astype("<u4").tobytes() for lv in levels]


def blake3(data) -> bytes:
    return blake3_many([data])[0]


# ---------------------------------------------------------------------------
# CRC-32C
# ---------------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78


def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> np.uint32(1)) ^ np.uint32(_CRC32C_POLY),
                     t >> np.uint32(1)).astype(np.uint32)
    return t


_T0 = _crc_table()


class Crc32c:
    """CRC-32C of many messages of one length at once. The register
    after a message is S^n(init) xor the xor over i of S^(n-1-i)(T[b_i]),
    S the step for a zero byte (linear over GF(2)): the per-distance
    tables U[d] = S^d(T) turn a message into one gather and one xor
    reduction, without a loop over its bytes."""

    def __init__(self):
        self._u = _T0[None, :].copy()

    def _tables(self, n: int) -> np.ndarray:
        have = self._u.shape[0]
        if have < n:
            more = np.empty((n - have, 256), dtype=np.uint32)
            cur = self._u[-1]
            for d in range(n - have):
                cur = _T0[cur & np.uint32(0xFF)] ^ (cur >> np.uint32(8))
                more[d] = cur
            self._u = np.concatenate([self._u, more])
        return self._u

    @staticmethod
    def _shift_init(n: int) -> int:
        reg = 0xFFFFFFFF
        t = _T0.tolist()
        for _ in range(n):
            reg = t[reg & 0xFF] ^ (reg >> 8)
        return reg

    def many(self, rows: np.ndarray, batch: int = 32) -> np.ndarray:
        """rows (N, n) uint8 -> (N,) uint32 CRC-32C of each row."""
        nrows, n = rows.shape
        if n == 0:
            return np.zeros(nrows, dtype=np.uint32)
        u = self._tables(n)[n - 1::-1]  # u[i] = U[n-1-i]
        cols = np.arange(n)
        out = np.empty(nrows, dtype=np.uint32)
        for s in range(0, nrows, batch):
            part = rows[s:s + batch]
            out[s:s + batch] = np.bitwise_xor.reduce(
                u[cols[None, :], part], axis=1)
        return out ^ np.uint32(self._shift_init(n) ^ 0xFFFFFFFF)


def crc32c(data) -> int:
    row = np.frombuffer(bytes(data), dtype=np.uint8)[None, :]
    return int(Crc32c().many(row)[0])


# ---------------------------------------------------------------------------
# GF(2^8) and RS(k, m)
# ---------------------------------------------------------------------------

GF_POLY = 0x11D


def _gf_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:] = exp[:255]
    return exp, log


GF_EXP, GF_LOG = _gf_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(GF_EXP[255 - GF_LOG[a]])


# MUL[c] is the 256-entry table of products by c
MUL = np.array([[gf_mul(c, b) for b in range(256)] for c in range(256)],
               dtype=np.uint8)


def generator(k: int, m: int) -> np.ndarray:
    """(k + m, k) systematic generator: I_k over the Cauchy rows."""
    g = np.zeros((k + m, k), dtype=np.uint8)
    g[:k] = np.eye(k, dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            g[k + i, j] = gf_inv(i ^ (m + j))
    return g


def gf_matmul(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """(r, s) coefficients times (s, n) bytes over GF(2^8) -> (r, n)."""
    out = np.zeros((a.shape[0], x.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(a.shape[1]):
            c = int(a[i, j])
            if c:
                out[i] ^= MUL[c][x[j]]
    return out


def gf_solve(a: np.ndarray) -> np.ndarray:
    """Inverse of a square matrix over GF(2^8) (Gauss-Jordan); raises
    if it is singular."""
    n = a.shape[0]
    aug = np.concatenate([a.astype(np.uint8), np.eye(n, dtype=np.uint8)],
                         axis=1)
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r, col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        aug[[col, piv]] = aug[[piv, col]]
        aug[col] = MUL[gf_inv(int(aug[col, col]))][aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= MUL[int(aug[r, col])][aug[col]]
    return aug[:, n:]


def shard_len(packed_len: int, k: int) -> int:
    return -(-packed_len // k)


def stripe(packed: bytes, k: int) -> np.ndarray:
    """The packed block as k zero-padded rows."""
    s = shard_len(len(packed), k)
    buf = np.zeros(k * s, dtype=np.uint8)
    buf[:len(packed)] = np.frombuffer(packed, dtype=np.uint8)
    return buf.reshape(k, s)


def rs_encode(packed: bytes, k: int, m: int) -> np.ndarray:
    """-> (k + m, shard length): the k data rows, then the m parity
    rows."""
    data = stripe(packed, k)
    g = generator(k, m)
    return np.concatenate([data, gf_matmul(g[k:], data)])


# ---------------------------------------------------------------------------
# Block and shard files
# ---------------------------------------------------------------------------

SCHEME_PLAIN = 0
MAGIC_CRC32C = b"GTS2"
MAGIC_CRC32 = b"GTS3"
SHARD_HEADER = 16


def packed_block(block: bytes) -> bytes:
    """A block as the port packs it when it stays plain (incompressible
    bodies do): the scheme byte, then the payload."""
    return bytes([SCHEME_PLAIN]) + block


def block_dir(data_dir: str, hash32: bytes) -> str:
    import os

    return os.path.join(data_dir, hash32[:1].hex(), hash32[1:2].hex())


def parse_shard(raw: bytes) -> tuple[str, int, int, bytes]:
    """-> (checksum kind, packed length, stored checksum, payload);
    raises ValueError on a file that is not a shard image."""
    if len(raw) < SHARD_HEADER:
        raise ValueError("shard file shorter than its header")
    magic = raw[:4]
    kind = {MAGIC_CRC32C: "crc32c", MAGIC_CRC32: "crc32"}.get(magic)
    if kind is None:
        raise ValueError(f"unknown shard magic {magic!r}")
    return (kind, int.from_bytes(raw[4:12], "big"),
            int.from_bytes(raw[12:16], "big"), raw[SHARD_HEADER:])


def crc32(data) -> int:
    return zlib.crc32(data)


# ---------------------------------------------------------------------------
# S3 ETags
# ---------------------------------------------------------------------------

def multipart_etag(part_md5s: list[bytes]) -> str:
    """The ETag of a completed multipart upload from its parts' binary
    MD5s, in part order."""
    return f"{hashlib.md5(b''.join(part_md5s)).hexdigest()}-{len(part_md5s)}"
