"""The erasure shard file format (copied from the JAX package's
block/manager.py, which holds the BlockManager around it).

A shard file is magic + whole-block packed length + shard checksum +
shard bytes. Files written by either package are byte-identical for
the same shard and the same CRC flavour: the magic names the flavour
(crc32c from the native library, zlib crc32 without it, legacy
blake2), so writers and readers of any flavour interoperate."""

from __future__ import annotations

import zlib

import numpy as np

from ..utils.data import blake2sum
from ..utils.error import CorruptData

_SHARD_MAGIC_V1 = b"GTS1"  # blake2-256 checksum (legacy)
_SHARD_MAGIC_C32C = b"GTS2"  # crc32c (native slice-by-8 kernel)
_SHARD_MAGIC_C32 = b"GTS3"  # zlib crc32 (no native toolchain)


def _write_flavour():
    """(magic, crc function) for new shard files: crc32c once the native
    library is loaded; until then (loaded() never triggers a build,
    which would block the caller for seconds) zlib crc32."""
    from .. import native

    if native.loaded():
        return _SHARD_MAGIC_C32C, native.crc32c
    return _SHARD_MAGIC_C32, zlib.crc32


def pack_shard(data: bytes, packed_len: int) -> bytes:
    """Shard file image for `data`, one shard of a block whose packed
    length is `packed_len`."""
    magic, crc = _write_flavour()
    return (magic + packed_len.to_bytes(8, "big")
            + crc(data).to_bytes(4, "big") + data)


def pack_shards(parts: list[np.ndarray], packed_len: int) -> list[memoryview]:
    """pack_shard for every row of `parts` (2-D uint8 arrays of equal
    width, stacked in order), framed in ONE buffer: the shard file
    images come back as memoryviews over it, byte-identical to
    [pack_shard(bytes(row), packed_len) ...], with one copy of the
    payload instead of three."""
    sl = parts[0].shape[1]
    n = sum(p.shape[0] for p in parts)
    out = np.empty((n, 16 + sl), dtype=np.uint8)
    row = 0
    for p in parts:
        out[row:row + p.shape[0], 16:] = p
        row += p.shape[0]
    magic, crc = _write_flavour()
    out[:, :12] = np.frombuffer(magic + packed_len.to_bytes(8, "big"),
                                dtype=np.uint8)
    for i in range(n):
        out[i, 12:16] = np.frombuffer(crc(out[i, 16:]).to_bytes(4, "big"),
                                      dtype=np.uint8)
    view = memoryview(out.reshape(-1))
    stride = 16 + sl
    return [view[i * stride:(i + 1) * stride] for i in range(n)]


def validate_shard(raw) -> int:
    """Checksum-verify a shard file image without copying its payload;
    -> whole-block packed length. Raises CorruptData. Reads every
    format (crc32c, zlib crc32, legacy blake2)."""
    mv = memoryview(raw)
    magic = bytes(mv[:4])
    packed_len = int.from_bytes(mv[4:12], "big")
    if magic == _SHARD_MAGIC_C32C:
        ck, data = bytes(mv[12:16]), mv[16:]
        from .. import native

        if native.loaded():
            good = native.crc32c(data).to_bytes(4, "big") == ck
        else:  # cross-node file from a native writer, no library here
            good = native.crc32c_py(data).to_bytes(4, "big") == ck
        if not good:
            raise CorruptData(b"")
    elif magic == _SHARD_MAGIC_C32:
        ck, data = bytes(mv[12:16]), mv[16:]
        if zlib.crc32(data).to_bytes(4, "big") != ck:
            raise CorruptData(b"")
    elif magic == _SHARD_MAGIC_V1:
        ck, data = bytes(mv[12:44]), mv[44:]
        if blake2sum(data) != ck:
            raise CorruptData(b"")
    else:
        raise CorruptData(b"")
    return packed_len


def unpack_shard(raw: bytes) -> tuple[bytes, int]:
    """-> (shard bytes, whole-block packed length); raises CorruptData."""
    packed_len = validate_shard(raw)
    hdr = 44 if bytes(raw[:4]) == _SHARD_MAGIC_V1 else 16
    return raw[hdr:], packed_len
