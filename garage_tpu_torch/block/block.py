"""Copy of garage_tpu/block/block.py: import paths rewritten, issue and PR tags dropped.

DataBlock: the on-wire/on-disk representation of one block or shard.

Ref parity: src/block/block.rs:12-106. A block travels either plain or
compressed; the content hash always refers to the PLAIN bytes, and a
compressed block is checked by decompressing and hashing. Default
scheme is zstd level 1 like the reference (util/config.rs:280); zlib
blocks written by earlier builds still decode — the header byte records
the scheme so formats coexist on disk and on the wire.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

try:
    import zstandard
    _ZstdError = zstandard.ZstdError
except ModuleNotFoundError:  # bare image: fall back to the zlib scheme
    zstandard = None

    class _ZstdError(Exception):
        """Placeholder so except-tuples stay valid; never raised."""

from ..utils.data import content_hash_matches
from ..utils.error import CorruptData

COMPRESSION_NONE = 0
COMPRESSION_ZLIB = 1
COMPRESSION_ZSTD = 2

COMPRESSION_LEVEL = 1  # ref: util/config.rs:280 (zstd level 1 default)

# scheme -> block-file suffix; every reader probes all of these
SUFFIX_OF = {COMPRESSION_NONE: "", COMPRESSION_ZLIB: ".zlib",
             COMPRESSION_ZSTD: ".zst"}
COMP_OF_SUFFIX = {v: k for k, v in SUFFIX_OF.items()}
BLOCK_SUFFIXES = list(SUFFIX_OF.values())


class MissingCodec(RuntimeError):
    """A stored block uses a compression scheme whose codec wheel is
    not installed here. The data is NOT corrupt — readers must fail the
    read without quarantining the file."""


def comp_of_path(p: str) -> int:
    """Compression scheme from a block-file path's suffix."""
    for sfx, comp in COMP_OF_SUFFIX.items():
        if sfx and p.endswith(sfx):
            return comp
    return COMPRESSION_NONE


@dataclass
class DataBlock:
    compression: int
    bytes: bytes

    @classmethod
    def plain(cls, data: bytes) -> "DataBlock":
        return cls(COMPRESSION_NONE, data)

    # compressing a 64 KiB sample costs ~3 ms and reliably detects
    # already-compressed/encrypted payloads, for which a full-block
    # zlib pass would burn ~45 ms per 1 MiB for nothing
    _SAMPLE = 64 * 1024
    _SAMPLE_RATIO = 0.97

    @classmethod
    def compress(cls, data: bytes, level: int = COMPRESSION_LEVEL) -> "DataBlock":
        """Compress (zstd, ref default scheme) if it helps; otherwise
        keep plain (ref: block.rs:85-99 from_buffer). Incompressible
        payloads are detected from a leading sample before paying for
        the full pass. Without the zstandard wheel the zlib scheme is
        written instead — every reader probes all schemes, so mixed
        stores interoperate."""
        if zstandard is None:
            if len(data) > 2 * cls._SAMPLE:
                probe = zlib.compress(data[: cls._SAMPLE], level)
                if len(probe) > cls._SAMPLE * cls._SAMPLE_RATIO:
                    return cls(COMPRESSION_NONE, data)
            c = zlib.compress(data, level)
            if len(c) < len(data):
                return cls(COMPRESSION_ZLIB, c)
            return cls(COMPRESSION_NONE, data)
        cctx = zstandard.ZstdCompressor(level=level)
        if len(data) > 2 * cls._SAMPLE:
            probe = cctx.compress(data[: cls._SAMPLE])
            if len(probe) > cls._SAMPLE * cls._SAMPLE_RATIO:
                return cls(COMPRESSION_NONE, data)
        c = cctx.compress(data)
        if len(c) < len(data):
            return cls(COMPRESSION_ZSTD, c)
        return cls(COMPRESSION_NONE, data)

    def plain_bytes(self) -> bytes:
        if self.compression == COMPRESSION_NONE:
            return self.bytes
        if self.compression == COMPRESSION_ZSTD:
            if zstandard is None:
                raise MissingCodec(
                    "zstd-compressed block but the zstandard wheel is "
                    "not installed")
            # a fresh decompressor per call: ZstdDecompressor instances
            # are not safe for concurrent use, and GET (to_thread) can
            # race a ScrubWorker read on another worker thread
            return zstandard.ZstdDecompressor().decompress(self.bytes)
        return zlib.decompress(self.bytes)

    def verify(self, hash32: bytes) -> None:
        """ref: block.rs:69-83 (plain: content-hash check; compressed:
        integrity of the decompression stream + content hash of the
        result). Content hash is BLAKE3 by default (utils/data.py),
        blake2 accepted for stores migrated from the legacy algo."""
        try:
            plain = self.plain_bytes()
        except (zlib.error, _ZstdError) as e:
            raise CorruptData(hash32) from e
        if not content_hash_matches(plain, hash32):
            raise CorruptData(hash32)

    # wire format: 1 header byte + payload
    def pack(self) -> bytes:
        return bytes([self.compression]) + self.bytes

    @classmethod
    def unpack(cls, raw: bytes) -> "DataBlock":
        return cls(raw[0], raw[1:])

    def file_suffix(self) -> str:
        return SUFFIX_OF[self.compression]
