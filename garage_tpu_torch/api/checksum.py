"""Copy of garage_tpu/api/checksum.py: import paths rewritten, issue and PR tags dropped.

Checksum framework: x-amz-checksum-* values over request payloads.

Ref parity: src/api/common/signature/checksum.rs — crc32, crc32c, sha1,
sha256 (md5 is handled separately as the etag). Values travel base64 in
headers/trailers; crc32c (Castagnoli) is table-driven since the stdlib
only ships crc32.
"""

from __future__ import annotations

import base64
import hashlib
import zlib
from typing import Optional

ALGORITHMS = ("crc32", "crc32c", "sha1", "sha256", "crc64nvme")

# pure-Python table fallbacks live with the native kernels so every
# layer shares one implementation (garage_tpu/native)
from ..native import crc32c_py as _crc32c_py
from ..native import crc64nvme_py as _crc64nvme_py


def crc32c(data: bytes, crc: int = 0) -> int:
    """Native slice-by-8 when the library is already loaded (the server
    warms it off-loop at startup; checking `loaded` here never triggers
    a blocking compile on the event loop), else the Python table loop."""
    from .. import native

    if native.loaded():
        return native.crc32c(data, crc)
    return _crc32c_py(data, crc)


def crc64nvme(data: bytes, crc: int = 0) -> int:
    from .. import native

    if native.loaded():
        return native.crc64nvme(data, crc)
    return _crc64nvme_py(data, crc)


class Checksummer:
    """Incrementally computes one named checksum; result is raw bytes."""

    def __init__(self, algo: str):
        if algo not in ALGORITHMS:
            raise ValueError(f"unsupported checksum algorithm {algo!r}")
        self.algo = algo
        if algo == "crc32":
            self._crc = 0
        elif algo in ("crc32c", "crc64nvme"):
            self._crc = 0
        else:
            self._h = hashlib.new(algo)

    def update(self, data: bytes) -> None:
        if self.algo == "crc32":
            self._crc = zlib.crc32(data, self._crc)
        elif self.algo == "crc32c":
            self._crc = crc32c(data, self._crc)
        elif self.algo == "crc64nvme":
            self._crc = crc64nvme(data, self._crc)
        else:
            self._h.update(data)

    def digest(self) -> bytes:
        if self.algo == "crc32":
            return self._crc.to_bytes(4, "big")
        if self.algo == "crc32c":
            return self._crc.to_bytes(4, "big")
        if self.algo == "crc64nvme":
            return self._crc.to_bytes(8, "big")
        return self._h.digest()

    def b64(self) -> str:
        return base64.b64encode(self.digest()).decode()


def header_algorithm(header_name: str) -> Optional[str]:
    """"x-amz-checksum-crc32" -> "crc32" (None if not a checksum hdr)."""
    prefix = "x-amz-checksum-"
    name = header_name.lower()
    if name.startswith(prefix) and name[len(prefix):] in ALGORITHMS:
        return name[len(prefix):]
    return None


def request_checksum_value(headers: dict[str, str]) -> Optional[tuple[str, str]]:
    """-> (algo, base64 value) from x-amz-checksum-* headers; raises on
    multiple (ref: checksum.rs request_checksum_value)."""
    found = [(a, v) for h, v in headers.items()
             if (a := header_algorithm(h)) is not None]
    if not found:
        return None
    if len(found) > 1:
        raise ValueError("multiple x-amz-checksum-* headers")
    return found[0]


def trailer_algorithm(headers: dict[str, str]) -> Optional[str]:
    """Algorithm named by the x-amz-trailer header, if any."""
    t = headers.get("x-amz-trailer")
    if not t:
        return None
    algo = header_algorithm(t.strip())
    if algo is None:
        raise ValueError(f"unsupported x-amz-trailer {t!r}")
    return algo
