"""Copy of garage_tpu/api/s3/encryption.py: import paths rewritten, issue and PR tags dropped.

SSE-C: server-side encryption with customer-provided keys.

Ref parity: src/api/s3/encryption.rs:48-596. The client supplies an
AES-256 key per request (x-amz-server-side-encryption-customer-*); the
server encrypts each block with AES-256-GCM before it enters the block
store and forgets the key. Reads require the same key headers. Design
differences from the reference, chosen for the block-batched data
plane: each 1 MiB block is one AES-GCM message with a random 96-bit
nonce prepended (the reference uses an AES-GCM STREAM of 4 KiB
segments); the content-address hash covers the CIPHERTEXT, so scrub
and repair verify integrity without ever holding customer keys — same
property as the reference (blake2 over encrypted blocks,
encryption.rs:576-596). Compression is skipped for encrypted objects
(ciphertext doesn't compress; timing/size side channels).

Object metadata records only the algorithm marker and the key's MD5 so
GETs can verify the presented key without storing it.
"""

from __future__ import annotations

import base64
import hashlib
import os
from typing import Optional

from ..http import Request
from .xml import S3Error

ALGO_HEADER = "x-amz-server-side-encryption-customer-algorithm"
KEY_HEADER = "x-amz-server-side-encryption-customer-key"
KEY_MD5_HEADER = "x-amz-server-side-encryption-customer-key-md5"
COPY_ALGO_HEADER = ("x-amz-copy-source-server-side-encryption"
                    "-customer-algorithm")
COPY_KEY_HEADER = ("x-amz-copy-source-server-side-encryption"
                   "-customer-key")
COPY_KEY_MD5_HEADER = ("x-amz-copy-source-server-side-encryption"
                       "-customer-key-md5")

# stored in object meta headers (never the key itself)
META_SSEC_ALGO = "x-garage-ssec-algorithm"
META_SSEC_MD5 = "x-garage-ssec-key-md5"

NONCE_LEN = 12
TAG_LEN = 16
OVERHEAD = NONCE_LEN + TAG_LEN


def _aesgcm():
    """AESGCM or a clean S3 error when the wheel is absent (bare image:
    everything but SSE-C keeps working)."""
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ModuleNotFoundError:
        raise S3Error("NotImplemented", 501,
                      "SSE-C requires the `cryptography` wheel, which "
                      "is not installed on this node")
    return AESGCM


class SseCKey:
    __slots__ = ("key", "md5_b64")

    def __init__(self, key: bytes, md5_b64: str):
        self.key = key
        self.md5_b64 = md5_b64

    def encrypt_block(self, plain: bytes) -> bytes:
        AESGCM = _aesgcm()

        nonce = os.urandom(NONCE_LEN)
        return nonce + AESGCM(self.key).encrypt(nonce, plain, b"")

    def decrypt_block(self, cipher: bytes) -> bytes:
        AESGCM = _aesgcm()

        if len(cipher) < OVERHEAD:
            raise S3Error("InvalidRequest", 400, "corrupt encrypted block")
        try:
            return AESGCM(self.key).decrypt(cipher[:NONCE_LEN],
                                            cipher[NONCE_LEN:], b"")
        except Exception:
            raise S3Error("AccessDenied", 403,
                          "wrong encryption key for this object")


def _parse(algo: Optional[str], key_b64: Optional[str],
           md5_b64: Optional[str], what: str) -> Optional[SseCKey]:
    if algo is None and key_b64 is None and md5_b64 is None:
        return None
    if algo != "AES256":
        raise S3Error("InvalidRequest", 400,
                      f"{what}: algorithm must be AES256")
    if not key_b64:
        raise S3Error("InvalidRequest", 400, f"{what}: key is required")
    try:
        key = base64.b64decode(key_b64)
    except Exception:
        raise S3Error("InvalidRequest", 400, f"{what}: bad key base64")
    if len(key) != 32:
        raise S3Error("InvalidRequest", 400,
                      f"{what}: key must be 256 bits")
    digest = base64.b64encode(hashlib.md5(key).digest()).decode()
    if md5_b64 is not None and md5_b64 != digest:
        raise S3Error("InvalidRequest", 400, f"{what}: key MD5 mismatch")
    return SseCKey(key, digest)


def request_sse_key(req: Request) -> Optional[SseCKey]:
    """The x-amz-server-side-encryption-customer-* triple, or None."""
    return _parse(req.header(ALGO_HEADER), req.header(KEY_HEADER),
                  req.header(KEY_MD5_HEADER), "SSE-C")


def copy_source_sse_key(req: Request) -> Optional[SseCKey]:
    return _parse(req.header(COPY_ALGO_HEADER),
                  req.header(COPY_KEY_HEADER),
                  req.header(COPY_KEY_MD5_HEADER), "copy-source SSE-C")


def meta_is_encrypted(meta) -> bool:
    return META_SSEC_ALGO in meta.headers


def check_key_for_meta(meta, key: Optional[SseCKey]) -> Optional[SseCKey]:
    """Validate the presented key against the object's stored key-MD5.
    Returns the key to decrypt with (None for plaintext objects)."""
    if not meta_is_encrypted(meta):
        if key is not None:
            raise S3Error("InvalidRequest", 400,
                          "object is not SSE-C encrypted")
        return None
    if key is None:
        raise S3Error("InvalidRequest", 400,
                      "object is SSE-C encrypted: key headers required")
    if meta.headers.get(META_SSEC_MD5) != key.md5_b64:
        raise S3Error("AccessDenied", 403,
                      "wrong encryption key for this object")
    return key


def sse_response_headers(meta) -> list[tuple[str, str]]:
    if not meta_is_encrypted(meta):
        return []
    return [(ALGO_HEADER, "AES256"),
            (KEY_MD5_HEADER, meta.headers.get(META_SSEC_MD5, ""))]
