"""AWS Signature V4 verification (ported from the JAX package's
api/signature.py; it differs only in comments: a chunk this module hands
the feeder is hashed by S2 in the feeder's "require" mode, and routed
as in the JAX package in "auto" and "off").

Ref parity: src/api/common/signature/ (payload.rs:35-576 header +
presigned auth, streaming.rs aws-chunked per-chunk signatures). Verifies
Authorization-header and presigned-query signatures against the key
table, and wraps `aws-chunked` streaming bodies (signed chunks or
unsigned-with-trailer) so handlers see plain payload bytes.
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import os
from typing import Optional
from urllib.parse import quote, unquote

from .http import BodyReader, HttpError, Request

# sha256 releases the GIL; chunks at/above this size hash in a worker
# thread, overlapping with the next read instead of stalling the event
# loop (same threshold discipline as the put pipeline's md5 offload)
_HASH_OFFLOAD_MIN = 64 * 1024
_MULTICORE = (os.cpu_count() or 1) > 1

SERVICE = "s3"
ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_SIGNED = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
STREAMING_SIGNED_TRAILER = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD-TRAILER"
STREAMING_UNSIGNED_TRAILER = "STREAMING-UNSIGNED-PAYLOAD-TRAILER"
MAX_CLOCK_SKEW = 15 * 60


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str,
                service: str = SERVICE) -> bytes:
    k = _hmac(b"AWS4" + secret.encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return quote(s, safe=safe)


def canonical_query(raw_pairs: list[tuple[str, str]],
                    skip: tuple[str, ...] = ()) -> str:
    enc = []
    for k, v in raw_pairs:
        dk, dv = unquote(k), unquote(v)
        if dk in skip:
            continue
        enc.append((uri_encode(dk), uri_encode(dv)))
    return "&".join(f"{k}={v}" for k, v in sorted(enc))


def canonical_headers(headers: dict[str, str],
                      signed: list[str]) -> tuple[str, str]:
    lines = []
    for name in signed:
        v = headers.get(name)
        if v is None:
            raise HttpError(403, f"signed header {name} missing")
        lines.append(f"{name}:{' '.join(v.split())}\n")
    return "".join(lines), ";".join(signed)


def canonical_request(method: str, raw_path: str,
                      raw_query: list[tuple[str, str]],
                      headers: dict[str, str], signed: list[str],
                      payload_hash: str,
                      skip_query: tuple[str, ...] = ()) -> str:
    ch, sh = canonical_headers(headers, signed)
    return "\n".join([
        method,
        raw_path or "/",
        canonical_query(raw_query, skip_query),
        ch,
        sh,
        payload_hash,
    ])


def string_to_sign(amz_date: str, scope: str, creq: str) -> str:
    return "\n".join([ALGORITHM, amz_date, scope, _sha256(creq.encode())])


def parse_amz_date(s: str) -> datetime.datetime:
    try:
        return datetime.datetime.strptime(s, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc)
    except ValueError:
        raise HttpError(403, "invalid x-amz-date")


class VerifiedRequest:
    __slots__ = ("key_id", "content_sha256", "signature", "scope_date",
                 "signing_key", "presigned")

    def __init__(self, key_id, content_sha256, signature, scope_date,
                 sk, presigned):
        self.key_id = key_id
        self.content_sha256 = content_sha256  # literal header value
        self.signature = signature
        self.scope_date = scope_date
        self.signing_key = sk
        self.presigned = presigned


def claimed_key_id(req: Request) -> Optional[str]:
    """The key id the request CLAIMS, parsed without any crypto — the
    per-key FAIRNESS identity (qos deficit round-robin) available
    BEFORE SigV4 runs. A forged claim only picks which fair queue the
    request waits in (and a flood under someone else's id shares that
    id's 1/K slice — strictly worse for the attacker than spreading
    out); authorization always uses the VERIFIED identity resolved
    after signature check."""
    auth = req.header("authorization")
    if auth and "Credential=" in auth:
        cred = auth.split("Credential=", 1)[1].split(",", 1)[0]
        kid = cred.strip().split("/", 1)[0]
        return kid or None
    cred = req.query.get("X-Amz-Credential")
    if cred:
        kid = unquote(cred).split("/", 1)[0]
        return kid or None
    return None


async def verify_request(req: Request, region: str, lookup_secret,
                         service: str = SERVICE
                         ) -> Optional[VerifiedRequest]:
    """Check the request signature. `lookup_secret(key_id) -> secret|None`
    (async). Returns None for anonymous (unsigned) requests; raises
    HttpError(403) on bad signatures. `service` is the SigV4 scope
    service — "s3", or "k2v" for the K2V API (ref:
    api/k2v/api_server.rs verify_request). ref: payload.rs:35-200."""
    auth = req.header("authorization")
    if auth is not None:
        return await _verify_header(req, region, lookup_secret, auth,
                                    service)
    if req.query.get("X-Amz-Algorithm") == ALGORITHM:
        return await _verify_presigned(req, region, lookup_secret, service)
    return None


def _parse_credential(cred: str, region: str,
                      service: str = SERVICE) -> tuple[str, str]:
    parts = cred.split("/")
    if len(parts) != 5 or parts[4] != "aws4_request":
        raise HttpError(403, "malformed credential")
    key_id, date, creg, svc = parts[0], parts[1], parts[2], parts[3]
    if creg != region or svc != service:
        raise HttpError(403, f"wrong scope region/service ({creg}/{svc})")
    return key_id, date


def _check_date(amz_date: str, scope_date: str, now=None) -> None:
    t = parse_amz_date(amz_date)
    if t.strftime("%Y%m%d") != scope_date:
        raise HttpError(403, "date mismatch between x-amz-date and scope")
    now = now or datetime.datetime.now(datetime.timezone.utc)
    if abs((now - t).total_seconds()) > MAX_CLOCK_SKEW:
        raise HttpError(403, "request time too skewed")


async def _verify_header(req: Request, region: str, lookup_secret,
                         auth: str,
                         service: str = SERVICE) -> VerifiedRequest:
    if not auth.startswith(ALGORITHM):
        raise HttpError(403, "unsupported auth algorithm")
    fields = {}
    for item in auth[len(ALGORITHM):].split(","):
        k, _, v = item.strip().partition("=")
        fields[k] = v
    try:
        cred = fields["Credential"]
        signed_headers = fields["SignedHeaders"].split(";")
        signature = fields["Signature"]
    except KeyError:
        raise HttpError(403, "malformed authorization header")
    key_id, scope_date = _parse_credential(cred, region, service)
    amz_date = req.header("x-amz-date") or req.header("date") or ""
    _check_date(amz_date, scope_date)
    secret = await lookup_secret(key_id)
    if secret is None:
        raise HttpError(403, "no such key")
    payload_hash = req.header("x-amz-content-sha256") or UNSIGNED_PAYLOAD
    from .http import parse_query

    _, raw_pairs = parse_query(req.raw_query)
    creq = canonical_request(req.method, req.raw_path, raw_pairs,
                             req.headers, signed_headers, payload_hash)
    scope = f"{scope_date}/{region}/{service}/aws4_request"
    sk = signing_key(secret, scope_date, region, service)
    expect = hmac.new(sk, string_to_sign(amz_date, scope, creq).encode(),
                      hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, signature):
        raise HttpError(403, "signature mismatch")
    return VerifiedRequest(key_id, payload_hash, signature, scope_date,
                           sk, False)


async def _verify_presigned(req: Request, region: str, lookup_secret,
                            service: str = SERVICE) -> VerifiedRequest:
    """ref: payload.rs check_presigned_signature."""
    q = req.query
    try:
        cred = q["X-Amz-Credential"]
        amz_date = q["X-Amz-Date"]
        expires = int(q["X-Amz-Expires"])
        signed_headers = q["X-Amz-SignedHeaders"].split(";")
        signature = q["X-Amz-Signature"]
    except (KeyError, ValueError):
        raise HttpError(403, "malformed presigned query")
    key_id, scope_date = _parse_credential(cred, region, service)
    t = parse_amz_date(amz_date)
    now = datetime.datetime.now(datetime.timezone.utc)
    if now > t + datetime.timedelta(seconds=min(expires, 7 * 86400)):
        raise HttpError(403, "presigned URL expired")
    secret = await lookup_secret(key_id)
    if secret is None:
        raise HttpError(403, "no such key")
    from .http import parse_query

    _, raw_pairs = parse_query(req.raw_query)
    creq = canonical_request(req.method, req.raw_path, raw_pairs,
                             req.headers, signed_headers, UNSIGNED_PAYLOAD,
                             skip_query=("X-Amz-Signature",))
    scope = f"{scope_date}/{region}/{service}/aws4_request"
    sk = signing_key(secret, scope_date, region, service)
    expect = hmac.new(sk, string_to_sign(amz_date, scope, creq).encode(),
                      hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, signature):
        raise HttpError(403, "signature mismatch")
    return VerifiedRequest(key_id, UNSIGNED_PAYLOAD, signature, scope_date,
                           sk, True)


# ---- payload body wrappers (ref: signature/streaming.rs) ---------------


class SignedPayloadReader:
    """Whole-body sha256 check for x-amz-content-sha256=<hex> requests.

    MiB-scale chunks hash in a worker thread, and the previous chunk's
    hash runs WHILE the next chunk is read off the socket, so on
    multicore the verification cost overlaps I/O instead of serializing
    with it. Updates stay strictly ordered: the pending hash is awaited
    before the next one is scheduled."""

    def __init__(self, inner: BodyReader, expect_hex: str):
        self.inner = inner
        self.h = hashlib.sha256()
        self.expect = expect_hex
        self._hash_task: Optional[asyncio.Task] = None

    async def readinto1(self, mv: memoryview) -> int:
        """Zero-copy ingest: land the next span directly in
        a leased buffer slice and advance the running body hash over
        the view — no per-chunk bytes object. The whole-body digest is
        inherently serial, so the update runs inline (a ≤64 KiB span
        hashes in tens of microseconds; MiB-scale spans never occur —
        the chunker asks for at most one socket read's worth)."""
        if self._hash_task is not None:
            # a prior read()'s off-thread hash must land first to keep
            # update order; mixed read()/readinto1 use is legal
            task, self._hash_task = self._hash_task, None
            await task
        n = await self.inner.readinto1(mv)
        if n:
            self.h.update(mv[:n])
        elif self.h.hexdigest() != self.expect:
            raise HttpError(400, "payload checksum mismatch")
        return n

    async def read(self, n: int = 65536) -> bytes:
        if self._hash_task is not None:
            task, self._hash_task = self._hash_task, None
            chunk, _ = await asyncio.gather(self.inner.read(n), task)
        else:
            chunk = await self.inner.read(n)
        if chunk:
            if _MULTICORE and len(chunk) >= _HASH_OFFLOAD_MIN:
                self._hash_task = asyncio.create_task(
                    asyncio.to_thread(self.h.update, chunk))
            else:
                self.h.update(chunk)
        elif self.h.hexdigest() != self.expect:
            raise HttpError(400, "payload checksum mismatch")
        return chunk

    async def read_all(self, limit: int = 1 << 30) -> bytes:
        out = bytearray()
        while True:
            c = await self.read()
            if not c:
                return bytes(out)
            out.extend(c)
            if len(out) > limit:
                raise HttpError(413)

    async def drain(self):
        if self._hash_task is not None:
            task, self._hash_task = self._hash_task, None
            await task
        await self.inner.drain()


class AwsChunkedReader:
    """Decodes aws-chunked framing, verifying per-chunk signatures when
    the payload is STREAMING-AWS4-HMAC-SHA256-PAYLOAD.

    chunk: <hex size>;chunk-signature=<sig>\r\n <data> \r\n
    chunk signature = HMAC(sk, "AWS4-HMAC-SHA256-PAYLOAD" \n date \n
                      scope \n previous-sig \n sha256("") \n sha256(data))
    ref: streaming.rs.

    Verification is PIPELINED: a returned chunk's sha256 runs in a
    worker thread while the caller processes it and the next chunk is
    read; the signature check settles at the start of the next read()
    (the HMAC chain needs chunk order anyway). A forged chunk therefore
    raises 403 one read later than the strictly-serial decoder did —
    still before the body ever completes, so nothing a handler stores
    can be finalized from a forged stream (the request aborts and the
    upload is tombstoned), but MiB-scale hashing no longer serializes
    with socket reads.
    """

    def __init__(self, inner: BodyReader, verified: VerifiedRequest,
                 region: str, amz_date: str, signed: bool,
                 trailer: bool = False,
                 trailer_algo: Optional[str] = None,
                 feeder=None):
        self.inner = inner
        self.v = verified
        self.region = region
        self.amz_date = amz_date
        self.signed = signed
        self.trailer = trailer
        self.prev_sig = verified.signature
        self._buf = bytearray()
        self._done = False
        # previously returned chunk awaiting verification:
        # (data, sig, hash_task | None)
        self._pending: Optional[tuple] = None
        # cross-connection hash batching: when set, chunk sha256 jobs
        # of at least _HASH_OFFLOAD_MIN bytes route through the device
        # feeder so concurrent PUT streams' chunk hashes coalesce into
        # one S2 launch; smaller chunks are hashed on the host
        self._feeder = feeder
        # zero-copy mode state (readinto1): the current chunk's
        # remaining payload bytes, its declared signature, the spans it
        # landed in the CURRENT lease (hashed as one batched feeder
        # message at chunk end), and the host hasher spans fold into
        # when the chunk outlives a lease
        self._chunk_left = 0
        self._chunk_sig: Optional[str] = None
        self._chunk_spans: list = []
        self._chunk_hasher = None
        self._checksummer = None
        if trailer_algo is not None:
            from .checksum import Checksummer

            self._checksummer = Checksummer(trailer_algo)

    async def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            c = await self.inner.read()
            if not c:
                raise HttpError(400, "truncated aws-chunked body")
            self._buf.extend(c)
        i = self._buf.index(b"\r\n")
        line = bytes(self._buf[:i])
        del self._buf[:i + 2]
        return line

    async def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            c = await self.inner.read()
            if not c:
                raise HttpError(400, "truncated aws-chunked body")
            self._buf.extend(c)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def _chunk_string_to_sign(self, data_sha_hex: str) -> str:
        scope = f"{self.v.scope_date}/{self.region}/{SERVICE}/aws4_request"
        return "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD", self.amz_date, scope, self.prev_sig,
            _sha256(b""), data_sha_hex,
        ])

    def _start_hash(self, data: bytes):
        if len(data) >= _HASH_OFFLOAD_MIN and self._feeder is not None:
            # feeder lane: concurrent PUT streams' chunk hashes batch
            # into one device launch (kernel S2); the task resolves to
            # the hex digest _settle expects
            return asyncio.create_task(self._feeder.sha256_hex(data))
        if _MULTICORE and len(data) >= _HASH_OFFLOAD_MIN:
            return asyncio.create_task(
                asyncio.to_thread(lambda: _sha256(data)))
        return None

    def _verify_chunk_sig(self, data_sha_hex: str, sig: str) -> None:
        """Check one chunk's signature and advance the HMAC chain."""
        expect = hmac.new(self.v.signing_key,
                          self._chunk_string_to_sign(data_sha_hex).encode(),
                          hashlib.sha256).hexdigest()
        if not hmac.compare_digest(expect, sig):
            raise HttpError(403, "chunk signature mismatch")
        self.prev_sig = expect

    async def _settle(self) -> None:
        """Finish the previous chunk: await its off-thread sha256,
        verify its signature (advancing the HMAC chain), feed the
        trailing checksummer. Chunk order is preserved because at most
        one chunk is ever pending."""
        if self._pending is None:
            return
        data, sig, task = self._pending
        self._pending = None
        sha_hex = (await task) if task is not None else _sha256(data)
        if self.signed:
            self._verify_chunk_sig(sha_hex, sig)
        if self._checksummer is not None:
            self._checksummer.update(data)

    async def read(self, n: int = 1 << 30) -> bytes:
        """Returns one decoded chunk (ignores n except as a hint)."""
        if self._done:
            return b""
        header = await self._read_line()
        size_part, _, ext = header.partition(b";")
        try:
            size = int(size_part, 16)
        except ValueError:
            raise HttpError(400, "bad aws-chunk header")
        sig = None
        if ext.startswith(b"chunk-signature="):
            sig = ext[len(b"chunk-signature="):].decode()
        if self.signed and sig is None:
            raise HttpError(403, "missing chunk signature")
        data = await self._read_exact(size)
        # the previous chunk's hash has been running while we read;
        # settle it now — prev_sig must advance before this chunk's
        # signature can be checked
        await self._settle()
        if size == 0:
            if self.signed:
                self._verify_chunk_sig(_sha256(b""), sig)
            # trailer section follows the final chunk header directly
            # (ref: streaming.rs parse_next — no data CRLF here)
            if self.trailer:
                await self._verify_trailer()
            else:
                await self._read_exact(2)  # final CRLF
            await self.inner.drain()
            self._done = True
            return b""
        await self._read_exact(2)  # CRLF after data
        self._pending = (data, sig, self._start_hash(data))
        return data

    async def readinto1(self, mv: memoryview) -> int:
        """Zero-copy ingest: decode the aws-chunked framing
        but land payload bytes directly in `mv` (a leased ingest-buffer
        slice), -> bytes written, 0 at end. A client chunk larger than
        `mv` is consumed across calls; its sha256 accumulates
        incrementally and the signature verifies at the chunk's last
        span — strictly EARLIER than the pipelined read() path settles
        (which is one read later), so the forged-chunk guarantee is
        preserved. Do not interleave with read() mid-chunk."""
        if self._done:
            return 0
        if self._chunk_left == 0:
            await self._settle()  # a prior read()'s pending chunk
            header = await self._read_line()
            size_part, _, ext = header.partition(b";")
            try:
                size = int(size_part, 16)
            except ValueError:
                raise HttpError(400, "bad aws-chunk header")
            sig = None
            if ext.startswith(b"chunk-signature="):
                sig = ext[len(b"chunk-signature="):].decode()
            if self.signed and sig is None:
                raise HttpError(403, "missing chunk signature")
            if size == 0:
                if self.signed:
                    self._verify_chunk_sig(_sha256(b""), sig)
                if self.trailer:
                    await self._verify_trailer()
                else:
                    await self._read_exact(2)  # final CRLF
                await self.inner.drain()
                self._done = True
                return 0
            self._chunk_left = size
            self._chunk_sig = sig
            self._chunk_spans = []
            self._chunk_hasher = None
        want = min(len(mv), self._chunk_left)
        if self._buf:
            # spill: a header-line read overshot into payload; those
            # bytes hop through _buf before landing (bounded by one
            # socket read per chunk — counted so the copy budget in
            # bench_put_path stays honest)
            n = min(want, len(self._buf))
            mv[:n] = self._buf[:n]
            del self._buf[:n]
            from ..utils.metrics import registry

            registry().inc("s3_put_copy_bytes", n, path="spill")
        else:
            n = await self.inner.readinto1(mv[:want])
            if not n:
                raise HttpError(400, "truncated aws-chunked body")
        span = mv[:n]
        if self.signed:
            self._chunk_spans.append(span)
        if self._checksummer is not None:
            self._checksummer.update(span)
        self._chunk_left -= n
        if self._chunk_left == 0:
            await self._read_exact(2)  # CRLF after data
            if self.signed:
                self._verify_chunk_sig(await self._chunk_sha_hex(),
                                       self._chunk_sig)
        elif self.signed and n == len(mv):
            # the destination (a leased block buffer) just filled: the
            # caller hands it to the put pipeline, which recycles it on
            # release — fold its spans into a host hasher NOW, while
            # the bytes are still this chunk's to read
            self._fold_spans()
        return n

    def _fold_spans(self) -> None:
        if self._chunk_hasher is None:
            self._chunk_hasher = hashlib.sha256()
        for s in self._chunk_spans:
            self._chunk_hasher.update(s)
        self._chunk_spans = []

    async def _chunk_sha_hex(self) -> str:
        """Digest of the just-completed chunk. A chunk wholly resident
        in the live lease rides the feeder's batched sha256 lane as its
        span list — concurrent streams' chunk hashes coalesce into one
        device launch with zero host copies (the SHA pad-in IS the h2d
        staging). A chunk that crossed a lease boundary was folded into
        a host hasher at the handoff and finishes there."""
        spans, self._chunk_spans = self._chunk_spans, []
        if self._chunk_hasher is not None:
            h, self._chunk_hasher = self._chunk_hasher, None
            for s in spans:
                h.update(s)
            return h.hexdigest()
        if self._feeder is not None \
                and sum(len(s) for s in spans) >= _HASH_OFFLOAD_MIN:
            return await self._feeder.sha256_hex(spans)
        h = hashlib.sha256()
        for s in spans:
            h.update(s)
        return h.hexdigest()

    async def _verify_trailer(self) -> None:
        """Parse `name:value[\\n]\\r\\n` (+ x-amz-trailer-signature for
        signed mode), check the declared checksum against the payload,
        and verify the trailer signature (ref: streaming.rs
        TrailerChunk::parse_*, compute_streaming_trailer_signature)."""
        line = await self._read_line()
        if not line and self._checksummer is None and not self.signed:
            return  # legitimately empty trailer section: 0\r\n\r\n
        name, sep, value = line.partition(b":")
        if not sep:
            raise HttpError(400, "malformed trailer")
        name = name.strip().decode("latin-1").lower()
        value = value.strip().decode("latin-1")
        if self.signed:
            sig_line = await self._read_line()
            if not sig_line.startswith(b"x-amz-trailer-signature:"):
                raise HttpError(403, "missing x-amz-trailer-signature")
            sig = sig_line.partition(b":")[2].strip().decode()
            trailer_blob = f"{name}:{value}\n".encode()
            scope = (f"{self.v.scope_date}/{self.region}/{SERVICE}"
                     "/aws4_request")
            ok = False
            # AWS documents AWS4-HMAC-SHA256-TRAILER; the reference
            # signs with AWS4-HMAC-SHA256-PAYLOAD — accept either.
            for label in ("AWS4-HMAC-SHA256-TRAILER",
                          "AWS4-HMAC-SHA256-PAYLOAD"):
                sts = "\n".join([label, self.amz_date, scope, self.prev_sig,
                                 _sha256(trailer_blob)])
                expect = hmac.new(self.v.signing_key, sts.encode(),
                                  hashlib.sha256).hexdigest()
                if hmac.compare_digest(expect, sig):
                    ok = True
                    break
            if not ok:
                raise HttpError(403, "trailer signature mismatch")
        if self._checksummer is not None:
            from .checksum import header_algorithm

            if header_algorithm(name) == self._checksummer.algo:
                if value != self._checksummer.b64():
                    raise HttpError(400, "trailing checksum mismatch")
            else:
                raise HttpError(400, f"expected {self._checksummer.algo} "
                                     "trailer checksum")

    async def read_all(self, limit: int = 1 << 30) -> bytes:
        out = bytearray()
        while True:
            c = await self.read()
            if not c:
                return bytes(out)
            out.extend(c)
            if len(out) > limit:
                raise HttpError(413)

    async def drain(self):
        # settle a pending off-thread hash so no task outlives the
        # request (the verdict no longer matters: the body is being
        # discarded, not stored)
        if self._pending is not None:
            _data, _sig, task = self._pending
            self._pending = None
            if task is not None:
                await task
        await self.inner.drain()


def wrap_body(req: Request, verified: Optional[VerifiedRequest],
              region: str, feeder=None):
    """Give the handler a body reader enforcing the payload integrity
    mode the client declared. `feeder` (the block manager's device
    feeder, when the caller has one) lets aws-chunked per-chunk sha256
    jobs batch across concurrent connections."""
    if verified is None:
        return req.body
    cs = verified.content_sha256
    amz_date = req.header("x-amz-date") or ""
    if cs == STREAMING_SIGNED:
        return AwsChunkedReader(req.body, verified, region, amz_date, True,
                                feeder=feeder)
    if cs in (STREAMING_UNSIGNED_TRAILER, STREAMING_SIGNED_TRAILER):
        from .checksum import trailer_algorithm

        try:
            talgo = trailer_algorithm(req.headers)
        except ValueError as e:
            raise HttpError(400, str(e))
        return AwsChunkedReader(req.body, verified, region, amz_date,
                                cs == STREAMING_SIGNED_TRAILER,
                                trailer=True, trailer_algo=talgo,
                                feeder=feeder)
    if cs and cs != UNSIGNED_PAYLOAD:
        return SignedPayloadReader(req.body, cs)
    return req.body
