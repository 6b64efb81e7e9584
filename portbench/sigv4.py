"""The load generator's S3 client: an independent stdlib SigV4 signer
(a frozen copy of tests/s3util.py's `S3Client.signing_key`, `sign` and
`chunked_signed_body`, which share no code with the server's
api/signature.py), over one persistent HTTP/1.1 connection per client,
as SDKs keep them. Besides PutObject and GetObject it sends the three
requests of a multipart upload: CreateMultipartUpload
(POST ?uploads), UploadPart (PUT ?partNumber=n&uploadId=u) and
CompleteMultipartUpload (POST ?uploadId=u with the parts' XML)."""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Optional

ALGORITHM = "AWS4-HMAC-SHA256"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
STREAMING = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def uri_encode(s: str, encode_slash: bool = True) -> str:
    return urllib.parse.quote(s, safe="-_.~" if encode_slash else "-_.~/")


def url(path: str, query=()) -> str:
    """`path?query` as the AWS CLI sends it: a key with an empty value
    goes bare (`?uploads`); the signature canonicalises it as
    `uploads=`."""
    if not query:
        return path
    return path + "?" + "&".join(
        uri_encode(k) + (f"={uri_encode(v)}" if v else "") for k, v in query)


def xml_text(body: bytes, tag: str) -> str:
    """The text of the first element whose local name is `tag` ("" where
    there is none or the body is no XML)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        return ""
    for el in root.iter():
        if el.tag.split("}")[-1] == tag:
            return el.text or ""
    return ""


class Signer:
    def __init__(self, key_id: str, secret: str, region: str = "garage",
                 service: str = "s3"):
        self.key_id = key_id
        self.secret = secret
        self.region = region
        self.service = service

    def _scope(self, date: str) -> str:
        return f"{date}/{self.region}/{self.service}/aws4_request"

    def signing_key(self, date: str) -> bytes:
        k = _hmac(b"AWS4" + self.secret.encode(), date)
        k = _hmac(k, self.region)
        k = _hmac(k, self.service)
        return _hmac(k, "aws4_request")

    def _canonical_query(self, query: list[tuple[str, str]]) -> str:
        pairs = sorted((uri_encode(k), uri_encode(v)) for k, v in query)
        return "&".join(f"{k}={v}" for k, v in pairs)

    def sign(self, method: str, path: str, query: list[tuple[str, str]],
             headers: dict[str, str], payload_hash: str,
             now: Optional[datetime.datetime] = None) -> dict[str, str]:
        """-> headers + Authorization. `headers` must already contain
        host; x-amz-date/x-amz-content-sha256 are added here."""
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date = now.strftime("%Y%m%d")
        headers = dict(headers)
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash
        signed = sorted(h.lower() for h in headers)
        canonical_headers = "".join(
            f"{h}:{' '.join(str(headers[next(k for k in headers if k.lower() == h)]).split())}\n"
            for h in signed)
        creq = "\n".join([
            method,
            # S3 convention: the request path is single-encoded by
            # the caller and used VERBATIM as the canonical URI
            path or "/",
            self._canonical_query(query),
            canonical_headers,
            ";".join(signed),
            payload_hash,
        ])
        sts = "\n".join([ALGORITHM, amz_date, self._scope(date),
                         _sha256(creq.encode())])
        sig = hmac.new(self.signing_key(date), sts.encode(),
                       hashlib.sha256).hexdigest()
        headers["authorization"] = (
            f"{ALGORITHM} Credential={self.key_id}/{self._scope(date)},"
            f"SignedHeaders={';'.join(signed)},Signature={sig}")
        return headers

    def chunked_signed_body(self, chunks: list, amz_date: str,
                            seed_signature: str) -> bytes:
        """A STREAMING-AWS4-HMAC-SHA256-PAYLOAD body: each chunk framed
        with its signature, chained from the seed signature, and the
        final empty chunk."""
        date = amz_date[:8]
        sk = self.signing_key(date)
        prev = seed_signature
        out = bytearray()
        for data in list(chunks) + [b""]:
            sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date,
                             self._scope(date), prev, EMPTY_SHA256,
                             _sha256(data)])
            sig = hmac.new(sk, sts.encode(), hashlib.sha256).hexdigest()
            out += f"{len(data):x};chunk-signature={sig}\r\n".encode()
            if data:
                out += data + b"\r\n"
            prev = sig
        out += b"\r\n"
        return bytes(out)


class Client:
    """One S3 client: a signer and a persistent connection, reopened
    after an error."""

    def __init__(self, host: str, port: int, signer: Signer,
                 timeout: float = 120.0):
        self.host, self.port, self.signer = host, port, signer
        self.timeout = timeout
        self._conn: Optional[http.client.HTTPConnection] = None

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _send(self, method: str, path: str, body: bytes,
              headers: dict) -> tuple[int, dict, bytes]:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        try:
            self._conn.request(method, path, body=body, headers=headers)
            r = self._conn.getresponse()
            rbody = r.read()
            hdrs = {k.lower(): v for k, v in r.getheaders()}
        except BaseException:
            self.close()
            raise
        if hdrs.get("connection", "").lower() == "close":
            self.close()
        return r.status, hdrs, rbody

    def _host(self) -> dict:
        return {"host": f"{self.host}:{self.port}"}

    def put_unsigned(self, path: str, body: bytes, query=()):
        headers = self.signer.sign("PUT", path, list(query), self._host(),
                                   "UNSIGNED-PAYLOAD")
        return self._send("PUT", url(path, query), body, headers)

    def signed_chunked_body(self, path: str, chunks: list,
                            forge_chunk: Optional[int] = None, query=()
                            ) -> tuple[dict, bytes]:
        """Headers and aws-chunked body of a signed streaming PUT;
        `forge_chunk` alters that chunk's signature."""
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        headers = dict(self._host())
        headers["content-encoding"] = "aws-chunked"
        headers["x-amz-decoded-content-length"] = str(
            sum(len(c) for c in chunks))
        headers = self.signer.sign("PUT", path, list(query), headers,
                                   STREAMING, now=now)
        seed = headers["authorization"].rsplit("Signature=", 1)[1]
        body = self.signer.chunked_signed_body(chunks, amz_date, seed)
        if forge_chunk is not None:
            at = -1
            for _ in range(forge_chunk + 1):
                at = body.index(b"chunk-signature=", at + 1)
            i = at + len(b"chunk-signature=")
            body = (body[:i] + (b"0" if body[i:i + 1] != b"0" else b"1")
                    + body[i + 1:])
        return headers, body

    def put_signed(self, path: str, headers: dict, body: bytes, query=()):
        return self._send("PUT", url(path, query), body, headers)

    def get(self, path: str):
        headers = self.signer.sign("GET", path, [], self._host(),
                                   EMPTY_SHA256)
        return self._send("GET", path, b"", headers)

    def post(self, path: str, query: list, body: bytes = b""):
        """A POST whose payload is signed by its SHA-256, as the AWS CLI
        signs its small XML bodies."""
        headers = self.signer.sign("POST", path, query, self._host(),
                                   _sha256(body))
        return self._send("POST", url(path, query), body, headers)

    def create_multipart(self, path: str):
        """-> (status, headers, upload id or "")."""
        st, hdr, body = self.post(path, [("uploads", "")])
        return st, hdr, xml_text(body, "UploadId") if st == 200 else ""

    def complete_multipart(self, path: str, upload_id: str,
                           etags: list[str]):
        """Completes with parts 1..len(etags) and the ETags their
        UploadParts returned -> (status, headers, the upload's ETag or
        "")."""
        xml = "".join(f'<Part><PartNumber>{n}</PartNumber><ETag>"{e}"</ETag>'
                      "</Part>" for n, e in enumerate(etags, 1))
        body = f"<CompleteMultipartUpload>{xml}</CompleteMultipartUpload>"
        st, hdr, rbody = self.post(path, [("uploadId", upload_id)],
                                   body.encode())
        etag = xml_text(rbody, "ETag").strip('"') if st == 200 else ""
        return st, hdr, etag
