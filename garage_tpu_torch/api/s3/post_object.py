"""Copy of garage_tpu/api/s3/post_object.py: import paths rewritten, issue and PR tags dropped.

PostObject: browser form uploads (multipart/form-data + POST policy).

Ref parity: src/api/s3/post_object.rs. The request is NOT header-signed:
the form carries a base64 policy document signed with the SigV4 signing
key (signature = HMAC(signing_key, policy_b64)). Every form field must
be authorized by a policy condition (exact / starts-with /
content-length-range), the file must be the last field, and `${filename}`
in the key field substitutes the uploaded file's name.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
from typing import Optional

from ..http import BodyReader, Request, Response
from ..signature import signing_key
from .put import save_stream
from .xml import S3Error, access_denied

# fields the policy need not cover (ref: post_object.rs:147)
_IGNORED_FIELDS = ("policy", "x-amz-signature", "file")


class _FormReader:
    """Streaming multipart/form-data parser. Text fields (before the
    file) are collected into a dict; the `file` part's content is
    exposed as a body-reader that stops at the closing boundary."""

    def __init__(self, body: BodyReader, boundary: str):
        self.body = body
        self.delim = b"\r\n--" + boundary.encode()
        self._buf = bytearray()
        self._eof = False

    async def _fill(self, n: int) -> None:
        while not self._eof and len(self._buf) < n:
            chunk = await self.body.read(65536)
            if not chunk:
                self._eof = True
                break
            self._buf.extend(chunk)

    async def _read_until(self, marker: bytes, limit: int = 1 << 20
                          ) -> bytes:
        """Consume through `marker`; returns bytes before it."""
        while True:
            i = bytes(self._buf).find(marker)
            if i >= 0:
                out = bytes(self._buf[:i])
                del self._buf[: i + len(marker)]
                return out
            if self._eof:
                raise S3Error("MalformedPOSTRequest", 400,
                              "truncated multipart body")
            if len(self._buf) > limit:
                raise S3Error("MalformedPOSTRequest", 400,
                              "form field too large")
            await self._fill(len(self._buf) + 65536)

    async def start(self) -> None:
        # first boundary has no leading CRLF
        await self._read_until(self.delim[2:])

    async def next_part(self) -> Optional[tuple[str, dict]]:
        """-> (field_name, part headers) or None after the final
        boundary. Call read_field() or the file reader afterwards."""
        await self._fill(2)
        if bytes(self._buf[:2]) == b"--":
            return None  # closing delimiter
        head = await self._read_until(b"\r\n\r\n", limit=16 << 10)
        headers: dict[str, str] = {}
        for line in head.split(b"\r\n"):
            name, _, val = line.partition(b":")
            if val:
                headers[name.decode().strip().lower()] = val.decode().strip()
        disp = headers.get("content-disposition", "")
        fname = None
        field = None
        for item in disp.split(";"):
            item = item.strip()
            if item.startswith("name="):
                field = item[5:].strip('"')
            elif item.startswith("filename="):
                fname = item[9:].strip('"')
        if field is None:
            raise S3Error("MalformedPOSTRequest", 400,
                          "part without a field name")
        headers["_filename"] = fname or ""
        return field, headers

    async def read_field(self, limit: int = 1 << 20) -> str:
        raw = await self._read_until(self.delim, limit=limit)
        return raw.decode("utf-8", "replace")

    def file_reader(self) -> "_FileReader":
        return _FileReader(self)


class _FileReader:
    """Body-reader over the file part: yields content up to the next
    boundary delimiter."""

    def __init__(self, form: _FormReader):
        self.form = form
        self.done = False

    async def read(self, n: int = 65536) -> bytes:
        if self.done:
            return b""
        form = self.form
        # keep enough lookahead that a delimiter split across chunk
        # borders is always detected
        await form._fill(n + len(form.delim) + 4)
        buf = bytes(form._buf)
        i = buf.find(form.delim)
        if i >= 0:
            out = buf[:i]
            del form._buf[: i + len(form.delim)]
            self.done = True
            return out
        keep = len(form.delim) - 1 if not form._eof else 0
        if len(buf) <= keep:
            if form._eof:
                raise S3Error("MalformedPOSTRequest", 400,
                              "file part not terminated")
            return await self.read(n)
        out = buf[: len(buf) - keep]
        del form._buf[: len(buf) - keep]
        return out


def _check_policy(policy_raw: bytes,
                  fields: dict[str, str]) -> tuple[int, int]:
    """Validate the decoded policy against the submitted fields; returns
    the (min, max) content-length-range
    (ref: post_object.rs:133-220 + Policy::into_conditions)."""
    try:
        policy = json.loads(policy_raw.decode())
        expiration = policy["expiration"]
        raw_conditions = policy["conditions"]
    except (ValueError, KeyError, UnicodeDecodeError):
        raise S3Error("InvalidPolicyDocument", 400, "invalid policy")
    try:
        exp = datetime.datetime.fromisoformat(
            expiration.replace("Z", "+00:00"))
    except ValueError:
        raise S3Error("InvalidPolicyDocument", 400,
                      "invalid expiration date")
    if datetime.datetime.now(datetime.timezone.utc) > exp:
        raise S3Error("AccessDenied", 403, "policy has expired")

    conditions: dict[str, list[tuple[str, str]]] = {}
    length = [0, 1 << 62]
    for cond in raw_conditions:
        if isinstance(cond, dict):
            if len(cond) != 1:
                raise S3Error("InvalidPolicyDocument", 400,
                              "invalid policy item")
            (k, v), = cond.items()
            conditions.setdefault(k.lower(), []).append(("eq", str(v)))
        elif isinstance(cond, list) and len(cond) == 3:
            op, k, v = cond
            if op == "content-length-range":
                try:
                    length[0] = max(length[0], int(k))
                    length[1] = min(length[1], int(v))
                except (TypeError, ValueError):
                    raise S3Error("InvalidPolicyDocument", 400,
                                  "content-length-range bounds must be "
                                  "integers")
                continue
            if not isinstance(k, str) or not k.startswith("$") \
                    or op not in ("eq", "starts-with"):
                raise S3Error("InvalidPolicyDocument", 400,
                              "invalid policy item")
            conditions.setdefault(k[1:].lower(), []).append((op, str(v)))
        else:
            raise S3Error("InvalidPolicyDocument", 400,
                          "invalid policy item")

    for name, value in fields.items():
        lname = name.lower()
        if lname in _IGNORED_FIELDS:
            continue
        ops = conditions.pop(lname, None)
        if ops is None:
            if lname.startswith("x-ignore-"):
                continue
            raise S3Error("AccessDenied", 403,
                          f"field {name!r} is not allowed by the policy")
        for op, v in ops:
            if op == "eq" and value != v:
                raise S3Error("AccessDenied", 403,
                              f"field {name!r} does not match the policy")
            if op == "starts-with" and not value.startswith(v):
                raise S3Error("AccessDenied", 403,
                              f"field {name!r} does not match the policy")
    if conditions:
        missing = next(iter(conditions))
        raise S3Error("AccessDenied", 403,
                      f"field {missing!r} is required by the policy")
    return length[0], length[1]


class _LimitReader:
    def __init__(self, inner, max_len: int, prebuffered: bytes = b""):
        self.inner = inner
        self.max_len = max_len
        self.count = 0
        self._pre = prebuffered

    async def read(self, n: int = 65536) -> bytes:
        if self._pre:
            chunk, self._pre = self._pre[:n], self._pre[n:]
        else:
            chunk = await self.inner.read(n)
        self.count += len(chunk)
        if self.count > self.max_len:
            raise S3Error("EntityTooLarge", 400,
                          "file larger than content-length-range maximum")
        return chunk


# pre-buffering bound for the min-size check; content-length-range
# minimums beyond this are rejected up front rather than buffered
_MIN_PREBUFFER_CAP = 64 << 20


async def handle_post_object(server, req: Request,
                             bucket_name: str) -> Response:
    ctype = req.header("content-type") or ""
    if not ctype.startswith("multipart/form-data"):
        raise S3Error("MalformedPOSTRequest", 400,
                      "expected multipart/form-data")
    boundary = None
    for item in ctype.split(";")[1:]:
        item = item.strip()
        if item.startswith("boundary="):
            boundary = item[9:].strip('"')
    if not boundary:
        raise S3Error("MalformedPOSTRequest", 400, "no multipart boundary")

    form = _FormReader(req.body, boundary)
    await form.start()
    fields: dict[str, str] = {}
    file_headers = None
    while True:
        part = await form.next_part()
        if part is None:
            raise S3Error("MalformedPOSTRequest", 400,
                          "request did not contain a file")
        field, headers = part
        if field == "file":
            file_headers = headers
            break
        if len(fields) > 64:
            raise S3Error("MalformedPOSTRequest", 400, "too many fields")
        fields[field] = await form.read_field()

    key_tmpl = fields.get("key")
    policy_b64 = fields.get("policy")
    credential = fields.get("x-amz-credential")
    signature = fields.get("x-amz-signature")
    if not key_tmpl or not policy_b64 or not credential or not signature:
        raise S3Error("MalformedPOSTRequest", 400,
                      "key, policy, x-amz-credential and x-amz-signature "
                      "fields are required")
    key = key_tmpl.replace("${filename}",
                           file_headers.get("_filename", ""))

    # signature over the raw base64 policy (SigV4 POST policy scheme)
    parts = credential.split("/")
    if len(parts) != 5 or parts[4] != "aws4_request" \
            or parts[2] != server.region or parts[3] != "s3":
        raise access_denied("malformed credential")
    key_id, scope_date = parts[0], parts[1]
    secret = await server.helper.key_secret(key_id)
    if secret is None:
        raise access_denied("no such key")
    sk = signing_key(secret, scope_date, server.region, "s3")
    expect = hmac.new(sk, policy_b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, signature):
        raise access_denied("policy signature mismatch")
    try:
        policy_raw = base64.b64decode(policy_b64)
    except Exception:
        raise S3Error("InvalidPolicyDocument", 400, "bad policy base64")

    api_key = await server.helper.get_existing_key(key_id)
    bucket_id = await server.helper.resolve_global_bucket_name(bucket_name)
    if bucket_id is None:
        from .xml import no_such_bucket

        raise no_such_bucket(bucket_name)
    if not api_key.allow_write(bucket_id):
        raise access_denied()

    fields_with_key = dict(fields)
    fields_with_key["key"] = key_tmpl
    # the bucket the policy is checked against is ALWAYS the request
    # URL's bucket — a client-supplied "bucket" form field must never
    # satisfy the condition for a different target bucket
    fields_with_key["bucket"] = bucket_name
    min_len, max_len = _check_policy(policy_raw, fields_with_key)

    meta = {}
    if fields.get("content-type"):
        meta["content-type"] = fields["content-type"]
    for name, v in fields.items():
        if name.lower().startswith("x-amz-meta-"):
            meta[name.lower()] = v

    # size bounds are enforced WITHOUT mutating state on violation:
    # the minimum by pre-buffering min_len bytes before anything is
    # persisted, the maximum during streaming (save_stream's
    # interrupted-cleanup tombstones the partial version)
    file_body = form.file_reader()
    pre = b""
    if min_len > 0:
        if min_len > _MIN_PREBUFFER_CAP:
            raise S3Error("InvalidPolicyDocument", 400,
                          "content-length-range minimum too large")
        chunks = []
        got = 0
        while got < min_len:
            chunk = await file_body.read(min(65536, min_len - got))
            if not chunk:
                raise S3Error("EntityTooSmall", 400,
                              "file smaller than content-length-range "
                              "minimum")
            chunks.append(chunk)
            got += len(chunk)
        pre = b"".join(chunks)
    uuid, ts, etag, total = await save_stream(
        server.garage, bucket_id, key, meta,
        _LimitReader(file_body, max_len, prebuffered=pre))

    status_field = fields.get("success_action_status", "204")
    redirect = fields.get("success_action_redirect")
    if redirect:
        sep = "&" if "?" in redirect else "?"
        loc = (f"{redirect}{sep}bucket={bucket_name}&key={key}"
               f"&etag=%22{etag}%22")
        return Response(303, [("location", loc), ("etag", f'"{etag}"')])
    if status_field == "200":
        return Response(200, [("etag", f'"{etag}"')])
    if status_field == "201":
        from .xml import xml, xml_response

        return xml_response(
            xml("PostResponse",
                xml("Bucket", bucket_name),
                xml("Key", key),
                xml("ETag", f'"{etag}"')), status=201)
    return Response(204, [("etag", f'"{etag}"')])
