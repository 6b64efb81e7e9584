"""Copy of garage_tpu/k2v_client.py: import paths rewritten, issue and PR tags dropped.

K2V client SDK: a standalone synchronous client for the K2V API.

Ref parity: src/k2v-client/lib.rs:59-341 (the reference ships a Rust
SDK crate; this is its Python equivalent, self-contained — its own
SigV4 signer with scope service "k2v", stdlib HTTP only, usable from
scripts without importing the server packages).

    c = K2vClient("127.0.0.1", 3904, "bucket", key_id, secret)
    c.insert_item("pk", "sk", b"value")
    val = c.read_item("pk", "sk")          # -> K2vValue
    c.insert_item("pk", "sk", b"v2", causality=val.causality)
    c.delete_item("pk", "sk", causality=...)
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import http.client
import json
from dataclasses import dataclass
from typing import Optional
from urllib.parse import quote

CAUSALITY_HEADER = "x-garage-causality-token"


@dataclass
class K2vValue:
    """One read result: the concurrent values (None = delete marker)
    and the causality token to echo on the next write."""

    causality: str
    values: list[Optional[bytes]]

    @property
    def value(self) -> Optional[bytes]:
        live = [v for v in self.values if v is not None]
        return live[0] if live else None


@dataclass
class PartitionInfo:
    pk: str
    entries: int
    conflicts: int
    values: int
    bytes: int


class K2vError(Exception):
    def __init__(self, status: int, code: str, message: str):
        self.status = status
        self.code = code
        super().__init__(f"{status} {code}: {message}")


class K2vClient:
    def __init__(self, host: str, port: int, bucket: str, key_id: str,
                 secret: str, region: str = "garage"):
        self.host, self.port = host, port
        self.bucket = bucket
        self.key_id, self.secret = key_id, secret
        self.region = region

    # ---- signing (SigV4, service "k2v") --------------------------------

    def _sign(self, method: str, path: str, query: list[tuple[str, str]],
              headers: dict[str, str], body: bytes) -> dict[str, str]:
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(body).hexdigest()
        headers = {k.lower(): v for k, v in headers.items()}
        headers["host"] = f"{self.host}:{self.port}"
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash
        signed = sorted(headers)
        cq = "&".join(
            f"{quote(k, safe='-_.~')}={quote(v, safe='-_.~')}"
            for k, v in sorted(query))
        creq = "\n".join([
            method, quote(path, safe="/-_.~"), cq,
            "".join(f"{k}:{headers[k].strip()}\n" for k in signed),
            ";".join(signed), payload_hash,
        ])
        scope = f"{date}/{self.region}/k2v/aws4_request"
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
        k = b"AWS4" + self.secret.encode()
        for part in (date, self.region, "k2v", "aws4_request"):
            k = hmac.new(k, part.encode(), hashlib.sha256).digest()
        sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.key_id}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        return headers

    def _req(self, method: str, path: str,
             query: Optional[list[tuple[str, str]]] = None,
             headers: Optional[dict[str, str]] = None,
             body: bytes = b"", timeout: float = 330.0):
        query = query or []
        headers = self._sign(method, path, query, headers or {}, body)
        qs = "&".join(f"{quote(k, safe='-_.~')}={quote(v, safe='-_.~')}"
                      for k, v in query)
        url = path + ("?" + qs if qs else "")
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            conn.request(method, url, body=body, headers=headers)
            r = conn.getresponse()
            return r.status, {k.lower(): v for k, v in r.getheaders()}, \
                r.read()
        finally:
            conn.close()

    @staticmethod
    def _raise(status: int, body: bytes):
        try:
            err = json.loads(body.decode())
            raise K2vError(status, err.get("code", "?"),
                           err.get("message", ""))
        except (ValueError, UnicodeDecodeError, AttributeError):
            raise K2vError(status, "?", body[:200].decode("utf-8",
                                                          "replace"))

    # ---- item ops (ref: k2v-client/lib.rs) -----------------------------

    def read_item(self, pk: str, sk: str) -> K2vValue:
        st, hdrs, body = self._req(
            "GET", f"/{self.bucket}/{quote(pk, safe='')}",
            query=[("sort_key", sk)],
            headers={"accept": "application/json"})
        if st != 200:
            self._raise(st, body)
        vals = [None if v is None else base64.b64decode(v)
                for v in json.loads(body.decode())]
        return K2vValue(hdrs[CAUSALITY_HEADER], vals)

    def insert_item(self, pk: str, sk: str, value: bytes,
                    causality: Optional[str] = None) -> None:
        headers = {CAUSALITY_HEADER: causality} if causality else {}
        st, _, body = self._req(
            "PUT", f"/{self.bucket}/{quote(pk, safe='')}",
            query=[("sort_key", sk)], headers=headers, body=value)
        if st not in (200, 204):
            self._raise(st, body)

    def delete_item(self, pk: str, sk: str, causality: str) -> None:
        st, _, body = self._req(
            "DELETE", f"/{self.bucket}/{quote(pk, safe='')}",
            query=[("sort_key", sk)],
            headers={CAUSALITY_HEADER: causality})
        if st not in (200, 204):
            self._raise(st, body)

    def poll_item(self, pk: str, sk: str, causality: str,
                  timeout: float = 300.0) -> Optional[K2vValue]:
        """Long-poll until a newer version exists; None on timeout."""
        st, hdrs, body = self._req(
            "GET", f"/{self.bucket}/{quote(pk, safe='')}",
            query=[("sort_key", sk), ("causality_token", causality),
                   ("timeout", str(timeout))],
            headers={"accept": "application/json"},
            timeout=timeout + 30.0)
        if st == 304:
            return None
        if st != 200:
            self._raise(st, body)
        vals = [None if v is None else base64.b64decode(v)
                for v in json.loads(body.decode())]
        return K2vValue(hdrs[CAUSALITY_HEADER], vals)

    def poll_range(self, pk: str, seen_marker: Optional[str] = None,
                   prefix: Optional[str] = None,
                   start: Optional[str] = None, end: Optional[str] = None,
                   timeout: float = 300.0):
        """Long-poll a sort-key range; -> (items, seen_marker) or None
        on timeout. Items are dicts {sk, ct, v: [bytes|None]}."""
        spec = {"timeout": timeout}
        if seen_marker:
            spec["seenMarker"] = seen_marker
        if prefix is not None:
            spec["prefix"] = prefix
        if start is not None:
            spec["start"] = start
        if end is not None:
            spec["end"] = end
        st, _, body = self._req(
            "POST", f"/{self.bucket}/{quote(pk, safe='')}",
            query=[("poll_range", "")],
            body=json.dumps(spec).encode(), timeout=timeout + 30.0)
        if st == 304:
            return None
        if st != 200:
            self._raise(st, body)
        data = json.loads(body.decode())
        items = [{"sk": i["sk"], "ct": i["ct"],
                  "v": [None if v is None else base64.b64decode(v)
                        for v in i["v"]]}
                 for i in data["items"]]
        return items, data["seenMarker"]

    # ---- index / batch -------------------------------------------------

    def read_index(self, prefix: Optional[str] = None,
                   limit: Optional[int] = None) -> list[PartitionInfo]:
        q = []
        if prefix is not None:
            q.append(("prefix", prefix))
        if limit is not None:
            q.append(("limit", str(limit)))
        st, _, body = self._req("GET", f"/{self.bucket}", query=q)
        if st != 200:
            self._raise(st, body)
        data = json.loads(body.decode())
        return [PartitionInfo(p["pk"], p["entries"], p["conflicts"],
                              p["values"], p["bytes"])
                for p in data["partitionKeys"]]

    def insert_batch(self, items: list[tuple]) -> None:
        """items: [(pk, sk, value-bytes-or-None, causality-or-None)]."""
        payload = [{
            "pk": pk, "sk": sk,
            "v": base64.b64encode(v).decode() if v is not None else None,
            "ct": ct,
        } for pk, sk, v, ct in items]
        st, _, body = self._req("POST", f"/{self.bucket}",
                                body=json.dumps(payload).encode())
        if st not in (200, 204):
            self._raise(st, body)

    def read_batch(self, queries: list[dict]) -> list[dict]:
        st, _, body = self._req("POST", f"/{self.bucket}",
                                query=[("search", "")],
                                body=json.dumps(queries).encode())
        if st != 200:
            self._raise(st, body)
        return json.loads(body.decode())

    def delete_batch(self, queries: list[dict]) -> list[dict]:
        st, _, body = self._req("POST", f"/{self.bucket}",
                                query=[("delete", "")],
                                body=json.dumps(queries).encode())
        if st != 200:
            self._raise(st, body)
        return json.loads(body.decode())
