"""Copy of garage_tpu/api/s3/xml.py: import paths rewritten, issue and PR tags dropped.

Tiny XML writer + S3 error responses.

Ref parity: src/api/s3/xml.rs + error.rs. S3 responses are small XML
documents; a nested (tag, content) structure is enough.
"""

from __future__ import annotations

from typing import Optional
from xml.sax.saxutils import escape

from ..http import Response

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def xml(tag: str, *children, **attrs) -> tuple:
    return (tag, attrs, list(children))


def render_node(node) -> str:
    if isinstance(node, str):
        return escape(node)
    tag, attrs, children = node
    a = "".join(f' {k}="{escape(str(v))}"' for k, v in attrs.items())
    inner = "".join(render_node(c) for c in children)
    return f"<{tag}{a}>{inner}</{tag}>"


def xml_response(root, status: int = 200,
                 extra_headers: Optional[list] = None) -> Response:
    body = ('<?xml version="1.0" encoding="UTF-8"?>'
            + render_node(root)).encode()
    headers = [("content-type", "application/xml")] + (extra_headers or [])
    return Response(status, headers, body)


class S3Error(Exception):
    """ref: api/s3/error.rs — code + HTTP status + message."""

    def __init__(self, code: str, status: int, message: str = "",
                 resource: str = "", headers: Optional[list] = None):
        self.code = code
        self.status = status
        self.message = message or code
        self.resource = resource
        self.headers = headers or []
        super().__init__(f"{code}: {self.message}")

    def response(self) -> Response:
        return xml_response(
            xml("Error",
                xml("Code", self.code),
                xml("Message", self.message),
                xml("Resource", self.resource),
                xml("Region", "garage")),
            status=self.status,
            extra_headers=self.headers,
        )


def no_such_key(key: str = "") -> S3Error:
    return S3Error("NoSuchKey", 404, "The specified key does not exist.", key)


def no_such_bucket(name: str = "") -> S3Error:
    return S3Error("NoSuchBucket", 404,
                   "The specified bucket does not exist.", name)


def access_denied(msg: str = "Access Denied.") -> S3Error:
    return S3Error("AccessDenied", 403, msg)


def bad_request(msg: str) -> S3Error:
    return S3Error("InvalidRequest", 400, msg)


def slow_down(retry_after_header: str) -> S3Error:
    """Admission-control shed (ref: S3's real overload answer — code
    `SlowDown`, HTTP 503 — plus the standard Retry-After hint)."""
    return S3Error(
        "SlowDown", 503,
        "Please reduce your request rate.",
        headers=[("retry-after", retry_after_header)],
    )
