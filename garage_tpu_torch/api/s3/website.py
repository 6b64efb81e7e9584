"""Copy of garage_tpu/api/s3/website.py: import paths rewritten, issue and PR tags dropped.

Bucket website + CORS configuration endpoints, and CORS evaluation.

Ref parity: src/api/s3/website.rs (Get/Put/DeleteBucketWebsite) and
src/api/s3/cors.rs (Get/Put/DeleteBucketCors + rule matching applied by
the web server and to cross-origin API requests). Configs live as Lww
registers in the bucket params (model/bucket_table.py plain-structure
payloads).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Optional

from ...model.helper import GarageHelper
from ..http import Request, Response
from .xml import S3Error, xml, xml_response

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _strip_ns(tag: str) -> str:
    return tag.split("}", 1)[1] if tag.startswith("{") else tag


# ---------------------------------------------------------------------------
# Website config CRUD (ref: website.rs)
# ---------------------------------------------------------------------------


async def handle_get_bucket_website(ctx) -> Response:
    cfg = ctx.bucket.params.website_config.value
    if cfg is None:
        raise S3Error("NoSuchWebsiteConfiguration", 404,
                      "The specified bucket does not have a website "
                      "configuration")
    children = [xml("IndexDocument", xml("Suffix", cfg["index_document"]))]
    if cfg.get("error_document"):
        children.append(xml("ErrorDocument", xml("Key",
                                                 cfg["error_document"])))
    return xml_response(xml(
        "WebsiteConfiguration", *children,
        xmlns="http://s3.amazonaws.com/doc/2006-03-01/"))


async def handle_put_bucket_website(ctx, req: Request) -> Response:
    body = await req.body.read_all(limit=1 << 20)
    try:
        root = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError):
        raise S3Error("MalformedXML", 400, "cannot parse request body")
    if _strip_ns(root.tag) != "WebsiteConfiguration":
        raise S3Error("MalformedXML", 400, "expected WebsiteConfiguration")
    index = root.find(f"{_NS}IndexDocument/{_NS}Suffix")
    if index is None:
        index = root.find("IndexDocument/Suffix")
    # ref: website.rs — redirect_all_requests_to is rejected as
    # unimplemented; an index document is required
    if root.find(f"{_NS}RedirectAllRequestsTo") is not None \
            or root.find("RedirectAllRequestsTo") is not None:
        raise S3Error("NotImplemented", 501,
                      "RedirectAllRequestsTo is not implemented")
    if index is None or not (index.text or "").strip():
        raise S3Error("InvalidArgument", 400,
                      "IndexDocument.Suffix is required")
    err = root.find(f"{_NS}ErrorDocument/{_NS}Key")
    if err is None:
        err = root.find("ErrorDocument/Key")
    cfg = {"index_document": index.text.strip(),
           "error_document": (err.text.strip() if err is not None
                              and err.text else None)}
    await GarageHelper(ctx.garage).update_bucket_config(
        ctx.bucket_id, "website_config", cfg)
    return Response(200)


async def handle_delete_bucket_website(ctx) -> Response:
    await GarageHelper(ctx.garage).update_bucket_config(
        ctx.bucket_id, "website_config", None)
    return Response(204)


# ---------------------------------------------------------------------------
# CORS config CRUD (ref: cors.rs)
# ---------------------------------------------------------------------------


async def handle_get_bucket_cors(ctx) -> Response:
    rules = ctx.bucket.params.cors_config.value
    if not rules:
        raise S3Error("NoSuchCORSConfiguration", 404,
                      "The CORS configuration does not exist")
    out = []
    for r in rules:
        children = []
        if r.get("id"):
            children.append(xml("ID", r["id"]))
        for o in r.get("allow_origins", []):
            children.append(xml("AllowedOrigin", o))
        for m in r.get("allow_methods", []):
            children.append(xml("AllowedMethod", m))
        for h in r.get("allow_headers", []):
            children.append(xml("AllowedHeader", h))
        for h in r.get("expose_headers", []):
            children.append(xml("ExposeHeader", h))
        if r.get("max_age_seconds") is not None:
            children.append(xml("MaxAgeSeconds", str(r["max_age_seconds"])))
        out.append(xml("CORSRule", *children))
    return xml_response(xml(
        "CORSConfiguration", *out,
        xmlns="http://s3.amazonaws.com/doc/2006-03-01/"))


async def handle_put_bucket_cors(ctx, req: Request) -> Response:
    body = await req.body.read_all(limit=1 << 20)
    try:
        root = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError):
        raise S3Error("MalformedXML", 400, "cannot parse request body")
    rules = []
    for rule in root:
        if _strip_ns(rule.tag) != "CORSRule":
            continue
        r = {"id": None, "max_age_seconds": None, "allow_origins": [],
             "allow_methods": [], "allow_headers": [], "expose_headers": []}
        for el in rule:
            tag, text = _strip_ns(el.tag), (el.text or "").strip()
            if tag == "ID":
                r["id"] = text
            elif tag == "AllowedOrigin":
                r["allow_origins"].append(text)
            elif tag == "AllowedMethod":
                r["allow_methods"].append(text)
            elif tag == "AllowedHeader":
                r["allow_headers"].append(text.lower())
            elif tag == "ExposeHeader":
                r["expose_headers"].append(text)
            elif tag == "MaxAgeSeconds":
                try:
                    r["max_age_seconds"] = int(text)
                except ValueError:
                    raise S3Error("MalformedXML", 400, "bad MaxAgeSeconds")
        if not r["allow_origins"] or not r["allow_methods"]:
            raise S3Error("MalformedXML", 400,
                          "CORSRule needs AllowedOrigin and AllowedMethod")
        rules.append(r)
    if not rules:
        raise S3Error("MalformedXML", 400, "no CORSRule in configuration")
    await GarageHelper(ctx.garage).update_bucket_config(
        ctx.bucket_id, "cors_config", rules)
    return Response(200)


async def handle_delete_bucket_cors(ctx) -> Response:
    await GarageHelper(ctx.garage).update_bucket_config(
        ctx.bucket_id, "cors_config", None)
    return Response(204)


# ---------------------------------------------------------------------------
# CORS rule evaluation (ref: cors.rs find_matching_cors_rule,
# add_cors_headers, handle_options_for_bucket)
# ---------------------------------------------------------------------------


def _origin_matches(patterns: list[str], origin: str) -> bool:
    for p in patterns:
        if p == "*" or p == origin:
            return True
        if "*" in p:
            pre, _, suf = p.partition("*")
            if origin.startswith(pre) and origin.endswith(suf) \
                    and len(origin) >= len(pre) + len(suf):
                return True
    return False


def find_matching_cors_rule(bucket_params, origin: str, method: str,
                            request_headers: list[str]) -> Optional[dict]:
    rules = bucket_params.cors_config.value or []
    for r in rules:
        if not _origin_matches(r.get("allow_origins", []), origin):
            continue
        methods = r.get("allow_methods", [])
        if "*" not in methods and method not in methods:
            continue
        allowed = r.get("allow_headers", [])
        if "*" not in allowed:
            if any(h.lower() not in allowed for h in request_headers):
                continue
        return r
    return None


def cors_headers(rule: dict, origin: str) -> list[tuple[str, str]]:
    out = [("access-control-allow-origin",
            "*" if "*" in rule.get("allow_origins", []) else origin),
           ("access-control-allow-methods",
            ", ".join(rule.get("allow_methods", []) or ["*"]))]
    if rule.get("allow_headers"):
        out.append(("access-control-allow-headers",
                    ", ".join(rule["allow_headers"])))
    if rule.get("expose_headers"):
        out.append(("access-control-expose-headers",
                    ", ".join(rule["expose_headers"])))
    if rule.get("max_age_seconds") is not None:
        out.append(("access-control-max-age",
                    str(rule["max_age_seconds"])))
    if "*" not in rule.get("allow_origins", []):
        out.append(("vary", "Origin"))
    return out


def handle_options_for_bucket(req: Request, bucket_params) -> Response:
    """CORS preflight against a bucket (ref: cors.rs
    handle_options_for_bucket)."""
    origin = req.header("origin")
    if origin is None:
        raise S3Error("BadRequest", 400, "Missing Origin header")
    method = req.header("access-control-request-method")
    if method is None:
        raise S3Error("BadRequest", 400,
                      "Missing Access-Control-Request-Method header")
    req_headers = [h.strip() for h in
                   (req.header("access-control-request-headers") or ""
                    ).split(",") if h.strip()]
    rule = find_matching_cors_rule(bucket_params, origin, method,
                                   req_headers)
    if rule is None:
        raise S3Error("AccessDenied", 403, "This CORS request is not allowed")
    return Response(200, cors_headers(rule, origin))


def apply_cors_to_response(req: Request, bucket_params,
                           resp: Response) -> Response:
    """Attach CORS headers to an actual (non-preflight) response when a
    rule matches (ref: cors.rs add_cors_headers call sites)."""
    origin = req.header("origin")
    if origin is None or bucket_params is None:
        return resp
    rule = find_matching_cors_rule(bucket_params, origin, req.method, [])
    if rule is not None:
        have = {n.lower() for n, _ in resp.headers}
        for n, v in cors_headers(rule, origin):
            if n not in have:
                resp.headers.append((n, v))
    return resp
