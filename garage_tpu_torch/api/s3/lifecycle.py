"""Copy of garage_tpu/api/s3/lifecycle.py: import paths rewritten, issue and PR tags dropped.

Bucket lifecycle configuration endpoints.

Ref parity: src/api/s3/lifecycle.rs — Get/Put/DeleteBucketLifecycle.
Rules are stored as the plain-structure payload documented in
model/bucket_table.py and executed by the daily lifecycle worker
(model/s3/lifecycle_worker.py). Supported actions: Expiration (days or
absolute date) and AbortIncompleteMultipartUpload; filters: Prefix and
object size bounds.
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET

from ...model.helper import GarageHelper
from ..http import Request, Response
from .xml import S3Error, xml, xml_response


def _strip_ns(tag: str) -> str:
    return tag.split("}", 1)[1] if tag.startswith("{") else tag


def _find(el, name):
    for child in el:
        if _strip_ns(child.tag) == name:
            return child
    return None


def _int(el, what: str) -> int:
    """Parse an integer element; malformed input is the client's fault
    (MalformedXML 400), never a 500."""
    try:
        return int((el.text or "").strip())
    except (TypeError, ValueError):
        raise S3Error("MalformedXML", 400, f"bad integer in {what}")


async def handle_get_bucket_lifecycle(ctx) -> Response:
    rules = ctx.bucket.params.lifecycle_config.value
    if not rules:
        raise S3Error("NoSuchLifecycleConfiguration", 404,
                      "The lifecycle configuration does not exist")
    out = []
    for r in rules:
        children = []
        if r.get("id"):
            children.append(xml("ID", r["id"]))
        children.append(xml("Status",
                            "Enabled" if r.get("enabled", True)
                            else "Disabled"))
        f = r.get("filter") or {}
        fchildren = []
        if f.get("prefix"):
            fchildren.append(xml("Prefix", f["prefix"]))
        if f.get("size_gt") is not None:
            fchildren.append(xml("ObjectSizeGreaterThan", str(f["size_gt"])))
        if f.get("size_lt") is not None:
            fchildren.append(xml("ObjectSizeLessThan", str(f["size_lt"])))
        children.append(xml("Filter", *fchildren))
        if r.get("abort_incomplete_mpu_days") is not None:
            children.append(xml(
                "AbortIncompleteMultipartUpload",
                xml("DaysAfterInitiation",
                    str(r["abort_incomplete_mpu_days"]))))
        exp = r.get("expiration")
        if exp is not None:
            if isinstance(exp, int):
                children.append(xml("Expiration", xml("Days", str(exp))))
            else:
                children.append(xml("Expiration", xml("Date", exp)))
        out.append(xml("Rule", *children))
    return xml_response(xml(
        "LifecycleConfiguration", *out,
        xmlns="http://s3.amazonaws.com/doc/2006-03-01/"))


async def handle_put_bucket_lifecycle(ctx, req: Request) -> Response:
    body = await req.body.read_all(limit=1 << 20)
    try:
        root = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError):
        raise S3Error("MalformedXML", 400, "cannot parse request body")
    rules = []
    for rule in root:
        if _strip_ns(rule.tag) != "Rule":
            continue
        r = {"id": None, "enabled": True, "filter": {},
             "abort_incomplete_mpu_days": None, "expiration": None}
        idel = _find(rule, "ID")
        if idel is not None:
            r["id"] = (idel.text or "").strip()
        st = _find(rule, "Status")
        if st is None or (st.text or "").strip() not in ("Enabled",
                                                         "Disabled"):
            raise S3Error("MalformedXML", 400,
                          "Rule.Status must be Enabled or Disabled")
        r["enabled"] = st.text.strip() == "Enabled"
        flt = _find(rule, "Filter")
        if flt is not None:
            inner = _find(flt, "And") or flt
            p = _find(inner, "Prefix")
            if p is not None and p.text:
                r["filter"]["prefix"] = p.text
            gt = _find(inner, "ObjectSizeGreaterThan")
            if gt is not None:
                r["filter"]["size_gt"] = _int(gt, "ObjectSizeGreaterThan")
            lt = _find(inner, "ObjectSizeLessThan")
            if lt is not None:
                r["filter"]["size_lt"] = _int(lt, "ObjectSizeLessThan")
        # legacy top-level Prefix
        p = _find(rule, "Prefix")
        if p is not None and p.text:
            r["filter"]["prefix"] = p.text
        ab = _find(rule, "AbortIncompleteMultipartUpload")
        if ab is not None:
            days = _find(ab, "DaysAfterInitiation")
            if days is None:
                raise S3Error("MalformedXML", 400,
                              "DaysAfterInitiation is required")
            r["abort_incomplete_mpu_days"] = _int(days,
                                                  "DaysAfterInitiation")
        exp = _find(rule, "Expiration")
        if exp is not None:
            days = _find(exp, "Days")
            date = _find(exp, "Date")
            if days is not None:
                r["expiration"] = _int(days, "Expiration.Days")
                if r["expiration"] <= 0:
                    raise S3Error("MalformedXML", 400,
                                  "Expiration.Days must be positive")
            elif date is not None:
                txt = (date.text or "").strip()
                try:
                    datetime.date.fromisoformat(txt[:10])
                except ValueError:
                    raise S3Error("MalformedXML", 400,
                                  "bad Expiration.Date")
                r["expiration"] = txt[:10]
            else:
                raise S3Error("MalformedXML", 400,
                              "Expiration needs Days or Date")
        rules.append(r)
    if not rules:
        # an empty configuration must not act as a silent delete
        raise S3Error("MalformedXML", 400, "no Rule in configuration")
    await GarageHelper(ctx.garage).update_bucket_config(
        ctx.bucket_id, "lifecycle_config", rules)
    return Response(200)


async def handle_delete_bucket_lifecycle(ctx) -> Response:
    await GarageHelper(ctx.garage).update_bucket_config(
        ctx.bucket_id, "lifecycle_config", None)
    return Response(204)
