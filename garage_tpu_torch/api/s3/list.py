"""Copy of garage_tpu/api/s3/list.py: import paths rewritten, issue and PR tags dropped.

Listing endpoints: ListBuckets, ListObjects v1/v2, uploads, parts.

Ref parity: src/api/s3/list.rs (the pagination state machine) — here
the range reads page through the object table per partition key with
prefix / delimiter / common-prefix folding and continuation tokens.
"""

from __future__ import annotations

import base64
import logging
from typing import Optional

from ..http import Request, Response
from .get import http_date
from .xml import S3Error, xml, xml_response

log = logging.getLogger("garage_tpu_torch.api.s3.list")

PAGE = 1000
# rows fetched right after a delimiter skip-seek: in prefix-heavy
# layouts the very next row folds into a new common prefix, so a full
# PAGE fetch per distinct prefix would re-create the O(keys) cost the
# skip-scan removed. A small probe keeps per-prefix cost ~constant; a
# probe that comes back fold-free falls back to full pages.
DELIM_PROBE = 16


def _enc_token(s: str) -> str:
    return base64.urlsafe_b64encode(s.encode()).decode()


def _dec_token(s: str) -> str:
    try:
        return base64.urlsafe_b64decode(s.encode()).decode()
    except Exception:
        raise S3Error("InvalidArgument", 400, "bad continuation token")


def _encoder(q):
    """encoding-type=url -> (percent-encoder, True); SDKs (boto3 et
    al.) request it by default so keys with arbitrary bytes survive
    XML (ref: list.rs uriencode_maybe). Unknown values are a 400."""
    enc = q.get("encoding-type")
    if enc in (None, ""):
        return (lambda s: s), False
    if enc != "url":
        raise S3Error("InvalidArgument", 400, "bad encoding-type")
    from urllib.parse import quote

    return (lambda s: quote(s, safe="/")), True


def _page_size(q, name: str, lo: int = 1) -> int:
    """Validated page-size query param, clamped to <=1000. Values < lo
    are a 400: a 0-size page with IsTruncated=true and a non-advancing
    marker would loop paginating clients forever."""
    raw = q.get(name)
    if raw in (None, ""):
        return 1000
    try:
        v = int(raw)
    except ValueError:
        raise S3Error("InvalidArgument", 400, f"bad {name}")
    if v < lo:
        raise S3Error("InvalidArgument", 400, f"{name} must be >= {lo}")
    return min(v, 1000)


async def handle_list_buckets(helper, api_key) -> Response:
    """ref: api/s3/bucket.rs handle_list_buckets — buckets this key may
    read, with their global aliases."""
    aliases = await helper.list_buckets(limit=10000)
    entries = []
    for a in aliases:
        if a.bucket_id is None:
            continue
        if not (api_key.allow_read(a.bucket_id)
                or api_key.allow_owner(a.bucket_id)):
            continue
        try:
            b = await helper.get_existing_bucket(a.bucket_id)
        except Exception as e:
            # alias row pointing at a deleted/ghost bucket: skip it,
            # but not silently (Aspirator/GL05)
            log.debug("ListBuckets: alias %s -> %s unresolvable: %s",
                      a.name, a.bucket_id.hex()[:8], e)
            continue
        created = b.params.creation_date if b.params else 0
        entries.append(xml("Bucket",
                           xml("Name", a.name),
                           xml("CreationDate", _iso(created))))
    return xml_response(
        xml("ListAllMyBucketsResult",
            xml("Owner", xml("ID", api_key.key_id),
                xml("DisplayName", api_key.params.name.value
                    if api_key.params else "")),
            xml("Buckets", *entries)))


def _iso(ts_msec: int) -> str:
    import datetime

    return datetime.datetime.fromtimestamp(
        ts_msec / 1000, datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%S.000Z")


def _marker_is_folded_prefix(marker: str, prefix: str,
                             delimiter: str) -> bool:
    """True when a NextMarker/NextKeyMarker names a folded common
    prefix. A folded prefix is always `prefix + <nonempty> + delimiter`
    — a marker that merely ends with the delimiter (e.g. equal to the
    request prefix, or outside its window) must resume key-by-key, or
    the ("p",...) cursor would seek past the entire prefix window and
    return an empty page."""
    return (bool(delimiter) and marker.endswith(delimiter)
            and marker.startswith(prefix) and len(marker) > len(prefix))


def _prefix_upper_bound(b: bytes):
    bb = bytearray(b)
    while bb:
        if bb[-1] != 0xFF:
            bb[-1] += 1
            return bytes(bb)
        bb.pop()
    return None


async def _collect_objects(ctx, prefix: str, resume, delimiter: str,
                           max_keys: int):
    """Shared lister. `resume` is None or ("k", last_key) /
    ("p", last_common_prefix) — the last item the previous page
    returned. Folds keys under `delimiter` into common prefixes.
    Returns (contents, common_prefixes, next_token, truncated).

    Delimiter skip-scan: the moment a key folds into a common
    prefix, the cursor jumps straight to the prefix's upper bound
    instead of consuming every key under it — one engine seek per
    DISTINCT prefix, so a page over a bucket with a million keys under
    `photos/` costs O(distinct prefixes) range reads, not O(keys)."""
    garage = ctx.garage
    contents = []  # (key, ObjectVersion) rows
    prefixes: set[str] = set()
    last_token = None  # last RETURNED item, for the continuation token

    probe = False
    if resume is None:
        sk = prefix.encode() if prefix else None
    elif resume[0] == "p":
        # skip everything under the already-returned common prefix
        sk = _prefix_upper_bound(resume[1].encode())
        if sk is None:
            return contents, [], None, False
        probe = True  # next row most likely folds again
    else:
        sk = resume[1].encode() + b"\x00"
    while True:
        lim = DELIM_PROBE if probe else PAGE
        entries = await garage.object_table.get_range(
            ctx.bucket_id, start_sk=sk, flt={"type": "data"}, limit=lim,
        )
        if not entries:
            return contents, sorted(prefixes), None, False
        reseek = False
        for o in entries:
            key = o.key
            sk = key.encode() + b"\x00"
            if not key.startswith(prefix):
                if key > prefix:  # past the prefix window: done
                    return contents, sorted(prefixes), None, False
                continue
            if delimiter:
                rest = key[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    if cp not in prefixes:
                        if len(contents) + len(prefixes) >= max_keys:
                            return (contents, sorted(prefixes),
                                    last_token, True)
                        prefixes.add(cp)
                        last_token = ("p", cp)
                    # skip-scan: every remaining key under cp folds into
                    # the prefix just recorded — seek past all of them
                    sk = _prefix_upper_bound(cp.encode())
                    if sk is None:
                        return contents, sorted(prefixes), None, False
                    reseek = True
                    break
            v = o.last_data()
            if v is None:
                continue
            if len(contents) + len(prefixes) >= max_keys:
                return contents, sorted(prefixes), last_token, True
            contents.append((key, v))
            last_token = ("k", key)
        if reseek:
            probe = True
            continue
        if len(entries) < lim:
            return contents, sorted(prefixes), None, False
        probe = False  # a fold-free page: back to full pages


async def handle_list_objects_v2(ctx, req: Request) -> Response:
    q = req.query
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter", "")
    max_keys = _page_size(q, "max-keys", lo=0)
    token = q.get("continuation-token")
    start_after = q.get("start-after", "")
    if token:
        raw = _dec_token(token)
        resume = (raw[:1], raw[1:]) if raw[:1] in ("k", "p") else None
    elif start_after:
        resume = ("k", start_after)
    else:
        resume = None
    if max_keys == 0:  # AWS: empty page, never truncated
        contents, prefixes, next_token, truncated = [], [], None, False
    else:
        contents, prefixes, next_token, truncated = await _collect_objects(
            ctx, prefix, resume, delimiter, max_keys)

    enc, encoded = _encoder(q)
    nodes = [xml("Name", ctx.bucket_name), xml("Prefix", enc(prefix)),
             xml("KeyCount", str(len(contents) + len(prefixes))),
             xml("MaxKeys", str(max_keys)),
             xml("IsTruncated", "true" if truncated else "false")]
    if encoded:
        nodes.append(xml("EncodingType", "url"))
    if delimiter:
        nodes.append(xml("Delimiter", enc(delimiter)))
    if truncated and next_token is not None:
        nodes.append(xml("NextContinuationToken",
                         _enc_token(next_token[0] + next_token[1])))
    for key, v in contents:
        nodes.append(xml("Contents",
                         xml("Key", enc(key)),
                         xml("LastModified", _iso(v.timestamp)),
                         xml("ETag", f'"{v.state.data.meta.etag}"'),
                         xml("Size", str(v.state.data.meta.size)),
                         xml("StorageClass", "STANDARD")))
    for cp in prefixes:
        nodes.append(xml("CommonPrefixes", xml("Prefix", enc(cp))))
    return xml_response(xml("ListBucketResult", *nodes))


async def handle_list_objects_v1(ctx, req: Request) -> Response:
    q = req.query
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter", "")
    max_keys = _page_size(q, "max-keys", lo=0)
    marker = q.get("marker", "")
    if marker and _marker_is_folded_prefix(marker, prefix, delimiter):
        resume = ("p", marker)  # marker was a folded common prefix
    elif marker:
        resume = ("k", marker)
    else:
        resume = None
    if max_keys == 0:  # AWS: empty page, never truncated
        contents, prefixes, next_token, truncated = [], [], None, False
    else:
        contents, prefixes, next_token, truncated = await _collect_objects(
            ctx, prefix, resume, delimiter, max_keys)
    enc, encoded = _encoder(q)
    nodes = [xml("Name", ctx.bucket_name), xml("Prefix", enc(prefix)),
             xml("Marker", enc(marker)), xml("MaxKeys", str(max_keys)),
             xml("IsTruncated", "true" if truncated else "false")]
    if encoded:
        nodes.append(xml("EncodingType", "url"))
    if delimiter:
        nodes.append(xml("Delimiter", enc(delimiter)))
    if truncated and next_token:
        nodes.append(xml("NextMarker", enc(next_token[1])))
    for key, v in contents:
        nodes.append(xml("Contents",
                         xml("Key", enc(key)),
                         xml("LastModified", _iso(v.timestamp)),
                         xml("ETag", f'"{v.state.data.meta.etag}"'),
                         xml("Size", str(v.state.data.meta.size)),
                         xml("StorageClass", "STANDARD")))
    for cp in prefixes:
        nodes.append(xml("CommonPrefixes", xml("Prefix", enc(cp))))
    return xml_response(xml("ListBucketResult", *nodes))


async def _collect_uploads(ctx, prefix: str, resume, delimiter: str,
                           max_uploads: int):
    """Upload lister with full marker pagination (ref: list.rs:628-650
    ListMultipartUploadsQuery::begin + UploadAccumulator).

    `resume` is None or a cursor:
      ("k", key)        — start strictly after `key`
      ("p", cprefix)    — start past every key under `cprefix`
      ("i", key)        — start AT `key`, all of its uploads
      ("u", key, uuid)  — start AT `key`, uploads with id > `uuid`
    An object may hold several concurrent uploads (one uploading
    version each); same-key uploads are returned in lexicographic
    upload-id order, so ("u", ...) resumes mid-key losslessly.
    Returns (uploads, common_prefixes, next_cursor, truncated) where
    uploads is [(key, version)] and next_cursor follows the same
    cursor grammar (its key becomes NextKeyMarker; a ("u",...) or
    ("i",...) cursor additionally yields NextUploadIdMarker).

    Folded prefixes skip-scan exactly like _collect_objects: one
    engine seek past the whole prefix instead of consuming each key."""
    garage = ctx.garage
    ups = []
    prefixes: set[str] = set()
    last_cursor = resume  # scan position after the last consumed item

    after_uuid = None
    marker_key = None
    if resume is None:
        sk = prefix.encode() if prefix else None
    elif resume[0] == "k":
        sk = resume[1].encode() + b"\x00"
    elif resume[0] == "p":
        sk = _prefix_upper_bound(resume[1].encode())
        if sk is None:
            return ups, [], None, False
    else:  # "i" / "u": re-read the marker key itself
        sk = resume[1].encode()
        if resume[0] == "u":
            marker_key = resume[1]
            try:
                after_uuid = bytes.fromhex(resume[2])
            except ValueError:
                raise S3Error("InvalidArgument", 400, "bad upload-id-marker")

    def full() -> bool:
        return len(ups) + len(prefixes) >= max_uploads

    probe = resume is not None and resume[0] == "p"
    while True:
        lim = DELIM_PROBE if probe else PAGE
        entries = await garage.object_table.get_range(
            ctx.bucket_id, start_sk=sk,
            flt={"type": "uploading", "multipart": True}, limit=lim,
            prefix_sk=prefix.encode() if prefix else None,
        )
        if not entries:
            return ups, sorted(prefixes), None, False
        reseek = False
        for o in entries:
            key = o.key
            sk = key.encode() + b"\x00"
            if not key.startswith(prefix):
                if key > prefix:  # past the prefix window: done
                    return ups, sorted(prefixes), None, False
                continue
            if delimiter:
                rest = key[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    if cp not in prefixes:
                        if full():
                            return ups, sorted(prefixes), last_cursor, True
                        prefixes.add(cp)
                    # skip-scan past every key under the folded prefix;
                    # the cursor records the prefix itself so a page
                    # that fills right here resumes past all of it
                    last_cursor = ("p", cp)
                    sk = _prefix_upper_bound(cp.encode())
                    if sk is None:
                        return ups, sorted(prefixes), None, False
                    reseek = True
                    break
            vs = sorted((v for v in o.versions if v.is_uploading(True)),
                        key=lambda v: v.uuid)
            if after_uuid is not None and key == marker_key:
                vs = [v for v in vs if v.uuid > after_uuid]
            placed_any = False
            for v in vs:
                if full():
                    return ups, sorted(prefixes), last_cursor, True
                ups.append((key, v))
                last_cursor = ("u", key, v.uuid.hex())
                placed_any = True
            if not placed_any:
                last_cursor = ("k", key)
        if reseek:
            probe = True
            continue
        if len(entries) < lim:
            return ups, sorted(prefixes), None, False
        probe = False  # a fold-free page: back to full pages


async def handle_list_object_versions(ctx, req: Request) -> Response:
    """GET ?versions. Buckets are unversioned (like the reference,
    whose router parses this endpoint but never implements it —
    router.rs:964 with no handler): every live object is exactly one
    Version with VersionId "null" and IsLatest true, the AWS contract
    for unversioned buckets, so version-aware clients (rclone, backup
    tools) work against this store. Pagination mirrors ListObjects
    (key-marker; version-id-marker is trivially satisfied at one
    version per key)."""
    q = req.query
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter", "")
    max_keys = _page_size(q, "max-keys", lo=0)
    key_marker = q.get("key-marker")
    if key_marker and _marker_is_folded_prefix(key_marker, prefix,
                                               delimiter):
        # the previous page ended on a folded common prefix (same
        # convention as v1/uploads): resume past the whole prefix,
        # or page 2 re-emits the same CommonPrefixes entry
        resume = ("p", key_marker)
    elif key_marker:
        resume = ("k", key_marker)
    else:
        resume = None
    if max_keys == 0:
        contents, prefixes, next_token, truncated = [], [], None, False
    else:
        contents, prefixes, next_token, truncated = await _collect_objects(
            ctx, prefix, resume, delimiter, max_keys)
    enc, encoded = _encoder(q)
    nodes = [xml("Name", ctx.bucket_name), xml("Prefix", enc(prefix)),
             xml("MaxKeys", str(max_keys)),
             xml("IsTruncated", "true" if truncated else "false")]
    if encoded:
        nodes.append(xml("EncodingType", "url"))
    if key_marker:
        nodes.append(xml("KeyMarker", enc(key_marker)))
    if delimiter:
        nodes.append(xml("Delimiter", enc(delimiter)))
    if truncated and next_token is not None:
        nodes.append(xml("NextKeyMarker", enc(next_token[1])))
        nodes.append(xml("NextVersionIdMarker", "null"))
    for key, v in contents:
        nodes.append(xml("Version",
                         xml("Key", enc(key)),
                         xml("VersionId", "null"),
                         xml("IsLatest", "true"),
                         xml("LastModified", _iso(v.timestamp)),
                         xml("ETag", f'"{v.state.data.meta.etag}"'),
                         xml("Size", str(v.state.data.meta.size)),
                         xml("StorageClass", "STANDARD")))
    for cp in prefixes:
        nodes.append(xml("CommonPrefixes", xml("Prefix", enc(cp))))
    return xml_response(xml("ListVersionsResult", *nodes))


async def handle_list_multipart_uploads(ctx, req: Request) -> Response:
    """ref: list.rs:169-265 handle_list_multipart_upload. Markers:
    key-marker alone starts after that key; with upload-id-marker it
    starts at that key after that upload id; the reference's "include"
    sentinel (an impossible hex id) means "at the key, first upload"
    and is emitted when a page fills right at a key boundary."""
    q = req.query
    prefix = q.get("prefix", "")
    delimiter = q.get("delimiter", "")
    max_uploads = _page_size(q, "max-uploads")
    key_marker = q.get("key-marker")
    upload_id_marker = q.get("upload-id-marker")
    if key_marker is not None and upload_id_marker:
        if upload_id_marker == "include":
            resume = ("i", key_marker)
        else:
            resume = ("u", key_marker, upload_id_marker)
    elif key_marker is not None:
        if _marker_is_folded_prefix(key_marker, prefix, delimiter):
            # the previous page ended on a folded common prefix (same
            # convention as ListObjects v1): resume past the whole
            # prefix, not key-by-key under it
            resume = ("p", key_marker)
        else:
            resume = ("k", key_marker)
    else:
        resume = None
    ups, prefixes, next_cursor, truncated = await _collect_uploads(
        ctx, prefix, resume, delimiter, max_uploads)

    enc, encoded = _encoder(q)
    nodes = [xml("Bucket", ctx.bucket_name), xml("Prefix", enc(prefix)),
             xml("MaxUploads", str(max_uploads)),
             xml("IsTruncated", "true" if truncated else "false")]
    if encoded:
        nodes.append(xml("EncodingType", "url"))
    if delimiter:
        nodes.append(xml("Delimiter", enc(delimiter)))
    if key_marker is not None:
        nodes.append(xml("KeyMarker", enc(key_marker)))
    if upload_id_marker:
        nodes.append(xml("UploadIdMarker", upload_id_marker))
    if truncated and next_cursor is not None:
        nodes.append(xml("NextKeyMarker", enc(next_cursor[1])))
        if next_cursor[0] == "u":
            nodes.append(xml("NextUploadIdMarker", next_cursor[2]))
        elif next_cursor[0] == "i":
            nodes.append(xml("NextUploadIdMarker", "include"))
    for key, v in ups:
        nodes.append(xml("Upload",
                         xml("Key", enc(key)),
                         xml("UploadId", v.uuid.hex()),
                         xml("Initiated", _iso(v.timestamp))))
    for cp in prefixes:
        nodes.append(xml("CommonPrefixes", xml("Prefix", enc(cp))))
    return xml_response(xml("ListMultipartUploadsResult", *nodes))


async def handle_list_parts(ctx, req: Request) -> Response:
    """ref: list.rs:274-311 handle_list_parts + fetch_part_info
    (list.rs:512-558): newest record per part number, cut below the
    marker, NextPartNumberMarker when the page fills."""
    upload_id = req.query.get("uploadId", "")
    from .multipart import _get_upload

    # 404s aborted/completed uploads too, not just unknown ids
    mpu, _ov = await _get_upload(ctx, upload_id)
    marker = int(req.query.get("part-number-marker", "0") or 0)
    max_parts = _page_size(req.query, "max-parts")
    # newest record per part number with a finished etag
    best = {}
    for (pn, ts), part in mpu.parts.items():
        if part.etag is not None and pn > marker:
            if pn not in best or ts > best[pn][0]:
                best[pn] = (ts, part)
    all_parts = sorted(best.items())
    truncated = len(all_parts) > max_parts
    parts = all_parts[:max_parts]
    nodes = [xml("Bucket", ctx.bucket_name), xml("Key", ctx.key),
             xml("UploadId", upload_id),
             xml("PartNumberMarker", str(marker)),
             xml("MaxParts", str(max_parts)),
             xml("IsTruncated", "true" if truncated else "false")]
    if truncated:
        nodes.append(xml("NextPartNumberMarker", str(parts[-1][0])))
    for pn, (_ts, part) in parts:
        nodes.append(xml("Part",
                         xml("PartNumber", str(pn)),
                         xml("ETag", f'"{part.etag}"'),
                         xml("Size", str(part.size or 0))))
    return xml_response(xml("ListPartsResult", *nodes))
