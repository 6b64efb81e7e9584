"""Copy of garage_tpu/api/s3/api_server.py: import paths rewritten, issue and PR tags dropped.

S3 API server: routing, auth, and dispatch.

Ref parity: src/api/s3/api_server.rs + router.rs:20-1109 (routing is by
method + path + query markers). Bucket addressing is path-style
(`/bucket/key...`) or vhost-style (`bucket.root_domain`).
"""

from __future__ import annotations

import logging
from typing import Optional

from ...model.helper import GarageHelper
from ...utils.error import (BadRequest, NoSuchBucket, NoSuchKey,
                            QuorumError)
from ..http import HttpError, HttpServer, Request, Response
from ...qos.limiter import CURRENT_QOS_KEY, SlowDown
from ..signature import claimed_key_id, verify_request, wrap_body
from . import bucket as bucket_handlers
from . import delete as delete_handlers
from . import get as get_handlers
from . import list as list_handlers
from . import lifecycle as lifecycle_handlers
from . import multipart as multipart_handlers
from . import put as put_handlers
from . import website as website_handlers
from .xml import S3Error, access_denied, no_such_bucket, slow_down

log = logging.getLogger("garage_tpu_torch.api.s3")


def declared_body_length(req: Request):
    """Body size a request admits to up front — the qos bytes-bucket
    charge. aws-chunked bodies declare the true payload size separately
    (raw content-length includes per-chunk framing); bodies with
    neither header are charged nothing here and shaped per-block on the
    streaming path instead (put.py Chunker)."""
    cl = (req.header("x-amz-decoded-content-length")
          or req.header("content-length"))
    return int(cl) if cl and cl.isdigit() else None


class ReqCtx:
    """Per-request context handed to handlers (ref: api_server.rs
    ReqCtx)."""

    __slots__ = ("garage", "bucket_id", "bucket_name", "bucket", "key",
                 "api_key", "verified")

    def __init__(self, garage, bucket_id, bucket_name, bucket, key,
                 api_key, verified):
        self.garage = garage
        self.bucket_id = bucket_id
        self.bucket_name = bucket_name
        self.bucket = bucket
        self.key = key  # object key (str) or None
        self.api_key = api_key
        self.verified = verified


class S3ApiServer:
    def __init__(self, garage, region: Optional[str] = None,
                 root_domain: Optional[str] = None):
        self.garage = garage
        self.helper = GarageHelper(garage)
        self.region = region or garage.config.s3_region
        self.root_domain = root_domain or garage.config.root_domain
        self.http = HttpServer(self.handle, name="s3")

    async def start(self, host: str, port=None,
                    reuse_port: bool = False) -> None:
        # a path (port None) binds a Unix-domain socket, like the
        # reference's UnixOrTCPSocketAddress bind addresses; reuse_port
        # is the gateway workers' SO_REUSEPORT shared accept loop
        if port is None:
            await self.http.start_unix(host)
        else:
            await self.http.start(host, port, reuse_port=reuse_port)

    async def stop(self) -> None:
        await self.http.stop()

    # ---- request entry -------------------------------------------------

    def _split_bucket_key(self, req: Request) -> tuple[Optional[str], Optional[str]]:
        host = (req.header("host") or "").split(":")[0]
        path = req.path.lstrip("/")
        if host.endswith(self.root_domain) and host != self.root_domain.lstrip("."):
            bucket = host[: -len(self.root_domain)]
            return bucket, (path or None)
        if not path:
            return None, None
        bucket, _, key = path.partition("/")
        return bucket, (key or None)

    async def handle(self, req: Request) -> Response:
        # one conn task serves many keep-alive requests: the fairness
        # key must never leak from one request into the next. Seeded
        # with the CLAIMED key id (no crypto) so the global request-
        # rate DRR can queue fairly BEFORE SigV4 runs; replaced by the
        # verified id once auth resolves.
        qos_key_token = CURRENT_QOS_KEY.set(claimed_key_id(req))
        try:
            # global admission (qos/): requests/s + declared body bytes
            # + bounded concurrency, BEFORE SigV4 — shedding must stay
            # cheap or overload melts the node doing auth for requests
            # it then rejects. Per-key/per-bucket stages run in _handle
            # once identity is resolved.
            qos = getattr(self.garage, "qos", None)
            if qos is None:
                return await self._handle(req)
            async with qos.admit("s3", nbytes=declared_body_length(req)):
                return await self._handle(req)
        except SlowDown as e:
            return slow_down(e.header_value()).response()
        except S3Error as e:
            return e.response()
        except HttpError as e:
            return S3Error("InvalidRequest", e.status, e.reason).response()
        except NoSuchBucket as e:
            return no_such_bucket(str(e)).response()
        except NoSuchKey as e:
            return S3Error("NoSuchKey", 404, str(e)).response()
        except BadRequest as e:
            return S3Error("InvalidRequest", 400, str(e)).response()
        except QuorumError as e:
            # not enough replicas answered (node overload, a partition,
            # or a gateway worker whose store is slow): a retryable 503,
            # not an "internal error" — SDKs back off and retry 503s
            return S3Error(
                "ServiceUnavailable", 503,
                f"quorum not reached: {e}").response()
        finally:
            CURRENT_QOS_KEY.reset(qos_key_token)

    async def _handle(self, req: Request) -> Response:
        verified = await verify_request(req, self.region,
                                        self.helper.key_secret)
        req.body = wrap_body(req, verified, self.region,
                             feeder=self.garage.block_manager.feeder)
        bucket_name, key = self._split_bucket_key(req)

        api_key = None
        if verified is not None:
            api_key = await self.helper.get_existing_key(verified.key_id)

        # per-key / per-bucket admission, now that identity is known
        # (raises qos SlowDown, translated to 503 by handle())
        qos = getattr(self.garage, "qos", None)
        if qos is not None:
            await qos.admit_scoped(
                key_id=api_key.key_id if api_key is not None else None,
                bucket=bucket_name)
        if api_key is not None:
            # fairness identity for every downstream byte charge (block
            # reads, chunk shaping); reset by handle() per request
            CURRENT_QOS_KEY.set(api_key.key_id)

        if bucket_name is None:
            if req.method == "GET":
                if api_key is None:
                    raise access_denied("authentication required")
                return await list_handlers.handle_list_buckets(
                    self.helper, api_key)
            raise S3Error("InvalidRequest", 400, "no bucket specified")

        # browser form upload: authentication lives in the signed POST
        # policy inside the form, not in headers (ref: post_object.rs)
        if req.method == "POST" and key is None and (
                req.header("content-type") or ""
        ).startswith("multipart/form-data"):
            from . import post_object as post_object_handlers

            return await post_object_handlers.handle_post_object(
                self, req, bucket_name)

        # CreateBucket resolves no existing bucket
        if req.method == "PUT" and key is None and not req.query:
            if api_key is None:
                raise access_denied("authentication required")
            return await bucket_handlers.handle_create_bucket(
                self.helper, bucket_name, api_key, self.region, req)

        bucket_id = await self.helper.resolve_global_bucket_name(bucket_name)
        if bucket_id is None:
            raise no_such_bucket(bucket_name)
        bucket = await self.helper.get_existing_bucket(bucket_id)

        # CORS preflight is unauthenticated by definition
        # (ref: api_server.rs handle_options_api)
        if req.method == "OPTIONS":
            return website_handlers.handle_options_for_bucket(
                req, bucket.params)

        try:
            # authorization (ref: api_server.rs:96-171)
            if api_key is not None:
                allowed = (api_key.allow_read(bucket_id)
                           if req.method in ("GET", "HEAD")
                           else api_key.allow_write(bucket_id))
                if req.method == "DELETE" and key is None:
                    allowed = api_key.allow_owner(bucket_id)
                # bucket config CRUD is owner-only (ref: api_server.rs
                # Endpoint::authorization_type Owner for website/cors/
                # lifecycle endpoints)
                if key is None and any(x in req.query for x in
                                       ("website", "cors", "lifecycle")):
                    allowed = api_key.allow_owner(bucket_id)
            else:
                allowed = False  # no anonymous access (web server differs)
            if not allowed:
                raise access_denied()

            ctx = ReqCtx(self.garage, bucket_id, bucket_name, bucket, key,
                         api_key, verified)
            resp = await self._route(req, ctx)
        except S3Error as e:
            # errors carry CORS headers too, or browsers turn a plain
            # 404 into an opaque network error (ref: cors.rs
            # add_cors_headers on the error path)
            resp = e.response()
        return website_handlers.apply_cors_to_response(req, bucket.params,
                                                       resp)

    # ---- router (ref: router.rs:20-1109) -------------------------------

    # subresources the reference's router recognizes but neither it nor
    # this build implements: answer 501 NotImplemented like the
    # reference (api_server.rs:66,332) instead of silently falling
    # through to GetObject/ListObjects with the wrong response shape
    _UNIMPLEMENTED_SUBRESOURCES = frozenset((
        "tagging", "acl", "policy", "policyStatus", "replication",
        "encryption", "notification", "accelerate", "requestPayment",
        "logging", "ownershipControls", "publicAccessBlock",
        "intelligent-tiering", "inventory", "metrics", "analytics",
        "object-lock", "legal-hold", "retention", "torrent", "restore",
        "select", "attributes",
    ))

    async def _route(self, req: Request, ctx: ReqCtx) -> Response:
        m, q = req.method, req.query
        for sub in self._UNIMPLEMENTED_SUBRESOURCES:
            if sub in q:
                raise S3Error("NotImplemented", 501, sub)
        if ctx.key is None:
            # bucket-level ops
            if m in ("GET", "HEAD"):
                if "uploads" in q:
                    return await list_handlers.handle_list_multipart_uploads(
                        ctx, req)
                if "location" in q:
                    return bucket_handlers.handle_get_bucket_location(
                        self.region)
                if "versioning" in q:
                    return bucket_handlers.handle_get_bucket_versioning()
                if "versions" in q:
                    return await list_handlers.handle_list_object_versions(
                        ctx, req)
                if "website" in q:
                    return await website_handlers.handle_get_bucket_website(
                        ctx)
                if "cors" in q:
                    return await website_handlers.handle_get_bucket_cors(ctx)
                if "lifecycle" in q:
                    return await lifecycle_handlers.handle_get_bucket_lifecycle(
                        ctx)
                if m == "HEAD":
                    return Response(200)
                if q.get("list-type") == "2":
                    return await list_handlers.handle_list_objects_v2(ctx, req)
                return await list_handlers.handle_list_objects_v1(ctx, req)
            if m == "PUT":
                if "website" in q:
                    return await website_handlers.handle_put_bucket_website(
                        ctx, req)
                if "cors" in q:
                    return await website_handlers.handle_put_bucket_cors(
                        ctx, req)
                if "lifecycle" in q:
                    return await lifecycle_handlers.handle_put_bucket_lifecycle(
                        ctx, req)
            if m == "DELETE":
                if "website" in q:
                    return await website_handlers.handle_delete_bucket_website(
                        ctx)
                if "cors" in q:
                    return await website_handlers.handle_delete_bucket_cors(
                        ctx)
                if "lifecycle" in q:
                    return await \
                        lifecycle_handlers.handle_delete_bucket_lifecycle(ctx)
                return await bucket_handlers.handle_delete_bucket(
                    self.helper, ctx)
            if m == "POST" and "delete" in q:
                return await delete_handlers.handle_delete_objects(ctx, req)
            raise S3Error("NotImplemented", 501,
                          f"unsupported bucket operation {m} {sorted(q)}")
        # object-level ops
        if m == "GET" or m == "HEAD":
            if "uploadId" in q:
                return await list_handlers.handle_list_parts(ctx, req)
            return await get_handlers.handle_get(ctx, req, head=(m == "HEAD"))
        if m == "PUT":
            if "partNumber" in q and "uploadId" in q:
                if "x-amz-copy-source" in req.headers:
                    return await multipart_handlers.handle_upload_part_copy(
                        ctx, req)
                return await multipart_handlers.handle_put_part(ctx, req)
            if "x-amz-copy-source" in req.headers:
                return await put_handlers.handle_copy(ctx, req)
            return await put_handlers.handle_put(ctx, req)
        if m == "POST":
            if "uploads" in q:
                return await multipart_handlers.handle_create_multipart(
                    ctx, req)
            if "uploadId" in q:
                return await multipart_handlers.handle_complete_multipart(
                    ctx, req)
        if m == "DELETE":
            if "uploadId" in q:
                return await multipart_handlers.handle_abort_multipart(
                    ctx, req)
            return await delete_handlers.handle_delete_object(ctx, req)
        raise S3Error("NotImplemented", 501, f"unsupported operation {m}")
