"""Copy of garage_tpu/web/server.py: import paths rewritten, issue and PR tags dropped.

WebServer: anonymous static-website serving of buckets.

Ref parity: src/web/web_server.rs:70-450. Requests address a bucket by
vhost (`{bucket}.{web_root_domain}` — or any alias/custom domain that
resolves as a global bucket alias). The bucket must have a website
configuration; GET/HEAD reuse the S3 object read path without
authentication, OPTIONS evaluates the bucket's CORS rules, and errors
render the configured error document. Folder-style paths follow the
S3 website rules (web_server.rs:420-447 path_to_keys): a trailing slash
serves `{path}{index}`, no trailing slash 302-redirects to `{path}/`
when `{path}/{index}` exists.
"""

from __future__ import annotations

import logging
from typing import Optional
from urllib.parse import unquote

from ..api.http import HttpServer, Request, Response
from ..api.s3 import get as get_handlers
from ..api.s3 import website as website_handlers
from ..api.s3.api_server import ReqCtx
from ..api.s3.xml import S3Error
from ..model.helper import GarageHelper

log = logging.getLogger("garage_tpu_torch.web")


def path_to_keys(path: str, index: str) -> tuple[str, Optional[tuple[str, str]]]:
    """-> (key to serve, implicit redirect (key, url) or None).
    ref: web_server.rs:420-447."""
    decoded = unquote(path)
    if not decoded.startswith("/"):
        raise S3Error("InvalidRequest", 400, "path must start with /")
    base_key = decoded[1:]
    if not base_key:
        return index, None
    if decoded.endswith("/"):
        return base_key + index, None
    return base_key, (f"{base_key}/{index}", f"{path}/")


class WebServer:
    def __init__(self, garage, s3_server=None,
                 root_domain: Optional[str] = None):
        self.garage = garage
        self.helper = GarageHelper(garage)
        self.root_domain = root_domain or garage.config.web_root_domain
        self.http = HttpServer(self.handle, name="web")
        self.metrics = {"requests": 0, "errors": 0}

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

    def _bucket_name(self, req: Request) -> str:
        host = (req.header("host") or "").split(":")[0].lower()
        if not host:
            raise S3Error("InvalidRequest", 400, "Host header required")
        if host.endswith(self.root_domain):
            return host[: -len(self.root_domain)]
        return host  # custom domain == global alias (ref: host_to_bucket)

    async def handle(self, req: Request) -> Response:
        self.metrics["requests"] += 1
        try:
            return await self._serve(req)
        except S3Error as e:
            self.metrics["errors"] += 1
            return e.response()

    async def _serve(self, req: Request) -> Response:
        bucket_name = self._bucket_name(req)
        bucket_id = await self.helper.resolve_global_bucket_name(bucket_name)
        if bucket_id is None:
            raise S3Error("NoSuchBucket", 404, bucket_name)
        bucket = await self.helper.get_existing_bucket(bucket_id)
        params = bucket.params
        website = params.website_config.value
        if website is None:
            raise S3Error("NoSuchWebsiteConfiguration", 404,
                          "Bucket is not configured for website hosting")
        index = website.get("index_document") or "index.html"

        if req.method == "OPTIONS":
            return website_handlers.handle_options_for_bucket(req, params)
        if req.method not in ("GET", "HEAD"):
            raise S3Error("MethodNotAllowed", 405,
                          "HTTP method not supported on websites")

        # raw_path: the key comes from percent-decoding the original
        # path; the redirect URL reuses the still-encoded form
        key, may_redirect = path_to_keys(req.raw_path, index)
        ctx = ReqCtx(self.garage, bucket_id, bucket_name, bucket, key,
                     None, None)
        try:
            resp = await get_handlers.handle_get(ctx, req,
                                                 head=req.method == "HEAD")
            for n, v in resp.headers:
                if n == "x-amz-website-redirect-location":
                    # object-level redirect (ref: web_server.rs:302-309)
                    resp = Response(301, [("location", v)])
                    break
        except S3Error as e:
            if e.code == "NoSuchKey" and may_redirect is not None:
                redirect_key, url = may_redirect
                if await self._key_exists(bucket_id, redirect_key):
                    return Response(302, [("location", url)])
            resp = await self._error_response(req, ctx, website, e)
        return website_handlers.apply_cors_to_response(req, params, resp)

    async def _key_exists(self, bucket_id: bytes, key: str) -> bool:
        obj = await self.garage.object_table.get(bucket_id, key.encode())
        return obj is not None and obj.last_data() is not None

    async def _error_response(self, req: Request, ctx: ReqCtx, website: dict,
                              err: S3Error) -> Response:
        """Render the configured error document for 4xx GETs
        (ref: web_server.rs:330-390)."""
        error_doc = website.get("error_document")
        if (req.method == "HEAD" or not error_doc
                or not 400 <= err.status < 500):
            raise err
        ctx2 = ReqCtx(ctx.garage, ctx.bucket_id, ctx.bucket_name,
                      ctx.bucket, error_doc.lstrip("/"), None, None)
        try:
            doc = await get_handlers.handle_get(ctx2, req)
        except S3Error:
            raise err
        # serve the error document body with the ORIGINAL error status
        doc.status = err.status
        return doc
