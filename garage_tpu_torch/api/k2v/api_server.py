"""Copy of garage_tpu/api/k2v/api_server.py: import paths rewritten, issue and PR tags dropped.

K2V API server: routing, auth, dispatch.

Ref parity: src/api/k2v/api_server.rs + router.rs. URL shape:

  GET    /{bucket}                       ?start&end&limit&prefix  ReadIndex
  POST   /{bucket}                       body = [items]           InsertBatch
  POST   /{bucket}?search                body = [queries]         ReadBatch
  POST   /{bucket}?delete                body = [queries]         DeleteBatch
  GET    /{bucket}/{partition_key}?sort_key=...                   ReadItem
  GET    /{bucket}/{partition_key}?sort_key=...&causality_token=
         ...&timeout=...                                          PollItem
  PUT    /{bucket}/{partition_key}?sort_key=...                   InsertItem
  DELETE /{bucket}/{partition_key}?sort_key=...                   DeleteItem

Auth is SigV4 with scope service "k2v". Permissions reuse the bucket
key grants (read for GET/POLL, write for PUT/DELETE/batches).
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from ...model.helper import GarageHelper
from ...qos.limiter import SlowDown
from ...utils.error import BadRequest, NoSuchBucket, NoSuchKey
from ..http import HttpError, HttpServer, Request, Response
from ..s3.api_server import ReqCtx
from ..s3.xml import S3Error, access_denied, no_such_bucket
from ..signature import verify_request
from . import batch as batch_handlers
from . import index as index_handlers
from . import item as item_handlers

log = logging.getLogger("garage_tpu_torch.api.k2v")


def json_error(code: str, status: int, message: str,
               headers: Optional[list] = None) -> Response:
    body = json.dumps({"code": code, "message": message}).encode()
    return Response(status,
                    [("content-type", "application/json")]
                    + (headers or []), body)


class K2VApiServer:
    def __init__(self, garage, region: Optional[str] = None):
        self.garage = garage
        self.helper = GarageHelper(garage)
        self.region = region or garage.config.s3_region
        self.http = HttpServer(self.handle, name="k2v")

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

    async def handle(self, req: Request) -> Response:
        # claimed key id = per-key fairness identity for the global
        # request-rate DRR (same discipline as the S3 frontend; reset
        # per keep-alive request so identity never leaks across)
        from ...qos.limiter import CURRENT_QOS_KEY
        from ..signature import claimed_key_id

        qos_key_token = CURRENT_QOS_KEY.set(claimed_key_id(req))
        try:
            # same two-stage qos admission as the S3 frontend: global
            # (cheap, pre-auth) here, per-key/per-bucket in _handle
            qos = getattr(self.garage, "qos", None)
            if qos is None:
                return await self._handle(req)
            cl = req.header("content-length")
            async with qos.admit(
                    "k2v", nbytes=int(cl) if cl and cl.isdigit() else None):
                return await self._handle(req)
        except SlowDown as e:
            return json_error("SlowDown", 503,
                              "Please reduce your request rate.",
                              headers=[("retry-after", e.header_value())])
        except S3Error as e:
            return json_error(e.code, e.status, e.message)
        except HttpError as e:
            return json_error("InvalidRequest", e.status, e.reason)
        except NoSuchBucket as e:
            return json_error("NoSuchBucket", 404, str(e))
        except NoSuchKey as e:
            return json_error("NoSuchKey", 404, str(e))
        except BadRequest as e:
            return json_error("InvalidRequest", 400, str(e))
        finally:
            CURRENT_QOS_KEY.reset(qos_key_token)

    async def _handle(self, req: Request) -> Response:
        verified = await verify_request(req, self.region,
                                        self.helper.key_secret,
                                        service="k2v")
        if verified is None:
            raise access_denied("authentication required")
        api_key = await self.helper.get_existing_key(verified.key_id)

        path = req.path.lstrip("/")
        bucket_name, _, partition_key = path.partition("/")
        if not bucket_name:
            raise S3Error("InvalidRequest", 400, "no bucket in path")
        qos = getattr(self.garage, "qos", None)
        if qos is not None:
            await qos.admit_scoped(key_id=api_key.key_id,
                                   bucket=bucket_name)
        # fairness identity for downstream byte charges, now VERIFIED
        # (reset by handle() per request)
        from ...qos.limiter import CURRENT_QOS_KEY

        CURRENT_QOS_KEY.set(api_key.key_id)

        bucket_id = await self.helper.resolve_global_bucket_name(bucket_name)
        if bucket_id is None:
            raise no_such_bucket(bucket_name)
        bucket = await self.helper.get_existing_bucket(bucket_id)

        # PollRange is a READ despite traveling as POST (it carries a
        # JSON body); gating it on write would both leak values to
        # write-only keys and lock out read-only consumers
        is_read = (req.method in ("GET", "HEAD")
                   or (req.method == "POST" and "poll_range" in req.query))
        allowed = (api_key.allow_read(bucket_id) if is_read
                   else api_key.allow_write(bucket_id))
        if not allowed:
            raise access_denied()

        ctx = ReqCtx(self.garage, bucket_id, bucket_name, bucket,
                     partition_key or None, api_key, verified)
        return await self._route(req, ctx, partition_key)

    async def _route(self, req: Request, ctx: ReqCtx,
                     partition_key: str) -> Response:
        m, q = req.method, req.query
        if not partition_key:
            if m == "GET":
                return await index_handlers.handle_read_index(ctx, req)
            if m == "POST":
                if "search" in q:
                    return await batch_handlers.handle_read_batch(ctx, req)
                if "delete" in q:
                    return await batch_handlers.handle_delete_batch(ctx,
                                                                    req)
                return await batch_handlers.handle_insert_batch(ctx, req)
            raise S3Error("NotImplemented", 501,
                          f"unsupported K2V bucket operation {m}")
        if m == "POST" and "poll_range" in q:
            return await item_handlers.handle_poll_range(ctx, req,
                                                         partition_key)
        if "sort_key" not in q:
            raise S3Error("InvalidRequest", 400, "sort_key is required")
        sort_key = q["sort_key"]
        if m in ("GET", "HEAD"):
            if "causality_token" in q:
                return await item_handlers.handle_poll_item(
                    ctx, req, partition_key, sort_key)
            return await item_handlers.handle_read_item(
                ctx, req, partition_key, sort_key)
        if m == "PUT":
            return await item_handlers.handle_insert_item(
                ctx, req, partition_key, sort_key)
        if m == "DELETE":
            return await item_handlers.handle_delete_item(
                ctx, req, partition_key, sort_key)
        raise S3Error("NotImplemented", 501,
                      f"unsupported K2V item operation {m}")
