"""Copy of garage_tpu/api/s3/bucket.py: import paths rewritten, issue and PR tags dropped.

Bucket-level endpoints.

Ref parity: src/api/s3/bucket.rs — CreateBucket (idempotent when the
key may write), DeleteBucket (owner only, must be empty), location,
versioning stub.
"""

from __future__ import annotations

from ...model.helper import allow_all
from ...utils.error import BadRequest
from ..http import Request, Response
from .xml import S3Error, xml, xml_response


async def handle_create_bucket(helper, bucket_name: str, api_key,
                               region: str, req: Request) -> Response:
    """ref: bucket.rs handle_create_bucket."""
    body = await req.body.read_all(limit=1 << 16)
    if body.strip():
        # CreateBucketConfiguration: a LocationConstraint naming any
        # other region is rejected (ref: bucket.rs:127-138)
        import xml.etree.ElementTree as ET

        try:
            root = ET.fromstring(body.decode())
        except (ET.ParseError, UnicodeDecodeError):
            raise S3Error("MalformedXML", 400,
                          "Invalid create bucket XML query")
        for c in root.iter():
            if c.tag.endswith("LocationConstraint") and c.text \
                    and c.text.strip() and c.text.strip() != region:
                raise S3Error(
                    "InvalidLocationConstraint", 400,
                    f"Cannot satisfy location constraint "
                    f"`{c.text.strip()}`: buckets can only be created "
                    f"in region `{region}`")
    existing = await helper.resolve_global_bucket_name(bucket_name)
    if existing is not None:
        if api_key.allow_write(existing) or api_key.allow_owner(existing):
            # you already own it: S3 says 200 in the default region
            return Response(200, [("location", f"/{bucket_name}")])
        raise S3Error("BucketAlreadyExists", 409,
                      "The requested bucket name is not available.")
    # ref: bucket.rs:166 — only keys granted create-bucket may claim
    # new global alias names.
    if api_key.params is None or not api_key.params.allow_create_bucket.value:
        raise S3Error("AccessDenied", 403,
                      "Your key does not allow creating buckets.")
    try:
        bucket = await helper.create_bucket(bucket_name)
    except BadRequest as e:
        raise S3Error("InvalidBucketName", 400, str(e))
    await helper.set_bucket_key_permissions(bucket.id, api_key.key_id,
                                            allow_all())
    return Response(200, [("location", f"/{bucket_name}")])


async def handle_delete_bucket(helper, ctx) -> Response:
    try:
        await helper.delete_bucket(ctx.bucket_id)
    except BadRequest as e:
        raise S3Error("BucketNotEmpty", 409, str(e))
    return Response(204)


def handle_get_bucket_location(region: str) -> Response:
    return xml_response(
        xml("LocationConstraint", region,
            xmlns="http://s3.amazonaws.com/doc/2006-03-01/"))


def handle_get_bucket_versioning() -> Response:
    # versioning is not supported (ref: bucket.rs:
    # handle_get_bucket_versioning returns unversioned)
    return xml_response(xml("VersioningConfiguration",
                            xmlns="http://s3.amazonaws.com/doc/2006-03-01/"))
