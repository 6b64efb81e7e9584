"""Copy of garage_tpu/api/s3/delete.py: import paths rewritten, issue and PR tags dropped.

DeleteObject / DeleteObjects.

Ref parity: src/api/s3/delete.rs. Deletion inserts a DeleteMarker
version; the object-table merge drops older versions, whose cleanup
cascades through the version -> block_ref triggers.
"""

from __future__ import annotations

from ...model.s3.object_table import (Object, ObjectVersion,
                                      ObjectVersionData, ObjectVersionState)
from ...utils.crdt import now_msec
from ...utils.data import gen_uuid
from ..http import Request, Response
from .put import next_timestamp
from .xml import S3Error, xml, xml_response


async def delete_object(garage, bucket_id: bytes, key: str):
    """-> (deleted_uuid | None). ref: delete.rs handle_delete_internal."""
    obj = await garage.object_table.get(bucket_id, key.encode())
    if obj is None or obj.last_data() is None:
        return None  # idempotent: deleting nothing is fine
    uuid = gen_uuid()
    ts = next_timestamp(obj)
    marker = Object(bucket_id, key, [ObjectVersion(
        uuid, ts,
        ObjectVersionState.complete(ObjectVersionData.delete_marker()))])
    await garage.object_table.insert(marker)
    return uuid


async def handle_delete_object(ctx, req: Request) -> Response:
    await delete_object(ctx.garage, ctx.bucket_id, ctx.key)
    return Response(204)


async def handle_delete_objects(ctx, req: Request) -> Response:
    """POST /?delete — batch deletion (ref: delete.rs
    handle_delete_objects)."""
    import xml.etree.ElementTree as ET

    body = await req.body.read_all(limit=1 << 20)
    try:
        root = ET.fromstring(body.decode())
    except ET.ParseError:
        raise S3Error("MalformedXML", 400, "cannot parse Delete document")
    quiet = any(c.tag.endswith("Quiet") and (c.text or "").strip() == "true"
                for c in root)
    results = []
    for obj in root:
        if not obj.tag.endswith("Object"):
            continue
        key = None
        for c in obj:
            if c.tag.endswith("Key"):
                key = c.text or ""
        if key is None:
            continue
        try:
            await delete_object(ctx.garage, ctx.bucket_id, key)
            if not quiet:
                results.append(xml("Deleted", xml("Key", key)))
        except Exception as e:
            results.append(xml("Error", xml("Key", key),
                               xml("Code", "InternalError"),
                               xml("Message", str(e))))
    return xml_response(xml("DeleteResult", *results))
