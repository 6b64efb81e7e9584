"""Copy of garage_tpu/api/k2v/index.py: import paths rewritten, issue and PR tags dropped.

K2V ReadIndex: list partition keys with their counter aggregates.

Ref parity: src/api/k2v/index.rs — reads the k2v index counter table
(entries / conflicts / values / bytes per partition key).
"""

from __future__ import annotations

import json

from ...model.k2v.item_table import BYTES, CONFLICTS, ENTRIES, VALUES
from ..http import Request, Response
from ..s3.xml import S3Error
from .batch import check_start_in_prefix

MAX_LIMIT = 1000


async def handle_read_index(ctx, req: Request) -> Response:
    q = req.query
    prefix = q.get("prefix")
    start = q.get("start")
    end = q.get("end")
    check_start_in_prefix(start, prefix)
    try:
        limit = min(int(q.get("limit", MAX_LIMIT)), MAX_LIMIT)
    except ValueError:
        raise S3Error("InvalidRequest", 400, "bad limit")
    reverse = q.get("reverse", "").lower() in ("1", "true", "yes")

    garage = ctx.garage
    nodes = list(garage.system.layout_manager.history.all_nongateway_nodes())
    counter_table = garage.k2v_counter.table

    entries = await counter_table.get_range(
        ctx.bucket_id,
        start.encode() if start is not None else None,
        flt={"deleted": "not_deleted", "nodes": nodes},
        limit=limit + 1, reverse=reverse,
        prefix_sk=prefix.encode() if prefix else None,
        end_sk=end.encode() if end is not None else None)

    keys = []
    more, next_start = False, None
    for e in entries:
        pk_str = e.sk.decode("utf-8", "replace")
        if len(keys) >= limit:
            more, next_start = True, pk_str
            break
        vals = e.filtered_values(nodes)
        keys.append({
            "pk": pk_str,
            "entries": vals.get(ENTRIES, 0),
            "conflicts": vals.get(CONFLICTS, 0),
            "values": vals.get(VALUES, 0),
            "bytes": vals.get(BYTES, 0),
        })

    body = json.dumps({
        "prefix": prefix,
        "start": start,
        "end": end,
        "limit": limit,
        "reverse": reverse,
        "partitionKeys": keys,
        "more": more,
        "nextStart": next_start,
    }).encode()
    return Response(200, [("content-type", "application/json")], body)
