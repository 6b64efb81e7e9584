"""Copy of garage_tpu/cli/k2v.py: import paths rewritten, issue and PR tags dropped.

k2v-cli: command-line client for the K2V API.

Ref parity: src/k2v-client/bin/k2v-cli.rs:392 — the operator/debug CLI
over the K2V HTTP API, built on the same SDK applications use
(garage_tpu/k2v_client.py). Connection comes from flags or environment
(K2V_HOST/K2V_PORT/K2V_BUCKET/AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY).

  python -m garage_tpu_torch.cli.k2v --bucket b -k GK.. -s .. read pk sk
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

from ..k2v_client import K2vClient, K2vError


def _client(args) -> K2vClient:
    key_id = args.key_id or os.environ.get("AWS_ACCESS_KEY_ID", "")
    secret = args.secret or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
    bucket = args.bucket or os.environ.get("K2V_BUCKET", "")
    if not (key_id and secret and bucket):
        print("need --bucket/--key-id/--secret (or env K2V_BUCKET, "
              "AWS_ACCESS_KEY_ID, AWS_SECRET_ACCESS_KEY)", file=sys.stderr)
        raise SystemExit(2)
    return K2vClient(args.host, args.port, bucket, key_id, secret,
                     region=args.region)


def _print_value(v) -> None:
    out = {"causality": v.causality, "values": []}
    for b in v.values:
        if b is None:
            out["values"].append({"tombstone": True})
        else:
            try:
                out["values"].append({"utf8": b.decode()})
            except UnicodeDecodeError:
                out["values"].append(
                    {"base64": base64.b64encode(b).decode()})
    print(json.dumps(out, indent=2))


def main(argv=None) -> int:
    from . import reset_sigpipe

    reset_sigpipe()
    p = argparse.ArgumentParser(prog="k2v-cli")
    p.add_argument("--host", default=os.environ.get("K2V_HOST", "127.0.0.1"))
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("K2V_PORT", "3904")))
    p.add_argument("--bucket", "-b", default=None)
    p.add_argument("--key-id", "-k", default=None)
    p.add_argument("--secret", "-s", default=None)
    p.add_argument("--region", default="garage")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("read", help="read one item (all causal values)")
    pr.add_argument("partition_key")
    pr.add_argument("sort_key")

    pi = sub.add_parser("insert", help="insert/overwrite one item")
    pi.add_argument("partition_key")
    pi.add_argument("sort_key")
    pi.add_argument("value", help="value bytes; @file reads a file, "
                                  "- reads stdin")
    pi.add_argument("--causality", "-c", default=None)
    pi.add_argument("--b64", action="store_true",
                    help="value argument is base64")

    pd = sub.add_parser("delete", help="delete one item")
    pd.add_argument("partition_key")
    pd.add_argument("sort_key")
    pd.add_argument("--causality", "-c", required=True)

    px = sub.add_parser("read-index",
                        help="list partition keys with item counts")
    px.add_argument("--prefix", default=None)
    px.add_argument("--limit", type=int, default=None)

    prr = sub.add_parser("read-range", help="list items of one partition")
    prr.add_argument("partition_key")
    prr.add_argument("--prefix", default=None)
    prr.add_argument("--limit", type=int, default=None)

    pp = sub.add_parser("poll-item",
                        help="long-poll one item for a newer value")
    pp.add_argument("partition_key")
    pp.add_argument("sort_key")
    pp.add_argument("--causality", "-c", required=True)
    pp.add_argument("--timeout", type=float, default=10.0)

    ppr = sub.add_parser("poll-range",
                         help="long-poll a partition for changes")
    ppr.add_argument("partition_key")
    ppr.add_argument("--prefix", default=None)
    ppr.add_argument("--seen-marker", default=None)
    ppr.add_argument("--timeout", type=float, default=10.0)

    args = p.parse_args(argv)
    cli = _client(args)
    try:
        if args.cmd == "read":
            _print_value(cli.read_item(args.partition_key, args.sort_key))
        elif args.cmd == "insert":
            raw = args.value
            if raw == "-":
                data = sys.stdin.buffer.read()
            elif raw.startswith("@"):
                with open(raw[1:], "rb") as f:
                    data = f.read()
            else:
                data = (base64.b64decode(raw) if args.b64
                        else raw.encode())
            cli.insert_item(args.partition_key, args.sort_key, data,
                            causality=args.causality)
            print("ok")
        elif args.cmd == "delete":
            cli.delete_item(args.partition_key, args.sort_key,
                            args.causality)
            print("ok")
        elif args.cmd == "read-index":
            infos = cli.read_index(prefix=args.prefix, limit=args.limit)
            for pi_ in infos:
                print(json.dumps({"partitionKey": pi_.pk,
                                  "entries": pi_.entries,
                                  "values": pi_.values,
                                  "bytes": pi_.bytes}))
        elif args.cmd == "read-range":
            q = {"partitionKey": args.partition_key}
            if args.prefix:
                q["prefix"] = args.prefix
            if args.limit:
                q["limit"] = args.limit
            for resp in cli.read_batch([q]):
                print(json.dumps(resp, indent=2))
        elif args.cmd == "poll-item":
            v = cli.poll_item(args.partition_key, args.sort_key,
                              args.causality, timeout=args.timeout)
            if v is None:
                print("timeout: no new value")
                return 3
            _print_value(v)
        elif args.cmd == "poll-range":
            r = cli.poll_range(args.partition_key, prefix=args.prefix,
                               seen_marker=args.seen_marker,
                               timeout=args.timeout)
            if r is None:
                print("timeout: no changes")
                return 3
            items, marker = r
            for it in items:
                print(json.dumps({
                    "sk": it["sk"], "ct": it["ct"],
                    "v": [None if v is None
                          else base64.b64encode(v).decode()
                          for v in it["v"]]}))
            print(json.dumps({"seenMarker": marker}))
    except K2vError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
