"""Copy of garage_tpu/cli/main.py: import paths rewritten, issue and PR tags dropped.

Operator CLI: `python -m garage_tpu_torch.cli.main <command>`.

Ref parity: src/garage/cli/ (structs.rs:9-530, cmd.rs). Connects to a
running node's RPC port (config from --config / GARAGE_CONFIG_FILE) with
an ephemeral identity and drives the AdminRpc endpoint.

Commands: status, node connect, layout {show,assign,remove,apply},
bucket {list,create,delete,info,allow,deny}, key {new,list,info,delete,
import}, worker list, stats.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from ..model.garage import parse_addr, parse_peer
from ..net import NetApp
from ..net.message import PRIO_NORMAL
from ..utils.config import read_config


def fmt_table(rows: list[list[str]], header: list[str]) -> str:
    """ref: src/format-table/lib.rs — tab-aligned columns."""
    all_rows = [header] + rows
    widths = [max(len(str(r[i])) for r in all_rows)
              for i in range(len(header))]
    lines = []
    for i, r in enumerate(all_rows):
        lines.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


class AdminClient:
    def __init__(self, cfg):
        self.cfg = cfg
        netid = (bytes.fromhex(cfg.rpc_secret) if cfg.rpc_secret
                 else b"garage-tpu-insecure-dev")
        self.netapp = NetApp(netid)
        self.node = None

    async def connect(self) -> None:
        addr = parse_addr(self.cfg.rpc_public_addr or self.cfg.rpc_bind_addr)
        self.node = await self.netapp.try_connect(addr)
        self.ep = self.netapp.endpoint("garage_tpu/admin")

    async def call(self, op: str, **kw):
        resp, _ = await self.ep.call(self.node, {"op": op, **kw},
                                     PRIO_NORMAL, timeout=30.0)
        return resp

    async def close(self):
        await self.netapp.shutdown()


async def cmd(args) -> int:
    if args.cmd in ("convert-db", "repair-offline"):
        return await _offline(args)  # no server connection
    cfg = await asyncio.to_thread(read_config, args.config)
    cli = AdminClient(cfg)
    try:
        await cli.connect()
        return await _dispatch(cli, args)
    finally:
        await cli.close()


async def _offline(args) -> int:
    """Offline maintenance: operates directly on the metadata db with
    NO server running (ref: src/garage/cli/convert_db.rs +
    src/garage/repair/offline.rs)."""
    if args.cmd == "convert-db":
        from ..db import open_db

        src_db_file = (args.src if args.src.endswith(".sqlite")
                       else os.path.join(args.src, "db.sqlite"))
        if args.src_engine == "sqlite" and not os.path.exists(src_db_file):
            # open_db would CREATE an empty db at a typo'd path and the
            # "conversion" would silently produce nothing
            print(f"source database {src_db_file} does not exist",
                  file=sys.stderr)
            return 1
        if os.path.abspath(args.src) == os.path.abspath(args.dst):
            print("--src and --dst are the same path", file=sys.stderr)
            return 1
        # a live server on this metadata dir would mutate trees while we
        # snapshot them — take the same lock the server holds. The db
        # usually lives at {metadata_dir}/db, so the server's lock sits
        # in the PARENT of src; guard both.
        from ..utils import lockfile

        src_dir = os.path.abspath(args.src) if os.path.isdir(args.src) \
            else os.path.dirname(os.path.abspath(args.src))
        lock_fds = []
        try:
            for d in dict.fromkeys([src_dir, os.path.dirname(src_dir)]):
                lock_fds.append(lockfile.acquire(d, "convert-db"))
        except lockfile.AlreadyLocked as e:
            for fd in lock_fds:
                lockfile.release(fd)
            print(str(e), file=sys.stderr)
            return 1
        def _convert() -> int:
            # runs in a worker thread (GL10): the whole-db copy is
            # minutes of sqlite/LSM I/O and must not pin the loop
            src = open_db(args.src, engine=args.src_engine)
            dst = open_db(args.dst, engine=args.dst_engine)
            try:
                if dst.list_trees():
                    print("destination database is not empty; refusing "
                          "to interleave rows", file=sys.stderr)
                    return 1
                total = 0
                for name in src.list_trees():
                    st = src.open_tree(name)
                    dt = dst.open_tree(name)
                    rows, cursor = 0, None
                    while True:  # batched: never materialize a tree
                        batch = list(st.iter(start=cursor, limit=10000))
                        if not batch:
                            break

                        def copy(tx, batch=batch, dt=dt):
                            for k, v in batch:
                                tx.insert(dt, k, v)

                        dst.transaction(copy)
                        rows += len(batch)
                        if len(batch) < 10000:
                            break
                        cursor = batch[-1][0] + b"\x00"
                    total += rows
                    print(f"  {name}: {rows} rows")
                print(f"converted {total} rows "
                      f"({args.src_engine} -> {args.dst_engine})")
            finally:
                src.close()
                dst.close()
            return 0

        try:
            return await asyncio.to_thread(_convert)
        finally:
            for fd in lock_fds:
                lockfile.release(fd)
    if args.cmd == "repair-offline":
        cfg = await asyncio.to_thread(read_config, args.config)
        from ..model.garage import Garage
        from ..utils import lockfile

        # a live server holds this lock: a recount racing a live
        # count() would win the CRDT merge with stale totals
        try:
            lock_fd = lockfile.acquire(cfg.metadata_dir, "repair-offline")
        except lockfile.AlreadyLocked as e:
            print(str(e), file=sys.stderr)
            return 1
        try:
            garage = Garage(cfg)
            if args.what == "object-counters":
                n = await asyncio.to_thread(
                    garage.object_counter.recount,
                    garage.object_table.data)
                n += await asyncio.to_thread(
                    garage.mpu_counter.recount, garage.mpu_table.data)
                print(f"recomputed {n} object/mpu counter rows")
            elif args.what == "k2v-counters":
                n = await asyncio.to_thread(
                    garage.k2v_counter.recount,
                    garage.k2v_item_table.data)
                print(f"recomputed {n} k2v counter rows")
            else:
                print(f"unknown offline repair {args.what!r}",
                      file=sys.stderr)
                return 1
            garage.db.close()
        finally:
            lockfile.release(lock_fd)
        return 0
    return 1


async def _dispatch(cli: AdminClient, args) -> int:
    c = args.cmd
    if c == "status":
        r = await cli.call("status")
        h = r["health"]
        print(f"node id:  {r['node_id'].hex()}")
        print(f"health:   {h['status']} "
              f"({h['connected_nodes']}/{h['known_nodes']} nodes, "
              f"{h['storage_nodes_up']}/{h['storage_nodes']} storage, "
              f"{h['partitions_quorum']}/256 partitions with quorum)")
        print(f"layout:   v{r['layout_version']}")
        rows = []
        for n in r["nodes"]:
            role = n.get("role") or {}
            rows.append([
                n["id"].hex()[:16], n.get("hostname", ""),
                "up" if n["is_up"] else "DOWN",
                role.get("zone", "-"),
                str(role.get("capacity", "-")),
            ])
        print(fmt_table(rows, ["id", "host", "status", "zone", "capacity"]))
        return 0
    if c == "connect":
        addr, nid = parse_peer(args.peer)
        await cli.call("connect", addr=list(addr), id=nid)
        print("ok")
        return 0
    if c == "layout":
        return await _layout(cli, args)
    if c == "bucket":
        return await _bucket(cli, args)
    if c == "key":
        return await _key(cli, args)
    if c == "worker":
        s = getattr(args, "subcmd", None) or "list"
        if s == "list":
            r = await cli.call("worker_list")
            rows = [[w["id"], w["name"], str(w.get("queue") or ""),
                     str(w.get("errors") or "")] for w in r["workers"]]
            print(fmt_table(rows, ["id", "name", "queue", "errors"]))
            return 0
        if s == "get":
            r = await cli.call("worker_get", name=args.name)
            for k, v in sorted(r["vars"].items()):
                print(f"{k} = {v}")
            return 0
        if s == "set":
            r = await cli.call("worker_set", name=args.name,
                               value=args.value)
            print(f"{args.name} = {r['value']}")
            return 0
        return 1
    if c == "repair":
        r = await cli.call("repair", what=args.what,
                           cmd=getattr(args, "scrub_cmd", None))
        print(r.get("msg", "ok"))
        return 0
    if c == "block":
        return await _block(cli, args)
    if c == "meta":
        if args.subcmd == "snapshot":
            r = await cli.call("meta_snapshot")
            print(f"snapshot written to {r['path']}")
            return 0
        return 1
    if c == "stats":
        r = await cli.call("stats")
        print(json.dumps(r, indent=2, default=str))
        return 0
    print(f"unknown command {c}", file=sys.stderr)
    return 1


async def _layout(cli, args) -> int:
    s = args.subcmd
    if s == "show":
        r = await cli.call("layout_show")
        print(f"current layout version: {r['version']}")
        rows = [[nid[:16], v["zone"], str(v["capacity"])]
                for nid, v in sorted(r["roles"].items())]
        print(fmt_table(rows, ["id", "zone", "capacity"]))
        if r["staged"]:
            print("\nstaged changes:")
            for nid, v in sorted(r["staged"].items()):
                print(f"  {nid[:16]} -> {v}")
        return 0
    if s == "assign":
        from ..utils.config import parse_capacity

        node = bytes.fromhex(args.node) if len(args.node) == 64 else None
        if node is None:
            # prefix match against known nodes
            r = await cli.call("status")
            cands = [n["id"] for n in r["nodes"]
                     if n["id"].hex().startswith(args.node)]
            if len(cands) != 1:
                print(f"node prefix {args.node!r} matches {len(cands)} nodes",
                      file=sys.stderr)
                return 1
            node = bytes(cands[0])
        cap = parse_capacity(args.capacity) if args.capacity else None
        await cli.call("layout_assign", node=node, zone=args.zone,
                       capacity=cap, tags=args.tags or [])
        print("staged; run `layout apply` to activate")
        return 0
    if s == "remove":
        node = bytes.fromhex(args.node)
        await cli.call("layout_remove", node=node)
        print("staged removal")
        return 0
    if s == "apply":
        r = await cli.call("layout_apply", version=args.version)
        print(f"layout applied, now at version {r['version']}")
        return 0
    if s == "revert":
        r = await cli.call("layout_revert")
        print(f"staged changes reverted (layout stays at "
              f"v{r['version']})")
        return 0
    if s == "config":
        r = await cli.call("layout_config",
                           zone_redundancy=args.zone_redundancy)
        print(f"staged parameters: {r['staged_parameters']} "
              f"(run `layout apply` to activate)")
        return 0
    if s == "skip-dead-nodes":
        r = await cli.call("layout_skip_dead_nodes", version=args.version,
                           allow_missing_data=args.allow_missing_data)
        if r["updated"]:
            print(f"advanced trackers to v{r['version']} for "
                  f"{len(r['updated'])} dead node(s):")
            for n in r["updated"]:
                print(f"  {n[:16]}")
        else:
            print("no dead nodes with stale trackers")
        return 0
    return 1


async def _bucket(cli, args) -> int:
    s = args.subcmd
    if s == "list":
        r = await cli.call("bucket_list")
        print(fmt_table([[b["name"], b["id"][:16]] for b in r["buckets"]],
                        ["name", "id"]))
        return 0
    if s == "create":
        r = await cli.call("bucket_create", name=args.name)
        print(f"bucket {args.name} created, id {r['id']}")
        return 0
    if s == "delete":
        await cli.call("bucket_delete", name=args.name)
        print("deleted")
        return 0
    if s == "info":
        r = await cli.call("bucket_info", name=args.name)
        print(json.dumps(r, indent=2))
        return 0
    if s in ("allow", "deny"):
        await cli.call(f"bucket_{s}", bucket=args.name, key=args.key,
                       read=args.read, write=args.write, owner=args.owner)
        print("ok")
        return 0
    return 1


async def _block(cli, args) -> int:
    s = args.subcmd
    if s == "list-errors":
        r = await cli.call("block_list_errors")
        rows = [[e["hash"][:16], str(e["failures"]),
                 str(e["next_try_ms"])] for e in r["errors"]]
        print(fmt_table(rows, ["hash", "failures", "next_try_ms"]))
        return 0
    if s == "info":
        r = await cli.call("block_info", hash=args.hash)
        print(json.dumps(r, indent=2, default=str))
        return 0
    if s == "retry-now":
        r = await cli.call("block_retry_now", all=args.all,
                           hashes=args.hashes or [])
        print(f"{r['count']} block(s) queued for retry")
        return 0
    if s == "purge":
        if not args.yes:
            print("refusing to purge without --yes", file=sys.stderr)
            return 1
        r = await cli.call("block_purge", hashes=args.hashes or [])
        print(f"purged {r['versions']} version(s), "
              f"{r['objects']} object(s)")
        return 0
    return 1


async def _key(cli, args) -> int:
    s = args.subcmd
    if s == "new":
        r = await cli.call("key_new", name=args.name or "")
        print(f"Key ID:     {r['key_id']}")
        print(f"Secret key: {r['secret_key']}")
        return 0
    if s == "list":
        r = await cli.call("key_list")
        print(fmt_table([[k["id"], k["name"]] for k in r["keys"]],
                        ["id", "name"]))
        return 0
    if s == "info":
        r = await cli.call("key_info", key=args.key, show_secret=args.show_secret)
        print(json.dumps(r, indent=2))
        return 0
    if s == "delete":
        await cli.call("key_delete", key=args.key)
        print("deleted")
        return 0
    if s == "import":
        r = await cli.call("key_import", key_id=args.key_id,
                           secret_key=args.secret_key, name=args.name or "")
        print(f"imported {r['key_id']}")
        return 0
    if s in ("allow", "deny"):
        await cli.call(f"key_{s}", key=args.key,
                       create_bucket=args.create_bucket)
        print("ok")
        return 0
    return 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="garage")
    p.add_argument("--config", "-c",
                   default=os.environ.get("GARAGE_CONFIG_FILE",
                                          "/etc/garage.toml"))
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status")
    pc = sub.add_parser("connect")
    pc.add_argument("peer")  # id@host:port
    pl = sub.add_parser("layout")
    pls = pl.add_subparsers(dest="subcmd", required=True)
    pls.add_parser("show")
    pa = pls.add_parser("assign")
    pa.add_argument("node")
    pa.add_argument("--zone", "-z", default="dc1")
    pa.add_argument("--capacity", "-c", default=None)
    pa.add_argument("--tags", "-t", nargs="*")
    pr = pls.add_parser("remove")
    pr.add_argument("node")
    pap = pls.add_parser("apply")
    pap.add_argument("--version", type=int, default=None)
    pls.add_parser("revert")
    pcf = pls.add_parser("config")
    pcf.add_argument("--zone-redundancy", "-r", dest="zone_redundancy",
                     required=True,
                     help="int or 'maximum' (zones per partition)")
    psd = pls.add_parser("skip-dead-nodes")
    psd.add_argument("--version", type=int, default=None)
    psd.add_argument("--allow-missing-data", action="store_true",
                     help="also advance sync trackers (accepts data "
                          "loss on the dead nodes)")
    pb = sub.add_parser("bucket")
    pbs = pb.add_subparsers(dest="subcmd", required=True)
    pbs.add_parser("list")
    for name in ("create", "delete", "info"):
        x = pbs.add_parser(name)
        x.add_argument("name")
    for name in ("allow", "deny"):
        x = pbs.add_parser(name)
        x.add_argument("name")
        x.add_argument("--key", required=True)
        x.add_argument("--read", action="store_true")
        x.add_argument("--write", action="store_true")
        x.add_argument("--owner", action="store_true")
    pk = sub.add_parser("key")
    pks = pk.add_subparsers(dest="subcmd", required=True)
    kn = pks.add_parser("new")
    kn.add_argument("--name", default="")
    pks.add_parser("list")
    ki = pks.add_parser("info")
    ki.add_argument("key")
    ki.add_argument("--show-secret", action="store_true")
    kd = pks.add_parser("delete")
    kd.add_argument("key")
    kim = pks.add_parser("import")
    kim.add_argument("key_id")
    kim.add_argument("secret_key")
    kim.add_argument("--name", default="")
    for name in ("allow", "deny"):
        x = pks.add_parser(name)
        x.add_argument("key")
        x.add_argument("--create-bucket", action="store_true")
    pw = sub.add_parser("worker")
    pws = pw.add_subparsers(dest="subcmd")
    pws.add_parser("list")
    wg = pws.add_parser("get")
    wg.add_argument("name", nargs="?", default=None)
    ws = pws.add_parser("set")
    ws.add_argument("name")
    ws.add_argument("value")
    prp = sub.add_parser("repair")
    prp.add_argument("what", choices=["tables", "versions", "mpu",
                                      "block-refs", "block-rc", "blocks",
                                      "rebalance", "scrub"])
    prp.add_argument("scrub_cmd", nargs="?", default="start",
                     choices=["start", "pause", "resume", "cancel"])
    pbl = sub.add_parser("block")
    pbls = pbl.add_subparsers(dest="subcmd", required=True)
    pbls.add_parser("list-errors")
    bi = pbls.add_parser("info")
    bi.add_argument("hash")
    br = pbls.add_parser("retry-now")
    br.add_argument("--all", action="store_true")
    br.add_argument("hashes", nargs="*")
    bp = pbls.add_parser("purge")
    bp.add_argument("--yes", action="store_true")
    bp.add_argument("hashes", nargs="*")
    pm = sub.add_parser("meta")
    pms = pm.add_subparsers(dest="subcmd", required=True)
    pms.add_parser("snapshot")
    sub.add_parser("stats")
    pcv = sub.add_parser("convert-db",
                         help="offline: copy all metadata trees between "
                              "db engines/paths (server must be stopped)")
    pcv.add_argument("--src", required=True)
    pcv.add_argument("--src-engine", default="sqlite")
    pcv.add_argument("--dst", required=True)
    pcv.add_argument("--dst-engine", default="sqlite")
    pro = sub.add_parser("repair-offline",
                         help="offline: recompute index counters from "
                              "the stored tables (server must be stopped)")
    pro.add_argument("what", choices=["object-counters", "k2v-counters"])
    return p


def main() -> None:
    from . import reset_sigpipe

    reset_sigpipe()
    args = build_parser().parse_args()
    if args.cmd == "worker" and getattr(args, "subcmd", None) is None:
        args.subcmd = "list"
    sys.exit(asyncio.run(cmd(args)))


if __name__ == "__main__":
    main()
