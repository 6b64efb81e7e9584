"""Copy of garage_tpu/admin/rpc.py: import paths rewritten, issue and PR tags dropped.

Admin RPC: the operator control surface of a node.

Ref parity: src/garage/admin/mod.rs:42-530 (AdminRpcHandler). The CLI
connects to any node over the normal net layer and drives cluster
management ops: status, layout staging/apply, bucket/key CRUD, worker
and stats introspection. Endpoint: "garage_tpu/admin".
"""

from __future__ import annotations

import asyncio
import logging

from ..model.helper import GarageHelper, allow_all
from ..rpc.layout.version import NodeRole
from ..utils.error import BadRequest, GarageError, NoSuchBucket

log = logging.getLogger("garage_tpu_torch.admin")


class AdminRpcHandler:
    def __init__(self, garage):
        self.garage = garage
        self.helper = GarageHelper(garage)
        self.endpoint = garage.netapp.endpoint("garage_tpu/admin")
        self.endpoint.set_handler(self._handle)

    async def _handle(self, from_node, payload, stream):
        op = payload.get("op")
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            raise GarageError(f"unknown admin op {op!r}")
        return await fn(payload)

    # ---- cluster -------------------------------------------------------

    async def op_status(self, p):
        sys = self.garage.system
        h = sys.health()
        nodes = [
            {"id": n.id, "addr": list(n.addr) if n.addr else None,
             "is_up": n.is_up,
             "hostname": n.status.hostname if n.status else "",
             "role": self._role_of(n.id)}
            for n in sys.get_known_nodes()
        ]
        return {
            "node_id": sys.id,
            "health": {
                "status": h.status.value,
                "known_nodes": h.known_nodes,
                "connected_nodes": h.connected_nodes,
                "storage_nodes": h.storage_nodes,
                "storage_nodes_up": h.storage_nodes_up,
                "partitions_quorum": h.partitions_quorum,
            },
            "layout_version": sys.layout_manager.history.current().version,
            "nodes": nodes,
        }

    def _role_of(self, node_id):
        role = self.garage.system.layout_manager.history.current().node_role(
            node_id)
        if role is None:
            return None
        return {"zone": role.zone, "capacity": role.capacity,
                "tags": list(role.tags)}

    async def op_connect(self, p):
        addr = tuple(p["addr"])
        await self.garage.netapp.try_connect(
            addr, bytes(p["id"]) if p.get("id") else None)
        self.garage.system.peering.add_peer(
            addr, bytes(p["id"]) if p.get("id") else None)
        return {"ok": True}

    # ---- layout --------------------------------------------------------

    async def op_layout_show(self, p):
        hist = self.garage.system.layout_manager.history
        cur = hist.current()
        roles = {}
        for nid in hist.all_storage_nodes():
            r = cur.node_role(nid)
            if r:
                roles[nid.hex()] = {"zone": r.zone, "capacity": r.capacity,
                                    "tags": list(r.tags)}
        # only the actual staged DIFF — staged_roles() is the merged
        # view (current + staging) and would show every existing role
        # as "staged" forever
        staged = {
            nid.hex(): ({"zone": r.zone, "capacity": r.capacity,
                         "tags": list(r.tags)} if r else None)
            for nid, r in hist.staging.roles.items()
        }
        return {"version": cur.version, "roles": roles, "staged": staged,
                "staged_parameters": hist.staging.parameters.value}

    async def op_layout_assign(self, p):
        lm = self.garage.system.layout_manager
        role = NodeRole(zone=p.get("zone", "dc1"),
                        capacity=p.get("capacity"),
                        tags=tuple(p.get("tags", [])))
        lm.history.stage_role(bytes(p["node"]), role)
        lm.save()
        await lm.broadcast()
        return {"ok": True}

    async def op_layout_remove(self, p):
        lm = self.garage.system.layout_manager
        lm.history.stage_role(bytes(p["node"]), None)
        lm.save()
        await lm.broadcast()
        return {"ok": True}

    async def op_layout_apply(self, p):
        lm = self.garage.system.layout_manager
        # off-loop compute: an expensive assignment must not freeze a
        # node that is serving traffic mid-resize
        await lm.apply_staged_async(p.get("version"))
        return {"version": lm.history.current().version}

    async def op_layout_revert(self, p):
        """Drop all staged role/parameter changes
        (ref: cli/layout.rs cmd_revert_layout)."""
        lm = self.garage.system.layout_manager
        lm.revert_staged()  # _changed() persists + schedules broadcast
        return {"version": lm.history.current().version}

    async def op_layout_config(self, p):
        """Stage layout parameters — currently zone_redundancy
        (ref: cli/structs.rs:113-123 layout config -r)."""
        lm = self.garage.system.layout_manager
        zr = p.get("zone_redundancy")
        if zr is None:
            raise ValueError("zone_redundancy is required")
        if zr != "maximum":
            zr = int(zr)
            if zr < 1:
                raise ValueError("zone_redundancy must be >= 1 or "
                                 "'maximum'")
        lm.history.stage_parameters(zr)
        lm.save()  # staged params must survive a restart
        await lm.broadcast()
        cur = lm.history.staging.parameters.value
        return {"staged_parameters": cur}

    async def op_layout_skip_dead_nodes(self, p):
        """Advance the ack (and, with allow_missing_data, sync) trackers
        of DOWN nodes to `version`, so a permanently lost node no longer
        wedges tracker convergence and old-version GC
        (ref: cli/layout.rs cmd_layout_skip_dead_nodes,
        cli/structs.rs:182)."""
        lm = self.garage.system.layout_manager
        hist = lm.history
        version = p.get("version") or hist.current().version
        if version > hist.current().version:
            raise ValueError(f"version {version} is in the future")
        allow_missing = bool(p.get("allow_missing_data"))
        updated = []
        for node in hist.all_nongateway_nodes():
            if self.garage.system.is_up(node):
                continue
            ch = hist.update_trackers.set_max("ack", node, version)
            if allow_missing:
                ch = hist.update_trackers.set_max("sync", node,
                                                  version) or ch
                ch = hist.update_trackers.set_max("sync_ack", node,
                                                  version) or ch
            if ch:
                updated.append(node.hex())
        if updated:
            hist.cleanup_old_versions()
            lm.save()
            await lm.broadcast()
        return {"updated": updated, "version": version}

    # ---- buckets -------------------------------------------------------

    async def op_bucket_list(self, p):
        aliases = await self.helper.list_buckets()
        return {"buckets": [
            {"name": a.name, "id": a.bucket_id.hex()} for a in aliases
        ]}

    async def op_bucket_create(self, p):
        b = await self.helper.create_bucket(p["name"])
        return {"id": b.id.hex()}

    async def op_bucket_delete(self, p):
        bid = await self.helper.resolve_global_bucket_name(p["name"])
        if bid is None:
            raise NoSuchBucket(p["name"])
        await self.helper.delete_bucket(bid)
        return {"ok": True}

    async def op_bucket_info(self, p):
        bid = await self.helper.resolve_global_bucket_name(p["name"])
        if bid is None:
            raise NoSuchBucket(p["name"])
        b = await self.helper.get_existing_bucket(bid)
        counters = await self.garage.object_counter.read(
            bid, b"", list(self.garage.system.layout_manager.history
                           .all_nongateway_nodes()))
        return {
            "id": bid.hex(),
            "aliases": [a for a, v in b.params.aliases.items() if v],
            "keys": [k for k, perm in b.params.authorized_keys.items()
                     if perm.is_any],
            "objects": counters.get("objects", 0),
            "bytes": counters.get("bytes", 0),
            "unfinished_uploads": counters.get("unfinished_uploads", 0),
            "website": b.params.website_config.value,
            "quotas": b.params.quotas.value
            or {"max_size": None, "max_objects": None},
        }

    async def op_bucket_allow(self, p):
        bid = await self.helper.resolve_global_bucket_name(p["bucket"])
        if bid is None:
            raise NoSuchBucket(p["bucket"])
        key = await self.helper.get_existing_key(p["key"])
        from ..model.permission import BucketKeyPerm
        from ..utils.crdt import now_msec

        perm = key.bucket_permissions(bid)
        new = BucketKeyPerm(
            now_msec(),
            perm.allow_read or bool(p.get("read")),
            perm.allow_write or bool(p.get("write")),
            perm.allow_owner or bool(p.get("owner")),
        )
        await self.helper.set_bucket_key_permissions(bid, key.key_id, new)
        return {"ok": True}

    async def op_bucket_deny(self, p):
        bid = await self.helper.resolve_global_bucket_name(p["bucket"])
        if bid is None:
            raise NoSuchBucket(p["bucket"])
        key = await self.helper.get_existing_key(p["key"])
        from ..model.permission import BucketKeyPerm
        from ..utils.crdt import now_msec

        perm = key.bucket_permissions(bid)
        new = BucketKeyPerm(
            now_msec(),
            perm.allow_read and not p.get("read"),
            perm.allow_write and not p.get("write"),
            perm.allow_owner and not p.get("owner"),
        )
        await self.helper.set_bucket_key_permissions(bid, key.key_id, new)
        return {"ok": True}

    # ---- keys ----------------------------------------------------------

    async def op_key_new(self, p):
        k = await self.helper.create_key(p.get("name", ""))
        return {"key_id": k.key_id, "secret_key": k.params.secret_key}

    async def op_key_list(self, p):
        keys = await self.helper.list_keys()
        return {"keys": [
            {"id": k.key_id,
             "name": k.params.name.value if k.params else ""}
            for k in keys
        ]}

    async def op_key_info(self, p):
        k = await self.helper.get_existing_key(p["key"])
        return {
            "id": k.key_id,
            "name": k.params.name.value,
            "create_bucket": k.params.allow_create_bucket.value,
            "secret_key": k.params.secret_key if p.get("show_secret") else None,
            "buckets": {bid.hex(): {"read": perm.allow_read,
                                    "write": perm.allow_write,
                                    "owner": perm.allow_owner}
                        for bid, perm in k.params.authorized_buckets.items()},
        }

    async def op_key_allow(self, p):
        if p.get("create_bucket"):
            await self.helper.set_key_create_bucket(p["key"], True)
        return {"ok": True}

    async def op_key_deny(self, p):
        if p.get("create_bucket"):
            await self.helper.set_key_create_bucket(p["key"], False)
        return {"ok": True}

    async def op_key_delete(self, p):
        await self.helper.delete_key(p["key"])
        return {"ok": True}

    async def op_key_import(self, p):
        from ..model.key_table import Key

        k = Key.import_key(p["key_id"], p["secret_key"], p.get("name", ""))
        await self.garage.key_table.insert(k)
        return {"key_id": k.key_id}

    # ---- repair / block ops / snapshot (ref: garage/admin/mod.rs
    # launch repairs + block ops, garage/repair/online.rs) ---------------

    async def op_repair(self, p):
        from ..model.repair import launch_repair

        what = p.get("what", "")
        if what == "scrub":
            return await self._scrub_cmd(p.get("cmd", "start"))
        msg = launch_repair(self.garage, what)
        return {"ok": True, "msg": msg}

    async def _scrub_cmd(self, cmd: str):
        sw = getattr(self.garage.block_manager, "scrub_worker", None)
        if sw is None:
            raise BadRequest("no scrub worker on this node")
        try:
            sw.command(cmd)
        except ValueError as e:
            raise BadRequest(str(e))
        return {"ok": True, "msg": f"scrub {cmd}"}

    async def op_block_list_errors(self, p):
        res = self.garage.block_manager.resync
        # iter_errors scans the resync error tree (GL10)
        errors = await asyncio.to_thread(lambda: list(res.iter_errors()))
        return {"errors": [
            {"hash": h.hex(), "failures": count, "next_try_ms": next_ms}
            for h, count, next_ms in errors
        ]}

    async def op_block_info(self, p):
        try:
            h = bytes.fromhex(p["hash"])
        except ValueError:
            raise BadRequest(f"not a hex block hash: {p['hash']!r}")
        m = self.garage.block_manager
        state, at = m.rc.get(h)
        refs = []
        store = self.garage.block_ref_table.data
        raws = await asyncio.to_thread(store.read_range, h, None, None,
                                       100)
        for raw in raws:
            e = store.decode_stored(raw)
            refs.append({"version": e.version.hex(),
                         "deleted": e.deleted.value})
        return {
            "hash": h.hex(),
            "rc": state,
            "deletable_at": at,
            "stored_locally": (m.local_parts(h) if m.erasure
                               else m.has_local(h)),
            "refs": refs,
        }

    async def op_block_retry_now(self, p):
        res = self.garage.block_manager.resync
        try:
            hashes = [bytes.fromhex(x) for x in p.get("hashes", [])]
        except ValueError as e:
            raise BadRequest(f"bad block hash: {e}")
        n = await asyncio.to_thread(res.retry_now, hashes,
                                    bool(p.get("all")))
        return {"ok": True, "count": n}

    async def op_block_purge(self, p):
        """Tombstone every version referencing the block (cascades to
        refs + object entries; ref: admin/block.rs handle_block_purge)."""
        from ..model.s3.mpu_table import MultipartUpload
        from ..model.s3.object_table import (Object, ObjectVersion,
                                             ObjectVersionState)
        from ..model.s3.version_table import BACKLINK_OBJECT, Version

        try:
            hashes = [bytes.fromhex(x) for x in p.get("hashes", [])]
        except ValueError as e:
            raise BadRequest(f"bad block hash: {e}")
        purged_versions = 0
        purged_objects = 0
        purged_mpus = 0

        async def abort_object_version(bucket_id, key, uuid):
            kb = key.encode() if isinstance(key, str) else key
            obj = await self.garage.object_table.get(bucket_id, kb)
            if obj is None:
                return 0
            aborted = [ObjectVersion(ov.uuid, ov.timestamp,
                                     ObjectVersionState.aborted())
                       for ov in obj.versions if ov.uuid == uuid]
            if not aborted:
                return 0
            await self.garage.object_table.insert(Object(
                bucket_id, key if isinstance(key, str) else key.decode(),
                aborted))
            return 1

        for h in hashes:
            data = self.garage.block_ref_table.data
            raws = await asyncio.to_thread(data.read_range, h, None,
                                           None, 10000)
            refs = [data.decode_stored(raw) for raw in raws]
            for ref in refs:
                if ref.deleted.value:
                    continue
                v = await self.garage.version_table.get(ref.version, b"")
                if v is None:
                    continue
                if v.backlink[0] == BACKLINK_OBJECT:
                    _, bucket_id, key = v.backlink
                    purged_objects += await abort_object_version(
                        bucket_id, key, v.uuid)
                else:
                    # MPU-backed part: abort the whole upload — its
                    # object uploading-version AND the mpu row — or the
                    # client could still "complete" an upload whose data
                    # is gone (ref: admin/block.rs handle_block_purge)
                    upload_id = v.backlink[1]
                    mpu = await self.garage.mpu_table.get(upload_id, b"")
                    if mpu is not None and not mpu.deleted.value:
                        purged_objects += await abort_object_version(
                            mpu.bucket_id, mpu.key, upload_id)
                        await self.garage.mpu_table.insert(
                            MultipartUpload.new(upload_id, mpu.timestamp,
                                                mpu.bucket_id, mpu.key,
                                                deleted=True))
                        purged_mpus += 1
                await self.garage.version_table.insert(
                    Version.new(v.uuid, v.backlink, deleted=True))
                purged_versions += 1
        return {"ok": True, "versions": purged_versions,
                "objects": purged_objects, "mpus": purged_mpus}

    async def op_meta_snapshot(self, p):
        import asyncio

        from ..model.snapshot import snapshot_metadata

        path = await asyncio.to_thread(snapshot_metadata, self.garage)
        return {"ok": True, "path": path}

    async def op_worker_get(self, p):
        bv = self.garage.bg_vars
        if p.get("name"):
            try:
                return {"vars": {p["name"]: bv.get(p["name"])}}
            except KeyError:
                raise BadRequest(
                    f"unknown variable {p['name']!r}; known: "
                    f"{', '.join(sorted(bv.all()))}")
        return {"vars": bv.all()}

    async def op_worker_set(self, p):
        bv = self.garage.bg_vars
        try:
            bv.set(p["name"], p["value"])
            return {"ok": True, "value": bv.get(p["name"])}
        except KeyError:
            raise BadRequest(
                f"unknown variable {p['name']!r}; known: "
                f"{', '.join(sorted(bv.all()))}")
        except ValueError as e:
            raise BadRequest(str(e))

    # ---- workers / stats ----------------------------------------------

    async def op_worker_list(self, p):
        infos = self.garage.runner.worker_info()
        return {"workers": [
            {"id": wid, "name": i.name, "state": getattr(i, "state", ""),
             "queue": i.queue_length, "errors": i.persistent_errors,
             "tranquility": i.tranquility, "progress": i.progress}
            for wid, i in sorted(infos.items())
        ]}

    async def op_stats(self, p):
        g = self.garage
        tables = {t.name: t.data.stats() for t in g.all_tables()}
        return {
            "tables": tables,
            "block": dict(g.block_manager.metrics),
            "resync_queue": g.block_manager.resync.queue_len(),
            "resync_errors": g.block_manager.resync.errors_len(),
            "http": {},
        }
