"""Admin HTTP API: health/metrics + the v1 cluster-management REST API
(ported from the JAX package's admin/http.py).

Ref parity: src/api/admin/api_server.rs:232-330 + router_v1.rs (cluster
status/health/connect, layout staging, key + bucket CRUD, aliasing,
allow/deny) and rpc/system_metrics.rs for /metrics. Bearer-token auth
via admin_token (management) / metrics_token (/metrics); /health is
always public (used by load balancers). Management endpoints delegate
to the same AdminRpcHandler ops the CLI drives, so both operator
surfaces stay behavior-identical.

What differs from the JAX package, all of it about the device feeder
(block/feeder.py):
- /v1/s3/tuning keeps every knob of the JAX package, within its ranges:
  the S3, read-cache and cache-tier knobs, `feeder_inflight_batches`
  (the batches in flight through the staged pipeline, applied from the
  next batch on) and the routing floors `feeder_device_min_*`, which
  the feeder's "auto" mode reads at every batch.
- /metrics exports every feeder counter of the JAX package, plus
  `feeder_device_fallbacks` (always 0: a failed device group fails its
  requests), `feeder_mesh_batches` counts the batches split over the
  device grid (parallel/mesh.py), `feeder_recompiles` the distinct
  launch shapes (the kernels are built once; no shape compiles
  anything), and `feeder_kernel_launches{kernel}` the launches of each
  hand-written kernel in this process (a gateway worker's under its
  `worker` label).
"""

from __future__ import annotations

import json

from .. import __version__
from ..api.http import HttpServer, Request, Response
from ..utils.error import BadRequest, GarageError, NoSuchBucket, NoSuchKey


def _json(body, status: int = 200) -> Response:
    return Response(status, [("content-type", "application/json")],
                    json.dumps(body, default=str).encode())


# ---- runtime-knob application ------------------------------------------

# Module-level so BOTH operator surfaces share one implementation: the
# admin HTTP routes below, and the gateway worker RPC handler
# (gateway/worker.py) that the supervisor fans /v1/s3/tuning, /v1/qos
# and /v1/chaos writes out through — runtime knobs keep working when
# the frontend is N worker processes instead of one.

def apply_s3_tuning(garage, spec: dict) -> dict:
    """Validate-then-apply the S3 data-plane knobs; returns the live
    state (the GET payload). A 400 must never leave half the update
    applied on a live node."""
    cfg = garage.config
    cache = garage.block_manager.cache
    feeder = garage.block_manager.feeder
    tier = getattr(garage.block_manager, "cache_tier", None)
    bounds = {"get_readahead_blocks": (0, 64),
              # cluster cache tier (block/cache_tier.py): runtime
              # on/off + hint breadth, so an operator can shed the
              # tier under incident pressure without a restart
              "cache_tier": (0, 1),
              "cache_tier_hint_top_n": (1, 256),
              "put_blocks_max_parallel": (1, 64),
              # hot-block read cache (block/cache.py): size + admission
              # knobs, live-resizable so bench sweeps flip the cache
              # on/off without a server restart (0 = disabled)
              "read_cache_max_bytes": (0, 1 << 40),
              "read_cache_probation_pct": (1, 90),
              # device feeder ([tpu] knobs, block/feeder.py): pipeline
              # depth and host/device routing floors, live-tunable so
              # bench sweeps walk the overlap/latency trade without a
              # server restart
              "feeder_inflight_batches": (1, 16),
              "feeder_device_min_bytes": (0, 1 << 40),
              "feeder_device_min_items": (1, 4096),
              # read-side routing floors (decode/repair)
              "feeder_device_min_decode_bytes": (0, 1 << 40),
              "feeder_device_min_decode_items": (1, 4096)}
    validated = {}
    for k, raw in spec.items():
        if k not in bounds:
            raise BadRequest(f"unknown s3 tuning knob {k!r}")
        if k.startswith("cache_tier") and tier is None:
            raise BadRequest(
                "cache tier is disabled in config "
                "([block] cache_tier = false); restart to enable")
        lo, hi = bounds[k]
        v = int(raw)
        if v < lo or v > hi:
            raise BadRequest(f"{k} must be in [{lo}, {hi}]")
        validated[k] = v
    for k, v in validated.items():
        if k == "read_cache_max_bytes":
            cfg.block_read_cache_max_bytes = v
            cache.configure(max_bytes=v)
        elif k == "read_cache_probation_pct":
            cache.configure(probation_pct=v)
        elif k == "cache_tier":
            tier.enabled = bool(v)
        elif k == "cache_tier_hint_top_n":
            tier.hint_top_n = v
        elif k.startswith("feeder_"):
            setattr(feeder, k[len("feeder_"):], v)
        else:
            setattr(cfg, "s3_" + k, v)
    return s3_tuning_state(garage)


def s3_tuning_state(garage) -> dict:
    from ..api.http import DRAIN_HIGH_WATER

    cache = garage.block_manager.cache
    feeder = garage.block_manager.feeder
    return {
        "get_readahead_blocks": garage.config.s3_get_readahead_blocks,
        "put_blocks_max_parallel":
            garage.config.s3_put_blocks_max_parallel,
        "drain_high_water": DRAIN_HIGH_WATER,
        "read_cache_max_bytes": cache.max_bytes,
        "read_cache_probation_pct": cache.probation_pct,
        "read_cache": cache.stats(),
        "cache_tier": (garage.block_manager.cache_tier.stats()
                       if getattr(garage.block_manager, "cache_tier",
                                  None) is not None
                       else {"enabled": False}),
        "feeder_inflight_batches": feeder.inflight_batches,
        "feeder_device_min_bytes": feeder.device_min_bytes,
        "feeder_device_min_items": feeder.device_min_items,
        "feeder_device_min_decode_bytes": feeder.device_min_decode_bytes,
        "feeder_device_min_decode_items": feeder.device_min_decode_items,
        "feeder_pipeline": feeder.pipeline_stats(),
    }


def apply_chaos_spec(spec: dict) -> dict:
    """Validate-then-apply a fault-injection spec against THIS
    process's chaos controller; returns its state."""
    from ..chaos import injector as chaos_inj

    ctl = chaos_inj.controller()
    allowed = {"kind", "prob", "count", "node", "peer", "endpoint",
               "hash_prefix", "delay_s", "rate_bps"}
    # validate EVERYTHING before the first mutation — a 400 must never
    # leave the live controller half-updated (cleared, reseeded, or
    # with only some faults armed)
    new_faults = []
    for f in spec.get("faults", []):
        bad = set(f) - allowed
        if bad:
            raise BadRequest(f"unknown fault field(s): {sorted(bad)}")
        if f.get("kind") not in chaos_inj.ALL_KINDS:
            raise BadRequest(
                f"unknown fault kind {f.get('kind')!r} "
                f"(kinds: {', '.join(chaos_inj.ALL_KINDS)})")
        fs = chaos_inj.FaultSpec(
            kind=f["kind"],
            prob=float(f.get("prob", 1.0)),
            count=(int(f["count"])
                   if f.get("count") is not None else None),
            node=str(f.get("node", "")),
            peer=str(f.get("peer", "")),
            endpoint=str(f.get("endpoint", "")),
            hash_prefix=str(f.get("hash_prefix", "")),
            delay_s=float(f.get("delay_s", 0.05)),
            rate_bps=float(f.get("rate_bps", 1 << 20)))
        if not 0.0 <= fs.prob <= 1.0:
            raise BadRequest("prob must be in [0, 1]")
        new_faults.append(fs)
    seed = int(spec["seed"]) if "seed" in spec else None
    if spec.get("clear"):
        ctl.clear()
    if seed is not None:
        ctl.reseed(seed)
    for fs in new_faults:
        ctl.add(fs)
    if "enabled" in spec:
        if spec["enabled"]:
            chaos_inj.arm()
        else:
            chaos_inj.disarm(clear=False)
    elif new_faults:
        chaos_inj.arm()  # arming faults implies enabling
    return ctl.state()


def relabel_metrics(text: str, worker: str) -> list[str]:
    """Stamp a `worker` label onto every sample line of a worker's
    Prometheus text exposition (HELP/TYPE lines dropped — the store's
    own render already carries them once). Merging N workers' renders
    this way is what makes per-worker series addressable
    (`api_request_duration_seconds_count{api="s3",worker="1"}`)."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_labels, _, value = line.rpartition(" ")
        if not name_labels:
            continue
        if name_labels.endswith("}"):
            out.append(f'{name_labels[:-1]},worker="{worker}"}} {value}')
        else:
            out.append(f'{name_labels}{{worker="{worker}"}} {value}')
    return out


class AdminHttpServer:
    def __init__(self, garage, admin_rpc=None):
        self.garage = garage
        self.http = HttpServer(self.handle, name="admin")
        if admin_rpc is None:
            from .rpc import AdminRpcHandler

            admin_rpc = AdminRpcHandler(garage)
        self.rpc = admin_rpc

    async def start(self, host: str, port=None) -> None:
        # a path (port None) binds a Unix-domain socket, like the
        # reference's UnixOrTCPSocketAddress bind addresses
        if port is None:
            await self.http.start_unix(host)
        else:
            await self.http.start(host, port)

    async def stop(self) -> None:
        await self.http.stop()

    def _authorized(self, req: Request, token) -> bool:
        if token is None:
            return True
        return req.header("authorization") == f"Bearer {token}"

    @staticmethod
    def _bucket_info_json(r: dict) -> dict:
        wc = r.get("website")
        return {
            "id": r["id"], "globalAliases": r["aliases"],
            "keys": r["keys"], "objects": r["objects"],
            "bytes": r["bytes"],
            "unfinishedUploads": r["unfinished_uploads"],
            "websiteAccess": wc is not None,
            "websiteConfig": ({"indexDocument": wc.get("index_document"),
                               "errorDocument": wc.get("error_document")}
                              if wc else None),
            "quotas": {"maxSize": r.get("quotas", {}).get("max_size"),
                       "maxObjects": r.get("quotas", {}).get("max_objects")},
        }

    async def handle(self, req: Request) -> Response:
        path = req.path
        if path == "/health":
            h = self.garage.system.health()
            status = 200 if h.status.value != "unavailable" else 503
            return Response(status, [("content-type", "text/plain")],
                            f"{h.status.value}\n".encode())
        if path == "/metrics":
            if not self._authorized(req, self.garage.config.metrics_token):
                return Response(403, [], b"forbidden")
            # the first table_size_bytes read scans each table for its
            # baseline — do that off the event loop ONCE; steady-state
            # scrapes read the cached base + delta inline
            import asyncio

            if any(t.data._bytes_base is None
                   for t in self.garage.all_tables()):
                await asyncio.to_thread(
                    lambda: [t.data.size_bytes()
                             for t in self.garage.all_tables()])
            # the whole render runs off-loop: per-table row counts and
            # the metadata engine_stats() are COUNT(*) scans on sqlite —
            # at millions of rows a scrape must not stall the loop
            body = await asyncio.to_thread(self.render_metrics)
            sup = getattr(self.garage, "gateway_supervisor", None)
            if sup is not None:
                # aggregate the worker processes' series under a
                # `worker` label (best-effort: a worker mid-respawn is
                # skipped, its absence shows in gateway_worker_up)
                lines = []
                for idx, res in (await sup.fanout({"op": "metrics"},
                                                  timeout=15.0)).items():
                    if isinstance(res, dict) and "text" in res:
                        lines.extend(relabel_metrics(res["text"],
                                                     str(idx)))
                body += "\n".join(lines) + ("\n" if lines else "")
            return Response(200,
                            [("content-type",
                              "text/plain; version=0.0.4")],
                            body.encode())
        if path == "/check" and req.method == "GET":
            return await self._check_domain(req)
        if path == "/v1/trace" and req.method == "GET":
            # span ring tail (admin-token gated like management routes);
            # ?limit=N caps the tail. Ref: the reference exports spans
            # via OTLP (garage/tracing_setup.rs); this surfaces the same
            # span stream without a collector.
            if self.garage.config.admin_token is None \
                    or not self._authorized(req,
                                            self.garage.config.admin_token):
                return Response(403, [], b"forbidden")
            from ..utils.tracing import tracer

            try:
                limit = int(req.query.get("limit", "200"))
            except ValueError:
                return _json({"code": "InvalidRequest",
                              "message": "limit must be an integer"}, 400)
            limit = max(1, min(limit, 2048))
            spans = list(tracer.ring)[-limit:]
            return _json({"enabled": tracer.enabled, "spans": spans}, 200)
        # management endpoints: an UNSET admin token means access is
        # always denied (the reference's admin_token semantics) —
        # /metrics above differs deliberately (open when no
        # metrics_token is configured, for scrapers)
        if self.garage.config.admin_token is None \
                or not self._authorized(req,
                                        self.garage.config.admin_token):
            return Response(403, [], b"forbidden")
        try:
            resp = await self._route_v1(req)
        except (BadRequest, NoSuchBucket, NoSuchKey, GarageError) as e:
            code = 404 if isinstance(e, (NoSuchBucket, NoSuchKey)) else 400
            return _json({"code": type(e).__name__, "message": str(e)},
                         code)
        except (KeyError, ValueError) as e:
            return _json({"code": "InvalidRequest", "message": str(e)}, 400)
        if resp is None:
            return _json({"code": "NotFound",
                          "message": f"no such endpoint {req.method} {path}"},
                         404)
        return resp

    # ---- v1 management REST (ref: router_v1.rs:97-131) -----------------

    async def _route_v1(self, req: Request):  # noqa: C901
        m = req.method
        path = req.path
        if path.startswith("/v0/"):
            path = "/v1/" + path[4:]  # v0 compat: same handlers
        q = req.query

        async def body_json():
            raw = await req.body.read_all(limit=1 << 20)
            return json.loads(raw.decode()) if raw else None

        if path == "/v1/s3/tuning":
            # S3 data-plane knobs (README "S3 data-plane tuning"):
            # runtime-readable AND writable so bench sweeps don't need a
            # server restart per setting. Writes touch plain ints read
            # fresh on every request — safe on a live node. In gateway
            # mode the write fans out to every worker process (theirs
            # are the caches/configs actually serving traffic).
            if m == "POST":
                spec = await body_json() or {}
                state = apply_s3_tuning(self.garage, spec)
                sup = getattr(self.garage, "gateway_supervisor", None)
                if sup is not None and spec:
                    state["workers"] = await sup.fanout(
                        {"op": "tuning", "spec": spec})
                return _json(state)
            elif m != "GET":
                return None
            return _json(s3_tuning_state(self.garage))

        if path == "/v1/chaos":
            # fault injection control plane (garage_tpu/chaos/): GET
            # reports armed faults + fired counts; POST arms/updates.
            # Body: {"enabled": bool, "seed": int, "clear": bool,
            #        "faults": [{kind, prob, count, node, peer,
            #                    endpoint, hash_prefix, delay_s,
            #                    rate_bps}, ...]}
            # Gateway mode: the spec ALSO fans out to every worker
            # process — net/rpc faults scoped at the API side must fire
            # in the processes actually making those calls.
            from ..chaos import injector as chaos_inj

            if m == "POST":
                spec = await body_json() or {}
                state = apply_chaos_spec(spec)
                sup = getattr(self.garage, "gateway_supervisor", None)
                if sup is not None:
                    state["workers"] = await sup.fanout(
                        {"op": "chaos", "spec": spec})
                return _json(state)
            elif m != "GET":
                return None
            return _json(chaos_inj.controller().state())

        if path == "/v1/zones" and m == "GET":
            # per-zone health rollup (garage_tpu/zones/):
            # up / degraded / partitioned per zone, derived live from
            # peering state — during a zone partition this flips within
            # one ping interval, observer-relative (each side of the
            # cut sees the OTHER side partitioned)
            return _json(self.garage.system.zone_health.snapshot())

        if path == "/v1/metadata" and m == "GET":
            # metadata-engine observability (README "Metadata at
            # scale"): per-engine internals (lsm: segments, compaction
            # backlog, WAL/memtable bytes; sqlite: file size), per-table
            # row/todo depths, compaction worker state, and the
            # resize-phase readout so one call answers "what is the
            # metadata plane doing right now"
            import asyncio as _aio

            g = self.garage

            def collect():
                # engine_stats + per-table depths are COUNT(*) scans on
                # sqlite: keep them off the event loop (GL01 in spirit)
                return (g.db.engine_stats(),
                        {t.name: t.data.stats() for t in g.all_tables()})

            engine, tables = await _aio.to_thread(collect)
            lm = getattr(g, "lsm_maintenance", None)
            maintenance = None
            if lm is not None:
                maintenance = {"steps": lm.steps,
                               "tranquility": round(lm.tranquility, 4),
                               "backlog": engine.get(
                                   "compaction_backlog", 0)}
            from ..utils.metrics import registry as _reg

            phases = {}
            for labels, count, total, mx in _reg().series(
                    "resize_phase_seconds"):
                phases[labels.get("phase", "?")] = {
                    "count": count, "total_s": round(total, 3),
                    "max_s": round(mx, 3)}
            return _json({"engine": engine, "tables": tables,
                          "compaction": maintenance,
                          "resize_phase_seconds": phases})
        if path == "/v1/resize" and m == "GET":
            # operator progress readout for a live layout transition
            # (satellite; an earlier change follow-on): phases with timings
            # (from the resize_phase_seconds series the orchestrator
            # records), per-node ack/sync trackers with the LAGGING
            # nodes named per phase, and the rebalance backlog — one
            # call answers "how far along is the resize and who is
            # holding it up".
            g = self.garage
            hist = g.system.layout_manager.history
            helper = g.system.layout_manager.helper
            current = hist.current().version
            min_stored = hist.min_stored()
            trackers = hist.update_trackers
            nodes = []
            for n in sorted(hist.all_storage_nodes()):
                ack = trackers.ack.get(n, min_stored)
                sync = trackers.sync.get(n, min_stored)
                sync_ack = trackers.sync_ack.get(n, min_stored)
                lagging = [ph for ph, v in (("ack", ack),
                                            ("sync", sync),
                                            ("commit", sync_ack))
                           if v < current]
                nodes.append({"node": n.hex()[:16], "ack": ack,
                              "sync": sync, "sync_ack": sync_ack,
                              "lagging": lagging})
            from ..utils.metrics import registry as _reg

            phases = {}
            for labels, count, total, mx in _reg().series(
                    "resize_phase_seconds"):
                phases[labels.get("phase", "?")] = {
                    "count": count, "total_s": round(total, 3),
                    "max_s": round(mx, 3)}
            completed = sum(
                c for _l, c, _t, _m in _reg().series(
                    "resize_transitions_completed"))
            res = g.block_manager.resync
            return _json({
                "layout_version": current,
                "min_stored": min_stored,
                "ack_min": helper.ack_map_min(),
                "sync_min": helper.sync_map_min(),
                "resizing": min_stored < current,
                "phases": phases,
                "transitions_completed": completed,
                "nodes": nodes,
                "rebalance_backlog": res.queue_len(),
                "rebalance_errors": res.errors_len(),
            })

        if path == "/v1/cache" and m == "GET":
            # cache observability: per-segment bytes/entries,
            # the cluster tier's lease table + prefetch queue depth, and
            # the node-local singleflight collapse counts — one stop for
            # "is the cold-herd machinery actually engaging?"
            bm = getattr(self.garage, "block_manager", None)
            if bm is None:
                return _json({"enabled": False})
            out = {"enabled": True,
                   "plain": bm.cache.stats(),
                   "singleflight": {
                       "leaders": bm.sf_leaders,
                       "collapsed": bm.sf_collapsed,
                       "in_flight": len(bm._sf),
                   }}
            pc = getattr(bm, "packed_cache", None)
            if pc is not None:
                out["packed"] = pc.stats()
            tier = getattr(bm, "cache_tier", None)
            out["tier"] = tier.stats() if tier is not None else None
            return _json(out)

        if path == "/v1/qos" and m == "GET":
            return _json(self._qos_state())
        if path == "/v1/qos" and m == "POST":
            spec = await body_json() or {}
            qos = getattr(self.garage, "qos", None)
            if qos is None:
                raise BadRequest("qos engine not available")
            gov = getattr(self.garage, "qos_governor", None)
            gov_spec = spec.pop("governor", None)
            sup = getattr(self.garage, "gateway_supervisor", None)
            if sup is not None:
                bad = sorted(k for k in spec
                             if k in ("global_burst",
                                      "global_bytes_burst"))
                if bad:
                    # not silently droppable: leases re-derive burst as
                    # 1s of each worker's granted rate on every renew,
                    # so a fanned-out burst would be overwritten within
                    # one lease interval. Reject before applying
                    # anything so the operator learns the limitation.
                    raise BadRequest(
                        f"{', '.join(bad)} cannot be set in gateway "
                        "mode: worker burst is leased as 1s of each "
                        "worker's granted rate (set global_rps / "
                        "global_bytes_per_s instead)")
            if spec:
                qos.update_limits(spec)
            if sup is not None and spec:
                # node-wide budgets feed the lease broker (each worker
                # learns its new share at its next renew — conservation
                # holds through the change); every other limit applies
                # per worker process and fans out directly
                if "global_rps" in spec:
                    sup.broker.set_totals(rps=spec["global_rps"])
                if "global_bytes_per_s" in spec:
                    sup.broker.set_totals(
                        bytes_per_s=spec["global_bytes_per_s"])
                worker_spec = {k: v for k, v in spec.items()
                               if not k.startswith("global_")}
                if worker_spec:
                    await sup.fanout({"op": "qos", "spec": worker_spec})
            if gov_spec is not None:
                if gov is None:
                    raise BadRequest("governor not running "
                                     "(disabled in config)")
                if isinstance(gov_spec, bool):
                    gov_spec = {"enabled": gov_spec}
                if "enabled" in gov_spec:
                    gov.enabled = bool(gov_spec["enabled"])
                if "target_latency_s" in gov_spec:
                    t = float(gov_spec["target_latency_s"])
                    if t <= 0:
                        raise BadRequest("target_latency_s must be > 0")
                    gov.target_latency = t
                if "scrub_range" in gov_spec:
                    lo, hi = map(float, gov_spec["scrub_range"])
                    gov.scrub_range = (lo, hi)
                if "resync_range" in gov_spec:
                    lo, hi = map(float, gov_spec["resync_range"])
                    gov.resync_range = (lo, hi)
            return _json(self._qos_state())

        if path == "/v1/gateway" and m == "GET":
            # multi-process gateway observability (gateway/supervisor):
            # worker pids/liveness/restarts, per-worker leases, broker
            # conservation. ?detail=1 additionally pulls each live
            # worker's qos + tuning snapshots over RPC.
            sup = getattr(self.garage, "gateway_supervisor", None)
            if sup is None:
                return _json({"enabled": False, "workers": []})
            state = sup.state()
            if q.get("detail"):
                state["worker_qos"] = await sup.fanout(
                    {"op": "qos_state"})
                state["worker_tuning"] = await sup.fanout(
                    {"op": "tuning_state"})
            return _json(state)

        if path in ("/status", "/v1/status") and m == "GET":
            r = await self.rpc.op_status({})
            return _json({
                "node": r["node_id"].hex(),
                "garageVersion": f"garage-tpu-{__version__}",
                "clusterHealth": r["health"],
                "layoutVersion": r["layout_version"],
                "nodes": [{
                    "id": n["id"].hex(),
                    "addr": (f"{n['addr'][0]}:{n['addr'][1]}"
                             if n.get("addr") else None),
                    "isUp": n["is_up"],
                    "hostname": n.get("hostname", ""),
                    "role": n.get("role"),
                } for n in r["nodes"]],
            })
        if path == "/v1/health" and m == "GET":
            h = self.garage.system.health()
            return _json({
                "status": h.status.value,
                "knownNodes": h.known_nodes,
                "connectedNodes": h.connected_nodes,
                "storageNodes": h.storage_nodes,
                "storageNodesOk": h.storage_nodes_up,
                "partitions": 256,
                "partitionsQuorum": h.partitions_quorum,
            })
        if path == "/v1/connect" and m == "POST":
            peers = await body_json() or []
            from ..model.garage import parse_peer

            results = []
            for p in peers:
                try:
                    addr, nid = parse_peer(p)
                    await self.rpc.op_connect(
                        {"addr": list(addr), "id": nid})
                    results.append({"success": True, "error": None})
                except Exception as e:
                    results.append({"success": False, "error": str(e)})
            return _json(results)

        if path == "/v1/layout" and m == "GET":
            r = await self.rpc.op_layout_show({})
            return _json({"version": r["version"], "roles": r["roles"],
                          "stagedRoleChanges": r["staged"]})
        if path == "/v1/layout" and m == "POST":
            changes = await body_json() or []
            for c in changes:
                nid = bytes.fromhex(c["id"])
                if c.get("remove"):
                    await self.rpc.op_layout_remove({"node": nid})
                else:
                    # a role change must be complete — defaulting zone or
                    # capacity would silently relocate/drain the node
                    if "zone" not in c or "capacity" not in c:
                        raise BadRequest(
                            "role change requires zone and capacity "
                            "(capacity null = gateway)")
                    cap = c["capacity"]
                    if isinstance(cap, str):
                        from ..utils.config import parse_capacity

                        cap = parse_capacity(cap)
                    await self.rpc.op_layout_assign({
                        "node": nid, "zone": c["zone"],
                        "capacity": cap,
                        "tags": c.get("tags", []),
                    })
            return _json({"ok": True})
        if path == "/v1/layout/apply" and m == "POST":
            spec = await body_json() or {}
            r = await self.rpc.op_layout_apply(
                {"version": spec.get("version")})
            return _json({"layout": {"version": r["version"]}})
        if path == "/v1/layout/revert" and m == "POST":
            self.garage.system.layout_manager.revert_staged()
            return _json({"ok": True})

        if path == "/v1/key" and m == "GET":
            if q.get("id") or q.get("search"):
                key_id = q.get("id")
                if not key_id:
                    for k in (await self.rpc.op_key_list({}))["keys"]:
                        if k["id"].startswith(q["search"]) \
                                or q["search"] in k["name"]:
                            key_id = k["id"]
                            break
                    if not key_id:
                        raise NoSuchKey(q["search"])
                r = await self.rpc.op_key_info(
                    {"key": key_id,
                     "show_secret": q.get("showSecretKey") == "true"})
                return _json(self._key_info_json(r))
            r = await self.rpc.op_key_list({})
            return _json([{"id": k["id"], "name": k["name"]}
                          for k in r["keys"]])
        if path == "/v1/key" and m == "POST":
            if q.get("id"):
                spec = await body_json() or {}
                if spec.get("allow", {}).get("createBucket"):
                    await self.rpc.op_key_allow({"key": q["id"],
                                                 "create_bucket": True})
                if spec.get("deny", {}).get("createBucket"):
                    await self.rpc.op_key_deny({"key": q["id"],
                                                "create_bucket": True})
                r = await self.rpc.op_key_info({"key": q["id"]})
                return _json(self._key_info_json(r))
            spec = await body_json() or {}
            r = await self.rpc.op_key_new({"name": spec.get("name", "")})
            return _json({"accessKeyId": r["key_id"],
                          "secretAccessKey": r["secret_key"]})
        if path == "/v1/key/import" and m == "POST":
            spec = await body_json() or {}
            r = await self.rpc.op_key_import({
                "key_id": spec["accessKeyId"],
                "secret_key": spec["secretAccessKey"],
                "name": spec.get("name", ""),
            })
            return _json({"accessKeyId": r["key_id"]})
        if path == "/v1/key" and m == "DELETE":
            await self.rpc.op_key_delete({"key": q["id"]})
            return Response(204)

        if path == "/v1/bucket" and m == "GET":
            if q.get("id") or q.get("globalAlias"):
                name = q.get("globalAlias") or q["id"]
                r = await self.rpc.op_bucket_info({"name": name})
                return _json(self._bucket_info_json(r))
            r = await self.rpc.op_bucket_list({})
            return _json([{"id": b["id"], "globalAliases": [b["name"]]}
                          for b in r["buckets"]])
        if path == "/v1/bucket" and m == "PUT" and q.get("id"):
            # UpdateBucket: website access flags + quotas — PUT with id,
            # matching the reference admin v1 route so admin SDKs work
            # (ref: src/api/admin/bucket.rs:405-452 handle_update_bucket)
            bid = bytes.fromhex(q["id"])
            await self.rpc.helper.get_existing_bucket(bid)
            spec = await body_json() or {}
            # validate EVERYTHING first, then apply atomically — a 400
            # must never leave half the update persisted
            updates: dict = {}
            if "websiteAccess" in spec:
                wa = spec["websiteAccess"]
                if not isinstance(wa, dict):
                    raise BadRequest("websiteAccess must be an object")
                if wa.get("enabled"):
                    idx = wa.get("indexDocument")
                    if not idx:
                        raise BadRequest(
                            "indexDocument is required to enable website "
                            "access")
                    updates["website_config"] = {
                        "index_document": idx,
                        "error_document": wa.get("errorDocument")}
                else:
                    updates["website_config"] = None
            if "quotas" in spec:
                qt = spec["quotas"]
                if not isinstance(qt, dict):
                    raise BadRequest("quotas must be an object")
                ms, mo = qt.get("maxSize"), qt.get("maxObjects")
                if (ms is not None and int(ms) <= 0) \
                        or (mo is not None and int(mo) <= 0):
                    raise BadRequest("quota values must be positive")
                updates["quotas"] = {
                    "max_size": int(ms) if ms is not None else None,
                    "max_objects": int(mo) if mo is not None else None}
            if updates:
                await self.rpc.helper.update_bucket_configs(bid, updates)
            r = await self.rpc.op_bucket_info({"name": q["id"]})
            return _json(self._bucket_info_json(r))
        if path == "/v1/bucket" and m == "POST":
            spec = await body_json() or {}
            alias = spec.get("globalAlias")
            if not alias:
                raise BadRequest("globalAlias is required")
            r = await self.rpc.op_bucket_create({"name": alias})
            return _json({"id": r["id"], "globalAliases": [alias]})
        if path == "/v1/bucket" and m == "DELETE":
            await self.rpc.helper.delete_bucket(bytes.fromhex(q["id"]))
            return Response(204)

        if path == "/v1/bucket/allow" and m == "POST":
            spec = await body_json() or {}
            perms = spec.get("permissions", {})
            await self.rpc.op_bucket_allow({
                "bucket": spec["bucketId"], "key": spec["accessKeyId"],
                "read": perms.get("read"), "write": perms.get("write"),
                "owner": perms.get("owner"),
            })
            return _json({"ok": True})
        if path == "/v1/bucket/deny" and m == "POST":
            spec = await body_json() or {}
            perms = spec.get("permissions", {})
            await self.rpc.op_bucket_deny({
                "bucket": spec["bucketId"], "key": spec["accessKeyId"],
                "read": perms.get("read"), "write": perms.get("write"),
                "owner": perms.get("owner"),
            })
            return _json({"ok": True})

        if path == "/v1/bucket/alias/global":
            helper = self.rpc.helper
            bid = bytes.fromhex(q["id"])
            if m == "PUT":
                await helper.global_alias_bucket(bid, q["alias"])
                return _json({"ok": True})
            if m == "DELETE":
                await helper.global_unalias_bucket(bid, q["alias"])
                return _json({"ok": True})
        if path == "/v1/bucket/alias/local":
            helper = self.rpc.helper
            bid = bytes.fromhex(q["id"])
            if m == "PUT":
                await helper.local_alias_bucket(bid, q["accessKeyId"],
                                                q["alias"])
                return _json({"ok": True})
            if m == "DELETE":
                await helper.local_unalias_bucket(bid, q["accessKeyId"],
                                                  q["alias"])
                return _json({"ok": True})

        return None

    def _qos_state(self) -> dict:
        qos = getattr(self.garage, "qos", None)
        gov = getattr(self.garage, "qos_governor", None)
        out = qos.state() if qos is not None else {}
        out["governor"] = gov.state() if gov is not None else None
        sup = getattr(self.garage, "gateway_supervisor", None)
        if sup is not None:
            out["gateway_leases"] = sup.broker.state()
        return out

    async def _check_domain(self, req: Request) -> Response:
        """Website vhost check for reverse proxies; deliberately
        UNAUTHENTICATED like the reference (api_server.rs routes
        CheckDomain before auth — on-demand-TLS issuers don't hold
        admin tokens)."""
        domain = req.query.get("domain", "")
        helper = self.rpc.helper
        name = domain.split(":")[0]
        root = self.garage.config.web_root_domain
        if name.endswith(root):
            name = name[: -len(root)]
        try:
            bid = await helper.resolve_global_bucket_name(name)
            if bid is not None:
                b = await helper.get_existing_bucket(bid)
                if b.params.website_config.value is not None:
                    return Response(200, [], b"Domain is managed\n")
        except (NoSuchBucket, BadRequest):
            pass
        return Response(400, [], b"Domain not managed\n")

    @staticmethod
    def _key_info_json(r: dict) -> dict:
        return {
            "accessKeyId": r["id"], "name": r["name"],
            "secretAccessKey": r.get("secret_key"),
            "permissions": {"createBucket": r.get("create_bucket", False)},
            "buckets": [
                {"id": bid, "permissions": perms}
                for bid, perms in r.get("buckets", {}).items()
            ],
        }

    def render_metrics(self) -> str:
        """Prometheus text exposition from live counters
        (ref: rpc/system_metrics.rs, block/metrics.rs,
        table/metrics.rs)."""
        g = self.garage
        out = []

        def gauge(name, value, help_="", **labels):
            if help_:
                out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} gauge")
            lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
            out.append(f"{name}{{{lab}}} {value}" if lab
                       else f"{name} {value}")

        h = g.system.health()
        gauge("cluster_healthy", 1 if h.status.value == "healthy" else 0,
              "Whether the cluster is fully healthy")
        gauge("cluster_available", 1 if h.status.value != "unavailable" else 0)
        gauge("cluster_known_nodes", h.known_nodes)
        gauge("cluster_connected_nodes", h.connected_nodes)
        gauge("cluster_storage_nodes", h.storage_nodes)
        gauge("cluster_storage_nodes_up", h.storage_nodes_up)
        gauge("cluster_partitions_quorum", h.partitions_quorum)
        gauge("cluster_layout_version",
              g.system.layout_manager.history.current().version)

        out.append("# TYPE block_manager_bytes counter")
        for k, v in g.block_manager.metrics.items():
            gauge(f"block_{k}", v)
        gauge("block_resync_queue_length",
              g.block_manager.resync.queue_len(),
              "Number of blocks in the resync queue")
        gauge("block_resync_errored_blocks",
              g.block_manager.resync.errors_len())
        # the resize plane watches the same queue under its own name:
        # during a layout transition this IS the rebalance backlog,
        # and "backlog drained to zero" is the smoke/soak assertion
        gauge("resync_backlog", g.block_manager.resync.queue_len(),
              "Rebalance/resync backlog (blocks awaiting "
              "re-examination)")
        gauge("resize_layout_min_stored",
              g.system.layout_manager.history.min_stored(),
              "Oldest live layout version (== current once a resize "
              "fully commits)")
        gauge("resize_layout_ack_min",
              g.system.layout_manager.helper.ack_map_min())
        gauge("resize_layout_sync_min",
              g.system.layout_manager.helper.sync_map_min())
        # hot-block read cache (block/cache.py): cache_hits/misses/
        # evictions/bytes + admission counters
        out.append("# TYPE cache_hits counter")
        for k, v in g.block_manager.cache.stats().items():
            gauge(f"cache_{k}", v)
        # cluster cache tier (block/cache_tier.py): probe economics +
        # hint-gossip visibility; cache_tier_enabled is the smoke
        # assertion that the tier plane exists
        tier = getattr(g.block_manager, "cache_tier", None)
        gauge("cache_tier_enabled",
              1 if tier is not None and tier.enabled else 0,
              "Whether the cluster-wide cache tier is active")
        if tier is not None:
            ts = tier.stats()
            gauge("cache_tier_members", ts["members"])
            gauge("cache_tier_probes", ts["probes"])
            gauge("cache_tier_probe_hits", ts["probe_hits"])
            gauge("cache_tier_probe_misses", ts["probe_misses"])
            gauge("cache_tier_probe_fails", ts["probe_fails"])
            gauge("cache_tier_remote_hit_bytes", ts["remote_hit_bytes"])
            gauge("cache_tier_inserts_pushed", ts["inserts_pushed"])
            gauge("cache_tier_hints_known", ts["hints_known"])
            gauge("cache_tier_hints_seen", ts["hints_seen"])
            # probe singleflight leases + hint prefetch:
            # the cold-herd plane — lease table depth and queue length
            # are the live-pressure gauges, the counters are the
            # collapse economics the flash-crowd drill asserts on
            gauge("cache_lease_wait_ms_configured", ts["lease_wait_ms"])
            gauge("cache_lease_table_depth", ts["lease_depth"],
                  "Live probe leases at this owner")
            gauge("cache_lease_minted_total", ts["lease_minted"])
            gauge("cache_lease_resolved_total", ts["lease_resolved"])
            gauge("cache_lease_expired_total", ts["lease_expired"])
            gauge("cache_lease_waits_total", ts["lease_waits"])
            gauge("cache_lease_grants_total", ts["lease_grants"])
            gauge("cache_lease_wait_hits_total", ts["lease_wait_hits"])
            gauge("cache_lease_wait_timeouts_total",
                  ts["lease_wait_timeouts"])
            gauge("cache_prefetch_queue_depth", ts["prefetch_queue"],
                  "Hinted hashes awaiting background prefetch")
            gauge("cache_prefetch_done_total", ts["prefetched"])
            gauge("cache_prefetch_skips_total", ts["prefetch_skips"])
            gauge("cache_prefetch_drops_total", ts["prefetch_drops"])
            gauge("cache_prefetch_errors_total", ts["prefetch_errors"])
        # packed-bytes tier segment + node-local read singleflight
        #
        pc = getattr(g.block_manager, "packed_cache", None)
        if pc is not None:
            gauge("cache_packed_bytes", pc.bytes_used,
                  "Packed-bytes tier segment resident bytes")
            gauge("cache_packed_entries", pc.entries)
            gauge("cache_packed_max_bytes", pc.max_bytes)
            gauge("cache_packed_inserts_total", pc.inserts)
            gauge("cache_packed_hits_total", pc.hits)
        gauge("cache_sf_leaders_total",
              getattr(g.block_manager, "sf_leaders", 0),
              "Node-local read singleflight: store reads led")
        gauge("cache_sf_collapsed_total",
              getattr(g.block_manager, "sf_collapsed", 0),
              "Node-local read singleflight: reads collapsed onto "
              "a leader")
        sw = g.block_manager.scrub_worker
        if sw is not None:
            out.append("# HELP block_scrub_corruptions "
                       "Corruptions found across all scrub passes")
            out.append("# TYPE block_scrub_corruptions counter")
            gauge("block_scrub_corruptions", sw.state.corruptions)
            out.append("# TYPE block_scrub_deep_stripes_checked counter")
            gauge("block_scrub_deep_stripes_checked", sw.deep_checked)
            out.append("# TYPE block_scrub_deep_stripes_repaired counter")
            gauge("block_scrub_deep_stripes_repaired", sw.deep_repaired)
            out.append("# TYPE block_scrub_header_repaired counter")
            gauge("block_scrub_header_repaired", sw.header_repaired)
            out.append("# TYPE block_scrub_cache_lookups counter")
            gauge("block_scrub_cache_lookups", sw.scrub_cache_lookups)
            out.append("# TYPE block_scrub_cache_hits counter")
            gauge("block_scrub_cache_hits", sw.scrub_cache_hits)

        for t in g.all_tables():
            s = t.data.stats()
            for k, v in s.items():
                gauge(f"table_{k}", v, table=t.name)
            gauge("table_size_bytes", t.data.size_bytes(), table=t.name)

        # metadata engine internals (db/lsm.py et al.; README "Metadata
        # at scale") — segment count, compaction backlog and WAL size
        # make compaction stalls and flush storms visible to operators
        es = g.db.engine_stats()
        gauge("meta_rows", es.get("rows", 0),
              "Live rows across all metadata trees",
              engine=es.get("engine", "?"))
        for k in ("segments", "compaction_backlog", "wal_bytes",
                  "memtable_bytes", "flushes", "compactions",
                  "file_bytes"):
            if k in es:
                gauge(f"meta_{k}", es[k], engine=es["engine"])
        lm = getattr(g, "lsm_maintenance", None)
        if lm is not None:
            gauge("meta_compaction_tranquility",
                  round(lm.tranquility, 4))

        # per-node status + ping gauges (ref: rpc/system_metrics.rs:302)
        for peer in g.system.peering.get_peer_list():
            nid = peer.id.hex()[:16]
            gauge("cluster_node_up",
                  1 if peer.state.value == "connected"
                  or peer.id == g.system.id else 0, node=nid)
            if peer.ping_avg is not None:
                gauge("cluster_node_ping_avg_seconds", round(peer.ping_avg, 6),
                      node=nid)
            if peer.ping_max is not None:
                gauge("cluster_node_ping_max_seconds", round(peer.ping_max, 6),
                      node=nid)

        # qos admission-control plane (garage_tpu/qos/)
        qos = getattr(g, "qos", None)
        if qos is not None:
            c = qos.counters
            out.append("# TYPE qos_requests counter")
            gauge("qos_admitted_total", c.admitted)
            gauge("qos_shed_total", c.shed)
            gauge("qos_queued_waits_total", c.queued_waits)
            gauge("qos_queued_seconds_total",
                  round(c.queued_seconds, 6))
            gauge("qos_shaped_bytes_total", c.shaped_bytes)
            for scope, n in c.shed_by_scope.items():
                gauge("qos_shed_by_scope", n, scope=scope)
            if qos._conc is not None:
                gauge("qos_in_flight", qos._conc.active)
                gauge("qos_queued", qos._conc.queued)
        gov = getattr(g, "qos_governor", None)
        if gov is not None:
            gauge("qos_governor_pressure_current",
                  round(gov.pressure, 4))
            gauge("qos_governor_queue_depth", gov.last_queue_depth)
            if gov.ewma is not None:
                gauge("qos_governor_ewma_latency_seconds",
                      round(gov.ewma, 6))

        # chaos fault injection (garage_tpu/chaos/) — always exported,
        # so dashboards/smoke can assert the plane exists even at zero
        from ..chaos import injector as chaos_inj

        ctl = chaos_inj.controller()
        gauge("chaos_enabled", 1 if chaos_inj.ACTIVE is not None else 0,
              "Whether fault injection is armed")
        gauge("chaos_faults_armed", len(ctl.faults))
        gauge("chaos_fired_total", ctl.total_fired,
              "Total injected faults that actually fired")

        # self-healing rpc: hedge + breaker counters and per-peer
        # breaker state (0 closed, 1 half-open, 2 open)
        health = g.system.peering.health
        hs = health.stats()
        gauge("rpc_hedging_enabled", 1 if hs["hedging_enabled"] else 0)
        gauge("rpc_hedge_launched_total", hs["hedges_launched"],
              "Backup requests launched by hedged reads")
        gauge("rpc_hedge_wins_total", hs["hedge_wins"])
        gauge("rpc_breaker_open_total", hs["breaker_opens"],
              "Circuit breaker open transitions")
        gauge("rpc_breaker_close_total", hs["breaker_closes"])
        _brk_num = {"closed": 0, "half_open": 1, "open": 2}
        for nid, st in health.peer_state().items():
            gauge("rpc_breaker_state", _brk_num[st["breaker"]], node=nid)
            if st["p99_s"] is not None:
                gauge("rpc_peer_p99_seconds", round(st["p99_s"], 6),
                      node=nid)

        # multi-process gateway supervisor (gateway/supervisor.py):
        # worker liveness + lease ledger. conservation_ok == 1 is the
        # smoke/soak assertion that Σ(worker leases) never exceeded the
        # node budget, including across worker kills.
        sup = getattr(g, "gateway_supervisor", None)
        if sup is not None:
            st = sup.state()
            gauge("gateway_workers_configured", st["workers_configured"],
                  "Gateway worker processes configured")
            gauge("gateway_workers_alive", st["workers_alive"])
            gauge("gateway_worker_restarts_total", st["restarts_total"],
                  "Worker processes respawned after a crash")
            gauge("gateway_lease_conservation_ok",
                  1 if st["broker"]["conservation_ok"] else 0,
                  "Whether sum(worker leases) <= node budget held")
            for dim, metric in (("rps", "gateway_lease_rps"),
                                ("bytes_per_s",
                                 "gateway_lease_bytes_per_s")):
                d = st["broker"][dim]
                for w, v in d["granted"].items():
                    gauge(metric, v, worker=w.lstrip("w"))
                if d["pool_free"] is not None:
                    gauge(metric + "_free", d["pool_free"])
            for w in st["workers"]:
                gauge("gateway_worker_up", 1 if w["alive"] else 0,
                      worker=str(w["index"]))

        # op counters/durations from the process-wide registry
        # (rpc/table/api/block series; ref: rpc/metrics.rs etc.)
        from ..utils.metrics import registry

        out.extend(registry().render())

        # device feeder calibration + staged-pipeline observability
        # (see the module docstring). Names are registered literally
        # (GL07-checkable, and `feeder` is in METRIC_NAME_RE).
        feeder = g.block_manager.feeder
        for opbe, mbps in feeder.perf_summary().items():
            op, _, be = opbe.partition("/")
            gauge("feeder_throughput_mbps", mbps, op=op, backend=be)
        fs = feeder.stats
        gauge("feeder_batches", fs["batches"],
              "Batches dispatched by the device feeder")
        gauge("feeder_items", fs["items"])
        gauge("feeder_device_batches", fs["device_batches"])
        gauge("feeder_device_items", fs["device_items"],
              "Items that actually ran on the device path (the live "
              "device-engagement proof metric)")
        gauge("feeder_device_bytes", fs["device_bytes"])
        gauge("feeder_inline_items", fs["inline_items"])
        gauge("feeder_max_batch", fs["max_batch"])
        gauge("feeder_pad_waste_bytes", fs["pad_waste_bytes"],
              "Zero-padding bytes added by fixed-shape bucket launches")
        gauge("feeder_recompiles", fs["recompiles"],
              "Distinct launch shapes seen")
        gauge("feeder_device_fallbacks", fs["device_fallbacks"],
              "Device groups re-run on the host (none ever is: a "
              "failed group fails its requests)")
        gauge("feeder_decode_items", fs["decode_items"],
              "Decode/repair items through the feeder (degraded GETs "
              "+ scrub/resync rebuilds)")
        gauge("feeder_decode_device_items", fs["decode_device_items"],
              "Decode/repair items that ran on the device path (the "
              "read-side engagement proof metric)")
        gauge("feeder_decode_device_bytes", fs["decode_device_bytes"])
        gauge("feeder_mesh_batches", fs["mesh_batches"],
              "Device batches split over the device grid")
        from ..ops import kernel_launches

        for i, (name, n) in enumerate(sorted(kernel_launches().items())):
            gauge("feeder_kernel_launches", n,
                  "" if i else "Launches of each hand-written kernel in "
                  "this process", kernel=name)
        ps = feeder.pipeline_stats()
        gauge("feeder_inflight", ps["inflight"],
              "Batches currently in flight through the staged pipeline")
        gauge("feeder_pipeline_wall_seconds", ps["wall_s"],
              "Wall-clock union of windows with a device leg in flight")
        gauge("feeder_overlap_efficiency", ps["overlap_efficiency"],
              "Sum of stage-busy seconds / wall (>1 = stages overlap)")
        for stage, s in ps["busy_s"].items():
            gauge("feeder_pipeline_busy_seconds", s, stage=stage)

        for wid, info in g.runner.worker_info().items():
            gauge("worker_busy", 1 if info.state == "busy" else 0,
                  worker=info.name)
            if info.queue_length is not None:
                gauge("worker_queue_length", info.queue_length,
                      worker=info.name)
            gauge("worker_errors", info.errors, worker=info.name)
        return "\n".join(out) + "\n"
