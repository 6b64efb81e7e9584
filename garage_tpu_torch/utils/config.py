"""Copy of garage_tpu/utils/config.py: import paths rewritten, issue and PR tags dropped.

TOML configuration. Ref parity: src/util/config.rs:13-263.

Field names mirror the reference's garage.toml so operators can port configs
nearly verbatim; TPU-specific knobs live under [tpu].
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional

try:  # stdlib on 3.11+; bare 3.10 images have neither tomllib nor tomli
    import tomllib
except ModuleNotFoundError:
    try:
        import tomli as tomllib  # type: ignore[no-redef]
    except ModuleNotFoundError:
        tomllib = None


@dataclass
class DataDir:
    path: str
    capacity: Optional[int] = None  # bytes; None => read-only dir
    read_only: bool = False


@dataclass
class TpuConfig:
    """TPU data-plane knobs (no reference analogue; README "The TPU
    data plane"). The feeder routing/trial knobs were hard-coded module
    constants before the staged pipeline landed; a None leaves the
    feeder's built-in default in force. inflight_batches /
    device_min_bytes / device_min_items are also runtime-tunable via
    admin GET/POST /v1/s3/tuning."""

    enable: bool = True
    # max blocks shipped to the device in one encode/hash call (the
    # feeder's greedy-drain cap; 256 matches the previously hard-coded
    # value)
    batch_blocks: int = 256
    # platform override for tests ("cpu" forces the jnp fallback path)
    platform: Optional[str] = None
    # staged-pipeline depth: device batches concurrently in flight
    # through the h2d/compute/d2h stages (3 = one per stage; 2 = double
    # buffering, cheaper on device RAM but leaves the transfer engine
    # idle while the batch ahead computes + reads back)
    inflight_batches: int = 3
    # calibration routing floors: batches below BOTH never leave the
    # host (a device round trip costs more than it saves there)
    device_min_bytes: Optional[int] = None  # default 4 MiB
    device_min_items: Optional[int] = None  # default 4
    # read-side floors (decode/repair): a lone degraded GET
    # decodes host-inline for latency; only coalesced bursts
    # (concurrent degraded GETs, scrub/resync rebuild waves) pay a
    # device trip. Runtime-tunable via admin /v1/s3/tuning.
    device_min_decode_bytes: Optional[int] = None  # default 4 MiB
    device_min_decode_items: Optional[int] = None  # default 4
    # exploration-trial caps: items/bytes sacrificed to re-time the
    # currently-losing backend (block/feeder.py _trial_cut)
    trial_max_items: Optional[int] = None   # default 2
    trial_items_cap: Optional[int] = None   # default 8
    trial_max_bytes: Optional[int] = None   # default 4 MiB
    # fixed-shape launch buckets: item counts pad up to the next value
    # here so XLA compiles a handful of programs instead of one per
    # batch shape (feeder_pad_waste_bytes / feeder_recompiles track
    # the trade); shard lengths round to the next power of two
    pad_buckets: list = field(
        default_factory=lambda: [1, 2, 4, 8, 16, 32, 64, 128, 256])
    # batches of at least this many items shard across every visible
    # chip through parallel/mesh.py's (dp, tp) data-plane mesh
    mesh_min_items: int = 8
    # "jax" = real accelerator; "stub" = deterministic latency
    # emulator (CI / deviceless boxes; GARAGE_TPU_DEVICE_BACKEND
    # env var overrides)
    device_backend: str = "jax"
    # per-batch watchdog budget, seconds (covers every pipeline stage)
    batch_timeout_s: Optional[float] = None  # default 300
    # batch-formation linger, milliseconds: how long the
    # dispatcher holds a hash/encode batch open waiting for sibling
    # PUT streams' submissions to line up. Under light load a trickle
    # of PUTs used to ride size-1 host fallbacks because the greedy
    # drain found an empty queue; the linger (still gated on >1 active
    # stream) lets them coalesce into one device launch. 0 disables.
    batch_linger_ms: Optional[float] = None  # default 6.0


@dataclass
class QosConfig:
    """[qos] admission control + background-work governor (no reference
    analogue; see garage_tpu/qos/). A None limit disables that limiter
    entirely — an absent [qos] section costs nothing on the request
    path. The governor IS on by default (background repair yields to
    foreground latency, sprints when idle); `governor = false` keeps
    the static tranquilities, and an explicit `worker set
    *-tranquility` always outranks it (persisted for scrub)."""

    global_rps: Optional[float] = None
    global_burst: Optional[float] = None
    global_bytes_per_s: Optional[float] = None
    global_bytes_burst: Optional[float] = None
    per_key_rps: Optional[float] = None
    per_bucket_rps: Optional[float] = None
    max_concurrent: Optional[int] = None
    max_queue: int = 64
    max_wait_s: float = 0.5
    # deficit round-robin across per-key queues INSIDE the global bytes
    # bucket (qos/limiter.py DeficitRoundRobin): under byte-budget
    # contention every active key gets an equal share of the drain
    # instead of first-come-first-served, so one hot key cannot
    # monopolize a worker's lease before per-key limits bite
    fair_keys: bool = True
    governor: bool = True
    governor_interval: float = 2.0
    governor_target_latency: float = 0.05  # seconds
    scrub_tranquility_min: float = 1.0
    scrub_tranquility_max: float = 30.0
    resync_tranquility_min: float = 0.0
    resync_tranquility_max: float = 2.0
    # resync/rebalance backlog depth at which the governor's backlog
    # signal saturates (rebalance yields to foreground p99 during a
    # cluster resize; README "Cluster resize")
    resync_backlog_ref: float = 256.0


@dataclass
class GatewayConfig:
    """[gateway] multi-process S3/K2V/web frontend (garage_tpu/gateway/;
    no reference analogue; README "Multi-process gateway"). `workers`
    selects how many API worker processes share the frontend ports via
    SO_REUSEPORT: 1 (default) keeps today's in-process frontends —
    byte-compatible with every prior release — and 0 means
    auto(cpu_count). With N > 1 the main process becomes the store node
    + supervisor (no S3 frontend of its own): it forks N API-only
    worker nodes, rents each a lease on the node's qos budgets
    (rebalanced by observed demand every `lease_interval_s`, reclaimed
    `lease_ttl_s` after a worker goes silent), respawns crashed workers
    no faster than `respawn_backoff_s`, and aggregates their /metrics
    under a `worker` label. `cache_shard` routes cacheable block reads
    to a consistent-hash owner worker so the node holds ONE decoded
    copy of a hot block instead of N. `min_share` is the fraction of a
    worker's fair share it always keeps leased even when idle (the
    demand-discovery floor)."""

    workers: int = 1
    lease_interval_s: float = 1.0
    lease_ttl_s: float = 3.0
    min_share: float = 0.05
    respawn_backoff_s: float = 2.0
    cache_shard: bool = True
    # zero-copy intra-node cache forwards (gateway/shm.py):
    # the owner worker publishes the decoded payload once into a
    # shared-memory ring and the forwarding worker serves it via
    # memoryview — no payload bytes cross the loopback socket. false =
    # kill switch, every forward carries bytes over the socket again.
    shm_forwards: bool = True
    # ring capacity per worker and the reuse lease: a published slot
    # is never overwritten before its lease expires, which bounds how
    # long a forwarding worker may keep serving the mapped bytes
    shm_ring_bytes: int = 64 * 1024 * 1024
    shm_lease_s: float = 60.0


@dataclass
class ChaosConfig:
    """[chaos] deterministic fault injection (garage_tpu/chaos/; no
    reference analogue). Disabled by default — the seams are single
    pointer-compare no-ops until armed. `faults` is a list of inline
    tables matching chaos.FaultSpec fields, e.g.

        [chaos]
        enable = true
        seed = 42
        faults = [ {kind = "rpc_error", peer = "ab12", prob = 0.1} ]

    Runtime arm/disarm/inspect via admin `GET/POST /v1/chaos`."""

    enable: bool = False
    seed: int = 0
    faults: list = field(default_factory=list)


@dataclass
class Config:
    # ref: util/config.rs:13-258
    metadata_dir: str = ""
    data_dir: list[DataDir] = field(default_factory=list)
    metadata_fsync: bool = False
    data_fsync: bool = False
    block_size: int = 1024 * 1024  # ref default 1 MiB (util/config.rs:269-271)
    block_ram_buffer_max: int = 256 * 1024 * 1024
    # [block] read_cache_max_bytes: budget of the node-local hot-block
    # read cache (block/cache.py). None = default to
    # block_ram_buffer_max // 4; 0 disables. Runtime-tunable via admin
    # POST /v1/s3/tuning (README "Hot-block read cache").
    block_read_cache_max_bytes: Optional[int] = None
    # [block] resync_breaker_aware: rebalance/resync pushes skip peers
    # whose circuit breaker is open and spread across healthy holders
    # (README "Cluster resize"); off restores blind placement
    block_resync_breaker_aware: bool = True
    # [block] cache_tier: CLUSTER-wide read cache tier (
    # block/cache_tier.py; README "Cluster cache tier"). Non-owner
    # reads probe the block's rendezvous-hash owner node in one hop
    # and warm it on miss, so the cluster pays ~1 decode per hot block
    # instead of one per node. false = every read serves node-locally
    # (the pre-tier behavior); the node-local cache itself is governed
    # by read_cache_max_bytes as before.
    block_cache_tier: bool = True
    # [block] cache_tier_hint_top_n: hottest cache keys gossiped per
    # peering ping (hot-hash hints; background resync reads probe the
    # tier only for hinted-hot blocks)
    block_cache_tier_hint_top_n: int = 16
    # [block] cache_lease_wait_ms: probe singleflight lease wait
    # (README "Cluster cache tier"). A probe that misses at
    # the owner behind a live lease parks up to this long — budgeted
    # INSIDE the flat probe timeout — for the lease holder's decode to
    # land; default ≈ the observed p95 of a 1 MiB erasure gather+decode.
    # 0 disables leases entirely (probes answer flat misses, the
    # pre-lease race returns).
    block_cache_lease_wait_ms: float = 250.0
    # [block] cache_prefetch_inflight: concurrent hint-driven prefetch
    # decodes at a cache owner (bounded queue, qos-governor-paced);
    # 0 disables prefetch
    block_cache_prefetch_inflight: int = 2
    # [block] cache_packed_max_bytes: byte budget of the packed-bytes
    # tier segment (exact on-disk packed block images; shard rebuilds
    # and scrub stripe repairs re-encode from it with zero gather
    # RPCs). None = block_ram_buffer_max // 8; 0 disables. Erasure
    # mode only — replicate stores hold no stripes to rebuild.
    block_cache_packed_max_bytes: Optional[int] = None
    compression_level: Optional[int] = 1  # zstd level; None disables
    replication_factor: int = 1
    consistency_mode: str = "consistent"  # consistent|degraded|dangerous
    # erasure coding mode (north star; not in reference): e.g. "4,2" => k=4,m=2
    erasure_coding: Optional[str] = None
    # block content hash: "blake3" (TPU-batchable tree hash, default) or
    # "blake2" (the reference's sequential hash, for migrated stores)
    block_hash_algo: str = "blake3"

    rpc_secret: Optional[str] = None
    rpc_secret_file: Optional[str] = None
    rpc_bind_addr: str = "127.0.0.1:3901"
    rpc_public_addr: Optional[str] = None
    # [rpc] self-healing knobs (rpc/rpc_helper.py + net/peering.py
    # PeerHealthTracker; README "Fault injection & self-healing RPC"):
    # hedged reads on/off, the cluster-wide hedge rate cap (token
    # bucket, hedges/s), and p99-derived adaptive per-call timeouts
    rpc_hedging: bool = True
    rpc_hedge_rate: float = 8.0
    # [rpc] hedge_writes: backup pushes for IDEMPOTENT writes that
    # opted in per-call (erasure shard puts; README "Cluster resize").
    # Off = writes never hedge, regardless of per-call opt-ins.
    rpc_hedge_writes: bool = True
    rpc_adaptive_timeout: bool = True
    # [rpc] layout_debounce_ms: coalescing window for layout gossip
    # broadcasts (rpc/layout/manager.py). Every tracker tick during a
    # resize fires a change; broadcasting each one is an O(N^2) gossip
    # storm, so back-to-back changes ride one wave per window. Raise on
    # big clusters, lower for snappier test convergence.
    rpc_layout_debounce_ms: float = 100.0
    bootstrap_peers: list[str] = field(default_factory=list)
    # external discovery (ref: rpc/consul.rs, rpc/kubernetes.rs);
    # TOML sections [consul_discovery] / [kubernetes_discovery]
    consul_http_addr: Optional[str] = None
    consul_service_name: Optional[str] = None
    kubernetes_namespace: Optional[str] = None
    kubernetes_service_name: Optional[str] = None

    # [metadata] db_engine: sqlite (durable default) | memory (tests) |
    # lsm (log-structured merge engine for metadata at millions of
    # keys; README "Metadata at scale"). Top-level `db_engine = ...`
    # also accepted, like the reference garage.toml.
    db_engine: str = "sqlite"

    s3_api_bind_addr: Optional[str] = None
    s3_region: str = "garage"
    root_domain: str = ".s3.garage"
    # [s3_api] data-plane tuning (no reference analogue; see README
    # "S3 data-plane tuning"). get_readahead_blocks: how many blocks the
    # GET path prefetches beyond the one currently streaming to the
    # client (0 = strictly sequential, the pre-readahead behavior).
    # put_blocks_max_parallel: concurrent block writes in the PUT
    # pipeline (ref: put.rs:42 used a hard-coded 3). Both are runtime
    # read/writable via admin `GET/POST /v1/s3/tuning` for bench sweeps.
    s3_get_readahead_blocks: int = 3
    s3_put_blocks_max_parallel: int = 3
    # ingest_buffers: pinned host buffers for the zero-copy PUT path
    # (block/hostbuf.py) — each holds one block in stripe
    # layout, so the pool pins ~N * block_size RAM; exhaustion
    # backpressures PUTs instead of allocating. 0 disables the
    # zero-copy path entirely (every PUT takes the classic copy path).
    s3_ingest_buffers: int = 16
    k2v_api_bind_addr: Optional[str] = None
    admin_api_bind_addr: Optional[str] = None
    admin_token: Optional[str] = None
    # lint: ignore[GL08] read via getattr in fill_secrets
    admin_token_file: Optional[str] = None
    metrics_token: Optional[str] = None
    # lint: ignore[GL08] read via getattr in fill_secrets
    metrics_token_file: Optional[str] = None
    # [admin] trace_sink: OTLP/HTTP collector base URL (ref:
    # config.rs admin.trace_sink + garage/tracing_setup.rs)
    admin_trace_sink: Optional[str] = None
    web_bind_addr: Optional[str] = None
    web_root_domain: str = ".web.garage"

    # [table] sync_tranquility_max: per-partition sleep (seconds) the
    # qos governor applies to table anti-entropy rounds at full
    # pressure (qos/governor.py; was the hard-coded
    # TABLE_SYNC_TRANQ_MAX). 0 disables governor pacing of table sync.
    table_sync_tranquility_max: float = 0.05

    metadata_auto_snapshot_interval: Optional[float] = None  # seconds
    metadata_snapshots_dir: Optional[str] = None  # default {meta}/snapshots

    tpu: TpuConfig = field(default_factory=TpuConfig)
    qos: QosConfig = field(default_factory=QosConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    gateway: GatewayConfig = field(default_factory=GatewayConfig)

    @property
    def data_dirs(self) -> list[DataDir]:
        return self.data_dir

    @property
    def erasure_params(self) -> Optional[tuple[int, int]]:
        if not self.erasure_coding:
            return None
        k, m = self.erasure_coding.split(",")
        return int(k), int(m)


def _parse_data_dir(v: Any) -> list[DataDir]:
    # Accept a single path string or a list of {path, capacity, read_only}
    # tables (multi-HDD mode, ref: util/config.rs DataDirEnum).
    if isinstance(v, str):
        return [DataDir(path=v)]
    out = []
    for d in v:
        if isinstance(d, str):
            out.append(DataDir(path=d))
        else:
            cap = d.get("capacity")
            if isinstance(cap, str):
                cap = parse_capacity(cap)
            out.append(DataDir(path=d["path"], capacity=cap,
                               read_only=bool(d.get("read_only", False))))
    return out


def parse_capacity(s: str) -> int:
    """'1G', '100M', '2T' → bytes (decimal units like the reference)."""
    s = s.strip()
    units = {"k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12}
    if s and s[-1].lower() in units:
        return int(float(s[:-1]) * units[s[-1].lower()])
    return int(s)


def _toml_scalar(s: str):
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    if s == "true":
        return True
    if s == "false":
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s  # bare value; garage.toml doesn't use these


def _split_toml_array(s: str) -> list[str]:
    out, depth, cur, quote = [], 0, "", None
    for ch in s:
        if quote:
            cur += ch
            if ch == quote and not cur.endswith("\\" + quote):
                quote = None
            continue
        if ch in "\"'":
            quote = ch
            cur += ch
        elif ch in "[{":
            depth += 1
            cur += ch
        elif ch in "]}":
            depth -= 1
            cur += ch
        elif ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur)
    return out


def _toml_value(s: str):
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        return [_toml_value(p) for p in _split_toml_array(s[1:-1])]
    if s.startswith("{") and s.endswith("}"):
        d = {}
        for pair in _split_toml_array(s[1:-1]):
            k, _, v = pair.partition("=")
            d[k.strip().strip('"')] = _toml_value(v)
        return d
    return _toml_scalar(s)


def parse_toml_minimal(text: str) -> dict:
    """Fallback TOML-subset parser for images without tomllib/tomli
    (Python <= 3.10): sections, key = scalar/array/inline-table,
    comments. Covers the full garage.toml surface this build reads;
    NOT a general TOML implementation (no multi-line values, no
    [[array-of-tables]], no date types)."""
    root: dict = {}
    cur = root
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            cur = root
            for part in line[1:-1].split("."):
                cur = cur.setdefault(part.strip().strip('"'), {})
            continue
        key, sep, val = line.partition("=")
        if not sep:
            raise ValueError(f"unparseable config line: {line!r}")
        # cut at the first '#' that is outside any quoted string
        quote = None
        for i, ch in enumerate(val):
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "\"'":
                quote = ch
            elif ch == "#":
                val = val[:i]
                break
        cur[key.strip().strip('"')] = _toml_value(val)
    return root


def read_config(path: str) -> Config:
    """ref: util/config.rs:259 read_config. Env var GARAGE_RPC_SECRET etc.
    override file values (subset of the reference's layered secrets)."""
    with open(path, "rb") as f:
        data = f.read()
    if tomllib is not None:
        raw = tomllib.loads(data.decode())
    else:
        raw = parse_toml_minimal(data.decode())
    return config_from_dict(raw)


def config_from_dict(raw: dict) -> Config:
    cfg = Config()
    simple_fields = {f.name for f in dataclasses.fields(Config)} \
        - {"data_dir", "tpu", "qos", "chaos", "gateway"}
    for key, val in raw.items():
        if key == "data_dir":
            cfg.data_dir = _parse_data_dir(val)
        elif key == "tpu" and isinstance(val, dict):
            cfg.tpu = TpuConfig(**val)
        elif key == "qos" and isinstance(val, dict):
            cfg.qos = QosConfig(**val)
        elif key == "chaos" and isinstance(val, dict):
            cfg.chaos = ChaosConfig(**val)
        elif key == "gateway" and isinstance(val, dict):
            cfg.gateway = GatewayConfig(**val)
        elif key in ("s3_api", "k2v_api", "admin", "web", "block", "rpc",
                     "table", "metadata",
                     "consul_discovery", "kubernetes_discovery"):
            # nested sections like the reference layout; [metadata]
            # db_engine / fsync map onto the top-level fields so the
            # engine selection reads like the docs ([metadata]
            # db_engine = "lsm")
            prefix = {"s3_api": "s3_", "k2v_api": "k2v_",
                      "admin": "admin_", "web": "web_", "block": "block_",
                      "rpc": "rpc_", "table": "table_",
                      "metadata": "metadata_",
                      "consul_discovery": "consul_",
                      "kubernetes_discovery": "kubernetes_"}[key]
            for k2, v2 in val.items():
                attr = k2 if k2.startswith(prefix) else None
                # prefixed name first: [web] root_domain must map to
                # web_root_domain, not the top-level (S3) root_domain
                for cand in (prefix + k2, k2, {
                    "api_bind_addr": prefix + "api_bind_addr",
                }.get(k2, "")):
                    if cand in simple_fields:
                        attr = cand
                        break
                if attr:
                    if attr in ("block_size", "block_ram_buffer_max",
                                "block_read_cache_max_bytes",
                                "block_cache_packed_max_bytes") \
                            and isinstance(v2, str):
                        v2 = parse_capacity(v2)
                    setattr(cfg, attr, v2)
        elif key in simple_fields:
            if key in ("block_size", "block_ram_buffer_max",
                       "block_read_cache_max_bytes",
                       "block_cache_packed_max_bytes") \
                    and isinstance(val, str):
                val = parse_capacity(val)
            setattr(cfg, key, val)
        # unknown keys ignored (forward compat)
    fill_secrets(cfg)
    if not cfg.metadata_dir:
        raise ValueError("metadata_dir is required")
    return cfg


def _read_secret_file(path: str) -> str:
    """Read a one-line secret file with a permission check: refuse
    group/world-readable files unless GARAGE_ALLOW_WORLD_READABLE_SECRETS
    is set (ref: src/garage/secrets.rs:54-120)."""
    if not os.environ.get("GARAGE_ALLOW_WORLD_READABLE_SECRETS"):
        mode = os.stat(path).st_mode
        if mode & 0o077:
            raise ValueError(
                f"secret file {path} is readable by other users "
                f"(mode {mode & 0o777:03o}); chmod 600 it or set "
                "GARAGE_ALLOW_WORLD_READABLE_SECRETS=1")
    with open(path) as f:
        return f.read().strip()


def fill_secrets(cfg: "Config") -> None:
    """Layered secret resolution, per secret: env var > env _FILE var >
    config *_file > config inline (ref: src/garage/secrets.rs
    fill_secrets — same precedence, CLI flags excepted). An env value
    OVERRIDES config-file sources (that is the point of the layering —
    rotation without editing the TOML); only the two env forms
    conflicting is an error."""
    for attr, env in (("rpc_secret", "GARAGE_RPC_SECRET"),
                      ("admin_token", "GARAGE_ADMIN_TOKEN"),
                      ("metrics_token", "GARAGE_METRICS_TOKEN")):
        file_attr = f"{attr}_file"
        env_val = os.environ.get(env)
        env_file = os.environ.get(f"{env}_FILE")
        if env_val and env_file:
            raise ValueError(f"both {env} and {env}_FILE are set; "
                             "pick one")
        if env_val:
            setattr(cfg, attr, env_val)
            continue
        if env_file:
            setattr(cfg, attr, _read_secret_file(env_file))
            continue
        cfg_file = getattr(cfg, file_attr, None)
        if cfg_file:
            if getattr(cfg, attr, None):
                raise ValueError(
                    f"both {attr} and {file_attr} are set in the "
                    "config; pick one")
            setattr(cfg, attr, _read_secret_file(cfg_file))
