"""Node server entrypoint:
`python -m garage_tpu_torch.cli.server --config x.toml [--device cpu]`
(ported from the JAX package's cli/server.py).

Builds the Garage root on `--device` ("cuda" unless "cpu" is given: the
block math then runs each kernel's plain torch version), starts RPC
listen + gossip + workers, then every front end the config asks for:
S3, the admin HTTP API, K2V and the web front end; exits cleanly on
SIGINT/SIGTERM/SIGHUP. The config file format is the JAX package's.
With `[gateway] workers` other than 1 and a TCP front-end bind, the
node becomes the store and gateway supervisor, as in the JAX package:
it keeps RPC, the tables, the background work and the admin API, and
N worker processes (gateway/) serve S3, K2V and web on the same ports,
each on the store's `--device`.

What differs from the JAX package: `--device`, which the gateway
workers inherit; a node with `[tpu] enable = true` (the feeder's
"require") stops at startup when that device cannot be reached, and
one with `enable = false` runs host-only, as in the JAX package, and
needs no device at all. With tracing on from the environment
(`GARAGE_TPU_TRACE`), the node also meters its event loop
(utils/tracing.py). The operator CLI (cli/main.py) reaches the node
over RPC as before.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

from ..admin.rpc import AdminRpcHandler
from ..api.s3.api_server import S3ApiServer
from ..model.garage import Garage, parse_addr
from ..utils.config import read_config

log = logging.getLogger("garage_tpu_torch.server")


async def run_server(cfg_path: str, device="cuda") -> None:
    from ..utils.runtime import tune

    tune()
    cfg = await asyncio.to_thread(read_config, cfg_path)
    from .. import resolve_device

    try:
        if cfg.tpu.enable:
            resolve_device(device)  # no CUDA device: fail before booting
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"garage_tpu_torch server: {e}") from None
    from ..utils import lockfile

    # held for the server's lifetime; repair-offline/convert-db take the
    # same lock, so offline maintenance can't race a live node
    lock_fd = lockfile.acquire(cfg.metadata_dir, "server")
    try:
        await _run_server_locked(cfg, cfg_path, device)
    finally:
        lockfile.release(lock_fd)


async def _run_server_locked(cfg, cfg_path: str, device) -> None:
    if os.environ.get("GARAGE_TPU_TRACE"):
        from ..utils.tracing import tracer

        # tracing on from the environment: meter this node's event loop
        # (utils/tracing.py LoopMeter); it stops when the loop closes
        tracer.start_meter()
    garage = Garage(cfg, device=device)
    admin = AdminRpcHandler(garage)  # also serves the CLI's RPC endpoint
    otlp = None
    if cfg.admin_trace_sink:
        from ..utils.otlp import setup_otlp

        otlp = setup_otlp(cfg.admin_trace_sink, garage.system.id)
    stop = asyncio.Event()

    loop = asyncio.get_event_loop()
    for name in ("SIGINT", "SIGTERM", "SIGHUP"):
        sig = getattr(signal, name, None)
        if sig is None:
            continue
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass

    async def start_frontend(srv, bind: str) -> None:
        # bind addr is "host:port" or an absolute path -> Unix socket
        if bind.startswith("/"):
            await srv.start(bind)
        else:
            await srv.start(*parse_addr(bind))

    # multi-process gateway ([gateway] workers != 1 with at least one
    # TCP frontend bind): this process becomes the store node +
    # supervisor — it keeps RPC, tables, block/resync/scrub workers and
    # the admin API, while N worker processes bind the S3/K2V/web ports
    # with SO_REUSEPORT (gateway/), on this node's device.
    from ..gateway.supervisor import GatewaySupervisor, resolve_workers

    n_workers = resolve_workers(cfg.gateway.workers)
    gateway_mode = n_workers > 1 and any(
        b and not b.startswith("/")
        for b in (cfg.s3_api_bind_addr, cfg.k2v_api_bind_addr,
                  cfg.web_bind_addr))
    if n_workers > 1 and not gateway_mode:
        log.warning(
            "[gateway] workers = %d ignored: no TCP frontend binds "
            "(SO_REUSEPORT does not apply to unix sockets); running "
            "the single-process frontend", n_workers)

    system_task = asyncio.create_task(garage.run())
    servers = []
    supervisor = None
    s3 = None
    if cfg.s3_api_bind_addr and not gateway_mode:
        s3 = S3ApiServer(garage)
        await start_frontend(s3, cfg.s3_api_bind_addr)
        servers.append(s3)
    if cfg.admin_api_bind_addr:
        from ..admin.http import AdminHttpServer

        ad = AdminHttpServer(garage, admin_rpc=admin)
        await start_frontend(ad, cfg.admin_api_bind_addr)
        servers.append(ad)
    if cfg.k2v_api_bind_addr and not gateway_mode:
        from ..api.k2v.api_server import K2VApiServer

        k2v = K2VApiServer(garage)
        await start_frontend(k2v, cfg.k2v_api_bind_addr)
        servers.append(k2v)
    if cfg.web_bind_addr and not gateway_mode:
        from ..web.server import WebServer

        web = WebServer(garage, s3)
        await start_frontend(web, cfg.web_bind_addr)
        servers.append(web)
    if gateway_mode:
        supervisor = GatewaySupervisor(garage, cfg_path,
                                       n_workers=n_workers, device=device)
        await supervisor.start()

    log.info("node %s up (rpc %s, device %s)", garage.system.id.hex()[:16],
             cfg.rpc_bind_addr, device)
    print(f"garage_tpu_torch node {garage.system.id.hex()} ready",
          flush=True)
    await stop.wait()
    log.info("shutting down")
    if supervisor is not None:
        await supervisor.stop()
    for s in servers:
        await s.stop()
    await garage.stop()
    system_task.cancel()
    if otlp is not None:
        otlp.stop()


def main() -> None:
    p = argparse.ArgumentParser(prog="garage_tpu_torch.cli.server")
    p.add_argument("--config", "-c",
                   default=os.environ.get("GARAGE_CONFIG_FILE",
                                          "/etc/garage.toml"))
    p.add_argument("--log-level", default=os.environ.get("RUST_LOG", "info"))
    p.add_argument("--device", default="cuda",
                   help='torch device of the block math: "cuda" (default; '
                   'fails without a CUDA device) or "cpu"')
    args = p.parse_args()
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    from ..utils.lockfile import AlreadyLocked

    try:
        asyncio.run(run_server(args.config, args.device))
    except AlreadyLocked as e:
        import sys

        print(str(e), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
