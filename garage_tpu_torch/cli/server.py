"""Node server entrypoint:
`python -m garage_tpu_torch.cli.server --config x.toml [--device cpu]`
(ported from the JAX package's cli/server.py).

Builds the Garage root on `--device` ("cuda" unless "cpu" is given: the
block math then runs each kernel's plain torch version), starts RPC
listen + gossip + workers, then every front end the config asks for:
S3, the admin HTTP API, K2V and the web front end; exits cleanly on
SIGINT/SIGTERM/SIGHUP. The config file format is the JAX package's.

What differs from the JAX package: a config with `[gateway] workers`
other than 1 (the multi-process gateway) stops at startup with an error
that names the later slice of the port, and so does `[tpu] enable =
false` unless `--device cpu` is given (model/garage.py
check_tpu_section); nothing runs without them silently. The operator
CLI (cli/main.py) reaches the node over RPC as before.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

from ..admin.rpc import AdminRpcHandler
from ..api.s3.api_server import S3ApiServer
from ..model.garage import Garage, check_tpu_section, parse_addr
from ..utils.config import read_config

log = logging.getLogger("garage_tpu_torch.server")


async def run_server(cfg_path: str, device="cuda") -> None:
    from ..utils.runtime import tune

    tune()
    cfg = await asyncio.to_thread(read_config, cfg_path)
    if cfg.gateway.workers != 1:
        raise SystemExit(
            "garage_tpu_torch server: not ported yet, comes with a later "
            "slice of the port (ROADMAP: the multi-process gateway): "
            f"[gateway] workers = {cfg.gateway.workers}")
    from .. import resolve_device

    try:
        check_tpu_section(cfg.tpu, device)
        resolve_device(device)  # no CUDA device: fail before booting
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"garage_tpu_torch server: {e}") from None
    from ..utils import lockfile

    # held for the server's lifetime; repair-offline/convert-db take the
    # same lock, so offline maintenance can't race a live node
    lock_fd = lockfile.acquire(cfg.metadata_dir, "server")
    try:
        await _run_server_locked(cfg, device)
    finally:
        lockfile.release(lock_fd)


async def _run_server_locked(cfg, device) -> None:
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

    system_task = asyncio.create_task(garage.run())
    servers = []
    s3 = None
    if cfg.s3_api_bind_addr:
        s3 = S3ApiServer(garage)
        await start_frontend(s3, cfg.s3_api_bind_addr)
        servers.append(s3)
    if cfg.admin_api_bind_addr:
        from ..admin.http import AdminHttpServer

        ad = AdminHttpServer(garage, admin_rpc=admin)
        await start_frontend(ad, cfg.admin_api_bind_addr)
        servers.append(ad)
    if cfg.k2v_api_bind_addr:
        from ..api.k2v.api_server import K2VApiServer

        k2v = K2VApiServer(garage)
        await start_frontend(k2v, cfg.k2v_api_bind_addr)
        servers.append(k2v)
    if cfg.web_bind_addr:
        from ..web.server import WebServer

        web = WebServer(garage, s3)
        await start_frontend(web, cfg.web_bind_addr)
        servers.append(web)

    log.info("node %s up (rpc %s, device %s)", garage.system.id.hex()[:16],
             cfg.rpc_bind_addr, device)
    print(f"garage_tpu_torch node {garage.system.id.hex()} ready",
          flush=True)
    await stop.wait()
    log.info("shutting down")
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
