"""Node server entrypoint:
`python -m garage_tpu_torch.cli.server --config x.toml [--device cpu]`
(ported from the JAX package's cli/server.py).

Builds the Garage root on `--device` ("cuda" unless "cpu" is given: the
block math then runs each kernel's plain torch version), starts RPC
listen + gossip + workers, then the S3 front end; exits cleanly on
SIGINT/SIGTERM/SIGHUP. The config file format is the JAX package's.

What differs from the JAX package: the port serves S3 only so far. A
config that asks for the admin HTTP API, the K2V API, the web front end
or `[gateway] workers` other than 1 stops at startup with an error that
names the later slice of the port; nothing runs without them silently.
The operator CLI (cli/main.py) reaches the node over RPC as before.
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

# front ends of the JAX package's server that the port has not ported yet
_LATER_SLICE = "a later slice of the port (ROADMAP: host front ends)"


def unported_frontends(cfg) -> list[str]:
    """Config sections asking for a front end the port does not have."""
    out = []
    if cfg.admin_api_bind_addr:
        out.append("[admin] api_bind_addr (admin HTTP API)")
    if cfg.k2v_api_bind_addr:
        out.append("[k2v_api] api_bind_addr (K2V API)")
    if cfg.web_bind_addr:
        out.append("[web] bind_addr (web front end)")
    if cfg.gateway.workers != 1:
        out.append(f"[gateway] workers = {cfg.gateway.workers} "
                   "(multi-process gateway)")
    return out


async def run_server(cfg_path: str, device="cuda") -> None:
    from ..utils.runtime import tune

    tune()
    cfg = await asyncio.to_thread(read_config, cfg_path)
    missing = unported_frontends(cfg)
    if missing:
        raise SystemExit(
            "garage_tpu_torch server: not ported yet, comes with "
            f"{_LATER_SLICE}: " + "; ".join(missing))
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
    AdminRpcHandler(garage)  # serves the operator CLI's RPC endpoint
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

    system_task = asyncio.create_task(garage.run())
    s3 = None
    if cfg.s3_api_bind_addr:
        s3 = S3ApiServer(garage)
        # bind addr is "host:port" or an absolute path -> Unix socket
        if cfg.s3_api_bind_addr.startswith("/"):
            await s3.start(cfg.s3_api_bind_addr)
        else:
            await s3.start(*parse_addr(cfg.s3_api_bind_addr))

    log.info("node %s up (rpc %s, device %s)", garage.system.id.hex()[:16],
             cfg.rpc_bind_addr, device)
    print(f"garage_tpu_torch node {garage.system.id.hex()} ready",
          flush=True)
    await stop.wait()
    log.info("shutting down")
    if s3 is not None:
        await s3.stop()
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
    from .. import resolve_device
    from ..utils.lockfile import AlreadyLocked

    resolve_device(args.device)  # no CUDA device: fail before booting
    try:
        asyncio.run(run_server(args.config, args.device))
    except AlreadyLocked as e:
        import sys

        print(str(e), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
