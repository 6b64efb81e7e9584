"""garage_tpu_torch stands alone: it imports neither jax nor anything of
the JAX package (garage_tpu), not even its host-only modules."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

import garage_tpu_torch

PKG_DIR = os.path.dirname(garage_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _py_files():
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "garage_tpu"))


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["garage_tpu"] = None
import numpy as np
import torch
import garage_tpu_torch
names = ["garage_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(garage_tpu_torch.__path__,
                                          "garage_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from garage_tpu_torch.ops import rs
x = np.random.default_rng(0).integers(0, 256, (2, 4, 64), dtype=np.uint8)
par = rs.encode(4, 2, torch.from_numpy(x)).numpy()
assert all((par[i] == rs.encode_np(4, 2, x[i])).all() for i in range(2))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "garage_tpu")
             and sys.modules[n] is not None)
assert not bad, bad
print("IMPORTED", len(names))
"""


def test_every_module_imports_and_encodes_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORTED" in r.stdout


_S3_CHILD = r"""
import asyncio, hashlib, os, sys, tempfile, threading
sys.modules["jax"] = None
sys.modules["garage_tpu"] = None
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import torch
torch.set_num_threads(1)
import http.client
import garage_tpu_torch.api.s3.api_server
import garage_tpu_torch.cli.k2v
import garage_tpu_torch.cli.main
import garage_tpu_torch.cli.server
import garage_tpu_torch.utils.tranquilizer
from garage_tpu_torch.admin.http import AdminHttpServer
from garage_tpu_torch.admin.rpc import AdminRpcHandler
from garage_tpu_torch.api.k2v import K2VApiServer
from garage_tpu_torch.api.s3.api_server import S3ApiServer
from garage_tpu_torch.k2v_client import K2vClient
from garage_tpu_torch.web import WebServer
from garage_tpu_torch.model.garage import Garage
from garage_tpu_torch.rpc.layout import NodeRole
from garage_tpu_torch.utils.config import Config, DataDir
from s3util import S3Client


WEBSITE = (b'<WebsiteConfiguration xmlns="http://s3.amazonaws.com/doc/'
           b'2006-03-01/"><IndexDocument><Suffix>index.html</Suffix>'
           b'</IndexDocument></WebsiteConfiguration>')


def get(port, path, host):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path, headers={"host": host})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


async def main(tmp):
    cfg = Config(metadata_dir=os.path.join(tmp, "meta"),
                 data_dir=[DataDir(path=os.path.join(tmp, "data"))],
                 rpc_bind_addr="127.0.0.1:0", db_engine="memory",
                 replication_factor=1, block_size=65536)
    g = Garage(cfg, device="cpu")
    task = asyncio.create_task(g.run())
    lm = g.system.layout_manager
    lm.history.stage_role(g.system.id, NodeRole(zone="dc1", capacity=1 << 30))
    lm.apply_staged(None)
    admin = AdminRpcHandler(g)
    key = await admin.op_key_new({"name": "t"})
    await admin.op_key_allow({"key": key["key_id"], "create_bucket": True})
    s3 = S3ApiServer(g)
    servers = [s3, AdminHttpServer(g, admin_rpc=admin), K2VApiServer(g),
               WebServer(g, s3, root_domain=".web")]
    for srv in servers:
        await srv.start("127.0.0.1", 0)
    port, admin_port, k2v_port, web_port = (srv.http.bound_port
                                            for srv in servers)
    c = S3Client("127.0.0.1", port, key["key_id"], key["secret_key"])
    # one 64 KiB chunk, the size at which the verifier hands a chunk's
    # digest to the feeder, and a short one that it hashes on the host
    body = os.urandom(65_536 + 34_464)

    def client():
        assert c.request("PUT", "/bkt")[0] == 200
        st, hdr, _ = c.put_chunked("/bkt/o", [body[:65_536], body[65_536:]])
        assert st == 200 and hdr["etag"].strip('"') == \
            hashlib.md5(body).hexdigest(), (st, hdr)
        st, _, got = c.request("GET", "/bkt/o")
        assert st == 200 and got == body
        # the other front ends: web, K2V and the admin API's metrics
        assert c.request("PUT", "/bkt", query=[("website", "")],
                         body=WEBSITE)[0] == 200
        assert get(web_port, "/o", "bkt.web") == (200, body)
        k = K2vClient("127.0.0.1", k2v_port, "bkt", key["key_id"],
                      key["secret_key"])
        k.insert_item("pk", "sk", b"v")
        assert k.read_item("pk", "sk").values == [b"v"]
        st, text = get(admin_port, "/metrics", "localhost")
        assert st == 200 and b"feeder_device_items" in text

    await asyncio.to_thread(client)
    feeder = g.block_manager.feeder
    assert feeder.stats["device_items"] > 0
    assert feeder.pipeline_stats()["op_items"].get("sha256", 0) >= 1
    for srv in servers:
        await srv.stop()
    await g.stop()
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)

with tempfile.TemporaryDirectory() as tmp:
    asyncio.run(main(tmp))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "garage_tpu")
             and sys.modules[n] is not None)
assert not bad, bad
print("S3 OK")
"""


def test_s3_entry_points_put_get_without_jax():
    """The server entry, the CLIs and the S3, admin, K2V and web front
    ends import with jax and garage_tpu blocked, one PUT/GET runs on the
    CPU, and the object reads back through the web front end, a K2V
    item round-trips and the admin API serves the feeder's metrics."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _S3_CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "S3 OK" in r.stdout


_GRID_GATEWAY_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["garage_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import garage_tpu_torch.gateway.shm
import garage_tpu_torch.gateway.supervisor
from garage_tpu_torch.gateway.worker import derive_worker_config
from garage_tpu_torch.ops import rs, treehash
from garage_tpu_torch.parallel import data_plane_mesh, make_put_step
from garage_tpu_torch.utils.config import Config

grid = data_plane_mesh(tp=2, devices=["cpu"] * 4)
x = np.random.default_rng(1).integers(0, 256, (4, 4, 2048), dtype=np.uint8)
parity, hashes = make_put_step(grid, 4, 2, 2048)(torch.from_numpy(x))
for i in range(4):
    assert (parity[i].numpy() == rs.encode_np(4, 2, x[i])).all()
    assert bytes(hashes[i, 0].numpy()) == treehash.blake3_py(x[i, 0].tobytes())
w = derive_worker_config(Config(metadata_dir="/m"), 1, 2, "ab" * 32 + "@h:1")
assert w.metadata_dir == "/m/gateway/worker1" and w.db_engine == "memory"
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "garage_tpu")
             and sys.modules[n] is not None)
assert not bad, bad
print("GRID GATEWAY OK")
"""


def test_grid_steps_and_gateway_modules_run_without_jax():
    """parallel/ and gateway/{shm,supervisor,worker}.py import with jax
    and garage_tpu blocked; a put step runs on a grid of 4 CPU cells and
    a worker config derives."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _GRID_GATEWAY_CHILD], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "GRID GATEWAY OK" in r.stdout
