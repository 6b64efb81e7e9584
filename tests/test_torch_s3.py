"""The port's S3 slice as a whole, on the CPU: a forked port server
(`garage_tpu_torch.cli.server --device cpu`, with jax and garage_tpu
blocked in the child) set up through the port's CLI, driven with the
independent signer in tests/s3util.py; the node's on-disk state (S3
objects and K2V items) read back across the two packages in both
directions; and the server's other front ends (admin HTTP API, K2V,
web), each answering from a node booted with only its section.

Stages share one set of node directories (one garage.toml serves both
packages): the port server, then the JAX package's server on the same
directories, then the port server again. Objects are small (64 KiB
blocks); one signed chunk is exactly 64 KiB, the size at which the
SigV4 verifier hands a chunk to the feeder's sha256 lane (kernel S2's
plain torch version here), so that lane runs once.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import signal
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest

from s3util import S3Client, xml_find
# the port's entry points, run with jax and garage_tpu unimportable
from test_torch_copies import PORT_MAIN as _BLOCKED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 64 << 10


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _body(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _etag(hdr: dict) -> str:
    return hdr.get("etag", "").strip('"')


class Node:
    """One node's directories and config, served by either package."""

    def __init__(self, tmpdir: str):
        self.dir = tmpdir
        self.rpc_port = free_port()
        self.s3_port = free_port()
        self.k2v_port = free_port()
        self.config_path = os.path.join(tmpdir, "garage.toml")
        with open(self.config_path, "w") as f:
            f.write(f"""
metadata_dir = "{tmpdir}/meta"
data_dir = "{tmpdir}/data"
replication_factor = 1
block_size = 65536
rpc_bind_addr = "127.0.0.1:{self.rpc_port}"
rpc_public_addr = "127.0.0.1:{self.rpc_port}"

[s3_api]
api_bind_addr = "127.0.0.1:{self.s3_port}"
s3_region = "garage"
root_domain = ".s3.garage.test"

[k2v_api]
api_bind_addr = "127.0.0.1:{self.k2v_port}"
""")
        self.proc = None
        self.package = None
        self.client = None

    def _cmd(self, package: str, mod: str, *args: str) -> list[str]:
        if package == "port":
            return [sys.executable, "-c",
                    _BLOCKED.format(mod=f"garage_tpu_torch.{mod}"), *args]
        return [sys.executable, "-m", f"garage_tpu.{mod}", *args]

    def start(self, package: str) -> None:
        self.stop()
        args = ["--config", self.config_path, "--log-level", "warning"]
        if package == "port":
            args += ["--device", "cpu"]
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            self._cmd(package, "cli.server", *args), cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.package = package
        while True:
            line = self.proc.stdout.readline()
            if "ready" in line:
                return
            if not line and self.proc.poll() is not None:
                raise RuntimeError(f"{package} server died: "
                                   + self.proc.stdout.read())

    def cli(self, *args: str) -> str:
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            self._cmd("port", "cli.main", "--config", self.config_path,
                      *args),
            cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, f"cli {args}: {r.stdout}{r.stderr}"
        return r.stdout

    def setup(self) -> None:
        """Layout, key and bucket through the port's CLI and S3 API."""
        out = self.cli("status")
        node_id = next(line.split()[-1] for line in out.splitlines()
                       if line.startswith("node id:"))
        self.cli("layout", "assign", node_id, "-z", "dc1", "-c", "1G")
        self.cli("layout", "apply")
        out = self.cli("key", "new", "--name", "test")
        kid = next(ln.split()[-1] for ln in out.splitlines()
                   if ln.startswith("Key ID:"))
        secret = next(ln.split()[-1] for ln in out.splitlines()
                      if ln.startswith("Secret key:"))
        self.cli("key", "allow", kid, "--create-bucket")
        self.key = (kid, secret)
        self.client = S3Client("127.0.0.1", self.s3_port, kid, secret)
        st, _, body = self.client.request("PUT", "/bkt")
        assert st == 200, body

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.proc is not None:
            self.proc.stdout.close()
        self.proc = None


@pytest.fixture(scope="module")
def node(tmp_path_factory):
    n = Node(str(tmp_path_factory.mktemp("torch_s3")))
    try:
        yield n
    finally:
        n.stop()


@pytest.fixture
def port(node):
    """The node served by the port's server (set up on first use)."""
    if node.package != "port":
        node.start("port")
    if node.client is None:
        node.setup()
    return node.client


def _get(c: S3Client, path: str, body: bytes) -> None:
    st, hdr, got = c.request("GET", path)
    assert st == 200 and got == body
    assert _etag(hdr) == hashlib.md5(body).hexdigest()


def test_signed_chunked_round_trip_runs_the_sha256_lane(port):
    body = _body(CHUNK + 3000, 1)
    st, hdr, resp = port.put_chunked("/bkt/signed",
                                     [body[:CHUNK], body[CHUNK:]])
    assert st == 200, resp
    assert _etag(hdr) == hashlib.md5(body).hexdigest()
    _get(port, "/bkt/signed", body)


def test_signed_trailer_round_trip(port):
    body = _body(30_000, 2)
    crc = base64.b64encode(zlib.crc32(body).to_bytes(4, "big")).decode()
    st, hdr, resp = port.put_chunked(
        "/bkt/strailer", [body[:20_000], body[20_000:]],
        trailer=("x-amz-checksum-crc32", crc))
    assert st == 200, resp
    assert _etag(hdr) == hashlib.md5(body).hexdigest()
    _get(port, "/bkt/strailer", body)


def test_unsigned_trailer_round_trip(port):
    body = _body(40_000, 3)
    crc = base64.b64encode(zlib.crc32(body).to_bytes(4, "big")).decode()
    st, hdr, resp = port.put_unsigned_trailer(
        "/bkt/utrailer", [body], trailer=("x-amz-checksum-crc32", crc))
    assert st == 200, resp
    _get(port, "/bkt/utrailer", body)


def test_unsigned_payload_head_list_and_range(port):
    body = _body(150_000, 4)  # three 64 KiB blocks
    st, hdr, resp = port.request("PUT", "/bkt/dir/unsigned", body=body,
                                 unsigned_payload=True)
    assert st == 200, resp
    st, hdr, _ = port.request("HEAD", "/bkt/dir/unsigned")
    assert st == 200 and int(hdr["content-length"]) == len(body)
    assert _etag(hdr) == hashlib.md5(body).hexdigest()
    st, _, resp = port.request("GET", "/bkt", query=[
        ("list-type", "2"), ("prefix", "dir/")])
    assert st == 200 and xml_find(resp, "Key") == ["dir/unsigned"]
    st, _, got = port.request("GET", "/bkt/dir/unsigned",
                              headers={"range": "bytes=65530-131080"})
    assert st == 206 and got == body[65530:131081]


def test_bad_chunk_signature_is_refused(port):
    body = _body(20_000, 5)
    st, _, _ = port.put_chunked("/bkt/badsig", [body[:9000], body[9000:]],
                                corrupt_chunk_sig=True)
    assert st == 403
    st, _, _ = port.request("HEAD", "/bkt/badsig")
    assert st == 404


def test_objects_read_back_across_packages(node, port):
    """Objects PUT through the port server read back byte-identical with
    the same ETag through the JAX package's server started on the same
    directories, the same request gets the same ETag from both, and
    objects PUT through the JAX server read back through the port's."""
    c = port
    a = _body(CHUNK + 100, 6)  # a signed 64 KiB chunk: the S2 lane
    st, hdr, _ = c.put_chunked("/bkt/from-port", [a[:CHUNK], a[CHUNK:]])
    assert st == 200
    etag_port = _etag(hdr)
    u = _body(100_000, 7)
    assert c.request("PUT", "/bkt/u-port", body=u,
                     unsigned_payload=True)[0] == 200

    node.start("jax")
    _get(c, "/bkt/from-port", a)
    _get(c, "/bkt/u-port", u)
    st, hdr, _ = c.put_chunked("/bkt/same-request", [a[:CHUNK], a[CHUNK:]])
    assert st == 200 and _etag(hdr) == etag_port
    b = _body(130_000, 8)
    st, hdr, _ = c.put_chunked("/bkt/from-jax",
                               [b[:60_000], b[60_000:]])
    assert st == 200 and _etag(hdr) == hashlib.md5(b).hexdigest()

    node.start("port")
    _get(c, "/bkt/from-jax", b)
    _get(c, "/bkt/same-request", a)
    _get(c, "/bkt/from-port", a)


def test_k2v_items_read_back_across_packages(node, port):
    """K2V items written through the port server read back through the
    JAX package's server on the same directories, and the other way
    round, causality tokens included."""
    from garage_tpu_torch.k2v_client import K2vClient

    assert port.request("PUT", "/k2vbkt")[0] == 200
    c = K2vClient("127.0.0.1", node.k2v_port, "k2vbkt", *node.key)
    c.insert_item("users", "alice", b"from-port")
    c.insert_batch([("users", "bob", b"bob-port", None)])

    node.start("jax")
    alice = c.read_item("users", "alice")
    assert alice.values == [b"from-port"]
    assert c.read_item("users", "bob").values == [b"bob-port"]
    c.insert_item("users", "alice", b"from-jax", causality=alice.causality)
    c.insert_item("users", "carol", b"carol-jax")

    node.start("port")
    assert c.read_item("users", "alice").values == [b"from-jax"]
    assert c.read_item("users", "carol").values == [b"carol-jax"]
    got = c.read_batch([{"partitionKey": "users"}])[0]
    assert [(it["sk"], it["v"]) for it in got["items"]] == [
        ("alice", [base64.b64encode(b"from-jax").decode()]),
        ("bob", [base64.b64encode(b"bob-port").decode()]),
        ("carol", [base64.b64encode(b"carol-jax").decode()])]


# ---------------------------------------------------------------------------
# erasure(4,2): blocks across the two packages' BlockManagers
# ---------------------------------------------------------------------------


def _box_config(config_mod, root: str, i: int):
    d = os.path.join(root, f"node{i}")
    return config_mod.Config(
        metadata_dir=os.path.join(d, "meta"),
        data_dir=[config_mod.DataDir(path=os.path.join(d, "data"))],
        db_engine="sqlite", replication_factor=3, erasure_coding="4,2",
        block_size=65536, qos=config_mod.QosConfig(governor=False))


async def _boot(pkg: str, root: str, n: int, first: bool):
    """n nodes of `pkg` ("port" or "jax") on its loopback transport,
    from the state under `root`; the first boot applies the layout."""
    if pkg == "port":
        from garage_tpu_torch.model.garage import Garage
        from garage_tpu_torch.net import LocalNetwork
        from garage_tpu_torch.rpc.layout import NodeRole
        from garage_tpu_torch.utils import config as cfgmod
        kw = {"device": "cpu"}
    else:
        from garage_tpu.model.garage import Garage
        from garage_tpu.net import LocalNetwork
        from garage_tpu.rpc.layout import NodeRole
        from garage_tpu.utils import config as cfgmod
        kw = {}
    net = LocalNetwork()
    gs = [Garage(_box_config(cfgmod, root, i), local_net=net,
                 status_interval=0.2, ping_interval=0.5, **kw)
          for i in range(n)]
    tasks = [asyncio.create_task(g.run(spawn_workers=False)) for g in gs]
    for g in gs[1:]:
        await g.netapp.try_connect(gs[0].netapp.public_addr, gs[0].system.id)
        g.system.peering.add_peer(gs[0].netapp.public_addr, gs[0].system.id)
    for _ in range(400):
        if all(len(g.netapp.conns) == n - 1 for g in gs):
            break
        await asyncio.sleep(0.05)
    if first:
        lm = gs[0].system.layout_manager
        for g in gs:
            lm.history.stage_role(g.system.id,
                                  NodeRole(zone="dc1", capacity=1 << 30))
        lm.apply_staged(None)
    for _ in range(400):
        if all(g.system.layout_manager.history.current().version == 1
               for g in gs):
            break
        await asyncio.sleep(0.05)
    assert all(g.system.layout_manager.history.current().version == 1
               for g in gs)
    return gs, tasks


async def _shutdown(gs, tasks) -> None:
    for g in gs:
        await g.netapp.shutdown()
    for g in gs:
        await g.stop()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


def test_erasure_blocks_read_back_across_packages(tmp_path):
    """erasure(4,2) on six nodes: blocks put through the port's
    BlockManager read back through JAX nodes reopened on the same
    directories, and blocks the JAX nodes put read back through the
    port's nodes reopened after them."""
    import torch

    torch.set_num_threads(1)
    root = str(tmp_path)
    port_blocks = [_body(n, 20 + n) for n in (65536, 1000, 40_000)]
    jax_blocks = [_body(n, 30 + n) for n in (65536, 5000)]

    async def put_all(gs, blocks):
        bm = gs[0].block_manager
        hashes = [await bm.hash_block(b) for b in blocks]
        for h, b in zip(hashes, blocks):
            await bm.rpc_put_block(h, b)
        return hashes

    async def read_all(gs, node, hashes, blocks):
        bm = gs[node].block_manager
        for h, b in zip(hashes, blocks):
            assert await bm.rpc_get_block(h) == b

    async def go():
        gs, tasks = await _boot("port", root, 6, first=True)
        try:
            assert gs[0].block_manager.erasure
            ph = await put_all(gs, port_blocks)
        finally:
            await _shutdown(gs, tasks)
        gs, tasks = await _boot("jax", root, 6, first=False)
        try:
            await read_all(gs, 3, ph, port_blocks)
            jh = await put_all(gs, jax_blocks)
        finally:
            await _shutdown(gs, tasks)
        gs, tasks = await _boot("port", root, 6, first=False)
        try:
            await read_all(gs, 5, jh, jax_blocks)
            await read_all(gs, 1, ph, port_blocks)
        finally:
            await _shutdown(gs, tasks)

    asyncio.run(go())


def _server_exit(config_text: str, tmp_path, *args: str):
    cfg = tmp_path / "garage.toml"
    cfg.write_text(config_text.format(tmp=tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-c",
         _BLOCKED.format(mod="garage_tpu_torch.cli.server"),
         "--config", str(cfg), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


_MIN_CONFIG = """
metadata_dir = "{tmp}/meta"
data_dir = "{tmp}/data"
replication_factor = 1
rpc_bind_addr = "127.0.0.1:0"
"""


def test_server_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    """Without --device the server asks for CUDA and, with no CUDA
    device visible, stops before booting instead of running on the
    CPU."""
    r = _server_exit(_MIN_CONFIG, tmp_path)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stdout + r.stderr
    assert not (tmp_path / "meta").exists()


def _answer(port: int, path: str, host: str = "127.0.0.1"):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path, headers={"host": host})
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def _check_admin(port):
    # a node with no layout yet: the health answer says so
    assert _answer(port, "/health") == (503, "unavailable\n")
    st, text = _answer(port, "/metrics")
    assert st == 200
    names = {ln.split("{")[0].split()[0] for ln in text.splitlines()
             if ln.startswith("feeder_")}
    assert {"feeder_batches", "feeder_device_items", "feeder_max_batch",
            "feeder_device_fallbacks", "feeder_decode_device_items",
            "feeder_overlap_efficiency", "feeder_mesh_batches",
            "feeder_inline_items", "feeder_recompiles"} <= names
    # no route has been timed yet: no calibration rate is reported
    assert "feeder_throughput_mbps" not in names


def _check_k2v(port):
    # an unsigned request: the K2V front end refuses it in its own terms
    st, body = _answer(port, "/somebucket?search")
    assert st == 403 and "AccessDenied" in body


def _check_web(port):
    st, body = _answer(port, "/index.html", host="nobucket.web")
    assert st == 404 and "NoSuchBucket" in body


@pytest.mark.parametrize("section,check", [
    ('[admin]\napi_bind_addr = "127.0.0.1:{port}"\n', _check_admin),
    ('[k2v_api]\napi_bind_addr = "127.0.0.1:{port}"\n', _check_k2v),
    ('[web]\nbind_addr = "127.0.0.1:{port}"\nroot_domain = ".web"\n',
     _check_web),
], ids=["admin", "k2v", "web"])
def test_server_serves_front_end(tmp_path, section, check):
    """A port server booted with one front end's section (on the CPU)
    answers on that front end."""
    port = free_port()
    cfg = tmp_path / "garage.toml"
    cfg.write_text(_MIN_CONFIG.format(tmp=tmp_path)
                   + section.format(port=port))
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         _BLOCKED.format(mod="garage_tpu_torch.cli.server"),
         "--config", str(cfg), "--device", "cpu", "--log-level", "warning"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        while True:
            line = proc.stdout.readline()
            if "ready" in line:
                break
            if not line and proc.poll() is not None:
                raise AssertionError("port server died: "
                                     + proc.stdout.read())
        check(port)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    assert proc.returncode == 0


@pytest.mark.parametrize("section", [
    '[s3_api]\napi_bind_addr = "127.0.0.1:0"\n[gateway]\nworkers = 2\n'],
    ids=["gateway"])
def test_server_refuses_front_ends_it_has_not_ported(tmp_path, section):
    """Every front end is ported now, the multi-process gateway too: a
    gateway node is no longer refused as unported, and its workers run
    on the store's device, so without --device and with no CUDA device
    visible it stops before booting (it never starts CPU workers by
    itself)."""
    r = _server_exit(_MIN_CONFIG + section, tmp_path)
    assert r.returncode != 0
    out = r.stdout + r.stderr
    assert "not ported yet" not in out
    assert "no CUDA device is available" in out
    assert not (tmp_path / "meta").exists()


def test_server_refuses_tpu_enable_false_off_the_cpu(tmp_path):
    """`[tpu] enable = false` is the host-only node, as in the JAX
    package: without --device (CUDA) and with no CUDA device visible,
    the server boots and serves instead of stopping, its feeder "off"."""
    port = free_port()
    cfg = tmp_path / "garage.toml"
    cfg.write_text(_MIN_CONFIG.format(tmp=tmp_path)
                   + "[tpu]\nenable = false\n"
                   + f'[admin]\napi_bind_addr = "127.0.0.1:{port}"\n')
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         _BLOCKED.format(mod="garage_tpu_torch.cli.server"),
         "--config", str(cfg), "--log-level", "warning"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        while True:
            line = proc.stdout.readline()
            if "ready" in line:
                break
            if not line and proc.poll() is not None:
                raise AssertionError("port server died: "
                                     + proc.stdout.read())
        st, text = _answer(port, "/metrics")
        assert st == 200 and "feeder_device_items 0" in text
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    assert proc.returncode == 0