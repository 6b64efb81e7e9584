"""S3 multipart uploads on the port's replicate-N path, on the CPU: three
port nodes under replicate-3 with 1 MiB blocks (Garage's documented
3-node deployment, the benchmark's `rep3`), on the loopback transport
and an event loop of their own thread, node 0 serving S3; driven over
HTTP with the independent signer in tests/s3util.py.

Every upload is held against portbench/reference.py and hashlib on
seeded random bytes, with byte equality: each part's ETag is its MD5,
the Complete's is S3's MD5(the parts' binary MD5s)-N, GetObject (whole
and by a range across a part boundary) returns the parts in order,
every block of every part lies on all three nodes under the reference
BLAKE3 of its bytes, and once the Complete has propagated every live
block ref of the object names its final version. A Complete that names
a part it may not is refused as InvalidPart. The multipart spans and
the replicated block write's span are emitted with the tracer on, once
per handler, part and block, and never with it off."""

from __future__ import annotations

import asyncio
import hashlib
import os
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import reference as ref  # noqa: E402
from s3util import S3Client, xml_error_code, xml_find  # noqa: E402

from garage_tpu_torch.utils.tracing import tracer  # noqa: E402

NODES = 3
BLOCK = 1 << 20
MIB = 1 << 20
BUCKET = "mpu-rep3"
MPU_SPANS = ("s3.mpu.create", "s3.mpu.put_part", "s3.mpu.complete",
             "s3.mpu.ref_repoint", "block.write_replicas")


def _body(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _blocks(part: bytes) -> list[bytes]:
    """A part cut as the port cuts it: the chunker restarts at each
    part, so blocks never straddle two parts."""
    return [part[o:o + BLOCK] for o in range(0, len(part), BLOCK)]


class Box:
    """The cluster on an event loop of its own thread: tests call S3
    from theirs, and run coroutines on the loop with `run`."""

    def __init__(self, root: str):
        self.root = root
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.garages: list = []
        self.tasks: list = []
        self.s3 = None
        key_id, secret, port = self.run(self._start())
        self.client = S3Client("127.0.0.1", port, key_id, secret)

    def run(self, coro, timeout: float = 120.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def data_dir(self, i: int) -> str:
        return os.path.join(self.root, f"node{i}", "data")

    async def _start(self):
        from garage_tpu_torch.admin.rpc import AdminRpcHandler
        from garage_tpu_torch.api.s3.api_server import S3ApiServer
        from garage_tpu_torch.model.garage import Garage
        from garage_tpu_torch.net import LocalNetwork
        from garage_tpu_torch.rpc.layout import NodeRole
        from garage_tpu_torch.utils.config import Config, DataDir, QosConfig

        net = LocalNetwork()
        for i in range(NODES):
            d = os.path.join(self.root, f"node{i}")
            cfg = Config(metadata_dir=os.path.join(d, "meta"),
                         data_dir=[DataDir(path=self.data_dir(i))],
                         replication_factor=3, consistency_mode="consistent",
                         block_size=BLOCK, db_engine="lsm",
                         block_read_cache_max_bytes=0,
                         qos=QosConfig(governor=False))
            g = Garage(cfg, local_net=net, status_interval=0.2,
                       ping_interval=0.5, device="cpu")
            self.garages.append(g)
            self.tasks.append(asyncio.create_task(g.run()))
        g0 = self.garages[0]
        for g in self.garages[1:]:
            await g.netapp.try_connect(g0.netapp.public_addr, g0.system.id)
            g.system.peering.add_peer(g0.netapp.public_addr, g0.system.id)
        await self._until(lambda: all(len(g.netapp.conns) == NODES - 1
                                      for g in self.garages), "mesh")
        lm = g0.system.layout_manager
        for g in self.garages:
            lm.history.stage_role(g.system.id,
                                  NodeRole(zone="dc1", capacity=1 << 30))
        lm.apply_staged(None)
        await self._until(lambda: all(
            g.system.layout_manager.history.current().version == 1
            for g in self.garages), "layout v1")
        assert not g0.block_manager.erasure
        assert g0.block_manager.codec.write_quorum == 2
        self.s3 = S3ApiServer(g0)
        await self.s3.start("127.0.0.1", 0)
        admin = AdminRpcHandler(g0)
        k = await admin.op_key_new({"name": "mpu"})
        await admin.op_bucket_create({"name": BUCKET})
        await admin.op_bucket_allow({"bucket": BUCKET, "key": k["key_id"],
                                     "read": True, "write": True})
        return k["key_id"], k["secret_key"], self.s3.http.bound_port

    @staticmethod
    async def _until(cond, what: str, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            assert time.monotonic() < deadline, f"timeout waiting for {what}"
            await asyncio.sleep(0.05)

    async def _stop(self) -> None:
        await self.s3.stop()
        for g in self.garages:
            await g.netapp.shutdown()
        await asyncio.gather(*(g.stop() for g in self.garages))
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)

    def close(self) -> None:
        self.run(self._stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()

    # ---- the cluster's state, read on its loop -------------------------

    async def _live_refs(self, hashes: list[bytes]) -> list[list[set]]:
        """-> for each node, for each block, the version uuids of its
        live block refs in that node's own table."""
        out = []
        for g in self.garages:
            t = g.block_ref_table
            out.append([{e.version for e in map(
                t.schema.decode_entry, t.data.read_range(h, None, None, 100))
                if not e.is_tombstone()} for h in hashes])
        return out

    async def _flush_queues(self) -> None:
        for g in self.garages:
            for t in (g.object_table, g.mpu_table, g.version_table,
                      g.block_ref_table):
                await t.flush_insert_queue()

    def refs_settled(self, hashes: list[bytes], uuid: bytes,
                     timeout: float = 60.0) -> list[list[set]]:
        """Flush the nodes' insert queues (the Complete's tombstones of
        the part versions and their refs propagate through them) until
        every node holds exactly the final version's ref for each block,
        or the time is up; -> what the nodes hold last."""
        async def go():
            deadline = time.monotonic() + timeout
            while True:
                refs = await self._live_refs(hashes)
                if all(r == {uuid} for node in refs for r in node) \
                        or time.monotonic() > deadline:
                    return refs
                await self._flush_queues()
                await asyncio.sleep(0.1)
        return self.run(go(), timeout + 30)


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    import torch

    torch.set_num_threads(1)
    b = Box(str(tmp_path_factory.mktemp("mpu_rep3")))
    try:
        yield b
    finally:
        b.close()


# ---- S3 over HTTP ------------------------------------------------------


def _create(c: S3Client, key: str) -> str:
    st, _h, body = c.request("POST", f"/{BUCKET}/{key}", [("uploads", "")])
    assert st == 200, body
    return xml_find(body, "UploadId")[0]


def _put_part(c: S3Client, key: str, upload: str, n: int,
              body: bytes) -> str:
    st, h, rbody = c.request("PUT", f"/{BUCKET}/{key}",
                             [("partNumber", str(n)), ("uploadId", upload)],
                             body=body, unsigned_payload=True, timeout=120)
    assert st == 200, rbody
    return h["etag"].strip('"')


def _complete(c: S3Client, key: str, upload: str,
              parts: list[tuple[int, str]]):
    xml = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag>"
                  "</Part>" for n, e in parts)
    body = f"<CompleteMultipartUpload>{xml}</CompleteMultipartUpload>"
    return c.request("POST", f"/{BUCKET}/{key}", [("uploadId", upload)],
                     body=body.encode(), timeout=120)


def _files_of(box: Box, h: bytes) -> list[bytes | None]:
    """The stored file of block `h` on each node, or None."""
    out = []
    for i in range(NODES):
        p = os.path.join(ref.block_dir(box.data_dir(i), h), h.hex())
        if os.path.exists(p):
            with open(p, "rb") as f:
                out.append(f.read())
        else:
            out.append(None)
    return out


def _stored_everywhere(box: Box, blocks: list[bytes],
                       timeout: float = 30.0) -> list[list]:
    """Each block's files on the three nodes, once all three hold it
    (the copy past the write quorum may land after the reply) or the
    time is up."""
    names = ref.blake3_many(blocks)
    deadline = time.monotonic() + timeout
    while True:
        files = [_files_of(box, h) for h in names]
        if all(f is not None for fs in files for f in fs) \
                or time.monotonic() > deadline:
            return files
        time.sleep(0.05)


# ---- uploads held against the reference --------------------------------

# name -> (part sizes in part order, upload order, parts sent twice);
# every last part is short of the others
CASES = {
    "1-part": ([MIB + 300_000], [1], ()),
    "2-parts": ([5 * MIB // 2, 600_000], [1, 2], ()),
    "5-parts": ([3 * MIB // 2] * 4 + [300_000], [1, 2, 3, 4, 5], ()),
    "part-sent-twice": ([2 * MIB, 1_200_000, 500_000], [1, 2, 3], (2,)),
    "out-of-order": ([5 * MIB // 4] * 2 + [700_000], [3, 1, 2], ()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_upload_equals_the_reference(box, case):
    sizes, order, twice = CASES[case]
    c = box.client
    key = f"obj-{case}"
    seed = 1000 + 100 * list(CASES).index(case)
    parts = {n: _body(s, seed + n) for n, s in enumerate(sizes, 1)}
    upload = _create(c, key)
    etags = {}
    for n in order:
        if n in twice:
            # an older body of the same length, sent first and replaced
            old = _body(sizes[n - 1], seed + 50 + n)
            assert old != parts[n]
            assert _put_part(c, key, upload, n, old) == \
                hashlib.md5(old).hexdigest()
        etags[n] = _put_part(c, key, upload, n, parts[n])
        assert etags[n] == hashlib.md5(parts[n]).hexdigest()
    st, _h, body = _complete(c, key, upload, sorted(etags.items()))
    assert st == 200, body
    want = ref.multipart_etag([hashlib.md5(parts[n]).digest()
                               for n in sorted(parts)])
    assert xml_find(body, "ETag")[0].strip('"') == want

    whole = b"".join(parts[n] for n in sorted(parts))
    st, h, got = c.request("GET", f"/{BUCKET}/{key}", timeout=120)
    assert st == 200 and got == whole
    assert h["etag"].strip('"') == want
    # a range across the first part's end (across a block's end where
    # the object has one part)
    edge = sizes[0] if len(sizes) > 1 else BLOCK
    lo, hi = edge - 4000, edge + 3999
    st, _h, got = c.request("GET", f"/{BUCKET}/{key}",
                            headers={"range": f"bytes={lo}-{hi}"})
    assert st == 206 and got == whole[lo:hi + 1]

    blocks = [b for n in sorted(parts) for b in _blocks(parts[n])]
    for blk, files in zip(blocks, _stored_everywhere(box, blocks)):
        assert files == [blk] * NODES
    uuid = bytes.fromhex(upload)
    refs = box.refs_settled(ref.blake3_many(blocks), uuid)
    assert refs == [[{uuid}] * len(blocks)] * NODES


# ---- Completes the store refuses ----------------------------------------


def _flip(etag: str) -> str:
    return ("1" if etag[0] != "1" else "2") + etag[1:]


@pytest.mark.parametrize("wrong", ["altered-etag", "replaced-etag",
                                   "unsent-part"])
def test_complete_naming_a_wrong_part_is_refused(box, wrong):
    c = box.client
    key = f"refused-{wrong}"
    p1, p2 = _body(MIB + 1000, 7001), _body(200_000, 7002)
    upload = _create(c, key)
    e1 = _put_part(c, key, upload, 1, p1)
    old = (_put_part(c, key, upload, 2, _body(200_000, 7003))
           if wrong == "replaced-etag" else None)
    e2 = _put_part(c, key, upload, 2, p2)
    bad = {"altered-etag": [(1, _flip(e1)), (2, e2)],
           "replaced-etag": [(1, e1), (2, old)],
           "unsent-part": [(1, e1), (2, e2), (3, e2)]}[wrong]
    st, _h, body = _complete(c, key, upload, bad)
    assert st == 400 and xml_error_code(body) == "InvalidPart", body
    # the upload is still open, and the right list completes it
    st, _h, body = _complete(c, key, upload, [(1, e1), (2, e2)])
    assert st == 200, body
    st, _h, got = c.request("GET", f"/{BUCKET}/{key}")
    assert st == 200 and got == p1 + p2


# ---- the spans ----------------------------------------------------------


@pytest.mark.parametrize("traced", [True, False], ids=["on", "off"])
def test_multipart_spans(box, traced):
    c = box.client
    key = f"traced-{traced}"
    parts = [_body(5 * MIB // 2, 8001), _body(600_000, 8002)]
    blocks = [b for p in parts for b in _blocks(p)]
    recs: list = []
    was = tracer.enabled
    tracer.sinks.append(recs.append)
    if traced:
        tracer.enable()
    try:
        upload = _create(c, key)
        etags = [(n, _put_part(c, key, upload, n, p))
                 for n, p in enumerate(parts, 1)]
        st, _h, body = _complete(c, key, upload, etags)
        assert st == 200, body
    finally:
        tracer.sinks.remove(recs.append)
        tracer.enabled = was
    got = [r for r in recs if r["name"] in MPU_SPANS]
    if not traced:
        assert got == []
        return
    by = {name: [r for r in got if r["name"] == name] for name in MPU_SPANS}
    assert len(by["s3.mpu.create"]) == 1
    assert sorted((r["attrs"]["part"], r["attrs"]["size"])
                  for r in by["s3.mpu.put_part"]) == \
        [(n, len(p)) for n, p in enumerate(parts, 1)]
    (done,) = by["s3.mpu.complete"]
    assert done["attrs"] == {"parts": 2, "blocks": len(blocks)}
    (repoint,) = by["s3.mpu.ref_repoint"]
    assert repoint["attrs"] == {"blocks": len(blocks)}
    assert repoint["parent"] == done["span"]
    assert repoint["dur_us"] <= done["dur_us"]
    writes = by["block.write_replicas"]
    assert len(writes) == len(blocks)
    assert all(w["attrs"] == {"copies": 3, "quorum": 2} for w in writes)
    assert all("error" not in r for r in got)
