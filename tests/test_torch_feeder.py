"""The port's DeviceFeeder (garage_tpu_torch.block.feeder) against the
JAX package's, on the CPU, at zero tolerance.

Both feeders run in mode "require": every batch takes the device route
(the JAX package's XLA programs on the CPU; the port's torch backend on
device="cpu", i.e. the kernels' plain torch versions). The same blocks,
made from a numpy seed, go through the eight ops the block manager,
scrub and resync call; the native libraries are loaded on both sides
first, so both frame shards with the crc32c flavour.
"""

from __future__ import annotations

import asyncio
import hashlib
import itertools
import threading

import numpy as np
import pytest
import torch

from garage_tpu import native as jnative
from garage_tpu.block.codec import ErasureCodec as JCodec
from garage_tpu.block.feeder import DeviceFeeder as JFeeder
from garage_tpu.block.hostbuf import HostBufPool as JPool
from garage_tpu.ops import rs as jrs
from garage_tpu_torch import native as tnative
from garage_tpu_torch.block import feeder as tfeeder
from garage_tpu_torch.block.codec import ErasureCodec
from garage_tpu_torch.block.device_backend import TorchDeviceBackend
from garage_tpu_torch.block.feeder import DeviceFeeder
from garage_tpu_torch.block.hostbuf import HostBufPool
from garage_tpu_torch.block.manager import pack_shard, unpack_shard

# tier-1 runs several pytest workers per machine: one torch thread each
torch.set_num_threads(1)

K, M = 10, 4
BLOCK = 64 << 10


@pytest.fixture(scope="module", autouse=True)
def _native_loaded():
    if not (jnative.available() and tnative.available()):
        pytest.skip("no C toolchain for the native libraries")


def _feeders(k=K, m=M):
    ref = JFeeder(codec=JCodec(k, m, use_jax=False), mode="require")
    ref._device_ok = True  # the JAX "device" is the CPU platform here
    port = DeviceFeeder(codec=ErasureCodec(k, m, device="cpu"),
                        mode="require", device="cpu")
    return ref, port


def _blocks(n, seed, size=BLOCK):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for _ in range(n)]


async def _both(ref, port, fn):
    try:
        return (await asyncio.gather(*fn(ref)),
                await asyncio.gather(*fn(port)))
    finally:
        await ref.stop()
        await port.stop()


def _stripe(block: bytes, prefix=b"\x00"):
    return [bytes(s) for s in
            jrs.split_stripe(prefix + block, K)] + [
        bytes(p) for p in jrs.encode_np(K, M, jrs.split_stripe(prefix + block,
                                                              K))]


def test_encode_put_matches_reference():
    ref, port = _feeders()
    blocks = _blocks(5, 1) + [_blocks(1, 2, size=BLOCK - 777)[0]]
    want, got = asyncio.run(_both(ref, port, lambda f: [
        f.encode_put(b, prefix=b"\x00") for b in blocks]))
    assert [[bytes(s) for s in parts] for parts in got] == \
        [[bytes(s) for s in parts] for parts in want]
    for parts, b in zip(got, blocks):
        assert [unpack_shard(bytes(s))[0] for s in parts] == _stripe(b)
    assert port.stats["device_items"] == len(blocks)
    assert port.stats["device_fallbacks"] == 0


@pytest.mark.parametrize("sizes", [[0, 1, 9, 10, 11], [BLOCK, 5_000, 17]])
def test_encode_and_encode_put_small_blocks_match_reference(sizes):
    """Blocks shorter than k bytes, empty ones and ragged shard lengths:
    the stripe fill (prefix, tail zeros, row padding) stays exact."""
    ref, port = _feeders()
    blocks = [b[:n] for b, n in zip(_blocks(len(sizes), 5), sizes)]
    want, got = asyncio.run(_both(ref, port, lambda f: [
        f.encode_put(b, prefix=b"\x07") for b in blocks]
        + [f.encode(b) for b in blocks]))
    assert [[bytes(s) for s in p] for p in got] == \
        [[bytes(s) for s in p] for p in want]


def _leases(pool, blocks):
    out = []
    for b in blocks:
        lease = pool.try_acquire()
        lease.body_mv()[:len(b)] = b
        lease.length = len(b)
        lease.set_scheme(0)
        out.append(lease)
    return out


def test_encode_put_lease_matches_reference():
    """Zero-copy ingest leases of full blocks (the only kind the block
    manager hands over), each released only after encode_put returns."""
    ref, port = _feeders()
    blocks = _blocks(3, 3)
    jl = _leases(JPool(K, BLOCK, 4), blocks)
    tl = _leases(HostBufPool(K, BLOCK, 4), blocks)
    want, got = asyncio.run(_both(
        ref, port,
        lambda f: [f.encode_put(x) for x in (jl if f is ref else tl)]))
    assert [[bytes(s) for s in p] for p in got] == \
        [[bytes(s) for s in p] for p in want]
    for lease in tl:
        lease.release()


def test_encode_put_partial_lease_equals_copy_path():
    """A partly filled lease frames exactly as its (prefix, data) copy."""
    _ref, port = _feeders()
    block = _blocks(1, 4, size=BLOCK // 3)[0]
    (lease,) = _leases(HostBufPool(K, BLOCK, 1), [block])

    async def go():
        try:
            return (await port.encode_put(lease),
                    await port.encode_put(block, prefix=b"\x00"))
        finally:
            await port.stop()

    from_lease, from_copy = asyncio.run(go())
    assert [bytes(s) for s in from_lease] == [bytes(s) for s in from_copy]
    assert [unpack_shard(bytes(s))[0] for s in from_lease] == _stripe(block)
    lease.release()


def test_hash_with_md5_matches_reference():
    """Three objects of three blocks, one Md5 per object, blocks of the
    objects submitted concurrently so that batches form."""
    ref, port = _feeders()
    objects = [_blocks(3, 10 + i) for i in range(3)]

    async def put(f, md5s):
        f.active_streams = len(objects)
        digests = [[] for _ in objects]

        async def stream(i):
            for b in objects[i]:
                digests[i].append(await f.hash_with_md5(b, md5s[i]))
        await asyncio.gather(*(stream(i) for i in range(len(objects))))
        await f.stop()
        return digests

    jmd5 = [jnative.Md5() for _ in objects]
    tmd5 = [tnative.Md5() for _ in objects]
    want = asyncio.run(put(ref, jmd5))
    got = asyncio.run(put(port, tmd5))
    assert got == want
    for i, obj in enumerate(objects):
        assert tmd5[i].hexdigest() == jmd5[i].hexdigest() \
            == hashlib.md5(b"".join(obj)).hexdigest()
        assert got[i] == [tnative.blake3(b) for b in obj]
    assert port.stats["device_items"] == 9


def test_hash_matches_reference():
    """The plain content-hash op, over rows of several chunk counts
    (one device group each) and an empty block."""
    ref, port = _feeders()
    blocks = [b[:n] for b, n in zip(_blocks(6, 6),
                                    [0, 1, 1025, 3000, BLOCK, BLOCK])]
    want, got = asyncio.run(_both(ref, port, lambda f: [
        f.hash(b) for b in blocks]))
    assert got == want == [tnative.blake3(b) for b in blocks]


def test_decode_matches_reference_mixed_patterns():
    ref, port = _feeders()
    blocks = _blocks(4, 20)
    rng = np.random.default_rng(21)
    items = []
    for b in blocks:
        st = _stripe(b)
        present = tuple(sorted(rng.choice(K + M, K, replace=False)))
        items.append((present, [st[i] for i in present], len(b) + 1))
    want, got = asyncio.run(_both(ref, port, lambda f: [
        f.decode(*it) for it in items]))
    assert got == want == [b"\x00" + b for b in blocks]
    assert port.stats["decode_device_items"] == len(items)


def test_decode_every_rs42_pattern_matches_reference():
    ref, port = _feeders(4, 2)
    block = _blocks(1, 25, size=3_000)[0]
    st = [bytes(s) for s in jrs.split_stripe(block, 4)]
    st += [bytes(p) for p in jrs.encode_np(4, 2, jrs.split_stripe(block, 4))]
    items = [(p, [st[i] for i in p], len(block))
             for p in itertools.combinations(range(6), 4)]
    want, got = asyncio.run(_both(ref, port, lambda f: [
        f.decode(*it) for it in items]))
    assert got == want == [block] * 15


def test_repair_matches_reference():
    ref, port = _feeders()
    blocks = _blocks(4, 30)
    items = []
    for b, missing in zip(blocks, [(0,), (13,), (2, 11), (0, 5, 10, 13)]):
        st = _stripe(b)
        present = tuple(i for i in range(K + M) if i not in missing)[:K]
        items.append((present, missing, [st[i] for i in present]))
    want, got = asyncio.run(_both(ref, port, lambda f: [
        f.repair(*it) for it in items]))
    assert got == want
    for (_p, missing, _s), b, out in zip(items, blocks, got):
        assert out == {mi: _stripe(b)[mi] for mi in missing}


def test_verify_blocks_matches_reference():
    ref, port = _feeders()
    blocks = _blocks(4, 40)
    items = [(tnative.blake3(b), b) for b in blocks]
    items[2] = (items[2][0], blocks[2][:-1] + b"\x01")  # corrupt
    want, got = asyncio.run(_both(ref, port, lambda f: [
        f.verify_blocks(items)]))
    assert got == want == [[True, True, False, True]]


def test_parity_check_matches_reference():
    ref, port = _feeders()
    stripes = [_stripe(b) for b in _blocks(4, 50)]
    bad = bytearray(stripes[1][3])
    bad[100] ^= 0x08
    stripes[1][3] = bytes(bad)
    want, got = asyncio.run(_both(ref, port, lambda f: [
        f.parity_check(stripes)]))
    assert got == want == [[True, False, True, True]]


def test_parity_check_wide_code_matches_reference():
    """A scrub parity_check of erasure(20,20) stripes through the feeder
    (G2 refused 20 parity rows before its redesign)."""
    k, m = 20, 20
    ref, port = _feeders(k, m)
    stripes = []
    for b in _blocks(3, 60, size=20 << 10):
        data = jrs.split_stripe(b"\x00" + b, k)
        stripes.append([bytes(s) for s in data]
                       + [bytes(p) for p in jrs.encode_np(k, m, data)])
    bad = bytearray(stripes[2][k + m - 1])
    bad[-1] ^= 0x01
    stripes[2][k + m - 1] = bytes(bad)
    want, got = asyncio.run(_both(ref, port, lambda f: [
        f.parity_check(stripes)]))
    assert got == want == [[True, True, False]]


def test_pack_shard_matches_reference():
    from garage_tpu.block.manager import pack_shard as jpack

    data = _blocks(1, 60, size=1000)[0]
    assert pack_shard(data, 12345) == jpack(data, 12345)


# ---------------------------------------------------------------------------
# The port's own rules: one mode, "require"; a failed or hung device
# group fails its own requests and is never re-run on the host
# ---------------------------------------------------------------------------


class _BrokenBackend(TorchDeviceBackend):
    def __init__(self, codec):
        super().__init__(codec=codec, device="cpu")

    def stage(self, op, blobs):
        raise RuntimeError("device lost")


def test_require_mode_raises_instead_of_falling_back():
    codec = ErasureCodec(K, M, device="cpu")
    f = DeviceFeeder(codec=codec, mode="require", device="cpu",
                     backend=_BrokenBackend(codec))
    blocks = _blocks(4, 70)

    async def go():
        try:
            return await asyncio.gather(
                *(f.encode_put(b, prefix=b"\x00") for b in blocks),
                return_exceptions=True)
        finally:
            await f.stop()

    res = asyncio.run(go())
    assert all(isinstance(r, RuntimeError) for r in res), res
    assert f.stats["device_fallbacks"] == 0
    assert f.stats["device_items"] == 0


class _HangOnceBackend(TorchDeviceBackend):
    """Its first stage call blocks until released; later ones work."""

    def __init__(self, codec):
        super().__init__(codec=codec, device="cpu")
        self.release = threading.Event()
        self.calls = 0

    def stage(self, op, blobs):
        self.calls += 1
        if self.calls == 1:
            self.release.wait(10.0)
        return super().stage(op, blobs)


def test_device_hang_fails_the_group(monkeypatch):
    """The watchdog fails a hung group's requests (no host re-run); the
    next batch runs on a fresh pipeline generation."""
    monkeypatch.setattr(tfeeder, "_BATCH_TIMEOUT", 0.3)
    codec = ErasureCodec(K, M, device="cpu")
    be = _HangOnceBackend(codec)
    f = DeviceFeeder(codec=codec, mode="require", device="cpu", backend=be)
    block = _blocks(1, 72)[0]

    async def go():
        try:
            with pytest.raises(RuntimeError, match="hung"):
                await f.encode_put(block, prefix=b"\x00")
            return await f.encode_put(block, prefix=b"\x00")
        finally:
            be.release.set()
            await f.stop()

    parts = asyncio.run(go())
    assert [unpack_shard(bytes(s))[0] for s in parts] == _stripe(block)
    assert f.stats["device_items"] == 1
    assert f.stats["device_fallbacks"] == 0


class _NoEncodeBackend(TorchDeviceBackend):
    def __init__(self, codec):
        super().__init__(codec=codec, device="cpu")

    def stage(self, op, blobs):
        if op == "encode_put":
            raise RuntimeError("encode lost")
        return super().stage(op, blobs)


def test_failed_group_fails_only_its_own_requests():
    """One batch, two op groups: the failing group's requests raise, the
    other group's complete on the device."""
    codec = ErasureCodec(K, M, device="cpu")
    f = DeviceFeeder(codec=codec, mode="require", device="cpu",
                     backend=_NoEncodeBackend(codec))
    blocks = _blocks(3, 73)

    async def go():
        try:
            return await asyncio.gather(
                *(f.encode_put(b, prefix=b"\x00") for b in blocks),
                *(f.hash(b) for b in blocks), return_exceptions=True)
        finally:
            await f.stop()

    res = asyncio.run(go())
    assert all(isinstance(r, RuntimeError) for r in res[:3]), res
    assert res[3:] == [tnative.blake3(b) for b in blocks]
    assert f.stats["device_items"] == 3


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_host_modes_are_rejected(mode):
    """The JAX feeder's host-routing modes do not exist in the port."""
    with pytest.raises(ValueError, match="require"):
        DeviceFeeder(mode=mode, device="cpu")


def test_unknown_mode_is_rejected():
    with pytest.raises(ValueError):
        DeviceFeeder(mode="fast", device="cpu")


def test_require_mode_never_takes_the_host_inline_path():
    """With the native library loaded, a lone request of every op still
    goes through the device backend."""
    codec = ErasureCodec(K, M, device="cpu")
    f = DeviceFeeder(codec=codec, mode="require", device="cpu")
    assert tnative.loaded()
    block = _blocks(1, 74)[0]
    st = _stripe(block)
    present = tuple(range(1, K + 1))

    async def go():
        try:
            await f.hash(block)
            await f.hash_with_md5(block, tnative.Md5())
            await f.encode(block)
            await f.encode_put(block, prefix=b"\x00")
            await f.verify_blocks([(tnative.blake3(block), block)])
            await f.parity_check([st])
            await f.decode(present, [st[i] for i in present], len(block) + 1)
            await f.repair(present, (0,), [st[i] for i in present])
        finally:
            await f.stop()

    asyncio.run(go())
    assert f.stats["items"] == f.stats["device_items"] == 8
    assert f.stats["decode_device_items"] == 2


def test_backend_sha256_stage_compute_readback():
    """The backend's sha256 op: stage -> compute -> readback gives
    hashlib's hex digests for buffers and span lists alike."""
    be = TorchDeviceBackend(device="cpu")
    msgs = [b"x", b"", (b"ab", b"c"), bytes(range(200))]
    staged = be.stage("sha256", msgs)
    got = be.readback("sha256", be.compute("sha256", staged))
    assert got == [hashlib.sha256(b"".join(m) if isinstance(m, tuple)
                                  else m).hexdigest() for m in msgs]


class _RecordingBackend(TorchDeviceBackend):
    """Records the shape of every staged sha256 group."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.sha_groups = []

    def _stage_sha256(self, datas):
        rows, nbs = super()._stage_sha256(datas)
        self.sha_groups.append((tuple(rows.shape), nbs.tolist()))
        return rows, nbs


@pytest.mark.parametrize("streams", [1, 5])
def test_sha256_hex_matches_reference(streams):
    """Port feeder vs the JAX package's: the JAX feeder takes its device
    route (XLA on the CPU) only with more than one active stream, the
    port's always takes the device route."""
    ref, port = _feeders()
    ref.active_streams = port.active_streams = streams
    msgs = _blocks(streams, 90 + streams, size=700)
    msgs[0] = [msgs[0][:100], msgs[0][100:]]  # a span list

    def calls(f):
        return [f.sha256_hex(m) for m in msgs]

    want, got = asyncio.run(_both(ref, port, calls))
    assert got == want == [
        hashlib.sha256(b"".join(m) if isinstance(m, list) else m)
        .hexdigest() for m in msgs]
    assert port.stats["device_items"] == streams
    assert port.pipeline_stats()["op_items"] == {"sha256": streams}


def test_concurrent_sha256_calls_batch_into_one_group():
    """Concurrent streams' chunk digests form one batch and one S2
    group whose row width is its longest message's padded length."""
    be = _RecordingBackend(device="cpu")
    f = DeviceFeeder(backend=be, device="cpu")
    lengths = [10, 3000, 100, 1000, 64]
    msgs = _blocks(len(lengths), 91, size=3000)
    msgs = [m[:n] for m, n in zip(msgs, lengths)]
    f.active_streams = len(msgs)

    async def go():
        try:
            return await asyncio.gather(*(f.sha256_hex(m) for m in msgs))
        finally:
            await f.stop()

    got = asyncio.run(go())
    assert got == [hashlib.sha256(m).hexdigest() for m in msgs]
    assert f.stats["batches"] == 1 and f.stats["device_batches"] == 1
    nbs = [(n + 9 + 63) // 64 for n in lengths]
    assert be.sha_groups == [((len(msgs), max(nbs) * 64), nbs)]
    assert be.stats["pad_waste_bytes"] == len(msgs) * max(nbs) * 64 \
        - sum(lengths)


def test_probe_and_cuda_entry_points():
    assert tfeeder.probe_device("cpu")["ok"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = tfeeder.probe_device("cuda")
    assert not res["ok"] and res["error"]
    with pytest.raises(RuntimeError):
        ErasureCodec(K, M)
    with pytest.raises(RuntimeError):
        TorchDeviceBackend(device="cuda")
    f = DeviceFeeder(codec=ErasureCodec(K, M, device="cpu"), mode="require")

    async def go():
        try:
            await f.hash(b"abc")
        finally:
            await f.stop()

    with pytest.raises(RuntimeError, match="probe failed"):
        asyncio.run(go())


def test_codec_encode_batch_matches_reference():
    blocks = _blocks(3, 80, size=5_000)
    got = ErasureCodec(K, M, device="cpu").encode_batch(blocks)
    assert got == JCodec(K, M, use_jax=True).encode_batch(blocks)


@pytest.mark.parametrize("present", [(0, 1, 2, 3, 4, 5, 6, 7, 8, 9),
                                     (1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
                                     (0, 2, 4, 6, 8, 10, 11, 12, 13, 1)])
def test_codec_host_paths_match_reference(present):
    """The codec's host-only single-stripe paths (all-systematic
    decode, deep scrub's localization, repair_parts) equal the JAX
    package's."""
    block = b"\x00" + _blocks(1, 81, size=5_000)[0]
    st = _stripe(block[1:])
    parts = {i: st[i] for i in present}
    port, ref = ErasureCodec(K, M, device="cpu"), JCodec(K, M, use_jax=False)
    assert port.decode(parts, len(block)) == ref.decode(parts, len(block)) \
        == block
    missing = tuple(i for i in range(K + M) if i not in present)
    assert port.repair_parts(parts, missing) == \
        ref.repair_parts(parts, missing) == {i: st[i] for i in missing}
    full = dict(enumerate(st))
    assert port.parity_ok(full, b"") and ref.parity_ok(full, b"")
    bad = dict(full)
    bad[K] = bytes([bad[K][0] ^ 1]) + bad[K][1:]
    assert not port.parity_ok(bad, b"") and not ref.parity_ok(bad, b"")
