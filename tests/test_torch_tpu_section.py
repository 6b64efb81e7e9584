"""The port honours garage.toml's `[tpu]` section as far as its keys mean
something on CUDA: a port `Garage` built from a config reads
`batch_blocks`, `inflight_batches`, `batch_timeout_s`, `batch_linger_ms`,
`pad_buckets` and `mesh_min_items` into its feeder exactly as the JAX package's `Garage`
built from the same file does, and its batches never exceed
`batch_blocks`. `enable = false` builds the host-only node (feeder mode
"off") on any device; `platform`, the one key with no meaning on the
port, is named in one warning. The admin API's /v1/s3/tuning sets
`inflight_batches` and the routing floors at run time, within the JAX
package's ranges."""

from __future__ import annotations

import asyncio
import logging
import os
import threading

import pytest
import torch

from garage_tpu.model.garage import Garage as JGarage
from garage_tpu.utils.config import read_config as jread_config
from garage_tpu_torch import native as tnative
from garage_tpu_torch.admin.http import apply_s3_tuning, s3_tuning_state
from garage_tpu_torch.block.device_backend import TorchDeviceBackend
from garage_tpu_torch.model.garage import Garage, check_tpu_section
from garage_tpu_torch.utils.config import read_config
from garage_tpu_torch.utils.error import BadRequest

# tier-1 runs several pytest workers per machine: one torch thread each
torch.set_num_threads(1)

_CONFIG = """
metadata_dir = "{tmp}/meta"
data_dir = "{tmp}/data"
replication_factor = 1
rpc_bind_addr = "127.0.0.1:0"

[metadata]
db_engine = "memory"

[tpu]
{tpu}
"""

_KNOBS = ("batch_blocks = 8\nbatch_linger_ms = 0\ninflight_batches = 2\n"
          "batch_timeout_s = 30\nmesh_min_items = 4\n")


def _config(tmp_path, tpu: str, reader=read_config):
    path = tmp_path / "garage.toml"
    path.write_text(_CONFIG.format(tmp=tmp_path, tpu=tpu))
    return reader(str(path))


def _settings(feeder) -> dict:
    return {"max_batch": feeder.max_batch,
            "inflight_batches": feeder.inflight_batches,
            "batch_timeout": feeder.batch_timeout,
            "batch_linger": feeder.batch_linger,
            "pad_buckets": tuple(feeder.pad_buckets),
            "mesh_min_items": feeder.mesh_min_items}


def test_feeder_reads_the_knobs_like_the_jax_package(tmp_path):
    """The settings read back from the feeder, against the JAX package's
    Garage built from the same file."""
    g = Garage(_config(tmp_path, _KNOBS), device="cpu")
    want = {"max_batch": 8, "inflight_batches": 2, "batch_timeout": 30.0,
            "batch_linger": 0.0,
            "pad_buckets": (1, 2, 4, 8, 16, 32, 64, 128, 256),
            "mesh_min_items": 4}
    assert _settings(g.block_manager.feeder) == want
    jtmp = tmp_path / "jax"
    jtmp.mkdir()
    jg = JGarage(_config(jtmp, _KNOBS, reader=jread_config))
    assert _settings(jg.block_manager.feeder) == want


def test_batches_never_exceed_batch_blocks(tmp_path):
    """32 concurrent hash_md5 items through a Garage built with
    `batch_blocks = 8, batch_linger_ms = 0`: no batch is wider than 8,
    and every digest and ETag is right."""
    if not tnative.available():
        pytest.skip("no C toolchain for the native library")
    g = Garage(_config(tmp_path, _KNOBS), device="cpu")
    feeder = g.block_manager.feeder
    blocks = [os.urandom(1024 + i) for i in range(32)]
    md5s = [tnative.Md5() for _ in blocks]

    async def go():
        feeder.active_streams = len(blocks)
        try:
            return await asyncio.gather(*(
                feeder.hash_with_md5(b, m) for b, m in zip(blocks, md5s)))
        finally:
            await feeder.stop()

    digests = asyncio.run(go())
    assert digests == [tnative.blake3(b) for b in blocks]
    import hashlib

    assert [m.hexdigest() for m in md5s] == [
        hashlib.md5(b).hexdigest() for b in blocks]
    assert feeder.stats["device_items"] == 32
    assert 0 < feeder.stats["max_batch"] <= 8
    assert feeder.stats["batches"] >= 4


class _CountingBackend(TorchDeviceBackend):
    """Records the batches in flight whenever a stage starts, and holds
    each stage a little so that batches would pile up."""

    def __init__(self, feeder):
        super().__init__(device="cpu")
        self.feeder = feeder
        self.seen: list[int] = []
        self._lock = threading.Lock()

    def stage(self, op, blobs):
        with self._lock:
            self.seen.append(self.feeder.pipeline_stats()["inflight"])
        threading.Event().wait(0.02)
        return super().stage(op, blobs)


@pytest.mark.parametrize("depth", [1, 2])
def test_inflight_batches_bounds_the_pipeline(tmp_path, depth):
    """`inflight_batches` set at run time (as /v1/s3/tuning does) bounds
    the batches in flight from the next batch on."""
    g = Garage(_config(tmp_path, "batch_blocks = 1\n"), device="cpu")
    feeder = g.block_manager.feeder
    be = _CountingBackend(feeder)
    feeder._backend = be
    apply_s3_tuning(g, {"feeder_inflight_batches": depth})
    assert feeder.inflight_batches == depth
    blocks = [os.urandom(512) for _ in range(12)]

    async def go():
        try:
            return await asyncio.gather(*(feeder.hash(b) for b in blocks))
        finally:
            await feeder.stop()

    assert asyncio.run(go()) == [tnative.blake3(b) for b in blocks]
    assert max(be.seen) == depth


def test_tuning_refuses_the_host_routing_floors(tmp_path):
    """The routing floors are tuned as in the JAX package: set, read
    back, held to its ranges; a refused update changes nothing."""
    g = Garage(_config(tmp_path, ""), device="cpu")
    feeder = g.block_manager.feeder
    state = s3_tuning_state(g)
    assert state["feeder_inflight_batches"] == 3
    assert state["feeder_device_min_bytes"] == 4 << 20
    assert state["feeder_device_min_decode_items"] == 4
    state = apply_s3_tuning(g, {"feeder_inflight_batches": 2,
                                "feeder_device_min_bytes": 1 << 20,
                                "feeder_device_min_items": 7,
                                "feeder_device_min_decode_bytes": 0,
                                "feeder_device_min_decode_items": 4096})
    assert (feeder.device_min_bytes, feeder.device_min_items,
            feeder.device_min_decode_bytes,
            feeder.device_min_decode_items) == (1 << 20, 7, 0, 4096)
    assert state["feeder_device_min_items"] == 7
    for knob, bad in (("feeder_device_min_bytes", -1),
                      ("feeder_device_min_items", 0),
                      ("feeder_device_min_decode_bytes", (1 << 40) + 1),
                      ("feeder_device_min_decode_items", 4097)):
        with pytest.raises(BadRequest, match=knob):
            apply_s3_tuning(g, {"feeder_inflight_batches": 3, knob: bad})
    # validate-then-apply: the refused update changed nothing
    assert feeder.inflight_batches == 2
    assert feeder.device_min_items == 7
    with pytest.raises(BadRequest):
        apply_s3_tuning(g, {"feeder_inflight_batches": 17})


def test_pad_buckets_shape_the_launches(tmp_path):
    g = Garage(_config(tmp_path, "pad_buckets = [3, 5]\n"), device="cpu")
    feeder = g.block_manager.feeder
    assert feeder.pad_buckets == (3, 5)
    be = feeder._get_backend()
    assert be.pad_buckets == (3, 5)
    _op, _blobs, (n, staged) = be.stage("hash", [b"a" * 100, b"b" * 200])
    assert n == 2 and staged[0][1].shape[0] == 3
    _op, _blobs, (n, staged) = be.stage("hash", [b"c" * 100] * 4)
    assert staged[0][1].shape[0] == 5


def test_enable_false_needs_the_cpu(tmp_path):
    """`enable = false` (the JAX package's host-only node) builds a port
    node whose feeder runs "off" on any device, its codec on the CPU;
    `enable = true` keeps "require"."""
    cfg = _config(tmp_path, "enable = false\n")
    for device in ("cuda", "cpu"):
        g = Garage(cfg, device=device)
        assert g.block_manager.feeder.mode == "off"
    assert check_tpu_section(cfg.tpu) == []
    (tmp_path / "on").mkdir()
    on = Garage(_config(tmp_path / "on", ""), device="cpu")
    assert on.block_manager.feeder.mode == "require"


def test_keys_without_meaning_are_named_once(tmp_path, caplog):
    cfg = _config(tmp_path, _KNOBS + "device_min_bytes = 1\n"
                  "device_min_items = 2\ntrial_max_items = 1\n"
                  'platform = "cpu"\n')
    assert check_tpu_section(cfg.tpu) == ["platform"]
    with caplog.at_level(logging.WARNING, "garage_tpu_torch.model"):
        g = Garage(cfg, device="cpu")
    warned = [r.getMessage() for r in caplog.records
              if "[tpu]" in r.getMessage()]
    assert len(warned) == 1
    assert warned[0].endswith(": platform")
    feeder = g.block_manager.feeder
    assert (feeder.device_min_bytes, feeder.device_min_items,
            feeder.trial_max_items) == (1, 2, 1)
    assert check_tpu_section(_config(tmp_path, _KNOBS).tpu) == []
