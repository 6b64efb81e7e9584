"""Shared helpers of portbench's tests: a copy of the benchmark's data
files with the traffic mixes cut down to what a CPU run holds."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_bench(dst: str) -> str:
    """portbench's configs/, traffic/ and metrics/ under `dst`, every
    mix cut to 4 clients, objects of 64 KiB-1 MiB (8 sizes) and a 1 s
    ramp, fills to 16 objects; a multipart mix to objects of 256 KiB-2
    MiB in parts of 256 KiB from 256 KiB up, so that it stays multipart
    (2 to 8 parts an object)."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub),
                        os.path.join(dst, sub))
    tdir = os.path.join(dst, "traffic")
    for name in os.listdir(tdir):
        p = os.path.join(tdir, name)
        with open(p) as f:
            spec = json.load(f)
        spec.update(size_min=65536, size_max=1 << 20, strata=8, clients=4,
                    ramp_s=1)
        if "fill" in spec:
            spec["fill"]["objects"] = 16
        if "multipart" in spec:
            spec.update(size_min=256 << 10, size_max=2 << 20,
                        multipart={"threshold": 256 << 10,
                                   "part_size": 256 << 10})
        with open(p, "w") as f:
            json.dump(spec, f)
    return dst


@pytest.fixture
def cuda_device():
    """Skips the test where no CUDA device exists (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return "cuda"
