"""garage_tpu_torch — the PyTorch/CUDA port of garage_tpu's block data
path, for NVIDIA Hopper (H100).

It imports torch and numpy, never jax and nothing of garage_tpu: host
helpers it needs are its own copies (native/, utils/, block/hostbuf.py,
the shard format in block/manager.py). Device work runs through
hand-written CUDA kernels (csrc/, built with nvcc at first use):

  G1 gf_apply   GF(2^8) matrix apply: RS encode, decode, repair
  G2 gf_check   parity re-derive + compare (scrub)
  B3 blake3_rows batched BLAKE3-256 (content hash)

Entry points run on "cuda" unless the caller passes device="cpu" (the
tests do, and then run each kernel's plain torch version); where no
CUDA device exists a "cuda" entry point raises."""

from __future__ import annotations

import torch

# the JAX package's release this port serves the same API as (the admin
# API reports it)
__version__ = "0.4.0"


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises if it names CUDA and none is
    available (the port never carries on on the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               "device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
