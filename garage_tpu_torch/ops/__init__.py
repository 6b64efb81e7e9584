"""ops — the GPU data plane of the port.

  gf256.py     GF(2^8) host arithmetic + the plain torch bit-matrix
               formulation (the kernels' reference)
  rs.py        Cauchy-Reed-Solomon (k, m): matrices, numpy oracles,
               and the torch encode / decode / repair / parity_check
  gf_kernel.py wrappers of kernels G1 (gf_apply) and G2 (gf_check),
               csrc/gf256.cu
  treehash.py  BLAKE3: pure-Python oracle, plain torch batch, and the
               wrapper of kernel B3 (blake3_rows), csrc/blake3.cu
  sha256.py    SHA-256: host padding helpers, plain torch batch, and the
               wrapper of kernel S2 (sha256_rows), csrc/sha256.cu
  _build.py    nvcc build + ctypes load of csrc/*.cu
"""

from __future__ import annotations


def kernel_launches() -> dict[str, int]:
    """Launch count of every kernel wrapper, by kernel name."""
    from . import gf_kernel, sha256, treehash

    return {**gf_kernel.launches, **treehash.launches, **sha256.launches}


def reset_launches() -> None:
    from . import gf_kernel, sha256, treehash

    for counts in (gf_kernel.launches, treehash.launches, sha256.launches):
        for name in counts:
            counts[name] = 0
