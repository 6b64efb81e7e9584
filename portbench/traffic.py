"""The one traffic generator: reads a mix's parameters from
portbench/traffic/<name>.json and makes, from the seed, the sizes, keys
and bodies the load generator sends. A new mix is a new data file.

Object sizes are log-uniform between `size_min` and `size_max`: as many
objects in each doubling of size, the law of MinIO warp's random object
sizes (`--obj.randsize`, the mix's "source").

Every seed gets the same multiset of object sizes, in another order:
sizes are the quantiles of the size law at the centres of `strata`
equal-probability strata, and each consecutive group of `strata`
requests is one permutation of them drawn from the seed. Any run that
completes whole groups has sent exactly the same bytes in another order,
so seeds change the order and the contents, never the work.

Keys: a mix with "fill" first writes fill objects f000000... of the
same law, and its window requests draw keys from them, each consecutive
group of `fill.objects` requests a permutation of all of them.
Bodies are random bytes from (seed, object), incompressible as stored
media and backups are.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_SIZE_STREAM, _KEY_STREAM, _BODY_STREAM, _FILL_STREAM = 1, 2, 3, 4


def load(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        spec = json.load(f)
    spec["name"] = name
    return spec


def seed64(seed: int) -> int:
    """A run's seed as the generators take it."""
    return int(seed) % (1 << 64)


def size_set(spec: dict) -> list[int]:
    """The object sizes of one stratum group, smallest first: the
    log-uniform law's quantiles at the strata's centres."""
    lo, hi, n = spec["size_min"], spec["size_max"], spec["strata"]
    return [int(round(lo * (hi / lo) ** ((j + 0.5) / n))) for j in range(n)]


class Plan:
    """Sizes, keys and bodies of one run's requests, from the seed."""

    def __init__(self, spec: dict, seed: int):
        self.spec = spec
        self.seed = seed64(seed)
        self.sizes = size_set(spec)
        self._perm: dict = {}

    def _permutation(self, stream: int, group: int, n: int) -> np.ndarray:
        key = (stream, group)
        p = self._perm.get(key)
        if p is None:
            rng = np.random.default_rng([self.seed, stream, group])
            p = self._perm[key] = rng.permutation(n)
            if len(self._perm) > 4096:
                self._perm.clear()
                self._perm[key] = p
        return p

    def put_size(self, i: int) -> int:
        """Size of the i-th window PUT."""
        n = len(self.sizes)
        return self.sizes[self._permutation(_SIZE_STREAM, i // n, n)[i % n]]

    def body(self, tag: str, i: int, size: int) -> bytes:
        rng = np.random.default_rng(
            [self.seed, _BODY_STREAM, 0 if tag == "put" else 1, i])
        return rng.bytes(size)

    # fill objects (read mixes)

    @property
    def fill_count(self) -> int:
        return int(self.spec.get("fill", {}).get("objects", 0))

    def fill_size(self, j: int) -> int:
        """Size of fill object j: each group of `strata` fill objects
        holds the size set once, in a seeded order."""
        n = len(self.sizes)
        return self.sizes[self._permutation(_FILL_STREAM, j // n, n)[j % n]]

    def get_target(self, i: int) -> int:
        """Fill object the i-th window GET reads."""
        n = self.fill_count
        return int(self._permutation(_KEY_STREAM, i // n, n)[i % n])

    @staticmethod
    def put_key(i: int) -> str:
        return f"p{i:07d}"

    @staticmethod
    def fill_key(j: int) -> str:
        return f"f{j:06d}"


def blocks_of(size: int, block_size: int) -> list[int]:
    """Lengths of the blocks an object of `size` bytes is cut into."""
    full, tail = divmod(size, block_size)
    return [block_size] * full + ([tail] if tail else [])


def chunks_of(size: int, chunk: int) -> list[int]:
    """Lengths of the aws-chunked data chunks of a body."""
    full, tail = divmod(size, chunk)
    return [chunk] * full + ([tail] if tail else [])


def describe(spec: dict) -> dict:
    """Plain numbers of a mix, for PERF.md and the tests."""
    s = size_set(spec)
    return {"sizes": len(s), "min": min(s), "max": max(s),
            "mean": sum(s) / len(s),
            "p95": sorted(s)[math.ceil(0.95 * len(s)) - 1]}
