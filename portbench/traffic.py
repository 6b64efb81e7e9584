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

Multipart: a mix with "multipart": {"threshold": t, "part_size": p}
uploads an object of t bytes or more as ceil(size / p) UploadParts,
each but the last exactly p bytes (the AWS CLI's multipart_threshold and
multipart_chunksize); a smaller object is one PutObject. The sizes are
the same law's either way. Part n of object i is random bytes from
(seed, object i, part n), so no whole object body is ever made.
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

    def part_sizes(self, size: int) -> list[int] | None:
        """Lengths of the UploadParts of an object of `size` bytes, or
        None where the mix sends it as one PutObject."""
        mp = self.spec.get("multipart")
        if not mp or size < mp["threshold"]:
            return None
        return blocks_of(size, mp["part_size"])

    def part_body(self, i: int, n: int, size: int) -> bytes:
        """Body of part n (from 1) of window object i."""
        rng = np.random.default_rng([self.seed, _BODY_STREAM, 2, i, n])
        return rng.bytes(size)

    def unit_body(self, tag: str, idx, size: int) -> bytes:
        """Body of a unit of the stored-block check: an object
        ("put", i) or ("fill", j), or a part ("part", (i, n))."""
        return (self.part_body(*idx, size) if tag == "part"
                else self.body(tag, idx, size))

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
