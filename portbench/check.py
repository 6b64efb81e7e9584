"""The comparison that decides `correct`, run once the window has
closed and drained: every number is a count, compared exactly (limit
0), or a quorum from the configuration.

From the load generator (hashlib, byte equality):
- failed: requests (the ramp's and the window's) and fill PUTs that
  got no 2xx reply (a wrong chunk-signature verdict on a sound body
  fails its PUT), and multipart uploads that never completed;
- etag_bad: acknowledged PutObjects and UploadParts whose ETag is not
  the MD5 of the body, and completed uploads whose ETag is not the MD5
  of the parts' binary MD5s, a dash and the part count (S3's rule,
  reference.multipart_etag);
- get_bad: GET replies whose body or ETag differs from the object PUT;
  in a multipart mix, the read-back of one completed upload (the
  smallest of two parts or more), whose body must be its parts in
  order and whose ETag must be the upload's;
- forged_accepted: signed PUTs with a forged chunk signature that the
  server accepted (signed mixes only).
From the nodes' data directories, for a sample of the acknowledged
units drawn from the seed, the largest among them, held against
reference.py (a unit is an object, or a part of a completed multipart
upload: the port cuts each part into blocks of its own):
- blocks_unfound: blocks stored under no file named by the reference
  BLAKE3 of their bytes;
- shards_bad: stored files of those blocks whose framing, checksum or
  bytes differ from the reference's (RS(k, m) parity, shard format;
  whole copies for replication);
- blocks_below_quorum: blocks found on fewer parts than the
  configuration's write quorum.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from portbench import reference as ref
from portbench import traffic


def sample(objects: list, seed: int, budget: int) -> list:
    """A seeded sample of (tag, index, size) units, the largest first,
    then others in a seeded order until `budget` bytes. A part's index
    is (object, part number)."""
    if not objects:
        return []
    order = sorted(objects, key=lambda o: (-o[2], o[0], o[1]))
    rest = order[1:]
    rng = np.random.default_rng([traffic.seed64(seed), 5])
    picked, total = [order[0]], order[0][2]
    for j in rng.permutation(len(rest)):
        if total >= budget:
            break
        picked.append(rest[j])
        total += rest[j][2]
    return picked


def stored(cfg: dict, plan: traffic.Plan, objects: list,
           data_dirs: list[str]) -> dict:
    """Hold the sampled objects' stored blocks against the reference."""
    g = cfg["garage"]
    bs = g["block_size"]
    quorum = cfg["guarantees"]["write_quorum"]
    ec = g.get("erasure_coding")
    k, m = map(int, ec.split(",")) if ec else (0, 0)
    blocks = [blk for tag, i, size in objects
              for blk in _cut(plan.unit_body(tag, i, size), bs)]
    hashes = ref.blake3_many(blocks)
    out = {"blocks_checked": len(blocks), "blocks_unfound": 0,
           "shards_bad": 0, "blocks_below_quorum": 0}
    crc = ref.Crc32c()
    for blk, h in zip(blocks, hashes):
        if k:
            good, seen = _erasure_block(blk, h, k, m, data_dirs, crc, out)
        else:
            good, seen = _replica_block(blk, h, data_dirs, out)
        out["blocks_unfound"] += not seen
        out["blocks_below_quorum"] += good < quorum
    return out


def _cut(body: bytes, bs: int) -> list[bytes]:
    return [body[o:o + bs] for o in range(0, len(body), bs)]


def _erasure_block(blk: bytes, h: bytes, k: int, m: int, dirs: list,
                   crc: ref.Crc32c, out: dict) -> tuple[int, bool]:
    packed = ref.packed_block(blk)
    rows = ref.rs_encode(packed, k, m)
    want_crc32c = crc.many(rows)
    good, seen = set(), False
    for d in dirs:
        base = os.path.join(ref.block_dir(d, h), h.hex())
        for i in range(k + m):
            p = f"{base}.s{i}"
            if not os.path.exists(p):
                continue
            seen = True
            with open(p, "rb") as f:
                raw = f.read()
            try:
                kind, plen, ck, payload = ref.parse_shard(raw)
            except ValueError:
                out["shards_bad"] += 1
                continue
            row = rows[i].tobytes()
            want = (int(want_crc32c[i]) if kind == "crc32c"
                    else zlib.crc32(row))
            if plen != len(packed) or payload != row or ck != want:
                out["shards_bad"] += 1
                continue
            good.add(i)
    return len(good), seen


def _replica_block(blk: bytes, h: bytes, dirs: list,
                   out: dict) -> tuple[int, bool]:
    good, seen = 0, False
    for d in dirs:
        base = os.path.join(ref.block_dir(d, h), h.hex())
        for sfx in ("", ".zst", ".zlib"):
            p = base + sfx
            if not os.path.exists(p):
                continue
            seen = True
            with open(p, "rb") as f:
                ok = sfx == "" and f.read() == blk
            good += ok
            out["shards_bad"] += not ok
    return good, seen
