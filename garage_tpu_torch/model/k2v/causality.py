"""Copy of garage_tpu/model/k2v/causality.py: import paths rewritten, issue and PR tags dropped.

K2V causality: vector clocks and causality tokens.

Ref parity: src/model/k2v/causality.rs:21-120. A CausalContext is a
vector clock over abbreviated 64-bit node ids; its base64url (no pad)
encoding — checksum u64 followed by (node, time) u64 pairs, all
big-endian — is the "causality token" clients echo back on writes to
declare which versions they have seen.
"""

from __future__ import annotations

import base64
from typing import Optional

# node ids in K2V are the first 8 bytes of the 32-byte node uuid
# (ref: causality.rs make_node_id)


def make_node_id(node_uuid: bytes) -> int:
    return int.from_bytes(node_uuid[:8], "big")


VectorClock = dict  # int node id -> int time


def vclock_gt(a: VectorClock, b: VectorClock) -> bool:
    return any(ts > b.get(n, 0) for n, ts in a.items())


def vclock_max(a: VectorClock, b: VectorClock) -> VectorClock:
    out = dict(a)
    for n, ts in b.items():
        out[n] = max(out.get(n, 0), ts)
    return out


class CausalContext:
    __slots__ = ("vector_clock",)

    def __init__(self, vector_clock: Optional[VectorClock] = None):
        self.vector_clock: VectorClock = vector_clock or {}

    def serialize(self) -> str:
        ints = []
        for node, t in sorted(self.vector_clock.items()):
            ints.append(node)
            ints.append(t)
        checksum = 0
        for v in ints:
            checksum ^= v
        raw = checksum.to_bytes(8, "big") + b"".join(
            v.to_bytes(8, "big") for v in ints)
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    @classmethod
    def parse(cls, s: str) -> Optional["CausalContext"]:
        try:
            raw = base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))
        except Exception:
            # lint: ignore[GL05] malformed client token -> None is the parse contract (400 upstream)
            return None
        if len(raw) < 8 or len(raw) % 16 != 8:
            return None
        checksum = int.from_bytes(raw[:8], "big")
        vc: VectorClock = {}
        for i in range((len(raw) - 8) // 16):
            node = int.from_bytes(raw[8 + 16 * i:16 + 16 * i], "big")
            t = int.from_bytes(raw[16 + 16 * i:24 + 16 * i], "big")
            vc[node] = t
        check = 0
        for n, t in vc.items():
            check ^= n ^ t
        if check != checksum:
            return None
        return cls(vc)

    def is_newer_than(self, other: "CausalContext") -> bool:
        return vclock_gt(self.vector_clock, other.vector_clock)

    def __eq__(self, other):
        return (isinstance(other, CausalContext)
                and self.vector_clock == other.vector_clock)

    def __repr__(self):
        return f"CausalContext({self.vector_clock})"
