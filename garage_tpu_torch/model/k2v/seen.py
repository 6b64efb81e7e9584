"""Copy of garage_tpu/model/k2v/seen.py: import paths rewritten, issue and PR tags dropped.

RangeSeenMarker: resumable cursor for K2V PollRange.

Ref parity: src/model/k2v/seen.rs. The marker records, per sort key,
the vector clock the client has already seen; a poll returns items
whose causal context carries something newer. Encoding is
base64url(msgpack) with a checksum-free structure (the marker is
client-opaque but server-validated by shape).
"""

from __future__ import annotations

import base64
from typing import Optional

import msgpack

from .causality import CausalContext, vclock_gt, vclock_max


class RangeSeenMarker:
    __slots__ = ("seen",)

    def __init__(self, seen: Optional[dict] = None):
        # sort_key (str) -> vector clock (dict int->int)
        self.seen: dict[str, dict] = seen or {}

    def update(self, sort_key: str, cc: CausalContext) -> None:
        # merge, never overwrite: answers from divergent replicas must
        # only advance the marker or redeliveries ping-pong until the
        # replicas converge
        self.seen[sort_key] = vclock_max(
            self.seen.get(sort_key, {}), cc.vector_clock)

    def is_new(self, sort_key: str, cc: CausalContext) -> bool:
        prev = self.seen.get(sort_key)
        if prev is None:
            return True
        return vclock_gt(cc.vector_clock, prev)

    def serialize(self) -> str:
        raw = msgpack.packb(
            [[sk, sorted(vc.items())] for sk, vc in sorted(self.seen.items())],
            use_bin_type=True)
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    @classmethod
    def parse(cls, s: str) -> Optional["RangeSeenMarker"]:
        if not s:
            return cls()
        try:
            raw = base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))
            items = msgpack.unpackb(raw, raw=False)
            return cls({sk: {int(n): int(t) for n, t in vc}
                        for sk, vc in items})
        except Exception:
            # lint: ignore[GL05] malformed client token -> None is the parse contract (400 upstream)
            return None
