"""Copy of garage_tpu/rpc/replication_mode.py: import paths rewritten, issue and PR tags dropped.

Replication modes and quorums — the plugin boundary for erasure coding.

Ref parity: src/rpc/replication_mode.rs:8-94 (ReplicationFactor,
ConsistencyMode, quorum arithmetic). The reference only replicates whole
blocks N ways; this framework adds `erasure(k, m)` as a first-class mode
at the same boundary (the north star, BASELINE.md): metadata still
replicates n ways with the same quorums, while block *data* is striped
k+m ways with RS coding on TPU.

Quorum arithmetic:
  replicate-n consistent:  R = ceil((n+1)/2), W = n+1-R  (R+W > n)
  degraded: R = 1 (reads may miss recent writes); dangerous: R = W = 1
  erasure(k, m): a block read needs any k of n=k+m shards; a write is
  durable against the same failures as replicate-(m+1) once k+m shards
  land, but is *decodable* after any k — write quorum k+q_extra, where
  q_extra = ceil((m+1)/2) keeps read-your-writes through m failures.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class ConsistencyMode(Enum):
    CONSISTENT = "consistent"
    DEGRADED = "degraded"
    DANGEROUS = "dangerous"

    @classmethod
    def parse(cls, s: str) -> "ConsistencyMode":
        return cls(s.lower())


@dataclass(frozen=True)
class ReplicationMode:
    """replication_factor for metadata; optional (k, m) erasure scheme
    for block data."""

    factor: int
    consistency: ConsistencyMode = ConsistencyMode.CONSISTENT
    erasure: tuple[int, int] | None = None  # (k, m) or None = replicate

    @classmethod
    def parse(cls, replication_factor: int, consistency_mode: str = "consistent",
              erasure: str | None = None) -> "ReplicationMode":
        """erasure: "k,m" string from config, e.g. "4,2" or "10,4"."""
        scheme = None
        if erasure:
            k, m = (int(x) for x in str(erasure).replace("+", ",").split(","))
            if k < 1 or m < 1:
                raise ValueError(f"invalid erasure scheme ({k},{m})")
            scheme = (k, m)
        if replication_factor < 1:
            raise ValueError(f"invalid replication factor {replication_factor}")
        return cls(replication_factor, ConsistencyMode.parse(consistency_mode), scheme)

    # ---- metadata quorums (ref: replication_mode.rs:45-59) -------------

    @property
    def read_quorum(self) -> int:
        if self.consistency == ConsistencyMode.CONSISTENT:
            return self.factor // 2 + 1
        return 1

    @property
    def write_quorum(self) -> int:
        # Always derived from the CONSISTENT read quorum so that degraded
        # mode (R=1) relaxes reads without inflating the write quorum
        # (ref: replication_mode.rs:52-58 uses read_quorum(Consistent)).
        if self.consistency == ConsistencyMode.DANGEROUS:
            return 1
        return self.factor + 1 - (self.factor // 2 + 1)

    # ---- block data path ----------------------------------------------

    @property
    def storage_width(self) -> int:
        """Distinct nodes each block (or its shards) lands on."""
        if self.erasure is not None:
            return self.erasure[0] + self.erasure[1]
        return self.factor

    @property
    def block_write_quorum(self) -> int:
        if self.erasure is None:
            return self.write_quorum
        k, m = self.erasure
        if self.consistency == ConsistencyMode.DANGEROUS:
            return k
        return min(k + (m + 1) // 2, k + m)

    @property
    def block_read_need(self) -> int:
        """Shards needed to reconstruct (1 whole copy if replicated)."""
        return self.erasure[0] if self.erasure is not None else 1
