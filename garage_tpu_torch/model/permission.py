"""Copy of garage_tpu/model/permission.py: import paths rewritten, issue and PR tags dropped.

Bucket-key permission CRDT.

Ref parity: src/model/permission.rs. A timestamped permission triple;
newer timestamp wins, equal timestamps merge to the most restricted set
(so a concurrent grant+revoke resolves to revoke).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.crdt import Crdt


@dataclass(frozen=True)
class BucketKeyPerm(Crdt):
    ts: int = 0
    allow_read: bool = False
    allow_write: bool = False
    allow_owner: bool = False

    @staticmethod
    def no_permissions() -> "BucketKeyPerm":
        return BucketKeyPerm(0, False, False, False)

    @staticmethod
    def all_permissions(ts: int = 0) -> "BucketKeyPerm":
        return BucketKeyPerm(ts, True, True, True)

    @property
    def is_any(self) -> bool:
        return self.allow_read or self.allow_write or self.allow_owner

    def merge(self, other: "BucketKeyPerm") -> "BucketKeyPerm":
        if other.ts > self.ts:
            return other
        if other.ts == self.ts and other != self:
            # most-restricted wins on timestamp tie (ref: permission.rs)
            return BucketKeyPerm(
                self.ts,
                self.allow_read and other.allow_read,
                self.allow_write and other.allow_write,
                self.allow_owner and other.allow_owner,
            )
        return self

    def pack(self) -> list:
        return [self.ts, self.allow_read, self.allow_write, self.allow_owner]

    @classmethod
    def unpack(cls, o) -> "BucketKeyPerm":
        return cls(o[0], bool(o[1]), bool(o[2]), bool(o[3]))
