"""Copy of garage_tpu/block/layout.py: import paths rewritten, issue and PR tags dropped.

Multi-drive data layout: where a block lives on this node's disks.

Ref parity: src/block/layout.rs. 1024 sub-partitions (top 10 bits of the
block hash) map to data directories proportionally to their capacity;
each sub-partition has a primary and (during rebalances) secondary dirs.
On-disk path: {dir}/{hex(hash[0])}/{hex(hash[1])}/{full hex}[suffix]
(ref: layout.rs:262-291, HASH_DRIVE_BYTES).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..utils import migrate

DRIVE_NPART = 1024  # ref: layout.rs:13


@dataclass
class DataDir:
    path: str
    capacity: int  # bytes; 0 = read-only (drain)


class DataLayout(migrate.Migratable):
    """ref: layout.rs DataLayout."""

    VERSION_MARKER = b"GTdlay01"

    def __init__(self, dirs: list[DataDir], part_prim: list[int],
                 part_sec: list[list[int]]):
        self.dirs = dirs
        self.part_prim = part_prim  # sub-partition -> dir index
        self.part_sec = part_sec  # sub-partition -> old dir indices

    @classmethod
    def initialize(cls, dirs: list[DataDir]) -> "DataLayout":
        lay = cls(dirs, [], [[] for _ in range(DRIVE_NPART)])
        lay.part_prim = cls._assign(dirs)
        return lay

    @classmethod
    def single(cls, path: str) -> "DataLayout":
        return cls.initialize([DataDir(path, 1)])

    @staticmethod
    def _assign(dirs: list[DataDir]) -> list[int]:
        """Capacity-proportional striped assignment (deterministic)."""
        writable = [(i, d.capacity) for i, d in enumerate(dirs) if d.capacity > 0]
        if not writable:
            raise ValueError("no writable data dir")
        total = sum(c for _, c in writable)
        out, acc = [], [0.0] * len(writable)
        for _ in range(DRIVE_NPART):
            for j, (_, c) in enumerate(writable):
                acc[j] += c / total
            j = max(range(len(writable)), key=lambda j: acc[j])
            acc[j] -= 1.0
            out.append(writable[j][0])
        return out

    def update_dirs(self, dirs: list[DataDir]) -> "DataLayout":
        """New drive set: recompute primaries, remember old location as
        secondary so reads keep working until rebalance moves the files
        (ref: layout.rs update)."""
        new_prim = self._assign(dirs)
        old_paths = [d.path for d in self.dirs]
        path_to_new = {d.path: i for i, d in enumerate(dirs)}
        sec = []
        for p in range(DRIVE_NPART):
            s = set()
            old_i = self.part_prim[p] if p < len(self.part_prim) else None
            if old_i is not None and old_i < len(old_paths):
                ni = path_to_new.get(old_paths[old_i])
                if ni is not None and ni != new_prim[p]:
                    s.add(ni)
            for oi in (self.part_sec[p] if p < len(self.part_sec) else []):
                if oi < len(old_paths):
                    ni = path_to_new.get(old_paths[oi])
                    if ni is not None and ni != new_prim[p]:
                        s.add(ni)
            sec.append(sorted(s))
        return DataLayout(dirs, new_prim, sec)

    # ---- path resolution ----------------------------------------------

    @staticmethod
    def subpart_of(hash32: bytes) -> int:
        return (hash32[0] << 2) | (hash32[1] >> 6)  # top 10 bits

    def _dir_path(self, dir_idx: int, hash32: bytes) -> str:
        return os.path.join(
            self.dirs[dir_idx].path, hash32[:1].hex(), hash32[1:2].hex()
        )

    def primary_dir(self, hash32: bytes) -> str:
        return self._dir_path(self.part_prim[self.subpart_of(hash32)], hash32)

    def candidate_dirs(self, hash32: bytes) -> list[str]:
        p = self.subpart_of(hash32)
        out = [self._dir_path(self.part_prim[p], hash32)]
        for i in self.part_sec[p]:
            out.append(self._dir_path(i, hash32))
        return out

    def block_path(self, hash32: bytes, suffix: str = "") -> str:
        return os.path.join(self.primary_dir(hash32), hash32.hex() + suffix)

    # ---- serialization -------------------------------------------------

    def pack(self):
        return {
            "dirs": [[d.path, d.capacity] for d in self.dirs],
            "prim": self.part_prim,
            "sec": self.part_sec,
        }

    @classmethod
    def unpack(cls, o):
        return cls([DataDir(p, c) for p, c in o["dirs"]], o["prim"], o["sec"])
