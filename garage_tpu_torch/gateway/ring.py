"""Copy of garage_tpu/gateway/ring.py: import paths rewritten, issue and PR tags dropped.

Rendezvous-hash ownership of cacheable block hashes across gateway
workers.

Highest-random-weight beats a modulo ring here because membership
changes are common (worker crash/respawn) and must remap ONLY the dead
worker's share: every surviving worker keeps exactly the keys it
already owns, so a respawn invalidates nothing that is still hot.
Ownership is computed from the blake2b of (member id ‖ block hash) —
deterministic across processes, no coordination beyond agreeing on the
member list (the lease roster, which every worker refreshes each renew).
"""

from __future__ import annotations

import hashlib
from typing import Optional


def _weight(member: bytes, hash32: bytes) -> bytes:
    return hashlib.blake2b(member + hash32, digest_size=8).digest()


def rendezvous_owner(members, hash32: bytes) -> Optional[bytes]:
    """Highest-random-weight owner of `hash32` among `members` (any
    iterable of node ids), or None when empty. Shared by the worker
    ring below and the CLUSTER cache tier (block/cache_tier.py), so
    both layers agree on what 'owner' means and a future weighting
    change cannot drift between them."""
    best = None
    best_w = b""
    for m in members:
        w = _weight(m, hash32)
        if best is None or w > best_w:
            best, best_w = m, w
    return best


class CacheRing:
    def __init__(self, self_id: bytes):
        self.self_id = self_id
        self._members: list[bytes] = []

    def set_members(self, members: list[bytes]) -> None:
        # order-insensitive: every worker must compute the same owner
        # from the same roster regardless of arrival order
        self._members = sorted(set(members))

    @property
    def members(self) -> list[bytes]:
        return list(self._members)

    def owner(self, hash32: bytes) -> Optional[bytes]:
        """The owning member id, or None when routing is moot (fewer
        than two members, or we are not in the roster yet)."""
        if len(self._members) < 2 or self.self_id not in self._members:
            return None
        return max(self._members, key=lambda m: _weight(m, hash32))

    def owner_of(self, hash32: bytes) -> Optional[bytes]:
        """Remote owner to forward to, or None when this worker should
        serve (it owns the hash, or routing is moot)."""
        owner = self.owner(hash32)
        if owner is None or owner == self.self_id:
            return None
        return owner

    def owns(self, hash32: bytes) -> bool:
        """Whether this worker should hold the cached copy. True when
        routing is moot: an unsharded cache owns everything it sees."""
        owner = self.owner(hash32)
        return owner is None or owner == self.self_id
