"""Copy of garage_tpu/utils/error.py: import paths rewritten, issue and PR tags dropped.

Unified error types. Ref parity: src/util/error.rs."""

from __future__ import annotations


class GarageError(Exception):
    """Base error."""


class TimeoutError_(GarageError):
    pass


class QuorumError(GarageError):
    """Could not reach quorum. ref: util/error.rs Error::Quorum(q, sets, ok, total, errs)."""

    def __init__(self, quorum: int, sets: int | None, ok: int, total: int, errors: list):
        self.quorum, self.sets, self.ok, self.total, self.errors = quorum, sets, ok, total, errors
        where = f" in {sets} sets" if sets is not None else ""
        super().__init__(
            f"could not reach quorum {quorum}{where}: {ok}/{total} ok; "
            f"errors: {[str(e) for e in errors[:4]]}"
        )


class ZoneSpanError(QuorumError):
    """A write quorum set cannot span the required number of zones
    (zone-aware quorums). Subclasses QuorumError so callers
    that already treat quorum failures as retryable/unavailable degrade
    gracefully; the distinct type lets operators tell "placement can't
    satisfy zone_redundancy" apart from "nodes were down"."""

    def __init__(self, required: int, got: int, zones: list[str], total: int):
        self.required_zones, self.got_zones, self.zone_list = required, got, zones
        super(QuorumError, self).__init__(
            f"write set spans {got} zone(s) {zones} < required zone span "
            f"{required} across {total} node(s)"
        )
        # QuorumError field shape, for handlers that introspect it
        self.quorum, self.sets, self.ok, self.total, self.errors = (
            required, None, got, total, [])


class CorruptData(GarageError):
    def __init__(self, hash_: bytes):
        self.hash = hash_
        super().__init__(f"corrupt data for block {hash_.hex()[:16]}")


class MissingBlock(GarageError):
    def __init__(self, hash_: bytes):
        self.hash = hash_
        super().__init__(f"missing block {hash_.hex()[:16]}")


class RpcError(GarageError):
    """An error returned by a remote node."""


class NoSuchBucket(GarageError):
    pass


class NoSuchKey(GarageError):
    pass


class BadRequest(GarageError):
    pass
