"""Copy of garage_tpu/net/message.py: import paths rewritten, issue and PR tags dropped.

Request priorities, order tags, and payload encoding.

Ref parity: src/net/message.rs:15-88 (RequestPriority bits, OrderTag) and
the msgpack payload convention used throughout the reference. Payloads
here are plain msgpack-encodable Python values (dicts/lists/bytes/ints);
typed schemas live at the endpoint layer.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import msgpack

# Priority byte: lower value = more urgent. Bit 0 picks primary/secondary
# send queue within a level (ref: src/net/message.rs:49-58).
PRIO_HIGH = 0x20  # pings, membership gossip — must beat bulk data
PRIO_NORMAL = 0x40  # interactive metadata RPC
PRIO_BACKGROUND = 0x80  # resync/sync bulk transfers
PRIO_PRIMARY = 0x00
PRIO_SECONDARY = 0x01


@dataclass(frozen=True)
class OrderTag:
    """Orders sub-streams within one logical transfer: messages with the
    same `stream` id are delivered in `seq` order even though they travel
    as independent requests (ref: src/net/message.rs:62-88). Used by the
    GET path to stream blocks of one object in order."""

    stream: int
    seq: int

    _counter = itertools.count(1)

    @classmethod
    def stream_id(cls) -> int:
        return next(cls._counter)


def pack(value) -> bytes:
    return msgpack.packb(value, use_bin_type=True)


def unpack(data: bytes):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)
