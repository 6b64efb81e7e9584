"""Copy of garage_tpu/utils/migrate.py: import paths rewritten, issue and PR tags dropped.

Versioned on-disk encoding with forward migration.

Ref parity: src/util/migrate.rs:5-157. Values are encoded as msgpack with a
leading version marker. Decoding tries the current version first, then walks
back through `PREVIOUS` classes, decoding with the old schema and applying
`migrate()` forward — so any historical on-disk state loads after upgrades.

A Migratable class defines:
    VERSION_MARKER: bytes     # e.g. b"G010obj"
    PREVIOUS: type | None     # older Migratable class, or None
    def pack(self) -> object                  # msgpack-able plain structure
    @classmethod def unpack(cls, raw) -> cls
    def migrate(self) -> "next version instance"   # only on non-latest
"""

from __future__ import annotations

from typing import Optional, Type, TypeVar

import msgpack

M = TypeVar("M", bound="Migratable")


class Migratable:
    VERSION_MARKER: bytes = b""
    PREVIOUS: Optional[Type["Migratable"]] = None

    def pack(self):
        raise NotImplementedError

    @classmethod
    def unpack(cls, raw):
        raise NotImplementedError

    def migrate(self) -> "Migratable":
        raise NotImplementedError("not an old version")


def encode(value: Migratable) -> bytes:
    assert value.VERSION_MARKER, "VERSION_MARKER required"
    return value.VERSION_MARKER + msgpack.packb(value.pack(), use_bin_type=True)


def decode(cls: Type[M], data: bytes) -> M:
    """Decode `data` as `cls`, falling back through the PREVIOUS chain and
    migrating forward. ref: src/util/migrate.rs:19-55."""
    chain = []
    c: Optional[Type[Migratable]] = cls
    while c is not None:
        chain.append(c)
        c = c.PREVIOUS
    for depth, c in enumerate(chain):
        marker = c.VERSION_MARKER
        if data.startswith(marker):
            raw = msgpack.unpackb(data[len(marker):], raw=False)
            val = c.unpack(raw)
            for _ in range(depth):
                val = val.migrate()
            return val  # type: ignore[return-value]
    raise ValueError(
        f"cannot decode {cls.__name__}: no version marker matches "
        f"(head={data[:16]!r})"
    )
