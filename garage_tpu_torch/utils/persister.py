"""Copy of garage_tpu/utils/persister.py: import paths rewritten, issue and PR tags dropped.

Atomic save/load of a Migratable value to a file (tmp+rename).

Ref parity: src/util/persister.rs:10-120 (Persister, PersisterShared).
"""

from __future__ import annotations

import os
import threading
from typing import Generic, Optional, Type, TypeVar

from . import migrate

M = TypeVar("M", bound=migrate.Migratable)


class Persister(Generic[M]):
    def __init__(self, directory: str, name: str, cls: Type[M]):
        self.path = os.path.join(directory, name)
        self.cls = cls

    def load(self) -> Optional[M]:
        try:
            with open(self.path, "rb") as f:
                return migrate.decode(self.cls, f.read())
        except FileNotFoundError:
            return None

    def save(self, value: M) -> None:
        tmp = self.path + ".tmp"
        data = migrate.encode(value)
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


class PersisterShared(Generic[M]):
    """Persister + in-memory cached value behind a lock.
    ref: src/util/persister.rs:89."""

    def __init__(self, directory: str, name: str, cls: Type[M], default: M):
        self._p = Persister(directory, name, cls)
        self._lock = threading.Lock()
        loaded = self._p.load()
        self._value = loaded if loaded is not None else default
        if loaded is None:
            self._p.save(self._value)

    def get(self) -> M:
        with self._lock:
            return self._value

    def set(self, value: M) -> None:
        with self._lock:
            self._value = value
            self._p.save(value)

    def update(self, fn) -> M:
        with self._lock:
            self._value = fn(self._value)
            self._p.save(self._value)
            return self._value
