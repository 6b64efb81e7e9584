"""Copy of garage_tpu/net/stream.py: import paths rewritten, issue and PR tags dropped.

ByteStream: an async byte pipe with backpressure and error propagation.

Ref parity: src/net/stream.rs:29-213 (ByteStreamReader and friends).
Attached to requests/responses to stream block bodies without buffering
whole blocks in RAM.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Optional

from ..utils.background import spawn

_HIGH_WATER = 1 << 20  # pause producer above 1 MiB buffered


class StreamClosed(Exception):
    pass


class ByteStream:
    """Single-producer single-consumer byte pipe.

    Producer: push(bytes) / push_eof() / push_error(exc)  (sync, unbounded
    from remote; local producers use write() which honors backpressure).
    Consumer: read_chunk(n) -> b"" at EOF; async-iterable in chunks.
    """

    def __init__(self):
        self._chunks: list[bytes] = []
        self._size = 0
        self._eof = False
        self._error: Optional[Exception] = None
        self._data_ready = asyncio.Event()
        self._drained = asyncio.Event()
        self._drained.set()
        # consumer-progress callback (bytes drained); the transport wires
        # this to CREDIT grants for wire-level flow control
        self.on_consume: Optional[callable] = None

    # ---- producer ------------------------------------------------------

    def push(self, data: bytes) -> None:
        if self._eof or self._error:
            return
        if data:
            self._chunks.append(bytes(data))
            self._size += len(data)
            self._data_ready.set()
            if self._size >= _HIGH_WATER:
                self._drained.clear()

    def push_eof(self) -> None:
        self._eof = True
        self._data_ready.set()

    def push_error(self, exc: Exception) -> None:
        self._error = exc
        self._eof = True
        self._data_ready.set()

    async def write(self, data: bytes) -> None:
        """Backpressured push for local producers."""
        await self._drained.wait()
        if self._error:
            raise self._error
        if self._eof:
            raise StreamClosed("write after eof")
        # lint: ignore[GL12] single-producer contract; push() re-derives drained-ness from the LIVE buffer level, not from the pre-await read
        self.push(data)

    def close(self) -> None:
        self.push_eof()

    # ---- consumer ------------------------------------------------------

    async def read_chunk(self, max_len: int) -> bytes:
        while not self._chunks:
            if self._error:
                raise self._error
            if self._eof:
                return b""
            self._data_ready.clear()
            await self._data_ready.wait()
        head = self._chunks[0]
        if len(head) <= max_len:
            self._chunks.pop(0)
            out = head
        else:
            out = head[:max_len]
            self._chunks[0] = head[max_len:]
        self._size -= len(out)
        if self._size < _HIGH_WATER:
            self._drained.set()
        if self.on_consume is not None:
            self.on_consume(len(out))
        return out

    async def read_exact(self, n: int) -> bytes:
        parts: list[bytes] = []
        got = 0
        while got < n:
            chunk = await self.read_chunk(n - got)
            if not chunk:
                raise EOFError(f"stream ended at {got}/{n} bytes")
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    async def read_all(self, limit: Optional[int] = None) -> bytes:
        parts: list[bytes] = []
        total = 0
        while True:
            chunk = await self.read_chunk(1 << 16)
            if not chunk:
                return b"".join(parts)
            total += len(chunk)
            if limit is not None and total > limit:
                raise ValueError(f"stream exceeds limit {limit}")
            parts.append(chunk)

    def discard(self) -> None:
        """Drop buffered data and swallow the rest."""
        self._chunks.clear()
        self._size = 0
        self._drained.set()
        if not self._eof:
            spawn(self._drain_rest(), "stream-discard-drain")

    async def _drain_rest(self) -> None:
        try:
            while await self.read_chunk(1 << 16):
                pass
        except Exception:
            pass  # lint: ignore[GL05] draining an abandoned stream; errors have no consumer

    def __aiter__(self) -> AsyncIterator[bytes]:
        return self._iter()

    async def _iter(self):
        while True:
            chunk = await self.read_chunk(1 << 16)
            if not chunk:
                return
            yield chunk

    @classmethod
    def from_bytes(cls, data: bytes) -> "ByteStream":
        s = cls()
        s.push(data)
        s.push_eof()
        return s

    @classmethod
    def from_iter(cls, it) -> "ByteStream":
        """Wrap an async iterator of bytes; pumped lazily by a task."""
        s = cls()

        async def pump():
            try:
                async for chunk in it:
                    await s.write(chunk)
                s.push_eof()
            except Exception as e:
                s.push_error(e)

        spawn(pump(), "stream-iter-pump")
        return s
