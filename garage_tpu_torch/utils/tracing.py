"""Copy of garage_tpu/utils/tracing.py: import paths rewritten, issue and PR tags dropped.

Distributed tracing: contextvar trace ids, timed spans, JSONL export.

Ref parity: the reference wraps every RPC, table op, block IO and PUT
pipeline stage in OpenTelemetry spans and exports OTLP
(src/garage/tracing_setup.rs:13-37, src/rpc/rpc_helper.rs:172-190,
src/api/s3/put.rs:395,424,452). This build keeps the same span
topology with a dependency-free tracer:

- a contextvar carries (trace_id, span_id) across awaits, so every
  nested span knows its parent without explicit plumbing
- `span("name", **attrs)` works as a sync or async context manager;
  when tracing is disabled it costs one attribute read
- finished spans go to an in-memory ring (admin API /trace tail) and,
  when `GARAGE_TPU_TRACE=<path>` (or `enable(path)`) is set, to a
  JSON-lines file — one object per span with trace/span/parent ids,
  name, start (unix us), dur_us, and attrs
- the rpc layer propagates the trace id on the wire (conn.call header)
  so one S3 request's spans correlate across nodes
"""

from __future__ import annotations

import atexit
import contextvars
import json
import os
import secrets
import threading
import time
from collections import deque
from typing import Optional

_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "garage_tpu_trace", default=None)  # (trace_id: str, span_id: str)

RING_MAX = 2048


_FLUSH_EVERY = 128  # spans buffered before one batched write() syscall


class Tracer:
    def __init__(self):
        self.enabled = bool(os.environ.get("GARAGE_TPU_TRACE"))
        self._path = os.environ.get("GARAGE_TPU_TRACE") or None
        if self._path in ("1", "ring"):  # ring-only mode
            self._path = None
        self._file = None
        self._buf: list[str] = []
        self._lock = threading.Lock()
        self.ring: deque = deque(maxlen=RING_MAX)
        # extra span consumers (e.g. the OTLP exporter, utils/otlp.py);
        # each gets every finished span record and must not block
        self.sinks: list = []

    def enable(self, path: Optional[str] = None) -> None:
        self.enabled = True
        if path:
            self._close()
            self._path = path

    def disable(self) -> None:
        self.enabled = False
        self._close()

    def _close(self) -> None:
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf or self._path is None:
            return
        if self._file is None:
            try:
                self._file = open(self._path, "a")
            except OSError:
                self._path = None
                self._buf.clear()
                return
        try:
            self._file.write("".join(self._buf))
            self._file.flush()
        except OSError:
            pass
        self._buf.clear()

    def emit(self, rec: dict) -> None:
        self.ring.append(rec)
        for sink in self.sinks:
            sink(rec)
        if self._path is None:
            return
        # buffer; one write() per _FLUSH_EVERY spans keeps the export
        # off the hot path (a 4 MiB PUT emits ~200 spans)
        with self._lock:
            self._buf.append(json.dumps(rec, separators=(",", ":")) + "\n")
            if len(self._buf) >= _FLUSH_EVERY:
                self._flush_locked()


tracer = Tracer()
atexit.register(tracer.flush)


def current_trace_id() -> Optional[str]:
    """Wire form "trace_id:span_id" — the caller's span id rides along
    so remote-side spans parent-link into the caller's tree."""
    cur = _ctx.get()
    return f"{cur[0]}:{cur[1]}" if cur else None


def set_remote_context(wire: Optional[str]) -> None:
    """Adopt a trace context that arrived over the wire (handler side)."""
    if wire and ":" in wire:
        trace_id, span_id = wire.split(":", 1)
        _ctx.set((trace_id, span_id))
    elif wire:
        _ctx.set((wire, "remote"))


class span:
    """with span("table.insert", table=name): ...  (sync or async)."""

    __slots__ = ("name", "attrs", "t0", "ids", "token")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.token = None

    def _enter(self):
        if not tracer.enabled:
            return self
        parent = _ctx.get()
        if parent is None:
            trace_id = secrets.token_hex(8)
            parent_id = None
        else:
            trace_id, parent_id = parent
        span_id = secrets.token_hex(4)
        self.ids = (trace_id, span_id, parent_id)
        self.token = _ctx.set((trace_id, span_id))
        self.t0 = time.perf_counter()
        return self

    def _exit(self, exc_type):
        if self.token is None:
            return False
        dur_us = int((time.perf_counter() - self.t0) * 1e6)
        trace_id, span_id, parent_id = self.ids
        rec = {
            "trace": trace_id,
            "span": span_id,
            "parent": parent_id,
            "name": self.name,
            "start_us": int(time.time() * 1e6) - dur_us,
            "dur_us": dur_us,
        }
        if self.attrs:
            rec["attrs"] = {k: (v.hex()[:16] if isinstance(v, bytes) else v)
                            for k, v in self.attrs.items()}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        tracer.emit(rec)
        _ctx.reset(self.token)
        self.token = None
        return False

    def __enter__(self):
        return self._enter()

    def __exit__(self, exc_type, exc, tb):
        return self._exit(exc_type)

    async def __aenter__(self):
        return self._enter()

    async def __aexit__(self, exc_type, exc, tb):
        # lint: ignore[GL10] emit buffers; the open+write is one amortized page-cache append per _FLUSH_EVERY spans on an already-open file
        return self._exit(exc_type)
