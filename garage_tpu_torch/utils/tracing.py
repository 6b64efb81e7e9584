"""Distributed tracing: contextvar trace ids, timed spans, JSONL export,
and a meter of the event loop.

Ported from the JAX package's utils/tracing.py, which it extends; what
differs is below the list.

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

What differs from the JAX package:

- one clock: `enable()` (and the tracer's construction) takes an anchor,
  the wall clock and `perf_counter_ns` read together; every record takes
  its start on `perf_counter_ns` at entry and writes `start_us` as the
  anchor's wall time plus the perf-counter time since the anchor, and
  `dur_us` on the same clock
- the loop meter (`LoopMeter`): `enable()` called inside a running event
  loop starts it on that loop, `disable()` (or the loop's close) stops
  it; while tracing is off nothing of it exists. It splits the loop's
  time into idle (inside the selector's `select()`) and busy, charges
  each stretch of busy time to the layer of the innermost program frame
  on the loop thread (`sys.monitoring` events of the package's own code
  objects; every other code object is disabled after its first event),
  times a heartbeat's lag, and emits `loop.window` records (one a second)
  and `loop.stall` records (a busy stretch of 5 ms or more) through
  `Tracer.emit`, shaped as root spans so every sink takes them unchanged
"""

from __future__ import annotations

import asyncio
import atexit
import contextvars
import json
import os
import secrets
import sys
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
        self._anchor = (time.time_ns(), time.perf_counter_ns())
        self.meter: Optional[LoopMeter] = None

    def enable(self, path: Optional[str] = None) -> None:
        """Turn span recording on; inside a running event loop, start
        the loop meter on it."""
        self.enabled = True
        self._anchor = (time.time_ns(), time.perf_counter_ns())
        if path:
            self._close()
            self._path = path
        loop = asyncio._get_running_loop()
        if loop is not None:
            self.start_meter(loop)

    def disable(self) -> None:
        self.enabled = False
        self.stop_meter()
        self._close()

    def start_meter(self, loop=None, rules=None,
                    root: Optional[str] = None) -> Optional["LoopMeter"]:
        """Start the loop meter on `loop` (the running loop by default)
        unless it already runs there; -> the meter, or None where the
        loop cannot be metered (no selector, or no free monitoring
        tool id). `rules` and `root` replace the package's layer map
        (see LoopMeter)."""
        loop = loop or asyncio.get_running_loop()
        m = self.meter
        if m is not None and m.loop is loop and m.running and rules is None:
            return m
        self.stop_meter()
        m = LoopMeter(self, loop, rules=rules, root=root)
        if not m.start():
            return None
        self.meter = m
        return m

    def stop_meter(self) -> None:
        m, self.meter = self.meter, None
        if m is not None:
            m.stop()

    def wall_us(self, t_ns: int) -> int:
        """Wall-clock us of a `perf_counter_ns` reading, by the anchor."""
        wall, perf = self._anchor
        return (wall + t_ns - perf) // 1000

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


# ---- the loop meter -------------------------------------------------

# the layers of the loop's busy time, in the order of the records' keys
LAYERS = ("frontend", "tables", "blockmgr", "feeder", "runtime", "other")
RUNTIME = LAYERS.index("runtime")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_SELF = os.path.abspath(__file__)


def default_rules(pkg: str = _PKG) -> list[tuple[str, str]]:
    """(path prefix, layer) of the package's modules, first match wins;
    a module of `pkg` that none names is "other"."""
    j = os.path.join
    return [(j(pkg, "api") + os.sep, "frontend"),
            (j(pkg, "block", "feeder.py"), "feeder"),
            (j(pkg, "block", "device_backend.py"), "feeder"),
            (j(pkg, "ops") + os.sep, "feeder"),
            (j(pkg, "block") + os.sep, "blockmgr")] + [
        (j(pkg, d) + os.sep, "tables")
        for d in ("table", "rpc", "net", "db", "model")]


class LoopMeter:
    """Where one event loop's time goes, while tracing is on.

    - idle: time inside the selector's `select()` (an instance attribute
      wraps the loop's selector's method); busy: the rest of the wall
      time, but for the meter's own work (`meter_us`), which is neither
    - busy time by layer: `sys.monitoring` (PY_START/RESUME/THROW and
      PY_RETURN/YIELD/UNWIND) keeps a stack of the program code objects
      executing on the loop thread; the time between two events goes to
      the layer of the innermost one, to "runtime" when there is none
      (asyncio's machinery, streams, the stdlib). Code outside `root`,
      and this module's own, is disabled at its first event, so it costs
      nothing after and its time goes to the program frame that called
      it. Program code costs two events a run (about a microsecond each
      on a server core), so two kinds of it are disabled the same way
      once seen SAME_N times: code only ever entered from its own
      layer (its time stays in that layer), and code never entered
      from the runtime whose runs are short (CHEAP_NS: at most that
      much a run moves to its caller's layer). The layer is then the
      innermost *monitored* program frame's
    - lag: a heartbeat every 10 ms records how late it runs after it
      was due, or after the selector woke when it fell due inside a
      `select()` (the selector's timer rounding is not the loop's lag)
    - `loop.stall`: a busy stretch between two `select()` calls of
      `STALL_NS` or more, with its dominant layer and the innermost
      program function of its longest uninterrupted interval
    - `loop.window`: every `WINDOW_NS` of meter time, `busy_us`,
      `idle_us`, `meter_us`, `events`, `lag_us_sum`, `beats`,
      `lag_us_max` and `us.<layer>` for each of LAYERS (they sum to
      `busy_us`)

    `rules` is a list of (path prefix, layer) tried in order, `root` the
    prefix of every program file (default: the package's map); the
    meter runs on one loop's thread and stops itself when the loop
    closes."""

    WINDOW_NS = 1_000_000_000
    # a program function entered this many times from its own layer,
    # and never from another, is disabled like code outside the package;
    # so is one never entered from the runtime whose first SAME_N runs
    # took under CHEAP_NS on average: two events cost more than it runs
    SAME_N = 32
    CHEAP_NS = 5_000
    STALL_NS = 5_000_000
    BEAT_S = 0.01
    NAME = "garage_tpu_torch.loop_meter"

    def __init__(self, tracer: Tracer, loop, rules=None,
                 root: Optional[str] = None):
        self.tracer = tracer
        self.loop = loop
        self.root = root if root is not None else _PKG
        self.rules = rules if rules is not None else default_rules(self.root)
        self.running = False
        self._stop = None

    def layer_of(self, filename: str) -> int:
        """Index in LAYERS of a code object's file, -1 where it is not
        program code (or is this module)."""
        filename = os.path.abspath(filename)
        if filename == _SELF or not filename.startswith(self.root):
            return -1
        for prefix, layer in self.rules:
            if filename.startswith(prefix):
                return LAYERS.index(layer)
        return LAYERS.index("other")

    def func_name(self, code) -> str:
        rel = os.path.relpath(code.co_filename,
                              os.path.dirname(self.root.rstrip(os.sep)))
        mod = os.path.splitext(rel)[0].replace(os.sep, ".")
        return f"{mod}:{code.co_qualname}"

    def start(self) -> bool:
        mon = sys.monitoring
        sel = getattr(self.loop, "_selector", None)
        if sel is None or not callable(getattr(sel, "select", None)):
            return False
        tool = next((t for t in (mon.PROFILER_ID, 3, 4)
                     if mon.get_tool(t) is None), None)
        if tool is None:
            return False
        self._stop = self._install(mon, tool, sel)
        self.running = True
        return True

    def stop(self) -> None:
        if self.running:
            self.running = False
            self._stop()

    def _install(self, mon, tool: int, sel):
        # the hot callbacks share their state as closure cells: the
        # cheapest reads and writes Python has
        E = mon.events
        DISABLE = mon.DISABLE
        SAME_N, CHEAP_NS = self.SAME_N, self.CHEAP_NS
        clock = time.perf_counter_ns
        get_ident = threading.get_ident
        tid = get_ident()
        loop = self.loop
        tracer = self.tracer
        layers: dict[str, int] = {}   # file -> index in LAYERS, or -1
        codes: dict[int, list] = {}   # id(code) -> state(code)
        classify = self.layer_of
        stack: list = []              # program code objects, innermost last
        starts: list = []             # when each was entered (ns)
        acc = [0] * len(LAYERS)       # busy ns by layer, this window
        snap = acc[:]                 # acc at the stretch's start
        cur, cur_code = RUNTIME, None
        t0 = clock()
        t_last = sel_end = sel_start = win_t0 = t0
        idle = meter = events = 0
        lag_sum = beats = lag_max = 0
        max_dt, max_code = 0, None
        beat_due = t0
        beat_handle = None
        real_select = sel.select
        real_close = loop.close

        def state(code):
            """[layer, same-layer entries, timed runs, their ns, the
            longest, the code itself (so that its id stays its own)] of
            a program code object, None for any other code.
            The count of entries is -1 once one came from another layer,
            SAME_N once the code is disabled. A run is one stretch on
            the stack, from an entry to the matching exit; code entered
            from the runtime (a task's own coroutine, a callback) is not
            timed: disabled, its time would leave its layer."""
            f = code.co_filename
            lay = layers.get(f)
            if lay is None:
                lay = layers[f] = classify(f)
            if lay < 0:
                return None
            st = codes[id(code)] = [lay, 0, 0, 0, 0, code]
            return st

        def enter(code, _off):
            nonlocal cur, cur_code, t_last, max_dt, max_code, meter, events
            st = codes.get(id(code))
            if st is None:
                st = state(code)
                if st is None:
                    return DISABLE
            n = st[1]
            if n >= SAME_N:
                return DISABLE
            if get_ident() != tid:
                return None
            now = clock()
            dt = now - t_last
            acc[cur] += dt
            if dt > max_dt:
                max_dt, max_code = dt, cur_code
            if n >= 0:
                st[1] = n + 1 if st[0] == cur else -1
            if cur == RUNTIME:
                st[2] = SAME_N
            stack.append(code)
            starts.append(now)
            cur, cur_code = st[0], code
            events += 1
            t_last = clock()
            meter += t_last - now
            return None

        def leave(code, _off, _val):
            nonlocal cur, cur_code, t_last, max_dt, max_code, meter, events
            st = codes.get(id(code))
            if st is None:
                st = state(code)
                if st is None:
                    return DISABLE
            out = None
            if st[1] >= SAME_N:
                if not (stack and stack[-1] is code):
                    return DISABLE
                out = DISABLE
            if get_ident() != tid:
                return None
            now = clock()
            dt = now - t_last
            acc[cur] += dt
            if dt > max_dt:
                max_dt, max_code = dt, cur_code
            if stack and stack[-1] is code:
                stack.pop()
                t0 = starts.pop()
                if st[2] < SAME_N:
                    d = now - t0
                    st[2] += 1
                    st[3] += d
                    if d > st[4]:
                        st[4] = d
                    # its runs but the longest (a GIL wait, a collection)
                    # average under CHEAP_NS: metering it costs more
                    # than it runs
                    if st[2] == SAME_N and \
                            st[3] - st[4] < (SAME_N - 1) * CHEAP_NS:
                        st[1] = SAME_N
                        out = DISABLE
            else:
                # a frame that was running when the meter started, or
                # one whose resumption fired no event: drop what lies
                # above it, if it is on the stack at all
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i] is code:
                        del stack[i:]
                        del starts[i:]
                        break
            if stack:
                cur_code = stack[-1]
                cur = codes[id(cur_code)][0]
            else:
                cur, cur_code = RUNTIME, None
            events += 1
            t_last = clock()
            meter += t_last - now
            return out

        # PY_THROW and PY_UNWIND cannot be disabled: never return DISABLE
        def thrown(code, off, _exc):
            enter(code, off)

        def unwound(code, off, exc):
            leave(code, off, exc)

        def root_record(name: str, start: int, end: int, attrs: dict):
            return {"trace": secrets.token_hex(8),
                    "span": secrets.token_hex(4), "parent": None,
                    "name": name, "start_us": tracer.wall_us(start),
                    "dur_us": (end - start) // 1000, "attrs": attrs}

        def emit_window(now: int) -> None:
            nonlocal win_t0, idle, meter, events, lag_sum, beats, lag_max
            us = [a // 1000 for a in acc]
            attrs = {"busy_us": sum(us), "idle_us": idle // 1000,
                     "meter_us": meter // 1000, "events": events,
                     "lag_us_sum": lag_sum // 1000, "beats": beats,
                     "lag_us_max": lag_max // 1000}
            for name, v in zip(LAYERS, us):
                attrs["us." + name] = v
            tracer.emit(root_record("loop.window", win_t0, now, attrs))
            win_t0 = now
            for i in range(len(acc)):
                acc[i] = snap[i] = 0
            idle = meter = events = lag_sum = beats = lag_max = 0

        def emit_stall(now: int) -> None:
            d = [a - s for a, s in zip(acc, snap)]
            attrs = {"layer": LAYERS[d.index(max(d))],
                     "func": (self.func_name(max_code) if max_code
                              is not None else "runtime"),
                     "func_us": max_dt // 1000}
            for name, v in zip(LAYERS, d):
                if v >= 1000:
                    attrs["us." + name] = v // 1000
            tracer.emit(root_record("loop.stall", sel_end, now, attrs))

        def select(timeout=None):
            nonlocal cur, cur_code, t_last, max_dt, max_code, meter, idle
            nonlocal sel_start, sel_end
            now = clock()
            acc[cur] += now - t_last
            if now - t_last > max_dt:
                max_dt, max_code = now - t_last, cur_code
            t_last = now
            # nothing of the program runs under select(): what is left
            # on the stack was there before the meter started
            stack.clear()
            starts.clear()
            cur, cur_code = RUNTIME, None
            if now - sel_end >= self.STALL_NS:
                emit_stall(now)
            if now - win_t0 >= self.WINDOW_NS:
                emit_window(now)
            sel_start = clock()
            meter += sel_start - now
            try:
                return real_select(timeout)
            finally:
                t_last = sel_end = clock()
                idle += sel_end - sel_start
                snap[:] = acc
                max_dt, max_code = 0, None

        def beat():
            nonlocal t_last, max_dt, max_code, meter, beat_due, beat_handle
            nonlocal lag_sum, beats, lag_max
            now = clock()
            acc[cur] += now - t_last
            if now - t_last > max_dt:
                max_dt, max_code = now - t_last, cur_code
            # due inside the last select(): the lag starts when it woke
            start = (max(beat_due, sel_end) if beat_due >= sel_start
                     else beat_due)
            late = max(0, now - start)
            lag_sum += late
            beats += 1
            lag_max = max(lag_max, late)
            beat_due = now + int(self.BEAT_S * 1e9)
            beat_handle = loop.call_later(self.BEAT_S, beat)
            t_last = clock()
            meter += t_last - now

        def close():
            self.stop()
            if tracer.meter is self:
                tracer.meter = None
            real_close()

        def stop() -> None:
            mon.set_events(tool, 0)
            for ev in ALL:
                mon.register_callback(tool, ev, None)
            mon.free_tool_id(tool)
            sel.__dict__.pop("select", None)
            loop.__dict__.pop("close", None)
            h = beat_handle
            if h is not None:
                if get_ident() == tid or loop.is_closed():
                    h.cancel()
                else:
                    loop.call_soon_threadsafe(h.cancel)
            end = clock()
            if end > win_t0:
                acc[cur] += end - t_last
                emit_window(end)

        ALL = (E.PY_START, E.PY_RESUME, E.PY_THROW, E.PY_RETURN,
               E.PY_YIELD, E.PY_UNWIND)
        mon.use_tool_id(tool, self.NAME)
        for ev, fn in zip(ALL, (enter, enter, thrown, leave, leave,
                                unwound)):
            mon.register_callback(tool, ev, fn)
        # code objects another run of a meter disabled may be program
        # code under this meter's map
        mon.restart_events()
        mon.set_events(tool, sum(ALL))
        sel.select = select
        loop.close = close
        beat_due = clock() + int(self.BEAT_S * 1e9)
        beat_handle = loop.call_later(self.BEAT_S, beat)
        return stop


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
        self.t0 = time.perf_counter_ns()
        return self

    def _exit(self, exc_type):
        if self.token is None:
            return False
        t0 = self.t0
        dur_us = (time.perf_counter_ns() - t0) // 1000
        trace_id, span_id, parent_id = self.ids
        rec = {
            "trace": trace_id,
            "span": span_id,
            "parent": parent_id,
            "name": self.name,
            "start_us": tracer.wall_us(t0),
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
