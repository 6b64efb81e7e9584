"""Copy of garage_tpu/utils/sanitizer.py: import paths rewritten, issue and PR tags dropped.

Runtime asyncio sanitizer: the dynamic half of the
GL10/GL12 static story, in the spirit of ThreadSanitizer's
static/dynamic pairing — every static claim about the event loop is
checked against the LIVE loop when `GARAGE_SANITIZE=1`.

Three checks, all report-don't-crash (a monitor must never alter the
behavior it observes; tests assert on the drained reports instead):

  * **loop-stall detector** — a heartbeat callback re-arms itself on
    every registered event loop; an own monitor THREAD samples the
    beats and, when one goes silent past the threshold, captures the
    loop thread's live stack via `sys._current_frames()` and reports
    the frames actually pinning the loop. Sharper than asyncio debug
    mode's slow-callback log: that one reports AFTER the callback
    returns, this one names the frame WHILE it blocks (a hang is
    reported before it resolves, not after).
  * **leak checks at loop teardown** — hooked into
    `asyncio.runners._cancel_all_tasks` (the `asyncio.run` exit path):
    before the runner cancels stragglers, any pending task that is not
    a deliberate background task (`utils.background.spawn` /
    `BackgroundRunner` mark theirs) is reported as leaked; after the
    cancellation settles, any asyncio.Lock still held by a task of
    this loop is reported (a lock that survives its holder serializes
    the next run forever).
  * **budget conservation** — objects exposing `conservation_ok`
    (BudgetLeaseBroker; qos TokenBucket via its clamp invariant)
    register themselves when armed and are re-checked at every loop
    teardown: a leaked lease/token is invisible until the budget runs
    dry, so the soak asserts Σ granted ≤ budget after every test.

Wired into tests/conftest.py: an autouse fixture drains reports after
each test and fails THAT test, so tier-1 and the nightly soak run
sanitized (CI exports GARAGE_SANITIZE=1). The stall threshold is
`GARAGE_SANITIZE_STALL_S` (default 1.0 s — calibrated on the 2-core CI
box where tier-1 runs clean; the seeded self-test uses 0.25 s).
"""

from __future__ import annotations

import asyncio
import os
import sys
import threading
import time
import traceback
import weakref
from typing import Optional

ENV_FLAG = "GARAGE_SANITIZE"
ENV_THRESHOLD = "GARAGE_SANITIZE_STALL_S"
DEFAULT_STALL_S = 1.0
# sample-cadence floor (satellite): the stall sampler used to
# run at threshold/5 only, so at the 1 s default the monitor woke every
# 200 ms and a sub-200 ms-threshold configuration could sandwich a
# whole stall between two samples. The period is now capped at 20 ms —
# we sample at LEAST every 20 ms — and the heartbeat itself reports a
# stall RETROACTIVELY when it fires late (see _beat), so a stall past
# the threshold is caught even when it resolves between monitor samples.
STALL_SAMPLE_FLOOR_S = 0.02

# attribute marking a task as deliberately detached/supervised
BACKGROUND_ATTR = "_garage_background"

_lock = threading.Lock()
_reports: list[dict] = []
_installed = False
# patches are irreversible, but REPORTING can be switched off: the
# self-tests install in unarmed pytest sessions and deactivate on the
# way out so later tests don't accumulate reports nobody drains
_active = False
_stall_threshold = DEFAULT_STALL_S

# live loops: id(loop) -> [thread_id, last_beat, reported, beat_token]
_loops: dict[int, list] = {}
_beat_seq = 0
_monitor: Optional[threading.Thread] = None
# held asyncio.Locks: id(lock) -> (loop_id, task_name, since)
_held_locks: dict[int, tuple] = {}
# objects with a `conservation_ok` property (weakrefs)
_conserved: list = []


def armed() -> bool:
    return os.environ.get(ENV_FLAG, "") == "1"


def stall_threshold() -> float:
    return _stall_threshold


def configure(stall_threshold_s: Optional[float] = None) -> None:
    global _stall_threshold
    if stall_threshold_s is not None:
        _stall_threshold = float(stall_threshold_s)


# ---- reporting ----------------------------------------------------------

def set_active(flag: bool) -> None:
    global _active
    _active = bool(flag)


def report(kind: str, detail: str) -> None:
    if not _active:
        return
    entry = {"kind": kind, "detail": detail, "time": time.time()}
    with _lock:
        _reports.append(entry)
    # stderr line so forked processes and the soak's log artifacts
    # carry the report even when no in-process assert sees it
    print(f"[GARAGE_SANITIZE] {kind}: {detail}", file=sys.stderr)


def reports() -> list[dict]:
    with _lock:
        return list(_reports)


def drain_reports() -> list[dict]:
    with _lock:
        out = list(_reports)
        _reports.clear()
    return out


# ---- conservation tracking ----------------------------------------------

def track_conservation(obj) -> None:
    """Register an object exposing `conservation_ok`; checked at every
    loop teardown while the object is alive. No-op when disarmed.
    Dead refs are pruned here too — long-lived armed processes churn
    per-key TokenBuckets, and teardown (the other pruning site) may
    not run until process exit."""
    if not armed():
        return
    with _lock:
        _conserved[:] = [r for r in _conserved if r() is not None]
        _conserved.append(weakref.ref(obj))


def _check_conservation() -> None:
    with _lock:
        refs = list(_conserved)
    live = []
    for r in refs:
        obj = r()
        if obj is None:
            continue
        live.append(r)
        try:
            ok = obj.conservation_ok
        except Exception:  # lint: ignore[GL05] a broken invariant property must not crash the monitor; the object is simply skipped
            continue
        if not ok:
            report("budget_conservation",
                   f"{type(obj).__name__} violates its conservation "
                   f"invariant at loop teardown: {obj!r}")
    with _lock:
        _conserved[:] = live


# ---- stall detector ------------------------------------------------------

def _sample_period() -> float:
    """Sampling/heartbeat period: threshold/5, floored at 10 ms and
    capped at STALL_SAMPLE_FLOOR_S (a minimum cadence — sub-200 ms
    thresholds stay observable)."""
    return max(0.01, min(_stall_threshold / 5.0, STALL_SAMPLE_FLOOR_S))


def _beat(loop, token: int) -> None:
    ent = _loops.get(id(loop))
    if ent is None or ent[3] != token or loop.is_closed():
        # stale chain: this loop re-entered run_forever (new token) or
        # stopped — without the token check every run_until_complete
        # on a persistent loop would add one more self-re-arming chain
        return
    now = time.monotonic()
    dt = now - ent[1]
    if dt > _stall_threshold and not ent[2]:
        # the beat itself arrived late past the threshold: the stall
        # already RESOLVED (we are running again), so the live stack is
        # gone, but the episode must still be reported — the monitor
        # thread can sandwich a short stall between two samples, this
        # check cannot
        report("loop_stall",
               f"event loop was silent for {dt:.2f}s (threshold "
               f"{_stall_threshold:.2f}s); stall resolved before a "
               "live stack could be captured")
    ent[1] = now
    ent[2] = False  # beat recovered: re-arm one report per episode
    try:
        loop.call_later(_sample_period(), _beat, loop, token)
    except RuntimeError:
        pass  # loop closing under us


def _loop_stack(thread_id: int) -> str:
    frame = sys._current_frames().get(thread_id)
    if frame is None:
        return "<no frame>"
    return "".join(traceback.format_stack(frame, limit=12))


def _monitor_main() -> None:
    while True:
        time.sleep(_sample_period())
        now = time.monotonic()
        for ent in list(_loops.values()):
            tid, last, reported = ent[0], ent[1], ent[2]
            dt = now - last
            if dt > _stall_threshold and not reported:
                ent[2] = True
                report(
                    "loop_stall",
                    f"event loop silent for {dt:.2f}s "
                    f"(threshold {_stall_threshold:.2f}s); loop-thread "
                    f"stack:\n{_loop_stack(tid)}")


def _ensure_monitor() -> None:
    global _monitor
    if _monitor is None or not _monitor.is_alive():
        _monitor = threading.Thread(target=_monitor_main,
                                    name="garage-sanitizer",
                                    daemon=True)
        _monitor.start()


# ---- teardown checks -----------------------------------------------------

def _pending_leaks(loop) -> list[str]:
    out = []
    try:
        tasks = asyncio.all_tasks(loop)
    except RuntimeError:
        return out
    for t in tasks:
        if t.done() or getattr(t, BACKGROUND_ATTR, False):
            continue
        coro = t.get_coro()
        where = ""
        frame = getattr(coro, "cr_frame", None)
        if frame is not None:
            where = (f" at {frame.f_code.co_filename}:"
                     f"{frame.f_lineno}")
        out.append(f"{t.get_name()} ({coro!r}{where})")
    return out


def _held_locks_of(loop) -> list[str]:
    """Report AND purge this loop's held-lock entries: the loop is
    closing, so a leaked lock can never be released — leaving the
    entry would re-attribute it to a future loop allocated at the
    same address (id() reuse) and fail an innocent test."""
    with _lock:
        mine = {k: v for k, v in _held_locks.items()
                if v[0] == id(loop)}
        for k in mine:
            del _held_locks[k]
    return [f"Lock held by task {name!r} for {time.monotonic() - t0:.1f}s"
            for _lid, name, t0 in mine.values()]


def _check_teardown(loop) -> None:
    for leak in _pending_leaks(loop):
        report("task_leak",
               f"pending non-background task at loop teardown: {leak}")


def _check_post_cancel(loop) -> None:
    for h in _held_locks_of(loop):
        report("lock_leak", f"asyncio.Lock still held at loop close: {h}")
    _check_conservation()


# ---- installation --------------------------------------------------------

def install(stall_threshold_s: Optional[float] = None) -> None:
    """Idempotent. Patches the asyncio seams the sanitizer observes;
    safe to call at import time from conftest when armed."""
    global _installed
    configure(stall_threshold_s if stall_threshold_s is not None
              else float(os.environ.get(ENV_THRESHOLD, DEFAULT_STALL_S)))
    set_active(True)
    if _installed:
        return
    _installed = True

    # (1) heartbeat on every loop that runs
    base = asyncio.base_events.BaseEventLoop
    orig_run_forever = base.run_forever

    def run_forever(self):
        global _beat_seq
        _beat_seq += 1
        token = _beat_seq
        _loops[id(self)] = [threading.get_ident(), time.monotonic(),
                            False, token]
        _ensure_monitor()
        self.call_soon(_beat, self, token)
        try:
            return orig_run_forever(self)
        finally:
            _loops.pop(id(self), None)

    base.run_forever = run_forever

    # background-ness is INHERITED: a task created from inside a
    # supervised background task (gather fan-outs in service loops,
    # helpers they spawn) is itself supervised by the same chain — a
    # teardown that catches such a wave mid-flight is not a leak
    orig_create_task = base.create_task

    def create_task(self, coro, **kw):
        t = orig_create_task(self, coro, **kw)
        try:
            parent = asyncio.current_task()
        except RuntimeError:
            parent = None
        if parent is not None and getattr(parent, BACKGROUND_ATTR,
                                          False):
            setattr(t, BACKGROUND_ATTR, True)
        return t

    base.create_task = create_task

    # (2) teardown checks on the asyncio.run exit path
    runners = asyncio.runners
    orig_cancel_all = runners._cancel_all_tasks

    def _cancel_all_tasks(loop):
        _check_teardown(loop)
        try:
            return orig_cancel_all(loop)
        finally:
            _check_post_cancel(loop)

    runners._cancel_all_tasks = _cancel_all_tasks

    # (3) asyncio.Lock hold tracking
    orig_acquire = asyncio.Lock.acquire
    orig_release = asyncio.Lock.release

    async def acquire(self):
        r = await orig_acquire(self)
        task = asyncio.current_task()
        name = task.get_name() if task is not None else "?"
        try:
            loop_id = id(asyncio.get_running_loop())
        except RuntimeError:
            loop_id = 0
        with _lock:
            _held_locks[id(self)] = (loop_id, name, time.monotonic())
        return r

    def release(self):
        orig_release(self)
        with _lock:
            _held_locks.pop(id(self), None)

    asyncio.Lock.acquire = acquire
    asyncio.Lock.release = release
