"""Copy of garage_tpu/utils/background.py: import paths rewritten, issue and PR tags dropped.

Background worker runtime (asyncio).

Ref parity: src/util/background/ — BackgroundRunner (mod.rs:16-75), Worker
loop with Busy/Idle/Throttled/Done states and exponential error backoff
(worker.rs:19-232), BgVars runtime-tunable variables (vars.rs).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger("garage.background")

# fire-and-forget tasks retained here until done: asyncio keeps only a
# weak reference to running tasks, so an un-retained task can be
# garbage-collected mid-flight and its exception is never observed
# (GL04 orphan-task — the static rule and this helper are two halves
# of the same invariant)
_detached: set[asyncio.Task] = set()


def spawn(coro, name: str = "") -> asyncio.Task:
    """Deliberately-detached task with lifecycle hygiene: retained
    until done, exception observed and logged instead of surfacing as
    'Task exception was never retrieved' at interpreter exit."""
    t = asyncio.ensure_future(coro)
    if name:
        try:
            t.set_name(name)
        except AttributeError:
            pass
    # deliberate background work: the runtime sanitizer's task-leak
    # check at loop teardown skips marked tasks (utils/sanitizer.py)
    t._garage_background = True
    _detached.add(t)
    t.add_done_callback(_spawn_done)
    return t


def _spawn_done(t: asyncio.Task) -> None:
    _detached.discard(t)
    if t.cancelled():
        return
    e = t.exception()
    if e is not None:
        # warning, not debug: before spawn() existed these surfaced as
        # asyncio's ERROR-level "Task exception was never retrieved",
        # and a detached task dying is never expected (expected
        # failures are caught inside the task)
        logger.warning("detached task %s failed: %s",
                       t.get_name(), e, exc_info=e)


class WState(Enum):
    BUSY = "busy"
    IDLE = "idle"
    DONE = "done"


@dataclass
class Throttled:
    delay: float


WorkerState = Any  # WState | Throttled


@dataclass
class WorkerInfo:
    name: str
    state: str = "idle"
    errors: int = 0
    consecutive_errors: int = 0
    last_error: Optional[str] = None
    last_error_time: Optional[float] = None
    tranquility: Optional[int] = None
    progress: Optional[str] = None
    queue_length: Optional[int] = None
    persistent_errors: Optional[int] = None


class Worker:
    """Subclass and implement work(); optionally wait_for_work().

    work() returns WState.BUSY (more work immediately), WState.IDLE (call
    wait_for_work), Throttled(delay), or WState.DONE (exit loop).
    ref: src/util/background/worker.rs:41-59.
    """

    name: str = "worker"

    def info(self) -> WorkerInfo:
        return WorkerInfo(name=self.name)

    async def work(self) -> WorkerState:
        return WState.DONE

    async def wait_for_work(self) -> None:
        await asyncio.sleep(10)


class BackgroundRunner:
    """Spawns workers as asyncio tasks; tracks status; graceful shutdown with
    an 8 s deadline. ref: src/util/background/mod.rs:42-75, worker.rs:189-232.
    """

    EXIT_DEADLINE = 8.0

    def __init__(self):
        self._tasks: Dict[str, asyncio.Task] = {}
        self._workers: Dict[str, Worker] = {}
        self._infos: Dict[str, WorkerInfo] = {}
        self._stopping = asyncio.Event()
        self._seq = 0

    def spawn_worker(self, worker: Worker) -> None:
        self._seq += 1
        wid = f"{self._seq}:{worker.name}"
        self._workers[wid] = worker
        self._infos[wid] = worker.info()
        t = asyncio.create_task(self._run_worker(wid, worker), name=wid)
        # supervised by shutdown(); not a leak at loop teardown
        t._garage_background = True
        self._tasks[wid] = t

    def worker_info(self) -> Dict[str, WorkerInfo]:
        for wid, w in self._workers.items():
            base = w.info()
            prev = self._infos.get(wid)
            if prev:
                base.errors = prev.errors
                base.consecutive_errors = prev.consecutive_errors
                base.last_error = prev.last_error
                base.last_error_time = prev.last_error_time
                base.state = prev.state
            self._infos[wid] = base
        return dict(self._infos)

    async def _run_worker(self, wid: str, worker: Worker) -> None:
        info = self._infos[wid]
        while not self._stopping.is_set():
            try:
                info.state = "busy"
                state = await worker.work()
                info.consecutive_errors = 0
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — worker errors backoff+retry
                info.errors += 1
                info.consecutive_errors += 1
                info.last_error = f"{type(e).__name__}: {e}"
                info.last_error_time = time.time()
                logger.warning("worker %s error: %s", wid, e, exc_info=True)
                # exponential backoff 1s → ~60s, ref worker.rs:206-215
                delay = min(60.0, 1.0 * (2 ** min(info.consecutive_errors - 1, 6)))
                state = Throttled(delay)
            if state is WState.DONE:
                break
            if isinstance(state, Throttled):
                info.state = "throttled"
                try:
                    await asyncio.wait_for(self._stopping.wait(), state.delay)
                    break
                except asyncio.TimeoutError:
                    continue
            if state is WState.IDLE:
                info.state = "idle"
                wait = asyncio.create_task(worker.wait_for_work())
                stop = asyncio.create_task(self._stopping.wait())
                done, pending = await asyncio.wait(
                    {wait, stop}, return_when=asyncio.FIRST_COMPLETED
                )
                for p in pending:
                    p.cancel()
                if stop in done:
                    break
        info.state = "done"

    async def shutdown(self) -> None:
        self._stopping.set()
        if not self._tasks:
            return
        _, pending = await asyncio.wait(
            set(self._tasks.values()), timeout=self.EXIT_DEADLINE
        )
        for p in pending:
            logger.warning("worker %s did not exit in time; cancelling", p.get_name())
            p.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)


class BgVars:
    """Named runtime-tunable variables exposed via CLI `worker get/set`.
    ref: src/util/background/vars.rs."""

    def __init__(self):
        self._vars: Dict[str, tuple[Callable[[], str], Callable[[str], None]]] = {}

    def register_rw(self, name: str, getter: Callable[[], Any],
                    setter: Callable[[str], None]) -> None:
        self._vars[name] = (lambda: str(getter()), setter)

    def get(self, name: str) -> str:
        return self._vars[name][0]()

    def set(self, name: str, value: str) -> None:
        self._vars[name][1](value)

    def all(self) -> Dict[str, str]:
        return {k: g() for k, (g, _) in self._vars.items()}
