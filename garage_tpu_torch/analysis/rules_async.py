"""Copy of garage_tpu/analysis/rules_async.py: import paths rewritten, issue and PR tags dropped.

Async-hygiene rules: GL01 blocking-call-in-async, GL04 orphan-task,
GL05 swallowed-exception, GL06 await-holding-lock.

All four are single-file syntactic checks. GL01's escape hatch is the
codebase's own idiom: wrap the blocking work in a sync function (def /
lambda / method) and run it via `asyncio.to_thread` — the walker's
scope stack makes that exemption automatic, because the blocking call
then sits in a sync frame, not directly in the `async def`.
"""

from __future__ import annotations

import ast
import re

from .core import FileContext, Rule, call_name, chain_segments, dotted_name

# ---- GL01 --------------------------------------------------------------

# call targets that block the event loop outright
BLOCKING_CALLS = {
    "open",
    "time.sleep",
    "socket.socket", "socket.create_connection",
    "socket.getaddrinfo", "socket.gethostbyname",
    "sqlite3.connect",
    "subprocess.run", "subprocess.check_output", "subprocess.check_call",
    "subprocess.call", "subprocess.Popen",
    "os.system",
    "urllib.request.urlopen",
    "shutil.copyfile", "shutil.copytree", "shutil.rmtree",
}
# digest constructors/helpers: blocking only when fed real data — a
# zero-arg or constant-literal construction is instantaneous
HASH_CALLS = {
    "hashlib.md5", "hashlib.sha1", "hashlib.sha224", "hashlib.sha256",
    "hashlib.sha384", "hashlib.sha512", "hashlib.blake2b",
    "hashlib.blake2s", "hashlib.new",
    # the project's own digest helpers (utils/data.py)
    "sha256sum", "blake2sum", "blake3sum", "content_hash",
    "content_hash_matches",
}


class BlockingCallInAsync(Rule):
    id = "GL01"
    name = "blocking-call-in-async"
    summary = ("blocking I/O or digest-of-data directly inside an "
               "`async def` — the an earlier change regression class; move it off "
               "the loop with asyncio.to_thread")
    rationale = (
        "One blocking call on the event loop stalls EVERY in-flight "
        "request, not just its own — the an earlier change fast-path work moved "
        "SigV4 hashing, sqlite and file I/O into worker threads, and "
        "this rule keeps them there. The escape hatch is the "
        "codebase's own idiom: wrap the work in a sync def and run it "
        "via asyncio.to_thread (the sync frame is automatically "
        "exempt). GL10 covers the same atoms one or more helpers "
        "down the call graph.")
    example_fire = ("async def handler(req):\n"
                    "    time.sleep(0.1)            # stalls the loop")
    example_ok = ("async def handler(req):\n"
                  "    await asyncio.to_thread(time.sleep, 0.1)")

    def on_call(self, node: ast.Call, ctx: FileContext) -> None:
        if not ctx.in_async_def:
            return
        target = dotted_name(node.func)
        if target in BLOCKING_CALLS:
            ctx.report(self.id, node,
                       f"blocking call `{target}(...)` on the event "
                       "loop; wrap in asyncio.to_thread")
            return
        if target in HASH_CALLS and self._feeds_data(node):
            ctx.report(self.id, node,
                       f"digest `{target}(...)` of non-constant data "
                       "on the event loop; hash in a worker thread "
                       "(asyncio.to_thread)")

    @staticmethod
    def _feeds_data(node: ast.Call) -> bool:
        return any(not isinstance(a, ast.Constant) for a in node.args)


# ---- GL04 --------------------------------------------------------------

SPAWN_CALLS = {"create_task", "ensure_future"}


class OrphanTask(Rule):
    id = "GL04"
    name = "orphan-task"
    summary = ("asyncio.create_task/ensure_future result dropped — an "
               "un-retained task can be garbage-collected mid-flight "
               "and its exception is never observed; store it, await "
               "it, or add_done_callback")
    rationale = (
        "CPython keeps only a weak reference to scheduled tasks: a "
        "dropped create_task result can be garbage-collected MID-"
        "FLIGHT, and its exception is silently lost either way. an earlier change "
        "converted 8 such sites to utils.background.spawn (retained "
        "until done, exception logged). Runs on harness files too — "
        "an orphaned task in clusterbox corrupts chaos-soak verdicts.")
    example_fire = "asyncio.create_task(self._flush())   # dropped"
    example_ok = "self._task = spawn(self._flush(), 'flush')"

    def on_expr_stmt(self, node: ast.Expr, ctx: FileContext) -> None:
        call = node.value
        if not isinstance(call, ast.Call):
            return
        name = call_name(call)
        if name not in SPAWN_CALLS:
            return
        segs = chain_segments(call.func)
        # create_task must come from asyncio / a loop, not an arbitrary
        # object's create_task method... but any `.create_task(` drop
        # is suspicious enough to flag; waive the exceptions.
        ctx.report(self.id, node,
                   f"`{'.'.join(segs)}(...)` result dropped; retain "
                   "the task (store + add_done_callback) or await it")


# ---- GL05 --------------------------------------------------------------

def _is_swallow_body(body: list[ast.stmt]) -> bool:
    """True when the handler body does nothing: only pass / continue /
    `return` / `return None` (docstring-free — any call, log, counter
    or attribute write makes it a real handler)."""
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Continue):
            continue
        if isinstance(stmt, ast.Return):
            if stmt.value is None or (isinstance(stmt.value, ast.Constant)
                                      and stmt.value.value is None):
                continue
            return False
        return False
    return True


class SwallowedException(Rule):
    id = "GL05"
    name = "swallowed-exception"
    summary = ("`except Exception`/bare `except` whose body only "
               "passes/continues/returns None — the Aspirator check "
               "(Yuan et al., OSDI '14); log and count it, or waive "
               "with the reason the swallow is safe")
    rationale = (
        "Yuan et al. (OSDI '14) traced the majority of catastrophic "
        "distributed-storage failures to exactly these do-nothing "
        "handlers — the failure was DETECTED and then discarded. Log "
        "it, count it, or waive it with the reason the swallow is "
        "provably safe. Runs on harness files too: a swallowed "
        "exception in the workload driver turns a real failure into "
        "a passing soak.")
    example_fire = ("try:\n    push(peer)\nexcept Exception:\n"
                    "    pass                    # failure discarded")
    example_ok = ("try:\n    push(peer)\nexcept Exception as e:\n"
                  "    log.debug('push to %s failed: %s', peer, e)")

    def on_except(self, node: ast.ExceptHandler, ctx: FileContext) -> None:
        t = node.type
        if t is None:
            kind = "bare except"
        elif isinstance(t, ast.Name) and t.id in ("Exception",
                                                  "BaseException"):
            kind = f"except {t.id}"
        else:
            return
        if _is_swallow_body(node.body):
            ctx.report(self.id, node,
                       f"{kind}: exception silently swallowed "
                       "(body is only pass/continue/return None)")


# ---- GL06 --------------------------------------------------------------

RPC_METHODS = {"try_call_many", "try_write_many_sets",
               "rpc_get_block", "rpc_put_block"}
RPC_RECEIVERS = {"rpc", "ep", "endpoint", "rpc_helper"}
GL06_DIRS = re.compile(r"(^|/)(table|block)/")


class AwaitHoldingLock(Rule):
    id = "GL06"
    name = "await-holding-lock"
    summary = ("awaiting a network/RPC call inside a `with <lock>:` / "
               "`async with <lock>:` body in table/ or block/ — the "
               "lock is held across the whole remote round-trip and "
               "serializes every other waiter behind a peer's tail "
               "latency (sync threading locks count since an earlier change: "
               "they stall the WHOLE loop, not just one task)")
    rationale = (
        "A lock held across a network await couples local concurrency "
        "to a PEER's tail latency: one slow replica and every other "
        "task queues behind the lock for seconds. Since an earlier change sync "
        "`with lock():` frames count too. Deliberate holds (e.g. the "
        "layout write_lock, which is a version PIN, not mutual "
        "exclusion) carry reasoned waivers.")
    example_fire = ("async with self._lock:\n"
                    "    await self.rpc.try_call_many(...)")
    example_ok = ("async with self._lock:\n    payload = build()\n"
                  "await self.rpc.try_call_many(...)")

    def applies_to(self, ctx: FileContext) -> bool:
        return (not ctx.is_test) and bool(GL06_DIRS.search(ctx.rel_path))

    def on_await(self, node: ast.Await, ctx: FileContext) -> None:
        if not ctx.lock_stack:
            return
        call = node.value
        if not isinstance(call, ast.Call):
            return
        segs = chain_segments(call.func)
        if not segs:
            return
        is_rpc = (segs[-1] in RPC_METHODS
                  or (segs[-1] == "call"
                      and any(s in RPC_RECEIVERS for s in segs[:-1]))
                  or any(s in ("rpc", "rpc_helper") for s in segs[:-1]))
        if is_rpc:
            ctx.report(self.id, node,
                       f"RPC `{'.'.join(segs)}` awaited while holding "
                       "an async lock; release the lock before the "
                       "network round-trip")
