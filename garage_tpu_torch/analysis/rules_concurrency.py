"""Copy of garage_tpu/analysis/rules_concurrency.py: import paths rewritten, issue and PR tags dropped.

Concurrency-soundness flow rules: GL12
await-interleaving-atomicity and GL13 lock-order-inversion.

Python's cooperative scheduler makes every `await` a preemption point:
any other task can run between the statement before the await and the
statement after it. Garage's correctness story rests on single-writer
invariants that hold only while a frame does NOT yield — and PRs 8-11
multiplied the shared mutable surface that straddles awaits (lease
pool accounting, gateway rosters, feeder in-flight maps, pipeline
generation state, peer-health rings).

GL12 is the TSan-style stale-check detector, specialized to asyncio:
a read of a shared lvalue (self-attribute or module-level state — the
GL09 census), then an await with NO lock held, then a write of the
same lvalue. The classic firing shape is check-then-act::

    if h not in self._inflight:
        fut = await self._start(h)      # another task can insert h here
        self._inflight[h] = fut         # ...and this clobbers it

The await may be interprocedural: the write can live in the awaited
callee (resolved through the call graph for same-object `self.x()`
calls and same-module functions). Re-checking after the await — a read
of the lvalue between the await and the write — suppresses the
finding: that IS the fix idiom. So does holding any lock across the
await (the pass-1 locks-at-await facts), and so does the guard-loop
idiom (`while cond: await ...` re-evaluates its test before falling
through — the summary walk re-emits the test's reads after the body).

GL13 is classic lock-order-cycle detection over a GLOBAL acquisition
graph: lock identity is the resolved attribute path (`Cls._lock`,
`module._global_lock` — the name-scope machinery pass 1 already has),
an edge A -> B exists wherever B is acquired (`async with` / `with` /
`.acquire()`) while A is held — including through resolved calls — and
any cycle is the ABBA deadlock no test reliably reproduces. Both full
chains are reported with their file:line witnesses.
"""

from __future__ import annotations

from .core import ProjectState, Rule, Violation
# one home for "which files do flow rules check" — GL12/GL13 must
# never diverge from GL10/GL11 on scope policy
from .rules_dataflow import _dataflow, _is_checked_file

# call-graph expansion caps (defense against pathological graphs)
_WRITE_DEPTH = 6
_LOCK_DEPTH = 6


def _lv_str(lv: list) -> str:
    return f"self.{lv[1]}" if lv[0] == "self" else lv[1]


class AwaitInterleavingAtomicity(Rule):
    id = "GL12"
    name = "await-interleaving-atomicity"
    needs_dataflow = True
    summary = ("read -> await -> write on the same shared lvalue "
               "(self-attribute / module state) in an async frame with "
               "no lock held across the await — every await is a "
               "preemption point, so another task can invalidate the "
               "read before the write lands (check-then-act race); "
               "re-check after the await, or hold a lock across it")
    rationale = (
        "Any `await` is a preemption point: the cooperative scheduler "
        "can run EVERY other task between the read and the write, so "
        "a decision made before the await is stale by the time the "
        "write lands — the classic shape is check-then-act on an "
        "in-flight map (`if h not in self._inflight: await ...; "
        "self._inflight[h] = fut` — two concurrent callers both pass "
        "the check and the second clobbers the first's entry). The "
        "write may also live in the awaited callee (resolved through "
        "the call graph). Recognized-safe shapes: any lock held "
        "across the await (pass-1 locks-at-await facts), a RE-READ of "
        "the lvalue between the await and the write (re-validation is "
        "the fix idiom), and the guard-loop `while cond: await` "
        "(its test is re-evaluated before falling through). Since "
        "an earlier change loop bodies that await are unrolled once in the "
        "event stream (the CFG back-edge), so the loop-carried race — "
        "read late in iteration i, write after the await early in "
        "iteration i+1 — fires too.")
    example_fire = ("async def start(self, h):\n"
                    "    if h not in self._inflight:\n"
                    "        fut = await self._spawn(h)\n"
                    "        self._inflight[h] = fut   # stale check")
    example_ok = ("async def start(self, h):\n"
                  "    fut = self._inflight.get(h)\n"
                  "    if fut is None:\n"
                  "        fut = await self._spawn(h)\n"
                  "        if h not in self._inflight:  # re-checked\n"
                  "            self._inflight[h] = fut")

    def finish_project(self, project: ProjectState) -> list[Violation]:
        df = _dataflow(project)
        if df is None:
            return []
        g = df.graph
        out: list[Violation] = []
        file_ok: dict[str, bool] = {}
        for fid in sorted(g.functions):
            fn = g.functions[fid]
            if not fn["is_async"] or not fn.get("accesses"):
                continue
            path = fn["path"]
            if path not in file_ok:
                file_ok[path] = _is_checked_file(project, path)
            if not file_ok[path]:
                continue
            out.extend(self._check_function(g, fid, fn))
        return out

    def _check_function(self, g, fid: str, fn: dict) -> list[Violation]:
        # open: lv-key -> read line (no await crossed yet);
        # pending: lv-key -> (read line, await line) — a lock-free
        # await separates the read from any later write
        open_reads: dict[tuple, int] = {}
        pending: dict[tuple, tuple[int, int]] = {}
        fired: set[tuple] = set()
        out: list[Violation] = []

        def fire(lv, read_ln, await_ln, write_ln, where=""):
            key = tuple(lv)
            if key in fired:
                return
            fired.add(key)
            name = _lv_str(lv)
            out.append(Violation(
                rule=self.id, path=fn["path"], line=write_ln, col=0,
                message=(
                    f"`{name}` read at line {read_ln}, then awaited at "
                    f"line {await_ln} with no lock held, then written "
                    f"{where}— the await is a preemption point, so the "
                    f"line-{read_ln} check is stale when the write "
                    "lands (check-then-act race); re-check after the "
                    "await or hold a lock across it"),
                context=fn["qualname"]))

        for ev in fn["accesses"]:
            k = ev["k"]
            if k == "x":
                # return barrier: flows that crossed the await left
                # the frame here; later writes sit on no-await paths
                pending.clear()
                continue
            if k == "r":
                key = tuple(ev["lv"])
                # a re-read AFTER an await re-validates the state:
                # that is the fix idiom, so it clears the pending pair
                pending.pop(key, None)
                open_reads[key] = ev["line"]
            elif k == "w":
                key = tuple(ev["lv"])
                if key in pending:
                    r_ln, a_ln = pending.pop(key)
                    if not ev.get("flag"):
                        fire(ev["lv"], r_ln, a_ln, ev["line"])
                open_reads.pop(key, None)
            elif k == "a":
                if ev["locks"]:
                    continue  # lock held across the await: atomic
                if ev.get("ret"):
                    continue  # control leaves the frame at this await
                for key, r_ln in list(open_reads.items()):
                    pending[key] = (r_ln, ev["line"])
                open_reads.clear()
                # interprocedural: the awaited callee (chain) writes
                # the lvalue this frame just checked
                if ev.get("call"):
                    self._callee_write_check(
                        g, fid, ev, pending, fire)
            elif k == "c":
                # a sync self-call can carry the write (`await x();
                # self._store(h)` where _store writes the map)
                if not ev.get("call"):
                    continue
                for lv, w_fid, flag in self._callee_writes(
                        g, fid, ev["call"]):
                    key = tuple(lv)
                    if key in pending:
                        r_ln, a_ln = pending.pop(key)
                        if not flag:
                            w_fn = g.functions[w_fid]
                            fire(lv, r_ln, a_ln, ev["line"],
                                 where=f"in `{w_fn['qualname']}` "
                                       f"(called at line {ev['line']}) ")
                    open_reads.pop(key, None)
        return out

    def _callee_write_check(self, g, fid, ev, pending, fire):
        for lv, w_fid, flag in self._callee_writes(g, fid, ev["call"]):
            key = tuple(lv)
            if key in pending:
                r_ln, a_ln = pending.pop(key)
                if not flag:
                    w_fn = g.functions[w_fid]
                    fire(lv, r_ln, a_ln, ev["line"],
                         where=f"in awaited `{w_fn['qualname']}` ")

    def _callee_writes(self, g, caller_id: str, ref: list):
        """(lvalue, writer fid, benign) triples the callee chain
        writes, with same-object guarantees: `self.x` lvalues
        propagate only through `self.m()` refs (same instance),
        module-state lvalues only within the same module. Accretive
        writes and writes the callee re-validates (a read of the same
        lvalue immediately before, no await between) are skipped —
        they act on live state, not on the caller's stale check."""
        callee = g.resolve_ref(caller_id, ref)
        if callee is None:
            return
        same_self = ref[0] == "self"
        caller_mod = caller_id.split(":", 1)[0]
        seen: set[str] = set()
        stack = [(callee, same_self, 0)]
        while stack:
            cur, self_ok, depth = stack.pop()
            if cur in seen or depth > _WRITE_DEPTH:
                continue
            seen.add(cur)
            cur_fn = g.functions[cur]
            cur_mod = cur.split(":", 1)[0]
            read_since_await: set[tuple] = set()
            for ev in cur_fn.get("accesses", []):
                if ev["k"] == "a":
                    read_since_await.clear()
                    continue
                if ev["k"] == "r":
                    read_since_await.add(tuple(ev["lv"]))
                    continue
                if ev["k"] != "w":
                    continue
                lv = ev["lv"]
                # a write the callee derives from a read it made after
                # its own last preemption point acts on LIVE state
                if ev.get("acc") or tuple(lv) in read_since_await:
                    continue
                flag = bool(ev.get("flag"))
                if lv[0] == "self" and self_ok:
                    yield lv, cur, flag
                elif lv[0] == "mod" and cur_mod == caller_mod:
                    yield lv, cur, flag
            for nxt, rec in g.edges_from(cur):
                if rec["via_thread"]:
                    continue
                stack.append((nxt, self_ok and rec["ref"][0] == "self",
                              depth + 1))


class LockOrderInversion(Rule):
    id = "GL13"
    name = "lock-order-inversion"
    needs_dataflow = True
    summary = ("two locks are acquired in opposite orders on different "
               "code paths (lock identity = resolved attribute path "
               "plus, since an earlier change, the allocation site of a local "
               "receiver — two instances of one class are distinct, "
               "two aliases of one instance are not; acquisitions seen "
               "through `async with` / `with` / `.acquire()`, "
               "including through resolved calls) — the classic ABBA "
               "deadlock; pick one global order and stick to it")
    rationale = (
        "If path 1 holds A while taking B and path 2 holds B while "
        "taking A, two tasks can each hold one lock and wait forever "
        "on the other — the ABBA deadlock that no test reliably "
        "reproduces because it needs the exact interleaving. The rule "
        "builds a GLOBAL acquisition graph (edge A -> B = B acquired "
        "while A held, lock identity = class-qualified attribute "
        "path — allocation-site-qualified for locks reached through "
        "a local constructed in the frame, so `x = Guard(); y = "
        "Guard()` yields two identities while `y = x` aliases one — "
        "edges also found THROUGH resolved calls) and reports "
        "every cycle with both witness chains. The fix is a single "
        "global acquisition order — usually: take the coarser lock "
        "first, or restructure so one lock is released before the "
        "other is taken.")
    example_fire = ("async def a(self):\n"
                    "    async with self._lock_a:\n"
                    "        async with self._lock_b: ...\n"
                    "async def b(self):\n"
                    "    async with self._lock_b:\n"
                    "        async with self._lock_a: ...")
    example_ok = ("async def a(self):\n"
                  "    async with self._lock_a:\n"
                  "        async with self._lock_b: ...\n"
                  "async def b(self):\n"
                  "    async with self._lock_a:   # same global order\n"
                  "        async with self._lock_b: ...")

    def finish_project(self, project: ProjectState) -> list[Violation]:
        df = _dataflow(project)
        if df is None:
            return []
        g = df.graph
        file_ok: dict[str, bool] = {}

        def checked(path: str) -> bool:
            if path not in file_ok:
                file_ok[path] = _is_checked_file(project, path)
            return file_ok[path]

        # edge (A, B) -> first witness {path, line, fn, note}
        edges: dict[tuple[str, str], dict] = {}

        def add_edge(a: str, b: str, fn: dict, line: int, note: str):
            if a == b:
                return  # re-entrant same-identity: not an order cycle
            edges.setdefault((a, b), {
                "path": fn["path"], "line": line,
                "fn": fn["qualname"], "note": note})

        for fid in sorted(g.functions):
            fn = g.functions[fid]
            if not checked(fn["path"]):
                continue
            for acq in fn.get("lock_acqs", []):
                b = self._qualify(fn, acq["lock"])
                for h in acq["held"]:
                    add_edge(self._qualify(fn, h), b, fn,
                             acq["line"], "")
            # through calls: a callee (chain) acquires while this
            # frame holds a lock ("c" = sync call with held locks,
            # "a" = awaited call with locks-at-await)
            for ev in fn.get("accesses", []):
                if ev["k"] not in ("c", "a") or not ev.get("call"):
                    continue
                held = ev.get("held") or ev.get("locks") or []
                if not held:
                    continue
                for lock, where in self._callee_locks(g, fid,
                                                      ev["call"]):
                    for h in held:
                        add_edge(self._qualify(fn, h), lock, fn,
                                 ev["line"], f" via {where}")

        return self._report_cycles(edges)

    def _qualify(self, fn: dict, lock: str) -> str:
        """Class-qualify self-rooted lock paths, module-qualify the
        rest — the identity two functions must agree on for an edge
        to connect them."""
        if lock.startswith("self.") or lock.startswith("cls."):
            rest = lock.split(".", 1)[1]
            cls = fn.get("class") or fn["qualname"]
            return f"{fn['module']}.{cls}.{rest}"
        return f"{fn['module']}.{lock}"

    def _callee_locks(self, g, caller_id: str, ref: list):
        """(qualified lock, holder qualname) for every lock the callee
        chain acquires."""
        callee = g.resolve_ref(caller_id, ref)
        if callee is None:
            return
        seen: set[str] = set()
        stack = [(callee, 0)]
        while stack:
            cur, depth = stack.pop()
            if cur in seen or depth > _LOCK_DEPTH:
                continue
            seen.add(cur)
            cur_fn = g.functions[cur]
            for acq in cur_fn.get("lock_acqs", []):
                yield (self._qualify(cur_fn, acq["lock"]),
                       cur_fn["qualname"])
            for nxt, rec in g.edges_from(cur):
                if not rec["via_thread"]:
                    stack.append((nxt, depth + 1))

    def _report_cycles(self, edges: dict) -> list[Violation]:
        graph: dict[str, list[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, []).append(b)
            graph.setdefault(b, [])
        for k in graph:
            graph[k].sort()

        out: list[Violation] = []
        reported: set[frozenset] = set()
        # DFS from each node (sorted: deterministic) finding one cycle
        # per distinct lock set
        for start in sorted(graph):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in graph.get(node, []):
                    if nxt == start and len(path) >= 2:
                        key = frozenset(path)
                        if key in reported:
                            continue
                        reported.add(key)
                        out.append(self._cycle_violation(path, edges))
                    elif nxt not in path and len(path) < 6:
                        stack.append((nxt, path + [nxt]))
        return out

    def _cycle_violation(self, path: list[str],
                         edges: dict) -> Violation:
        hops = []
        for i, a in enumerate(path):
            b = path[(i + 1) % len(path)]
            w = edges[(a, b)]
            hops.append(f"{a} -> {b} at {w['path']}:{w['line']} "
                        f"in {w['fn']}{w['note']}")
        w0 = edges[(path[0], path[1 % len(path)])]
        return Violation(
            rule=self.id, path=w0["path"], line=w0["line"], col=0,
            message=("lock-order cycle (ABBA deadlock): "
                     + "; ".join(hops)
                     + " — pick one global acquisition order"),
            context=w0["fn"])
