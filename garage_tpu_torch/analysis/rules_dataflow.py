"""Copy of garage_tpu/analysis/rules_dataflow.py: import paths rewritten, issue and PR tags dropped.

Flow rules that only exist because of the pass-1 summaries:
GL10 blocking-reachable-from-async, GL11 leaked-budget-on-exception.

GL10 closes GL01's interprocedural hole: GL01 sees `time.sleep` typed
directly inside an `async def`, but the an earlier change regression class more
often hides one helper down (`async def handler` -> `def scan` ->
sqlite). Pass 2 walks the call graph from every async function through
sync project frames (skipping `to_thread` hops, async callees — their
own GL01 problem — and generators, whose call runs nothing) to a
blocking atom, and reports the FULL chain so the fix site is obvious.
Atoms are GL01's hard-I/O list plus the project's sync db seams
(`self.store.iter(...)`, `db.transaction(...)`: receiver matching
store/db/tree/todo/queue/timestamp with a db-verb method, non-awaited)
— digest helpers are deliberately excluded transitively (hashing a
32-byte key two frames down is noise; GL01 still flags digests typed
directly in an async frame).

GL11 is the shape of an earlier change's lease-conservation bugs (and Aspirator's
error-path blindness, Yuan et al. OSDI '14): a qos token / lease /
semaphore acquire whose refund sits on the happy path only — any
raise-capable call between acquire and release leaks the budget
permanently. Safe shapes are recognized structurally: `with`-statement
acquires, releases in a `finally:`, the failure-refund idiom
(`except: refund; raise`), acquires with no release at all (plain
admission consumes tokens by design), and acquires whose value
escapes (ownership transferred to the caller)."""

from __future__ import annotations

from .core import ProjectState, Rule, Violation
from .dataflow import (ACQUIRE_METHODS, IO_BLOCKING_CALLS,
                       RELEASE_METHODS)
from .rules_async import BLOCKING_CALLS as _GL01_BLOCKING

# atoms GL10 adds beyond GL01's list: typed DIRECTLY in an async frame
# they are GL10's to report (GL01 would not fire), so inlining a
# flagged helper cannot make the finding disappear
_EXTRA_IO = IO_BLOCKING_CALLS - _GL01_BLOCKING


def _dataflow(project: ProjectState):
    return project.data.get("_dataflow")


def _is_checked_file(project: ProjectState, rel_path: str) -> bool:
    """GL10/GL11 run on production code only (harness files opt into
    the GL04/GL05/GL07 subset, not the flow rules)."""
    for ctx in project.files:
        if ctx.rel_path == rel_path:
            return not ctx.is_test and not ctx.is_harness
    return False


class BlockingReachableFromAsync(Rule):
    id = "GL10"
    name = "blocking-reachable-from-async"
    needs_dataflow = True
    summary = ("a sync helper that blocks (I/O, @blocking_api db seam) "
               "is reachable from an `async def` with no "
               "asyncio.to_thread frame on the path — the event loop "
               "stalls for the whole operation; the report names the "
               "full call chain (since an earlier change iterating an "
               "in-project generator counts, and the db seam is the "
               "@blocking_api annotation where the call resolves, "
               "receiver-name heuristic only for out-of-tree "
               "callables)")
    rationale = (
        "GL01 sees `time.sleep` typed directly in an async def; the "
        "an earlier change regression class more often hides one helper down "
        "(async handler -> def scan -> sqlite). Pass 2 walks the "
        "call graph from every async function through sync project "
        "frames to a blocking atom — GL01's hard-I/O list plus the "
        "project's sync db seams — skipping to_thread hops and async "
        "callees, and reports the FULL chain. an earlier change closed two "
        "holes: `for x in gen(...)` over an in-project generator now "
        "RUNS the body here (reported at the iteration site; a plain "
        "call stays exempt), and db-seam atoms come from the "
        "@blocking_api annotation on db.Db/Tree/Transaction wherever "
        "the call resolves in-project (the store/db/tree receiver-"
        "name heuristic remains as the fallback for calls the graph "
        "cannot resolve). The an earlier change sweep fixed ~30 real on-loop "
        "db calls this found (table sync/gc/queue, resync, k2v poll, "
        "RPC handlers).")
    example_fire = ("def scan(path):\n"
                    "    return sqlite3.connect(path)\n"
                    "async def handler(path):\n"
                    "    return scan(path)      # chain reported")
    example_ok = ("async def handler(path):\n"
                  "    return await asyncio.to_thread(scan, path)")

    def finish_project(self, project: ProjectState) -> list[Violation]:
        df = _dataflow(project)
        if df is None:
            return []
        out: list[Violation] = []
        file_ok: dict[str, bool] = {}
        for fid in sorted(df.graph.functions):
            fn = df.graph.functions[fid]
            if not fn["is_async"]:
                continue
            path = fn["path"]
            if path not in file_ok:
                file_ok[path] = _is_checked_file(project, path)
            if not file_ok[path]:
                continue
            # direct atoms in the async frame itself that GL01 does
            # not own: the db seams (annotation-filtered since
            # an earlier change), @blocking_api calls, and the fsync/rename
            # syscalls only GL10's list carries
            for atom in df.graph.atoms_of(fid):
                if atom["kind"] == "db":
                    msg = (f"sync db call `{atom['target']}(...)` "
                           "directly on the event loop; wrap in "
                           "asyncio.to_thread")
                elif atom["kind"] == "api":
                    msg = (f"blocking-annotated `{atom['target']}(...)`"
                           " called directly on the event loop; wrap "
                           "in asyncio.to_thread")
                elif atom["target"] in _EXTRA_IO:
                    msg = (f"blocking `{atom['target']}(...)` directly "
                           "on the event loop; wrap in "
                           "asyncio.to_thread")
                else:
                    continue  # GL01's direct hard-I/O list
                out.append(self._violation(path, atom["line"], fn, msg))
            reported: set[str] = set()
            for chain in df.graph.blocking_chains(fid):
                atom = chain[-1]
                frames = chain[:-1]
                atom_fid = frames[-1][0]
                if atom_fid in reported:
                    continue
                reported.add(atom_fid)
                first_rec = frames[0][1]
                hops = " -> ".join(
                    [fn["qualname"]]
                    + [df.graph.functions[cid]["qualname"]
                       for cid, _ in frames])
                atom_fn = df.graph.functions[atom_fid]
                out.append(self._violation(
                    path, first_rec["line"], fn,
                    f"blocking `{atom['target']}` reachable from this "
                    f"async frame with no to_thread hop: {hops} "
                    f"(atom at {atom_fn['path']}:{atom['line']}); move "
                    "the sync frame into asyncio.to_thread",
                    end_line=first_rec.get("end_line")))
        return out

    def _violation(self, path: str, line: int, fn: dict, msg: str,
                   end_line=None) -> Violation:
        v = Violation(rule=self.id, path=path, line=line, col=0,
                      message=msg, context=fn["qualname"])
        v._end_line = end_line  # type: ignore[attr-defined]
        return v


class LeakedBudgetOnException(Rule):
    id = "GL11"
    name = "leaked-budget-on-exception"
    needs_dataflow = True
    summary = ("qos token / lease / semaphore acquire whose refund or "
               "release is not on every exit path — a raise between "
               "acquire and the happy-path release leaks the budget "
               "('s lease-conservation bug class); cross-function "
               "since an earlier change: an acquire here released in a callee "
               "(or handed out by an acquiring helper) settles through "
               "the call graph instead of mis-reporting")
    rationale = (
        "The exact shape of an earlier change's lease-conservation bugs (and "
        "Aspirator's error-path blindness): acquire, do raise-capable "
        "work, release — the release never runs on the exception "
        "path and the budget leaks permanently. Recognized-safe "
        "shapes: `with` acquires, release in a finally:, the "
        "failure-refund idiom (except: refund; raise), acquires with "
        "no release at all (plain admission consumes by design), and "
        "acquires whose value escapes (ownership transferred). Since "
        "an earlier change acquire/release facts settle ACROSS call-graph "
        "edges to a fixpoint: a release inside a helper invoked from "
        "a finally: is exception-safe (no false positive), a helper "
        "that acquires and returns makes its CALLER the owner (the "
        "happy-path-only release there is a real leak — no false "
        "negative). This is the shape of BudgetLeaseBroker "
        "revoke/renew and the feeder's abort paths. Since an earlier change "
        "the raise-capable-call check is path-sensitive over the "
        "pass-1 CFG: a call in a dead except handler or a branch "
        "that never reaches the release does not count.")
    example_fire = ("lease = self._rent(n)   # helper acquires+returns\n"
                    "resp = await upstream()  # raise leaks the lease\n"
                    "lease.release()")
    example_ok = ("tok = await bucket.acquire(n)\n"
                  "try:\n    resp = await upstream()\n"
                  "finally:\n    self._give_back(tok)  "
                  "# releases in the callee")

    # fixpoint iteration cap (call chains deeper than this are noise)
    _MAX_ROUNDS = 8

    def finish_project(self, project: ProjectState) -> list[Violation]:
        df = _dataflow(project)
        if df is None:
            return []
        g = df.graph
        fns = g.functions
        rel_params, rel_attrs = self._release_facts(g)
        acq_ret = self._acquire_returning(g)

        out: list[Violation] = []
        file_ok: dict[str, bool] = {}
        for fid in sorted(fns):
            fn = fns[fid]
            path = fn["path"]
            if path not in file_ok:
                file_ok[path] = _is_checked_file(project, path)
            if not file_ok[path]:
                continue
            ret_names = set(fn["ret_names"])
            acquires = []
            for a in fn["acquires"]:
                if a["in_with"]:
                    continue
                acquires.append((a["line"], a["recv"],
                                 {a["recv"]} | set(a["names"]),
                                 set(a["names"])))
            for callee, rec in g.edges_from(fid):
                # synthetic acquire: the callee acquires and hands the
                # resource back — this frame is now the owner
                if callee in acq_ret and rec.get("bound") \
                        and not rec["via_thread"]:
                    bound = set(rec["bound"])
                    acquires.append(
                        (rec["line"], rec["name"], set(bound), bound))
            for line, recv, match_names, bound in acquires:
                if bound & ret_names:
                    continue  # ownership passed to OUR caller
                evs = self._release_events(g, fid, fn, match_names,
                                           rel_params, rel_attrs)
                if not evs:
                    continue  # plain admission consumes by design
                if any(ctx == "finally" for _, ctx in evs):
                    continue
                plain = [(ln, ctx) for ln, ctx in evs
                         if ctx != "except"]
                if not plain:
                    continue  # except-refund-reraise idiom
                after = [ln for ln, _ in plain if ln > line]
                if not after:
                    continue
                rel_line = min(after)
                risky = self._risky_between(fn, line, rel_line)
                if risky is None:
                    continue
                out.append(Violation(
                    rule=self.id, path=path, line=line, col=0,
                    message=(
                        f"`{recv}` acquire here is released at line "
                        f"{rel_line} only on the happy path — the call "
                        f"at line {risky} can raise and leak the "
                        "budget; release in a finally: (or refund in "
                        "an except: ... raise)"),
                    context=fn["qualname"]))
        return out

    # ---- cross-function facts (fixpoints over summaries) ---------------

    def _release_facts(self, g) -> tuple[dict, dict]:
        """rel_params[fid] = own params the function releases (itself
        or by passing them into a releasing callee); rel_attrs[fid] =
        receiver names it releases, transitively through self-calls
        (the `finally: self._cleanup()` shape)."""
        fns = g.functions
        rel_params = {}
        rel_attrs = {}
        for fid, fn in fns.items():
            params = set(fn["params"])
            rel_params[fid] = {r["recv"] for r in fn["releases"]
                               if r["recv"] in params}
            rel_attrs[fid] = {r["recv"] for r in fn["releases"]}
        for _ in range(self._MAX_ROUNDS):
            changed = False
            for fid, fn in fns.items():
                params = set(fn["params"])
                for callee, rec in g.edges_from(fid):
                    if rec["via_thread"]:
                        continue
                    for n, _ln in self._released_args(
                            g, fid, callee, rec, rel_params):
                        if n in params and n not in rel_params[fid]:
                            rel_params[fid].add(n)
                            changed = True
                    if rec["ref"][0] == "self":
                        new = rel_attrs[callee] - rel_attrs[fid]
                        if new:
                            rel_attrs[fid] |= new
                            changed = True
            if not changed:
                break
        return rel_params, rel_attrs

    def _released_args(self, g, fid, callee, rec, rel_params):
        """Names this call passes into parameters the callee releases."""
        shift = g.bound_call(fid, rec)
        for pos, ad in enumerate(rec["args"]):
            if not ad or "n" not in ad:
                continue
            pname = g.param_index(callee, pos, shift)
            if pname and pname in rel_params.get(callee, ()):
                yield ad["n"], rec["line"]
        for k, ad in rec.get("kw", {}).items():
            if ad and "n" in ad and k in rel_params.get(callee, ()):
                yield ad["n"], rec["line"]

    def _acquire_returning(self, g) -> set:
        """Functions that hand an acquired resource to their caller:
        return a name bound from an acquire, return the acquire call
        itself, or return the result of another acquire-returning
        function (fixpoint)."""
        fns = g.functions
        acq_ret = set()
        for fid, fn in fns.items():
            ret_names = set(fn["ret_names"])
            if any(set(a["names"]) & ret_names for a in fn["acquires"]):
                acq_ret.add(fid)
            if any(rec["name"] in ACQUIRE_METHODS and rec.get("in_ret")
                   for rec in fn["calls"]):
                acq_ret.add(fid)
        for _ in range(self._MAX_ROUNDS):
            changed = False
            for fid, fn in fns.items():
                if fid in acq_ret:
                    continue
                ret_names = set(fn["ret_names"])
                for callee, rec in g.edges_from(fid):
                    if callee not in acq_ret or rec["via_thread"]:
                        continue
                    if rec.get("in_ret") \
                            or set(rec.get("bound", ())) & ret_names:
                        acq_ret.add(fid)
                        changed = True
                        break
            if not changed:
                break
        return acq_ret

    def _release_events(self, g, fid, fn, match_names,
                        rel_params, rel_attrs) -> list[tuple[int, str]]:
        evs = [(r["line"], r["ctx"]) for r in fn["releases"]
               if r["recv"] in match_names]
        for callee, rec in g.edges_from(fid):
            if rec["via_thread"]:
                continue
            for n, ln in self._released_args(g, fid, callee, rec,
                                             rel_params):
                if n in match_names:
                    evs.append((ln, rec["ctx"]))
            if rec["ref"][0] == "self" \
                    and rel_attrs.get(callee, set()) & match_names:
                evs.append((rec["line"], rec["ctx"]))
        return sorted(set(evs))

    def _risky_between(self, fn, lo: int, hi: int):
        """Line of a raise-capable call between acquire (lo) and
        release (hi). Path-sensitive since an earlier change: with a CFG in the
        summary the call must also sit on some control-flow path from
        the acquire's block to the release's block — a call in a dead
        except handler (or a sibling branch that never reaches the
        release) no longer counts. Summaries without a CFG fall back
        to the textual check."""
        on_path = self._on_path_lines(fn, lo, hi)
        for rec in fn["calls"]:
            if lo < rec["line"] < hi \
                    and rec["name"] not in RELEASE_METHODS \
                    and (on_path is None or rec["line"] in on_path):
                return rec["line"]
        return None

    @staticmethod
    def _on_path_lines(fn, lo: int, hi: int):
        """Call lines inside blocks on some CFG path from the block
        containing line `lo` to the block containing line `hi`
        (forward-reachable from the start AND backward-reachable from
        the end). None when the CFG cannot anchor both lines."""
        cfg = fn.get("cfg")
        if not cfg:
            return None
        blocks = {b["id"]: b for b in cfg["blocks"]}
        start = end = None
        for b in cfg["blocks"]:
            if start is None and (lo in b["lines"] or lo in b["calls"]):
                start = b["id"]
            if end is None and (hi in b["lines"] or hi in b["calls"]):
                end = b["id"]
        if start is None or end is None:
            return None
        fwd = {start}
        work = [start]
        while work:
            for s in blocks[work.pop()]["succ"]:
                if s != -1 and s not in fwd:
                    fwd.add(s)
                    work.append(s)
        preds: dict[int, list[int]] = {}
        for b in cfg["blocks"]:
            for s in b["succ"]:
                preds.setdefault(s, []).append(b["id"])
        bwd = {end}
        work = [end]
        while work:
            for p in preds.get(work.pop(), ()):
                if p not in bwd:
                    bwd.add(p)
                    work.append(p)
        lines: set[int] = set()
        for bid in fwd & bwd:
            lines.update(blocks[bid]["calls"])
        return lines
