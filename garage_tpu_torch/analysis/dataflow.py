"""Copy of garage_tpu/analysis/dataflow.py: import paths rewritten, issue and PR tags dropped.

Pass 1 of the interprocedural engine: per-function summaries.

Infer-style compositional analysis: one extra walk per file
extracts, for every function, the facts the flow rules need —

  * name-level taint: which PARAMS flow into each call argument and
    into the return value (two monotone passes over the body, enough
    for the straight-line helper chains the rules care about);
  * SSE-C sources in scope (sse-named params/locals, decrypt results);
  * blocking atoms: calls that pin the event loop if reached from an
    `async def` without a thread hop — GL01's I/O list plus the
    project's sync db seams (`self.store.iter`, `db.transaction`, ...);
  * call records with enough structure to build the project call graph
    (callgraph.py): self/name/dotted/attr refs, `asyncio.to_thread` /
    `functools.partial` / `run_in_executor` unwrapping, awaited-ness,
    kwarg names, RequestStrategy argument classification;
  * resource discipline: qos/lease/semaphore acquires and whether their
    refund/release is structurally on every exit path (GL11's fact);
  * since an earlier change: an explicit per-function CFG (build_cfg — branch/
    loop/try-except/return edges, back-edges marked) for path-sensitive
    pass-2 queries, allocation-site lock identity, and receiver typing
    facts (var_types) that rank above unique-method CHA in pass 2.

Summaries are plain dicts of sorted primitives: `json.dumps(...,
sort_keys=True)` over the same tree is byte-identical, which is what
lets CI cache pass 1 keyed on file hash (`--summary-cache`).
"""

from __future__ import annotations

import ast
import hashlib
import json
from typing import Optional

from .rules_async import BLOCKING_CALLS as _GL01_BLOCKING

from .core import (MUTATION_NAME_RE, MUTATION_OP_RE, chain_segments,
                   dotted_name, payload_ops)

# ---- blocking atoms -----------------------------------------------------

# GL01's hard-I/O list IS the base (imported, not copied — the direct
# and transitive rules must never disagree about what blocks); GL10
# additionally treats durable-rename/fsync syscalls as atoms because
# they hide inside sync persistence helpers. Digest helpers are
# deliberately NOT propagated transitively: hashing a 32-byte key two
# frames down is microseconds, and GL01 already flags digest-of-data
# DIRECTLY in an async frame where the payload is plausibly large.

IO_BLOCKING_CALLS = _GL01_BLOCKING | {
    "os.fsync", "os.replace", "os.rename",
}

# the project's synchronous metadata seams: a non-awaited method call
# on a db-ish receiver is a sqlite/LSM operation that belongs in a
# worker thread when reachable from the event loop (db.py convention
# since an earlier change). Receiver segment must MATCH (not merely contain) one of
# these so `self.store.iter(...)`, `db.transaction(...)`,
# `self.merkle_todo.insert(...)` qualify but e.g. `self.restore.get`
# does not.
DB_RECEIVER_RE = r"(^|_)(store|db|tree|todo|queue|timestamp)$"
DB_METHODS = {"get", "iter", "insert", "remove", "transaction",
              "open_tree", "snapshot", "checkpoint"}

THREAD_HOPS = {"to_thread", "run_in_executor"}

SSE_NAME_RE = r"(^|_)sse"
DECRYPT_RE = r"(^|_)(decrypt|unseal)"

ACQUIRE_METHODS = {"acquire", "try_acquire"}
RELEASE_METHODS = {"release", "refund", "give_back", "revoke"}

# mutating container/method calls on a tracked shared lvalue count as
# WRITES for the GL12 interleaving analysis (the receiver read they
# imply is part of the atomic mutation, not a separate stale check, so
# no read event is emitted for it)
MUT_METHODS = {"add", "append", "appendleft", "clear", "discard",
               "extend", "insert", "pop", "popleft", "popitem",
               "remove", "setdefault", "update"}
# accretive subset: these operate on the LIVE state at mutation time
# (append/add/insert can't clobber a concurrent task's entry,
# setdefault is itself an atomic re-check), so they count as a
# re-validating read immediately before their write — a stale
# pre-await check cannot make them lose another task's update
ACCRETIVE_METHODS = {"add", "append", "appendleft", "extend", "insert",
                     "setdefault"}

# identifier segment that marks a context-manager expression as a lock
LOCK_SEG = "lock"

import re as _re

_DB_RECEIVER = _re.compile(DB_RECEIVER_RE)
_SSE_NAME = _re.compile(SSE_NAME_RE, _re.IGNORECASE)
_DECRYPT = _re.compile(DECRYPT_RE, _re.IGNORECASE)


# bump on ANY change to the summary schema or extraction semantics —
# cached entries from other versions are recomputed, not trusted
# (v3: an earlier change — exit-path contexts on call/acquire/release records,
# shared-state access events, lock-acquisition facts, generator-
# iteration flags, blocking_api annotations)
# (v4: an earlier change — explicit per-function CFG with back-edges, loop
# back-edge unrolling in the concurrency event stream, allocation-site
# lock identity, receiver type facts for import-aware call resolution)
SUMMARY_VERSION = 4


def module_name_of(rel_path: str) -> str:
    """garage_tpu/model/k2v/rpc.py -> garage_tpu_torch.model.k2v.rpc"""
    p = rel_path[:-3] if rel_path.endswith(".py") else rel_path
    p = p.replace("\\", "/")
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


def _call_ref(func_expr: ast.AST) -> Optional[list]:
    """Reference shape for a callable expression:
       ["name", n]          bare name
       ["self", m]          self.m / cls.m
       ["dotted", "a.b.c"]  attribute chain rooted at a plain name
       ["attr", m]          method on an arbitrary expression
    Receiver segments ride separately in the call record."""
    segs = chain_segments(func_expr)
    if not segs:
        return None
    if len(segs) == 1:
        return ["name", segs[0]]
    if segs[0] in ("self", "cls"):
        if len(segs) == 2:
            return ["self", segs[1]]
        return ["attr", segs[-1]]
    dn = dotted_name(func_expr)
    if dn is not None:
        return ["dotted", dn]
    return ["attr", segs[-1]]


def _payload_ops(node: ast.Call) -> list[str]:
    return sorted(set(payload_ops(node)))


def _contains_await(node: ast.AST) -> bool:
    """An Await in THIS frame (nested defs excluded; lambdas cannot
    contain await)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and n is not node:
            continue
        if isinstance(n, ast.Await):
            return True
        stack.extend(ast.iter_child_nodes(n))
    return False


# ---- control-flow graph -------------------------------------

def build_cfg(fn_node: ast.AST) -> dict:
    """Explicit statement-level control-flow graph for one function:
    blocks of consecutive simple statements, edges for branch / loop /
    try-except / return flow, loop back-edges marked. Block 0 is the
    entry; ``-1`` is the virtual exit. Each block records the source
    lines of its statements plus the lines of call expressions inside
    them (nested defs/lambdas excluded), which lets pass-2 rules ask
    "is this call on some CFG path between these two lines" instead of
    "is it textually between them" (GL11's risky-call check).

    Approximations, each sound for lint (they only ADD paths, never
    hide one): exception edges enter a handler only from body blocks
    that can raise (a call, an explicit raise, an await/yield, or an
    assert) — a handler guarding a raise-free body is unreachable; a
    nested raise links to every enclosing handler level, not just the
    innermost; a return inside try/finally jumps straight to the exit
    without threading the finally body."""
    blocks: list[dict] = []

    def new_block() -> dict:
        b = {"id": len(blocks), "lines": [], "calls": [],
             "succ": [], "back": [], "_raises": False}
        blocks.append(b)
        return b

    def link(a: dict, b: dict, back: bool = False) -> None:
        if b["id"] not in a["succ"]:
            a["succ"].append(b["id"])
        if back and b["id"] not in a["back"]:
            a["back"].append(b["id"])

    def to_exit(a: dict) -> None:
        if -1 not in a["succ"]:
            a["succ"].append(-1)

    def note_calls(b: dict, node: ast.AST) -> None:
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)) and n is not node:
                continue  # nested scope: its calls are not this frame's
            if isinstance(n, ast.Call):
                b["calls"].append(n.lineno)
                b["_raises"] = True
            elif isinstance(n, (ast.Raise, ast.Await, ast.Yield,
                                ast.YieldFrom, ast.Assert)):
                b["_raises"] = True
            stack.extend(ast.iter_child_nodes(n))

    def note(b: dict, st: ast.AST) -> None:
        b["lines"].append(st.lineno)
        note_calls(b, st)

    def flow(stmts: list, cur, loops: list, handlers: list):
        """Thread `stmts` through the graph starting in block `cur`;
        returns the open fall-through block, or None when control
        cannot reach past the last statement."""
        for st in stmts:
            if cur is None:
                cur = new_block()  # unreachable tail, still modeled
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                cur["lines"].append(st.lineno)
            elif isinstance(st, ast.Return):
                note(cur, st)
                to_exit(cur)
                cur = None
            elif isinstance(st, ast.Raise):
                note(cur, st)
                if handlers:
                    for h in handlers[-1]:
                        link(cur, h)
                else:
                    to_exit(cur)
                cur = None
            elif isinstance(st, ast.Break):
                cur["lines"].append(st.lineno)
                if loops:
                    link(cur, loops[-1][1])
                cur = None
            elif isinstance(st, ast.Continue):
                cur["lines"].append(st.lineno)
                if loops:
                    link(cur, loops[-1][0], back=True)
                cur = None
            elif isinstance(st, ast.If):
                cur["lines"].append(st.lineno)
                note_calls(cur, st.test)
                then_b = new_block()
                link(cur, then_b)
                out_t = flow(st.body, then_b, loops, handlers)
                if st.orelse:
                    else_b = new_block()
                    link(cur, else_b)
                    out_e = flow(st.orelse, else_b, loops, handlers)
                else:
                    out_e = cur
                outs = [o for o in (out_t, out_e) if o is not None]
                if outs:
                    join = new_block()
                    for o in outs:
                        link(o, join)
                    cur = join
                else:
                    cur = None
            elif isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
                header = new_block()
                link(cur, header)
                header["lines"].append(st.lineno)
                note_calls(header, st.test if isinstance(st, ast.While)
                           else st.iter)
                after = new_block()
                body_b = new_block()
                link(header, body_b)
                out_b = flow(st.body, body_b,
                             loops + [(header, after)], handlers)
                if out_b is not None:
                    link(out_b, header, back=True)
                if st.orelse:
                    oe = new_block()
                    link(header, oe)
                    out_oe = flow(st.orelse, oe, loops, handlers)
                    if out_oe is not None:
                        link(out_oe, after)
                else:
                    link(header, after)
                cur = after
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                cur["lines"].append(st.lineno)
                for item in st.items:
                    note_calls(cur, item.context_expr)
                cur = flow(st.body, cur, loops, handlers)
            elif isinstance(st, ast.Try):
                h_blks = [new_block() for _ in st.handlers]
                body_b = new_block()
                link(cur, body_b)
                lo = body_b["id"]
                out_body = flow(st.body, body_b, loops,
                                handlers + ([h_blks] if h_blks else []))
                hi = len(blocks)
                if h_blks:
                    h_ids = {h["id"] for h in h_blks}
                    for b in blocks[lo:hi]:
                        if b["_raises"] and b["id"] not in h_ids:
                            for h in h_blks:
                                link(b, h)
                if st.orelse and out_body is not None:
                    out_body = flow(st.orelse, out_body, loops, handlers)
                outs = [out_body] if out_body is not None else []
                for h, hb in zip(st.handlers, h_blks):
                    hb["lines"].append(h.lineno)
                    if h.type is not None:
                        note_calls(hb, h.type)
                    out_h = flow(h.body, hb, loops, handlers)
                    if out_h is not None:
                        outs.append(out_h)
                if st.finalbody:
                    fin = new_block()
                    for o in outs:
                        link(o, fin)
                    cur = flow(st.finalbody, fin, loops, handlers)
                else:
                    if outs:
                        join = new_block()
                        for o in outs:
                            link(o, join)
                        cur = join
                    else:
                        cur = None
            else:
                note(cur, st)
        return cur

    entry = new_block()
    out = flow(list(getattr(fn_node, "body", [])), entry, [], [])
    if out is not None:
        to_exit(out)
    for b in blocks:
        del b["_raises"]
        b["calls"] = sorted(set(b["calls"]))
    return {"blocks": blocks}


class _FunctionCollector:
    """One bounded walk over a single function body (nested defs get
    their own collector; we do not descend into them here)."""

    def __init__(self, node: ast.AST, qualname: str, cls: Optional[str],
                 parent: Optional[str], strategies: dict,
                 module_state: Optional[set] = None):
        self.node = node
        self.qualname = qualname
        self.cls = cls
        self.parent = parent
        self.local_strategies = strategies  # name -> hedge pin (or None)
        self.module_state = module_state or set()
        self.params: list[str] = []
        self.calls: list[dict] = []
        self.blocking: list[dict] = []
        self.acquires: list[dict] = []
        self.releases: list[dict] = []
        self.awaits_under_lock: list[dict] = []
        self.is_generator = False
        self.returns_exprs: list[ast.AST] = []
        self.escaped: set[str] = set()   # names that leave the function
        self.taint: dict[str, set] = {}
        self.sse_locals: set[str] = set()
        self._lock_stack: list[str] = []
        self._with_items: set[int] = set()  # id() of calls in with-items
        self._try_ctx: list[str] = []       # "except"/"finally" frames
        self._iter_calls: set[int] = set()  # id() of for/async-for iters
        self.blocking_api = False           # @blocking_api-decorated
        # concurrency facts (own ordered walk, _collect_concurrency):
        # accesses = source-order events over shared lvalues in THIS
        # frame ("r" read / "w" write / "a" await / "c" call);
        # lock_acqs = every lock acquisition with the locks already held
        self.accesses: list[dict] = []
        self.lock_acqs: list[dict] = []
        self._cw_locks: list[str] = []
        self._cw_terminal = 0  # inside a return/raise expression
        # allocation-site points-to: local name -> "Cls@line"
        # for `x = Cls(...)` bindings (aliases copy the site), so lock
        # identity can distinguish two instances of one class
        self._cw_alloc: dict[str, str] = {}
        # receiver typing facts: local/param name ->
        # {"k": "ann"|"call"|"isinstance", "t": "dotted.chain"} — pass 2
        # ranks these above unique-method CHA when resolving bare
        # attribute calls
        self.var_types: dict[str, dict] = {}

        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                self.params.append(arg.arg)
        for p in self.params:
            self.taint[p] = {p}
            if _SSE_NAME.search(p):
                self.sse_locals.add(p)

    # -- taint helpers ----------------------------------------------------

    def _expr_taint(self, expr: Optional[ast.AST]) -> set:
        if expr is None:
            return set()
        out: set = set()
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name):
                out |= self.taint.get(sub.id, set())
            elif isinstance(sub, ast.Call):
                cn = chain_segments(sub.func)
                if cn and _DECRYPT.search(cn[-1]):
                    out.add("<decrypt>")
        return out

    def _bind(self, target: ast.AST, labels: set, from_sse_expr: bool):
        if isinstance(target, ast.Name):
            self.taint[target.id] = self.taint.get(target.id, set()) | labels
            if _SSE_NAME.search(target.id) or from_sse_expr:
                self.sse_locals.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, labels, from_sse_expr)

    # -- the walk ---------------------------------------------------------

    def run(self) -> None:
        # two monotone passes: the second pass sees bindings made later
        # in the first (good enough for helper-chain shapes; loops in
        # the taint lattice only ever add labels)
        body = list(ast.iter_child_nodes(self.node))
        for _ in range(2):
            self.calls.clear()
            self.blocking.clear()
            self.acquires.clear()
            self.releases.clear()
            self.awaits_under_lock.clear()
            self._lock_stack.clear()
            self._with_items.clear()
            self._try_ctx.clear()
            self._iter_calls.clear()
            for child in body:
                self._visit(child, awaited=False)
        self._mark_return_calls()
        self._collect_var_types()
        self._collect_concurrency()

    def _visit(self, node: ast.AST, awaited: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # nested scopes summarized separately
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            self.is_generator = True
        if isinstance(node, ast.Return) and node.value is not None:
            self.returns_exprs.append(node.value)
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name):
                    self.escaped.add(sub.id)
        if isinstance(node, ast.Try):
            # exit-path contexts: releases/calls inside an except
            # handler or a finally: block carry a "ctx" marker so the
            # (now cross-function) GL11 logic can classify them from
            # the summary alone
            for st in node.body:
                self._visit(st, awaited=False)
            for h in node.handlers:
                if h.type is not None:
                    self._visit(h.type, awaited=False)
                self._try_ctx.append("except")
                for st in h.body:
                    self._visit(st, awaited=False)
                self._try_ctx.pop()
            for st in node.orelse:
                self._visit(st, awaited=False)
            self._try_ctx.append("finally")
            for st in node.finalbody:
                self._visit(st, awaited=False)
            self._try_ctx.pop()
            return
        if isinstance(node, ast.Assign):
            labels = self._expr_taint(node.value)
            sse_expr = any(lb in self.sse_locals or lb == "<decrypt>"
                           for lb in labels)
            for t in node.targets:
                self._bind(t, labels, sse_expr)
                if isinstance(t, ast.Attribute):
                    # stored on an object: ownership escapes
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Name):
                            self.escaped.add(sub.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                and node.value is not None:
            self._bind(node.target, self._expr_taint(node.value), False)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            self._bind(node.target, self._expr_taint(node.iter), False)
            if isinstance(node.iter, ast.Call):
                # `for x in gen(...)` — iterating a generator RUNS its
                # body on this frame (GL10's generator blindness)
                self._iter_calls.add(id(node.iter))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            lockish = None
            for item in node.items:
                segs = chain_segments(item.context_expr)
                if any("lock" in s.lower() for s in segs):
                    lockish = ".".join(segs)
                if isinstance(item.context_expr, ast.Call):
                    self._with_items.add(id(item.context_expr))
                if item.optional_vars is not None:
                    self._bind(item.optional_vars,
                               self._expr_taint(item.context_expr), False)
            if lockish is not None:
                self._lock_stack.append(lockish)
                for item in node.items:
                    self._visit(item.context_expr, awaited=False)
                for child in node.body:
                    self._visit(child, awaited=False)
                self._lock_stack.pop()
                return
        elif isinstance(node, ast.Await):
            if self._lock_stack:
                self.awaits_under_lock.append({
                    "line": node.lineno,
                    "lock": self._lock_stack[-1],
                })
            if isinstance(node.value, ast.Call):
                self._visit_call(node.value, awaited=True)
                for arg in ast.iter_child_nodes(node.value):
                    self._visit(arg, awaited=False)
                return
        elif isinstance(node, ast.Call):
            self._visit_call(node, awaited=awaited)

        for child in ast.iter_child_nodes(node):
            self._visit(child, awaited=False)

    # -- call records -----------------------------------------------------

    def _visit_call(self, node: ast.Call, awaited: bool) -> None:
        ref = _call_ref(node.func)
        segs = chain_segments(node.func)
        name = segs[-1] if segs else ""
        recv = segs[:-1]

        # every Name argument escapes (ownership may transfer)
        for a in list(node.args) + [k.value for k in node.keywords
                                    if k.value is not None]:
            if isinstance(a, ast.Name):
                self.escaped.add(a.id)

        # thread-hop / partial unwrapping: the FIRST callable argument
        # becomes its own edge
        if name in THREAD_HOPS or name == "partial":
            fn_args = node.args
            if name == "run_in_executor" and len(fn_args) >= 2:
                fn_args = fn_args[1:]
            if fn_args:
                inner = _call_ref(fn_args[0])
                if inner is not None:
                    self.calls.append({
                        "ref": inner, "line": node.lineno,
                        "end_line": getattr(node, "end_lineno", node.lineno),
                        "via_thread": name in THREAD_HOPS,
                        "awaited": False, "name": inner[-1],
                        "recv": [], "kwargs": [], "args": [], "kw": {},
                        "ops": [],
                        "ctx": self._try_ctx[-1] if self._try_ctx
                               else "",
                    })

        if ref is None:
            return

        rec = {
            "ref": ref,
            "line": node.lineno,
            "end_line": getattr(node, "end_lineno", node.lineno),
            "via_thread": False,
            "awaited": awaited,
            "name": name,
            "recv": recv,
            "kwargs": sorted(k.arg for k in node.keywords
                             if k.arg is not None),
            "args": [self._arg_desc(a) for a in node.args],
            "kw": {k.arg: self._arg_desc(k.value)
                   for k in node.keywords
                   if k.arg is not None
                   and self._arg_desc(k.value) is not None},
            "ops": _payload_ops(node),
            "ctx": self._try_ctx[-1] if self._try_ctx else "",
        }
        rec["kw"] = {k: v for k, v in rec["kw"].items() if v}
        if id(node) in self._iter_calls:
            rec["iterated"] = True
        self.calls.append(rec)

        # blocking atoms (non-awaited only: an awaited call is a
        # coroutine by definition)
        if not awaited:
            dn = dotted_name(node.func)
            if dn in IO_BLOCKING_CALLS:
                self.blocking.append(
                    {"target": dn, "line": node.lineno, "kind": "io"})
            elif name in DB_METHODS and recv \
                    and _DB_RECEIVER.search(recv[-1]):
                # "ref" lets pass 2 override the receiver-name
                # heuristic with the @blocking_api annotation when the
                # call resolves to an in-project function
                self.blocking.append(
                    {"target": ".".join(segs), "line": node.lineno,
                     "kind": "db", "ref": ref})

        # resource discipline facts
        if name in ACQUIRE_METHODS and recv:
            self.acquires.append({
                "line": node.lineno, "recv": recv[-1],
                "method": name, "awaited": awaited,
                "in_with": id(node) in self._with_items,
                "names": sorted(self._acq_names(
                    {"line": node.lineno, "method": name})),
                "ctx": self._try_ctx[-1] if self._try_ctx else "",
            })
        elif name in RELEASE_METHODS and recv:
            self.releases.append({
                "line": node.lineno, "recv": recv[-1], "method": name,
                "ctx": self._try_ctx[-1] if self._try_ctx else ""})

    def _arg_desc(self, expr: ast.AST) -> Optional[dict]:
        out: dict = {}
        tset = self._expr_taint(expr)
        labels = set(tset) & (set(self.params) | {"<decrypt>"})
        names_in = {sub.id for sub in ast.walk(expr)
                    if isinstance(sub, ast.Name)}
        # "<sse>" marks an argument built from SSE-C state in THIS
        # scope (sse-named param/local or a decrypt result) — the
        # interprocedural rule taints the callee's parameter outright
        if names_in & self.sse_locals or "<decrypt>" in tset:
            labels.add("<sse>")
        if labels:
            out["t"] = sorted(labels)
        if isinstance(expr, ast.Call):
            cn = chain_segments(expr.func)
            if cn and cn[-1] == "RequestStrategy":
                hedge = None
                for k in expr.keywords:
                    if k.arg == "hedge" and isinstance(k.value,
                                                      ast.Constant):
                        hedge = bool(k.value.value)
                out["s"] = {"k": "inline", "hedge": hedge}
        elif isinstance(expr, ast.Name):
            # the bare name itself (GL11v2 matches it against callee
            # release facts to see a resource released one frame down)
            out["n"] = expr.id
            if expr.id in self.local_strategies:
                out["s"] = {"k": "local",
                            "hedge": self.local_strategies[expr.id]}
            elif expr.id in self.params:
                out["s"] = {"k": "param", "name": expr.id}
        return out or None

    def _mark_return_calls(self) -> None:
        """Post-pass annotations that need whole-body context: which
        call records sit inside a `return` expression ("in_ret") and
        which names each call's result was bound to ("bound")."""
        ret_calls: set[tuple] = set()
        for r in self.returns_exprs:
            for sub in ast.walk(r):
                if isinstance(sub, ast.Call):
                    cs = chain_segments(sub.func)
                    if cs:
                        ret_calls.add((sub.lineno, cs[-1]))
        bound: dict[tuple, list] = {}
        for sub in ast.walk(self.node):
            if not isinstance(sub, ast.Assign):
                continue
            v = sub.value
            if isinstance(v, ast.Await):
                v = v.value
            if not isinstance(v, ast.Call):
                continue
            cs = chain_segments(v.func)
            if not cs:
                continue
            names = sorted(t.id for t in sub.targets
                           if isinstance(t, ast.Name))
            if names:
                bound[(v.lineno, cs[-1])] = names
        for rec in self.calls:
            key = (rec["line"], rec["name"])
            if key in ret_calls:
                rec["in_ret"] = True
            if key in bound:
                rec["bound"] = bound[key]

    # -- receiver typing facts --------------------------------

    def _ann_chain(self, ann: Optional[ast.AST]) -> Optional[str]:
        """Dotted chain of a simple annotation: Name / Attribute, a
        string literal forward reference, or Optional[X] unwrapped one
        level. Anything fancier returns None (no fact beats a wrong
        fact)."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            txt = ann.value.strip()
            return txt if txt.replace(".", "").isidentifier() else None
        if isinstance(ann, ast.Subscript):
            segs = chain_segments(ann.value)
            if segs and segs[-1] == "Optional":
                return self._ann_chain(ann.slice)
            return None
        if isinstance(ann, (ast.Name, ast.Attribute)):
            segs = chain_segments(ann)
            return ".".join(segs) if segs else None
        return None

    def _collect_var_types(self) -> None:
        """Local receiver types, best-evidence-last: parameter
        annotations seed the map, `x = Cls(...)` / `x = y` assignments
        overwrite (direct evidence), `isinstance(x, Cls)` guards fill
        gaps only. Pass 2 consults these before unique-method CHA."""
        if isinstance(self.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = self.node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs):
                t = self._ann_chain(arg.annotation)
                if t and arg.arg not in ("self", "cls"):
                    self.var_types[arg.arg] = {"k": "ann", "t": t}
        stack = list(ast.iter_child_nodes(self.node))[::-1]
        guards: list[tuple[str, str]] = []
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                tgt = n.targets[0].id
                if isinstance(n.value, ast.Call):
                    segs = chain_segments(n.value.func)
                    if segs:
                        self.var_types[tgt] = {"k": "call",
                                               "t": ".".join(segs)}
                elif isinstance(n.value, ast.Name):
                    src = self.var_types.get(n.value.id)
                    if src is not None:
                        self.var_types[tgt] = dict(src)
                    else:
                        self.var_types.pop(tgt, None)
                else:
                    # rebound to something we can't type: forget
                    self.var_types.pop(tgt, None)
            elif isinstance(n, ast.Call):
                segs = chain_segments(n.func)
                if segs and segs[-1] == "isinstance" \
                        and len(n.args) == 2 \
                        and isinstance(n.args[0], ast.Name) \
                        and isinstance(n.args[1], (ast.Name,
                                                   ast.Attribute)):
                    t = ".".join(chain_segments(n.args[1]))
                    if t:
                        guards.append((n.args[0].id, t))
            stack.extend(list(ast.iter_child_nodes(n))[::-1])
        for var, t in guards:
            self.var_types.setdefault(var, {"k": "isinstance", "t": t})

    # -- concurrency facts (GL12 / GL13) ---------------------------------

    def _lvalue_of(self, expr: ast.AST) -> Optional[list]:
        """Shared-state lvalue behind an expression: `self.X` (and any
        subscript of it) -> ["self", X]; a module-state name ->
        ["mod", name]. Local names and params are not shared state."""
        e = expr
        while isinstance(e, ast.Subscript):
            e = e.value
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
                and e.value.id in ("self", "cls"):
            return ["self", e.attr]
        if isinstance(e, ast.Name) and e.id in self.module_state:
            return ["mod", e.id]
        return None

    def _collect_concurrency(self) -> None:
        """One extra source-order walk collecting the facts the GL12
        (await-interleaving) and GL13 (lock-order) rules consume:

          * `accesses`: ordered events over shared lvalues — "r" read,
            "w" write (assignment, augmented assignment, del, or a
            mutating container method), "a" await (with the locks held
            and the awaited call's ref), "c" project call (so a write
            performed by a self-call lands at the call line);
          * `lock_acqs`: every lock acquisition (`with`/`async with` on
            a lock-named expression, or a bare `.acquire()` on one)
            with the locks already held at that point.

        The walk linearizes control flow by source order — good enough
        for lint — with two refinements: a `while` loop's test is
        re-emitted after its body, so the guard-loop idiom (await
        inside the loop, condition re-checked before falling through)
        does not read as a stale check; and a loop body containing an
        await is emitted TWICE (the CFG back-edge unrolled once)
        , so a loop-carried race — read late in iteration i, write
        after the await early in iteration i+1 — produces the r/a/w
        sequence GL12 fires on. Duplicate lock_acqs/call events from
        the unroll are harmless: GL12 and GL13 both dedup downstream."""
        for child in ast.iter_child_nodes(self.node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                self._cw_visit(child)

    def _cw_emit(self, kind: str, line: int, lv=None, **extra) -> None:
        ev = {"k": kind, "line": line}
        if lv is not None:
            ev["lv"] = lv
        ev.update(extra)
        self.accesses.append(ev)

    def _cw_lock_token(self, segs: list) -> str:
        """Lock identity token: the attribute path, with a
        local receiver rewritten to its allocation site when known
        (`g = Guard(...); g.lock` -> "<Guard@12>.lock"), so two
        instances of one class stay distinct while two aliases of one
        instance collapse to the same identity."""
        segs = [s for s in segs if s != "acquire"]
        if segs and segs[0] not in ("self", "cls"):
            site = self._cw_alloc.get(segs[0])
            if site is not None:
                return ".".join([f"<{site}>"] + segs[1:])
        return ".".join(segs)

    def _cw_visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # EVERY lock-ish item counts, in order: `with a, b:` is an
            # a -> b acquisition edge (items after the first are taken
            # while the earlier ones are held)
            pushed = 0
            for item in node.items:
                self._cw_visit(item.context_expr)
                segs = chain_segments(item.context_expr)
                if any(LOCK_SEG in s.lower() for s in segs):
                    lock = self._cw_lock_token(segs)
                    self.lock_acqs.append({
                        "lock": lock, "line": node.lineno,
                        "held": list(self._cw_locks),
                        "sync": isinstance(node, ast.With)})
                    self._cw_locks.append(lock)
                    pushed += 1
            for st in node.body:
                self._cw_visit(st)
            for _ in range(pushed):
                self._cw_locks.pop()
            return
        if isinstance(node, ast.While):
            self._cw_visit(node.test)
            # back-edge unroll: a body that awaits is
            # emitted twice so a read late in iteration i meets the
            # write after the await in iteration i+1
            rounds = 2 if any(_contains_await(st)
                              for st in node.body) else 1
            for _ in range(rounds):
                for st in node.body:
                    self._cw_visit(st)
                self._cw_visit(node.test)  # re-evaluated before exit
            for st in node.orelse:
                self._cw_visit(st)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._cw_visit(node.iter)
            rounds = 2 if any(_contains_await(st)
                              for st in node.body) else 1
            for _ in range(rounds):
                for st in node.body:
                    self._cw_visit(st)
            for st in node.orelse:
                self._cw_visit(st)
            return
        if isinstance(node, ast.Assign):
            self._cw_visit(node.value)
            # allocation-site tracking for lock identity
            if len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
                if isinstance(node.value, ast.Call):
                    vsegs = chain_segments(node.value.func)
                    if vsegs and vsegs[-1][:1].isupper():
                        self._cw_alloc[tgt] = \
                            f"{vsegs[-1]}@{node.value.lineno}"
                    else:
                        self._cw_alloc.pop(tgt, None)
                elif isinstance(node.value, ast.Name):
                    site = self._cw_alloc.get(node.value.id)
                    if site is not None:
                        self._cw_alloc[tgt] = site
                    else:
                        self._cw_alloc.pop(tgt, None)
                else:
                    self._cw_alloc.pop(tgt, None)
            # a bare True/False store is idempotent-convergent (every
            # racing task writes the same terminal flag value) — GL12
            # records but does not fire on it
            const_flag = isinstance(node.value, ast.Constant) \
                and node.value.value in (True, False)
            for t in node.targets:
                lv = self._lvalue_of(t)
                if lv is not None:
                    if const_flag and not isinstance(t, ast.Subscript):
                        self._cw_emit("w", t.lineno, lv, flag=True)
                    else:
                        self._cw_emit("w", t.lineno, lv)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    for el in t.elts:
                        elv = self._lvalue_of(el)
                        if elv is not None:
                            self._cw_emit("w", el.lineno, elv)
                if isinstance(t, ast.Subscript):
                    self._cw_visit(t.slice)
            return
        if isinstance(node, ast.AugAssign):
            # read-modify-write: the read precedes the value (CPython
            # loads the target before evaluating the RHS), so an await
            # INSIDE the value still races; but as a callee's write it
            # is accretive (it re-reads at mutation time)
            lv = self._lvalue_of(node.target)
            if lv is not None:
                self._cw_emit("r", node.lineno, lv)
            self._cw_visit(node.value)
            if lv is not None:
                self._cw_emit("w", node.lineno, lv, acc=True)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                lv = self._lvalue_of(t)
                if lv is not None:
                    self._cw_emit("w", t.lineno, lv)
                if isinstance(t, ast.Subscript):
                    self._cw_visit(t.slice)
            return
        if isinstance(node, (ast.Return, ast.Raise)):
            # control leaves this frame: an await here cannot precede
            # a later write in THIS frame, and the awaited callee's
            # writes land after the caller is done deciding
            self._cw_terminal += 1
            for child in ast.iter_child_nodes(node):
                self._cw_visit(child)
            self._cw_terminal -= 1
            if isinstance(node, ast.Return):
                # barrier: any flow that crossed an earlier await ends
                # here, so a textually-later write belongs to a branch
                # that never awaited (`if batch: await ...; return` /
                # `else: write`) — raise is NOT a barrier (exceptional
                # guards between await and write still race)
                self._cw_emit("x", node.lineno, None)
            return
        if isinstance(node, ast.Await):
            ref = None
            if isinstance(node.value, ast.Call):
                # the "a" event carries the ref itself — no separate
                # "c" event, which would wrongly count the awaited
                # callee's writes as landing BEFORE the preemption
                ref = _call_ref(node.value.func)
                self._cw_call(node.value, emit_call=False)
            else:
                self._cw_visit(node.value)
            self._cw_emit("a", node.lineno, None,
                          locks=list(self._cw_locks), call=ref,
                          **({"ret": True} if self._cw_terminal else {}))
            return
        if isinstance(node, ast.Call):
            self._cw_call(node)
            return
        if isinstance(node, ast.Attribute):
            lv = self._lvalue_of(node)
            if lv is not None:
                self._cw_emit("r", node.lineno, lv)
                return
        if isinstance(node, ast.Name):
            lv = self._lvalue_of(node)
            if lv is not None:
                self._cw_emit("r", node.lineno, lv)
            return
        if isinstance(node, ast.Subscript):
            lv = self._lvalue_of(node)
            if lv is not None:
                self._cw_emit("r", node.lineno, lv)
                self._cw_visit(node.slice)
                return
        for child in ast.iter_child_nodes(node):
            self._cw_visit(child)

    def _cw_call(self, node: ast.Call, emit_call: bool = True) -> None:
        segs = chain_segments(node.func)
        name = segs[-1] if segs else ""
        recv_lv = None
        if isinstance(node.func, ast.Attribute):
            recv_lv = self._lvalue_of(node.func.value)
            # receiver chain below the method name still carries reads
            # (`self.peers[p].ring.push(x)` reads self.peers) — but a
            # mutating method ON a tracked lvalue is one atomic write,
            # not a stale read followed by a write
            if recv_lv is None or name not in MUT_METHODS:
                self._cw_visit(node.func.value)
        for a in node.args:
            self._cw_visit(a)
        for k in node.keywords:
            self._cw_visit(k.value)
        db_recv = bool(segs[:-1]) and bool(
            _DB_RECEIVER.search(segs[-2]))
        if recv_lv is not None and name in MUT_METHODS and not db_recv:
            if name in ACCRETIVE_METHODS:
                # re-validating read at mutation time (see above)
                self._cw_emit("r", node.lineno, recv_lv)
                self._cw_emit("w", node.lineno, recv_lv, acc=True)
            else:
                self._cw_emit("w", node.lineno, recv_lv)
        if name == "acquire" and segs[:-1] \
                and any(LOCK_SEG in s.lower() for s in segs[:-1]):
            self.lock_acqs.append({
                "lock": self._cw_lock_token(segs[:-1]),
                "line": node.lineno,
                "held": list(self._cw_locks), "sync": False})
        if not emit_call:
            return
        ref = _call_ref(node.func)
        if ref is not None and name not in MUT_METHODS \
                and (ref[0] in ("self", "name") or self._cw_locks):
            self._cw_emit("c", node.lineno, None, call=ref,
                          held=list(self._cw_locks))

    # -- GL11 support facts ----------------------------------------------
    # (the leak DECISION moved to pass 2 in an earlier change so acquire/release
    # facts can settle across call-graph edges; the collector only
    # records the structural facts the rule consumes)

    def _acq_names(self, acq: dict) -> set:
        """Names the acquired value was bound to (release via the
        value: `lease = broker.acquire(); ...; lease.release()`)."""
        names = set()
        for sub in ast.walk(self.node):
            if not isinstance(sub, ast.Assign):
                continue
            for c in ast.walk(sub.value):
                if isinstance(c, ast.Call) and c.lineno == acq["line"]:
                    cs = chain_segments(c.func)
                    if cs and cs[-1] == acq["method"]:
                        for t in sub.targets:
                            if isinstance(t, ast.Name):
                                names.add(t.id)
        return names

    # -- output -----------------------------------------------------------

    def summary(self, path: str, module: str, nested: dict) -> dict:
        is_async = isinstance(self.node, ast.AsyncFunctionDef)
        name = getattr(self.node, "name", "<lambda>")
        param_return = sorted(
            set().union(*[self._expr_taint(r) for r in self.returns_exprs])
            & set(self.params)) if self.returns_exprs else []
        ret_names = sorted({sub.id for r in self.returns_exprs
                            for sub in ast.walk(r)
                            if isinstance(sub, ast.Name)})
        return {
            "name": name,
            "qualname": self.qualname,
            "class": self.cls or "",
            "parent": self.parent or "",
            "module": module,
            "path": path,
            "line": getattr(self.node, "lineno", 1),
            "is_async": is_async,
            "is_generator": self.is_generator,
            "is_method": bool(self.cls) and bool(self.params)
                         and self.params[0] in ("self", "cls"),
            "params": list(self.params),
            "mutation_name": bool(MUTATION_NAME_RE.search(name)),
            "sse_sources": sorted(self.sse_locals),
            "param_return": param_return,
            "ret_names": ret_names,
            "escaped": sorted(self.escaped),
            "blocking": sorted(self.blocking,
                               key=lambda b: (b["line"], b["target"])),
            "blocking_api": self.blocking_api,
            "calls": self.calls,
            "acquires": self.acquires,
            "releases": self.releases,
            "awaits_under_lock": self.awaits_under_lock,
            "accesses": self.accesses,
            "lock_acqs": self.lock_acqs,
            "alloc_sites": {k: self._cw_alloc[k]
                            for k in sorted(self._cw_alloc)},
            "var_types": {k: self.var_types[k]
                          for k in sorted(self.var_types)},
            "cfg": build_cfg(self.node),
            "nested": {k: nested[k] for k in sorted(nested)},
        }


def _local_strategy_pins(fn: ast.AST) -> dict:
    """name -> hedge pin (True/False/None) for `x = RequestStrategy(...)`
    bindings in this function body."""
    out: dict = {}
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
            segs = chain_segments(sub.value.func)
            if segs and segs[-1] == "RequestStrategy":
                hedge = None
                for k in sub.value.keywords:
                    if k.arg == "hedge" and isinstance(k.value,
                                                      ast.Constant):
                        hedge = bool(k.value.value)
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = hedge
    return out


_MUTABLE_INITS = (ast.Dict, ast.List, ast.Set, ast.Call,
                  ast.DictComp, ast.ListComp, ast.SetComp)


def _top_level_state(tree: ast.Module) -> set:
    """Module-level names bound to mutable-looking values (dict/list/
    set/call/comprehension) — the shared-state census GL09 pioneered,
    reused here so GL12 can track module-global lvalues. Restricted to
    true module scope (no descending into defs/classes)."""
    out: set = set()

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Assign) \
                    and isinstance(child.value, _MUTABLE_INITS):
                for t in child.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
            elif isinstance(child, ast.AnnAssign) \
                    and child.value is not None \
                    and isinstance(child.value, _MUTABLE_INITS) \
                    and isinstance(child.target, ast.Name):
                out.add(child.target.id)
            else:
                walk(child)

    walk(tree)
    return out


def _has_blocking_api_marker(node) -> bool:
    """`@blocking_api` decorator on a def, or a truthy `blocking_api =
    True` class attribute (checked by the caller for ClassDef)."""
    for dec in getattr(node, "decorator_list", []):
        segs = chain_segments(dec)
        if segs and segs[-1] == "blocking_api":
            return True
    return False


def _class_blocking_api(node: ast.ClassDef) -> bool:
    for child in node.body:
        if isinstance(child, ast.Assign):
            for t in child.targets:
                if isinstance(t, ast.Name) and t.id == "blocking_api" \
                        and isinstance(child.value, ast.Constant) \
                        and bool(child.value.value):
                    return True
    return False


def summarize_tree(tree: ast.Module, rel_path: str) -> dict:
    """The whole pass-1 product for one file: module facts (imports,
    classes) + per-function summaries. Pure function of the AST."""
    module = module_name_of(rel_path)
    module_state = _top_level_state(tree)
    # a package __init__ IS its package: `from .core import x` there
    # resolves against the package itself, one level shallower than the
    # same import in a sibling module
    is_package = rel_path.replace("\\", "/").endswith("/__init__.py")
    imports: dict[str, str] = {}
    classes: dict[str, dict] = {}
    functions: dict[str, dict] = {}

    def handle_import(node):
        if isinstance(node, ast.Import):
            for alias in node.names:
                imports[alias.asname or alias.name.split(".")[0]] = \
                    alias.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = module.split(".")
                # `from . import x` in pkg/mod.py: level 1 = pkg;
                # in pkg/__init__.py: level 1 = pkg too (module_name_of
                # already collapsed the __init__ component)
                drop = node.level - 1 if is_package else node.level
                if drop:
                    parts = parts[: len(parts) - drop]
                base = ".".join(parts + ([node.module]
                                         if node.module else []))
            for alias in node.names:
                if alias.name == "*":
                    continue
                imports[alias.asname or alias.name] = \
                    f"{base}.{alias.name}" if base else alias.name

    def walk_scope(node, class_stack: list[str],
                   parent_fn: Optional[str]) -> dict:
        """Returns {bare_name: qualname} of functions defined directly
        in this scope (the caller's name-resolution context)."""
        own: dict[str, str] = {}
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                handle_import(child)
            elif isinstance(child, ast.ClassDef):
                cname = ".".join(class_stack + [child.name])
                classes[cname] = {
                    "bases": sorted(
                        s for b in child.bases
                        for s in [".".join(chain_segments(b))] if s),
                    "methods": {},
                    "line": child.lineno,
                    "blocking_api": _class_blocking_api(child),
                }
                methods = walk_scope(child, class_stack + [child.name],
                                     None)
                classes[cname]["methods"] = {
                    k.rsplit(".", 1)[-1]: v for k, v in methods.items()}
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                qn = (f"{parent_fn}.{child.name}" if parent_fn
                      else ".".join(class_stack + [child.name]))
                coll = _FunctionCollector(
                    child, qn,
                    cls=".".join(class_stack) if class_stack else None,
                    parent=parent_fn,
                    strategies=_local_strategy_pins(child),
                    module_state=module_state)
                coll.blocking_api = _has_blocking_api_marker(child)
                coll.run()
                nested = walk_scope(child, [], qn)
                functions[qn] = coll.summary(rel_path, module, {
                    k.rsplit(".", 1)[-1]: v for k, v in nested.items()})
                own[child.name] = qn
            else:
                # module-level statements may nest defs inside
                # try/if blocks; recurse without changing scope kind
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef, ast.Lambda)):
                    own.update(walk_scope(child, class_stack, parent_fn))
        return own

    top = walk_scope(tree, [], None)
    return {
        "module": module,
        "path": rel_path,
        "imports": {k: imports[k] for k in sorted(imports)},
        "classes": {k: classes[k] for k in sorted(classes)},
        "top_functions": {k: top[k] for k in sorted(top)},
        "functions": {k: functions[k] for k in sorted(functions)},
    }


def summary_fingerprint(source: str) -> str:
    return hashlib.sha256(source.encode("utf-8", "replace")).hexdigest()


def summary_json(file_summary: dict) -> str:
    """Canonical byte form (the determinism + cache contract)."""
    return json.dumps(file_summary, sort_keys=True, separators=(",", ":"))


class DataflowState:
    """Pass-1 product for a whole project: file summaries (cache-aware)
    plus the resolved call graph. Built once per analyze run, shared by
    every `needs_dataflow` rule via project.data["_dataflow"]."""

    def __init__(self, file_contexts, summary_cache: Optional[dict] = None):
        from .callgraph import CallGraph

        cache = summary_cache or {}
        self.summaries: dict[str, dict] = {}
        self.fingerprints: dict[str, str] = {}
        self.cache_hits = 0
        for ctx in file_contexts:
            fp = summary_fingerprint(ctx.source)
            self.fingerprints[ctx.rel_path] = fp
            ent = cache.get(ctx.rel_path)
            # the engine version gates reuse too: CI's restore-keys
            # fallback serves a PREVIOUS tree's cache after any
            # analyzer change, and per-file hashes alone would then
            # happily feed old-schema summaries to new rules
            if ent is not None and ent.get("sha256") == fp \
                    and ent.get("v") == SUMMARY_VERSION:
                self.summaries[ctx.rel_path] = ent["summary"]
                self.cache_hits += 1
            else:
                self.summaries[ctx.rel_path] = summarize_tree(
                    ctx.tree, ctx.rel_path)
        self.graph = CallGraph(self.summaries)

    def cache_payload(self) -> dict:
        """What --summary-cache persists: per-file hash + engine
        version + summary."""
        return {rel: {"sha256": self.fingerprints[rel],
                      "v": SUMMARY_VERSION, "summary": s}
                for rel, s in sorted(self.summaries.items())}
