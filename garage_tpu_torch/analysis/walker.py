"""Copy of garage_tpu/analysis/walker.py: import paths rewritten, issue and PR tags dropped.

Single-pass multi-rule AST walker with scope / async-context tracking.

One recursive traversal per file; every rule's hooks are dispatched
from that same pass (Infer/RacerD-style compositional per-file
analysis — cross-file rules accumulate into ProjectState and settle in
finish_project). The walker owns ALL context bookkeeping: function and
class stacks, async-ness, async-with-lock frames, and a per-function
scratch dict with the cheap "dataflow" rules need (argument names,
assigned locals, RequestStrategy bindings) so each rule stays a few
lines of pattern matching.
"""

from __future__ import annotations

import ast
import os

from .core import (FileContext, META_RULE, ProjectState, Rule, Violation,
                   call_name, chain_segments)

# directory/file names never scanned (fixtures feed the self-tests
# violations on purpose)
EXCLUDE_DIRS = {"__pycache__", ".git", "fixtures"}

# harness files (FileContext.is_harness: clusterbox / conftest / bench)
# run exactly this subset — harness code orphaning tasks or swallowing
# exceptions silently corrupts chaos-soak verdicts, but the
# production-invariant rules (async hygiene, hedge/SSE-C flow, config
# drift) do not apply to driver code (satellite)
HARNESS_RULES = {"GL04", "GL05", "GL07"}

LOCK_HINT = "lock"


def _looks_like_lock(expr: ast.AST) -> bool:
    """The context expression of an `async with` names a lock: any
    identifier segment containing 'lock' (self._require_lock,
    write_lock(), state.lock)."""
    return any(LOCK_HINT in seg.lower() for seg in chain_segments(expr))


def _function_meta(node: ast.AST) -> dict:
    """Scratch facts about one function body, collected once on entry:
    names bound (args + assignment targets), and simple
    `name = RequestStrategy(...)` bindings so call sites can resolve a
    locally built strategy."""
    args: set[str] = set()
    assigned: set[str] = set()
    strategies: dict[str, ast.Call] = {}
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = node.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else [])):
            args.add(arg.arg)
    for sub in ast.walk(node):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    assigned.add(t.id)
                    if isinstance(sub.value, ast.Call) and \
                            call_name(sub.value) == "RequestStrategy":
                        strategies[t.id] = sub.value
        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(sub.target, ast.Name):
                assigned.add(sub.target.id)
        elif isinstance(sub, (ast.For, ast.AsyncFor)):
            if isinstance(sub.target, ast.Name):
                assigned.add(sub.target.id)
        elif isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                if isinstance(item.optional_vars, ast.Name):
                    assigned.add(item.optional_vars.id)
    return {"args": args, "assigned": assigned, "strategies": strategies}


class FileAnalyzer:
    """Runs every applicable rule over one file in a single traversal."""

    def __init__(self, rules: list[Rule]):
        self.rules = rules

    def run(self, ctx: FileContext) -> None:
        """Single traversal; waiver application is the CALLER's step
        (after cross-file rules settle, so their violations are
        waivable too)."""
        if ctx.is_harness:
            rules = [r for r in self.rules if r.id in HARNESS_RULES]
        else:
            rules = [r for r in self.rules if r.applies_to(ctx)]
        if not rules:
            return
        hooks = {
            "call": [r for r in rules if hasattr(r, "on_call")],
            "await": [r for r in rules if hasattr(r, "on_await")],
            "expr": [r for r in rules if hasattr(r, "on_expr_stmt")],
            "except": [r for r in rules if hasattr(r, "on_except")],
            "function": [r for r in rules if hasattr(r, "on_function")],
            "attribute": [r for r in rules if hasattr(r, "on_attribute")],
        }
        self._visit(ctx.tree, ctx, hooks)
        for r in rules:
            r.finish_file(ctx)

    def _visit(self, node: ast.AST, ctx: FileContext, hooks: dict) -> None:
        push_func = push_class = push_lock = False
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ctx.func_stack.append(
                (node, node.name, isinstance(node, ast.AsyncFunctionDef),
                 _function_meta(node)))
            push_func = True
            for r in hooks["function"]:
                r.on_function(node, ctx)
        elif isinstance(node, ast.Lambda):
            # a lambda body is a sync scope (GL01's to_thread escape)
            ctx.func_stack.append((node, "<lambda>", False, {}))
            push_func = True
        elif isinstance(node, ast.ClassDef):
            ctx.class_stack.append(node.name)
            push_class = True
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            # sync `with lock():` counts too: a threading
            # lock held across an await inside an async frame blocks
            # every other task on the loop exactly like an async lock
            if any(_looks_like_lock(item.context_expr)
                   for item in node.items):
                ctx.lock_stack.append(node)
                push_lock = True
        elif isinstance(node, ast.Call):
            for r in hooks["call"]:
                r.on_call(node, ctx)
        elif isinstance(node, ast.Await):
            for r in hooks["await"]:
                r.on_await(node, ctx)
        elif isinstance(node, ast.Expr):
            for r in hooks["expr"]:
                r.on_expr_stmt(node, ctx)
        elif isinstance(node, ast.ExceptHandler):
            for r in hooks["except"]:
                r.on_except(node, ctx)
        elif isinstance(node, ast.Attribute):
            for r in hooks["attribute"]:
                r.on_attribute(node, ctx)

        for child in ast.iter_child_nodes(node):
            self._visit(child, ctx, hooks)

        if push_func:
            ctx.func_stack.pop()
        if push_class:
            ctx.class_stack.pop()
        if push_lock:
            ctx.lock_stack.pop()


def iter_python_files(paths: list[str]) -> list[str]:
    out = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in EXCLUDE_DIRS)
            for f in sorted(filenames):
                if f.endswith(".py"):
                    out.append(os.path.join(dirpath, f))
    return out


def _needs_dataflow(rules: list[Rule]) -> bool:
    return any(getattr(r, "needs_dataflow", False) for r in rules)


def _build_dataflow(project: ProjectState, rules: list[Rule]) -> None:
    """Pass 1 of the interprocedural engine: per-function
    summaries + call graph, shared by every needs_dataflow rule.
    Cache-aware: project.data["summary_cache"] (loaded by the CLI from
    --summary-cache) short-circuits the summary walk for files whose
    hash is unchanged."""
    if not _needs_dataflow(rules):
        return
    files = [c for c in project.files if c.tree is not None]
    if "_dataflow" in project.data \
            and project.data.get("_dataflow_files") == len(files):
        return
    from .dataflow import DataflowState

    project.data["_dataflow"] = DataflowState(
        files, summary_cache=project.data.get("summary_cache"))
    project.data["_dataflow_files"] = len(files)


def _settle_project(project: ProjectState, rules: list[Rule],
                    restricted: bool = False) -> list[Violation]:
    """Run cross-file rules, attach their violations to the owning
    file context (so they are waivable at the line they land on), then
    apply waivers everywhere. Returns violations that matched no
    scanned file (stray). `restricted` marks a --rules subset run:
    waivers for rules that did not run are exempt from the staleness
    check (a full run still checks every waiver, typos included)."""
    _build_dataflow(project, rules)
    by_rel = {c.rel_path: c for c in project.files}
    # idempotent under re-settling: a repeated finish_project (shared
    # project across analyze_source calls) must not duplicate findings
    seen = {v.key() for c in project.files for v in c.violations}
    stray: list[Violation] = []
    for r in rules:
        for v in r.finish_project(project):
            if v.key() in seen:
                continue
            seen.add(v.key())
            ctx = by_rel.get(v.path)
            if ctx is not None:
                ctx.violations.append(v)
            else:
                stray.append(v)
    active = {r.id for r in rules} if restricted else None
    for c in project.files:
        c.apply_waivers(active_rules=active)
    return stray


def analyze_source(source: str, rules: list[Rule],
                   rel_path: str = "<memory>.py",
                   project: ProjectState | None = None) -> FileContext:
    """Analyze one in-memory module (the fixture-test entry point)
    through the FULL pipeline, cross-file/dataflow rules included —
    the mini-project contains just this file. Parse failures surface
    as a GL00 violation, never an exception."""
    if project is None:
        project = ProjectState()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        ctx = FileContext(rel_path, rel_path, "", ast.Module(body=[],
                                                             type_ignores=[]))
        ctx.tree = None
        ctx.violations.append(Violation(
            rule=META_RULE, path=rel_path, line=e.lineno or 1,
            col=e.offset or 0, message=f"unparseable: {e.msg}"))
        project.files.append(ctx)
        return ctx
    ctx = FileContext(rel_path, rel_path, source, tree)
    FileAnalyzer(rules).run(ctx)
    project.files.append(ctx)
    _settle_project(project, rules)
    return ctx


def analyze_paths(paths: list[str], rules: list[Rule],
                  root: str | None = None,
                  data: dict | None = None,
                  restricted: bool = False) -> tuple[list[Violation],
                                                     ProjectState]:
    """Analyze every .py under `paths`; returns (violations, project).
    Violations include waived/baselined-candidate ones — the caller
    filters on .active after baseline matching. `data` seeds
    ProjectState.data (e.g. readme_text for GL08)."""
    root = os.path.abspath(root or os.path.commonpath(
        [os.path.abspath(p) for p in paths]) if paths else ".")
    if os.path.isfile(root):
        root = os.path.dirname(root)
    project = ProjectState(root=root, data=dict(data or {}))
    for path in iter_python_files(paths):
        ap = os.path.abspath(path)
        rel = os.path.relpath(ap, root).replace(os.sep, "/")
        try:
            with open(ap, "r", encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as e:
            project.files.append(_error_ctx(rel, f"unreadable: {e}"))
            continue
        try:
            tree = ast.parse(source, filename=ap)
        except SyntaxError as e:
            project.files.append(_error_ctx(
                rel, f"unparseable: {e.msg}", e.lineno or 1))
            continue
        ctx = FileContext(ap, rel, source, tree)
        FileAnalyzer(rules).run(ctx)
        project.files.append(ctx)
    # cross-file rules settle BEFORE waivers, so their violations are
    # waivable at the line they land on (e.g. a config.py field read
    # only via getattr carries its own inline waiver)
    stray = _settle_project(project, rules, restricted=restricted)
    violations = [v for c in project.files for v in c.violations] + stray
    violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return violations, project


def _error_ctx(rel: str, msg: str, line: int = 1) -> FileContext:
    ctx = FileContext(rel, rel, "", ast.Module(body=[], type_ignores=[]))
    ctx.violations.append(Violation(rule=META_RULE, path=rel, line=line,
                                    col=0, message=msg))
    return ctx
