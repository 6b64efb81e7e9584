"""Port of garage_tpu/analysis/rules_project.py: GL09's request-plane
directories are the port's (`garage_tpu_torch/api/` ...), not the JAX
package's; the rest is the JAX module with its issue and PR tags
dropped.

Project-contract rules: GL07 unregistered-metric, GL08
config-knob-drift.

GL07 keeps the metric namespace auditable: every name handed to the
metrics registry must be a string LITERAL matching the
`<subsystem>_<snake_case>` scheme (regex shared with the runtime check
in utils/metrics.py, which rejects the same violations at registration
time under GARAGE_METRICS_STRICT=1 — the static rule and the runtime
agree by construction). A dynamically built name is flagged outright:
unbounded name cardinality is a slow memory leak and makes dashboards
unwriteable.

GL08 is the only genuinely cross-file rule: it parses the config
dataclasses out of utils/config.py during the normal pass and, in
finish_project, reconciles them against every `cfg.X` / `config.X` /
`cfg.<section>.Y` read in the tree — a knob read in code but absent
from the defaults is a typo that silently yields AttributeError at
runtime; a default that nothing reads and the README never mentions is
dead weight (or a feature that quietly lost its wiring).
"""

from __future__ import annotations

import ast
import re

from ..utils.metrics import METRIC_NAME_RE
from .core import (FileContext, ProjectState, Rule, Violation, call_name,
                   chain_segments, is_const)

# ---- GL07 --------------------------------------------------------------

METRIC_METHODS = {"inc", "observe", "timer"}
METRIC_RECEIVERS = {"registry", "metrics_registry"}


class UnregisteredMetric(Rule):
    id = "GL07"
    name = "unregistered-metric"
    summary = ("metric name is dynamic or breaks the "
               "<subsystem>_<snake_case> scheme; the runtime strict "
               "check (utils/metrics.py) enforces the same regex")
    rationale = (
        "Dynamically built metric names are unbounded cardinality — a "
        "slow memory leak and an ungreppable dashboard. Names must be "
        "string literals matching the shared METRIC_NAME_RE; the "
        "runtime rejects the same names at registration under "
        "GARAGE_METRICS_STRICT=1, so the static and runtime checks "
        "agree by construction. Runs on harness files (bench emits "
        "metric names into reports).")
    example_fire = 'registry().inc(f"qos_{key}_total")   # per-key series'
    example_ok = 'registry().inc("qos_shed_requests", scope=key)'

    def applies_to(self, ctx: FileContext) -> bool:
        # the registry implementation itself passes names through
        return (not ctx.is_test
                and not ctx.rel_path.endswith("utils/metrics.py"))

    def on_call(self, node: ast.Call, ctx: FileContext) -> None:
        segs = chain_segments(node.func)
        if len(segs) < 2 or segs[-1] not in METRIC_METHODS:
            return
        if not any(s in METRIC_RECEIVERS for s in segs[:-1]):
            return
        if not node.args:
            return
        name = node.args[0]
        if not (is_const(name) and isinstance(name.value, str)):
            ctx.report(self.id, node,
                       f"dynamically constructed metric name passed to "
                       f"`{segs[-1]}`; metric names must be string "
                       "literals (bounded cardinality, greppable)")
            return
        if not METRIC_NAME_RE.match(name.value):
            ctx.report(self.id, node,
                       f"metric name {name.value!r} violates the "
                       f"naming scheme {METRIC_NAME_RE.pattern!r}")


# ---- GL08 --------------------------------------------------------------

CONFIG_RECEIVERS = {"cfg", "config"}
SECTION_ATTRS = {"tpu": "TpuConfig", "qos": "QosConfig",
                 "chaos": "ChaosConfig", "gateway": "GatewayConfig"}
CONFIG_CLASSES = ("Config", "TpuConfig", "QosConfig", "ChaosConfig",
                  "GatewayConfig", "DataDir")


def _config_receiver(node: ast.AST) -> bool:
    """`cfg` / `config` / `self.cfg` / `self.config` / `<x>.config`
    where the FINAL segment is the config name (never e.g.
    website_config)."""
    if isinstance(node, ast.Name):
        return node.id in CONFIG_RECEIVERS
    if isinstance(node, ast.Attribute):
        return node.attr in CONFIG_RECEIVERS
    return False


class ConfigKnobDrift(Rule):
    id = "GL08"
    name = "config-knob-drift"
    summary = ("config key read in code but absent from utils/config.py "
               "defaults, or a default that nothing reads and the "
               "README never documents")
    rationale = (
        "Both directions of knob drift are silent failures: a key "
        "read in code with no default is an AttributeError waiting "
        "for the one deployment that exercises it; a default nothing "
        "reads is a feature that quietly lost its wiring (found "
        "two: metadata_fsync ignored, [tpu] batch_blocks dead). The "
        "rule reconciles every cfg.X / section alias / getattr read "
        "against the dataclass schema, cross-file.")
    example_fire = "return cfg.block_sizze    # typo: not a Config field"
    example_ok = "return cfg.block_size"

    def applies_to(self, ctx: FileContext) -> bool:
        return not ctx.is_test

    def __init__(self):
        # (attr, ctx_rel, lineno, col, qualname) for top-level reads;
        # section reads keyed by section name
        self.top_reads: list[tuple] = []
        self.section_reads: list[tuple] = []
        self.config_ctx: FileContext | None = None
        self.string_constants: set[str] = set()

    def finish_file(self, ctx: FileContext) -> None:
        """GL08 collects per-file in its own walk (it needs two
        ordered passes — alias discovery, then reads — which the
        shared single dispatch can't provide)."""
        if ctx.rel_path.endswith("utils/config.py"):
            self.config_ctx = ctx
            is_schema = True
        else:
            is_schema = False
        method_funcs: set[int] = set()
        # names locally bound to a config SECTION:  qc = cfg.qos
        aliases: dict[str, str] = {}
        for sub in ast.walk(ctx.tree):
            if isinstance(sub, ast.Constant) and isinstance(sub.value,
                                                            str):
                self.string_constants.add(sub.value)
            elif isinstance(sub, ast.Call):
                # knobs are data, never called: `cfg.get(...)` is a
                # dict named cfg, not a knob read
                method_funcs.add(id(sub.func))
                if not is_schema and call_name(sub) == "getattr" \
                        and len(sub.args) >= 2 \
                        and isinstance(sub.args[0], ast.Name) \
                        and sub.args[0].id in CONFIG_RECEIVERS \
                        and is_const(sub.args[1]) \
                        and isinstance(sub.args[1].value, str):
                    self.top_reads.append(
                        (sub.args[1].value, ctx.rel_path, sub.lineno,
                         sub.col_offset, "<getattr>"))
            elif isinstance(sub, ast.Assign) \
                    and isinstance(sub.value, ast.Attribute) \
                    and sub.value.attr in SECTION_ATTRS \
                    and _config_receiver(sub.value.value):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        aliases[t.id] = sub.value.attr
                    elif isinstance(t, ast.Attribute):
                        # self.qos_cfg = cfg.qos — alias by attr name
                        aliases[t.attr] = sub.value.attr
        if is_schema:
            return  # the schema module reads itself freely
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Attribute) \
                    or isinstance(node.ctx, (ast.Store, ast.Del)) \
                    or id(node) in method_funcs:
                continue
            at = (node.lineno, node.col_offset)
            v = node.value
            if _config_receiver(v):
                self.top_reads.append((node.attr, ctx.rel_path, *at,
                                       "<module>"))
            elif isinstance(v, ast.Attribute) and v.attr in SECTION_ATTRS \
                    and _config_receiver(v.value):
                self.section_reads.append((v.attr, node.attr,
                                           ctx.rel_path, *at, "<module>"))
            elif isinstance(v, ast.Name) and v.id in aliases:
                self.section_reads.append((aliases[v.id], node.attr,
                                           ctx.rel_path, *at, "<module>"))
            elif isinstance(v, ast.Attribute) and v.attr in aliases \
                    and isinstance(v.value, ast.Name) \
                    and v.value.id == "self":
                self.section_reads.append((aliases[v.attr], node.attr,
                                           ctx.rel_path, *at, "<module>"))

    def finish_project(self, project: ProjectState) -> list[Violation]:
        if self.config_ctx is None:
            return []  # fixture runs without the schema in scope
        schema = _parse_config_schema(self.config_ctx.tree)
        readme = project.data.get("readme_text", "")
        out: list[Violation] = []
        top_fields, top_extra, field_lines = schema["Config"]
        known_top = top_fields | top_extra | set(SECTION_ATTRS)
        for attr, rel, line, col, qual in self.top_reads:
            if attr.startswith("_") or attr in known_top:
                continue
            out.append(Violation(
                rule=self.id, path=rel, line=line, col=col,
                message=f"config key `{attr}` read here but not a "
                        "Config field in utils/config.py (typo or "
                        "missing default)", context=qual))
        for section, attr, rel, line, col, qual in self.section_reads:
            fields, extra, _ = schema[SECTION_ATTRS[section]]
            if attr.startswith("_") or attr in fields | extra:
                continue
            out.append(Violation(
                rule=self.id, path=rel, line=line, col=col,
                message=f"config key `{section}.{attr}` read here but "
                        f"not a {SECTION_ATTRS[section]} field in "
                        "utils/config.py", context=qual))
        # reverse direction: dead defaults
        read_top = {a for a, *_ in self.top_reads}
        read_sec = {(s, a) for s, a, *_ in self.section_reads}
        for cls, prefix in [("Config", "")] + [
                (c, s + ".") for s, c in SECTION_ATTRS.items()]:
            fields, _, lines = schema[cls]
            for f in sorted(fields):
                used = (f in read_top if not prefix
                        else (prefix[:-1], f) in read_sec)
                if used or f in self.string_constants \
                        or re.search(rf"\b{re.escape(f)}\b", readme):
                    continue
                out.append(Violation(
                    rule=self.id, path=self.config_ctx.rel_path,
                    line=lines.get(f, 1), col=0,
                    message=f"config default `{prefix}{f}` is never "
                            "read in code, as a string constant, or "
                            "documented in README (dead knob?)",
                    context=cls))
        return out


# ---- GL09 --------------------------------------------------------------

# request-plane packages where module-level mutable state is
# process-local but SEMANTICALLY node-wide: with the multi-process
# gateway, N workers each get their own copy of such state, so counters
# silently read 1/N, caches duplicate, and limits admit N× (exactly the
# bug class an earlier change creates). Node-wide state must live on an instance
# wired through Garage (one per process, aggregated by the supervisor)
# or be brokered (the qos lease protocol).
CROSS_WORKER_DIRS = ("api/", "qos/", "gateway/", "web/")

MUTATING_METHODS = {"append", "extend", "add", "update", "pop",
                    "popitem", "clear", "remove", "discard",
                    "setdefault", "insert", "appendleft", "__setitem__"}

MUTABLE_CONSTRUCTORS = {"dict", "list", "set", "OrderedDict",
                        "defaultdict", "deque", "Counter", "bytearray"}


class CrossWorkerState(Rule):
    id = "GL09"
    name = "cross-worker-state"
    summary = ("module-level mutable state in a request-plane package "
               "mutated from function scope: process-local but "
               "semantically node-wide — each gateway worker gets its "
               "own copy (counters read 1/N, limits admit N×)")
    rationale = (
        "Under the multi-process gateway every worker holds "
        "its own copy of module-level state in api/ qos/ gateway/ "
        "web/ — counters silently read 1/N, caches duplicate, limits "
        "admit N×. Node-wide state belongs on instances wired "
        "through Garage (aggregated by the supervisor) or leased via "
        "the broker. Read-only lookup tables and import-time "
        "construction are exempt.")
    example_fire = ("PENDING = {}\n"
                    "async def handle(req):\n"
                    "    PENDING[req.id] = req   # per-worker copy")
    example_ok = ("STATUS = {200: 'OK'}          # read-only table\n"
                  "def reason(code):\n"
                  "    return STATUS.get(code)")

    def applies_to(self, ctx: FileContext) -> bool:
        if ctx.is_test:
            return False
        rel = ctx.rel_path
        for d in CROSS_WORKER_DIRS:
            if f"garage_tpu_torch/{d}" in rel or rel.startswith(d):
                return True
        return False

    def finish_file(self, ctx: FileContext) -> None:
        # 1) module-level names bound to mutable containers
        mutable: dict[str, ast.AST] = {}
        for stmt in ctx.tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = [t for t in stmt.targets
                           if isinstance(t, ast.Name)]
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and stmt.value is not None:
                targets = [stmt.target]
                value = stmt.value
            else:
                continue
            is_mut = isinstance(value, (ast.Dict, ast.List, ast.Set)) \
                or (isinstance(value, ast.Call)
                    and call_name(value) in MUTABLE_CONSTRUCTORS)
            if not is_mut:
                continue
            for t in targets:
                mutable[t.id] = stmt
        if not mutable:
            return
        # 2) ... that any function in the module mutates. Module-level
        # init-time mutation (building a constant table at import) is
        # fine; mutation from function scope is cross-request state.
        flagged: set[str] = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            for sub in _walk_own_scope(fn):
                name = None
                if isinstance(sub, (ast.Assign, ast.AugAssign,
                                    ast.Delete)):
                    tgts = (sub.targets
                            if isinstance(sub, (ast.Assign, ast.Delete))
                            else [sub.target])
                    for t in tgts:
                        if isinstance(t, ast.Subscript) \
                                and isinstance(t.value, ast.Name):
                            name = t.value.id
                elif isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in MUTATING_METHODS \
                        and isinstance(sub.func.value, ast.Name):
                    name = sub.func.value.id
                if name in mutable and name not in flagged \
                        and name not in _locally_bound(fn, name):
                    flagged.add(name)
                    ctx.report(
                        self.id, mutable[name],
                        f"module-level mutable `{name}` is mutated "
                        f"from `{fn.name}`: process-local state that "
                        "reads as node-wide — under the multi-process "
                        "gateway every worker holds its own copy. "
                        "Move it onto an instance wired through "
                        "Garage, or lease/aggregate it via gateway/")

    def finish_project(self, project: ProjectState) -> list[Violation]:
        return []


def _walk_own_scope(fn: ast.AST):
    """Walk fn's body WITHOUT descending into nested def/lambda scopes
    — a nested function's locals and mutations belong to the nested
    function's own check, and letting them leak into the enclosing
    scope both hides real module-state mutations (a nested
    `NAME = {}` would shadow NAME for the whole outer body) and
    invents false ones."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _locally_bound(fn: ast.AST, name: str) -> set[str]:
    """Names shadowed inside fn (params or direct assignment) — a local
    `queues = {}` mutated in the same function is not module state. An
    explicit `global` declaration un-shadows: that IS module state.
    Nested def/lambda scopes are excluded (their locals are theirs)."""
    bound: set[str] = set()
    declared_global: set[str] = set()
    args = fn.args
    for a in (args.args + args.kwonlyargs + args.posonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        bound.add(a.arg)
    for sub in _walk_own_scope(fn):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    bound.add(t.id)
        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)) \
                and isinstance(sub.target, ast.Name):
            bound.add(sub.target.id)
        elif isinstance(sub, ast.Global):
            declared_global |= set(sub.names)
    bound -= declared_global
    return bound if name in bound else set()


def _parse_config_schema(tree: ast.Module) -> dict:
    """Per config class: ({fields}, {properties+methods}, {field: line})
    straight from the dataclass AST."""
    out = {c: (set(), set(), {}) for c in CONFIG_CLASSES}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef)
                and node.name in CONFIG_CLASSES):
            continue
        fields, extra, lines = out[node.name]
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                fields.add(stmt.target.id)
                lines[stmt.target.id] = stmt.lineno
            elif isinstance(stmt, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                extra.add(stmt.name)
    return out
