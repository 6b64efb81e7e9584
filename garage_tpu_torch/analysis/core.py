"""Port of garage_tpu/analysis/core.py: `FileContext.is_harness` also
names `chip_smoke.py`, the port's harness on the card (it plays the
part that `bench.py` plays for the JAX package); the rest is the JAX
module with its issue and PR tags dropped.

garage-lint core: violations, waivers, rule base class.

Project-invariant static analysis. Every rule here encodes an
invariant that an earlier PR established by hand and that nothing else
enforces: blocking work leaves the event loop, non-idempotent
RPCs never hedge, SSE-C plaintext never enters the read cache
, background tasks are retained and cancelled orphan-free,
exceptions are not silently swallowed (Yuan et al., OSDI '14 —
"Simple Testing Can Prevent Most Critical Failures": the majority of
catastrophic distributed-storage failures traced to exactly the
error-handling stubs GL05 flags).

Stdlib-only by design (`ast` + `re`): the repo's optional-dependency
discipline applies to its own tooling.

Waiver syntax, checked by the framework itself::

    risky_call()  # lint: ignore[GL05] reason the invariant is upheld

A waiver must carry a reason, must name a rule that actually fires on
that statement, and a waiver that no longer suppresses anything is
itself an error (GL00) — suppressions cannot rot silently.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Optional

# GL00 is the framework's own hygiene rule: stale or malformed waivers,
# stale baseline entries, unparseable files. It cannot be waived.
META_RULE = "GL00"

WAIVER_RE = re.compile(
    r"#\s*lint:\s*ignore\[([A-Za-z0-9,\s]+)\]\s*(.*)$")


@dataclass
class Violation:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    col: int
    message: str
    context: str = "<module>"   # enclosing def/class qualname
    waived: bool = False
    baselined: bool = False

    @property
    def active(self) -> bool:
        return not (self.waived or self.baselined)

    def key(self) -> tuple:
        return (self.rule, self.path, self.line, self.col, self.message)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message,
            "context": self.context, "waived": self.waived,
            "baselined": self.baselined,
        }

    def render(self) -> str:
        flag = " (waived)" if self.waived else \
            " (baselined)" if self.baselined else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.message}{flag}")


@dataclass
class Waiver:
    line: int
    rules: tuple[str, ...]
    reason: str
    used: bool = False
    # which of `rules` actually suppressed something — staleness is
    # per-rule since an earlier change, so a combined GL05+GL07 waiver with
    # only GL05 firing reports GL07 stale instead of staying silent
    used_rules: set = field(default_factory=set)


def extract_waivers(source: str) -> list[Waiver]:
    """Waivers live in real COMMENT tokens only — a waiver example
    inside a docstring is prose, not a suppression (tokenize, not a
    line regex, so strings can't fool it)."""
    out = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = WAIVER_RE.search(tok.string)
            if m:
                rules = tuple(r.strip().upper()
                              for r in m.group(1).split(",") if r.strip())
                out.append(Waiver(line=tok.start[0], rules=rules,
                                  reason=m.group(2).strip()))
    except (tokenize.TokenizeError, SyntaxError, IndentationError):
        pass  # unparseable files already surface as GL00
    return out


class FileContext:
    """Per-file state shared by all rules during the single AST pass.

    The walker maintains the scope stacks; rules read them and call
    report(). Waiver application happens after the pass, in
    apply_waivers(), so a rule never needs waiver logic of its own.
    """

    def __init__(self, path: str, rel_path: str, source: str,
                 tree: ast.Module):
        self.path = path
        self.rel_path = rel_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.waivers = extract_waivers(source)
        self.violations: list[Violation] = []
        # scope stacks, maintained by the walker
        # frames: (node, name, is_async, meta-dict)
        self.func_stack: list[tuple[ast.AST, str, bool, dict]] = []
        self.class_stack: list[str] = []
        # with / async-with frames whose context expression names a
        # lock (GL06 learned sync `with lock():` in an earlier change — a
        # threading lock held across an await serializes waiters just
        # the same)
        self.lock_stack: list[ast.AST] = []

    # ---- scope queries --------------------------------------------------

    @property
    def is_test(self) -> bool:
        parts = self.rel_path.split("/")
        name = parts[-1]
        return ("tests" in parts or name.startswith("test_")
                or name == "conftest.py")

    @property
    def is_harness(self) -> bool:
        """Test-infrastructure files that opt into a scoped rule
        subset (GL04/GL05/GL07): the cluster-in-a-box harness, the
        shared conftest, the bench driver and the card's smoke script —
        harness code orphaning tasks or swallowing exceptions silently
        corrupts chaos-soak verdicts."""
        name = self.rel_path.split("/")[-1]
        return name in ("clusterbox.py", "conftest.py", "bench.py",
                        "chip_smoke.py")

    @property
    def in_async_def(self) -> bool:
        """True when the INNERMOST function frame is async — a blocking
        call inside a nested sync def/lambda runs off-loop (that is the
        asyncio.to_thread pattern) and must not fire GL01."""
        if not self.func_stack:
            return False
        return self.func_stack[-1][2]

    @property
    def func_meta(self) -> dict:
        """Per-function scratch dict (arg names, local assigns, strategy
        bindings) prepared by the walker on function entry."""
        return self.func_stack[-1][3] if self.func_stack else {}

    def qualname(self) -> str:
        names = list(self.class_stack)
        names += [n for _, n, _, _ in self.func_stack]
        return ".".join(names) if names else "<module>"

    # ---- reporting ------------------------------------------------------

    def report(self, rule_id: str, node: ast.AST, message: str) -> None:
        v = Violation(
            rule=rule_id, path=self.rel_path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message, context=self.qualname(),
        )
        v._end_line = getattr(node, "end_lineno", None)  # type: ignore
        self.violations.append(v)

    # ---- waivers --------------------------------------------------------

    def apply_waivers(self, active_rules: "set[str] | None" = None) -> None:
        """Mark violations covered by an inline waiver, then report
        waiver hygiene: missing reason, stale (suppresses nothing).
        A waiver covers a violation when it sits on any line the
        flagged node's statement spans (first line - 1 .. last line),
        so multi-line calls can carry the comment on any of their
        lines. `active_rules` (a --rules subset) exempts waivers for
        rules that did not run from the staleness check — they could
        not possibly have suppressed anything this run."""
        # idempotent under re-settling (analyze_source with a shared
        # project settles after every added file): drop our own prior
        # hygiene output and recompute from scratch
        self.violations = [v for v in self.violations
                           if not getattr(v, "_waiver_hygiene", False)]
        for w in self.waivers:
            w.used = False
            w.used_rules = set()
        spans: dict[int, list[Violation]] = {}
        for v in self.violations:
            spans.setdefault(v.line, []).append(v)
        for w in self.waivers:
            if META_RULE in w.rules:
                v = Violation(
                    rule=META_RULE, path=self.rel_path, line=w.line,
                    col=0, message="GL00 cannot be waived")
                v._waiver_hygiene = True  # type: ignore[attr-defined]
                self.violations.append(v)
                continue
            if not w.reason:
                v = Violation(
                    rule=META_RULE, path=self.rel_path, line=w.line,
                    col=0,
                    message="waiver has no reason: "
                            "`# lint: ignore[RULE] why it is safe`")
                v._waiver_hygiene = True  # type: ignore[attr-defined]
                self.violations.append(v)
                # a reasonless waiver still suppresses nothing
                continue
            for v in self.violations:
                if v.rule in w.rules and self._covers(w, v):
                    v.waived = True
                    w.used = True
                    w.used_rules.add(v.rule)
        for w in self.waivers:
            if not w.reason or META_RULE in w.rules:
                continue
            # staleness is PER-RULE: a multi-rule waiver with one dead
            # rule names exactly the dead one (the others keep working)
            stale = [r for r in w.rules if r not in w.used_rules]
            if active_rules is not None:
                # a rule that didn't run this invocation could not
                # possibly have suppressed anything — exempt it
                stale = [r for r in stale if r in active_rules]
            if not stale:
                continue
            v = Violation(
                rule=META_RULE, path=self.rel_path, line=w.line, col=0,
                message=f"stale waiver for {','.join(stale)}: "
                        "suppresses nothing on this statement")
            v._waiver_hygiene = True  # type: ignore[attr-defined]
            self.violations.append(v)

    def _covers(self, w: Waiver, v: Violation) -> bool:
        if w.line in (v.line, v.line - 1):
            return True
        # multi-line statement: waiver on any spanned line counts
        end = getattr(v, "_end_line", None)
        return end is not None and v.line <= w.line <= end


class Rule:
    """One invariant. Subclasses declare `id`, `name`, `summary` and
    implement any of the hook methods the walker dispatches:

        on_call(node, ctx)           every ast.Call
        on_await(node, ctx)          every ast.Await
        on_expr_stmt(node, ctx)      every ast.Expr statement
        on_except(node, ctx)         every ast.ExceptHandler
        on_function(node, ctx)       every (Async)FunctionDef, on entry
        finish_file(ctx)             after the file's pass
        finish_project(project)      after ALL files (cross-file rules);
                                     returns extra list[Violation]
    """

    id: str = "GL??"
    name: str = "unnamed"
    summary: str = ""

    def applies_to(self, ctx: FileContext) -> bool:
        return not ctx.is_test

    # default no-op hooks (walker only dispatches ones overridden)
    def finish_file(self, ctx: FileContext) -> None:
        pass

    def finish_project(self, project: "ProjectState") -> list[Violation]:
        return []


@dataclass
class ProjectState:
    """Cross-file accumulator handed to finish_project hooks."""

    root: str = ""
    files: list[FileContext] = field(default_factory=list)
    # rule-id -> arbitrary accumulated state
    data: dict = field(default_factory=dict)


# ---- shared AST helpers ------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def chain_segments(node: ast.AST) -> list[str]:
    """All identifier segments of an attribute chain, outermost last;
    call/subscript links are skipped but their base is traversed
    (so registry().inc -> ['registry', 'inc'])."""
    parts: list[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, (ast.Call,)):
            node = node.func
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            break
        else:
            break
    return list(reversed(parts))


def call_name(node: ast.Call) -> str:
    """Last segment of the called thing ('' when unresolvable)."""
    segs = chain_segments(node.func)
    return segs[-1] if segs else ""


def kwarg(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def is_const(node: Optional[ast.AST], value=...) -> bool:
    if not isinstance(node, ast.Constant):
        return False
    return True if value is ... else node.value is value


# mutation-context detection shared by GL02 (rules_rpc) and the pass-1
# summaries (dataflow) — one home so they can never disagree
MUTATION_NAME_RE = re.compile(
    r"(^|_)(insert|write|put|delete|update|remove|push|apply|store|"
    r"flush|merge)($|_)")
MUTATION_OP_RE = re.compile(
    r"^(insert|write|put|delete|update|remove|push|apply|store|flush)")


def payload_ops(node: ast.Call) -> list[str]:
    """Constant `op` strings found anywhere in the call's payload
    arguments (table RPCs ship {'op': 'insert_many', ...} dicts)."""
    ops = []
    for arg in list(node.args) + [k.value for k in node.keywords
                                  if k.value is not None]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Dict):
                for k, v in zip(sub.keys, sub.values):
                    if is_const(k) and k.value == "op" \
                            and isinstance(v, ast.Constant) \
                            and isinstance(v.value, str):
                        ops.append(v.value)
    return ops
