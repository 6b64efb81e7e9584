"""Copy of garage_tpu/analysis/rules_rpc.py: import paths rewritten, issue and PR tags dropped.

Hedge-safety and SSE-C cache rules: GL02 hedge-on-mutation, GL03
ssec-cache-leak. Both are dataflow-backed since an earlier change.

GL02 generalizes an earlier change's hand-pinned k2v `hedge=False`: a hedged RPC
races a second copy of the request, so a non-idempotent (write/insert/
delete) endpoint must never be called with hedging possible — a
slow-but-alive node would apply the mutation twice (duplicate DVVS
siblings was the concrete k2v failure). Three triggers:

  (a) `RequestStrategy(..., hedge=True)` anywhere — explicitly forcing
      hedges is only ever safe on idempotent reads and needs a waiver
      saying so;
  (b) a hedge-DEFAULTING `try_call_many` (no `hedge=` in its strategy)
      in a mutation context: the enclosing function, or an `op` string
      in the payload, matches write/insert/delete patterns;
  (c) interprocedural (the ROADMAP upgrade): a helper whose `strategy`
      PARAMETER feeds a mutating `try_call_many` makes that parameter
      hedge-sensitive — every caller that passes an unpinned
      `RequestStrategy(...)` into it is flagged AT THE CALLER, where
      the missing `hedge=False` belongs. Sensitivity propagates up
      through param-to-param forwarding (fixpoint over the call graph).

GL03 is true SSE-C taint tracking since an earlier change (the an earlier change cut keyed on
an `sse`-*named* binding in scope). Sources: sse-named params/locals
and decrypt results. The taint crosses helper boundaries: an argument
built from SSE-C state taints the callee's parameter (whatever it is
named), to a fixpoint. Sinks, in api/s3/ + block/ + gateway/: any call
through the block-manager cache seam (`rpc_get_block`/`rpc_put_block`)
from a tainted scope without an explicit `cacheable=`, and any tainted
payload handed to a cache `insert`. The an earlier change invariant stands: SSE-C
plaintext never outlives the request in the node-local read cache, and
the explicit kwarg is the audit point."""

from __future__ import annotations

import ast
import re

from .core import (MUTATION_NAME_RE, MUTATION_OP_RE, FileContext,
                   ProjectState, Rule, Violation, call_name, is_const,
                   kwarg, payload_ops)


def _strategy_of(node: ast.Call, ctx: FileContext) -> "ast.Call | str | None":
    """Resolve the RequestStrategy expression of a try_call_many call:
    inline constructor (positional arg 3 / kw `strategy`), a local
    `name = RequestStrategy(...)` binding recorded by the walker, or
    the sentinel "param" when the strategy arrives as a function
    parameter (resolved interprocedurally in finish_project)."""
    expr = kwarg(node, "strategy")
    if expr is None and len(node.args) >= 4:
        expr = node.args[3]
    if isinstance(expr, ast.Call) and call_name(expr) == "RequestStrategy":
        return expr
    if isinstance(expr, ast.Name):
        local = ctx.func_meta.get("strategies", {}).get(expr.id)
        if local is not None:
            return local
        if expr.id in ctx.func_meta.get("args", set()):
            return "param"
    return None


def _mutating_ops(ops: list[str]) -> bool:
    return any(MUTATION_OP_RE.match(o) for o in ops)


class HedgeOnMutation(Rule):
    id = "GL02"
    name = "hedge-on-mutation"
    needs_dataflow = True
    summary = ("hedge=True, a hedge-defaulting try_call_many on a "
               "write/insert/delete endpoint, or an unpinned strategy "
               "passed into a mutating helper — a hedged mutation can "
               "apply twice (the an earlier change k2v duplicate-siblings bug); "
               "pin hedge=False on non-idempotent RPCs")
    rationale = (
        "A hedged RPC races a second copy of the request against a "
        "slow-but-alive node — harmless on idempotent reads, double-"
        "apply on mutations (the concrete an earlier change failure: duplicate "
        "DVVS siblings in k2v). Since an earlier change the rule resolves "
        "strategies across function boundaries: a helper whose "
        "strategy parameter feeds a mutating try_call_many makes "
        "every unpinned caller a finding AT THE CALLER.")
    example_fire = ("async def insert(self, who, payload):\n"
                    "    await self._call_any(who, payload,\n"
                    "                         RequestStrategy(quorum=1))")
    example_ok = ("async def insert(self, who, payload):\n"
                  "    await self._call_any(who, payload,\n"
                  "        RequestStrategy(quorum=1, hedge=False))")

    def on_call(self, node: ast.Call, ctx: FileContext) -> None:
        name = call_name(node)
        if name == "RequestStrategy":
            if is_const(kwarg(node, "hedge"), True):
                ctx.report(self.id, node,
                           "RequestStrategy(hedge=True): forcing "
                           "hedges is only safe on idempotent reads; "
                           "waive with that justification or drop it")
            return
        if name != "try_call_many":
            return
        strategy = _strategy_of(node, ctx)
        if strategy == "param":
            return  # resolved interprocedurally at the caller
        if isinstance(strategy, ast.Call) \
                and kwarg(strategy, "hedge") is not None:
            return  # explicit pin (True already flagged above)
        func_name = ctx.func_stack[-1][1] if ctx.func_stack else ""
        mutating = bool(MUTATION_NAME_RE.search(func_name))
        ops = payload_ops(node)
        mutating = mutating or _mutating_ops(ops)
        if mutating:
            why = (f"op {ops!r}" if ops and _mutating_ops(ops)
                   else f"enclosing `{func_name}`")
            ctx.report(self.id, node,
                       "hedge-defaulting try_call_many in mutation "
                       f"context ({why}); pass RequestStrategy("
                       "hedge=False) — a hedged write can apply twice")

    # ---- interprocedural strategy resolution (trigger c) ---------------

    def finish_project(self, project: ProjectState) -> list[Violation]:
        df = project.data.get("_dataflow")
        if df is None:
            return []
        graph = df.graph
        # seed: (function id, param name) pairs whose param feeds a
        # hedge-defaulting try_call_many. Two tiers: "mut" when the
        # CALLEE's own context (enclosing name / payload op) is already
        # mutating — every unpinned caller fires; "any" when the callee
        # is context-neutral plumbing — the CALLER fires only if its
        # own context is mutating.
        sensitive: dict[tuple, tuple] = {}   # (fid, param) -> (tier, why)
        for fid in sorted(graph.functions):
            fn = graph.functions[fid]
            for rec in fn["calls"]:
                if rec["name"] != "try_call_many":
                    continue
                desc = rec["kw"].get("strategy")
                if desc is None and len(rec["args"]) >= 4 \
                        and rec["args"][3] is not None:
                    desc = rec["args"][3]
                s = (desc or {}).get("s")
                if not s or s.get("k") != "param":
                    continue
                tier = ("mut" if fn["mutation_name"]
                        or _mutating_ops(rec["ops"]) else "any")
                why = (f"{fn['qualname']} (try_call_many at "
                       f"{fn['path']}:{rec['line']})")
                cur = sensitive.get((fid, s["name"]))
                if cur is None or (cur[0] == "any" and tier == "mut"):
                    sensitive[(fid, s["name"])] = (tier, why)
        # propagate param-to-param forwarding up the call graph
        changed = True
        while changed:
            changed = False
            for fid in graph.functions:
                fn = graph.functions[fid]
                for callee, rec in graph.edges_from(fid):
                    shift = graph.bound_call(fid, rec)
                    for pos, desc in enumerate(rec["args"]):
                        s = (desc or {}).get("s")
                        if not s or s.get("k") != "param":
                            continue
                        pname = graph.param_index(callee, pos, shift)
                        hit = sensitive.get((callee, pname)) \
                            if pname else None
                        if hit is None:
                            continue
                        cur = sensitive.get((fid, s["name"]))
                        if cur is None or (cur[0] == "any"
                                           and hit[0] == "mut"):
                            sensitive[(fid, s["name"])] = hit
                            changed = True
        if not sensitive:
            return []
        # fire: unpinned strategies constructed at a call into a
        # sensitive parameter
        out: list[Violation] = []
        test_paths = {c.rel_path for c in project.files
                      if c.is_test or c.is_harness}
        for fid in sorted(graph.functions):
            fn = graph.functions[fid]
            if fn["path"] in test_paths:
                continue
            for callee, rec in graph.edges_from(fid):
                shift = graph.bound_call(fid, rec)
                args = list(enumerate(rec["args"])) + [
                    (k, d) for k, d in sorted(rec["kw"].items())]
                for pos, desc in args:
                    s = (desc or {}).get("s")
                    if not s or s.get("k") not in ("inline", "local"):
                        continue
                    if s.get("hedge") is not None:
                        continue  # pinned (True fired in on_call)
                    pname = (graph.param_index(callee, pos, shift)
                             if isinstance(pos, int) else pos)
                    hit = sensitive.get((callee, pname)) if pname else None
                    if hit is None:
                        continue
                    tier, why = hit
                    if tier == "any" and not (
                            fn["mutation_name"]
                            or _mutating_ops(rec["ops"])):
                        continue
                    v = Violation(
                        rule=self.id, path=fn["path"],
                        line=rec["line"], col=0,
                        message=(
                            "unpinned RequestStrategy passed into "
                            f"hedge-sensitive `{pname}` of {why}; pass "
                            "hedge=False — a hedged write can apply "
                            "twice"),
                        context=fn["qualname"])
                    v._end_line = rec.get("end_line")  # type: ignore
                    out.append(v)
        return out


GL03_DIRS = re.compile(r"(^|/)(api/s3|block|gateway)/")
SSE_NAME_RE = re.compile(r"(^|_)sse", re.IGNORECASE)
CACHE_SEAM = {"rpc_get_block", "rpc_put_block"}
# the CLUSTER cache tier's cross-node seam (
# block/cache_tier.py): `probe` on a tier/cache receiver must carry the
# same explicit cacheable= audit flag as the rpc_get/put_block seam —
# an SSE-C hash must never even be ASKED about across nodes — and
# `insert_at` is a cache-insert sink like `.insert`. an earlier change widened
# the seam: `probe_full` is the lease-carrying GET form and
# `probe_packed` hits the packed-bytes segment — same audit flag, same
# rule (an SSE-C hash must not mint a lease or pull packed bytes
# either).
TIER_PROBE_NAMES = {"probe", "probe_full", "probe_packed",
                    "cache_tier_probe"}
CACHE_INSERT_NAMES = {"insert", "insert_at", "cache_tier_insert"}
_SSEISH = ("<sse>", "<decrypt>")


def _cacheish_recv(recv) -> bool:
    return any("cache" in s.lower() or "tier" in s.lower()
               for s in recv)


class SsecCacheLeak(Rule):
    id = "GL03"
    name = "ssec-cache-leak"
    needs_dataflow = True
    summary = ("SSE-C taint reaching the block cache seam without an "
               "explicit cacheable=, or a tainted payload inserted "
               "into a cache — an earlier change's invariant is that SSE-C "
               "plaintext never enters the node-local read cache; the "
               "taint follows the value across helper boundaries")
    rationale = (
        "SSE-C plaintext must never outlive its request in a shared "
        "cache ('s invariant; the explicit cacheable= kwarg is "
        "the audit point). an earlier change's cut keyed on an sse-NAMED binding "
        "in scope; since an earlier change this is real taint tracking — "
        "sse-named params/locals and decrypt results taint every "
        "argument built from them, the taint crosses helper "
        "boundaries to a fixpoint, and a helper that receives SSE-C "
        "state under ANY parameter name must pass cacheable= at the "
        "seam.")
    example_fire = ("async def helper(mgr, h, key):      # key <- sse_key\n"
                    "    return await mgr.rpc_get_block(h)\n"
                    "async def stream(mgr, h, sse_key):\n"
                    "    return await helper(mgr, h, sse_key)")
    example_ok = ("async def helper(mgr, h, key):\n"
                  "    return await mgr.rpc_get_block(\n"
                  "        h, cacheable=key is None)")

    def applies_to(self, ctx: FileContext) -> bool:
        # the rule itself runs in finish_project; applies_to only
        # gates the (unused) per-file hooks
        return not ctx.is_test

    def finish_project(self, project: ProjectState) -> list[Violation]:
        df = project.data.get("_dataflow")
        if df is None:
            return []
        graph = df.graph
        # fixpoint: parameters that receive SSE-C state from any caller
        tainted: dict[tuple, str] = {}   # (fid, param) -> provenance

        def fn_sse_labels(fid: str, fn: dict) -> set:
            labels = set(fn["sse_sources"])
            labels |= {p for p in fn["params"] if (fid, p) in tainted}
            return labels

        changed = True
        while changed:
            changed = False
            for fid in graph.functions:
                fn = graph.functions[fid]
                live = fn_sse_labels(fid, fn)
                for callee, rec in graph.edges_from(fid):
                    shift = graph.bound_call(fid, rec)
                    args = list(enumerate(rec["args"])) + [
                        (k, d) for k, d in sorted(rec["kw"].items())]
                    for pos, desc in args:
                        t = (desc or {}).get("t")
                        if not t:
                            continue
                        if not (set(t) & (live | set(_SSEISH))):
                            continue
                        pname = (graph.param_index(callee, pos, shift)
                                 if isinstance(pos, int) else pos)
                        if pname and (callee, pname) not in tainted:
                            tainted[(callee, pname)] = (
                                f"tainted via {fn['qualname']} at "
                                f"{fn['path']}:{rec['line']}")
                            changed = True
        # sinks
        out: list[Violation] = []
        test_paths = {c.rel_path for c in project.files
                      if c.is_test or c.is_harness}
        for fid in sorted(graph.functions):
            fn = graph.functions[fid]
            if fn["path"] in test_paths \
                    or not GL03_DIRS.search(fn["path"]):
                continue
            live = fn_sse_labels(fid, fn)
            if not live:
                continue
            origin = ""
            for p in fn["params"]:
                if (fid, p) in tainted:
                    origin = f" ({tainted[(fid, p)]})"
                    break
            for rec in fn["calls"]:
                if (rec["name"] in CACHE_SEAM
                        or (rec["name"] in TIER_PROBE_NAMES
                            and _cacheish_recv(rec["recv"]))) \
                        and "cacheable" not in rec["kwargs"]:
                    v = Violation(
                        rule=self.id, path=fn["path"], line=rec["line"],
                        col=0,
                        message=(
                            f"`{rec['name']}` in an SSE-C scope without "
                            "explicit cacheable=; pass cacheable="
                            "(sse_key is None) so encrypted payloads "
                            "never enter the read cache (or cross a "
                            f"node on the tier probe){origin}"),
                        context=fn["qualname"])
                    v._end_line = rec.get("end_line")  # type: ignore
                    out.append(v)
                    continue
                if rec["name"] in CACHE_INSERT_NAMES \
                        and _cacheish_recv(rec["recv"]):
                    hot = set()
                    for desc in list(rec["args"]) + \
                            list(rec["kw"].values()):
                        t = (desc or {}).get("t") or []
                        hot |= set(t) & (live | set(_SSEISH))
                    if hot:
                        v = Violation(
                            rule=self.id, path=fn["path"],
                            line=rec["line"], col=0,
                            message=(
                                "SSE-C-tainted payload inserted into a "
                                f"cache (labels {sorted(hot)}); SSE-C "
                                "plaintext must never enter a shared "
                                f"cache{origin}"),
                            context=fn["qualname"])
                        v._end_line = rec.get("end_line")  # type: ignore
                        out.append(v)
        return out
