"""Port of garage_tpu/analysis/rules_device.py: the device-path rules
re-aimed at the port's CUDA device path. What differs from the JAX
package's module:

  * the scope is the port's tree (`garage_tpu_torch/{block,ops,
    parallel}/`), not the JAX package's;
  * GL14's launch artifacts are, beside a jit program, a CUDA graph
    (`torch.cuda.CUDAGraph`, `torch.cuda.graph`), a kernel build or
    load (`_build.load`, `_build.nvcc`) and a plan from the kernel
    library's planner (`gt_g1_plan`, `g1_plan`, `b3_plan`, ...); a cache
    subscript fires on containers named *graph* or *plan* too;
  * GL15's launches are, beside `device_put` and `gf_apply_batched`, a
    `.to(<device>)` / `.cuda()` move, a `torch.as_tensor` /
    `torch.tensor` / `torch.empty` / `torch.zeros` / `torch.full` with
    `device=`, and an operand of the port's kernel wrappers (`gf_apply`,
    `gf_check`, `hash_rows`, `blake3_rows`); a function of the same file
    that only wraps such a move or allocation of its parameter (the
    backend's `_to_device` and `_host`) counts as one;
  * messages cite no issue or PR numbers.

The JAX idioms stay recognised, so the JAX package's fixtures hold
these rules as they hold its own. Standard library only (`ast`, `re`).

Device-path rules: GL14 jit-cache-key-leak, GL15
unpadded-device-launch, GL16 loop-touch-from-stage-thread.

All three encode the shape-stability and threading discipline of the
device path, scoped to the device path itself (`block/`, `ops/`,
`parallel/`) where the invariants are load-bearing:

  * GL14 is the pattern-keyed cache leak: a launch cache (a jit
    program, a CUDA graph, a kernel plan) keyed on data-dependent
    runtime values — an erasure pattern, a present/missing set —
    builds one artifact PER PATTERN (C(n,k) of them for RS(n,k)
    instead of one). The fix is always the same: key on shapes/counts
    (pad-bucket-derived values are exempt by construction) and ship
    the pattern as a tensor operand ("pattern-as-data", ops/rs.py's
    `gf_apply_batched`: G1 takes its matrices as data).
  * GL15 is the variable-shape trap: a host-to-device move, a device
    allocation or a batched-kernel launch whose operand was sized from
    raw lengths (`len(...)`, `max(...)`) instead of routing through the
    `pad_buckets` ladder (`bucket_items` / `bucket_len` / `pad*`) —
    every distinct size is a launch shape that never repeats (a fresh
    plan, and a graph that cannot be replayed).
  * GL16 is the stage-thread/loop boundary: functions the
    StageExecutor runs on its worker threads must never touch asyncio
    primitives directly (`call_soon`, `create_task`, `set_result`,
    ...) — the loop is not thread-safe; the ONLY sanctioned crossings
    are `call_soon_threadsafe` / `run_coroutine_threadsafe`
    (device_backend.py's delivery seam).
"""

from __future__ import annotations

import ast
import re

from .core import FileContext, ProjectState, Rule, Violation, \
    chain_segments
from .rules_dataflow import _dataflow, _is_checked_file

# the device path: where shape stability and stage-thread discipline
# are load-bearing (api/model/qos code has no launch caches or stage
# threads to misuse)
_DEVICE_PREFIXES = ("garage_tpu_torch/block/", "garage_tpu_torch/ops/",
                    "garage_tpu_torch/parallel/")

# data-dependent erasure-pattern identifiers: the values a pattern-keyed
# cache leaks on (a tuple of shard indices changes per request; a shape
# or count does not)
_PATTERN_RE = re.compile(r"(^|_)(present|missing|pattern|patterns)($|_)")

# GL14: what a cached builder may build per key — a CUDA graph, a
# kernel build or load, a plan from the kernel library's planner
_GRAPH_NAMES = {"CUDAGraph", "make_graphed_callables"}
_BUILD_CALLS = {("_build", "load"), ("_build", "nvcc"),
                ("cpp_extension", "load"), ("cpp_extension", "load_inline")}
_PLAN_CALL_RE = re.compile(r"(^|_)plan$")
# GL14 part B: containers whose subscripts are launch caches
_CACHE_CONTAINER_WORDS = ("cache", "jit", "graph", "plan")

# identifiers that mark a value as routed through the pad ladder
_PAD_SOURCES = {"bucket_items", "bucket_len"}
_PAD_NAME_RE = re.compile(r"(^|_)pad")

# array allocators whose shape arguments decide the launch shape
_ALLOC_METHODS = {"zeros", "empty", "ones", "full", "frombuffer",
                  "zeros_like", "empty_like", "as_tensor", "tensor"}

# torch allocators that land on a device when given `device=`
_DEVICE_ALLOCS = {"as_tensor", "tensor", "empty", "zeros", "full"}

# launches whose operands are their positional arguments
_LAUNCH_CALLS = {"device_put", "gf_apply_batched", "gf_apply", "gf_check",
                 "hash_rows", "blake3_rows"}

# raw-size evidence inside an allocation's shape arguments
_SIZE_CALLS = {"len", "max"}

# `.to(x)` with one of these as x converts the dtype, moving nothing
_DTYPE_NAMES = {"uint8", "int8", "int16", "int32", "int64", "float16",
                "bfloat16", "float32", "float64", "bool", "long", "int",
                "float", "double", "half"}

# loop-affine asyncio primitives a stage thread must not touch; the
# *_threadsafe crossings are sanctioned by name
_UNSAFE_LOOP_CALLS = {"call_soon", "call_at", "call_later",
                      "create_task", "ensure_future", "create_future",
                      "set_result", "set_exception", "put_nowait"}

# methods a *Backend class runs on the stage executor's worker threads
_STAGE_METHODS = {"stage", "compute", "readback"}


def _device_scoped(rel_path: str) -> bool:
    # segment-anchored rather than startswith so files scanned from
    # outside the repo root (rel_path led by ../) still scope
    p = "/" + rel_path.replace("\\", "/")
    return any(f"/{pfx}" in p for pfx in _DEVICE_PREFIXES)


def _own_scopes(root: ast.AST):
    """Yield (scope_node, [statements]) for the module/function and
    every function under it — each function's body is ONE scope; its
    nested defs are their own."""
    yield root, _scope_stmts(root)
    stack = list(ast.iter_child_nodes(root))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n, _scope_stmts(n)
        if not isinstance(n, ast.Lambda):
            stack.extend(ast.iter_child_nodes(n))


def _scope_stmts(scope: ast.AST) -> list:
    """Statements of a scope in source order, flattened through
    compound statements but NOT into nested defs/lambdas."""
    out = []
    stack = list(getattr(scope, "body", []))[::-1]
    while stack:
        st = stack.pop()
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda, ast.ClassDef)):
            continue
        out.append(st)
        for field in ("body", "orelse", "finalbody"):
            stack.extend(list(getattr(st, field, []))[::-1])
        for h in getattr(st, "handlers", []):
            stack.extend(list(h.body)[::-1])
    return out


def _walk_scope_exprs(node: ast.AST, skip_len: bool = False,
                      skip_pad: bool = False):
    """Walk an expression/statement without descending into nested
    defs/lambdas; optionally skip len()/max() call arguments (a
    len(pattern) key is a COUNT, not the pattern) or pad-ladder calls
    (whatever they round is no longer raw)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)) and n is not node:
            continue
        if skip_len and isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Name) \
                and n.func.id in _SIZE_CALLS:
            continue
        if skip_pad and _is_pad_call(n):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _is_pad_call(n: ast.AST) -> bool:
    if not isinstance(n, ast.Call):
        return False
    cs = chain_segments(n.func)
    return bool(cs) and (cs[-1] in _PAD_SOURCES
                         or bool(_PAD_NAME_RE.search(cs[-1])))


def _pattern_names(expr: ast.AST) -> list[str]:
    """Pattern-named identifiers in an expression, excluding those
    consumed by len()/max() (counts are shape-stable)."""
    names = {n.id for n in _walk_scope_exprs(expr, skip_len=True)
             if isinstance(n, ast.Name) and _PATTERN_RE.search(n.id)}
    return sorted(names)


def _launch_artifact(node: ast.AST) -> str:
    """What a cached builder's body builds per key: a jit program, a
    CUDA graph, a kernel build, a launch plan — or '' (nothing)."""
    for n in _walk_scope_exprs(node):
        if isinstance(n, (ast.Name, ast.Attribute)):
            ident = n.id if isinstance(n, ast.Name) else n.attr
            if "jit" in ident.lower():
                return "a jit program"
            if ident in _GRAPH_NAMES:
                return "a CUDA graph"
        if not isinstance(n, ast.Call):
            continue
        cs = chain_segments(n.func)
        if cs[-2:] == ["cuda", "graph"]:
            return "a CUDA graph"
        if tuple(cs[-2:]) in _BUILD_CALLS:
            return "a kernel build"
        if cs and _PLAN_CALL_RE.search(cs[-1]):
            return "a launch plan"
    return ""


def _is_device_move(call: ast.Call) -> bool:
    """`x.cuda(...)`, or `x.to(...)` naming a device (a dtype-only
    `.to(torch.int32)` moves nothing)."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cuda":
        return True
    if call.func.attr != "to":
        return False
    if any(kw.arg == "device" for kw in call.keywords):
        return True
    if not call.args:
        return False
    a = call.args[0]
    if isinstance(a, ast.Constant):
        return isinstance(a.value, str)
    segs = chain_segments(a)
    return bool(segs) and segs[-1] not in _DTYPE_NAMES \
        and "dtype" not in segs[-1].lower()


def _is_device_alloc(call: ast.Call) -> bool:
    cs = chain_segments(call.func)
    return bool(cs) and cs[-1] in _DEVICE_ALLOCS \
        and any(kw.arg == "device" for kw in call.keywords)


def _params(fn: ast.AST) -> set[str]:
    a = fn.args
    return {arg.arg for arg in (a.posonlyargs + a.args + a.kwonlyargs)
            if arg.arg not in ("self", "cls")}


def _wrappers(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(move wrappers, allocation wrappers) defined in this file: a def
    that returns a device move of one of its parameters (the backend's
    `_to_device(t)`), or an allocation shaped by one of its parameters
    (`_host(shape)`). A call to one is a move / an allocation."""
    moves, allocs = set(), set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = _params(fn)
        if not params:
            continue
        stmts = _scope_stmts(fn)
        allocated: set[str] = set()
        for st in stmts:
            if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call) \
                    and _alloc_of(st.value, params, set()):
                allocated.update(n.id for t in st.targets
                                 for n in ast.walk(t)
                                 if isinstance(n, ast.Name))
        for st in stmts:
            if not isinstance(st, ast.Return) or st.value is None:
                continue
            for n in _walk_scope_exprs(st.value):
                if isinstance(n, ast.Call) and _is_device_move(n) \
                        and isinstance(n.func.value, ast.Name) \
                        and n.func.value.id in params:
                    moves.add(fn.name)
                if (isinstance(n, ast.Call)
                        and _alloc_of(n, params, set())) \
                        or (isinstance(n, ast.Name) and n.id in allocated):
                    allocs.add(fn.name)
    return moves, allocs


def _alloc_of(call: ast.Call, names: set[str], extra: set[str]) -> bool:
    """An allocation (or allocation wrapper in `extra`) whose arguments
    mention one of `names`."""
    cs = chain_segments(call.func)
    if not cs or (cs[-1] not in _ALLOC_METHODS and cs[-1] not in extra):
        return False
    args = [*call.args, *(kw.value for kw in call.keywords)]
    return any(isinstance(n, ast.Name) and n.id in names
               for a in args for n in _walk_scope_exprs(a))


class JitCacheKeyLeak(Rule):
    id = "GL14"
    name = "jit-cache-key-leak"
    summary = ("a launch cache keyed on data-dependent runtime values — "
               "an `@lru_cache` whose parameters carry an erasure "
               "pattern (present/missing sets) into a body that builds "
               "a jit program, a CUDA graph, a kernel build or a launch "
               "plan, or a cache/graph/plan subscript whose key "
               "f-string/tuple embeds one — builds one artifact PER "
               "PATTERN (C(n,k) of them for RS(n,k)); key on "
               "shapes/counts (pad-bucket values are exempt) and ship "
               "the pattern as a tensor operand")
    rationale = (
        "A decode path that caches its launch artifact under "
        "`f\"dec{k},{m},{present}\"` lets RS(10,4) build and retain "
        "1001 of them — the cache becomes an unbounded leak keyed on "
        "request data. The discipline that replaces it (ops/rs.py "
        "`gf_apply_batched`, G1 with its matrices as data) keys builds "
        "on SHAPES only and passes the pattern as a device tensor, so "
        "the 1001 patterns share one launch shape. On the card the "
        "artifacts are CUDA graphs (a captured graph replays one "
        "shape and one set of pointers), kernel builds, and the "
        "kernel library's launch plans (`g1_plan`, `b3_plan`); the "
        "JAX package's are jit programs. This rule pins that "
        "discipline: an lru_cache/cache-decorated function whose "
        "parameters match present/missing/pattern AND whose body "
        "builds such an artifact fires, as does a subscript "
        "store/load on a cache/jit/graph/plan container whose key "
        "expression embeds a pattern-named value. `len(present)` keys "
        "are counts (shape-stable) and stay quiet, as do pad-bucket-"
        "derived shape keys.")
    example_fire = ("@functools.lru_cache(maxsize=None)\n"
                    "def graph_for(k, m, present, missing):\n"
                    "    g = torch.cuda.CUDAGraph()  # one graph/pattern\n"
                    "    ...\n"
                    "    return g")
    example_ok = ("@functools.lru_cache(maxsize=None)\n"
                  "def graph_for(k, rows, shard_len):\n"
                  "    g = torch.cuda.CUDAGraph()  # shape-keyed\n"
                  "    ...\n"
                  "# pattern ships as data: gf_apply(mats, shards)")

    def applies_to(self, ctx: FileContext) -> bool:
        return not ctx.is_test and _device_scoped(ctx.rel_path)

    def finish_file(self, ctx: FileContext) -> None:
        for scope, stmts in _own_scopes(ctx.tree):
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_cached_def(ctx, scope)
            self._check_key_subscripts(ctx, scope, stmts)

    # -- part A: @lru_cache def with pattern params + artifact body -----

    def _check_cached_def(self, ctx: FileContext,
                          node: ast.AST) -> None:
        cached = any(
            segs and segs[-1] in ("lru_cache", "cache")
            for d in node.decorator_list
            for segs in [chain_segments(d)])
        if not cached:
            return
        a = node.args
        pat = sorted(arg.arg for arg in
                     (a.posonlyargs + a.args + a.kwonlyargs)
                     if _PATTERN_RE.search(arg.arg))
        if not pat:
            return
        built = ""
        for st in node.body:
            built = _launch_artifact(st)
            if built:
                break
        if not built:
            return
        ctx.report(self.id, node, (
            f"`@lru_cache` on `{node.name}` is keyed on data-dependent "
            f"pattern parameter(s) {', '.join(pat)} while the body "
            f"builds {built} — one cached artifact per pattern "
            "(C(n,k) of them for RS(n,k)); key the cache on "
            "shapes/counts and ship the pattern as a tensor operand"))

    # -- part B: cache[key] with a pattern baked into the key ------------

    def _check_key_subscripts(self, ctx: FileContext, scope: ast.AST,
                              stmts: list) -> None:
        key_vars: dict[str, ast.AST] = {}
        for st in stmts:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name) \
                    and isinstance(st.value, (ast.JoinedStr, ast.Tuple)):
                key_vars[st.targets[0].id] = st.value
        # a compound statement's walk covers the statements flattened
        # after it: report each node once
        seen: set[int] = set()
        for st in stmts:
            for n in _walk_scope_exprs(st):
                if not isinstance(n, ast.Subscript) or id(n) in seen:
                    continue
                seen.add(id(n))
                segs = chain_segments(n.value)
                if not any(w in s.lower() for s in segs
                           for w in _CACHE_CONTAINER_WORDS):
                    continue
                key = n.slice
                if isinstance(key, ast.Name) and key.id in key_vars:
                    key = key_vars[key.id]
                names = _pattern_names(key)
                if names:
                    ctx.report(self.id, n, (
                        f"launch-cache key on `{'.'.join(segs)}` "
                        f"embeds data-dependent value(s) "
                        f"{', '.join(names)} — one cached artifact per "
                        "pattern; use shape/count keys and pass the "
                        "pattern as data"))


class UnpaddedDeviceLaunch(Rule):
    id = "GL15"
    name = "unpadded-device-launch"
    summary = ("a host-to-device move (device_put, .to(<device>), "
               ".cuda()), a device allocation (torch.empty/zeros/full/"
               "tensor/as_tensor with device=) or a batched-kernel "
               "launch (gf_apply, gf_check, hash_rows, blake3_rows) "
               "whose operand was sized from raw lengths (len()/max()) "
               "instead of the pad_buckets ladder (bucket_items/"
               "bucket_len/pad*) — every distinct size is a launch "
               "shape that never repeats; round sizes through the "
               "bucket helpers so the shape set stays closed")
    rationale = (
        "A launch shape sized straight from the request — a "
        "(n_blobs, max_len) staging buffer — differs on nearly every "
        "batch: the kernel library plans every new shape, a captured "
        "CUDA graph can replay none of them, and (under XLA) each one "
        "is a fresh compile that never repeats. The feeder discipline "
        "routes every staged shape through bucket_items/bucket_len so "
        "the reachable shape set is small and closed. This rule flags "
        "an operand allocated with raw len()/max() sizes reaching a "
        "device (a move, a device allocation, a batched kernel) "
        "without touching the ladder; a same-file helper that only "
        "moves or allocates its parameter counts as the move or "
        "allocation it wraps.")
    example_fire = ("buf = torch.empty((len(blobs), n), dtype=torch.uint8)\n"
                    "dev = buf.to(self.device)  # shape per request")
    example_ok = ("b = bucket_items(len(blobs), self.pad_buckets)\n"
                  "buf = torch.empty((b, n), dtype=torch.uint8)\n"
                  "dev = buf.to(self.device)  # bucketed shape")

    def applies_to(self, ctx: FileContext) -> bool:
        return not ctx.is_test and _device_scoped(ctx.rel_path)

    def finish_file(self, ctx: FileContext) -> None:
        moves, allocs = _wrappers(ctx.tree)
        for scope, stmts in _own_scopes(ctx.tree):
            self._check_scope(ctx, stmts, moves, allocs)

    def _assigned_names(self, target: ast.AST) -> list[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            return [e.id for e in target.elts if isinstance(e, ast.Name)]
        return []

    def _check_scope(self, ctx: FileContext, stmts: list,
                     moves: set[str], allocs: set[str]) -> None:
        padded: set[str] = set()
        raw: set[str] = set()
        # two monotone passes so `smax` defined after first use of the
        # helper chain still classifies (mirrors pass 1's taint walk)
        for _ in range(2):
            for st in stmts:
                if not isinstance(st, ast.Assign):
                    continue
                names = [n for t in st.targets
                         for n in self._assigned_names(t)]
                if not names:
                    continue
                v = st.value
                mentions = {n.id for n in _walk_scope_exprs(v)
                            if isinstance(n, ast.Name)}
                pad_call = any(_is_pad_call(n)
                               for n in _walk_scope_exprs(v))
                if pad_call or mentions & padded:
                    padded.update(names)
                    raw.difference_update(names)
                    continue
                alloc = isinstance(v, ast.Call) and (
                    (cs := chain_segments(v.func))
                    and (cs[-1] in _ALLOC_METHODS or cs[-1] in allocs))
                size_call = any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Name)
                    and n.func.id in _SIZE_CALLS
                    for n in _walk_scope_exprs(v))
                if (alloc and size_call) or mentions & raw:
                    raw.update(names)

        def raw_in(expr: ast.AST, direct_sizes: bool) -> str:
            """The raw name (or `len(...)`/`max(...)` when
            direct_sizes) an operand expression carries, else ''."""
            for n in _walk_scope_exprs(expr, skip_pad=True):
                if isinstance(n, ast.Name) and n.id in raw \
                        and n.id not in padded:
                    return n.id
                if direct_sizes and isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Name) \
                        and n.func.id in _SIZE_CALLS:
                    return f"{n.func.id}(...)"
            return ""

        seen: set[int] = set()
        for st in stmts:
            for n in _walk_scope_exprs(st):
                if not isinstance(n, ast.Call) or id(n) in seen:
                    continue
                seen.add(id(n))
                segs = chain_segments(n.func)
                cname = segs[-1] if segs else ""
                what = ""
                if cname in _LAUNCH_CALLS or cname in moves:
                    for a in n.args:
                        what = raw_in(a, False)
                        if what:
                            break
                    shown = f"{cname}({what})"
                elif _is_device_move(n):
                    what = raw_in(n.func.value, False)
                    shown = f"{what}.{cname}(...)"
                elif _is_device_alloc(n):
                    for a in [*n.args, *(kw.value for kw in n.keywords
                                         if kw.arg != "device")]:
                        what = raw_in(a, True)
                        if what:
                            break
                    shown = f"{'.'.join(segs)}({what}, device=...)"
                if what:
                    ctx.report(self.id, n, (
                        f"`{shown}` launches an operand sized from raw "
                        f"len()/max() — `{what}` never routed through "
                        "the pad_buckets ladder (bucket_items/"
                        "bucket_len), so every distinct size is a new "
                        "launch shape; round the shape through the "
                        "bucket helpers"))


class LoopTouchFromStageThread(Rule):
    id = "GL16"
    name = "loop-touch-from-stage-thread"
    needs_dataflow = True
    summary = ("code reachable on a device stage thread (a *Backend "
               "stage/compute/readback method, or a function submitted "
               "to the stage executor) calls a loop-affine asyncio "
               "primitive (call_soon, create_task, set_result, ...) — "
               "the event loop is not thread-safe off-loop; the only "
               "sanctioned crossings are call_soon_threadsafe / "
               "run_coroutine_threadsafe")
    rationale = (
        "DevicePipeline runs each stage on a dedicated worker thread "
        "(StageExecutor); the asyncio loop those stages report back "
        "to lives on the main thread. Every asyncio primitive except "
        "the *_threadsafe pair assumes it is called ON the loop "
        "thread — a stage function calling loop.call_soon or "
        "fut.set_result directly corrupts the loop's internal state "
        "or races its wakeup pipe, and the failure is a heisenbug "
        "(device_backend.py's delivery seam exists precisely to "
        "funnel results through loop.call_soon_threadsafe). The rule "
        "walks sync call-graph edges from every stage-executed root "
        "(TorchDeviceBackend's and StubDeviceBackend's stage/compute/"
        "readback among them) and flags loop-affine calls it can "
        "reach.")
    example_fire = ("class TorchDeviceBackend:\n"
                    "    def readback(self, op, handle):\n"
                    "        self.loop.call_soon(self._deliver, out)")
    example_ok = ("class TorchDeviceBackend:\n"
                  "    def readback(self, op, handle):\n"
                  "        self.loop.call_soon_threadsafe(\n"
                  "            self._deliver, out)")

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

        roots: dict[str, str] = {}
        for fid in sorted(g.functions):
            fn = g.functions[fid]
            if not _device_scoped(fn["path"]) or not checked(fn["path"]):
                continue
            cls = fn.get("class") or ""
            if cls.endswith("Backend") and fn["name"] in _STAGE_METHODS:
                roots.setdefault(
                    fid, f"`{cls}.{fn['name']}` runs on a stage "
                         "executor worker thread")
            for rec in fn["calls"]:
                if rec["name"] != "submit":
                    continue
                for ad in rec["args"]:
                    if not ad or "n" not in ad:
                        continue
                    cal = g.resolve_ref(fid, ["name", ad["n"]])
                    if cal is not None:
                        roots.setdefault(
                            cal, f"submitted to the stage executor in "
                                 f"`{fn['qualname']}`")

        out: list[Violation] = []
        fired: set[tuple] = set()
        for root in sorted(roots):
            why = roots[root]
            seen: set[str] = set()
            stack = [root]
            while stack:
                cur = stack.pop()
                if cur in seen:
                    continue
                seen.add(cur)
                fn = g.functions[cur]
                if checked(fn["path"]):
                    for rec in fn["calls"]:
                        if rec["name"] in _UNSAFE_LOOP_CALLS \
                                and rec["recv"]:
                            key = (fn["path"], rec["line"], rec["name"])
                            if key in fired:
                                continue
                            fired.add(key)
                            out.append(Violation(
                                rule=self.id, path=fn["path"],
                                line=rec["line"], col=0,
                                message=(
                                    f"asyncio `{rec['name']}` called "
                                    "from code reachable on a device "
                                    f"stage thread ({why}) — loop-"
                                    "affine primitives are not thread-"
                                    "safe off-loop; cross via loop."
                                    "call_soon_threadsafe(...) or "
                                    "asyncio.run_coroutine_threadsafe"
                                    "(...)"),
                                context=fn["qualname"]))
                for nxt, rec in g.edges_from(cur):
                    if rec["via_thread"] or rec["awaited"]:
                        continue
                    if g.functions[nxt]["is_async"]:
                        continue
                    stack.append(nxt)
        return out
