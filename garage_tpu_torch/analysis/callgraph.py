"""Copy of garage_tpu/analysis/callgraph.py: import paths rewritten, issue and PR tags dropped.

Best-effort project call graph over pass-1 summaries.

Resolution is deliberately conservative — an edge exists only when the
target is nameable with high confidence:

  * bare names: the caller's own nested defs (walking up the enclosing-
    function chain), then module-level functions, then imports that
    land on a project function;
  * `self.m` / `cls.m`: the enclosing class's methods, then base
    classes resolvable in-project (depth-limited, cycle-tolerant);
  * `mod.func` dotted chains rooted at an imported module;
  * `obj.m` on an arbitrary receiver: receiver TYPE facts from pass 1
    (parameter annotations, `x = Cls(...)` constructor assignments,
    `isinstance` guards — import-aware) rank first: a typed
    receiver resolves through its class, and a receiver typed to an
    out-of-project import contributes NO edge even when CHA would have
    guessed one (the `ET.Element.iter` vs `db.Tree.iter` fix); only
    untyped receivers fall back to class-hierarchy analysis, and ONLY
    when exactly one project class defines `m` (unique-method CHA) —
    common names like `get` disqualify themselves by ubiquity;
  * `asyncio.to_thread(f, ...)`, `loop.run_in_executor(_, f, ...)` and
    `functools.partial(f, ...)` were unwrapped in pass 1: the edge
    targets `f`, flagged `via_thread` for the executor hops so the
    blocking rule knows the frame left the loop.

Unresolved calls simply contribute no edge: the flow rules under-report
rather than guess. Reachability queries are iterative with a visited
set, so call cycles (A -> B -> A) terminate.
"""

from __future__ import annotations

from typing import Iterator, Optional

# self.m resolution climbs at most this many base-class links
_BASE_DEPTH = 4

# tri-state marker for typed-receiver resolution: "no type fact" (fall
# back to CHA), distinct from None ("typed: definitely no project edge")
_UNKNOWN = object()


class CallGraph:
    def __init__(self, file_summaries: dict[str, dict]):
        """file_summaries: rel_path -> summarize_tree() product."""
        self.files = file_summaries
        # module -> file summary
        self.modules: dict[str, dict] = {}
        # global function id "module:qualname" -> function summary
        self.functions: dict[str, dict] = {}
        # method name -> sorted list of function ids (for unique CHA)
        self._methods: dict[str, list[str]] = {}
        # function id -> list of (callee id, call record)
        self._edges: dict[str, list[tuple[str, dict]]] = {}

        # functions that are blocking-by-annotation: @blocking_api on
        # the def, or `blocking_api = True` on the enclosing class —
        # the exact replacement for GL10's db-receiver-name heuristic
        # wherever the call resolves in-project (satellite)
        self._annotated: set[str] = set()
        # top-level package names of the project itself — an import
        # whose target leaves this set types its receiver as external
        self._project_roots: set[str] = {
            fs["module"].split(".")[0] for fs in file_summaries.values()}

        for fs in file_summaries.values():
            self.modules[fs["module"]] = fs
            for qn, fn in fs["functions"].items():
                fid = f"{fs['module']}:{qn}"
                self.functions[fid] = fn
                cls = fs["classes"].get(fn.get("class") or "")
                if fn.get("blocking_api") \
                        or (cls is not None and cls.get("blocking_api")):
                    self._annotated.add(fid)
        for fs in file_summaries.values():
            for cname, cls in fs["classes"].items():
                for m, mq in cls["methods"].items():
                    self._methods.setdefault(m, []).append(
                        f"{fs['module']}:{mq}")
        for m in self._methods:
            self._methods[m].sort()
        for fid, fn in self.functions.items():
            self._edges[fid] = []
            for rec in fn["calls"]:
                callee = self.resolve(fid, rec)
                if callee is not None and callee in self.functions:
                    self._edges[fid].append((callee, rec))

    # ---- resolution -----------------------------------------------------

    def resolve(self, caller_id: str, rec: dict) -> Optional[str]:
        module, qualname = caller_id.split(":", 1)
        fs = self.modules.get(module)
        if fs is None:
            return None
        kind, target = rec["ref"][0], rec["ref"][1]
        if kind == "name":
            return self._resolve_name(fs, qualname, target)
        if kind == "self":
            fn = self.functions.get(caller_id)
            cls = fn.get("class") if fn else None
            if cls:
                hit = self._resolve_method(fs, cls, target, 0, set())
                if hit:
                    return hit
            # fall back to unique-method CHA: covers a base class
            # calling a method only its (single) subclass defines
            hits = self._methods.get(target, [])
            return hits[0] if len(hits) == 1 else None
        if kind == "dotted":
            hit = self._resolve_dotted(fs, target)
            if hit:
                return hit
            # not an import-rooted chain: treat the last segment as a
            # method receiver and fall back to unique-method CHA
            target = target.rsplit(".", 1)[-1]
            kind = "attr"
        if kind == "attr":
            typed = self._resolve_typed(caller_id, fs, rec, target)
            if typed is not _UNKNOWN:
                return typed
            hits = self._methods.get(target, [])
            if len(hits) == 1:
                return hits[0]
            return None
        return None

    def _resolve_typed(self, caller_id: str, fs: dict, rec: dict,
                       method: str):
        """Import-aware receiver typing. When pass 1 learned
        the single-name receiver's type (parameter annotation,
        constructor assignment, isinstance guard), that fact outranks
        unique-method CHA: an in-project class resolves through
        `_resolve_method` (None when the method is absent there), and a
        receiver typed by an import that leaves the project is external
        — no project edge, no CHA guess. Returns a function id, None
        (authoritative negative), or _UNKNOWN (no usable type fact)."""
        recv = rec.get("recv") or []
        if len(recv) != 1 or recv[0] in ("self", "cls"):
            return _UNKNOWN
        fn = self.functions.get(caller_id)
        if fn is None:
            return _UNKNOWN
        vt = (fn.get("var_types") or {}).get(recv[0])
        if not vt:
            return _UNKNOWN
        chain = vt["t"].split(".")
        cls_fs, cls_name = self._class_of_chain(fs, chain)
        if cls_name is not None:
            return self._resolve_method(cls_fs, cls_name, method, 0,
                                        set())
        imp = fs["imports"].get(chain[0])
        if imp is not None \
                and imp.split(".")[0] not in self._project_roots:
            return None
        return _UNKNOWN

    def _class_of_chain(self, fs: dict, chain: list):
        """(file_summary, class_name) when a type chain names an
        in-project class — same-module by bare name, or through this
        module's imports ("mod.Cls", an aliased class, a re-export) —
        else (None, None)."""
        if len(chain) == 1 and chain[0] in fs["classes"]:
            return fs, chain[0]
        imp = fs["imports"].get(chain[0])
        if imp is None:
            return None, None
        dotted = imp + ("." + ".".join(chain[1:])
                        if len(chain) > 1 else "")
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            tfs = self.modules.get(mod)
            if tfs is not None:
                cls = ".".join(parts[i:])
                if cls in tfs["classes"]:
                    return tfs, cls
                return None, None
        return None, None

    def _resolve_name(self, fs: dict, caller_qn: str,
                      name: str) -> Optional[str]:
        # 1) nested defs of the caller, walking up the parent chain
        qn = caller_qn
        while qn:
            fn = fs["functions"].get(qn)
            if fn is None:
                break
            nested = fn.get("nested", {})
            if name in nested:
                return f"{fs['module']}:{nested[name]}"
            qn = fn.get("parent", "")
        # 2) module-level functions
        if name in fs["top_functions"]:
            return f"{fs['module']}:{fs['top_functions'][name]}"
        # 3) imports landing on a project function
        tgt = fs["imports"].get(name)
        if tgt:
            return self._function_id_for(tgt)
        return None

    def _resolve_dotted(self, fs: dict, dotted: str) -> Optional[str]:
        root, rest = (dotted.split(".", 1) + [""])[:2]
        base = fs["imports"].get(root)
        if base is None or not rest:
            return None
        return self._function_id_for(f"{base}.{rest}")

    def _function_id_for(self, dotted: str) -> Optional[str]:
        """'pkg.mod.func' or 'pkg.mod.Class.meth' -> function id."""
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            fs = self.modules.get(mod)
            if fs is None:
                continue
            qn = ".".join(parts[i:])
            if qn in fs["functions"]:
                return f"{mod}:{qn}"
            return None
        return None

    def _resolve_method(self, fs: dict, cls: str, method: str,
                        depth: int, seen: set) -> Optional[str]:
        if depth > _BASE_DEPTH or (fs["module"], cls) in seen:
            return None
        seen.add((fs["module"], cls))
        cinfo = fs["classes"].get(cls)
        if cinfo is None:
            return None
        if method in cinfo["methods"]:
            return f"{fs['module']}:{cinfo['methods'][method]}"
        for base in cinfo.get("bases", []):
            base_name = base.split(".")[-1]
            # base in the same module?
            if base_name in fs["classes"]:
                hit = self._resolve_method(fs, base_name, method,
                                           depth + 1, seen)
                if hit:
                    return hit
                continue
            # imported base?
            tgt = fs["imports"].get(base.split(".")[0])
            if tgt:
                dotted = tgt + ("." + ".".join(base.split(".")[1:])
                                if "." in base else "")
                for i in range(len(dotted.split(".")), 0, -1):
                    mod = ".".join(dotted.split(".")[:i])
                    bfs = self.modules.get(mod)
                    if bfs is not None:
                        bcls = ".".join(dotted.split(".")[i:])
                        if bcls:
                            hit = self._resolve_method(
                                bfs, bcls, method, depth + 1, seen)
                            if hit:
                                return hit
                        break
        return None

    # ---- queries --------------------------------------------------------

    def edges_from(self, fid: str) -> list[tuple[str, dict]]:
        return self._edges.get(fid, [])

    def resolve_ref(self, caller_id: str, ref: list) -> Optional[str]:
        """Resolve a bare call ref (no full record) to a function id
        known to the graph, or None."""
        callee = self.resolve(caller_id, {"ref": ref})
        return callee if callee in self.functions else None

    def is_blocking_api(self, fid: Optional[str]) -> bool:
        return fid in self._annotated

    def atoms_of(self, fid: str):
        """The function's EFFECTIVE blocking atoms:

          * hard-I/O atoms unchanged;
          * heuristic db atoms (db-named receiver + db-verb method)
            kept only when the call does NOT resolve to an in-project
            function, or resolves to a @blocking_api one — the
            annotation is authoritative wherever it can speak, the
            name heuristic covers out-of-tree callables;
          * calls (non-awaited, non-thread-hop) resolving to a
            @blocking_api function become atoms even where the
            receiver name never matched the heuristic.
        """
        fn = self.functions.get(fid)
        if fn is None:
            return
        seen_lines = set()
        for atom in fn["blocking"]:
            if atom["kind"] != "db":
                yield atom
                continue
            ref = atom.get("ref")
            callee = self.resolve_ref(fid, ref) if ref else None
            if callee is None or callee in self._annotated:
                seen_lines.add(atom["line"])
                yield atom
        for callee, rec in self.edges_from(fid):
            if callee in self._annotated and not rec["awaited"] \
                    and not rec["via_thread"] \
                    and rec["line"] not in seen_lines:
                target = self.functions[callee]
                yield {"target": target["qualname"],
                       "line": rec["line"], "kind": "api"}

    def bound_call(self, caller_id: str, rec: dict) -> bool:
        """True when the call binds its receiver as `self` — positional
        arguments then land one parameter later. self/attr refs are
        bound by construction; a "dotted" ref is bound iff it did NOT
        resolve through an imported module (i.e. it fell back to
        unique-method CHA on `obj.m`)."""
        kind = rec["ref"][0]
        if kind in ("self", "attr"):
            return True
        if kind == "dotted":
            module = caller_id.split(":", 1)[0]
            fs = self.modules.get(module)
            return not (fs is not None
                        and self._resolve_dotted(fs, rec["ref"][1]))
        return False

    def blocking_chains(self, fid: str,
                        max_depth: int = 8) -> Iterator[list]:
        """Chains [ (callee id, call record)..., blocking atom ] from
        `fid` through SYNC project frames to a blocking atom, skipping
        thread-hop edges, async callees (their own rule's business) and
        generators — EXCEPT a generator reached by ITERATION (`for x
        in gen(...)` / `async for`): iterating runs the body on this
        frame, so its atoms count, reported at the iteration site
        (satellite; plain calls stay exempt). @blocking_api
        callees are atoms themselves (atoms_of) and are not expanded.
        Cycle-tolerant: a function is expanded at most once per
        query."""
        visited = {fid}
        stack: list[tuple[str, list]] = [(fid, [])]
        while stack:
            cur, path = stack.pop()
            for callee, rec in sorted(self.edges_from(cur),
                                      key=lambda e: (e[1]["line"], e[0])):
                if rec["via_thread"]:
                    continue
                if callee in visited:
                    continue
                target = self.functions[callee]
                iterated_gen = target["is_generator"] \
                    and rec.get("iterated")
                if (target["is_async"] or target["is_generator"]) \
                        and not iterated_gen:
                    continue
                if callee in self._annotated:
                    continue  # the CALL is the atom (atoms_of)
                visited.add(callee)
                new_path = path + [(callee, rec)]
                for atom in self.atoms_of(callee):
                    yield new_path + [atom]
                if len(new_path) < max_depth:
                    stack.append((callee, new_path))

    def param_index(self, fid: str, pos: int,
                    shift_self: bool) -> Optional[str]:
        """Name of the callee parameter a positional argument lands on
        (accounting for the bound `self` when called as a method)."""
        fn = self.functions.get(fid)
        if fn is None:
            return None
        params = fn["params"]
        if shift_self and fn.get("is_method"):
            pos += 1
        return params[pos] if pos < len(params) else None
