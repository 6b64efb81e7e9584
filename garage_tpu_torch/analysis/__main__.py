"""Port of garage_tpu/analysis/__main__.py: the default scan is the
port's package (`garage_tpu_torch/`) and its harness files, with
`chip_smoke.py` in the place of `bench.py`; the rest is the JAX
module with its issue and PR tags dropped.

CLI: python -m garage_tpu_torch.analysis [--format json|text|sarif] [paths]

Exit codes: 0 clean (waived/baselined findings allowed), 1 active
violations, 2 bad invocation. CI's lint job is exactly
`python -m garage_tpu_torch.analysis` (text output feeds the GitHub problem
matcher; `--format json` is the machine surface, `--format sarif`
emits a minimal SARIF 2.1.0 log for code-scanning upload).

Extras:
  --explain RULE        rule rationale + a firing and a suppressed
                        example, straight from the rule class
  --fix-waivers         delete stale `# lint: ignore[...]` comments
                        GL00 flags (dry-run by default; --write
                        applies); a multi-rule waiver where only SOME
                        rules are stale keeps the surviving rules
  --summary-cache PATH  reuse pass-1 dataflow summaries for files whose
                        sha256 is unchanged (CI keys the cache on the
                        tree hash; a miss just re-summarizes)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from . import (DEFAULT_BASELINE, META_RULE, analyze_paths,
               apply_baseline, default_rules, load_baseline,
               save_baseline)
from .core import WAIVER_RE

# harness files included in the default scan with the scoped
# GL04/GL05/GL07 subset (walker.HARNESS_RULES)
HARNESS_DEFAULTS = ("tests/clusterbox.py", "tests/conftest.py",
                    "chip_smoke.py")

GL00_EXPLAIN = {
    "rationale": (
        "The framework's own hygiene: a waiver that suppresses nothing, "
        "carries no reason, or names GL00 itself; a baseline entry that "
        "matches nothing; an unparseable file. Suppressions must not "
        "rot silently, so GL00 cannot be waived."),
    "example_fire": 'def f():  # lint: ignore[GL05] nothing fires here\n'
                    '    return 1',
    "example_ok": 'risky()  # lint: ignore[GL05] best-effort telemetry',
}


def _repo_root() -> str:
    # garage_tpu_torch/analysis/__main__.py -> repo root two levels above
    # the package
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def _explain(rule_id: str) -> int:
    rule_id = rule_id.strip().upper()
    if rule_id == META_RULE:
        info, name, summary = GL00_EXPLAIN, "(framework)", \
            "waiver/baseline hygiene"
    else:
        match = [r for r in default_rules() if r.id == rule_id]
        if not match:
            print(f"no such rule: {rule_id}", file=sys.stderr)
            return 2
        r = match[0]
        name, summary = r.name, r.summary
        info = {
            "rationale": getattr(r, "rationale", "") or r.summary,
            "example_fire": getattr(r, "example_fire", ""),
            "example_ok": getattr(r, "example_ok", ""),
        }
    print(f"{rule_id} {name}\n")
    print(f"  {summary}\n")
    print("rationale:")
    for line in info["rationale"].splitlines():
        print(f"  {line.strip()}" if line.strip() else "")
    if info["example_fire"]:
        print("\nfires on:\n")
        for line in info["example_fire"].splitlines():
            print(f"    {line}")
    if info["example_ok"]:
        print("\nquiet on:\n")
        for line in info["example_ok"].splitlines():
            print(f"    {line}")
    return 0


# GL00's per-rule staleness message names exactly the stale ids:
# "stale waiver for GL05,GL07: suppresses nothing ..."
_STALE_MSG_RE = re.compile(r"stale waiver for ([A-Z0-9,]+):")


def _fix_waivers(paths: list[str], root: str, write: bool) -> int:
    """Delete waiver comments GL00 reports as stale. Dry-run prints
    the edits; --write applies them. A multi-rule waiver where only
    some rules are stale is REWRITTEN to keep the surviving rules and
    the reason; the whole comment is removed only when every rule it
    names is stale, and a line that becomes empty is dropped."""
    rules = default_rules()
    violations, project = analyze_paths(paths, rules, root=root,
                                        data=_readme_data(root))
    stale: dict[str, dict[int, set[str]]] = {}
    for v in violations:
        if v.rule == META_RULE and "stale waiver" in v.message:
            m = _STALE_MSG_RE.search(v.message)
            ids = set(m.group(1).split(",")) if m else set()
            stale.setdefault(v.path, {}).setdefault(v.line,
                                                    set()).update(ids)
    if not stale:
        print("no stale waivers")
        return 0
    edits = 0
    for rel, lines in sorted(stale.items()):
        ap = os.path.join(root, rel)
        try:
            with open(ap, "r", encoding="utf-8") as f:
                src_lines = f.read().splitlines(keepends=True)
        except OSError as e:
            print(f"{rel}: unreadable ({e})", file=sys.stderr)
            continue
        for ln in sorted(lines, reverse=True):
            if ln - 1 >= len(src_lines):
                continue
            line = src_lines[ln - 1]
            nl = "\n" if line.endswith("\n") else ""
            wm = WAIVER_RE.search(line)
            keep: list[str] = []
            if wm and lines[ln]:
                named = [t.strip().upper()
                         for t in wm.group(1).split(",")]
                keep = [r for r in named if r and r not in lines[ln]]
            if keep:
                reason = wm.group(2).strip()
                comment = f"# lint: ignore[{','.join(keep)}]"
                if reason:
                    comment += f" {reason}"
                new_line = line[:wm.start()] + comment
                print(f"{rel}:{ln}: keep {','.join(keep)}: "
                      f"{line.rstrip()}")
                if write:
                    src_lines[ln - 1] = new_line + nl
            else:
                stripped = WAIVER_RE.sub("", line).rstrip()
                action = ("drop line" if not stripped.strip()
                          else "strip comment")
                print(f"{rel}:{ln}: {action}: {line.rstrip()}")
                if write:
                    if stripped.strip():
                        src_lines[ln - 1] = stripped + nl
                    else:
                        del src_lines[ln - 1]
            edits += 1
        if write:
            with open(ap, "w", encoding="utf-8") as f:
                f.write("".join(src_lines))
    verb = ("rewritten/removed" if write
            else "would rewrite/remove (dry-run; pass --write)")
    print(f"{edits} stale waiver(s) {verb}")
    return 0


def _to_sarif(active, rules) -> dict:
    """Minimal SARIF 2.1.0 log: one run, the rule table in
    tool.driver.rules, one result per active violation."""
    rule_meta = [{"id": r.id, "name": r.name,
                  "shortDescription": {"text": r.summary}}
                 for r in rules]
    rule_meta.append({"id": META_RULE, "name": "framework",
                      "shortDescription":
                          {"text": "waiver/baseline hygiene"}})
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": "garage-lint",
                                "rules": rule_meta}},
            "results": [{
                "ruleId": v.rule,
                "level": "error",
                "message": {"text": v.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": v.path},
                    "region": {"startLine": v.line,
                               "startColumn": max(v.col, 0) + 1},
                }}],
            } for v in active],
        }],
    }


def _readme_data(root: str) -> dict:
    # GL08's reverse direction accepts README documentation as a knob's
    # reason to exist
    data = {}
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        with open(readme, "r", encoding="utf-8") as f:
            data["readme_text"] = f.read()
    return data


def _load_summary_cache(path: str) -> dict:
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        return raw if isinstance(raw, dict) else {}
    except (OSError, ValueError):
        return {}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m garage_tpu_torch.analysis",
        description="garage-lint: project-invariant static analysis")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to scan (default: the "
                             "garage_tpu_torch package + harness files)")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default="text")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON path, or 'none' "
                             f"(default: <repo>/{DEFAULT_BASELINE})")
    parser.add_argument("--write-baseline", action="store_true",
                        help="snapshot current active violations into "
                             "the baseline file and exit 0")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--explain", metavar="RULE", default=None,
                        help="print a rule's rationale + fire/suppress "
                             "examples and exit")
    parser.add_argument("--fix-waivers", action="store_true",
                        help="delete stale waiver comments (dry-run "
                             "unless --write)")
    parser.add_argument("--write", action="store_true",
                        help="apply --fix-waivers edits in place")
    parser.add_argument("--summary-cache", default=None, metavar="PATH",
                        help="pass-1 summary cache JSON, keyed on file "
                             "sha256 (read + rewritten each run)")
    args = parser.parse_args(argv)

    if args.explain:
        return _explain(args.explain)

    root = _repo_root()
    paths = args.paths or [os.path.join(root, "garage_tpu_torch")] + [
        p for p in (os.path.join(root, h) for h in HARNESS_DEFAULTS)
        if os.path.exists(p)]

    if args.fix_waivers:
        return _fix_waivers(paths, root, args.write)

    rules = default_rules()
    if args.rules:
        want = {r.strip().upper() for r in args.rules.split(",")}
        rules = [r for r in rules if r.id in want]
        if not rules:
            print(f"no such rules: {args.rules}", file=sys.stderr)
            return 2

    data = _readme_data(root)
    if args.summary_cache:
        data["summary_cache"] = _load_summary_cache(args.summary_cache)

    t0 = time.monotonic()
    violations, project = analyze_paths(paths, rules, root=root,
                                        data=data,
                                        restricted=bool(args.rules))
    elapsed = time.monotonic() - t0

    if args.summary_cache and "_dataflow" in project.data:
        df = project.data["_dataflow"]
        tmp = args.summary_cache + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(args.summary_cache)),
                    exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(df.cache_payload(), f, sort_keys=True,
                      separators=(",", ":"))
        os.replace(tmp, args.summary_cache)

    baseline_path = args.baseline
    if baseline_path != "none":
        baseline_path = baseline_path or os.path.join(root,
                                                      DEFAULT_BASELINE)
        if args.write_baseline:
            n = save_baseline(baseline_path, violations)
            print(f"wrote {n} baseline entries to {baseline_path}")
            return 0
        violations.extend(apply_baseline(violations,
                                         load_baseline(baseline_path)))
        violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))

    active = [v for v in violations if v.active]
    if args.format == "sarif":
        print(json.dumps(_to_sarif(active, rules), indent=2,
                         sort_keys=True))
    elif args.format == "json":
        df = project.data.get("_dataflow")
        print(json.dumps({
            "violations": [v.to_dict() for v in active],
            "waived": sum(1 for v in violations if v.waived),
            "baselined": sum(1 for v in violations if v.baselined),
            "files": len(project.files),
            "elapsed_s": round(elapsed, 3),
            "summary_cache_hits": df.cache_hits if df else 0,
        }, indent=2))
    else:
        for v in active:
            print(v.render())
        waived = sum(1 for v in violations if v.waived)
        base = sum(1 for v in violations if v.baselined)
        print(f"{len(project.files)} files, {len(active)} violations "
              f"({waived} waived, {base} baselined) in {elapsed:.1f}s")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
