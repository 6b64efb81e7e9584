"""Copy of garage_tpu/analysis/baseline.py: import paths rewritten, issue and PR tags dropped.

Committed baseline for grandfathered violations.

The baseline is the escape valve that lets the lint gate land strict
from day one: pre-existing violations that are deliberate (and carry
too much context for an inline waiver) are enumerated in a committed
JSON file; everything NOT listed fails the build. Entries match on
(rule, path, context) — context is the enclosing def/class qualname —
so ordinary line churn around a grandfathered site does not break CI,
while moving or duplicating the pattern into NEW code does.

Baseline entries rot like waivers do: an entry that matches nothing is
reported as a GL00 violation, so the file can only shrink. an earlier change
ships it (near-)empty — the point of the PR is fixing the findings,
not cataloguing them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from .core import META_RULE, Violation

BASELINE_VERSION = 1
DEFAULT_BASELINE = "lint-baseline.json"


@dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    context: str
    reason: str = ""

    def key(self) -> tuple:
        return (self.rule, self.path, self.context)


def load_baseline(path: str) -> list[BaselineEntry]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
    except FileNotFoundError:
        return []
    entries = []
    for e in raw.get("entries", []):
        entries.append(BaselineEntry(
            rule=e["rule"], path=e["path"],
            context=e.get("context", "<module>"),
            reason=e.get("reason", "")))
    return entries


def save_baseline(path: str, violations: list[Violation]) -> int:
    """--write-baseline: snapshot every active violation. Dedupes on
    the match key (one entry covers all same-shaped sites in a
    scope)."""
    seen = set()
    entries = []
    for v in violations:
        if not v.active or v.rule == META_RULE:
            continue
        k = (v.rule, v.path, v.context)
        if k in seen:
            continue
        seen.add(k)
        entries.append({"rule": v.rule, "path": v.path,
                        "context": v.context,
                        "reason": "grandfathered; fix or justify"})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": BASELINE_VERSION, "entries": entries},
                  f, indent=2, sort_keys=True)
        f.write("\n")
    return len(entries)


def apply_baseline(violations: list[Violation],
                   entries: list[BaselineEntry]) -> list[Violation]:
    """Mark baselined violations in place; returns GL00 violations for
    entries that no longer match anything (stale suppression)."""
    used: set[tuple] = set()
    by_key: dict[tuple, BaselineEntry] = {e.key(): e for e in entries}
    for v in violations:
        if v.rule == META_RULE or v.waived:
            continue
        e = by_key.get((v.rule, v.path, v.context))
        if e is not None:
            v.baselined = True
            used.add(e.key())
    stale = []
    for e in entries:
        if e.key() in used:
            continue
        stale.append(Violation(
            rule=META_RULE, path=e.path, line=1, col=0,
            message=f"stale baseline entry {e.rule} in context "
                    f"`{e.context}`: matches nothing — remove it",
            context=e.context))
    return stale
