"""Copy of garage_tpu/analysis/__init__.py: import paths rewritten, issue and PR tags dropped.

garage-lint: project-invariant static analysis (stdlib-ast only).

Run it:  python -m garage_tpu_torch.analysis [--format json|text] [paths]
         python -m garage_tpu_torch.analysis --explain GL10
         python -m garage_tpu_torch.analysis --fix-waivers [--write]

Rules (each encodes an invariant an earlier PR established by hand):

  GL01 blocking-call-in-async   blocking I/O / digest-of-data on the
                                event loop ('s fast-path class)
  GL02 hedge-on-mutation        hedged or hedge-defaulting RPC on a
                                write endpoint ('s k2v pin); since
                                an earlier change strategies passed across
                                function boundaries resolve too
  GL03 ssec-cache-leak          SSE-C taint reaching the block cache
                                seam without explicit cacheable= —
                                true taint tracking across helper
                                boundaries since an earlier change
  GL04 orphan-task              create_task/ensure_future result dropped
  GL05 swallowed-exception      except Exception: pass (Aspirator)
  GL06 await-holding-lock       RPC awaited inside `with lock:` /
                                `async with lock:` (sync locks count
                                since an earlier change)
  GL07 unregistered-metric      dynamic / off-scheme metric names
  GL08 config-knob-drift        code<->utils/config.py key drift
  GL09 cross-worker-state       module-level mutable state in the
                                request plane (api/ qos/ gateway/ web/)
                                mutated from function scope
  GL10 blocking-reachable-from-async
                                a sync helper that blocks, called
                                transitively from an async def with no
                                to_thread hop (reports the full chain);
                                since an earlier change the db seam is the
                                @blocking_api annotation where the
                                call resolves, and iterating an
                                in-project generator counts
  GL11 leaked-budget-on-exception
                                qos token/lease/semaphore acquire whose
                                refund/release is not on every exit
                                path — cross-function since an earlier change
                                (acquire here / release in a callee
                                settles through the call graph)
  GL12 await-interleaving-atomicity
                                read -> await -> write on the same
                                shared lvalue with no lock across the
                                await (check-then-act race)
  GL13 lock-order-inversion     lock-acquisition cycles across the
                                global graph — the ABBA deadlock, both
                                chains reported; lock
                                identity is allocation-site-aware
                                since an earlier change
  GL14 jit-cache-key-leak       a jit/compile cache keyed on data-
                                dependent pattern values ('s
                                per-pattern program leak); device path
                                only (block/ ops/ parallel/)
  GL15 unpadded-device-launch   device_put / batched-kernel operand
                                sized from raw len()/max() instead of
                                the pad_buckets ladder; device path
                                only
  GL16 loop-touch-from-stage-thread
                                stage-executor-executed code reaching
                                loop-affine asyncio primitives without
                                the *_threadsafe crossings; device
                                path only
  GL00 (framework)              stale waivers, stale baseline entries,
                                unparseable files — cannot be waived

GL02/GL03/GL10-GL13 and GL16 run on the two-pass interprocedural
engine (dataflow.py summaries + callgraph.py resolution — see README
"How dataflow resolution works"). Since an earlier change the summaries carry
an explicit per-function CFG (path-sensitive GL11, loop-carried GL12),
allocation-site lock identity (per-instance GL13), and receiver type
facts that rank above unique-method CHA in call resolution. The runtime half is
utils/sanitizer.py (GARAGE_SANITIZE=1): loop-stall detection +
teardown leak/conservation checks wired into tests/conftest.py.

Waive a deliberate site inline, with a reason (checked for staleness):

    risky()  # lint: ignore[GL05] abort path; partial state dropped
"""

from __future__ import annotations

from .baseline import (DEFAULT_BASELINE, apply_baseline, load_baseline,
                       save_baseline)
from .callgraph import CallGraph
from .core import META_RULE, FileContext, ProjectState, Rule, Violation
from .dataflow import (DataflowState, summarize_tree, summary_fingerprint,
                       summary_json)
from .rules_async import (AwaitHoldingLock, BlockingCallInAsync,
                          OrphanTask, SwallowedException)
from .rules_concurrency import (AwaitInterleavingAtomicity,
                                LockOrderInversion)
from .rules_dataflow import (BlockingReachableFromAsync,
                             LeakedBudgetOnException)
from .rules_device import (JitCacheKeyLeak, LoopTouchFromStageThread,
                           UnpaddedDeviceLaunch)
from .rules_project import (ConfigKnobDrift, CrossWorkerState,
                            UnregisteredMetric)
from .rules_rpc import HedgeOnMutation, SsecCacheLeak
from .walker import analyze_paths, analyze_source

RULE_CLASSES = [
    BlockingCallInAsync,        # GL01
    HedgeOnMutation,            # GL02
    SsecCacheLeak,              # GL03
    OrphanTask,                 # GL04
    SwallowedException,         # GL05
    AwaitHoldingLock,           # GL06
    UnregisteredMetric,         # GL07
    ConfigKnobDrift,            # GL08
    CrossWorkerState,           # GL09
    BlockingReachableFromAsync,  # GL10
    LeakedBudgetOnException,    # GL11
    AwaitInterleavingAtomicity,  # GL12
    LockOrderInversion,         # GL13
    JitCacheKeyLeak,            # GL14
    UnpaddedDeviceLaunch,       # GL15
    LoopTouchFromStageThread,   # GL16
]


def default_rules() -> list[Rule]:
    """Fresh rule instances (cross-file rules carry per-run state)."""
    return [cls() for cls in RULE_CLASSES]


__all__ = [
    "analyze_paths", "analyze_source", "default_rules", "RULE_CLASSES",
    "Violation", "Rule", "FileContext", "ProjectState", "META_RULE",
    "DEFAULT_BASELINE", "load_baseline", "save_baseline",
    "apply_baseline", "CallGraph", "DataflowState", "summarize_tree",
    "summary_fingerprint", "summary_json",
]
