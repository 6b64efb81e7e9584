#!/usr/bin/env python3
"""The benchmark of garage_tpu_torch, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for (BENCHMARK.json). Builds or loads the port's kernels
(cached in garage_tpu_torch/_build/ inside the checkout), boots the
cell's cluster on cuda:0, does its set-up and warm-up, drives node 0's
S3 endpoint from the load generator's process for --seconds, checks
what the window produced against the plain reference, and prints the
compared numbers with their limits as the last lines of standard error
and one JSON object as the last line of standard output: the cell's
end-to-end metrics with --trace 0, its per-layer metrics (from the
port's spans and counters and a device trace of the window) with
--trace 1."""

import time

T_START = time.time()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def forbidden_modules() -> list[str]:
    from portbench.harness import FORBIDDEN

    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="plant a fault (portbench/faults.py): for the "
                    "control and the tests, never in a measured run")
    args = ap.parse_args()

    from portbench import harness

    try:
        manifest = harness.load_manifest()
        cell = harness.cell_of(manifest, args.workload)
    except (OSError, ValueError, harness.RunError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 3
    result = asyncio.run(harness.run(
        args.workload, args.seed, args.seconds, bool(args.trace), T_START,
        fault=args.fault, manifest=manifest))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)} (the benchmark and the "
              "port must load neither JAX nor the JAX package)",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        op = ">=" if c["bound"] == "min" else "<="
        print(f"check {name} {c['value']} {op} {c['limit']}",
              file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
