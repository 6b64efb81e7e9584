"""Time a writer's own replicate copy against its PUT's quorum return, in
the cluster of the chaos suite's EIO test
(`test_local_disk_eio_degrades_to_remote_read`: make_block_cluster(n=3,
rf=3), one 72,000-byte block), for the JAX package and the port.

`_put_replicate` returns at the write quorum (2 of 3), so node 0's own
write may land after the PUT returns; the test's disk fault fires only
if it landed before the GET. Each round runs the test's body and
records when each node's `write_local_payload` started and ended
against the quorum return, whether node 0's copy was on disk when the
PUT returned, and whether the fault fired.

Usage (from the repository root, on the CPU):

    python scripts/put_quorum_race.py --rounds 40 --load 2 \\
        jax port port-native-hash port-1thread

runs each variant in its own process, all at once, while `--load`
processes each of the JAX package's and the port's chaos + zones suites
loop beside them; it prints one summary line per variant. Variants:
`jax` (the JAX package's nodes, feeder "off" as in its tests), `port`
(port nodes on "cpu", feeder "require": the content hash through the
feeder's linger and the plain torch BLAKE3), `port-native-hash` (the
same, the content hash by `native.blake3` instead), `port-1thread`
(the same as `port` with one torch intra-op thread).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("jax", "port", "port-native-hash", "port-1thread")
LOAD_SUITES = (("tests/test_chaos.py", "tests/test_zones.py"),
               ("tests/test_torch_chaos.py", "tests/test_torch_zones.py"))


def _modules(variant: str):
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["GARAGE_TPU_DEVICE"] = "off"
    if variant == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import test_block as helpers
        from garage_tpu import chaos, native
    else:
        import torch

        if variant == "port-1thread":
            torch.set_num_threads(1)
        from test_torch_copies import port_helper

        from garage_tpu_torch import chaos, native
        helpers = port_helper("test_block")
    native.available()
    return helpers, chaos, native


async def _round(tmp: str, variant: str, helpers, chaos, native) -> dict:
    net, systems, managers, tasks = await helpers.make_block_cluster(
        pathlib.Path(tmp), n=3, rf=3)
    marks: dict = {}
    for i, m in enumerate(managers):
        def timed(h, comp, payload, _write=m.write_local_payload, _i=i):
            marks[("start", _i)] = time.monotonic()
            _write(h, comp, payload)
            marks[("end", _i)] = time.monotonic()
        m.write_local_payload = timed
    try:
        data = b"chaos-eio-payload " * 4000
        t0 = time.monotonic()
        if variant == "port-native-hash":
            h = native.blake3(data)
        else:
            h = await managers[0].hash_block(data)
        t1 = time.monotonic()
        await managers[0].rpc_put_block(h, data, compress=False)
        tq = time.monotonic()
        landed = managers[0].has_local(h)
        managers[0].cache.configure(max_bytes=0)
        c = chaos.arm(seed=8)
        c.add(chaos.FaultSpec(kind="disk_read_error",
                              node=systems[0].id.hex()[:8],
                              hash_prefix=h.hex()[:8]))
        got = await managers[0].rpc_get_block(h, cacheable=False)
        assert got == data
        fired = c.total_fired
        chaos.disarm()
        await asyncio.sleep(0.2)  # the late copies land before teardown
        ms = {k: (v - t1) * 1e3 for k, v in marks.items()}
        return {
            "hash_ms": (t1 - t0) * 1e3,
            "quorum_ms": (tq - t1) * 1e3,
            "local_start_ms": ms.get(("start", 0)),
            "local_end_ms": ms.get(("end", 0)),
            "remote_end_ms": sorted(ms[("end", i)] for i in (1, 2)
                                    if ("end", i) in ms),
            "landed_at_return": landed,
            "fired": fired,
        }
    finally:
        chaos.disarm()
        await helpers.stop_all(systems, tasks)


def run_variant(variant: str, rounds: int) -> None:
    helpers, chaos, native = _modules(variant)
    recs = []
    for _ in range(rounds):
        with tempfile.TemporaryDirectory() as tmp:
            recs.append(asyncio.run(_round(tmp, variant, helpers, chaos,
                                           native)))
        print(json.dumps(recs[-1]), flush=True)
    late = [r for r in recs if r["local_end_ms"] > r["quorum_ms"]]
    print("SUMMARY " + json.dumps({
        "variant": variant, "rounds": len(recs),
        "fault_not_fired": sum(1 for r in recs if r["fired"] < 1),
        "not_landed_at_return": sum(1 for r in recs
                                    if not r["landed_at_return"]),
        "local_end_after_quorum": len(late),
        "median_hash_ms": statistics.median(r["hash_ms"] for r in recs),
        "median_quorum_ms": statistics.median(r["quorum_ms"] for r in recs),
        "median_local_start_ms": statistics.median(
            r["local_start_ms"] for r in recs),
        "median_local_write_ms": statistics.median(
            r["local_end_ms"] - r["local_start_ms"] for r in recs),
        "median_first_remote_end_ms": statistics.median(
            r["remote_end_ms"][0] for r in recs),
    }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", choices=VARIANTS)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--load", type=int, default=2,
                    help="processes of each package's chaos + zones "
                         "suites looping beside the rounds")
    ap.add_argument("--one", action="store_true",
                    help="run the single variant in this process")
    args = ap.parse_args()
    if args.one:
        run_variant(args.variants[0], args.rounds)
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    loop_cmd = ("while true; do python -m pytest -q -p no:cacheprovider "
                "-m 'not slow' {} > /dev/null 2>&1; done")
    load = [subprocess.Popen(["bash", "-c", loop_cmd.format(" ".join(s))],
                             cwd=REPO, env=env, start_new_session=True)
            for s in LOAD_SUITES for _ in range(args.load)]
    try:
        time.sleep(20 if load else 0)  # the suites reach their tests
        runs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), v, "--one",
             "--rounds", str(args.rounds)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, text=True) for v in args.variants]
        for p in runs:
            out, _ = p.communicate()
            summary = [ln for ln in out.splitlines()
                       if ln.startswith("SUMMARY ")]
            print(summary[-1] if summary else f"failed: {p.args}",
                  flush=True)
    finally:
        for p in load:
            os.killpg(p.pid, 15)
            p.wait()


if __name__ == "__main__":
    main()
