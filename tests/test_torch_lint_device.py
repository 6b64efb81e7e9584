"""The port's device rules (garage_tpu_torch/analysis/rules_device.py)
on the port's own idioms: GL14 on a pattern-keyed CUDA graph, kernel
build or launch plan; GL15 on a raw-sized `.to(<device>)`, `.cuda()`,
device allocation or kernel-wrapper operand; GL16 on a loop-affine call
in a `TorchDeviceBackend` or `StubDeviceBackend` stage method. Each
firing fixture has a quiet twin (the pattern as data, the shape up the
pad ladder, the thread-safe crossing). The JAX package's own fixtures
run against these rules in tests/test_torch_lint_v4.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

from garage_tpu_torch.analysis import analyze_source, default_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(src: str, rel_path: str):
    ctx = analyze_source(textwrap.dedent(src), default_rules(),
                         rel_path=rel_path)
    return [v for v in ctx.violations if v.active]


def rules_of(violations):
    return sorted({v.rule for v in violations})


# ---- GL14: a launch artifact cached per erasure pattern -----------------

GL14_GRAPH = """
    import functools

    import torch

    @functools.lru_cache(maxsize=None)
    def graph_for(k, m, present):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            pass
        return g
"""

GL14_CASES = {
    # (fires, quiet)
    "cuda_graph": (GL14_GRAPH, """
        import functools

        import torch

        @functools.lru_cache(maxsize=None)
        def graph_for(k, rows, shard_len):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                pass
            return g
    """),
    "graph_context": ("""
        import functools

        import torch

        @functools.lru_cache(maxsize=None)
        def capture(step, missing):
            with torch.cuda.graph(step.graph):
                step()
            return step
    """, """
        import functools

        import torch

        @functools.lru_cache(maxsize=None)
        def capture(step, rows):
            with torch.cuda.graph(step.graph):
                step()
            return step
    """),
    "kernel_build": ("""
        import functools

        from . import _build

        @functools.lru_cache(maxsize=None)
        def lib_for(k, missing):
            return _build.load(f"gf256_{k}", {})
    """, """
        import functools

        from . import _build

        @functools.lru_cache(maxsize=None)
        def lib_for(k):
            return _build.load(f"gf256_{k}", {})
    """),
    "library_plan": ("""
        import functools

        @functools.lru_cache(maxsize=1024)
        def plan_for(b, k, s, present, device):
            return g1_plan(b, k, len(present), s, device)
    """, """
        import functools

        @functools.lru_cache(maxsize=1024)
        def plan_for(b, k, r, s, device):
            return g1_plan(b, k, r, s, device)
    """),
    "library_planner_call": ("""
        import functools

        @functools.lru_cache(maxsize=1024)
        def plan_for(b, c, pattern):
            lib = load()
            return lib.gt_b3_plan(b, c, pattern)
    """, """
        import functools

        @functools.lru_cache(maxsize=1024)
        def plan_for(b, c):
            lib = load()
            return lib.gt_b3_plan(b, c)
    """),
    "graph_subscript": ("""
        class Steps:
            def get(self, k, present):
                key = (k, present)
                return self._graphs[key]
    """, """
        class Steps:
            def get(self, k, present):
                key = (k, len(present))
                return self._graphs[key]
    """),
    "plan_subscript": ("""
        def launch(plans, k, missing):
            return plans[(k, missing)]
    """, """
        def launch(plans, k, missing):
            return plans[(k, len(missing))]
    """),
}


@pytest.mark.parametrize("idiom", sorted(GL14_CASES))
def test_gl14_fires_on_pattern_keyed_port_artifact(idiom):
    vs = run(GL14_CASES[idiom][0], "garage_tpu_torch/ops/fake_cache.py")
    assert rules_of(vs) == ["GL14"], [v.render() for v in vs]


@pytest.mark.parametrize("idiom", sorted(GL14_CASES))
def test_gl14_quiet_on_shape_keyed_twin(idiom):
    vs = run(GL14_CASES[idiom][1], "garage_tpu_torch/ops/fake_cache.py")
    assert vs == [], [v.render() for v in vs]


def test_gl14_names_the_artifact():
    vs = run(GL14_GRAPH, "garage_tpu_torch/parallel/fake_graph.py")
    assert len(vs) == 1
    assert "a CUDA graph" in vs[0].message and "present" in vs[0].message


def test_gl14_plain_matrix_cache_is_quiet():
    # ops/rs.py keys its host matrices on the pattern on purpose: tiny
    # numpy inverses, no launch artifact
    vs = run("""
        import functools

        @functools.lru_cache(maxsize=None)
        def decode_matrix(k, m, present):
            return invert(k, m, present)
    """, "garage_tpu_torch/ops/fake_rs.py")
    assert vs == []


# ---- GL15: a raw-sized operand reaching the card ------------------------

GL15_EMPTY = """
    import torch

    def stage(blobs, n, dev):
        return torch.empty((len(blobs), n), dtype=torch.uint8, device=dev)
"""

GL15_CASES = {
    "torch_empty_device": (GL15_EMPTY, """
        import torch

        def stage(blobs, n, dev, buckets):
            b = bucket_items(len(blobs), buckets)
            return torch.empty((b, n), dtype=torch.uint8, device=dev)
    """),
    "to_self_device": ("""
        import torch

        class Backend:
            def stage(self, blobs, n):
                buf = torch.empty((len(blobs), n), dtype=torch.uint8)
                return buf.to(self.device, non_blocking=True)
    """, """
        import torch

        class Backend:
            def stage(self, blobs, n):
                b = bucket_items(len(blobs), self.pad_buckets)
                buf = torch.empty((b, n), dtype=torch.uint8)
                return buf.to(self.device, non_blocking=True)
    """),
    "cuda": ("""
        import numpy as np
        import torch

        def stage(rows, lens):
            buf = np.zeros((len(rows), max(lens)), dtype=np.uint8)
            return torch.from_numpy(buf).cuda()
    """, """
        import numpy as np
        import torch

        def stage(rows, lens):
            b, width = pad_shape(len(rows), max(lens))
            buf = np.zeros((b, width), dtype=np.uint8)
            return torch.from_numpy(buf).cuda()
    """),
    "as_tensor_device": ("""
        import numpy as np
        import torch

        def lengths_of(blobs, dev):
            lens = np.zeros(len(blobs), dtype=np.int32)
            return torch.as_tensor(lens, device=dev)
    """, """
        import numpy as np
        import torch

        def lengths_of(blobs, dev):
            lens = np.zeros(bucket_items(len(blobs)), dtype=np.int32)
            return torch.as_tensor(lens, device=dev)
    """),
    "tensor_device": ("""
        import torch

        def counters(blobs, dev):
            return torch.tensor([0] * len(blobs), device=dev)
    """, """
        import torch

        def counters(blobs, dev):
            return torch.tensor([0] * bucket_items(len(blobs)), device=dev)
    """),
    "zeros_device": ("""
        import torch

        def out_for(rows, dev):
            return torch.zeros(len(rows), 32, device=dev)
    """, """
        import torch

        def out_for(rows, dev):
            return torch.zeros(bucket_items(len(rows)), 32, device=dev)
    """),
    "full_device": ("""
        import torch

        def lengths_for(rows, s, dev):
            return torch.full((len(rows),), s, dtype=torch.int32, device=dev)
    """, """
        import torch

        def lengths_for(rows, s, dev):
            return torch.full((bucket_items(len(rows)),), s,
                              dtype=torch.int32, device=dev)
    """),
    "gf_apply_operand": ("""
        import torch

        def decode(mats, shards, k, s):
            stack = torch.zeros((len(shards), k, s), dtype=torch.uint8)
            return gf_apply(mats, stack)
    """, """
        import torch

        def decode(mats, shards, k, s, buckets):
            b = bucket_items(len(shards), buckets)
            stack = torch.zeros((b, k, s), dtype=torch.uint8)
            return gf_apply(mats, stack)
    """),
    "gf_check_operand": ("""
        import torch

        def scrub(mats, stripes, n, s):
            arr = torch.empty((len(stripes), n, s), dtype=torch.uint8)
            return gf_check(mats, arr)
    """, """
        import torch

        def scrub(mats, stripes, n, s):
            arr = torch.empty((bucket_items(len(stripes)), n, s),
                              dtype=torch.uint8)
            return gf_check(mats, arr)
    """),
    "hash_rows_operand": ("""
        import torch

        def hash_all(blobs, lengths, padded):
            buf = torch.zeros((len(blobs), padded), dtype=torch.uint8)
            return hash_rows(buf, lengths)
    """, """
        import torch

        def hash_all(blobs, lengths, padded):
            buf = torch.zeros((bucket_items(len(blobs)), padded),
                              dtype=torch.uint8)
            return hash_rows(buf, lengths)
    """),
    "blake3_rows_operand": ("""
        import torch

        def hash_all(blobs, lengths, padded):
            buf = torch.zeros((len(blobs), padded), dtype=torch.uint8)
            return blake3_rows(buf, lengths)
    """, """
        import torch

        def hash_all(blobs, lengths, padded):
            b = bucket_items(len(blobs))
            buf = torch.zeros((b, padded), dtype=torch.uint8)
            return blake3_rows(buf, lengths)
    """),
    "staging_wrappers": ("""
        import torch

        class Backend:
            def _host(self, shape):
                t = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                return t, t.numpy()

            def _to_device(self, t):
                return t.to(self.device, non_blocking=True)

            def _stage(self, datas, width):
                buf_t, buf = self._host((len(datas), width))
                return self._to_device(buf_t)
    """, """
        import torch

        class Backend:
            def _host(self, shape):
                t = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                return t, t.numpy()

            def _to_device(self, t):
                return t.to(self.device, non_blocking=True)

            def _stage(self, datas, width):
                b = bucket_items(len(datas), self.pad_buckets)
                buf_t, buf = self._host((b, width))
                return self._to_device(buf_t)
    """),
}


@pytest.mark.parametrize("idiom", sorted(GL15_CASES))
def test_gl15_fires_on_raw_sized_port_launch(idiom):
    vs = run(GL15_CASES[idiom][0], "garage_tpu_torch/block/fake_stage.py")
    assert rules_of(vs) == ["GL15"], [v.render() for v in vs]


@pytest.mark.parametrize("idiom", sorted(GL15_CASES))
def test_gl15_quiet_on_bucketed_twin(idiom):
    vs = run(GL15_CASES[idiom][1], "garage_tpu_torch/block/fake_stage.py")
    assert vs == [], [v.render() for v in vs]


def test_gl15_dtype_conversion_moves_nothing():
    # `.to(torch.int32)` converts on the tensor's own device
    vs = run("""
        import torch

        def widen(blobs):
            buf = torch.zeros((len(blobs), 64), dtype=torch.uint8)
            return buf.to(torch.int32)
    """, "garage_tpu_torch/ops/fake_widen.py")
    assert vs == []


def test_gl15_reports_each_launch_once():
    vs = run("""
        import torch

        def stage(blobs, n, dev, ok):
            if ok:
                with torch.no_grad():
                    return torch.empty((len(blobs), n), device=dev)
    """, "garage_tpu_torch/block/fake_stage.py")
    assert [v.rule for v in vs] == ["GL15"]


# ---- GL16: the loop touched from a stage thread -------------------------

GL16_COMPUTE = """
    class TorchDeviceBackend:
        def compute(self, op, staged):
            self.loop.call_soon(self._deliver, op, staged)
"""

GL16_CASES = {
    "torch_compute_call_soon": (GL16_COMPUTE, """
        class TorchDeviceBackend:
            def compute(self, op, staged):
                self.loop.call_soon_threadsafe(self._deliver, op, staged)
    """),
    "stub_stage_set_result": ("""
        class StubDeviceBackend:
            def stage(self, op, blobs):
                self._fut.set_result(blobs)
                return (op, blobs, None)
    """, """
        class StubDeviceBackend:
            def stage(self, op, blobs):
                self.loop.call_soon_threadsafe(self._fut.set_result, blobs)
                return (op, blobs, None)
    """),
    "torch_readback_helper": ("""
        class TorchDeviceBackend:
            def readback(self, op, handle):
                return self._readback(op, handle)

            def _readback(self, op, handle):
                self.loop.call_later(0.0, self._finish, handle)
                return []
    """, """
        class TorchDeviceBackend:
            def readback(self, op, handle):
                return self._readback(op, handle)

            def _readback(self, op, handle):
                self.loop.call_soon_threadsafe(self._finish, handle)
                return []
    """),
}


@pytest.mark.parametrize("idiom", sorted(GL16_CASES))
def test_gl16_fires_on_loop_touch_in_port_backend(idiom):
    vs = run(GL16_CASES[idiom][0], "garage_tpu_torch/block/fake_backend.py")
    assert rules_of(vs) == ["GL16"], [v.render() for v in vs]


@pytest.mark.parametrize("idiom", sorted(GL16_CASES))
def test_gl16_quiet_on_threadsafe_twin(idiom):
    vs = run(GL16_CASES[idiom][1], "garage_tpu_torch/block/fake_backend.py")
    assert vs == [], [v.render() for v in vs]


# ---- scope --------------------------------------------------------------

SCOPE_CASES = {"GL14": GL14_GRAPH, "GL15": GL15_EMPTY, "GL16": GL16_COMPUTE}


@pytest.mark.parametrize("rule", sorted(SCOPE_CASES))
@pytest.mark.parametrize("where", ["block", "ops", "parallel"])
def test_device_rules_apply_to_the_port_device_path(rule, where):
    vs = run(SCOPE_CASES[rule], f"garage_tpu_torch/{where}/fake_scope.py")
    assert rules_of(vs) == [rule]


@pytest.mark.parametrize("rule", sorted(SCOPE_CASES))
def test_device_rules_skip_the_port_api(rule):
    assert run(SCOPE_CASES[rule], "garage_tpu_torch/api/fake_scope.py") == []


# ---- the real backend ---------------------------------------------------

BACKEND = os.path.join(REPO, "garage_tpu_torch", "block",
                       "device_backend.py")
BACKEND_REL = "garage_tpu_torch/block/device_backend.py"


def _backend_source() -> str:
    with open(BACKEND, encoding="utf-8") as f:
        return f.read()


def test_real_backend_is_clean_under_the_device_rules():
    ctx = analyze_source(_backend_source(), default_rules(),
                         rel_path=BACKEND_REL)
    fired = [v.render() for v in ctx.violations
             if v.active and v.rule in ("GL14", "GL15", "GL16")]
    assert fired == []


@pytest.mark.parametrize("cls, method, plant", [
    ("TorchDeviceBackend", "readback",
     "        self._delivered.set_result(handle)\n"),
    ("StubDeviceBackend", "compute",
     "        self._delivered.set_result(staged)\n"),
])
def test_planted_bare_set_result_in_real_backend_fires_gl16(cls, method,
                                                            plant):
    src = _backend_source()
    start = src.index(f"class {cls}")
    head = src.index(f"    def {method}(self", start)
    body = src.index(":\n", head) + 2  # after the def line
    mutated = src[:body] + plant + src[body:]
    ctx = analyze_source(mutated, default_rules(), rel_path=BACKEND_REL)
    gl16 = [v for v in ctx.violations if v.active and v.rule == "GL16"]
    line = mutated[:body].count("\n") + 1
    assert [(v.line, v.context) for v in gl16] == [
        (line, f"{cls}.{method}")]
    assert "set_result" in gl16[0].message
    assert f"`{cls}.{method}` runs on a stage" in gl16[0].message


# ---- the CLI ------------------------------------------------------------

def test_explain_gl15_shows_the_torch_example():
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['garage_tpu'] = None; "
            "sys.argv = ['x', '--explain', 'GL15']; "
            "runpy.run_module('garage_tpu_torch.analysis', "
            "run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert out.startswith("GL15 unpadded-device-launch")
    fires = out[out.index("fires on:"):out.index("quiet on:")]
    quiet = out[out.index("quiet on:"):]
    assert "torch.empty((len(blobs), n)" in fires
    assert "buf.to(self.device)" in fires
    assert "bucket_items(len(blobs), self.pad_buckets)" in quiet
