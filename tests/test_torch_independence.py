"""garage_tpu_torch stands alone: it imports neither jax nor anything of
the JAX package (garage_tpu), not even its host-only modules."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

import garage_tpu_torch

PKG_DIR = os.path.dirname(garage_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _py_files():
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "garage_tpu"))


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["garage_tpu"] = None
import numpy as np
import torch
import garage_tpu_torch
names = ["garage_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(garage_tpu_torch.__path__,
                                          "garage_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from garage_tpu_torch.ops import rs
x = np.random.default_rng(0).integers(0, 256, (2, 4, 64), dtype=np.uint8)
par = rs.encode(4, 2, torch.from_numpy(x)).numpy()
assert all((par[i] == rs.encode_np(4, 2, x[i])).all() for i in range(2))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "garage_tpu")
             and sys.modules[n] is not None)
assert not bad, bad
print("IMPORTED", len(names))
"""


def test_every_module_imports_and_encodes_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORTED" in r.stdout
