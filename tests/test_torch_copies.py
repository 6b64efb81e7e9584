"""Every module of garage_tpu_torch is either a copy of the JAX package's
module at the same path, or a port listed in PORTED below.

A copy's text equals the JAX module's text with its import paths
rewritten (`garage_tpu.` -> `garage_tpu_torch.`), the JAX package's
issue and PR tags dropped from its comments (the port's program text
cites no issue or PR numbers; every line keeps its place), and one
provenance line opening its docstring; nothing else may differ. This
keeps the copies reviewable and stops them drifting from the JAX
package.

`load_reference_suite` applies the same import rewrite to a test module
of the JAX package, so that its tests run against the port (the
test_torch_s3_api, test_torch_s3_fastpath, test_torch_k2v and
test_torch_gateway files)."""

from __future__ import annotations

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "garage_tpu_torch")
REF = os.path.join(REPO, "garage_tpu")

# modules the port wrote or changed (their own docstrings say what
# differs), relative to the package root
PORTED = {
    "__init__.py", "weights.py", "admin/http.py",
    "ops/__init__.py", "ops/_build.py", "ops/gf256.py", "ops/gf_kernel.py",
    "ops/rs.py", "ops/treehash.py", "ops/sha256.py",
    "block/codec.py", "block/device_backend.py", "block/feeder.py",
    "block/manager.py",
    "model/garage.py", "api/signature.py", "api/s3/put.py", "cli/server.py",
    "gateway/supervisor.py", "gateway/worker.py",
    "parallel/__init__.py", "parallel/mesh.py",
}

_REWRITE = re.compile(r"\bgarage_tpu(?=\.[A-Za-z_])")
_TAG = r"(?:ISSUE|PR) \d+"
# in order: "(TAG, x" -> "(x", "x, TAG)" -> "x)", " (TAG)" and "(TAG): "
# -> gone, "(TAG x" -> "(x", any other TAG -> "an earlier change"
_TAGS = (
    (re.compile(r"\(" + _TAG + r"[,;] ?"), "("),
    (re.compile(r"[,;] " + _TAG + r"\)"), ")"),
    (re.compile(r"(?<=\S) \(" + _TAG + r"\)"), ""),
    (re.compile(r"\(" + _TAG + r"\):? ?"), ""),
    (re.compile(r"\(" + _TAG + r" ?"), "("),
    (re.compile(r"\b" + _TAG), "an earlier change"),
)


def copy_text(ref_text: str, rel: str) -> str:
    """The port's copy of a JAX module: import paths rewritten, issue
    and PR tags dropped, and a provenance line opening the docstring
    (one is added if the module has none)."""
    text = _REWRITE.sub("garage_tpu_torch", ref_text)
    for rx, rep in _TAGS:
        text = rx.sub(rep, text)
    line = (f"Copy of garage_tpu/{rel}: import paths rewritten, issue "
            "and PR tags dropped.")
    if text.startswith('"""'):
        return '"""' + line + "\n\n" + text[3:]
    return '"""' + line + '"""\n\n' + text


# how a reference suite starts one of the port's entry points: as a
# module run with jax and garage_tpu unimportable, so that nothing of the
# JAX package serves the test
PORT_MAIN = ("import runpy, sys; sys.modules['jax'] = None; "
             "sys.modules['garage_tpu'] = None; "
             "runpy.run_module({mod!r}, run_name='__main__')")
_RUN_MODULE = re.compile(
    r'\[sys\.executable, "-m", "(garage_tpu_torch\.[\w.]+)"')


def load_reference_suite(name: str, namespace: dict, edits=(),
                         n_entry_points: int = 0) -> None:
    """Execute the JAX package's tests/<name>.py into `namespace` (a test
    module's globals), so that pytest collects its tests and fixtures
    there, against the port. The text gets copy_text's import rewrite;
    every `[sys.executable, "-m", "garage_tpu_torch.<mod>"` command (there
    must be `n_entry_points`) becomes the port's module run with jax and
    garage_tpu blocked; then each (old, new) of `edits` is applied and
    must match exactly once. The reference module itself is never
    imported or changed. Asserts are rewritten as pytest does for a test
    file; tracebacks name the reference file's lines."""
    from _pytest.assertion.rewrite import rewrite_asserts

    path = os.path.join(REPO, "tests", name + ".py")
    with open(path) as f:
        text = _REWRITE.sub("garage_tpu_torch", f.read())
    text, n = _RUN_MODULE.subn(
        lambda m: ('[sys.executable, "-c", '
                   f'PORT_MAIN.format(mod={m.group(1)!r})'), text)
    assert n == n_entry_points, (name, n)
    for old, new in edits:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    tree = ast.parse(text, path)
    rewrite_asserts(tree, text.encode(), path)
    doc = namespace.get("__doc__")
    namespace["PORT_MAIN"] = PORT_MAIN
    exec(compile(tree, path, "exec", dont_inherit=True), namespace)
    namespace["__doc__"] = doc


def _modules():
    out = []
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), PORT))
    return sorted(out)


COPIES = [m for m in _modules() if m not in PORTED]


def test_every_ported_module_exists():
    missing = sorted(m for m in PORTED if not os.path.exists(
        os.path.join(PORT, m)))
    assert not missing


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference_after_import_rewrite(rel):
    ref_path = os.path.join(REF, rel)
    assert os.path.exists(ref_path), (
        f"garage_tpu_torch/{rel} has no JAX counterpart: list it in "
        "PORTED if the port wrote it")
    with open(ref_path) as f:
        want = copy_text(f.read(), rel)
    with open(os.path.join(PORT, rel)) as f:
        got = f.read()
    assert got == want, f"garage_tpu_torch/{rel} drifted from garage_tpu/{rel}"


def test_native_c_source_is_the_reference_source():
    rel = os.path.join("native", "src", "b3gf.c")
    with open(os.path.join(REF, rel), "rb") as a, \
            open(os.path.join(PORT, rel), "rb") as b:
        assert a.read() == b.read()
