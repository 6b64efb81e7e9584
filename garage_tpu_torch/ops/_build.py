"""Build and load the port's CUDA kernels (csrc/*.cu).

Route: `nvcc` by hand into a shared library with a plain C interface,
loaded with ctypes — seconds per source, where a build that includes
PyTorch's headers takes minutes. Each library lands in
garage_tpu_torch/_build/ (git-ignored) under a name keyed by a hash of
its source and flags, so an edited source rebuilds and an unchanged one
loads at once. Nothing is built when a module is imported: the first
launch builds what it needs, and `build_all()` compiles every source in
parallel (one nvcc each, all started together).

Every C entry point returns `cudaGetLastError()`; `check()` raises on a
non-zero value, so a refused launch never passes silently."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("gf256", "blake3", "sha256")
ARCH = "arch=compute_90a,code=sm_90a"
FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# name -> {"seconds": float, "ptxas": [str]} for builds made by this process
build_log: dict[str, dict] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def so_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{tag.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every missing library of `names`, one nvcc per source,
    all started together; -> build_log entries of the ones compiled."""
    todo = [n for n in names if not os.path.exists(so_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    procs = []
    for n in todo:
        out = so_path(n)
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [exe, *FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    done = {}
    failed = []
    for n, out, tmp, t0, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}:\n{text[-4000:]}")
            continue
        os.replace(tmp, out)
        done[n] = {"seconds": time.perf_counter() - t0,
                   "ptxas": [ln.strip() for ln in text.splitlines()
                             if "registers" in ln or "spill" in ln]}
    build_log.update(done)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of csrc/<name>.cu (built on first use), with each
    entry's argtypes set from `signatures` (entry -> argtypes)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(so_path(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")
