"""Build and load the CUDA kernels of ``ltjax_torch/kernels/csrc``.

Each source is compiled with ``nvcc`` into a shared library with a plain
C interface and loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds).  A source may be compiled in several variants, each a
set of ``-D`` macro values that specialise it at compile time.
Libraries go to ``build/ltjax_torch/`` at the root of the checkout,
keyed by a hash of the source, the headers of ``csrc`` it may include
(``*.cuh``), the flags and the variant, so a changed source or header
rebuilds and an unchanged one loads at once.  ``prebuild`` starts the
builds of several sources and variants together, one ``nvcc`` each.
Every build
records nvcc's ``-Xptxas -v`` report (registers, stack, spills) in
``report``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "ltjax_torch")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}
report = {}   # library tag -> {"seconds": build time, "ptxas": [lines]}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def _macros(name: str):
    """The LTX_ macros that csrc/<name>.cu declares (its #ifndef lines),
    read once: every launch computes its variant's tag."""
    with open(os.path.join(_CSRC, name + ".cu")) as f:
        return tuple(ln.split()[1][4:] for ln in f
                     if ln.startswith("#ifndef LTX_"))


def tag(name: str, variant=None) -> str:
    """``name`` plus the variant's macro values, each under the shortest
    prefix of its name after ``LTX_`` that no other macro of the source
    shares (lower case): ext_step-b3h1m0v2, ext_step-b4h0m0sa1se1v0."""
    if not variant:
        return name
    others = _macros(name)

    def abbrev(k):
        k = k[4:]
        for i in range(1, len(k) + 1):
            if not any(o != k and o.startswith(k[:i]) for o in others):
                return k[:i].lower()
        return k.lower()

    return name + "-" + "".join(f"{abbrev(k)}{v}"
                                for k, v in sorted(variant.items()))


@functools.lru_cache(maxsize=None)
def _headers() -> bytes:
    """The shared headers of csrc (every ``*.cuh``), read once."""
    out = b""
    for h in sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh")):
        with open(os.path.join(_CSRC, h), "rb") as f:
            out += h.encode() + f.read()
    return out


def _target(name: str, variant):
    src = os.path.join(_CSRC, name + ".cu")
    defs = [f"-D{k}={v}" for k, v in sorted((variant or {}).items())]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + _headers()
                                + " ".join(FLAGS + defs).encode())
    so = os.path.join(BUILD_DIR,
                      f"{tag(name, variant)}-{digest.hexdigest()[:16]}.so")
    return src, defs, so


def _start(name: str, variant):
    """Start nvcc for a library that is not built yet; returns
    (process, tmp path, so path, start time) or None."""
    src, defs, so = _target(name, variant)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *FLAGS, *defs, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, so, time.perf_counter()


def _finish(key: str, job) -> None:
    proc, tmp, so, t0 = job
    try:
        _, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {key}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {key}:\n{err}")
    os.replace(tmp, so)
    lines = [ln.strip() for ln in err.splitlines()
             if "registers" in ln or "spill" in ln]
    report[key] = {"seconds": time.perf_counter() - t0, "ptxas": lines}
    print(f"[build] {key} in {report[key]['seconds']:.1f} s",
          file=sys.stderr)
    for ln in lines:
        print(f"[build] ptxas: {ln}", file=sys.stderr)


def prebuild(targets) -> None:
    """Build the given (name, variant) pairs of ``csrc/<name>.cu``
    concurrently (variant None: the source as it is)."""
    jobs = {}
    for name, v in targets:
        key = tag(name, v)
        if key not in jobs:
            job = _start(name, v)
            if job is not None:
                jobs[key] = job
    errors = []
    for key, job in jobs.items():
        try:
            _finish(key, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, variant=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` in the given variant
    (a dict of macro values), built on first use."""
    key = tag(name, variant)
    if key in _loaded:
        return _loaded[key]
    job = _start(name, variant)
    if job is not None:
        _finish(key, job)
    lib = ctypes.CDLL(_target(name, variant)[2])
    _loaded[key] = lib
    return lib
