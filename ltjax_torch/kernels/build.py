"""Build and load the CUDA kernels of ``ltjax_torch/kernels/csrc``.

Each source is compiled with ``nvcc`` into a shared library with a plain
C interface and loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds).  Libraries go to ``build/ltjax_torch/`` at the root of
the checkout, keyed by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one loads at once.  The first build in
a process prints nvcc's ``-Xptxas -v`` report (registers, spills).
"""

from __future__ import annotations

import ctypes
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
report = {}   # source name -> {"seconds": build time, "ptxas": [lines]}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        r = subprocess.run([_nvcc(), *FLAGS, "-o", tmp, src],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
        os.replace(tmp, so)
        lines = [ln.strip() for ln in r.stderr.splitlines()
                 if "registers" in ln or "spill" in ln]
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": lines}
        print(f"[build] {name}.cu in {report[name]['seconds']:.1f} s",
              file=sys.stderr)
        for ln in lines:
            print(f"[build] ptxas: {ln}", file=sys.stderr)
    lib = ctypes.CDLL(so)
    _loaded[name] = lib
    return lib
