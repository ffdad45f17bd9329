#!/usr/bin/env python3
"""Attribute the advection kernel's time: text-edited copies of it, timed.

    python3 tools/limiter_ab.py [LABEL]

Run from the root of a checkout of the port (copy this file into an older
checkout to measure it).  Builds copies of that checkout's
ltjax_torch/kernels/csrc/ext_step.cu (advection variant, the flags of
ltjax_torch/kernels/build.py, all nvcc processes started together) into a
temporary directory, so the kernel source gains no diagnostic macro, and
times each on chip_smoke.py's phase-2 first-launch inputs: 1,000,000
Hilbert-sorted particles on the 200x200x20 bench grid, records 0..2, one
external step of 30 internal steps.  The copies:

* committed: the source as it is;
* frozen_rows: every lookup reads the four corner rows of the particle's
  cell at the start of the external step (its own weights fx, fy;
  positions still advance, so the active counts and the arithmetic stay
  those of committed): committed - frozen_rows is the cost of the
  gathers' spread over rows as the particles move;
* one_row: every lookup of every particle reads the four corner rows of
  the grid's centre cell (each warp load one line): committed - one_row
  is the cost of the gathers' spread over rows at all;
* levels: MAX_LEVELS set to us + 1 (the fit scratch cp/dp0/dp1 in a
  252 B local frame instead of 768 B);
* no_staging (a checkout with a staged corner source, where the wrapper
  has STAGE_POINTS): the committed build with no block staged.

frozen_rows and one_row edit the per-lookup ``locate`` of a source whose
Stencil holds four corner rows (the design before the staged source);
where their anchor text is missing they are reported as not applicable.
Times: CUDA events, 3 launches per turn, the copies in turns (forward,
then backward).  Prints one JSON line with the card's name and power
limit, each copy's ptxas report and its mean and per-turn ms, and the
largest position difference from committed.  Needs the CUDA toolkit.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from ltjax_torch import packed as pk, state as st, synth  # noqa: E402
from ltjax_torch.kernels import build, ext_step as kx  # noqa: E402
from ltjax_torch.step import _sort  # noqa: E402

CSRC = os.path.join("ltjax_torch", "kernels", "csrc")

# the four-corner-row locate of the design before the staged source
LOCATE = ("__device__ __forceinline__ Stencil locate(const Args& a, "
          "const Curv& cv,")
LOAD = "float x = x_in[p], y = y_in[p], z = z_in[p], dob = dob_in[p];"
ROWS = """
__device__ __forceinline__ Stencil locate(const Args& a, const Curv& cv,
                                          float x, float y) {
  Stencil s = locate_exact(a, cv, x, y);
  %s
  s.r00 = c;
  s.r01 = c + a.nl;
  s.r10 = c + (long long)a.nx * a.nl;
  s.r11 = s.r10 + a.nl;
  return s;
}
"""
FROZEN = ("const float2 p0 = ltx_start[threadIdx.x];\n"
          "  const long long c = locate_exact(a, cv, p0.x, p0.y).r00;")
CENTRE = ("const long long c = ((long long)(a.ny / 2) * a.nx + a.nx / 2)"
          " * a.nl;")


def _rows_edit(src: str, four_rows: bool, body: str, store: bool):
    """The source with the per-lookup locate's rows replaced, or None."""
    if not four_rows or LOCATE not in src or (store and LOAD not in src):
        return None
    start = src.index(LOCATE)
    end = src.index("\n}\n", start) + 3
    exact = src[start:end].replace("Stencil locate(", "Stencil locate_exact(")
    head = "__shared__ float2 ltx_start[128];\n" if store else ""
    out = src[:start] + head + exact + ROWS % body + src[end:]
    if store:
        out = out.replace(LOAD, LOAD + "\n  ltx_start[threadIdx.x] = "
                          "make_float2(x, y);")
    return out


def copies(src: str, header: str, us: int) -> dict:
    """name -> edited source (None: not applicable)."""
    four_rows = "long long r00, r01, r10, r11;" in header
    levels = re.sub(r"#define MAX_LEVELS \d+", f"#define MAX_LEVELS {us + 1}",
                    src)
    return {"committed": src,
            "frozen_rows": _rows_edit(src, four_rows, FROZEN, True),
            "one_row": _rows_edit(src, four_rows, CENTRE, False),
            "levels": levels if levels != src else None}


def main(label: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("limiter_ab: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    n, us = 1_000_000, 20
    case = cs.bench_case(torch, dev, land=False)
    ctx = cs.context(case)
    cfg = cs.make_cfg(n, us=us, ws=us + 1)
    dt = float(cfg.dt)
    fsR = synth.fieldset_window(case, -dt / 2, dt, 3, device=dev)
    rng = np.random.default_rng(0)       # phase 2's release
    p0 = st.init_particles(rng.uniform(40e3, 160e3, n),
                           rng.uniform(40e3, 160e3, n),
                           rng.uniform(-40.0, -5.0, n),
                           dtype=torch.float32, device=dev)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    ps, _ = _sort(case.grid, p0)
    prec = pk.build_packed_records(case.grid, fsR)

    with open(os.path.join(CSRC, "ext_step.cu")) as f, \
            open(os.path.join(CSRC, "find_currents.cuh")) as h:
        srcs = copies(f.read(), h.read(), us)
    variant = kx.kernel_variant(cfg)
    defs = [f"-D{k}={v}" for k, v in sorted(variant.items())]
    tmp = tempfile.mkdtemp(prefix="limiter_ab_")
    jobs = {}
    for name, text in srcs.items():
        if text is None:
            continue
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = (os.path.join(tmp, f"{name}.so"), subprocess.Popen(
            [build._nvcc(), *build.FLAGS, *defs, "-I", os.path.abspath(CSRC),
             "-o", os.path.join(tmp, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns, ptxas = {}, {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        ptxas[name] = [re.sub(r"\s+", " ", ln.split(":", 1)[-1]).strip()
                       for ln in err.splitlines()
                       if "registers" in ln or "spill" in ln]
        fn = ctypes.CDLL(so).ltx_ext_step
        fn.argtypes = kx._C_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    runs = {name: (fn, None) for name, fn in fns.items()}
    if hasattr(kx, "STAGE_POINTS"):
        runs["no_staging"] = (fns["committed"], 0)

    lib0, points0 = kx._lib, getattr(kx, "STAGE_POINTS", None)

    def launch(name):
        fn, points = runs[name]
        kx._lib = lambda v: fn
        if points0 is not None:
            kx.STAGE_POINTS = points0 if points is None else points
        try:
            return kx.ext_step_fused(ctx, cfg, ps, prec, 0.0)
        finally:
            kx._lib = lib0
            if points0 is not None:
                kx.STAGE_POINTS = points0

    ref = launch("committed")
    torch.cuda.synchronize()
    res = {}
    for name in runs:
        out = launch(name)
        torch.cuda.synchronize()
        res[name] = {"ptxas": ptxas.get(name, ptxas["committed"]),
                     "max_abs_dxy_vs_committed_m": float(torch.maximum(
                         (out.x - ref.x).abs(), (out.y - ref.y).abs()).max()),
                     "active": int((out.status == st.ACTIVE).sum()),
                     "ms": []}
    order = list(runs) + list(runs)[::-1]
    for name in order:
        res[name]["ms"].append(cs.cuda_time(torch, lambda: launch(name), 3))
    for name in runs:
        res[name]["mean_ms"] = float(np.mean(res[name]["ms"]))
    skipped = [k for k, v in srcs.items() if v is None]
    print(json.dumps({"tree": label, "card": card, "n": n,
                      "internal_steps": cfg.internal_steps,
                      "not_applicable": skipped, "copies": res}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
