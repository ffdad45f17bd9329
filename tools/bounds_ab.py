#!/usr/bin/env python3
"""Choose the kernels' __launch_bounds__ by measurement.

    python3 tools/bounds_ab.py

Run from the root of a checkout of the port.  Builds copies of
ltjax_torch/kernels/csrc/ext_step.cu (every variant that chip_smoke.py
builds) and rk4_step.cu with the launch bounds text-edited, into a
temporary directory (all nvcc processes started together, the flags of
ltjax_torch/kernels/build.py), and prints one JSON line: the card's name
and power limit, each copy's ptxas report per variant (registers, stack,
spills), and the kernel ms of the advect, behavior and turb cells and of
K2 (tools/cells_ab.py's inputs: 1M and the first 65,536 released, sorted)
for each copy, in turns (forward, then backward).  Copies:

* ext_step ``lb1``: ``__launch_bounds__(LTX_BLOCK)`` (ptxas picks the
  registers), ``lb4``: ``__launch_bounds__(LTX_BLOCK, 4)`` (at most 128
  registers, 4 blocks an SM);
* rk4_step ``none``: no launch bounds, ``lb5``:
  ``__launch_bounds__(128, 5)`` (at most 96 registers).

Whichever the source holds is edited to each.  Needs the CUDA toolkit.
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
from ltjax_torch import packed as pk, synth  # noqa: E402
from ltjax_torch.kernels import build  # noqa: E402
from ltjax_torch.kernels import ext_step as kx, rk4_step as kr  # noqa: E402
from ltjax_torch.step import _sort, fieldset_slice  # noqa: E402

sys.path.insert(0, os.path.join(os.getcwd(), "tools"))
import cells_ab  # noqa: E402

CSRC = os.path.join("ltjax_torch", "kernels", "csrc")
K1_BOUNDS = {"lb1": "__launch_bounds__(LTX_BLOCK)",
             "lb4": "__launch_bounds__(LTX_BLOCK, 4)"}
K2_BOUNDS = {"none": "", "lb5": "__launch_bounds__(128, 5)"}
K1_RE = r"__launch_bounds__\(LTX_BLOCK(, \d+)?\)\s*\next_step_kernel\("
K2_RE = (r"__global__ void( __launch_bounds__\(128(, \d+)?\))?\s*"
         r"\nrk4_step_kernel\(")


def _start(tmp, name, src, defs):
    cu = os.path.join(tmp, name + ".cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(tmp, name + ".so")
    return so, subprocess.Popen(
        [build._nvcc(), *build.FLAGS, *defs, "-I", os.path.abspath(CSRC),
         "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bounds_ab: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    with open(os.path.join(CSRC, "ext_step.cu")) as f:
        k1 = f.read()
    with open(os.path.join(CSRC, "rk4_step.cu")) as f:
        k2 = f.read()
    tmp = tempfile.mkdtemp(prefix="bounds_ab_")
    jobs = {}
    variants = [v for n, v in cs.kernel_targets() if n == "ext_step"]
    for copy, lb in K1_BOUNDS.items():
        src, hits = re.subn(K1_RE, lb + "\next_step_kernel(", k1)
        assert hits == 1, "ext_step_kernel's launch bounds not found"
        for v in variants:
            tag = build.tag("ext_step", v)
            defs = [f"-D{k}={x}" for k, x in sorted(v.items())]
            jobs[(copy, tag)] = _start(tmp, f"{tag}-{copy}", src, defs)
    for copy, lb in K2_BOUNDS.items():
        src, hits = re.subn(K2_RE, "__global__ void " + lb
                            + "\nrk4_step_kernel(", k2)
        assert hits == 1, "rk4_step_kernel's declaration not found"
        jobs[(copy, "rk4_step")] = _start(tmp, f"rk4_step-{copy}", src, [])
    ptxas, libs = {}, {}
    for (copy, tag), (so, proc) in jobs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag} ({copy}):\n{err}")
        ptxas.setdefault(copy, {})[tag] = [
            re.sub(r"\s+", " ", ln.split(":", 1)[-1]).strip()
            for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        libs[(copy, tag)] = ctypes.CDLL(so)

    table, dt = cells_ab.cells(dev)
    runs = []          # (copy, cell, size, fn)
    for name in ("advect", "behavior", "turb", "stochastic"):
        ctx, cfg, z_lo, z_rng, case = table[name]
        g = ctx.grid
        fsR = synth.fieldset_window(case, -dt / 2, dt, 3, device=dev)
        p0 = cells_ab._particles(dev, z_lo, z_rng)
        ps, _ = _sort(g, p0)
        small, _ = _sort(g, p0.take(torch.arange(cells_ab.SMALL,
                                                 device=dev)))
        if name == "stochastic":
            tabs = pk.stage_value_tables(g, pk.build_packed_records(g, fsR),
                                         0.0, float(cfg.idt))
            for copy in K2_BOUNDS:
                fn = libs[(copy, "rk4_step")].ltx_rk4_step
                fn.argtypes, fn.restype = kr._C_ARGTYPES, ctypes.c_int
                for size, q in (("1M", ps), ("65536", small)):
                    def call(q=q, fn=fn):
                        lib0 = kr._lib
                        kr._lib = lambda: fn
                        try:
                            return kr.rk4_displacement_fused(
                                g, tabs, q.x, q.y, q.z, cfg.tension_sigma,
                                cfg.z0, float(cfg.idt))
                        finally:
                            kr._lib = lib0
                    runs.append((copy, name, size, call, 10))
            continue
        prec = pk.build_packed_records(
            g, fsR, with_aks=bool(cfg.VTurbOn and cfg.readAks),
            with_scalars=cfg.needs_salt_fields())
        f3 = fieldset_slice(fsR, 0)
        tag = build.tag("ext_step", kx.kernel_variant(cfg))
        for copy in K1_BOUNDS:
            fn = libs[(copy, tag)].ltx_ext_step
            fn.argtypes, fn.restype = kx._C_ARGTYPES, ctypes.c_int
            for size, q in (("1M", ps), ("65536", small)):
                def call(q=q, fn=fn, ctx=ctx, cfg=cfg, prec=prec, f3=f3):
                    lib0 = kx._lib
                    kx._lib = lambda v: fn
                    try:
                        return kx.ext_step_fused(ctx, cfg, q, prec, 0.0,
                                                 fields=f3)
                    finally:
                        kx._lib = lib0
                runs.append((copy, name, size, call, 3))
    ms = {}
    for copy, name, size, call, reps in runs + runs[::-1]:
        ms.setdefault(f"{name}/{size}/{copy}", []).append(
            cs.cuda_time(torch, call, reps))
    print(json.dumps({"card": card, "ptxas": ptxas,
                      "ms": {k: float(np.mean(v)) for k, v in ms.items()},
                      "ms_turns": ms}))


if __name__ == "__main__":
    main()
