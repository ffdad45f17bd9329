#!/usr/bin/env python3
"""Attribute the lanes kernel K3's time: text-edited copies of it, timed.

    python3 tools/lanes_limiter_ab.py [LABEL] [BUILD ...]

Run from the root of a checkout of the port.  Builds copies of that
checkout's ltjax_torch/kernels/csrc/step_lanes.cu with its headers (the
flags of ltjax_torch/kernels/build.py, all nvcc processes started
together) into a temporary directory, so the kernel sources gain no
diagnostic macro, in the variant of each BUILD of tools/lanes_ab.py
(default: oyster and b6), and times each on that build's first-launch
inputs at 1,000,000 particles (tools/lanes_ab.py's ``cell``).  The
copies:

* committed: the sources as they are;
* no_fits: Visser's fit, the 4/5 cue's and SaltTempOn's replaced by one
  lane read each (what is left: the tables' rows, the draws, reflection,
  settlement): committed - no_fits is the fits' cost;
* local_scratch: the fits' cp/dp0/dp1 columns as three MAX_LEVELS
  arrays in local memory in every build, in place of the float32 fit
  builds' columns in dynamic shared memory (K3_SHARED_SCRATCH);
* rcp_sweep: the Thomas rows of every fit multiply by one reciprocal of
  their pivot in place of two or three IEEE divides (not the plain
  version's arithmetic: for the attribution only);
* warp_keys: every warp derives the step's key pairs for itself (lanes
  0-4, __syncwarp) in place of threads 0-4 of the block behind a block
  barrier;
* min_blocks_6, min_blocks_8: __launch_bounds__ asking for 6 or 8 blocks
  an SM (85 or 64 registers a thread).

A copy whose anchor text is missing in the sources, or that changes
nothing in a build, is reported as not applicable.  Times: the profiler's
device ms of the kernel, 10 launches a turn, the copies in turns
(forward, then backward), and beside them CUDA events around 10 wrapper
calls (``event_ms``: the host's preparation included where it is the
slower).  Prints one JSON line per build with the
card's name and power limit, each copy's ptxas report, mean and per-turn
ms, and its largest difference from committed in x, y, z, salt and temp
and the statuses that differ.  Needs the CUDA toolkit.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from ltjax_torch import packed as pk  # noqa: E402
from ltjax_torch.kernels import build, rk4_step as kr  # noqa: E402
from ltjax_torch.kernels import step_lanes as sl  # noqa: E402
from ltjax_torch.step import _sort, packed_window  # noqa: E402

CSRC = os.path.join("ltjax_torch", "kernels", "csrc")
N = 1_000_000


def _sub(text, old, new):
    """text with old replaced by new, or None where old is missing."""
    return text.replace(old, new) if text is not None and old in text \
        else None


def no_fits(files):
    """Each scalar fit of lanes.cuh's step_lanes replaced by one lane read
    of the same source and stencil."""
    src = files["lanes.cuh"]
    src = _sub(src, "dz = dz + visser_dz(c.rec(0), a, Ts.sigma, sv, zeta1, "
               "h1, z, R, idt, cq,\n                          dq0, dq1);",
               "dz = dz + R * (pos_t)c.rec(0).lane(sv, a.nv);")
    src = re.sub(r"fit_eval<true>\(c\.rec\(0\), Ts, sb,[^;]*;",
                 "dsdz = (pos_t)c.rec(0).lane(sb, a.salt0); unused = "
                 "pos_t(0); zf = z;", src) if src else None
    src = re.sub(r"fit_eval\(c\.rec\(2\), Ts, s4,[^;]*;",
                 "salt = (pos_t)c.rec(2).lane(s4, a.salt0); temp = "
                 "(pos_t)c.rec(2).lane(s4, a.salt0 + a.us); zf = z;",
                 src) if src else None
    return None if src is None or src == files["lanes.cuh"] else \
        {"lanes.cuh": src}


def local_scratch(files):
    """The fits' cp/dp0/dp1 columns as three MAX_LEVELS arrays in local
    memory in every build (K3_SHARED_SCRATCH off)."""
    src = _sub(files["step_lanes.cu"],
               "#define K3_SHARED_SCRATCH (K3_FITS && !LTX_POS64)",
               "#define K3_SHARED_SCRATCH 0")
    return None if src is None else {"step_lanes.cu": src}


def rcp_sweep(files):
    """The Thomas rows with one reciprocal of the pivot."""
    out = {}
    fc = files["find_currents.cuh"]
    fc2 = _sub(fc, "      cp[i] = offc / denom;\n"
               "      dp0[i] = ((dy0 - dy0p) - offp * dp0[i - 1]) / denom;\n"
               "      if (two) dp1[i] = ((dy1 - dy1p) - offp * dp1[i - 1]) "
               "/ denom;",
               "      const R rd = R(1) / denom;\n"
               "      cp[i] = offc * rd;\n"
               "      dp0[i] = ((dy0 - dy0p) - offp * dp0[i - 1]) * rd;\n"
               "      if (two) dp1[i] = ((dy1 - dy1p) - offp * dp1[i - 1]) "
               "* rd;")
    ln = files["lanes.cuh"]
    ln2 = _sub(ln, "      cp[i] = offc / denom;\n"
               "      z2[i] = ((dy - dyp) - offp * z2[i - 1]) / denom;",
               "      const pos_t rd = pos_t(1) / denom;\n"
               "      cp[i] = offc * rd;\n"
               "      z2[i] = ((dy - dyp) - offp * z2[i - 1]) * rd;")
    if fc2:
        out["find_currents.cuh"] = fc2
    if ln2:
        out["lanes.cuh"] = ln2
    return out or None


WARP_KEYS = """  __shared__ uint32_t keys[K3_BLOCK / 32][K3_STRIDE];
  const int lane = threadIdx.x & 31;
  uint32_t* wk = keys[threadIdx.x >> 5];
  if (lane < K3_SUBSTREAMS) {
    uint32_t x0 = sv.step, x1 = lane;
    threefry2x32(sv.k0, sv.k1, x0, x1);
    wk[2 * lane] = x0;
    wk[2 * lane + 1] = x1;
  }
  __syncwarp();
  a.rngk = wk;
"""


def warp_keys(files):
    """The step's key pairs derived by every warp for itself (lanes 0-4,
    its own shared words, __syncwarp) in place of threads 0-4 of the
    block behind a block barrier."""
    src = files["step_lanes.cu"]
    start = src.find("  __shared__ uint32_t keys[K3_STRIDE];\n")
    end = src.find("  a.rngk = keys;\n")
    if start < 0 or end < 0:
        return None
    return {"step_lanes.cu": src[:start] + WARP_KEYS
            + src[end + len("  a.rngk = keys;\n"):]}


def min_blocks(k):
    """__launch_bounds__ asking for k blocks of 128 an SM (at most
    65536 / (128 k) registers a thread)."""
    def edit(files):
        src = _sub(files["step_lanes.cu"], "__launch_bounds__(K3_BLOCK)",
                   f"__launch_bounds__(K3_BLOCK, {k})")
        return None if src is None else {"step_lanes.cu": src}
    return edit


EDITS = {"no_fits": no_fits, "local_scratch": local_scratch,
         "rcp_sweep": rcp_sweep, "warp_keys": warp_keys,
         "min_blocks_6": min_blocks(6), "min_blocks_8": min_blocks(8)}


def build_copies(files, variant, tmp):
    """{copy: (library path, ptxas lines)} of every applicable copy."""
    copies = {"committed": {}}
    for name, edit in EDITS.items():
        copies[name] = edit(files)
    defs = [f"-D{k}={v}" for k, v in sorted(variant.items())]
    jobs, skipped = {}, []
    for name, edits in copies.items():
        if edits is None:
            skipped.append(name)
            continue
        d = os.path.join(tmp, name + "-" + build.tag("step_lanes", variant))
        os.makedirs(d, exist_ok=True)
        for f, text in files.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(edits.get(f, text))
        so = os.path.join(d, "lib.so")
        jobs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.FLAGS, *defs, "-I", d, "-o", so,
             os.path.join(d, "step_lanes.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        out[name] = (so, [re.sub(r"\s+", " ", ln.split(":", 1)[-1]).strip()
                          for ln in err.splitlines()
                          if "registers" in ln or "spill" in ln])
    return out, skipped


def main(label, names):
    if not torch.cuda.is_available():
        raise SystemExit("lanes_limiter_ab: needs a CUDA device")
    lab = cs.lanes_ab()
    dev = torch.device("cuda")
    files = {}
    for f in os.listdir(CSRC):
        if f.endswith(".cuh") or f == "step_lanes.cu":
            with open(os.path.join(CSRC, f)) as fh:
                files[f] = fh.read()
    tmp = tempfile.mkdtemp(prefix="lanes_limiter_ab_")
    lib0 = sl._lib
    try:
        for bname in names:
            ctx, cfg, p0, fs, t = lab.cell(bname, dev, N)
            ps, _ = _sort(ctx.grid, p0)
            g, idt = ctx.grid, float(cfg.idt)
            prec = packed_window(ctx, cfg, "per_step", fs)
            tabs = pk.stage_value_tables(g, prec, t, idt)
            aux = sl.aux_tables(g, cfg, prec, t, idt)
            disp = kr.rk4_displacement_fused(
                g, tabs, ps.x, ps.y, ps.z, cfg.tension_sigma, cfg.z0, idt,
                stage1=cfg.Behavior == 7)
            variant = sl.kernel_variant(ctx, cfg, ps.x.dtype)
            libs, skipped = build_copies(files, variant, tmp)
            fns = {}
            for name, (so, _) in libs.items():
                fn = ctypes.CDLL(so).ltx_step_lanes
                fn.argtypes = sl._C_ARGTYPES
                fn.restype = ctypes.c_int
                fns[name] = fn

            def launch(name):
                sl._lib = lambda v, fn=fns[name]: fn
                try:
                    return sl.step_lanes_fused(ctx, cfg, cfg.seed, 0, ps, fs,
                                               tabs, aux, t, disp)
                finally:
                    sl._lib = lib0

            ref = launch("committed")
            torch.cuda.synchronize()
            res = {}
            for name in fns:
                out = launch(name)
                torch.cuda.synchronize()
                d = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
                     for k in ("x", "y", "z", "salt", "temp")}
                res[name] = {"ptxas": libs[name][1], "max_abs_vs_committed": d,
                             "status_differs": int((out.status
                                                    != ref.status).sum()),
                             "ms": []}
            order = list(fns) + list(fns)[::-1]
            for name in order:
                res[name]["ms"].append(cs.profiled_ms(
                    torch, lambda: launch(name), 10, "step_lanes_kernel"))
                res[name].setdefault("event_ms", []).append(cs.cuda_time(
                    torch, lambda: launch(name), 10))
            for name in fns:
                res[name]["mean_ms"] = float(np.mean(res[name]["ms"]))
            print(json.dumps({"tree": label, "card": lab.card_name(),
                              "build": bname,
                              "variant": build.tag("step_lanes", variant),
                              "n": N, "not_applicable": skipped,
                              "copies": res}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree",
         sys.argv[2:] or ["oyster", "b6"])
