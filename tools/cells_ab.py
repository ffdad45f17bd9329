#!/usr/bin/env python3
"""Time the kernel of every chip_smoke.py cell in one checkout.

    python3 tools/cells_ab.py LABEL [STAGE_POINTS]

Run from the root of a checkout of the port (any commit whose
chip_smoke.py has phases 2, 4, 6, 7 and 8; copy this file into an older
checkout to time it), and compare two checkouts in one machine session,
in turns (A, B, B, A).  For each cell, on the inputs of the main path's
first launch (the cell's 1,000,000 particles Hilbert-sorted, records
0..2, as chip_smoke.py builds them): the whole-step kernel of advect
(phase 2), turb, behavior, dvm (phase 4), settle, salt (phase 6) and
curv (phase 7b), one external step of 30 internal steps, and the
per-step RK4 kernel of the stochastic cell (phase 8b), one internal
step; each at 1M and on the first 65,536 particles released (sorted).  Times:
CUDA events, mean of 3 launches at 1M and 10 at 65,536 (K2: 10 and 20),
after one warm launch.  Where the checkout's whole-step wrapper counts
staging (``ext_step.counts``), its counters of the first 1M launch too,
and
STAGE_POINTS, if given, sets the points a block may stage (0: none).
Prints one JSON line per cell and one with all, the card's name and
power limit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from ltjax_torch import packed as pk, state as st, synth  # noqa: E402
from ltjax_torch.kernels import ext_step as kx, rk4_step as kr  # noqa: E402
from ltjax_torch.step import _sort, fieldset_slice  # noqa: E402

N, SMALL = 1_000_000, 65536


def _particles(dev, z_lo, z_rng):
    """chip_smoke's release: x, y from rng 0 and z from rng 0 after them
    (z_rng 0: phases 2, 7b) or from rng 1 (phases 4, 6, 8b)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(40e3, 160e3, N)
    y = rng.uniform(40e3, 160e3, N)
    z = (rng if z_rng == 0 else np.random.default_rng(1)).uniform(
        z_lo, -5.0, N)
    p = st.init_particles(x, y, z, dtype=torch.float32, device=dev)
    return p.replace(status=torch.full_like(p.status, st.ACTIVE))


def cells(dev):
    """name -> (ctx, cfg, z_lo, z_rng, case)."""
    dt = 3600.0
    plain = cs.bench_case(torch, dev, land=False)
    larval = cs.bench_case(torch, dev, land=False, parabolic_aks=True)
    halo = cs.bench_case(torch, dev, land=False, halocline=True)
    curv = cs.curv_bench_case(torch, dev, land=False)
    out = {"advect": (cs.context(plain), cs.make_cfg(N), -40.0, 0, plain)}
    for name, kw in cs.LARVAL.items():
        out[name] = (cs.context(larval), cs.make_cfg(N, **kw),
                     -25.0 if name == "behavior" else -40.0, 1, larval)
    for name, kw in cs.SETTLE_SALT.items():
        ctx = cs.context(halo)
        if kw.get("settlementon"):
            ctx = cs.with_polygons(ctx)
        out[name] = (ctx, cs.make_cfg(N, **kw),
                     -25.0 if name == "settle" else -40.0, 1, halo)
    out["curv"] = (cs.context(curv), cs.make_cfg(N), -40.0, 0, curv)
    out["stochastic"] = (cs.context(plain), cs.make_cfg(N, **cs.STOCHASTIC),
                         -25.0, 1, plain)
    return out, dt


def main(label: str, points=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cells_ab: needs a CUDA device")
    if points is not None:
        kx.STAGE_POINTS = points
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    counted = hasattr(kx, "counts")
    table, dt = cells(dev)
    res = {}
    for name, (ctx, cfg, z_lo, z_rng, case) in table.items():
        g = ctx.grid
        fsR = synth.fieldset_window(case, -dt / 2, dt, 3, device=dev)
        p0 = _particles(dev, z_lo, z_rng)
        ps, _ = _sort(g, p0)
        small, _ = _sort(g, p0.take(torch.arange(SMALL, device=dev)))
        r = {}
        if name == "stochastic":
            prec = pk.build_packed_records(g, fsR)
            tabs = pk.stage_value_tables(g, prec, 0.0, float(cfg.idt))
            for size, q, reps in (("1M", ps, 10), (str(SMALL), small, 20)):
                def fn(q=q):
                    return kr.rk4_displacement_fused(
                        g, tabs, q.x, q.y, q.z, cfg.tension_sigma, cfg.z0,
                        float(cfg.idt))
                r["ms_" + size] = cs.cuda_time(torch, fn, reps)
        else:
            prec = pk.build_packed_records(
                g, fsR, with_aks=bool(cfg.VTurbOn and cfg.readAks),
                with_scalars=cfg.needs_salt_fields())
            f3 = fieldset_slice(fsR, 0)
            for size, q, reps in (("1M", ps, 3), (str(SMALL), small, 10)):
                def fn(q=q):
                    return kx.ext_step_fused(ctx, cfg, q, prec, 0.0,
                                             fields=f3)
                if counted and size == "1M":
                    kx.reset_launches()
                    fn()
                    r["staging"] = kx.counts()
                r["ms_" + size] = cs.cuda_time(torch, fn, reps)
        res[name] = r
        print(json.dumps({"tree": label, "cell": name, **r}), flush=True)
    print(json.dumps({"tree": label, "card": card,
                      "stage_points": getattr(kx, "STAGE_POINTS", None),
                      "cells": res}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree",
         int(sys.argv[2]) if len(sys.argv) > 2 else None)
