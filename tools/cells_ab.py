#!/usr/bin/env python3
"""Time the kernel of every chip_smoke.py cell in one checkout.

    python3 tools/cells_ab.py LABEL [STAGE_POINTS] [--cells NAME,...]

Run from the root of a checkout of the port (any commit whose
chip_smoke.py has phases 2, 4, 6, 7, 8, 9 and 11; copy this file into an
older checkout to time it), and compare two checkouts in one machine
session, in turns (A, B, B, A).  For each cell, on the inputs of the main
path's first launch (the cell's 1,000,000 particles Hilbert-sorted,
records 0..2, as chip_smoke.py builds them): the whole-step kernel of
advect (phase 2), turb, behavior, dvm (phase 4), settle, salt (phase 6)
and curv (phase 7b), one external step of 30 internal steps, and the
per-step RK4 kernel of the stochastic cell (phase 8b), one internal
step; each at 1M and on the first 65,536 particles released (sorted).
The builds off the float32 uniform grid: advect in float64 positions
(f64, phase 9b's LTX_POS64 build), on rho axes stretched x1.002 a cell
(axes, phase 9c's LTX_AXES build), and on tile 1 of 4 of phase 1's grid
with its halo (tile, tile_f64, tile_axes: phase 11a's LTX_TILE builds,
1M particles of the strip, one slot in 16 EMPTY).  ``--cells`` times
only the named cells (default: all).  Times: CUDA events, mean of 3
launches at 1M and 10 at 65,536 (K2: 10 and 20), after one warm launch.
Where the checkout's whole-step wrapper counts staging
(``ext_step.counts``), its counters of the first 1M launch too, and
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


def _particles(dev, z_lo, z_rng, dtype=torch.float32):
    """chip_smoke's release: x, y from rng 0 and z from rng 0 after them
    (z_rng 0: phases 2, 7b, 9b, 9c) or from rng 1 (phases 4, 6, 8b)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(40e3, 160e3, N)
    y = rng.uniform(40e3, 160e3, N)
    z = (rng if z_rng == 0 else np.random.default_rng(1)).uniform(
        z_lo, -5.0, N)
    p = st.init_particles(x, y, z, dtype=dtype, device=dev)
    return p.replace(status=torch.full_like(p.status, st.ACTIVE))


def _window(case, dev, dt):
    return synth.fieldset_window(case, -dt / 2, dt, 3, device=dev)


def _tile(dev, dt, dtype, axes):
    """phase 11a's strip: tile 1 of 4 of phase 1's grid (land block, open
    rim) with the halo of halo_rows_needed, N particles of the strip, one
    slot in 16 EMPTY."""
    from ltjax_torch import shard
    case = cs.bench_case(torch, dev, dtype=dtype, axes=axes)
    ctx = cs.context(case)
    cfg = cs.make_cfg(N, TrackCollisions=True,
                      dtype_pos=cs.dtype_name(dtype))
    nx = case.grid.nx
    dy = float(np.diff(case.grid.y_rho.cpu().numpy()).min())
    halo = shard.halo_rows_needed(5e-5 * 100e3 * np.sqrt(2.0), dt, dy)
    spec = shard.make_spec(cfg, nx, 4 * N, 1, 4, halo=halo)
    tctx = shard.tile_context(ctx, spec, shard.build_tiled_static(
        case.grid, spec), 1)
    fs = shard.strip_fieldset(_window(case, dev, dt), spec, 1, nx)
    ys = tctx.grid.y_rho.cpu().numpy()
    x, y = cs.strip_particles(case, N, ys[1], ys[-2], seed=11)
    z = cs.near_surface_and_bottom(N, case.h0, seed=4)
    p = st.init_particles(x, y, z, dtype=dtype, device=dev)
    empty = torch.arange(N, device=dev) % 16 == 5
    p = p.replace(
        status=torch.where(empty, shard.EMPTY, st.ACTIVE).to(torch.int32),
        pid=torch.where(empty, -1, p.pid).to(torch.int32))
    return tctx, cfg, p, fs


def cells(dev, dt):
    """name -> a function that makes (ctx, cfg, p0, fsR): the cell's
    context, configuration, unsorted particles and 3-record window."""
    f32, f64 = torch.float32, torch.float64

    def plain(dtype=f32, axes=1.0, **kw):
        case = cs.bench_case(torch, dev, land=False, dtype=dtype, axes=axes)
        return (cs.context(case),
                cs.make_cfg(N, dtype_pos=cs.dtype_name(dtype), **kw),
                _particles(dev, -40.0 if not kw else -25.0,
                           0 if not kw else 1, dtype), _window(case, dev, dt))

    def larval(kw, z_lo):
        case = cs.bench_case(torch, dev, land=False, parabolic_aks=True)
        return (cs.context(case), cs.make_cfg(N, **kw),
                _particles(dev, z_lo, 1), _window(case, dev, dt))

    def halo(kw, z_lo):
        case = cs.bench_case(torch, dev, land=False, halocline=True)
        ctx = cs.context(case)
        if kw.get("settlementon"):
            ctx = cs.with_polygons(ctx)
        return (ctx, cs.make_cfg(N, **kw), _particles(dev, z_lo, 1),
                _window(case, dev, dt))

    def curv():
        case = cs.curv_bench_case(torch, dev, land=False)
        return (cs.context(case), cs.make_cfg(N), _particles(dev, -40.0, 0),
                _window(case, dev, dt))

    out = {"advect": plain}
    for name, kw in cs.LARVAL.items():
        out[name] = (lambda kw=kw, z=-25.0 if name == "behavior" else -40.0:
                     larval(kw, z))
    for name, kw in cs.SETTLE_SALT.items():
        out[name] = (lambda kw=kw, z=-25.0 if name == "settle" else -40.0:
                     halo(kw, z))
    out["curv"] = curv
    out["stochastic"] = lambda: plain(**cs.STOCHASTIC)
    out["f64"] = lambda: plain(f64)
    out["axes"] = lambda: plain(axes=cs.AXES_STRETCH)
    out["tile"] = lambda: _tile(dev, dt, f32, 1.0)
    out["tile_f64"] = lambda: _tile(dev, dt, f64, 1.0)
    out["tile_axes"] = lambda: _tile(dev, dt, f32, cs.AXES_STRETCH)
    return out


def main(label: str, points=None, names=None) -> None:
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
    dt = 3600.0
    res = {}
    for name, make in cells(dev, dt).items():
        if names and name not in names:
            continue
        ctx, cfg, p0, fsR = make()
        g = ctx.grid
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
    args = sys.argv[1:]
    only = None
    if "--cells" in args:
        k = args.index("--cells")
        only = set(args[k + 1].split(","))
        del args[k:k + 2]
    main(args[0] if args else "tree",
         int(args[1]) if len(args) > 1 else None, only)
