#!/usr/bin/env python3
"""Time every build of the per-step lanes kernel K3 in one checkout.

    python3 tools/lanes_ab.py LABEL [routes]

Run from the root of a checkout of the port (any commit whose
chip_smoke.py has phase 8's ``lanes_vs_plain``; copy this file into an
older checkout to time it), and compare two checkouts in one run on
one card, in turns (A, B, B, A).  For each K3 build, on the inputs of its
main path's first internal step (1,000,000 particles Hilbert-sorted,
records 0..2, t = 0; 8a's at 9 h), K2's displacement of them and then,
through the checkout's ``chip_smoke.lanes_vs_plain``: K3 against its
plain version, K3's device ms (the profiler, mean of 10 launches), the
wrapper call's ms (CUDA events around 10 calls), the plain version's ms
and the checkout's own bound of the kernel (``kernel_bound(...,
lanes=True)``); here also the host's ms a wrapper call (the enqueue of
20 calls, before the synchronize).  The builds (``BUILDS``):

  b6      8b's, bench.py's behavior cell with stochastic mortality
  oyster  8d's, OYSTER_8D on the halocline with Aks and phase 6's polygons
  b7, b3  8a's behavior 7 and diel migration lanes, at 1M
  f64     9b's float64 advect cell with stochastic mortality
  axes    9c's stretched axes (x1.002 a cell)
  curv    9d's curvilinear grid
  tile, tile-f64  tile 1 of 4 of 8b's grid (11b's strips), 1M in it

With ``routes``, then the main paths of 8b and 8d: the fused call of 16
external steps of 30 internal steps at 1M, warm particle-steps/s of 3
calls.  Prints one JSON line per build, one with all, and the card's
name and power limit.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from ltjax_torch import packed as pk, state as st, synth  # noqa: E402
from ltjax_torch.kernels import rk4_step as kr  # noqa: E402
from ltjax_torch.kernels import step_lanes as sl  # noqa: E402
from ltjax_torch.step import (_sort, make_fused_external_steps,  # noqa: E402
                              packed_window)

N = 1_000_000
# 8d's cell: phase 3's oyster run with stochastic mortality at the death
# age of bench.py's behavior cell (2 days: about 72% of the particles
# survive 16 h)
OYSTER_8D = dict(cs.OYSTER_STOCHASTIC, deadage=cs.STOCHASTIC["deadage"])
BUILDS = ("b6", "oyster", "b7", "b3", "f64", "axes", "curv", "tile",
          "tile-f64")


def _uniform(dev, n, z_lo, dtype=torch.float32):
    """8b's release: x, y uniform in [40, 160] km (rng 0), z uniform in
    [z_lo, -5] m (rng 1), every particle ACTIVE."""
    rng = np.random.default_rng(0)
    x = rng.uniform(40e3, 160e3, n)
    y = rng.uniform(40e3, 160e3, n)
    z = np.random.default_rng(1).uniform(z_lo, -5.0, n)
    p = st.init_particles(x, y, z, dtype=dtype, device=dev)
    return p.replace(status=torch.full_like(p.status, st.ACTIVE))


def cell(name, dev, n=N, n_rec=3):
    """(ctx, cfg, particles, fsR, t) of a build's main path: fsR holds
    n_rec records from t's window (3: one external step's)."""
    dt = 3600.0
    if name == "oyster":
        case = cs.bench_case(torch, dev, land=False, halocline=True,
                             parabolic_aks=True)
        return (cs.with_polygons(cs.context(case)),
                cs.make_cfg(n, **OYSTER_8D), _uniform(dev, n, -40.0),
                synth.fieldset_window(case, -dt / 2, dt, n_rec, device=dev),
                0.0)
    if name in ("b7", "b3"):
        # 8a's lanes: phase 1's particles (land block, open rim) with ages
        # across the swim ramp and the death age, at 9 h (daylight)
        case = cs.bench_case(torch, dev, halocline=True, parabolic_aks=True)
        t9 = 9 * 3600.0
        x, y, _ = cs.water_particles(case, n, 2e3, 198e3, seed=1)
        z = cs.near_surface_and_bottom(n, case.h0, seed=4)
        rng = np.random.default_rng(5)
        age = rng.uniform(0.0, 3 * 86400.0, n)
        p = st.init_particles(x, y, z, dob=-age, dtype=torch.float32,
                              device=dev)
        p = p.replace(age=torch.tensor(age, dtype=torch.float32, device=dev),
                      pid=torch.tensor(rng.permutation(n), dtype=torch.int32,
                                       device=dev))
        kw = cs.LANES8["behavior7" if name == "b7" else "dvm"]
        return (cs.context(case), cs.make_cfg(
            n, TrackCollisions=True, **{**cs.STOCHASTIC, **kw}), p,
            synth.with_vertical_motion(synth.fieldset_window(
                case, t9 - dt / 2, dt, n_rec, device=dev), seed=3), t9)
    f64 = name in ("f64", "tile-f64")
    dtype = torch.float64 if f64 else torch.float32
    if name == "curv":
        case = cs.curv_bench_case(torch, dev, land=False)
    else:
        case = cs.bench_case(torch, dev, land=False, dtype=dtype,
                             axes=cs.AXES_STRETCH if name == "axes" else 1.0)
    ctx = cs.context(case)
    cfg = cs.make_cfg(n, dtype_pos="float64" if f64 else "float32",
                      **cs.STOCHASTIC)
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_rec, device=dev)
    if not name.startswith("tile"):
        return ctx, cfg, _uniform(dev, n, -25.0, dtype), fsR, 0.0
    from ltjax_torch import shard
    y_ax = case.grid.y_rho.cpu().numpy()
    halo = shard.halo_rows_needed(5e-5 * 100e3 * np.sqrt(2.0), dt,
                                  float(np.diff(y_ax).min()))
    spec = shard.make_spec(cfg, case.grid.nx, 4 * n, 1, 4, halo=halo)
    tiled = shard.build_tiled_static(case.grid, spec)
    tctx = shard.tile_context(ctx, spec, tiled, 1)
    ys = tctx.grid.y_rho.cpu().numpy()
    x, y = cs.strip_particles(case, n, ys[1], ys[-2], seed=11)
    z = np.random.default_rng(1).uniform(-25.0, -5.0, n)
    p = st.init_particles(x, y, z, dtype=dtype, device=dev)
    p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
    return (tctx, cfg, p, shard.strip_fieldset(fsR, spec, 1, case.grid.nx),
            0.0)


def host_ms(ctx, cfg, p, prec, f3, t, reps=20):
    """The host's milliseconds a wrapper call: the enqueue of reps calls
    (K2's displacement of p computed once), before the synchronize."""
    g, idt = ctx.grid, float(cfg.idt)
    tabs = pk.stage_value_tables(g, prec, t, idt)
    disp = kr.rk4_displacement_fused(g, tabs, p.x, p.y, p.z,
                                     cfg.tension_sigma, cfg.z0, idt,
                                     stage1=cfg.Behavior == 7)
    if hasattr(sl, "aux_tables"):          # the step's collapsed tables
        aux = sl.aux_tables(g, cfg, prec, t, idt)

        def call():
            return sl.step_lanes_fused(ctx, cfg, cfg.seed, 0, p, f3, tabs,
                                       aux, t, disp)
    else:                                  # the raw records' design
        def call():
            return sl.step_lanes_fused(ctx, cfg, cfg.seed, 0, p, f3, prec,
                                       tabs, t, disp)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return ms


def time_build(name, dev, n=N):
    """One build's row: lanes_vs_plain's numbers at n particles, the host
    ms a call, the variant's tag."""
    from ltjax_torch.kernels import build
    ctx, cfg, p0, fs, t = cell(name, dev, n)
    ps, _ = _sort(ctx.grid, p0)
    prec = packed_window(ctx, cfg, "per_step", fs)
    r = cs.lanes_vs_plain(torch, "lanes-" + name, ctx, cfg, ps, prec, fs,
                          t, reps=10, plain_reps=1)
    r["host_ms"] = host_ms(ctx, cfg, ps, prec, fs, t)
    r["variant"] = build.tag("step_lanes", sl.kernel_variant(ctx, cfg,
                                                             ps.x.dtype))
    if "kernel_ms" in r:
        r["bound_share"] = r["bound"]["bound_ms"] / r["kernel_ms"]
    return r


def route_rates(name, dev, n=N, n_fuse=16, calls=3):
    """Warm particle-steps/s of the fused call (n_fuse x 30 steps) of 8b's
    cell ("b6") or 8d's ("oyster")."""
    ctx, cfg, p0, fsR, _ = cell(name, dev, n, n_rec=n_fuse + 2)
    fused = make_fused_external_steps(ctx, cfg, n_fuse)
    fused(p0, fsR, 0.0, 0)
    torch.cuda.synchronize()
    rates = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fused(p0, fsR, 0.0, 0)
        torch.cuda.synchronize()
        rates.append(n * cfg.internal_steps * n_fuse
                     / (time.perf_counter() - t0))
    return rates


def card_name():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None


def main(label, routes=False):
    if not torch.cuda.is_available():
        raise SystemExit("lanes_ab: needs a CUDA device")
    dev = torch.device("cuda")
    res = {}
    for name in BUILDS:
        r = time_build(name, dev)
        keep = ("variant", "kernel_ms", "call_ms", "host_ms", "plain_ms",
                "bound", "bound_share", "decision_flips")
        res[name] = {k: r[k] for k in keep}
        print(json.dumps({"tree": label, "build": name, **res[name]}),
              flush=True)
    out = {"tree": label, "card": card_name(), "builds": res}
    if routes:
        out["routes"] = {name: route_rates(name, dev)
                         for name in ("b6", "oyster")}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree",
         len(sys.argv) > 2 and sys.argv[2] == "routes")
