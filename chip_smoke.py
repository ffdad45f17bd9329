#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ltjax_torch) once on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --only 4,9 # some phases (no summary lines)
    python3 chip_smoke.py --profile  # where the time goes, per bench cell

Builds the variants of the external-step CUDA kernel (K1), the per-step
RK4 kernel (K2) and the per-step lanes kernel (K3) from
ltjax_torch/kernels/csrc (one nvcc each, all started together), then
runs thirteen phases and fails (non-zero exit, no final
line) if any of them fails:

1. the kernel against its plain PyTorch version on the card: one
   external step (30 internal steps) of 65,536 particles on the
   200x200x20 bench grid with a land block (reflection) and an open rim
   (exits), particles near the surface and in the bottom log layer, on
   the affine and on a stretched ladder (theta_s 4, hc 10 m: depths that
   depend on Cs and hc); then the same with a seeded random w and zeta,
   internal step by internal step (w fit, surface and bottom
   reflection); then each path of the staged corner source with its
   counter: unsorted inputs (every block from device memory, as
   block_boxes predicts), a dense sorted patch (staged), and a flow ten
   times faster (misses);
2. the advection main path at real size: 1,000,000 particles, 16 fused
   external steps x 30 internal steps through ltjax_torch.step
   .make_fused_external_steps, held against the closed-form trajectory;
   timed with the Hilbert sort on and off; then the kernel against its
   plain version on the inputs of the main path's first launch;
3. the normal entry point: ltjax_torch.run.main on written planar ROMS
   series + parfile + namelist, CSV output: advection (against the
   closed form), a turbulent series on a parabolic Aks profile in
   chunks of 2 and of 4 external steps (identical particles), a
   diel-vertical-migration run, and an oyster run (behavior 4 on a
   halocline, SaltTempOn, settlement on habitat and hole CSVs,
   turbulence, mortality) in chunks of 2 and of 4 (identical particles);
4. the stochastic larval path at real size: bench.py's turb (horizontal
   and Visser vertical turbulence on the parabolic Aks profile),
   behavior (type-6 sinking + mortality) and dvm (type 3) variants, 1M
   particles, 16 x 30 steps through make_fused_external_steps, timed;
   each held against its plain version internal step by internal step
   from the plain trajectory's state, and timed against it per external
   step at 65,536 and at 1M particles;
5. the physics of the new lanes on the card: the horizontal random walk's
   variance on a zero-flow case (1M particles, 30 steps) and its deviates
   at 1e-5 m near the origin; the well-mixed condition of the Visser
   scheme (1M particles uniform in depth stay uniform over 180 steps);
   and a per-step check of each behavior type, mortality (DEAD over a
   same-step ERROR) and constant vertical diffusivity at 65,536
   particles;
6. settlement and salt at real size: bench.py's settle (type-6 sinking,
   settlement on its habitat square, here with a hole, and a slanted
   hexagon) and salt (behavior 4 on a heaving halocline, SaltTempOn)
   variants, 1M particles, 16 x 30 steps, timed; the settled counts by
   polygon (none in the hole) and the share of particles the cue moves;
   each kernel held against its plain version step by step and timed per
   external step at 65,536 and 1M; then per-step checks at 65,536 of
   behavior 5, sampling alone, behavior 4 without sampling, and
   settlement, death and exits in the same step;
7. curvilinear grids (the LTX_CURV variants): bench.py's curv geometry
   (200x200x20, a 3% sinusoidal distortion) with phase 1's land block,
   the kernel against its plain version at 65,536 particles (reflection
   and exits on curved segments); bench.py's curv cell at 1M through
   make_fused_external_steps (16 x 30, timed, against the circles) and
   the kernel against its plain version on its first launch; per-step
   checks of turbulence and of the oyster lanes on the curvilinear
   halocline at 65,536; and the CLI on a geographic curvilinear series;
8. stochastic mortality through the per-step route (per internal step
   the RK4 kernel K2, then the lanes kernel K3): K2 against its plain
   version at 65,536 particles on phase 1's inputs, its random-w case
   and the stretched ladder; K3 against its plain version on phase 1's
   particles for bench.py's behavior cell, the oyster lanes, behavior 7
   and diel migration (equal statuses and DEATH decisions); bench.py's
   behavior cell with stochastic mortality at 1M (16 x 30 steps through
   make_fused_external_steps: 480 launches each of K2 and K3 and none of
   the whole-step kernel, timed, the dead share against 1 -
   exp(-t/deadage), the circles), per internal step against the plain
   route, K2 and K3 timed at 1M and 65,536, and the internal step split
   by the profiler; the oyster CLI run with stochastic mortality in
   chunks of 2 and 4, and its lanes per step at 65,536;
9. the builds that let an LTRANS v2b run file start on the card:
   float64 positions (LTX_POS64), stretched rectilinear axes searched
   (LTX_AXES) and the per-step kernel on a curvilinear grid (LTX_CURV):
   (a) each against its plain version at 65,536 on phase 1's and phase
   8a's inputs; (b) the main path in float64 at full width, bench.py's
   advect cell with dtype_pos float64 (1M, 16 x 30, the circles); (c) a
   stretched-grid advection cell at 1M, 16 x 30 (spacing x1.002 a
   cell), and the same grid with stochastic mortality; (d) bench.py's
   curv cell with stochastic mortality at 1M, 16 x 30 (480 launches),
   the dead share and per internal step against the plain route; (e) the
   CLI on run files without a dtype_pos key: the float64 path against
   the closed form, BoundaryBLNs, checkpoint_every = 2 and --resume
   (final particles equal to the uninterrupted run's), and a stochastic
   run on the per-step route in float64;
10. the native route (fast_interp = False, or adaptive tension
   tension_sigma < 0: the reference's interpolation order as PyTorch
   ops, no kernel) and the CLI's record prefetch and diagnostic
   switches: (a) the route on the card against the same route on the
   CPU in float64, per internal step, on phase 1's particles and grid
   with a random w and zeta (sigma 0, adaptive, turbulence, stochastic
   mortality; 1e-6 m, 1e-9 m, equal statuses), and its displacement
   minus the collapsed route's; (b) the route at full width, phase 2's
   main-path case in float64 (1M particles, 1 x 30 steps) with
   fast_interp off and with sigma -1, against the circles and K1's
   float64 route, its rate, peak memory and per-internal-step device
   and wall ms, sorted and not, and the sort's time; (c) the CLI with each option
   (LTJAX_DEBUG_NANS on in one) and a run that leaves an
   LTJAX_PROFILE_DIR trace; (d) 1M particles through the CLI on a
   production-size series (800x600x25 where the disk takes it) with
   prefetch on and off, bit-equal, the read/compute/stall split per
   chunk;
11. sharded runs (ltjax_torch.shard, dist, run.run_sharded; the LTX_TILE
   builds of both kernels, which locate on the whole grid's axes and move
   into a tile's strip) and the native NetCDF reader: (a) K1 (float32,
   float64, stretched axes) and K2 on tile 1 of phase 1's grid cut into 4
   strips, against their plain versions, EMPTY slots bit-unchanged; (b)
   phase 2's case in float64 (1M, 4 external steps in chunks of 2) on
   the meshes (1, 4) and (2, 2), 4 gloo ranks sharing the card, against
   the single rank's K1 route, migrations counted, then stochastic
   mortality on the per-step route (K2 per tile): the same DEAD pids;
   (c) phase 3's CLI run through run.run(..., backend="gloo") on 2 x 2
   ranks: the single rank's CSV, resumes on (2, 2) and (1, 4); (d)
   BASELINE.json config 5 at size: 10M particles on an 800x600x25 series
   on 4 tiles, each rank reading its strip, against the single rank, the
   per-rank read / compute / stall split, and the native reader's MB/s
   against scipy's; (e) NCCL, one rank per card, where there are two
   cards or more;
12. the depth-banded Hilbert sort (sort_depth_bands, sort_band_height,
   sort_band_log) on a population under vertical shear (phase 2's grid,
   the rotation rate 1 + 0.01 z, particles uniform from -49 m to -1 m,
   no w and no turbulence, so each keeps its height and its band): (a)
   at 65,536 the banded fused call against the unbanded one, every
   column bit for bit: K1 in float32 and float64, the per-step route
   with stochastic mortality, and 2 gloo tiles on the card against the
   single unbanded rank; (b) K1 at 1M and 4M particles, 16 x 30 steps,
   unbanded and in four band settings, sorted every 2 and every
   external step: particle-steps/s, K1's and the sort's ms per external
   step, the staging counters and the staged share, the closed form;
   (c) phase 4's turb cell at 1M unbanded and with 3 bands; (d) the
   entry point with 3 bands on the ext_step, per-step and native routes
   and on 2 gloo tiles: the unbanded run's CSV;
13. the packed route (kernel_interp = False: ltjax's packed scheme,
   per-column tension fits evaluated on each corner's own knots and
   blended, as PyTorch ops, no kernel): (a) the route on the card
   against the same route on the CPU at 65,536, one internal step from
   the same state, float64 (1e-6 m, 1e-9 m, equal statuses and dead
   pids) for advection, turbulence, behavior 4 with salt, behavior 7,
   settlement and stochastic mortality on the uniform grid, some of them
   on stretched axes and the curvilinear grid, and float32 (0.05 m,
   1e-3 m); (b) phase 2's cell at 1M in float32 and float64 (2 x 30
   steps): particle-steps/s, peak memory, the closed form, the gap to
   K1's collapsed scheme on the same particles, per internal step the
   wall and device ms, idle share and top kernels; (c) the entry point
   on the card against the CPU (CSV), --resume (bit-equal) and 2 gloo
   tiles on the card (the single rank's CSV).

Stdout carries the card's name and power limit, the build report (per
library ptxas's registers, stack and spills, and its dynamic shared
memory and blocks per SM at the bench shape), each phase's numbers (the
main paths' staging counters: staged_block_steps, global_block_steps,
staged_misses, and the staged share) and its wall time, then the
per-kernel JSON summary
(each kernel's time, its plain version's, and its bound: the least time
the card could take for the same work, from the bytes and operations
counted in kernel_bound and rk4_bound), the card's name and power limit
again, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
There is no CPU path: without CUDA the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

KERNEL_SRC = "ltjax_torch/kernels/csrc/ext_step.cu"
KERNEL_REPLACES = "ltjax/kernels/ext_step.py:1404"
RK4_SRC = "ltjax_torch/kernels/csrc/rk4_step.cu"
RK4_REPLACES = "ltjax/kernels/gather_interp.py:827"
# K3: the per-step route's lanes, in ltjax the body of K1's internal step
# (ltjax/kernels/ext_step.py:993-1359) run as XLA ops on that route
LANES_SRC = "ltjax_torch/kernels/csrc/step_lanes.cu"
LANES_REPLACES = "ltjax/kernels/ext_step.py:993"
TOL_H = 0.5        # m, horizontal: f32 kernel vs plain (tests/test_kernel.py)
TOL_V = 1e-3       # m, vertical
MAX_MISMATCH = 1e-4   # status mismatches: at most 0.01% of particles
# horizontal error vs the closed form at f32: 0.43 m measured after 16 h
# at 1M particles, 0.06 m after 4 h through the CLI (H100, 700 W)
TOL_ANALYTIC = 2.0
TOL_ANALYTIC_CLI = 0.5
# the stochastic lanes, per internal step from the same state: the draws
# are bit-equal, what is left is f32 round-off and FMA contraction
TOL_H_STEP = 0.05
# phase 1's advection per internal step (1-vertical): 4 f32 ulps of a
# position at 128-256 km (0.0508 m measured on the H100)
TOL_H_STEP1 = 0.0625
TOL_HTURB_EXACT = 1e-5   # m, random-walk deviates near the origin
TOL_VARIANCE = 0.02      # relative, random-walk variance vs 2 K t
TOL_WELL_MIXED = 0.03    # relative, each of 10 depth bins vs N / 10
TOL_SALT = 1e-3          # psu / degC, kernel vs plain salt and temp

# bench.py's variants of the stochastic larval path (bench.py:53-71)
LARVAL = {
    "turb": dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                 readAks=True),
    "behavior": dict(Behavior=6, sink=5e-5, mortality=True, deadage=5e6),
    "dvm": dict(Behavior=3, swimslow=1e-3, swimfast=3e-3, pediage=5e6),
}
# per-step checks of every lane at 65,536 particles (phase 5)
SWIM = dict(deadage=2 * 86400.0, pediage=86400.0, swimstart=3600.0,
            swimslow=2e-3, swimfast=5e-3, sink=5e-4, Hswimspeed=0.1,
            Swimdepth=3.0)
LANE_CHECKS = {
    "vturb_const": dict(HTurbOn=True, VTurbOn=True, readAks=False,
                        ConstantVTurb=2e-3),
    "dead_over_error": dict(HTurbOn=True, ConstantHTurb=2e4,
                            mortality=True),
    **{f"behavior{b}": dict(Behavior=b, mortality=True)
       for b in (1, 2, 3, 6, 7)},
}


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def bench_case(torch, device, nx=200, ny=200, us=20, land=True,
               omega=5e-5, parabolic_aks=False, halocline=False,
               stretched=False, dtype=None, axes=1.0):
    """The bench.py advect case (200 km square, solid-body rotation,
    omega 5e-5, h0 50 m), optionally with a land block in its path,
    bench.py's turb-variant Aks profile, the synthetic halocline (salt
    and temperature, synth.halocline_fields) and (``stretched``) a
    stretched ladder, theta_s 4 with hc 10 m < h0, on which the s-level
    depths depend on both Cs and hc (with Cs = s or hc = h0 they depend
    on neither); the grid in ``dtype`` (default float32), on rho axes
    whose spacing grows by ``axes`` a cell (1: uniform)."""
    from ltjax_torch import synth
    return synth.make_solid_body_case(nx=nx, ny=ny, us=us, lx=200e3,
                                      ly=200e3, h0=50.0, omega=omega,
                                      dtype=dtype or torch.float32,
                                      device=device,
                                      mask=land_mask(nx, ny, land),
                                      parabolic_aks=parabolic_aks,
                                      halocline=halocline, stretch=axes,
                                      **(STRETCHED if stretched else {}))


STRETCHED = dict(theta_s=4.0, hc=10.0)


def land_mask(nx, ny, land):
    mask = np.ones((ny, nx), np.int32)
    if land:
        # a 16 x 10 cell island east of the centre, in the rotation path
        mask[int(0.47 * ny):int(0.52 * ny), int(0.62 * nx):int(0.70 * nx)] = 0
    return mask


def curv_bench_case(torch, device, nx=200, ny=200, us=20, land=True,
                    omega=5e-5, parabolic_aks=False, halocline=False,
                    dtype=None):
    """bench.py's curv case (the 200 km square distorted by 3%, solid-body
    rotation, omega 5e-5, h0 50 m), optionally with phase 1's land block,
    the turb-variant Aks profile and the halocline; the map in ``dtype``
    (default float32)."""
    from ltjax_torch import synth
    return synth.make_curv_case(nx=nx, ny=ny, us=us, lx=200e3, ly=200e3,
                                h0=50.0, omega=omega, amp=0.03,
                                mask=land_mask(nx, ny, land),
                                dtype=dtype or torch.float32, device=device,
                                parabolic_aks=parabolic_aks,
                                halocline=halocline)


def curv_water_particles(case, n, seed, margin=2.0):
    """n positions on a curvilinear case, uniform in logical coordinates
    at least ``margin`` cells inside the rim, whose 3x3 cell
    neighbourhood is water; depths in [-40, -5] m."""
    from ltjax_torch import synth
    rng = np.random.default_rng(seed)
    mask = case.grid.mask_rho.cpu().numpy()
    ny, nx = mask.shape
    ti, tj = [], []
    while sum(len(t) for t in ti) < n:
        a = rng.uniform(margin, nx - 1 - margin, n)
        b = rng.uniform(margin, ny - 1 - margin, n)
        i, j = np.rint(a).astype(int), np.rint(b).astype(int)
        wet = np.ones(n, bool)
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                wet &= mask[np.clip(j + dj, 0, ny - 1),
                            np.clip(i + di, 0, nx - 1)] > 0
        ti.append(a[wet])
        tj.append(b[wet])
    x, y = synth.logical_to_xy(case.x2d, case.y2d, np.concatenate(ti)[:n],
                               np.concatenate(tj)[:n])
    return x, y, rng.uniform(-40.0, -5.0, n)


def make_cfg(n, **kw):
    from ltjax_torch.run import Config
    base = dict(numpar=n, dt=3600, idt=120, us=20, ws=21,
                OpenOceanBoundary=True, dtype_pos="float32",
                reflect_iters=2)
    base.update(kw)
    return Config(**base)


def context(case):
    from ltjax_torch.physics import boundary as bd
    from ltjax_torch.step import StepContext
    g = case.grid
    mask = g.mask_rho.cpu().numpy()
    if g.curv is not None:
        bounds = bd.build_boundaries_curv(mask, case.x2d, case.y2d, g.curv,
                                          device=g.device)
    else:
        bounds = bd.build_boundaries(mask, g.x_rho.cpu().numpy(),
                                     g.y_rho.cpu().numpy(), device=g.device)
    return StepContext(grid=g, bounds=bounds)


def water_particles(case, n, lo, hi, seed):
    """n particles uniform in [lo, hi]^2 x [-40, -5] m, off land."""
    rng = np.random.default_rng(seed)
    g = case.grid
    mask = g.mask_rho.cpu().numpy()
    xa = g.x_rho.cpu().numpy()
    ya = g.y_rho.cpu().numpy()
    out = []
    while sum(len(o[0]) for o in out) < n:
        x = rng.uniform(lo, hi, n)
        y = rng.uniform(lo, hi, n)
        if g.uniform:
            i = np.clip(np.rint((x - xa[0]) / (xa[1] - xa[0])).astype(int),
                        0, len(xa) - 1)
            j = np.clip(np.rint((y - ya[0]) / (ya[1] - ya[0])).astype(int),
                        0, len(ya) - 1)
        else:                            # stretched axes: nearest node
            i = np.rint(np.interp(x, xa, np.arange(len(xa)))).astype(int)
            j = np.rint(np.interp(y, ya, np.arange(len(ya)))).astype(int)
        # keep particles whose 3x3 cell neighbourhood is water
        wet = np.ones(n, bool)
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                wet &= mask[np.clip(j + dj, 0, len(ya) - 1),
                            np.clip(i + di, 0, len(xa) - 1)] > 0
        out.append((x[wet], y[wet]))
    x = np.concatenate([o[0] for o in out])[:n]
    y = np.concatenate([o[1] for o in out])[:n]
    z = rng.uniform(-40.0, -5.0, n)
    return x, y, z


def cuda_time(torch, fn, reps):
    """Mean milliseconds of fn() over reps calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profiled_ms(torch, fn, reps, kernel):
    """Mean device milliseconds of a launch of the kernels named
    ``kernel`` over reps calls of fn() (torch.profiler's CUDA events, the
    mean of the launches it recorded), after a warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and kernel in e.name]
    assert ev, kernel
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / len(ev)


def profile_window(torch, fn, expect, tries=3):
    """The CUDA events of one profiled call of fn() (after the caller's
    warm call) and its wall milliseconds.  ``expect`` maps a kernel name to
    the launches its wrapper counted in that call; a window in which the
    profiler recorded fewer (CUPTI loses a kernel record now and then) is
    profiled again, up to ``tries`` windows.  Returns (events, wall_ms,
    windows, complete)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for window in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        complete = all(sum(name in e.name for e in ev) == n
                       for name, n in expect.items())
        if complete:
            break
    return ev, wall, window, complete


def compare(phase, p, out, ref):
    """Kernel output ``out`` against plain output ``ref`` from the same
    input ``p``: max |dx|, |dy|, |dz|, |dsalt|, |dtemp| over particles of
    equal status, and the status / settle_poly / collision-count
    mismatches (each status mismatch logged)."""
    s_ref = ref.status.cpu().numpy()
    s_out = out.status.cpu().numpy()
    same = s_ref == s_out
    res = {"max_abs_d" + k: float(np.abs(
        getattr(out, k).cpu().numpy()[same]
        - getattr(ref, k).cpu().numpy()[same]).max(initial=0.0))
        for k in ("x", "y", "z", "salt", "temp")}
    res["status_mismatch"] = int((~same).sum())
    for k in ("settle_poly", "hit_land", "hit_bottom"):
        res[k + "_mismatch"] = int((getattr(out, k) != getattr(ref, k))
                                   .sum())
    for q in np.nonzero(~same)[0][:10]:
        log({"phase": phase, "status_mismatch": int(q),
             "kernel": int(s_out[q]), "plain": int(s_ref[q]),
             "x0": float(p.x[q]), "y0": float(p.y[q])})
    return res


def check(res, n, tol_h=TOL_H, strict_status=False):
    assert res["max_abs_dx"] <= tol_h and res["max_abs_dy"] <= tol_h, res
    assert res["max_abs_dz"] <= TOL_V, res
    assert max(res["max_abs_dsalt"], res["max_abs_dtemp"]) <= TOL_SALT, res
    for k in ("status_mismatch", "settle_poly_mismatch", "hit_land_mismatch",
              "hit_bottom_mismatch"):
        assert res[k] <= MAX_MISMATCH * n, res
    assert not strict_status or (res["status_mismatch"] == 0
                                 and res["settle_poly_mismatch"] == 0), res


def kernel_vs_plain(torch, phase, ctx, cfg, p, prec, reps, plain_reps):
    """One external step through the kernel and through its plain version
    on the same inputs: errors, mismatches, and the time of each (CUDA
    events)."""
    from ltjax_torch.kernels import ext_step as kx
    ref = kx.ext_step_reference(ctx, cfg, p, prec, 0.0)
    kx.reset_launches()
    out = kx.ext_step_fused(ctx, cfg, p, prec, 0.0)
    if p.x.device.type == "cuda":
        torch.cuda.synchronize()
    res = {"phase": phase, "n": p.n, **compare(phase, p, out, ref),
           "staging": kx.counts()}
    ms = plain_ms = None
    if p.x.device.type == "cuda":
        ms = cuda_time(torch, lambda: kx.ext_step_fused(ctx, cfg, p, prec,
                                                        0.0), reps)
        plain_ms = cuda_time(torch, lambda: kx.ext_step_reference(
            ctx, cfg, p, prec, 0.0), plain_reps)
    s_ref = ref.status.cpu().numpy()
    res.update({
        # EMPTY slots of a tile (status -1) are no status
        "status_counts_plain": np.bincount(s_ref[s_ref >= 0],
                                           minlength=6).tolist(),
        "hit_land_plain": int(ref.hit_land.sum()),
        "hit_bottom_plain": int(ref.hit_bottom.sum()),
        "kernel_ms": ms, "plain_ms": plain_ms})
    log(res)
    check(res, p.n)
    return res


def lanes_stepwise(torch, phase, ctx, cfg, p, prec, fields, t0, steps,
                   seed=5, per_step=False, crossings=False,
                   tol_h=TOL_H_STEP):
    """The kernel's lanes, internal step by internal step from the plain
    trajectory's state (cfg.dt = cfg.idt; step i draws with step index
    i): horizontal tol_h (TOL_H_STEP), vertical TOL_V, age 1e-3 s, salt
    and temp TOL_SALT, equal statuses and settle_poly, hit_land / hit_bottom
    mismatches <= 0.01%.  Whole external steps are ill-conditioned under
    a random w or the stochastic lanes: near the bottom the log layer
    turns round-off in z into metres of horizontal drift, which moves w,
    so f32 against f64 of the plain version alone differs by hundreds of
    metres after 30 steps; step by step both sides start from the same
    state.  ``crossings`` also counts the plain version's bottom hits and
    surface crossings (before reflection) over the steps.

    Behaviors 1-5 and 7 decide by a threshold on a continuous value (zone
    edge, light threshold, |dS/dz| at Sgradient, riding speed), and
    settlement by a polygon edge; a particle within round-off of it may
    take the other branch, one swim step (or TST ride) away, or settle
    in one version only; on a curvilinear grid the boundary cell
    floor(ti + 0.5) of a point within f32 round-off of a cell edge may
    differ, and with it the segment bucket or guard radius.  Those
    "decision flips" are counted and allowed for at most 0.01% of the
    particles (as hit-count mismatches are); the other particles keep the
    tolerances.  Turbulence and the other lanes on a rectilinear grid
    allow none.

    ``per_step``: the per-step route instead, internal_step(mode="kernel")
    (the RK4 kernel and the PyTorch lanes) against
    internal_step(mode="collapsed")."""
    from dataclasses import replace
    from ltjax_torch import state as st
    from ltjax_torch.kernels import ext_step as kx
    from ltjax_torch.step import internal_step
    cfg1 = replace(cfg, dt=cfg.idt)
    idt = float(cfg.idt)
    thresholds = (cfg.Behavior in (1, 2, 3, 4, 5, 7) or cfg.settlementon
                  or ctx.grid.curv is not None)
    res = {"phase": phase, "n": p.n, "steps": steps, "max_abs_dx": 0.0,
           "max_abs_dy": 0.0, "max_abs_dz": 0.0, "max_abs_dage": 0.0,
           "max_abs_dsalt": 0.0, "max_abs_dtemp": 0.0,
           "status_mismatch": 0, "settle_poly_mismatch": 0,
           "hit_land_mismatch": 0, "hit_bottom_mismatch": 0,
           "decision_flips": 0}
    if crossings:
        res.update(hit_bottom_plain=0, surface_crossings_plain=0)
    q = p
    for i in range(steps):
        t = t0 + i * idt
        if per_step:
            out, ref = (internal_step(ctx, cfg1, seed, q, fields, t, i, prec,
                                      mode=m) for m in ("kernel", "collapsed"))
        else:
            out = kx.ext_step_fused(ctx, cfg1, q, prec, t, fields=fields,
                                    seed=seed, ext_idx=i)
            ref = kx.ext_step_reference(ctx, cfg1, q, prec, t,
                                        fields=fields, seed=seed, ext_idx=i)
        torch.cuda.synchronize()
        flip = ((((out.x - ref.x).abs() > tol_h)
                 | ((out.y - ref.y).abs() > tol_h)
                 | ((out.z - ref.z).abs() > TOL_V))
                & (out.status == ref.status))
        if cfg.settlementon:
            flip |= (out.status != ref.status) & (
                (out.status == st.SETTLED) | (ref.status == st.SETTLED))
        n_flip = int(flip.sum())
        q_cmp, ref_cmp = q, ref
        if thresholds and 0 < n_flip <= MAX_MISMATCH * p.n:
            for qi in torch.nonzero(flip)[:10, 0].tolist():
                log({"phase": phase, "decision_flip": qi,
                     "x0": float(q.x[qi]), "y0": float(q.y[qi]),
                     "z0": float(q.z[qi]), "dz_kernel": float(out.z[qi]
                                                              - q.z[qi]),
                     "dz_plain": float(ref.z[qi] - q.z[qi]),
                     "status_kernel": int(out.status[qi]),
                     "status_plain": int(ref.status[qi])})
            keep = torch.nonzero(~flip)[:, 0]
            q_cmp, out, ref_cmp = q.take(keep), out.take(keep), ref.take(keep)
        r = compare(phase, q_cmp, out, ref_cmp)
        r["max_abs_dage"] = float((out.age - ref_cmp.age).abs().max())
        r["decision_flips"] = n_flip if thresholds else 0
        check(r, p.n, tol_h, strict_status=True)
        assert r["max_abs_dage"] <= 1e-3, r
        for k, v in r.items():
            res[k] = max(res[k], v) if k.startswith("max") else res[k] + v
        if crossings:
            res["hit_bottom_plain"] += int((ref.hit_bottom
                                            - q.hit_bottom).sum())
            res["surface_crossings_plain"] += surface_crossings(ctx, cfg1, q,
                                                               prec, t)
        q = ref
    res["max_vertical_move_plain_m"] = float((q.z - p.z).abs().max())
    res["max_horizontal_move_plain_m"] = float(
        torch.hypot(q.x - p.x, q.y - p.y).max())
    res["status_counts_plain"] = np.bincount(q.status.cpu().numpy(),
                                             minlength=6).tolist()
    log(res)
    return res, q


def surface_crossings(ctx, cfg, p, prec, t0):
    """How many particles the plain version's internal step from t0
    carries above the surface before reflection (those released at t0
    included)."""
    from ltjax_torch import packed as pk, state as st
    from ltjax_torch.physics import boundary as bd
    g, idt = ctx.grid, float(cfg.idt)
    tabs = pk.stage_value_tables(g, prec, t0, idt)
    dx, dy, dz = pk.rk4_displacement_collapsed(
        g, tabs, p.x, p.y, p.z, cfg.tension_sigma, cfg.z0, idt)
    xr, yr, *_ = bd.reflect(ctx.bounds, p.x, p.y, p.x + dx, p.y + dy,
                            open_exits=cfg.OpenOceanBoundary,
                            n_iter=cfg.reflect_iters)
    zeta1, h1 = pk.zeta_h_packed(g, tabs[2], xr, yr)
    _, above, _ = bd.reflect_vertical(p.z + dz, zeta1, h1)
    act = (p.status == st.ACTIVE) | ((p.status == st.NOT_RELEASED)
                                     & (p.dob <= t0))
    return int((act & above).sum())


def phase1(torch, device, n=65536, nx=200, us=20, reps=5):
    """Kernel vs plain version on the same inputs.

    1. One external step (30 internal steps in one launch, timed) of
       solid-body rotation with the land block (reflection) and the open
       rim (exits); a third of the particles 0.1-1 m above the bottom,
       in the log layer, a third within a metre of the surface; then the
       same on a stretched ladder (depths that depend on Cs and hc).
    2. Rotation ten times slower (<= 0.7 m/s) with a seeded random w
       (+-5 mm/s) and zeta (std 0.3 m), step by step (lanes_stepwise:
       TOL_H_STEP1, TOL_V, equal statuses): the w-ladder fit, the
       zeta-moved knots and the surface and bottom reflections.
    3. Each path of the staged corner source (phase1_staging).

    f32 knows the height above the bottom z + h to ~4e-6 m, and the log
    layer's factor has slope 1/((z + h) ln(z_tb/z0)): a particle within
    a millimetre of the bottom moving at the bench case's up to 7 m/s
    drifts by metres in an hour on round-off alone, in either version.
    Hence the 0.1 m floor of the whole-step check, and the slower flow
    where the random w carries particles onto the bottom."""
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.step import _sort
    case = bench_case(torch, device, nx=nx, ny=nx, us=us)
    ctx = context(case)
    cfg = make_cfg(n, us=us, ws=us + 1, TrackCollisions=True)
    fs = synth.fieldset_for(case, t_center=0.0, dt=3600.0, device=device)
    x, y, _ = water_particles(case, n, 2e3, 198e3, seed=1)
    z = near_surface_and_bottom(n, case.h0, seed=4)
    pu = st.init_particles(x, y, z, dtype=torch.float32, device=device)
    pu = pu.replace(status=torch.full_like(pu.status, st.ACTIVE))
    p, _ = _sort(case.grid, pu)        # as the main path hands it over
    prec = pk.build_packed_records(case.grid, fs)
    res = kernel_vs_plain(torch, 1, ctx, cfg, p, prec, reps, 2)
    # the land block and the open rim were both exercised
    assert res["hit_land_plain"] > 0, res
    assert res["status_counts_plain"][st.OUT_OF_DOMAIN] > 0, res

    stretched = bench_case(torch, device, nx=nx, ny=nx, us=us,
                           stretched=True)
    assert ladder_depends_on_cs_and_hc(stretched.grid)
    res_s = kernel_vs_plain(
        torch, "1-stretched", context(stretched), cfg, p,
        pk.build_packed_records(stretched.grid, synth.fieldset_for(
            stretched, t_center=0.0, dt=3600.0, device=device)), 1, 1)
    assert res_s["hit_land_plain"] > 0, res_s

    slow = bench_case(torch, device, nx=nx, ny=nx, us=us, omega=5e-6)
    prec_v = pk.build_packed_records(case.grid, synth.with_vertical_motion(
        synth.fieldset_for(slow, t_center=0.0, dt=3600.0, device=device),
        seed=3))
    res_v, _ = lanes_stepwise(torch, "1-vertical", ctx, cfg, p, prec_v, None,
                              0.0, cfg.internal_steps, crossings=True,
                              tol_h=TOL_H_STEP1)
    # the bottom and the surface were both hit, and particles moved
    assert res_v["hit_bottom_plain"] > 0, res_v
    assert res_v["surface_crossings_plain"] > 0, res_v
    assert res_v["max_vertical_move_plain_m"] > 1.0, res_v
    res_g = phase1_staging(torch, device, case, ctx, cfg, pu, prec)
    return res, res_s, res_v, res_g


def ladder_depends_on_cs_and_hc(grid, h=50.0):
    """The grid's rho and w depths in a resting column of depth h move by
    more than 0.5 m when Cs is replaced by s, and when hc is replaced by
    h: a kernel that reads hc or Cs wrongly cannot pass on it."""
    from ltjax_torch.scoord import s_depths
    zero, hh = np.zeros(1), np.full(1, h)
    for s, cs in ((grid.s_rho, grid.Cs_r), (grid.s_w, grid.Cs_w)):
        s, cs = s.cpu().numpy(), cs.cpu().numpy()
        z = s_depths(zero, hh, s, cs, grid.hc, grid.vtransform)
        for z_other in (s_depths(zero, hh, s, s, grid.hc, grid.vtransform),
                        s_depths(zero, hh, s, cs, h, grid.vtransform)):
            if np.abs(z - z_other).max() <= 0.5:
                return False
    return True


def phase1_staging(torch, device, case, ctx, cfg, pu, prec, n=65536):
    """Each path of the staged corner source against the plain version,
    with its own counter (csrc find_currents.cuh):

    * overflow: phase 1's inputs unsorted (one external step, whole-step
      tolerances): every block's box exceeds the budget and runs from
      device memory; global_block_steps of a one-internal-step launch
      equals block_boxes' count of the blocks that do not fit;
    * staged: 65,536 sorted particles on a 24 x 24 km patch west of the
      centre (~110 a cell; the main path has ~70): the blocks stage, as
      block_boxes predicts for the first internal step;
    * misses: the same batch in a flow four times faster (7-12 m/s,
      0.9-1.4 cells an internal step), internal step by internal step
      (lanes_stepwise): stencils leave the box and read device memory.
      Ten times faster would be 2-4 cells a step, past the displacement
      guard's 1.5 cells: every particle would end ERROR in the first
      step."""
    from dataclasses import replace
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import ext_step as kx
    from ltjax_torch.step import _sort
    nl = prec.tab.shape[-1]
    cfg1 = replace(cfg, dt=cfg.idt)

    def first_step(q):
        """(measured, predicted) global_block_steps of the first internal
        step of batch q."""
        kx.reset_launches()
        kx.ext_step_fused(ctx, cfg1, q, prec, 0.0)
        got = kx.counts()["global_block_steps"]
        b = kx.block_boxes(ctx.grid, q.x, q.y, q.status, nl)
        return got, int((b["live"] & ~b["fits"]).sum())

    out = {}
    r = kernel_vs_plain(torch, "1-overflow", ctx, cfg, pu, prec, 1, 1)
    r["global_first_step"], r["global_first_step_predicted"] = first_step(pu)
    log({"phase": "1-overflow", "staging": r["staging"],
         "global_first_step": r["global_first_step"],
         "predicted": r["global_first_step_predicted"]})
    g = r["staging"]
    assert g["global_block_steps"] > 9 * g["staged_block_steps"], r
    assert r["global_first_step"] == r["global_first_step_predicted"], r
    out["overflow"] = r

    rng = np.random.default_rng(11)
    # depths clear of the log layer: near the bottom a particle lags its
    # block in the rotation and the boxes grow
    pd = st.init_particles(rng.uniform(40e3, 64e3, n),
                           rng.uniform(88e3, 112e3, n),
                           rng.uniform(-40.0, -5.0, n),
                           dtype=torch.float32, device=device)
    pd = pd.replace(status=torch.full_like(pd.status, st.ACTIVE))
    pd, _ = _sort(ctx.grid, pd)
    r = kernel_vs_plain(torch, "1-staged", ctx, cfg, pd, prec, 1, 1)
    r["global_first_step"], r["global_first_step_predicted"] = first_step(pd)
    log({"phase": "1-staged", "staging": r["staging"],
         "global_first_step": r["global_first_step"],
         "predicted": r["global_first_step_predicted"]})
    g = r["staging"]
    assert g["staged_block_steps"] > 9 * g["global_block_steps"], r
    assert r["global_first_step"] == r["global_first_step_predicted"], r
    out["staged"] = r

    fast = bench_case(torch, device, nx=case.grid.nx, ny=case.grid.ny,
                      us=case.grid.us, omega=2e-4)
    prec_f = pk.build_packed_records(ctx.grid, synth.fieldset_for(
        fast, t_center=0.0, dt=3600.0, device=device))
    kx.reset_launches()
    r, _ = lanes_stepwise(torch, "1-misses", ctx, cfg, pd, prec_f, None, 0.0,
                          steps=5)
    r["staging"] = kx.counts()
    log({"phase": "1-misses", "staging": r["staging"]})
    assert r["staging"]["staged_misses"] > 0, r
    assert r["staging"]["staged_block_steps"] > 0, r
    assert r["status_counts_plain"][st.ACTIVE] > 0.9 * n, r
    out["misses"] = r
    return out


def near_surface_and_bottom(n, h0, seed):
    """Depths: a third within 1 m of the surface, a third 0.1-1 m above
    the bottom (-h0), the rest in between."""
    rng = np.random.default_rng(seed)
    k = n // 3
    return np.concatenate([rng.uniform(-1.0, 0.0, k),
                           rng.uniform(0.1 - h0, 1.0 - h0, k),
                           rng.uniform(1.0 - h0, -1.0, n - 2 * k)])


def phase2(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16):
    """The bench advect configuration through make_fused_external_steps,
    Hilbert sort on (the main path, counted) and off (kernel only)."""
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import ext_step as kx
    from ltjax_torch.step import (_sort, make_fused_external_steps,
                                  summary_counts)
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False)
    ctx = context(case)
    cfg = make_cfg(n, us=us, ws=us + 1)
    dt = float(cfg.dt)
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_fuse + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    p0 = st.init_particles(x0, y0, z0, dtype=torch.float32, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    fused = make_fused_external_steps(ctx, cfg, n_fuse)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    sync()
    kx.reset_launches()
    t0 = time.perf_counter()
    p = fused(p0, fsR, 0.0, 0)
    sync()
    sec_on = time.perf_counter() - t0
    launches = kx.ext_step_fused.launches
    staging = kx.counts()

    # sort off: the same kernel calls on the unsorted batch
    prec_all = pk.build_packed_records(case.grid, fsR)
    sync()
    t0 = time.perf_counter()
    q = p0
    for e in range(n_fuse):
        prec3 = pk.PackedRecords(tab=prec_all.tab[e:e + 3],
                                 times=prec_all.times[e:e + 3])
        q = kx.ext_step_fused(ctx, cfg, q, prec3, e * dt)
    sync()
    sec_off = time.perf_counter() - t0

    steps = n * cfg.internal_steps * n_fuse
    counts = summary_counts(p)
    xa, ya, _ = case.analytic(x0, y0, z0, n_fuse * dt)
    err = np.hypot(p.x.cpu().numpy() - xa, p.y.cpu().numpy() - ya)
    err_off = np.hypot(q.x.cpu().numpy() - xa, q.y.cpu().numpy() - ya)
    res = {"phase": 2, "n": n, "ext_steps": n_fuse,
           "internal_steps": cfg.internal_steps, "launches": launches,
           "seconds_sort_on": sec_on, "seconds_sort_off": sec_off,
           "particle_steps_per_s_sort_on": steps / sec_on,
           "particle_steps_per_s_sort_off": steps / sec_off,
           "max_err_vs_analytic_m": float(err.max()),
           "max_err_vs_analytic_sort_off_m": float(err_off.max()),
           "counts": counts, "staging": staging,
           "staged_share": staged_share(staging)}
    log(res)
    # the CPU rehearsal of this function runs the plain version
    assert launches == (n_fuse if device.type == "cuda" else 0), res
    assert counts["error"] == 0 and counts["active"] == n, res
    assert np.isfinite(err).all() and err.max() < TOL_ANALYTIC, res
    assert err_off.max() < TOL_ANALYTIC, res

    # the kernel against its plain version at the main path's own shape:
    # the inputs of its first launch (sorted batch, records 0..2)
    ps, _ = _sort(case.grid, p0)
    prec3 = pk.PackedRecords(tab=prec_all.tab[:3], times=prec_all.times[:3])
    res["kernel"] = kernel_vs_plain(torch, 2, ctx, cfg, ps, prec3, 3, 1)
    res["bound"] = kernel_bound(cfg, ctx, prec3, ps,
                                kx.ext_step_fused(ctx, cfg, ps, prec3, 0.0))
    # block_boxes predicts the blocks of the first internal step that
    # run from device memory
    from dataclasses import replace
    kx.reset_launches()
    kx.ext_step_fused(ctx, replace(cfg, dt=cfg.idt), ps, prec3, 0.0)
    b = kx.block_boxes(case.grid, ps.x, ps.y, ps.status, prec3.tab.shape[-1])
    res["global_first_step"] = kx.counts()[
        "global_block_steps"]
    res["global_first_step_predicted"] = int((b["live"] & ~b["fits"]).sum())
    log({"phase": 2, "bound": res["bound"],
         "global_first_step": res["global_first_step"],
         "predicted": res["global_first_step_predicted"]})
    if device.type == "cuda":
        assert res["staged_share"] > 0.9, res["staging"]
        assert (res["global_first_step"]
                == res["global_first_step_predicted"]), res
    return res


def staged_share(c):
    """Staged block-steps over all block-steps with an active particle."""
    tot = c["staged_block_steps"] + c["global_block_steps"]
    return c["staged_block_steps"] / tot if tot else None


def phase3(torch, device, n=10_000, nx=60, us=10, n_ext=4):
    """ltjax_torch.run.main on written ROMS files, CSV output."""
    from ltjax_torch import run, synth
    work = os.path.join(ROOT, "build", "chip_smoke")
    case = synth.make_solid_body_case(nx=nx, ny=nx, us=us, lx=60e3, ly=60e3,
                                      h0=50.0, omega=5e-5,
                                      dtype=torch.float64)
    rng = np.random.default_rng(2)
    x0 = rng.uniform(15e3, 45e3, n)
    y0 = rng.uniform(15e3, 45e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    nml = synth.write_run_files(case, work, x0, y0, z0, n_ext=n_ext,
                                dt=3600, idt=120, iprint=3600 * n_ext,
                                ext_fuse=n_ext, dtype_pos="float32")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main([nml])
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"[run] {ln}")
    start = json.loads(lines[0])
    csv = os.path.join(work, "out", "run1.csv")
    rows = np.loadtxt(csv, delimiter=",")
    last = rows[rows[:, 0] == rows[:, 0].max()]
    last = last[np.argsort(last[:, 1])]
    xa, ya, _ = case.analytic(x0, y0, z0, n_ext * 3600.0)
    err = np.hypot(last[:, 2] - xa, last[:, 3] - ya)
    res = {"phase": 3, "n": n, "rc": rc, "path": start["path"],
           "uniform": start["uniform"], "csv_rows": int(rows.shape[0]),
           "max_err_vs_analytic_m": float(err.max())}
    log(res)
    assert rc == 0 and start["path"] == (
        "cuda_ext_step" if device.type == "cuda" else "plain"), res
    assert start["uniform"] is True, res
    assert last.shape[0] == n and np.all(last[:, 5] == 1), res
    assert err.max() < TOL_ANALYTIC_CLI, res
    return res


def run_cli(run, nml, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main([nml, *args])
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"[run] {ln}")
    assert rc == 0, rc
    return [json.loads(ln) for ln in lines if ln.startswith("{")]


def phase3_larval(torch, device, n=10_000, nx=60, us=10):
    """The CLI with the stochastic lanes: a turbulent series (HTurb +
    Visser on the parabolic AKs written to the series) in chunks of 2 and
    of 4 external steps, which must give the same particles (draws keyed
    by the global step index), and a type-3 run with mortality."""
    from ltjax_torch import run, synth
    case = synth.make_solid_body_case(nx=nx, ny=nx, us=us, lx=60e3, ly=60e3,
                                      h0=50.0, omega=5e-5,
                                      dtype=torch.float64, parabolic_aks=True)
    rng = np.random.default_rng(5)
    x0 = rng.uniform(15e3, 45e3, n)
    y0 = rng.uniform(15e3, 45e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    finals = {}
    for fuse in (2, 4):
        work = os.path.join(ROOT, "build", f"chip_smoke_turb{fuse}")
        nml = synth.write_run_files(
            case, work, x0, y0, z0, n_ext=4, dt=3600, idt=120,
            iprint=4 * 3600, ext_fuse=fuse, dtype_pos="float32",
            **LARVAL["turb"])
        lines = run_cli(run, nml)
        assert lines[0]["path"] == ("cuda_ext_step" if device.type == "cuda"
                                    else "plain"), lines[0]
        assert lines[0]["lanes"] == ["advection", "hturb", "vturb_aks"]
        rows = np.loadtxt(os.path.join(work, "out", "run1.csv"),
                          delimiter=",")
        last = rows[rows[:, 0] == rows[:, 0].max()]
        finals[fuse] = last[np.argsort(last[:, 1])]
    same = bool(np.array_equal(finals[2], finals[4]))
    f = finals[4]
    xa, ya, _ = case.analytic(x0, y0, z0, 4 * 3600.0)
    work = os.path.join(ROOT, "build", "chip_smoke_dvm")
    nml = synth.write_run_files(
        case, work, x0, y0, z0, n_ext=4, dt=3600, idt=120, iprint=4 * 3600,
        ext_fuse=4, dtype_pos="float32", mortality=True, deadage=7200.0,
        **LARVAL["dvm"])
    dvm = run_cli(run, nml)
    res = {"phase": "3-larval", "n": n, "turb_chunks_identical": same,
           "turb_mean_dist_from_closed_form_m": float(
               np.hypot(f[:, 2] - xa, f[:, 3] - ya).mean()),
           "turb_max_vertical_move_m": float(np.abs(f[:, 4] - z0).max()),
           "dvm_lanes": dvm[0]["lanes"], "dvm_counts": dvm[-1]}
    log(res)
    assert same and np.isfinite(f).all(), res
    assert res["turb_max_vertical_move_m"] > 1.0, res
    assert dvm[0]["lanes"] == ["advection", "behavior3", "mortality"], res
    assert dvm[-1]["dead"] == n, res


def phase4(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16,
           n_small=65536):
    """bench.py's turb, behavior and dvm variants at 1M particles through
    make_fused_external_steps (16 x 30 steps, timed, launches counted),
    then the kernel against its plain version: per internal step from
    the plain trajectory's state, and timed per external step at 1M and
    at 65,536 particles (the main path's first-launch inputs)."""
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import build, ext_step as kx
    from ltjax_torch.step import (_sort, fieldset_slice,
                                  make_fused_external_steps, summary_counts)
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False,
                      parabolic_aks=True)
    ctx = context(case)
    dt = 3600.0
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_fuse + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    out = {}
    for name, kw in LARVAL.items():
        cfg = make_cfg(n, us=us, ws=us + 1, **kw)
        # bench.py: sinking starts shallower, clear of the bottom layer
        z0 = np.random.default_rng(1).uniform(
            -25.0 if name == "behavior" else -40.0, -5.0, n)
        p0 = st.init_particles(x0, y0, z0, dtype=torch.float32,
                               device=device)
        p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
        fused = make_fused_external_steps(ctx, cfg, n_fuse)
        # load the variant's module before the timed call (phase 1 does
        # this for phase 2's advection variant)
        fused(p0.take(torch.arange(128, device=device)), fsR, 0.0, 0)
        torch.cuda.synchronize()
        kx.reset_launches()
        t0 = time.perf_counter()
        p = fused(p0, fsR, 0.0, 0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = dict(kx.ext_step_fused.variant_launches)
        staging = kx.counts()
        tag = build.tag("ext_step", kx.kernel_variant(cfg))
        counts = summary_counts(p)
        res = {"phase": f"4-{name}", "n": n, "ext_steps": n_fuse,
               "internal_steps": cfg.internal_steps, "variant": tag,
               "launches": launches, "staging": staging,
               "staged_share": staged_share(staging), "seconds": sec,
               "particle_steps_per_s": n * cfg.internal_steps * n_fuse / sec,
               "max_vertical_move_m": float((p.z - p0.z).abs().max()),
               "counts": counts}
        log(res)
        assert launches == {tag: n_fuse}, res
        assert all(bool(torch.isfinite(getattr(p, k)).all())
                   for k in ("x", "y", "z")), res
        assert counts["active"] == n, res
        assert res["max_vertical_move_m"] > 0.1, res

        # the kernel against its plain version, timed per external step
        with_aks = bool(cfg.VTurbOn and cfg.readAks)
        prec_all = pk.build_packed_records(case.grid, fsR, with_aks=with_aks)
        ps, _ = _sort(case.grid, p0)
        small, _ = _sort(case.grid, p0.take(torch.arange(n_small,
                                                         device=device)))
        prec3 = pk.PackedRecords(tab=prec_all.tab[:3],
                                 times=prec_all.times[:3])
        f3 = fieldset_slice(fsR, 0)
        for size, q in (("1M", ps), (str(n_small), small)):
            res["kernel_ms_" + size] = cuda_time(
                torch, lambda: kx.ext_step_fused(ctx, cfg, q, prec3, 0.0,
                                                 fields=f3), 3)
            res["plain_ms_" + size] = cuda_time(
                torch, lambda: kx.ext_step_reference(ctx, cfg, q, prec3,
                                                     0.0, fields=f3), 1)
        res["bound"] = kernel_bound(cfg, ctx, prec3, ps, kx.ext_step_fused(
            ctx, cfg, ps, prec3, 0.0, fields=f3))
        # per internal step, from the plain trajectory's state; DVM from
        # 9 h (daylight: the light branches), on records 9..11
        e0 = min(9, n_fuse - 1) if name == "dvm" else 0
        prec_e = pk.PackedRecords(tab=prec_all.tab[e0:e0 + 3],
                                  times=prec_all.times[e0:e0 + 3])
        rs, _ = lanes_stepwise(torch, f"4-{name}", ctx, cfg, ps, prec_e,
                               fieldset_slice(fsR, e0), e0 * dt,
                               steps=30 if name == "turb" else 10)
        res["stepwise"] = {k: v for k, v in rs.items() if k.startswith("max")
                           or k.endswith("mismatch")}
        log({k: res[k] for k in res if k.startswith(("phase", "kernel_ms",
                                                        "plain_ms", "bound"))})
        out[name] = res
    return out


def centred_zero_flow_case(torch, device):
    """The bench grid without flow, its axes centred on the origin so that
    positions near it resolve displacements to ~1e-6 m in f32."""
    from dataclasses import replace
    case = bench_case(torch, device, land=False, omega=0.0)
    g = case.grid
    g = replace(g, x_rho=g.x_rho - 100e3, y_rho=g.y_rho - 100e3,
                x_u=g.x_u - 100e3, y_v=g.y_v - 100e3)
    return replace(case, grid=g, xc=0.0, yc=0.0)


def phase5(torch, device, n=1_000_000, n_small=65536):
    """The new lanes' physics on the card, and a per-step check of every
    lane at 65,536 particles."""
    from dataclasses import replace
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import ext_step as kx
    from ltjax_torch.step import make_fused_external_steps
    out = {}

    # (a) horizontal random walk: variance 2 K t after 30 steps, and the
    # deviates themselves near the origin
    case = centred_zero_flow_case(torch, device)
    ctx = context(case)
    cfg = make_cfg(n, HTurbOn=True, ConstantHTurb=1.0)
    rec = pk.build_packed_records(case.grid, synth.fieldset_for(
        case, t_center=1800.0, dt=3600.0, device=device))
    rng = np.random.default_rng(6)
    p0 = st.init_particles(rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                           rng.uniform(-40, -10, n), dtype=torch.float32,
                           device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    p = kx.ext_step_fused(ctx, cfg, p0, rec, 0.0, ext_idx=0)
    want = 2.0 * cfg.ConstantHTurb * float(cfg.dt)
    var = [float(((getattr(p, k) - getattr(p0, k)).double() ** 2).mean())
           for k in ("x", "y")]
    cfg1 = replace(cfg, dt=cfg.idt)
    k1 = kx.ext_step_fused(ctx, cfg1, p0, rec, 0.0, ext_idx=3)
    r1 = kx.ext_step_reference(ctx, cfg1, p0, rec, 0.0, ext_idx=3)
    exact = max(float((k1.x - r1.x).abs().max()),
                float((k1.y - r1.y).abs().max()))
    res = {"phase": "5-hturb", "n": n, "var_x_m2": var[0], "var_y_m2": var[1],
           "expected_2Kt_m2": want, "max_abs_deviate_diff_m": exact}
    log(res)
    assert all(abs(v / want - 1.0) <= TOL_VARIANCE for v in var), res
    assert exact <= TOL_HTURB_EXACT, res
    out["hturb"] = res

    # (b) the well-mixed condition: Visser on the parabolic Aks profile
    # keeps a uniform depth distribution uniform over 180 steps
    case = bench_case(torch, device, land=False, omega=0.0,
                      parabolic_aks=True)
    ctx = context(case)
    cfg = make_cfg(n, VTurbOn=True, readAks=True)
    fsR = synth.fieldset_window(case, -1800.0, 3600.0, 8, device=device)
    p0 = st.init_particles(rng.uniform(40e3, 160e3, n),
                           rng.uniform(40e3, 160e3, n),
                           rng.uniform(-case.h0, 0.0, n),
                           dtype=torch.float32, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    p = make_fused_external_steps(ctx, cfg, 6)(p0, fsR, 0.0, 0)
    hist, _ = np.histogram(p.z.cpu().numpy(), bins=10,
                           range=(-case.h0, 0.0))
    dev = np.abs(hist / (n / 10) - 1.0)
    res = {"phase": "5-well-mixed", "n": n, "steps": 180,
           "bins": hist.tolist(), "max_rel_dev": float(dev.max()),
           "rms_move_m": float((p.z - p0.z).double().pow(2).mean().sqrt())}
    log(res)
    assert dev.max() <= TOL_WELL_MIXED and res["rms_move_m"] > 1.0, res
    out["well_mixed"] = res

    # (c) every lane, step by step, from the plain trajectory's state:
    # land block, open rim, slow rotation with a random w and zeta,
    # particles near the surface and the bottom, ages across the swim
    # ramp and the death age, DVM in daylight
    case = bench_case(torch, device, omega=5e-6, parabolic_aks=True)
    ctx = context(case)
    t0 = 9 * 3600.0
    fs = synth.with_vertical_motion(synth.fieldset_for(
        case, t_center=t0 + 1800.0, dt=3600.0, device=device), seed=3)
    x, y, _ = water_particles(case, n_small, 2e3, 198e3, seed=1)
    z = near_surface_and_bottom(n_small, case.h0, seed=4)
    age = rng.uniform(0.0, 3 * 86400.0, n_small)
    p0 = st.init_particles(x, y, z, dob=-age, dtype=torch.float32,
                           device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE),
                    age=torch.tensor(age, dtype=torch.float32,
                                     device=device),
                    pid=torch.tensor(rng.permutation(n_small),
                                     dtype=torch.int32, device=device))
    for name, kw in LANE_CHECKS.items():
        cfg = make_cfg(n_small, TrackCollisions=True, **{**SWIM, **kw})
        prec = pk.build_packed_records(case.grid, fs,
                                       with_aks=bool(cfg.VTurbOn
                                                     and cfg.readAks))
        r, q = lanes_stepwise(torch, f"5-{name}", ctx, cfg, p0, prec, fs,
                              t0, steps=5)
        assert r["max_vertical_move_plain_m"] > 0.1, r
        if cfg.mortality:
            assert r["status_counts_plain"][st.DEAD] > 0, r
        if name == "dead_over_error":
            # particles stuck on land in the step they die end DEAD
            cfg1 = replace(cfg, dt=cfg.idt)
            alive = kx.ext_step_reference(ctx, replace(cfg1, mortality=False),
                                          p0, prec, t0, fields=fs, seed=5)
            dead = kx.ext_step_reference(ctx, cfg1, p0, prec, t0,
                                         fields=fs, seed=5)
            both = int(((alive.status == st.ERROR)
                        & (dead.status == st.DEAD)).sum())
            log({"phase": "5-dead_over_error", "stuck_and_dead": both})
            assert both > 0
        out[name] = r
    return out


# bench.py's settle and salt variants (bench.py:72-91), phase 6
SETTLE_SALT = {
    "settle": dict(Behavior=6, sink=5e-5, settlementon=True, holesExist=True,
                   pediage=0.0),
    "salt": dict(Behavior=4, readSalt=True, readTemp=True, SaltTempOn=True,
                 swimslow=1e-3, swimfast=3e-3, pediage=5e6, Sgradient=0.5),
}
# per-step checks of the settlement and salt lanes at 65,536 particles
LANE_CHECKS6 = {
    "behavior5": dict(Behavior=5, readSalt=True, Sgradient=0.5),
    "salt_only": dict(SaltTempOn=True, readSalt=True, readTemp=True),
    "behavior4_no_sampling": dict(Behavior=4, readSalt=True, Sgradient=0.5,
                                  mortality=True),
    # a random walk of ~270 m per step: inside the displacement guard
    "settle_dead_exit": dict(settlementon=True, holesExist=True,
                             HTurbOn=True, ConstantHTurb=300.0,
                             mortality=True),
}
HOLE_BOX = (124e3, 128e3, 124e3, 128e3)      # x0, x1, y0, y1 of the hole
# the oyster CLI run of phase 3 (pediage and the death age inside its 4 h)
OYSTER_CLI = dict(Behavior=4, readSalt=True, readTemp=True, SaltTempOn=True,
                  Sgradient=0.5, swimslow=1e-3, swimfast=3e-3,
                  pediage=7200.0, HTurbOn=True, ConstantHTurb=1.0,
                  VTurbOn=True, readAks=True, mortality=True,
                  deadage=12600.0, settlementon=True, holesExist=True,
                  seed=3)


def bench_polygons(rim=False):
    """bench.py's 12 x 12 km habitat square (id 101) with a 4 x 4 km hole,
    and a slanted hexagon 10 km across (id 102) in the rotation path;
    ``rim`` adds a rectangle (id 103) across the open east edge."""
    th = np.linspace(0.0, 2.0 * np.pi, 7)[:-1] + 0.3
    hexagon = np.stack([80e3 + 5e3 * np.cos(th), 120e3 + 5e3 * np.sin(th)],
                       -1)
    habitat = [(101, np.array([[120e3, 120e3], [132e3, 120e3],
                               [132e3, 132e3], [120e3, 132e3]])),
               (102, hexagon)]
    if rim:
        habitat.append((103, np.array([[185e3, 60e3], [210e3, 60e3],
                                       [210e3, 90e3], [185e3, 90e3]])))
    x0, x1, y0, y1 = HOLE_BOX
    holes = [(1, np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]]))]
    return habitat, holes


def with_polygons(ctx, rim=False):
    from dataclasses import replace
    from ltjax_torch.physics import settlement as stl
    habitat, holes = bench_polygons(rim)
    xe = ctx.bounds.x_edges.cpu().numpy()
    ye = ctx.bounds.y_edges.cpu().numpy()
    dev = ctx.grid.device
    return replace(ctx, polys=stl.build_polygons(habitat, xe, ye, device=dev),
                   holes=stl.build_polygons(holes, xe, ye, device=dev),
                   cache={})


def in_hole(x, y):
    x0, x1, y0, y1 = HOLE_BOX
    return (x > x0) & (x < x1) & (y > y0) & (y < y1)


# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM, and
# float32 / float64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
FP64_PER_S = 34e12


def fit_ops(K, P, lane=31):
    """f32 operations of fit_eval on K knots and P profiles (csrc
    find_currents.cuh, counted from its source: a lane ``lane`` (ext_step's
    gather-collapse-blend of three records 31, rk4_step's blend of one
    table 11), a knot 8, the small-tension coefficients 18, a Thomas row 4
    + 4P, the backward sweep to the interval ~K/2 x 2P, the evaluation 14
    + 9P)."""
    return (31 + lane * P + (K - 1) * (31 + (lane + 6) * P) + K * P + 14
            + 9 * P)


def rk4_ops(us, ws):
    """f32 operations of one particle in rk4_step.cu: 4 stages (the rho
    cell 10, the zeta and h lanes, the u/v and w fits, the log layer 12)
    and the RK4 combination."""
    stage = 10 + 2 * 11 + fit_ops(us, 2, 11) + fit_ops(ws, 1, 11) + 12
    return 4 * stage + 24


def rk4_bound(grid, n, stage1=False, pos64=False):
    """The least time the card could take for one launch of rk4_step on n
    particles: the three stage tables (and a curvilinear grid's map, or
    searched rho axes) read once, x, y, z read and dx, dy, dz (and u1,
    v1) written once, over the HBM rate, against every particle's
    operations (the kernel computes all of them, whatever their status)
    over the peak rate of their type: with float64 positions (``pos64``)
    the cell location, the knots, the log layer and the RK4 sums are
    f64."""
    from ltjax_torch import packed as pk
    us, ws = grid.us, grid.ws
    nv = pk.n_value_lanes(us, ws)
    item = 8 if pos64 else 4
    nbytes = 3 * grid.ny * grid.nx * nv * 4 + n * item * (6 + 2 * int(stage1))
    extra = 0
    if grid.curv is not None:
        nbytes += grid.ny * grid.nx * 2 * item + 2 * grid.curv.seed_i.numel() * 4
        extra = 4 * CURV_SOLVE_OPS
    elif not grid.uniform:
        nbytes += (grid.nx + grid.ny) * item
        extra = 4 * 2 * AXIS_SEARCH_OPS
    ops = n * (rk4_ops(us, ws) + extra)
    pos = n * (4 * (10 + 12 + 8 * (us + ws)) + 24 + extra) if pos64 else 0
    f32, f64 = ops - pos, pos
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32 / FP32_PER_S + f64 / FP64_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "f32_ops": f32, "f64_ops": f64}


# f32 operations of one inverse-map solve (csrc ext_step.cu curv_logical,
# counted from its source): the raster seed 16, each of the 3 Newton
# steps 65, the final clamp 4; the residual of the inside test 40 more
CURV_SOLVE_OPS = 16 + 3 * 65 + 4
CURV_RESID_OPS = 40


def curv_solves(cfg):
    """Inverse-map solves of one internal step in the LTX_CURV variant:
    4 RK4 stages, the vertical reflection's column, one per reflection
    pass, the stage-1 column of Visser and of a behavior, and the two
    inside tests (with residual)."""
    return (5 + int(cfg.reflect_iters) + int(cfg.VTurbOn and cfg.readAks)
            + int(cfg.Behavior != 0)), 2


# operations of one searched axis (csrc find_currents.cuh search_right,
# locate_axis): 8 halvings of 4 on a 200-point axis, the fraction 5
AXIS_SEARCH_OPS = 8 * 4 + 5


def axis_searches(cfg, ctx):
    """Axis searches of one internal step in the LTX_AXES variant: two a
    rho-cell location where the rho axes are not uniform (4 RK4 stages,
    the vertical reflection's column, Visser's and a behavior's stage-1
    column), two an edge location where the cell edges are not (each
    reflection pass, the two inside tests, settlement)."""
    g, b = ctx.grid, ctx.bounds
    n = 0
    if g.curv is None and not g.uniform:
        n += 2 * (5 + int(cfg.VTurbOn and cfg.readAks)
                  + int(cfg.Behavior != 0))
    if g.curv is None and not b.uniform:
        n += 2 * (int(cfg.reflect_iters) + 2 + int(cfg.settlementon))
    return n


def ops_per_step(cfg, us, ws, curv=False, pos64=False, searches=0,
                 rk4=True):
    """(f32, f64) operations of one active particle's internal step in
    the variant of cfg (integer Threefry words counted at the f32 rate);
    on a curvilinear grid plus its inverse-map solves, on searched axes
    plus the searches.  With float64 positions (``pos64``) the cell
    location, knots, log layer, RK4 sums, turbulence, behavior,
    reflection, the vertical bounds and the scalar fits (Visser, the 4/5
    cue, SaltTempOn) are f64, as csrc/ext_step.cu's LTX_POS64 build runs
    them; the blend and find_currents' fits stay f32.  Without ``rk4``
    the lanes alone (csrc/step_lanes.cu: no RK4 stages, the DEATH draw)."""
    stage = 10 + 2 * 31 + fit_ops(us, 2) + fit_ops(ws, 1) + 12
    ops = 4 * stage + 40 + 60 + 82 + 5          # RK4, reflect, vertical
    pos = 4 * (10 + 12 + 8 * (us + ws)) + 40 + 60 + 82 + 5
    threefry = 120
    if not rk4:
        ops -= 4 * stage + 40 - threefry - 4
        pos -= 4 * (10 + 12 + 8 * (us + ws)) + 40 - 2
    if cfg.HTurbOn:
        ops += threefry + 12
        pos += 12
    if cfg.VTurbOn:
        ops += threefry + 4
        pos += 4
        if cfg.readAks:
            v = 72 + fit_ops(ws, 1) + 2 * ws + 2 * (ws + 62 + 20)
            ops += v
            pos += v
    if cfg.Behavior:
        ops += 80
        pos += 80
        if cfg.Behavior in (1, 2, 3, 4, 5):
            ops += 2 * threefry + 10
            pos += 10
        if cfg.Behavior in (4, 5):
            ops += fit_ops(us, 1)
            pos += fit_ops(us, 1)
    if cfg.SaltTempOn:
        ops += fit_ops(us, 2)
        pos += fit_ops(us, 2)
    if curv:
        plain, resid = curv_solves(cfg)
        plain -= 0 if rk4 else 4
        c = (plain + resid) * CURV_SOLVE_OPS + resid * CURV_RESID_OPS
        ops += c
        pos += c
    ops += searches * AXIS_SEARCH_OPS
    pos += searches * AXIS_SEARCH_OPS
    return (ops - pos, pos) if pos64 else (ops, 0)


def kernel_bound(cfg, ctx, prec, p_in, p_out, lanes=False):
    """The least time the card could take for one external step of the
    kernel on these inputs: the larger of the bytes it must move (each
    input read once, each output written once) over the HBM rate, and
    its operations over the peak rate of their type.  The work of a
    particle-step is counted only while the particle is active (mean of
    the active counts before and after, as the kernel skips the rest);
    settlement adds the f64 ray cast of each candidate edge of the
    particle's cell, counted at these particles' positions.  ``lanes``:
    one launch of the lanes kernel K3 instead (one internal step, no RK4
    stages, the DEATH draw; K2's dx, dy, dz and for behavior 7 u1, v1
    read)."""
    import torch
    from ltjax_torch import state as st
    from ltjax_torch.kernels import ext_step as kx
    n, n_int = p_in.n, 1 if lanes else cfg.internal_steps
    act = 0.5 * (int((p_in.status == st.ACTIVE).sum())
                 + int((p_out.status == st.ACTIVE).sum())) * n_int
    pdt = p_in.x.dtype
    pos64 = pdt == torch.float64
    item = 8 if pos64 else 4
    # float columns x y z dob age (+ salt temp) in the positions' dtype,
    # int32 status pid (+ settle_poly); out: the same, hit counts int32
    fcols = 5 + (2 if cfg.SaltTempOn else 0)
    icols = 2 + (1 if cfg.settlementon else 0)
    brows = kx.boundary_rows_table(ctx, pdt)
    curv = ctx.grid.curv is not None
    if lanes:
        # what one internal step's lanes need of the tables: the corner
        # rows of the particles' cells (zeta, h and the Aks or salt/temp
        # lanes the variant reads, three records), the boundary rows and
        # curvilinear map rows of those cells; K2's outputs read
        from ltjax_torch.grid import locate_rho_ij
        g = ctx.grid
        i, j, _, _ = locate_rho_ij(g, p_in.x, p_in.y)
        cells = torch.unique(j.long() * g.nx + i.long())
        rows = torch.unique(torch.cat([cells, cells + 1, cells + g.nx,
                                       cells + g.nx + 1]))
        read = 2 + (g.ws if cfg.VTurbOn and cfg.readAks else 0) + (
            2 * g.us if cfg.SaltTempOn
            else g.us if cfg.Behavior in (4, 5) else 0)
        nbytes = (rows.numel() * (read * 3 * 4 + (2 * item if curv else 0))
                  + cells.numel() * brows.shape[1] * item
                  + 2 * n * (item * fcols + 4 * icols)
                  + n * item * (5 if cfg.Behavior == 7 else 3))
    else:
        nbytes = (prec.tab.numel() * 4 + brows.numel() * item
                  + 2 * n * (item * fcols + 4 * icols))
    if curv:
        xy, seeds, _, _ = kx.curv_tables(ctx, pdt)
        nbytes += (0 if lanes else xy.numel() * item) + seeds.numel() * 4
    searches = axis_searches(cfg, ctx)
    if lanes and ctx.grid.curv is None and not ctx.grid.uniform:
        searches -= 2 * 4                       # the RK4 stages' cells
    if searches:
        nbytes += sum(t.numel() * t.element_size()
                      for pair in kx.axes_tables(ctx, pdt) if pair
                      for t in pair)
    o32, o64 = ops_per_step(cfg, ctx.grid.us, ctx.grid.ws, curv, pos64,
                            searches, rk4=not lanes)
    f32, f64 = act * o32, act * o64
    if cfg.settlementon and ctx.polys is not None:
        tabs = kx.settle_tables(ctx)
        nbytes += tabs[0].numel() * 8 + tabs[1].numel() * 4
        edges = 0.0
        for ps in (ctx.polys, ctx.holes):
            if ps is None:
                continue
            x0, dx, y0, dy, _, _ = ctx.bounds.edges
            ny, nx = ctx.bounds.water.shape
            i = torch.floor((p_in.x.double() - x0) / dx).clamp(0, nx - 1)
            j = torch.floor((p_in.y.double() - y0) / dy).clamp(0, ny - 1)
            c = ps.cell_cands[j.long(), i.long()].long()
            nv = torch.where(c >= 0, ps.nverts.long()[c.clamp(min=0)], 0)
            edges += float(nv.sum(dim=1).double().mean())
        f64 += act * (8 + 9 * edges)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32 / FP32_PER_S + f64 / FP64_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "f32_ops": f32, "f64_ops": f64}


def phase6(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16,
           n_small=65536):
    """bench.py's settle and salt variants at 1M particles through
    make_fused_external_steps (16 x 30 steps, timed, launches counted),
    the kernel against its plain version per internal step and timed per
    external step; then the settlement and salt lanes per step at 65,536
    particles."""
    from dataclasses import replace
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import build, ext_step as kx
    from ltjax_torch.physics import behavior as bh
    from ltjax_torch.step import (_sort, fieldset_slice,
                                  make_fused_external_steps, summary_counts)
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False,
                      halocline=True)
    ctx = with_polygons(context(case))
    dt = 3600.0
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_fuse + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    out = {}
    for name, kw in SETTLE_SALT.items():
        cfg = make_cfg(n, us=us, ws=us + 1, **kw)
        z0 = np.random.default_rng(1).uniform(
            -25.0 if name == "settle" else -40.0, -5.0, n)
        p0 = st.init_particles(x0, y0, z0, dtype=torch.float32,
                               device=device)
        p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
        fused = make_fused_external_steps(ctx, cfg, n_fuse)
        fused(p0.take(torch.arange(128, device=device)), fsR, 0.0, 0)
        torch.cuda.synchronize()
        kx.reset_launches()
        t0 = time.perf_counter()
        p = fused(p0, fsR, 0.0, 0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = dict(kx.ext_step_fused.variant_launches)
        staging = kx.counts()
        tag = build.tag("ext_step", kx.kernel_variant(cfg))
        counts = summary_counts(p)
        res = {"phase": f"6-{name}", "n": n, "ext_steps": n_fuse,
               "internal_steps": cfg.internal_steps, "variant": tag,
               "launches": launches, "staging": staging,
               "staged_share": staged_share(staging), "seconds": sec,
               "particle_steps_per_s": n * cfg.internal_steps * n_fuse / sec,
               "max_vertical_move_m": float((p.z - p0.z).abs().max()),
               "counts": counts}
        assert launches == {tag: n_fuse}, res
        assert all(bool(torch.isfinite(getattr(p, k)).all())
                   for k in ("x", "y", "z", "salt", "temp")), res
        assert counts["error"] == 0, res
        if cfg.settlementon:
            settled = p.status == st.SETTLED
            ids, k = torch.unique(p.settle_poly[settled], return_counts=True)
            res["settled_by_poly"] = dict(zip(map(str, ids.tolist()),
                                              k.tolist()))
            res["settled_in_hole"] = int((settled & in_hole(p.x, p.y)).sum())
            assert set(res["settled_by_poly"]) == {"101", "102"}, res
            assert res["settled_in_hole"] == 0, res
            assert int((p.settle_poly[~settled] >= 0).sum()) == 0, res
        if cfg.SaltTempOn:
            # the Behavior-4 cue at the release positions: fires for some
            dsdz, _ = bh._salt_gradient(
                case.grid, fieldset_slice(fsR, 0), p0.x, p0.y, p0.z,
                torch.tensor(0.0, dtype=torch.float32), cfg.tension_sigma)
            res["cue_fraction"] = float((dsdz.abs() >= cfg.Sgradient
                                         ).double().mean())
            res["salt_range"] = [float(p.salt.min()), float(p.salt.max())]
            res["temp_range"] = [float(p.temp.min()), float(p.temp.max())]
            assert 0.01 < res["cue_fraction"] < 0.99, res
            # 20-33 psu in the halocline, 8-20 degC
            assert 19.0 < res["salt_range"][0] < res["salt_range"][1] < 34.0, \
                res
            assert 8.0 < res["temp_range"][0] < res["temp_range"][1] < 20.0, \
                res
        log(res)

        # the kernel against its plain version, timed per external step
        prec_all = pk.build_packed_records(
            case.grid, fsR, with_scalars=cfg.needs_salt_fields())
        ps, _ = _sort(case.grid, p0)
        small, _ = _sort(case.grid, p0.take(torch.arange(n_small,
                                                         device=device)))
        prec3 = pk.PackedRecords(tab=prec_all.tab[:3],
                                 times=prec_all.times[:3])
        f3 = fieldset_slice(fsR, 0)
        for size, q in (("1M", ps), (str(n_small), small)):
            res["kernel_ms_" + size] = cuda_time(
                torch, lambda: kx.ext_step_fused(ctx, cfg, q, prec3, 0.0,
                                                 fields=f3), 3)
            res["plain_ms_" + size] = cuda_time(
                torch, lambda: kx.ext_step_reference(ctx, cfg, q, prec3,
                                                     0.0, fields=f3), 1)
        res["bound"] = kernel_bound(cfg, ctx, prec3, ps, kx.ext_step_fused(
            ctx, cfg, ps, prec3, 0.0, fields=f3))
        rs, _ = lanes_stepwise(torch, f"6-{name}", ctx, cfg, ps, prec3, f3,
                               0.0, steps=10)
        res["stepwise"] = {k: v for k, v in rs.items() if k.startswith("max")
                           or k.endswith("mismatch") or k == "decision_flips"}
        log({k: res[k] for k in res if k.startswith(("phase", "kernel_ms",
                                                        "plain_ms", "bound"))})
        out[name] = res

    # every settlement and salt lane, step by step, from the plain
    # trajectory's state: land block, open rim, slow rotation with a random
    # w and zeta, the heaving halocline, particles near the surface and
    # the bottom, ages across the swim ramp, pediage and the death age
    case = bench_case(torch, device, omega=5e-6, halocline=True)
    ctx = with_polygons(context(case), rim=True)
    t0 = 9 * 3600.0
    fs = synth.with_vertical_motion(synth.fieldset_for(
        case, t_center=t0 + 1800.0, dt=3600.0, device=device), seed=3)
    x, y, _ = water_particles(case, n_small, 2e3, 198e3, seed=1)
    # a tenth inside the rim polygon, within 1 km of the open east edge
    k = n_small // 10
    x[-k:] = rng.uniform(199.5e3, 200.4e3, k)
    y[-k:] = rng.uniform(60e3, 90e3, k)
    z = near_surface_and_bottom(n_small, case.h0, seed=4)
    age = rng.uniform(0.0, 3 * 86400.0, n_small)
    p0 = st.init_particles(x, y, z, dob=-age, dtype=torch.float32,
                           device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE),
                    age=torch.tensor(age, dtype=torch.float32,
                                     device=device),
                    pid=torch.tensor(rng.permutation(n_small),
                                     dtype=torch.int32, device=device))
    for name, kw in LANE_CHECKS6.items():
        cfg = make_cfg(n_small, TrackCollisions=True, **{**SWIM, **kw})
        prec = pk.build_packed_records(case.grid, fs, with_scalars=True)
        r, q = lanes_stepwise(torch, f"6-{name}", ctx, cfg, p0, prec, fs,
                              t0, steps=5)
        counts = np.bincount(q.status.cpu().numpy(), minlength=6)
        if cfg.SaltTempOn:
            assert float(q.salt.max() - q.salt.min()) > 1.0, r
        else:
            # sampling off: salt and temp stay as they came in (0)
            assert bool((q.salt == 0).all() and (q.temp == 0).all()), r
        if cfg.Behavior in (4, 5):
            assert r["max_vertical_move_plain_m"] > 0.1, r
        if name == "settle_dead_exit":
            assert counts[st.SETTLED] > 0 and counts[st.DEAD] > 0, r
            assert counts[st.OUT_OF_DOMAIN] > 0, r
            # particles in a habitat that die in the step they would
            # settle end DEAD; those that exit never settle
            cfg1 = replace(cfg, dt=cfg.idt)
            alive = kx.ext_step_reference(ctx, replace(cfg1, mortality=False),
                                          p0, prec, t0, fields=fs, seed=5)
            dead = kx.ext_step_reference(ctx, cfg1, p0, prec, t0,
                                         fields=fs, seed=5)
            both = int(((alive.status == st.SETTLED)
                        & (dead.status == st.DEAD)).sum())
            rim_exit = int(((p0.x > 185e3) & (p0.y > 60e3) & (p0.y < 90e3)
                            & (dead.status == st.OUT_OF_DOMAIN)).sum())
            log({"phase": "6-settle_dead_exit", "settle_or_dead": both,
                 "exits_from_rim_polygon": rim_exit,
                 "status_counts": counts.tolist()})
            assert both > 0 and rim_exit > 0
        out[name] = r
    return out


def oyster_cli_runs(torch, name, opts, n=10_000, nx=60, us=10):
    """The oyster CLI run (options ``opts``) on a 60 km halocline case
    with a habitat square with a hole and a slanted triangle (polygon
    CSVs), 10,000 particles, 4 external steps, in chunks of 2 and of 4:
    the final CSV rows of each, by particle, and the log lines of each."""
    from ltjax_torch import run, synth
    case = synth.make_solid_body_case(nx=nx, ny=nx, us=us, lx=60e3, ly=60e3,
                                      h0=50.0, omega=5e-5,
                                      dtype=torch.float64, parabolic_aks=True,
                                      halocline=True)
    rng = np.random.default_rng(7)
    x0 = rng.uniform(15e3, 45e3, n)
    y0 = rng.uniform(15e3, 45e3, n)
    z0 = rng.uniform(-16.0, -4.0, n)
    habitat = [(21, np.array([[22e3, 22e3], [34e3, 22e3], [34e3, 34e3],
                              [22e3, 34e3]])),
               (22, np.array([[36e3, 24e3], [44e3, 28e3], [38e3, 36e3]]))]
    holes = [(1, np.array([[26e3, 26e3], [30e3, 26e3], [30e3, 30e3],
                           [26e3, 30e3]]))]
    finals, lines = {}, {}
    for fuse in (2, 4):
        work = os.path.join(ROOT, "build", f"chip_smoke_{name}{fuse}")
        nml = synth.write_run_files(
            case, work, x0, y0, z0, n_ext=4, dt=3600, idt=120,
            iprint=4 * 3600, ext_fuse=fuse, dtype_pos="float32",
            habitat=habitat, holes=holes, **opts)
        lines[fuse] = run_cli(run, nml)
        rows = np.loadtxt(os.path.join(work, "out", "run1.csv"),
                          delimiter=",")
        last = rows[rows[:, 0] == rows[:, 0].max()]
        finals[fuse] = last[np.argsort(last[:, 1])]
    return finals, lines


def phase3_oyster(torch, device):
    """The oyster CLI run: behavior 4 on the halocline, SaltTempOn,
    settlement on a habitat square with a hole and a slanted triangle,
    HTurb, Visser on the written AKs, mortality, pediage inside the run;
    chunks of 2 and of 4 external steps must give the same particles."""
    finals, lines = oyster_cli_runs(torch, "oyster", OYSTER_CLI)
    f = finals[4]       # time id lon lat depth status salt temp age poly
    status, poly = f[:, 5], f[:, 9]
    res = {"phase": "3-oyster", "n": f.shape[0],
           "chunks_identical": bool(np.array_equal(finals[2], finals[4])),
           "lanes": lines[4][0]["lanes"], "path": lines[4][0]["path"],
           "counts": lines[4][-1],
           "settled_by_poly": {str(int(k)): int((poly[status == 2] == k).sum())
                               for k in np.unique(poly[status == 2])},
           "salt_range": [float(f[:, 6].min()), float(f[:, 6].max())]}
    log(res)
    assert res["chunks_identical"] and np.isfinite(f).all(), res
    assert res["path"] == ("cuda_ext_step" if device.type == "cuda"
                           else "plain"), res
    assert res["lanes"] == ["advection", "hturb", "vturb_aks", "behavior4",
                            "mortality", "settlement", "salt_temp"], res
    assert set(res["settled_by_poly"]) == {"21", "22"}, res
    assert res["counts"]["dead"] > 0, res
    assert res["salt_range"][1] - res["salt_range"][0] > 1.0, res

# per-step checks of the curvilinear variants at 65,536 particles, on the
# curvilinear halocline with random w and zeta (phase 7c)
CURV_LANES = {
    "turb": dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                 readAks=True),
    "oyster": dict(Behavior=4, readSalt=True, readTemp=True, SaltTempOn=True,
                   Sgradient=0.5, settlementon=True, holesExist=True,
                   HTurbOn=True, ConstantHTurb=300.0, mortality=True),
}
# the error of the curvilinear paths against the analytic circles: the
# u/v nodes sit O(h^2 curvature) off the rho mesh, metres over hours;
# the main path's 1 km cells (16 h) and the CLI's 60 km square with the
# same distortion (4 h), within tests/test_curv.py's 20 m budget for 4 h
# on 2.5 km cells
TOL_ANALYTIC_CURV = 5.0
TOL_ANALYTIC_CURV_CLI = 20.0


def phase7(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16,
           n_small=65536, reps=5):
    """Curvilinear grids (LTX_CURV): (a) the kernel against its plain
    version on bench.py's curv geometry with the land block, one
    external step of 65,536 particles, timed; (b) bench.py's curv cell at
    1M through make_fused_external_steps, 16 x 30 steps, timed, against
    the circles, then the kernel against its plain version on its first
    launch; (c) per internal step from the plain state at 65,536: HTurb +
    Visser, and the oyster lanes on the halocline; (d) the CLI on a
    geographic curvilinear series."""
    from ltjax_torch import packed as pk, run, state as st, synth
    from ltjax_torch.kernels import build, ext_step as kx
    from ltjax_torch.step import (_sort, make_fused_external_steps,
                                  summary_counts)
    out = {}

    # (a) kernel vs plain, land block and open rim
    case = curv_bench_case(torch, device, nx=nx, ny=nx, us=us)
    ctx = context(case)
    cfg = make_cfg(n_small, us=us, ws=us + 1, TrackCollisions=True)
    fs = synth.fieldset_for(case, t_center=0.0, dt=3600.0, device=device)
    x, y, _ = curv_water_particles(case, n_small, seed=1)
    z = near_surface_and_bottom(n_small, case.h0, seed=4)
    p = st.init_particles(x, y, z, dtype=torch.float32, device=device)
    p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
    p, _ = _sort(case.grid, p)
    ra = kernel_vs_plain(torch, "7a", ctx, cfg, p,
                         pk.build_packed_records(case.grid, fs), reps, 2)
    assert ra["hit_land_plain"] > 0, ra
    assert ra["status_counts_plain"][st.OUT_OF_DOMAIN] > 0, ra
    out["a"] = ra

    # (b) bench.py's curv cell at 1M
    case = curv_bench_case(torch, device, nx=nx, ny=nx, us=us, land=False)
    ctx = context(case)
    cfg = make_cfg(n, us=us, ws=us + 1)
    dt = float(cfg.dt)
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_fuse + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    p0 = st.init_particles(x0, y0, z0, dtype=torch.float32, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    fused = make_fused_external_steps(ctx, cfg, n_fuse)
    fused(p0.take(torch.arange(128, device=device)), fsR, 0.0, 0)
    torch.cuda.synchronize()
    kx.reset_launches()
    t0 = time.perf_counter()
    pb = fused(p0, fsR, 0.0, 0)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(kx.ext_step_fused.variant_launches)
    staging = kx.counts()
    tag = build.tag("ext_step", kx.kernel_variant(cfg, curv=True))
    counts = summary_counts(pb)
    xa, ya, _ = case.analytic(x0, y0, z0, n_fuse * dt)
    err = np.hypot(pb.x.cpu().numpy() - xa, pb.y.cpu().numpy() - ya)
    rb = {"phase": "7b", "n": n, "ext_steps": n_fuse,
          "internal_steps": cfg.internal_steps, "variant": tag,
          "launches": launches, "staging": staging,
          "staged_share": staged_share(staging), "seconds": sec,
          "particle_steps_per_s": n * cfg.internal_steps * n_fuse / sec,
          "max_err_vs_analytic_m": float(err.max()),
          "mean_err_vs_analytic_m": float(err.mean()), "counts": counts}
    log(rb)
    assert launches == {tag: n_fuse}, rb
    assert counts["error"] == 0 and counts["active"] == n, rb
    assert np.isfinite(err).all() and err.max() < TOL_ANALYTIC_CURV, rb
    prec_all = pk.build_packed_records(case.grid, fsR)
    ps, _ = _sort(case.grid, p0)
    prec3 = pk.PackedRecords(tab=prec_all.tab[:3], times=prec_all.times[:3])
    rb["kernel"] = kernel_vs_plain(torch, "7b", ctx, cfg, ps, prec3, 3, 1)
    rb["bound"] = kernel_bound(cfg, ctx, prec3, ps,
                               kx.ext_step_fused(ctx, cfg, ps, prec3, 0.0))
    small, _ = _sort(case.grid, p0.take(torch.arange(n_small,
                                                     device=device)))
    rb["kernel_ms_" + str(n_small)] = cuda_time(
        torch, lambda: kx.ext_step_fused(ctx, cfg, small, prec3, 0.0), reps)
    rb["plain_ms_" + str(n_small)] = cuda_time(
        torch, lambda: kx.ext_step_reference(ctx, cfg, small, prec3, 0.0), 1)
    log({k: rb[k] for k in rb if k.startswith(("phase", "kernel_ms",
                                               "plain_ms", "bound"))})
    out["b"] = rb

    # (c) per internal step: turbulence and the oyster lanes
    case = curv_bench_case(torch, device, nx=nx, ny=nx, us=us, omega=5e-6,
                           parabolic_aks=True, halocline=True)
    ctx = with_polygons(context(case))
    t0 = 9 * 3600.0
    fs = synth.with_vertical_motion(synth.fieldset_for(
        case, t_center=t0 + 1800.0, dt=3600.0, device=device), seed=3)
    x, y, _ = curv_water_particles(case, n_small, seed=1)
    z = near_surface_and_bottom(n_small, case.h0, seed=4)
    age = rng.uniform(0.0, 3 * 86400.0, n_small)
    pc = st.init_particles(x, y, z, dob=-age, dtype=torch.float32,
                           device=device)
    pc = pc.replace(status=torch.full_like(pc.status, st.ACTIVE),
                    age=torch.tensor(age, dtype=torch.float32,
                                     device=device),
                    pid=torch.tensor(rng.permutation(n_small),
                                     dtype=torch.int32, device=device))
    pc, _ = _sort(case.grid, pc)
    for name, kw in CURV_LANES.items():
        cfgc = make_cfg(n_small, TrackCollisions=True, **{**SWIM, **kw})
        prec = pk.build_packed_records(case.grid, fs, with_aks=True,
                                       with_scalars=True)
        r, q = lanes_stepwise(torch, f"7c-{name}", ctx, cfgc, pc, prec, fs,
                              t0, steps=5)
        assert r["max_vertical_move_plain_m"] > 0.1, r
        counts = np.bincount(q.status.cpu().numpy(), minlength=6)
        if cfgc.settlementon:
            settled = q.status == st.SETTLED
            assert set(q.settle_poly[settled].tolist()) == {101, 102}, r
            assert int((settled & in_hole(q.x, q.y)).sum()) == 0, r
            assert float(q.salt.max() - q.salt.min()) > 1.0, r
            assert counts[st.DEAD] > 0, r
        out["c-" + name] = r

    # (d) the CLI on a geographic curvilinear series, on the card
    out["d"] = phase7_cli(torch, device)
    return out


def phase7_cli(torch, device, n=10_000, nx=60, us=10, n_ext=4):
    """ltjax_torch.run.main on a written geographic curvilinear ROMS
    series (phase 3's size), CSV output, against the circles."""
    from ltjax_torch import convert, run, synth
    from ltjax_torch.kernels import build, ext_step as kx
    work = os.path.join(ROOT, "build", "chip_smoke_curv")
    case = synth.make_curv_case(nx=nx, ny=nx, us=us, lx=60e3, ly=60e3,
                                h0=50.0, omega=5e-5, amp=0.03,
                                dtype=torch.float64)
    rng = np.random.default_rng(8)
    x0 = rng.uniform(15e3, 45e3, n)
    y0 = rng.uniform(15e3, 45e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    nml = synth.write_run_files(case, work, x0, y0, z0, n_ext=n_ext,
                                dt=3600, idt=120, iprint=3600 * n_ext,
                                ext_fuse=n_ext, dtype_pos="float32",
                                geographic=True, lonmin=-76.0, latmin=37.0)
    kx.reset_launches()
    lines = run_cli(run, nml)
    launches = dict(kx.ext_step_fused.variant_launches)
    rows = np.loadtxt(os.path.join(work, "out", "run1.csv"), delimiter=",")
    last = rows[rows[:, 0] == rows[:, 0].max()]
    last = last[np.argsort(last[:, 1])]
    x = convert.lon2x(last[:, 2], last[:, 3], -76.0, 37.0)
    y = convert.lat2y(last[:, 3], 37.0)
    xa, ya, _ = case.analytic(x0, y0, z0, n_ext * 3600.0)
    err = np.hypot(x - xa, y - ya)
    tag = build.tag("ext_step", kx.kernel_variant(
        run.config_from_namelist(nml), curv=True))
    res = {"phase": "7d", "n": n, "path": lines[0]["path"],
           "curvilinear": lines[0]["curvilinear"], "launches": launches,
           "max_err_vs_analytic_m": float(err.max()),
           "counts": lines[-1]}
    log(res)
    assert res["path"] == "cuda_ext_step" and res["curvilinear"] is True, res
    assert launches == {tag: n_ext}, res
    assert last.shape[0] == n and np.all(last[:, 5] == 1), res
    assert err.max() < TOL_ANALYTIC_CURV_CLI, res
    return res



# bench.py's behavior cell (bench.py:53-68: type-6 sinking at 5e-5 m/s,
# mortality) with stochastic mortality at a 2-day death age, phase 8
STOCHASTIC = dict(Behavior=6, sink=5e-5, mortality=True,
                  stochastic_mortality=True, deadage=172800.0)
# phase 3's oyster CLI run with stochastic mortality (phase 8c)
OYSTER_STOCHASTIC = dict(OYSTER_CLI, stochastic_mortality=True)


def rk4_vs_plain(torch, phase, grid, tabs, p, cfg, reps=5, plain_reps=2):
    """The per-step RK4 kernel against its plain version on the same stage
    tables and positions: max |dx|, |dy|, |dz| (TOL_H_STEP, TOL_V) and of
    the stage-1 currents (TOL_H_STEP / idt), and the time of each per
    launch (CUDA events)."""
    from ltjax_torch import packed as pk
    from ltjax_torch.kernels import rk4_step as kr
    sig, z0m, idt = cfg.tension_sigma, cfg.z0, float(cfg.idt)

    def kernel():
        return kr.rk4_displacement_fused(grid, tabs, p.x, p.y, p.z, sig, z0m,
                                         idt, stage1=True)

    def plain():
        return pk.rk4_displacement_collapsed(grid, tabs, p.x, p.y, p.z, sig,
                                             z0m, idt)

    out = kernel()
    ref = plain() + pk.find_currents_collapsed(grid, tabs[0], p.x, p.y, p.z,
                                               sig, z0m)[:2]
    res = {"phase": phase, "n": p.n}
    for k, a, b in zip(("dx", "dy", "dz", "u1", "v1"), out, ref):
        res["max_abs_" + k] = float((a - b).abs().max())
        assert bool(torch.isfinite(a).all()), (phase, k)
    res["max_abs_move_m"] = float(torch.hypot(ref[0], ref[1]).max())
    res["max_abs_dz_move_m"] = float(ref[2].abs().max())
    if p.x.device.type == "cuda":
        res["kernel_ms"] = cuda_time(torch, kernel, reps)
        res["plain_ms"] = cuda_time(torch, plain, plain_reps)
    log(res)
    assert max(res["max_abs_dx"], res["max_abs_dy"]) <= TOL_H_STEP, res
    assert res["max_abs_dz"] <= TOL_V, res
    assert max(res["max_abs_u1"], res["max_abs_v1"]) <= TOL_H_STEP / idt, res
    return res


def lanes_vs_plain(torch, phase, ctx, cfg, p, prec, fields, t, reps=5,
                   plain_reps=2):
    """The lanes kernel K3 against its plain version on one internal step
    of the per-step route from p at t (step index 0): K2's displacement
    (and stage-1 currents) of p on the step's stage tables, then both on
    those same inputs.  Equal statuses and DEATH decisions; the particles
    whose behavior or settlement decision flipped on round-off (a swim
    step or more apart with equal status; lanes_stepwise) at most 0.01%,
    the others within TOL_H_STEP, TOL_V, age 1e-3 s and TOL_SALT; per
    launch K3's device time (``kernel_ms``: the profiler's time of its
    kernel, mean of ``reps``), the wrapper call's (``call_ms``: CUDA
    events around the calls, the host's preparation of each launch
    included where it is the slower), the plain version's (CUDA events),
    and K3's bound."""
    from ltjax_torch import packed as pk, state as st
    from ltjax_torch.kernels import rk4_step as kr, step_lanes as sl
    g, idt = ctx.grid, float(cfg.idt)
    tabs = pk.stage_value_tables(g, prec, t, idt)
    disp = kr.rk4_displacement_fused(g, tabs, p.x, p.y, p.z,
                                     cfg.tension_sigma, cfg.z0, idt,
                                     stage1=cfg.Behavior == 7)

    def kernel():
        return sl.step_lanes_fused(ctx, cfg, cfg.seed, 0, p, fields, prec,
                                   tabs, t, disp)

    def plain():
        return sl.step_lanes_reference(ctx, cfg, cfg.seed, 0, p, fields,
                                       tabs, t, disp)

    out, ref = kernel(), plain()
    sync(torch, p.x.device)
    flip = ((((out.x - ref.x).abs() > TOL_H_STEP)
             | ((out.y - ref.y).abs() > TOL_H_STEP)
             | ((out.z - ref.z).abs() > TOL_V))
            & (out.status == ref.status))
    keep = torch.nonzero(~flip)[:, 0]
    res = {"phase": phase, "n": p.n,
           **compare(phase, p.take(keep), out.take(keep), ref.take(keep)),
           "max_abs_dage": float((out.age - ref.age)[keep].abs().max()),
           "decision_flips": int(flip.sum()),
           "death_decisions_equal": bool(torch.equal(
               out.status == st.DEAD, ref.status == st.DEAD)),
           "dead_plain": int(((ref.status == st.DEAD)
                              & (p.status != st.DEAD)).sum()),
           "status_mismatch_all": int((out.status != ref.status).sum())}
    thresholds = cfg.Behavior in (1, 2, 3, 4, 5, 7) or cfg.settlementon
    if p.x.device.type == "cuda":
        res["kernel_ms"] = profiled_ms(torch, kernel, reps,
                                       "step_lanes_kernel")
        res["call_ms"] = cuda_time(torch, kernel, reps)
        res["plain_ms"] = cuda_time(torch, plain, plain_reps)
    res["bound"] = kernel_bound(cfg, ctx, prec, p, ref, lanes=True)
    log(res)
    check(res, p.n, TOL_H_STEP, strict_status=True)
    assert res["status_mismatch_all"] == 0 and res["death_decisions_equal"]
    assert res["max_abs_dage"] <= 1e-3, res
    assert res["decision_flips"] <= (MAX_MISMATCH * p.n if thresholds
                                     else 0), res
    return res


# phase 8a's lanes: bench.py's behavior cell with stochastic mortality
# (the main path's), and the lanes that decide on thresholds, on phase
# 1's particles with ages across the swim ramp
LANES8 = {"behavior": {},
          "oyster": {**OYSTER_CLI, **SWIM, "deadage": 3600.0},
          "behavior7": dict(SWIM, Behavior=7, deadage=3600.0),
          "dvm": dict(SWIM, Behavior=3, deadage=3600.0)}


def phase8(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16,
           n_small=65536):
    """Stochastic mortality through the per-step route (the per-internal-
    step RK4 kernel K2 and the lanes kernel K3): (a) K2 against its plain
    version at 65,536 particles on phase 1's inputs and on its random-w
    case, K3 against its plain version on LANES8; (b) bench.py's behavior
    cell with stochastic mortality at 1M, 16 x 30 steps through
    make_fused_external_steps (launches counted, timed, dead share,
    circles), per internal step against the plain route, K2 and K3 timed,
    the internal step split by the profiler; (c) the oyster CLI run with
    stochastic mortality, and its lanes per step at 65,536."""
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import ext_step as kx, rk4_step as kr
    from ltjax_torch.kernels import step_lanes as sl
    from ltjax_torch.step import (_sort, fieldset_slice,
                                  make_fused_external_steps, summary_counts)
    out = {}

    # (a) K2 against its plain version, phase 1's inputs
    case = bench_case(torch, device, nx=nx, ny=nx, us=us)
    cfg = make_cfg(n_small, us=us, ws=us + 1)
    idt = float(cfg.idt)
    x, y, _ = water_particles(case, n_small, 2e3, 198e3, seed=1)
    z = near_surface_and_bottom(n_small, case.h0, seed=4)
    pa = st.init_particles(x, y, z, dtype=torch.float32, device=device)
    pa, _ = _sort(case.grid, pa)
    prec = pk.build_packed_records(case.grid, synth.fieldset_for(
        case, t_center=0.0, dt=3600.0, device=device))
    out["a"] = rk4_vs_plain(torch, "8a", case.grid, pk.stage_value_tables(
        case.grid, prec, 0.0, idt), pa, cfg)
    slow = bench_case(torch, device, nx=nx, ny=nx, us=us, omega=5e-6)
    prec_v = pk.build_packed_records(case.grid, synth.with_vertical_motion(
        synth.fieldset_for(slow, t_center=0.0, dt=3600.0, device=device),
        seed=3))
    out["a-vertical"] = rk4_vs_plain(
        torch, "8a-vertical", case.grid,
        pk.stage_value_tables(case.grid, prec_v, 600.0, idt), pa, cfg)
    assert out["a-vertical"]["max_abs_dz_move_m"] > 0.1, out["a-vertical"]
    # the stretched ladder, in the slow flow with random w (the fast one
    # carries round-off of z in the bottom log layer into metres of x)
    stretched = bench_case(torch, device, nx=nx, ny=nx, us=us, omega=5e-6,
                           stretched=True)
    assert ladder_depends_on_cs_and_hc(stretched.grid)
    out["a-stretched"] = rk4_vs_plain(
        torch, "8a-stretched", stretched.grid, pk.stage_value_tables(
            stretched.grid, pk.build_packed_records(
                stretched.grid, synth.with_vertical_motion(synth.fieldset_for(
                    stretched, t_center=0.0, dt=3600.0, device=device),
                    seed=3)), 600.0, idt), pa, cfg, reps=1, plain_reps=1)
    # K3 on phase 1's particles (land block, open rim, near the surface and
    # in the log layer) on the halocline with Aks, random w and zeta, ages
    # across the swim ramp and the death age, at 9 h (daylight)
    hal = bench_case(torch, device, nx=nx, ny=nx, us=us, halocline=True,
                     parabolic_aks=True)
    ctx8 = with_polygons(context(hal), rim=True)
    t9 = 9 * 3600.0
    fs9 = synth.with_vertical_motion(synth.fieldset_for(
        hal, t_center=t9 + 1800.0, dt=3600.0, device=device), seed=3)
    rng8 = np.random.default_rng(5)
    age = rng8.uniform(0.0, 3 * 86400.0, n_small)
    pl = pa.replace(age=torch.tensor(age, dtype=torch.float32,
                                     device=device),
                    dob=torch.tensor(-age, dtype=torch.float32,
                                     device=device),
                    pid=torch.tensor(rng8.permutation(n_small),
                                     dtype=torch.int32, device=device))
    for name, kw in LANES8.items():
        cfg8 = make_cfg(n_small, us=us, ws=us + 1, TrackCollisions=True,
                        **{**STOCHASTIC, **kw})
        prec8 = pk.build_packed_records(
            hal.grid, fs9, with_aks=cfg8.VTurbOn and cfg8.readAks,
            with_scalars=cfg8.needs_salt_fields())
        out["a-lanes-" + name] = lanes_vs_plain(
            torch, "8a-lanes-" + name, ctx8 if cfg8.settlementon
            else context(hal), cfg8, pl, prec8, fs9, t9)
        assert out["a-lanes-" + name]["dead_plain"] > 0

    # (b) bench.py's behavior cell with stochastic mortality at 1M
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False)
    ctx = context(case)
    cfg = make_cfg(n, us=us, ws=us + 1, **STOCHASTIC)
    dt, n_int = float(cfg.dt), cfg.internal_steps
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_fuse + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    z0 = np.random.default_rng(1).uniform(-25.0, -5.0, n)
    p0 = st.init_particles(x0, y0, z0, dtype=torch.float32, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    fused = make_fused_external_steps(ctx, cfg, n_fuse)
    fused(p0.take(torch.arange(128, device=device)), fsR, 0.0, 0)
    torch.cuda.synchronize()
    kx.reset_launches()
    kr.rk4_displacement_fused.launches = 0
    sl.step_lanes_fused.launches = 0
    t0 = time.perf_counter()
    pb = fused(p0, fsR, 0.0, 0)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"rk4_displacement_fused": kr.rk4_displacement_fused.launches,
                "step_lanes": sl.step_lanes_fused.launches,
                "ext_step_fused": kx.ext_step_fused.launches}
    steps = n * n_int * n_fuse
    rates = []
    for _ in range(3):
        t1 = time.perf_counter()
        fused(p0, fsR, 0.0, 0)
        torch.cuda.synchronize()
        rates.append(steps / (time.perf_counter() - t1))
    counts = summary_counts(pb)
    p_dead = -np.expm1(-n_fuse * dt / cfg.deadage)
    sd = np.sqrt(p_dead * (1 - p_dead) / n)
    act = (pb.status == st.ACTIVE).cpu().numpy()
    xa, ya, _ = case.analytic(x0, y0, z0, n_fuse * dt)
    err = np.hypot(pb.x.cpu().numpy() - xa, pb.y.cpu().numpy() - ya)[act]
    rb = {"phase": "8b", "n": n, "ext_steps": n_fuse, "internal_steps": n_int,
          "launches": launches, "seconds": sec,
          "particle_steps_per_s": steps / sec, "warm_rates": rates,
          "dead_share": counts["dead"] / n, "dead_share_expected": p_dead,
          "dead_share_sd": sd,
          "max_err_vs_analytic_active_m": float(err.max()),
          "max_sink_m": float((p0.z - pb.z).max()), "counts": counts}
    log(rb)
    assert launches == {"rk4_displacement_fused": n_fuse * n_int,
                        "step_lanes": n_fuse * n_int,
                        "ext_step_fused": 0}, rb
    assert counts["error"] == 0 and counts["out_of_domain"] == 0, rb
    assert abs(rb["dead_share"] - p_dead) <= 5 * sd, rb
    assert np.isfinite(err).all() and err.max() < TOL_ANALYTIC, rb
    assert rb["max_sink_m"] > 0.5 * cfg.sink * n_fuse * dt, rb

    # per internal step over the first external step, from the plain
    # route's state: the DEATH draws are bit-equal, so no status differs
    ps, _ = _sort(case.grid, p0)
    prec_all = pk.build_packed_records(case.grid, fsR)
    prec3 = pk.PackedRecords(tab=prec_all.tab[:3], times=prec_all.times[:3])
    f3 = fieldset_slice(fsR, 0)
    rs, _ = lanes_stepwise(torch, "8b", ctx, cfg, ps, prec3, f3, 0.0,
                           steps=n_int, seed=cfg.seed, per_step=True)
    assert rs["decision_flips"] == 0 and rs["status_mismatch"] == 0, rs
    assert rs["status_counts_plain"][st.DEAD] > 0, rs
    rb["stepwise"] = {k: v for k, v in rs.items() if k.startswith("max")
                      or k.endswith("mismatch") or k == "decision_flips"}
    # K2 per launch at 1M and 65,536 against its plain version: the
    # main path's first launch (sorted batch, records 0..2, t = 0)
    tabs = pk.stage_value_tables(case.grid, prec3, 0.0, float(cfg.idt))
    small, _ = _sort(case.grid, p0.take(torch.arange(n_small,
                                                     device=device)))
    rb["kernel"] = {size: rk4_vs_plain(torch, f"8b-{size}", case.grid, tabs,
                                       q, cfg, reps=10, plain_reps=2)
                    for size, q in (("1M", ps), (str(n_small), small))}
    rb["bound"] = rk4_bound(case.grid, n)
    # K3 per launch on the same inputs (K2's displacement of them)
    rb["lanes"] = {size: lanes_vs_plain(torch, f"8b-lanes-{size}", ctx, cfg,
                                        q, prec3, f3, 0.0, reps=10,
                                        plain_reps=2)
                   for size, q in (("1M", ps), (str(n_small), small))}
    rb["profile"] = per_step_profile(torch, ctx, cfg, ps, prec3, f3)
    log({k: rb[k] for k in ("phase", "bound", "profile")})
    out["b"] = rb

    # (c) the oyster CLI run, and its lanes per step at 65,536
    out["c"] = phase8_cli(torch, device)
    case = bench_case(torch, device, omega=5e-6, halocline=True,
                      parabolic_aks=True)
    ctx = with_polygons(context(case), rim=True)
    t0 = 9 * 3600.0
    fs = synth.with_vertical_motion(synth.fieldset_for(
        case, t_center=t0 + 1800.0, dt=3600.0, device=device), seed=3)
    x, y, _ = water_particles(case, n_small, 2e3, 198e3, seed=1)
    z = near_surface_and_bottom(n_small, case.h0, seed=4)
    age = rng.uniform(0.0, 3 * 86400.0, n_small)
    pc = st.init_particles(x, y, z, dob=-age, dtype=torch.float32,
                           device=device)
    pc = pc.replace(status=torch.full_like(pc.status, st.ACTIVE),
                    age=torch.tensor(age, dtype=torch.float32, device=device),
                    pid=torch.tensor(rng.permutation(n_small),
                                     dtype=torch.int32, device=device))
    pc, _ = _sort(case.grid, pc)
    cfgc = make_cfg(n_small, TrackCollisions=True,
                    **{**SWIM, **OYSTER_STOCHASTIC, "deadage": 3600.0})
    rc, q = lanes_stepwise(torch, "8c-lanes", ctx, cfgc, pc,
                           pk.build_packed_records(case.grid, fs,
                                                   with_aks=True,
                                                   with_scalars=True),
                           fs, t0, steps=5, per_step=True)
    counts = np.bincount(q.status.cpu().numpy(), minlength=6)
    assert counts[st.DEAD] > 0 and counts[st.SETTLED] > 0, rc
    assert float(q.salt.max() - q.salt.min()) > 1.0, rc
    out["c-lanes"] = rc
    return out


def per_step_profile(torch, ctx, cfg, p, prec, fields):
    """Where an internal step of the per-step route spends the device's
    time: torch.profiler over one warm external step (cfg.internal_steps
    internal steps) for K2's and K3's device time (by kernel name) and all
    device time, and over the stage-table builds of those steps alone;
    the rest is the route's other ops (the copies of K3's params, the
    sort's).  Idle share: 1 - device time / wall.  The wrappers must count
    cfg.internal_steps launches each in the profiled call; the profiler's
    records are held to those counts (``profile_window``), and
    ``profiler_complete`` is false if every window lost one."""
    from ltjax_torch import packed as pk
    from ltjax_torch.kernels import rk4_step as kr, step_lanes as sl
    from ltjax_torch.step import per_step_external
    idt, n_int = float(cfg.idt), cfg.internal_steps
    names = ("rk4_step_kernel", "step_lanes_kernel")
    wrappers = (kr.rk4_displacement_fused, sl.step_lanes_fused)

    def step():
        per_step_external(ctx, cfg, p, prec, 0.0, fields, 0)

    step()
    torch.cuda.synchronize()
    before = [w.launches for w in wrappers]
    ev, wall, windows, complete = profile_window(
        torch, step, dict.fromkeys(names, n_int))
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    # every profiled window ran one external step through both wrappers
    assert launched == [windows * n_int] * 2, (launched, windows)
    all_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    ks = [[e for e in ev if name in e.name] for name in names]
    k2_ms, k3_ms = (sum(e.time_range.elapsed_us() for e in k) / 1e3
                    for k in ks)

    def tables():
        for i in range(n_int):
            pk.stage_value_tables(ctx.grid, prec, i * idt, idt)

    tables()
    torch.cuda.synchronize()
    tab_ev, _, _, _ = profile_window(torch, tables, {})
    tab_ms = sum(e.time_range.elapsed_us() for e in tab_ev) / 1e3
    res = {"internal_steps": n_int, "k2_launches": len(ks[0]),
           "k3_launches": len(ks[1]), "profiled_windows": windows,
           "profiler_complete": complete, "device_ms": all_ms,
           "k2_ms": k2_ms, "k3_ms": k3_ms, "stage_tables_ms": tab_ms,
           "other_ms": all_ms - k2_ms - k3_ms - tab_ms, "wall_ms": wall,
           "idle_share": 1.0 - all_ms / wall,
           "k2_share_of_device": k2_ms / all_ms,
           "k3_share_of_device": k3_ms / all_ms}
    if not complete:
        log({"warning": "the profiler lost a kernel record in every "
                        "window; device times are short by it", **res})
    return res


def phase8_cli(torch, device):
    """Phase 3's oyster CLI run with stochastic mortality: the per-step
    route on the card, chunks of 2 and of 4 external steps give the same
    particles, and some die."""
    from ltjax_torch.kernels import ext_step as kx, rk4_step as kr
    from ltjax_torch.kernels import step_lanes as sl
    kx.reset_launches()
    kr.rk4_displacement_fused.launches = 0
    sl.step_lanes_fused.launches = 0
    finals, lines = oyster_cli_runs(torch, "stochastic", OYSTER_STOCHASTIC)
    f = finals[4]
    res = {"phase": "8c", "n": f.shape[0],
           "chunks_identical": bool(np.array_equal(finals[2], finals[4])),
           "path": lines[4][0]["path"], "route": lines[4][0]["route"],
           "lanes": lines[4][0]["lanes"], "counts": lines[4][-1],
           "launches": {"rk4_displacement_fused":
                        kr.rk4_displacement_fused.launches,
                        "step_lanes": sl.step_lanes_fused.launches,
                        "ext_step_fused": kx.ext_step_fused.launches}}
    log(res)
    assert res["chunks_identical"] and np.isfinite(f).all(), res
    assert res["path"] == "cuda_rk4_step" and res["route"] == "per_step", res
    assert res["counts"]["dead"] > 0, res
    # both runs: 4 external steps x 30 internal steps each
    assert res["launches"] == {"rk4_displacement_fused": 2 * 4 * 30,
                               "step_lanes": 2 * 4 * 30,
                               "ext_step_fused": 0}, res
    return res


# phase 9: the variants that let an LTRANS v2b run file start on the card
# rho axes whose spacing grows by 0.2% a cell (x1.49 over 200 cells):
# rho axes and cell edges both searched
AXES_STRETCH = 1.002
# spacing that grows by 5e-8 a cell: not uniform at grid.py's 1e-9, but
# uniform at the boundary edges' 1e-4 (rho axes searched, edges not)
AXES_GRID_ONLY = 1 + 5e-8
POS_COLS = ("x", "y", "z", "dob", "age", "salt", "temp")


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def phase9a(torch, device, n=65536, nx=200, us=20):
    """The new variants against their plain versions at 65,536 particles:
    K1 on phase 1's inputs (land block, open rim, particles near the
    surface and in the log layer; one external step) in float64, on
    stretched axes (rho axes and edges searched; rho axes only) and both;
    K2 on phase 8a's random-w case in float64, on stretched axes and on
    bench.py's curv geometry with the land block (float32 and float64)."""
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import build, ext_step as kx, rk4_step as kr
    from ltjax_torch.step import _sort
    f32, f64 = torch.float32, torch.float64
    out = {}
    for name, dtype, axes in (("9a-f64", f64, 1.0),
                              ("9a-axes", f32, AXES_STRETCH),
                              ("9a-axes-grid", f32, AXES_GRID_ONLY),
                              ("9a-f64-axes", f64, AXES_STRETCH)):
        case = bench_case(torch, device, nx=nx, ny=nx, us=us, dtype=dtype,
                          axes=axes)
        ctx = context(case)
        assert case.grid.uniform == (axes == 1.0)
        assert ctx.bounds.uniform == (axes != AXES_STRETCH)
        cfg = make_cfg(n, us=us, ws=us + 1, TrackCollisions=True,
                       dtype_pos=dtype_name(dtype))
        x, y, _ = water_particles(case, n, 2e3, 198e3, seed=1)
        z = near_surface_and_bottom(n, case.h0, seed=4)
        p = st.init_particles(x, y, z, dtype=dtype, device=device)
        p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
        p, _ = _sort(case.grid, p)
        prec = pk.build_packed_records(case.grid, synth.fieldset_for(
            case, t_center=0.0, dt=3600.0, device=device))
        r = kernel_vs_plain(torch, name, ctx, cfg, p, prec, 3, 1)
        tag = build.tag("ext_step", kx.variant_of(ctx, cfg, dtype))
        r["variant"] = tag
        assert ("p1" in tag) == (dtype == f64) and (
            ("a1" in tag) == (axes != 1.0)), tag
        assert r["hit_land_plain"] > 0, r
        assert r["status_counts_plain"][st.OUT_OF_DOMAIN] > 0, r
        out[name] = r

    cfg = make_cfg(n, us=us, ws=us + 1)
    idt = float(cfg.idt)
    for name, dtype, geo in (("9a-rk4-f64", f64, 1.0),
                             ("9a-rk4-axes", f32, AXES_STRETCH),
                             ("9a-rk4-f64-axes", f64, AXES_STRETCH),
                             ("9a-rk4-curv", f32, "curv"),
                             ("9a-rk4-f64-curv", f64, "curv")):
        if geo == "curv":
            case = curv_bench_case(torch, device, nx=nx, ny=nx, us=us,
                                   omega=5e-6, dtype=dtype)
            x, y, _ = curv_water_particles(case, n, seed=1)
        else:
            case = bench_case(torch, device, nx=nx, ny=nx, us=us,
                              omega=5e-6, dtype=dtype, axes=geo)
            x, y, _ = water_particles(case, n, 2e3, 198e3, seed=1)
        z = near_surface_and_bottom(n, case.h0, seed=4)
        p, _ = _sort(case.grid, st.init_particles(x, y, z, dtype=dtype,
                                                  device=device))
        prec = pk.build_packed_records(case.grid, synth.with_vertical_motion(
            synth.fieldset_for(case, t_center=0.0, dt=3600.0,
                               device=device), seed=3))
        kr.rk4_displacement_fused.variant_launches = {}
        r = rk4_vs_plain(torch, name, case.grid, pk.stage_value_tables(
            case.grid, prec, 600.0, idt), p, cfg, reps=3, plain_reps=1)
        r["variant"] = build.tag("rk4_step",
                                 kr.kernel_variant(case.grid, dtype))
        if device.type == "cuda":
            assert (r["variant"]
                    in kr.rk4_displacement_fused.variant_launches), r
        assert r["max_abs_dz_move_m"] > 0.1, r
        out[name] = r
    return out


def fused_cell(torch, ctx, cfg, p0, fsR, n_fuse, warm=True):
    """One call of make_fused_external_steps (the main path) on p0, after
    a warm call on 128 particles, with every launch count and the staging
    counters set to 0 just before it: (particles, seconds, {tag:
    launches} of the three kernels, staging counters)."""
    from ltjax_torch.kernels import ext_step as kx, rk4_step as kr
    from ltjax_torch.kernels import step_lanes as sl
    from ltjax_torch.step import make_fused_external_steps
    fused = make_fused_external_steps(ctx, cfg, n_fuse)
    if warm:
        fused(p0.take(torch.arange(128, device=p0.x.device)), fsR, 0.0, 0)
    sync(torch, p0.x.device)
    kx.reset_launches()
    kr.rk4_displacement_fused.launches = 0
    kr.rk4_displacement_fused.variant_launches = {}
    sl.step_lanes_fused.launches = 0
    sl.step_lanes_fused.variant_launches = {}
    t0 = time.perf_counter()
    p = fused(p0, fsR, 0.0, 0)
    sync(torch, p0.x.device)
    sec = time.perf_counter() - t0
    launches = {**kx.ext_step_fused.variant_launches,
                **kr.rk4_displacement_fused.variant_launches,
                **sl.step_lanes_fused.variant_launches}
    return p, sec, launches, kx.counts()


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def advect_cell(torch, device, name, dtype, axes, n, nx, us, n_fuse,
                n_small=65536):
    """bench.py's advect cell (phase 2's inputs) in ``dtype`` on rho axes
    stretched by ``axes``: the main path at n particles, n_fuse x 30
    steps, against the circles; then the kernel against its plain version
    on its first launch (n and n_small particles, timed), its bound, and
    K2 in the same variant family on the same inputs (timed at n)."""
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import build, ext_step as kx, rk4_step as kr
    from ltjax_torch.step import _sort, summary_counts
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False,
                      dtype=dtype, axes=axes)
    ctx = context(case)
    cfg = make_cfg(n, us=us, ws=us + 1, dtype_pos=dtype_name(dtype))
    dt = float(cfg.dt)
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_fuse + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    p0 = st.init_particles(x0, y0, z0, dtype=dtype, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    p, sec, launches, staging = fused_cell(torch, ctx, cfg, p0, fsR, n_fuse)
    tag = build.tag("ext_step", kx.variant_of(ctx, cfg, dtype))
    counts = summary_counts(p)
    xa, ya, _ = case.analytic(x0, y0, z0, n_fuse * dt)
    err = np.hypot(p.x.cpu().numpy() - xa, p.y.cpu().numpy() - ya)
    res = {"phase": name, "n": n, "ext_steps": n_fuse,
           "internal_steps": cfg.internal_steps, "variant": tag,
           "launches": launches, "staging": staging,
           "staged_share": staged_share(staging), "seconds": sec,
           "particle_steps_per_s": n * cfg.internal_steps * n_fuse / sec,
           "max_err_vs_analytic_m": float(err.max()), "counts": counts,
           "dtype": dtype_name(p.x.dtype)}
    log(res)
    assert p.x.dtype == dtype, res
    if device.type == "cuda":
        assert launches == {tag: n_fuse}, res
    assert counts["error"] == 0 and counts["active"] == n, res
    assert np.isfinite(err).all() and err.max() < TOL_ANALYTIC, res
    prec_all = pk.build_packed_records(case.grid, fsR)
    prec3 = pk.PackedRecords(tab=prec_all.tab[:3], times=prec_all.times[:3])
    ps, _ = _sort(case.grid, p0)
    res["kernel"] = kernel_vs_plain(torch, name, ctx, cfg, ps, prec3, 3, 1)
    res["bound"] = kernel_bound(cfg, ctx, prec3, ps,
                                kx.ext_step_fused(ctx, cfg, ps, prec3, 0.0))
    small, _ = _sort(case.grid, p0.take(torch.arange(n_small,
                                                     device=device)))
    if device.type == "cuda":
        res["kernel_ms_" + str(n_small)] = cuda_time(
            torch, lambda: kx.ext_step_fused(ctx, cfg, small, prec3, 0.0), 5)
        res["plain_ms_" + str(n_small)] = cuda_time(
            torch, lambda: kx.ext_step_reference(ctx, cfg, small, prec3,
                                                 0.0), 1)
    tabs = pk.stage_value_tables(case.grid, prec3, 0.0, float(cfg.idt))
    res["rk4"] = {size: rk4_vs_plain(torch, f"{name}-rk4-{size}", case.grid,
                                     tabs, q, cfg, reps=10, plain_reps=1)
                  for size, q in (("1M", ps), (str(n_small), small))}
    res["rk4_variant"] = build.tag("rk4_step",
                                   kr.kernel_variant(case.grid, dtype))
    res["rk4_bound"] = rk4_bound(case.grid, n, stage1=True,
                                 pos64=dtype == torch.float64)
    log({k: res[k] for k in res if k.startswith(("phase", "kernel_ms",
                                                 "plain_ms", "bound",
                                                 "rk4_bound"))})
    return res, (case, ctx, fsR, p0)


def stochastic_cell(torch, device, name, case, ctx, fsR, p0, n_fuse,
                    stepwise=False):
    """The cell of ``case`` with stochastic mortality (bench.py's behavior
    cell: type-6 sinking, a 2-day death age) through the per-step route:
    the main path at p0's size, n_fuse x 30 steps (K2 and K3 launched once
    each per internal step, K1 never), the dead share against 1 -
    exp(-t/deadage) within 5 sd, no ERROR, warm rates; K3 against its
    plain version on the main path's first internal step (timed at p0's
    size); with ``stepwise`` also per internal step against the plain
    route over the first external step (0 status mismatches)."""
    from ltjax_torch import packed as pk, state as st
    from ltjax_torch.kernels import build, rk4_step as kr
    from ltjax_torch.kernels import step_lanes as sl
    from ltjax_torch.step import (_sort, fieldset_slice,
                                  make_fused_external_steps, summary_counts)
    n = p0.n
    cfg = make_cfg(n, us=case.grid.us, ws=case.grid.ws,
                   dtype_pos=dtype_name(p0.x.dtype), **STOCHASTIC)
    dt, n_int = float(cfg.dt), cfg.internal_steps
    p, sec, launches, _ = fused_cell(torch, ctx, cfg, p0, fsR, n_fuse)
    tag = build.tag("rk4_step", kr.kernel_variant(case.grid, p0.x.dtype))
    tag3 = build.tag("step_lanes", sl.kernel_variant(ctx, cfg, p0.x.dtype))
    counts = summary_counts(p)
    fused = make_fused_external_steps(ctx, cfg, n_fuse)
    rates = []
    for _ in range(2):
        t1 = time.perf_counter()
        fused(p0, fsR, 0.0, 0)
        sync(torch, device)
        rates.append(n * n_int * n_fuse / (time.perf_counter() - t1))
    p_dead = -np.expm1(-n_fuse * dt / cfg.deadage)
    sd = np.sqrt(p_dead * (1 - p_dead) / n)
    res = {"phase": name, "n": n, "ext_steps": n_fuse,
           "internal_steps": n_int, "variant": tag, "lanes_variant": tag3,
           "launches": launches, "seconds": sec,
           "particle_steps_per_s": n * n_int * n_fuse / sec,
           "warm_rates": rates,
           "dead_share": counts["dead"] / n, "dead_share_expected": p_dead,
           "dead_share_sd": sd, "counts": counts}
    log(res)
    if device.type == "cuda":
        assert launches == {tag: n_fuse * n_int, tag3: n_fuse * n_int}, res
    assert counts["error"] == 0, res
    assert abs(res["dead_share"] - p_dead) <= 5 * sd, res
    ps, _ = _sort(case.grid, p0)
    prec_all = pk.build_packed_records(case.grid, fsR)
    prec3 = pk.PackedRecords(tab=prec_all.tab[:3], times=prec_all.times[:3])
    res["lanes"] = lanes_vs_plain(torch, name + "-lanes", ctx, cfg, ps, prec3,
                                  fieldset_slice(fsR, 0), 0.0, reps=10,
                                  plain_reps=1)
    if stepwise:
        rs, _ = lanes_stepwise(torch, name, ctx, cfg, ps, prec3,
                               fieldset_slice(fsR, 0), 0.0, steps=n_int,
                               seed=cfg.seed, per_step=True)
        assert rs["status_mismatch"] == 0, rs
        assert rs["status_counts_plain"][st.DEAD] > 0, rs
        res["stepwise"] = {k: v for k, v in rs.items() if k.startswith("max")
                           or k.endswith("mismatch")
                           or k == "decision_flips"}
    return res


def phase9(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16,
           n_small=65536):
    """LTRANS v2b run files on the card (phase 9's builds): (a) each new
    variant against its plain version at 65,536 (phase9a); (b) the main
    path in float64 at full width: bench.py's advect cell with dtype_pos
    float64, 1M particles, 16 x 30 steps, against the circles, K1's
    LTX_POS64 build; K2's float64 build timed on its inputs; (c) the
    advect cell on stretched axes (x1.002 a cell), 1M, 16 x 30, float32,
    K1's LTX_AXES build, and the same grid with stochastic mortality for
    4 x 30 steps (K2's LTX_AXES build); (d) bench.py's curv cell with
    stochastic mortality at 1M, 16 x 30 (480 launches of K2's LTX_CURV
    build), per internal step against the plain route; (e) the CLI on
    unmodified run files (phase9_cli)."""
    from ltjax_torch import state as st, synth
    out = {"a": phase9a(torch, device, n=n_small, nx=nx, us=us)}
    out["b"], (case, ctx, fsR, p0) = advect_cell(
        torch, device, "9b", torch.float64, 1.0, n, nx, us, n_fuse, n_small)
    # K3's float64 build (the CLI's stochastic run, 9e) at 1M on 9b's
    # first launch inputs
    from ltjax_torch import packed as pk
    from ltjax_torch.step import _sort, fieldset_slice
    prec_all = pk.build_packed_records(case.grid, fsR)
    out["b"]["lanes"] = lanes_vs_plain(
        torch, "9b-lanes", ctx, make_cfg(n, us=us, ws=us + 1,
                                         dtype_pos="float64", **STOCHASTIC),
        _sort(case.grid, p0)[0], pk.PackedRecords(
            tab=prec_all.tab[:3], times=prec_all.times[:3]),
        fieldset_slice(fsR, 0), 0.0, reps=10, plain_reps=1)
    out["c"], (case, ctx, fsR, p0) = advect_cell(
        torch, device, "9c", torch.float32, AXES_STRETCH, n, nx, us, n_fuse,
        n_small)
    z0 = np.random.default_rng(1).uniform(-25.0, -5.0, n)
    p0 = p0.replace(z=torch.as_tensor(z0, dtype=p0.z.dtype, device=device))
    out["c-stochastic"] = stochastic_cell(torch, device, "9c-stochastic",
                                          case, ctx, synth.fieldset_window(
                                              case, -1800.0, 3600.0, 6,
                                              device=device), p0, 4)
    case = curv_bench_case(torch, device, nx=nx, ny=nx, us=us, land=False)
    ctx = context(case)
    fsR = synth.fieldset_window(case, -1800.0, 3600.0, n_fuse + 2,
                                device=device)
    rng = np.random.default_rng(0)
    p0 = st.init_particles(rng.uniform(40e3, 160e3, n),
                           rng.uniform(40e3, 160e3, n),
                           np.random.default_rng(1).uniform(-25.0, -5.0, n),
                           dtype=torch.float32, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    rd = stochastic_cell(torch, device, "9d", case, ctx, fsR, p0, n_fuse,
                         stepwise=True)
    from ltjax_torch import packed as pk
    from ltjax_torch.step import _sort
    ps, _ = _sort(case.grid, p0)
    prec_all = pk.build_packed_records(case.grid, fsR)
    tabs = pk.stage_value_tables(case.grid, pk.PackedRecords(
        tab=prec_all.tab[:3], times=prec_all.times[:3]), 0.0, 120.0)
    rd["rk4"] = rk4_vs_plain(torch, "9d-rk4-1M", case.grid, tabs, ps,
                             make_cfg(n), reps=10, plain_reps=1)
    rd["rk4_bound"] = rk4_bound(case.grid, n, stage1=True)
    log({k: rd[k] for k in ("phase", "rk4_bound")})
    out["d"] = rd
    out["e"] = phase9_cli(torch, device)
    return out


def phase9_cli(torch, device, n=10_000, nx=60, us=10, n_ext=4):
    """ltjax_torch.run.main on run files written without a dtype_pos key
    (LTRANS v2b's own keys; float64 positions by default): the startup
    line names the whole-step kernel and float64; the closed form as in
    phase 3; BoundaryBLNs writes xyBounds.csv and llBounds.csv; with
    checkpoint_every = 2 over 4 external steps, a run resumed (--resume)
    from the first checkpoint after the last was deleted ends with the
    uninterrupted run's particles (every column equal); and a run with
    stochastic mortality takes K2's float64 build (4 x 30 launches)."""
    import shutil
    from ltjax_torch import checkpoint as ckpt, run, synth
    from ltjax_torch.kernels import build, ext_step as kx, rk4_step as kr
    from ltjax_torch.kernels import step_lanes as sl
    work = os.path.join(ROOT, "build", "chip_smoke9")
    shutil.rmtree(work, ignore_errors=True)
    case = synth.make_solid_body_case(nx=nx, ny=nx, us=us, lx=60e3, ly=60e3,
                                      h0=50.0, omega=5e-5,
                                      dtype=torch.float64)
    rng = np.random.default_rng(2)
    x0 = rng.uniform(15e3, 45e3, n)
    y0 = rng.uniform(15e3, 45e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    cdir = os.path.join(work, "ckpt")
    nml = synth.write_run_files(case, work, x0, y0, z0, n_ext=n_ext,
                                dt=3600, idt=120, iprint=3600 * n_ext,
                                BoundaryBLNs=True, checkpoint_every=2,
                                checkpoint_dir=cdir)
    with open(nml) as f:
        assert "dtype_pos" not in f.read()
    kx.reset_launches()
    lines = run_cli(run, nml)
    start = lines[0]
    rows = np.loadtxt(os.path.join(work, "out", "run1.csv"), delimiter=",")
    last = rows[rows[:, 0] == rows[:, 0].max()]
    last = last[np.argsort(last[:, 1])]
    xa, ya, _ = case.analytic(x0, y0, z0, n_ext * 3600.0)
    err = np.hypot(last[:, 2] - xa, last[:, 3] - ya)[last[:, 5] == 1]
    nseg = 4 * case.grid.mask_rho.numel()  # an upper bound on segments
    with open(os.path.join(work, "out", "xyBounds.csv")) as f:
        xy_rows = f.read().splitlines()
    with open(os.path.join(work, "out", "llBounds.csv")) as f:
        ll_rows = f.read().splitlines()
    full = ckpt.load(os.path.join(cdir, "ckpt_4.npz"))
    os.remove(os.path.join(cdir, "ckpt_4.npz"))
    resumed_lines = run_cli(run, nml, "--resume")
    again = ckpt.load(os.path.join(cdir, "ckpt_4.npz"))
    equal = {k: bool(torch.equal(getattr(full[0], k), getattr(again[0], k)))
             for k in ("x", "y", "z", "status", "age", "dob", "pid",
                       "settle_poly", "hit_land", "hit_bottom")}
    res = {"phase": "9e", "n": n, "path": start["path"],
           "dtype_pos": start["dtype_pos"], "lanes": start["lanes"],
           "launches": dict(kx.ext_step_fused.variant_launches),
           "max_err_vs_analytic_m": float(err.max()),
           "active_at_end": int(err.size),
           "xy_bounds_rows": len(xy_rows) - 1,
           "ll_bounds_rows": len(ll_rows) - 1,
           "checkpoints": sorted(os.listdir(cdir)),
           "resumed_from": resumed_lines[1]["ext"],
           "resumed_equal": equal, "final_meta": again[1:3]}
    log(res)
    want = "cuda_ext_step" if device.type == "cuda" else "plain"
    assert start["path"] == want and start["dtype_pos"] == "float64", res
    assert full[0].x.dtype == torch.float64, res
    assert err.size > 0.9 * n and err.max() < TOL_ANALYTIC_CLI, res
    assert xy_rows[0] == "ax,ay,bx,by,kind" and 0 < res["xy_bounds_rows"], res
    assert res["ll_bounds_rows"] == res["xy_bounds_rows"] <= nseg, res
    assert res["checkpoints"] == ["ckpt_2.npz", "ckpt_4.npz"], res
    assert res["resumed_from"] == 2 and all(equal.values()), res
    if device.type == "cuda":
        # the uninterrupted run's 4 launches and the resumed run's 2
        tag = build.tag("ext_step", kx.kernel_variant(run.Config(),
                                                      pos64=True))
        assert res["launches"] == {tag: n_ext + n_ext // 2}, res

    # stochastic mortality: the per-step route in float64
    work_s = os.path.join(work, "stochastic")
    nml = synth.write_run_files(case, work_s, x0, y0, z0, n_ext=n_ext,
                                dt=3600, idt=120, **STOCHASTIC)
    kx.reset_launches()
    kr.rk4_displacement_fused.variant_launches = {}
    sl.step_lanes_fused.variant_launches = {}
    lines = run_cli(run, nml)
    rs = {"phase": "9e-stochastic", "path": lines[0]["path"],
          "route": lines[0]["route"], "dtype_pos": lines[0]["dtype_pos"],
          "launches": {**kx.ext_step_fused.variant_launches,
                       **kr.rk4_displacement_fused.variant_launches,
                       **sl.step_lanes_fused.variant_launches},
          "counts": lines[-1]}
    log(rs)
    assert rs["route"] == "per_step" and rs["dtype_pos"] == "float64", rs
    assert rs["counts"]["dead"] > 0 and rs["counts"]["error"] == 0, rs
    if device.type == "cuda":
        assert rs["path"] == "cuda_rk4_step", rs
        assert rs["launches"] == {"rk4_step-p1": n_ext * 30,
                                  "step_lanes-b6h0p1v0": n_ext * 30}, rs
    res["stochastic"] = rs
    return res


# phase 10: the native route (fast_interp = False, adaptive tension) and
# the CLI's prefetch and diagnostic switches
TOL_NATIVE_H = 1e-6    # m, float64 native route on the card vs the CPU
TOL_NATIVE_V = 1e-9    # m, per internal step from the same state
NATIVE_RUNS = {
    "sigma0": dict(fast_interp=False),
    "adaptive": dict(tension_sigma=-1.0),
    "turb": dict(fast_interp=False, HTurbOn=True, ConstantHTurb=1.0,
                 VTurbOn=True, readAks=True),
    # bench.py's behavior cell with stochastic mortality, dying within the
    # steps compared (a 1-hour death age)
    "stochastic": dict(STOCHASTIC, fast_interp=False, deadage=3600.0),
}
NATIVE_OPTIONS = {"fast_interp_off": dict(fast_interp=False),
                  "adaptive": dict(tension_sigma=-1.0)}
# 10d's series: a production-size grid, else the largest the disk takes
PREFETCH_GRIDS = ((800, 600), (400, 300), (200, 150))


def phase10(torch, device):
    """The native route and the CLI's switches (phase10a-d)."""
    t0 = time.perf_counter()
    out = {"a": phase10a(torch, device)}
    out["b"] = phase10b(torch, device)
    log({"phase": "10ab", "wall_seconds": time.perf_counter() - t0})
    out["c"] = phase10c(torch, device)
    out["d"] = phase10d(torch, device)
    return out


def phase10a(torch, device, n=65536, nx=200, us=20, steps=1):
    """The native route on the card against the same route on the CPU, in
    float64: phase 1's particles and grid (land block, open rim), its
    slow rotation with a seeded random w and zeta (with_vertical_motion,
    where the native and collapsed schemes differ) and the parabolic Aks
    profile; per internal step from the CPU's state (as lanes_stepwise),
    ``steps`` steps each of sigma 0, adaptive tension (sigma -1),
    turbulence and stochastic mortality: |dx|, |dy| <= TOL_NATIVE_H,
    |dz| <= TOL_NATIVE_V, no status mismatch, the route's tensors on the
    card.  Then the native route's displacement minus the collapsed
    route's over one internal step (printed, no gate).  The CPU side
    takes most of the time: one step each keeps 10a and 10b within
    ~150 s."""
    from dataclasses import replace
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.step import _sort, internal_step, mode_flags
    cpu = torch.device("cpu")
    f64 = torch.float64

    def setup(dev):
        case = bench_case(torch, dev, nx=nx, ny=nx, us=us, omega=5e-6,
                          parabolic_aks=True, dtype=f64)
        fs = synth.with_vertical_motion(synth.fieldset_for(
            case, t_center=0.0, dt=3600.0, device=dev), seed=3)
        return case, context(case), fs

    case, ctx, fs = setup(device)
    _, ctx_c, fs_c = setup(cpu)
    x, y, _ = water_particles(case, n, 2e3, 198e3, seed=1)
    z = near_surface_and_bottom(n, case.h0, seed=4)
    p = st.init_particles(x, y, z, dtype=f64, device=device)
    p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
    p, _ = _sort(case.grid, p)
    out = {}
    for name, kw in NATIVE_RUNS.items():
        cfg = make_cfg(n, us=us, ws=us + 1, dtype_pos="float64",
                       TrackCollisions=True, **kw)
        assert mode_flags(ctx, cfg) == "native", name
        idt = float(cfg.idt)
        res = {"phase": f"10a-{name}", "n": n, "steps": steps,
               "max_abs_dx": 0.0, "max_abs_dy": 0.0, "max_abs_dz": 0.0,
               "status_mismatch": 0, "hit_land_mismatch": 0,
               "hit_bottom_mismatch": 0}
        q = p
        for i in range(steps):
            a = internal_step(ctx, cfg, 5, q, fs, i * idt, i, mode="native")
            b = internal_step(ctx_c, cfg, 5, q.to(cpu), fs_c, i * idt, i,
                              mode="native")
            assert a.x.device.type == device.type and a.x.dtype == f64
            same = (a.status.cpu() == b.status).numpy()
            for k in ("x", "y", "z"):
                d = (getattr(a, k).cpu() - getattr(b, k)).abs().numpy()
                res["max_abs_d" + k] = max(res["max_abs_d" + k],
                                           float(d[same].max(initial=0.0)))
            res["status_mismatch"] += int((~same).sum())
            for k in ("hit_land", "hit_bottom"):
                res[k + "_mismatch"] += int(
                    (getattr(a, k).cpu() != getattr(b, k)).sum())
            q = b.to(device)
        res["status_counts"] = np.bincount(q.status.cpu().numpy(),
                                           minlength=6).tolist()
        res["hit_land"] = int(q.hit_land.sum())
        res["hit_bottom"] = int(q.hit_bottom.sum())
        res["max_vertical_move_m"] = float((q.z - p.z).abs().max())
        log(res)
        assert max(res["max_abs_dx"], res["max_abs_dy"]) <= TOL_NATIVE_H, res
        assert res["max_abs_dz"] <= TOL_NATIVE_V, res
        assert res["status_mismatch"] == 0, res
        assert res["max_vertical_move_m"] > 0.1, res
        if name == "stochastic":
            assert res["status_counts"][st.DEAD] > 0, res
        out[name] = res
    cfg = make_cfg(n, us=us, ws=us + 1, dtype_pos="float64")
    a = internal_step(ctx, replace(cfg, fast_interp=False), 5, p, fs, 0.0,
                      0, mode="native")
    b = internal_step(ctx, cfg, 5, p, fs, 0.0, 0,
                      pk.build_packed_records(case.grid, fs),
                      mode="collapsed")
    out["native_minus_collapsed"] = {
        "phase": "10a-native-minus-collapsed", "internal_steps": 1,
        **{"max_abs_d" + k: float((getattr(a, k) - getattr(b, k)).abs()
                                  .max()) for k in ("x", "y", "z")}}
    log(out["native_minus_collapsed"])
    return out


def route_steps(torch, ctx, cfg, p, fields, steps, mode="native",
                prec=None):
    """``steps`` internal steps of internal_step(mode=mode) from p
    (records 0..2, t = 0; ``prec`` their packed records, for the packed
    route)."""
    from ltjax_torch.step import internal_step
    for i in range(steps):
        p = internal_step(ctx, cfg, cfg.seed, p, fields, i * float(cfg.idt),
                          i, prec, mode=mode)
    return p


def route_profile(torch, ctx, cfg, p, fields, steps, mode="native",
                  prec=None):
    """Wall and device ms per internal step of a PyTorch route
    (route_steps): a warm run timed on the host clock (synchronized),
    then one under torch.profiler for the device time (all CUDA events),
    its count of device kernels and the top device kernels; idle share 1
    - device / wall (profiled run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    route_steps(torch, ctx, cfg, p, fields, 1, mode, prec)
    sync(torch, p.x.device)
    t0 = time.perf_counter()
    route_steps(torch, ctx, cfg, p, fields, steps, mode, prec)
    sync(torch, p.x.device)
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        route_steps(torch, ctx, cfg, p, fields, steps, mode, prec)
        sync(torch, p.x.device)
        wall_prof = 1e3 * (time.perf_counter() - t0)
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = [(k[:90], v / 1e3 / steps) for k, v in
           sorted(by_name.items(), key=lambda kv: -kv[1])[:12]]
    log({f"{mode}_profile_top_kernels_ms_per_step": top})
    return {"internal_steps": steps, "wall_ms_per_step": wall / steps,
            "wall_ms_per_step_profiled": wall_prof / steps,
            "device_ms_per_step": dev_ms / steps,
            "device_ops_per_step": len(ev) / steps,
            "idle_share": 1.0 - dev_ms / wall_prof if wall_prof else None,
            "top5_device_ms_per_step": top[:5]}


def phase10b(torch, device, n=1_000_000, nx=200, us=20, n_ext=1,
             prof_steps=4):
    """The native route at full width: phase 2's main-path case (the
    200x200x20 bench grid, 1M particles) in float64, n_ext external
    steps x 30 internal steps through make_fused_external_steps with
    fast_interp off, then with tension_sigma = -1: no kernel launched,
    the circles within TOL_ANALYTIC, and against K1's float64 route
    (the collapsed scheme, which coincides with the native one here:
    zeta constant, fields linear in x and y) within the whole-step
    gates; particle-steps/s, the peak of device memory, and per internal
    step the wall and device ms (route_profile) on the Hilbert-sorted
    batch, the sort's own time, and the wall ms unsorted."""
    from dataclasses import replace
    from ltjax_torch import state as st, synth
    from ltjax_torch.step import _sort, fieldset_slice, summary_counts
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False,
                      dtype=torch.float64)
    ctx = context(case)
    cfg0 = make_cfg(n, us=us, ws=us + 1, dtype_pos="float64")
    dt = float(cfg0.dt)
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_ext + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    p0 = st.init_particles(x0, y0, z0, dtype=torch.float64, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    pk1, sec_k1, launches_k1, _ = fused_cell(torch, ctx, cfg0, p0, fsR,
                                              n_ext, warm=False)
    xa, ya, _ = case.analytic(x0, y0, z0, n_ext * dt)
    out = {"k1": {"seconds": sec_k1, "launches": launches_k1}}
    for name, kw in NATIVE_OPTIONS.items():
        cfg = replace(cfg0, **kw)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        before = (torch.cuda.memory_allocated()
                  if device.type == "cuda" else 0)
        p, sec, launches, _ = fused_cell(torch, ctx, cfg, p0, fsR, n_ext,
                                         warm=False)
        peak = (torch.cuda.max_memory_allocated()
                if device.type == "cuda" else 0)
        counts = summary_counts(p)
        err = np.hypot(p.x.cpu().numpy() - xa, p.y.cpu().numpy() - ya)
        steps = n * cfg.internal_steps * n_ext
        r = {"phase": f"10b-{name}", "n": n, "ext_steps": n_ext,
             "internal_steps": cfg.internal_steps, "launches": launches,
             "seconds": sec, "particle_steps_per_s": steps / sec,
             "k1_seconds": sec_k1, "memory_before_gb": before / 1e9,
             "peak_memory_gb": peak / 1e9,
             "max_err_vs_analytic_m": float(err.max()), "counts": counts,
             "vs_k1": compare(f"10b-{name}", p0, p, pk1)}
        log(r)
        assert launches == {}, r
        assert p.x.dtype == torch.float64, r
        assert counts["error"] == 0 and counts["active"] == n, r
        assert np.isfinite(err).all() and err.max() < TOL_ANALYTIC, r
        check(r["vs_k1"], n)
        out[name] = r
    # per internal step at 1M on the Hilbert-sorted batch (the route's
    # order), the sort's own time, and the same steps unsorted
    f3 = fieldset_slice(fsR, 0)
    cfg = replace(cfg0, fast_interp=False)
    sync(torch, device)
    t0 = time.perf_counter()
    ps, _ = _sort(case.grid, p0)
    sync(torch, device)
    prof = {"sort_ms": 1e3 * (time.perf_counter() - t0),
            "sorted": route_profile(torch, ctx, cfg, ps, f3, prof_steps)}
    t0 = time.perf_counter()
    route_steps(torch, ctx, cfg, p0, f3, prof_steps)
    sync(torch, device)
    prof["unsorted_wall_ms_per_step"] = (
        1e3 * (time.perf_counter() - t0) / prof_steps)
    out["profile"] = prof
    log({"phase": "10b-per-internal-step", "n": n, **prof})
    return out


def phase10c(torch, device, n=10_000, nx=60, us=10, n_ext=4):
    """The CLI on the native route: phase 3's planar run (float32
    positions) with fast_interp = False, then with tension_sigma = -1
    and LTJAX_DEBUG_NANS on: the startup line says route "native", path
    "cuda_native"; no ERROR; within TOL_ANALYTIC_CLI of the closed form.
    Then a short run (2 external steps of 6 internal steps, one chunk
    each) with LTJAX_PROFILE_DIR and LTJAX_PROFILE_STEPS = 1:2, which
    leaves a trace file of external step 1."""
    import shutil
    import tempfile
    from ltjax_torch import run, synth
    case = synth.make_solid_body_case(nx=nx, ny=nx, us=us, lx=60e3, ly=60e3,
                                      h0=50.0, omega=5e-5,
                                      dtype=torch.float64)
    rng = np.random.default_rng(2)
    x0 = rng.uniform(15e3, 45e3, n)
    y0 = rng.uniform(15e3, 45e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    xa, ya, _ = case.analytic(x0, y0, z0, n_ext * 3600.0)
    want = "cuda_native" if device.type == "cuda" else "plain"
    out = {}
    for name, kw in NATIVE_OPTIONS.items():
        work = os.path.join(ROOT, "build", f"chip_smoke10_{name}")
        shutil.rmtree(work, ignore_errors=True)
        nml = synth.write_run_files(case, work, x0, y0, z0, n_ext=n_ext,
                                    dt=3600, idt=120, iprint=3600 * n_ext,
                                    ext_fuse=n_ext, dtype_pos="float32", **kw)
        if name == "adaptive":
            os.environ["LTJAX_DEBUG_NANS"] = "1"
        try:
            t0 = time.perf_counter()
            lines = run_cli(run, nml)
            sec = time.perf_counter() - t0
        finally:
            os.environ.pop("LTJAX_DEBUG_NANS", None)
        start = lines[0]
        rows = np.loadtxt(os.path.join(work, "out", "run1.csv"),
                          delimiter=",")
        last = rows[rows[:, 0] == rows[:, 0].max()]
        last = last[np.argsort(last[:, 1])]
        err = np.hypot(last[:, 2] - xa, last[:, 3] - ya)
        r = {"phase": f"10c-{name}", "n": n, "route": start["route"],
             "path": start["path"], "lanes": start["lanes"],
             "dtype_pos": start["dtype_pos"], "counts": lines[-1],
             "seconds": sec, "max_err_vs_analytic_m": float(err.max())}
        log(r)
        assert start["route"] == "native" and start["path"] == want, r
        assert ("adaptive_tension" in start["lanes"]) == (name == "adaptive")
        assert lines[-1]["error"] == 0 and last.shape[0] == n, r
        assert err.max() < TOL_ANALYTIC_CLI, r
        out[name] = r
    work = os.path.join(ROOT, "build", "chip_smoke10_profile")
    shutil.rmtree(work, ignore_errors=True)
    trace_dir = tempfile.mkdtemp(prefix="ltjax_trace_")
    nml = synth.write_run_files(case, work, x0[:1000], y0[:1000], z0[:1000],
                                n_ext=2, dt=3600, idt=600, iprint=7200,
                                ext_fuse=1, dtype_pos="float32",
                                fast_interp=False)
    os.environ.update(LTJAX_PROFILE_DIR=trace_dir, LTJAX_PROFILE_STEPS="1:2")
    try:
        run_cli(run, nml)
        files = sorted(os.listdir(trace_dir))
        size = sum(os.path.getsize(os.path.join(trace_dir, f))
                   for f in files)
        with open(os.path.join(trace_dir, files[0])) as f:
            n_events = len(json.load(f)["traceEvents"])
    finally:
        for k in ("LTJAX_PROFILE_DIR", "LTJAX_PROFILE_STEPS"):
            os.environ.pop(k, None)
        shutil.rmtree(trace_dir, ignore_errors=True)
    out["profile"] = {"phase": "10c-profile", "files": files,
                      "bytes": size, "trace_events": n_events}
    log(out["profile"])
    assert files == ["trace_ext1-2.json"] and n_events > 0, out["profile"]
    return out


def phase10d(torch, device, n=1_000_000, us=25, n_ext=8, fuse=2,
             grids=PREFETCH_GRIDS):
    """Prefetch on a production-size series: n_ext + 3 records of a
    solid-body case on the first grid of ``grids`` whose records fit on
    the disk (800x600x25: ~200 MB a record in float32) written with
    synth.write_run_files under a temporary directory (deleted at the
    end); n particles through the CLI's run() on the ext_step route
    (float32, chunks of ``fuse`` external steps, output at the start and
    the end only), with prefetch on, then off: the final particles
    bit-equal; per chunk the record-read and compute seconds, the
    prefetcher's wait and particle-steps/s."""
    import shutil
    import tempfile
    from dataclasses import replace
    from ltjax_torch import run, state as st, synth
    from ltjax_torch.config import config_from_namelist
    from ltjax_torch.kernels import ext_step as kx
    work = tempfile.mkdtemp(prefix="ltjax_prefetch_")
    try:
        n_rec = n_ext + 3
        free = shutil.disk_usage(work).free
        for nx, ny in grids:
            rec_bytes = 4 * (us * ny * (nx - 1) + us * (ny - 1) * nx
                             + 2 * (us + 1) * ny * nx + ny * nx)
            if n_rec * rec_bytes * 1.2 + 100 * n < free:
                break
        else:
            raise AssertionError(f"10d: no grid fits {free} bytes of disk")
        case = synth.make_solid_body_case(nx=nx, ny=ny, us=us, lx=nx * 500.0,
                                          ly=ny * 500.0, h0=50.0,
                                          omega=1e-5, dtype=torch.float64)
        rng = np.random.default_rng(10)
        x0 = rng.uniform(0.2, 0.8, n) * nx * 500.0
        y0 = rng.uniform(0.2, 0.8, n) * ny * 500.0
        z0 = rng.uniform(-40.0, -5.0, n)
        t0 = time.perf_counter()
        nml = synth.write_run_files(case, work, x0, y0, z0, n_ext=n_ext,
                                    dt=3600, idt=120, iprint=3600 * n_ext,
                                    ext_fuse=fuse, dtype_pos="float32",
                                    extra_records=1)
        write_s = time.perf_counter() - t0
        res = {"phase": "10d", "n": n, "grid": [nx, ny, us],
               "record_mb": rec_bytes / 1e6, "records": n_rec,
               "disk_free_gb": free / 1e9, "write_seconds": write_s,
               "ext_steps": n_ext, "chunk": fuse}
        finals = {}
        for on in (True, False):
            cfg = replace(config_from_namelist(nml), prefetch=on)
            kx.reset_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                finals[on] = run.run(cfg, device=device)
            sec = time.perf_counter() - t0
            lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
                     if ln.startswith("{")]
            chunks, stall = [], 0.0
            for ln in lines[1:]:
                chunks.append({"ext": ln["ext"],
                               "hydro_read": ln["hydro_read_s"],
                               "compute": ln["compute_s"],
                               "stall_s": ln["stall_s"] - stall,
                               "steps_per_s": ln["steps_per_s"]})
                stall = ln["stall_s"]
            key = "prefetch_on" if on else "prefetch_off"
            res[key] = {"path": lines[0]["path"], "route": lines[0]["route"],
                        "seconds": sec, "chunks": chunks,
                        "launches": kx.ext_step_fused.launches,
                        "counts": {k: lines[-1][k] for k in
                                   ("active", "out_of_domain", "error")}}
            log({"phase": "10d", key: res[key]})
            if device.type == "cuda":
                assert lines[0]["path"] == "cuda_ext_step", res[key]
                assert res[key]["launches"] == n_ext, res[key]
        res["bit_equal"] = {k: bool(torch.equal(getattr(finals[True], k),
                                                getattr(finals[False], k)))
                            for k in st.FIELDS}
        log({k: res[k] for k in res if k not in ("prefetch_on",
                                                  "prefetch_off")})
        assert all(res["bit_equal"].values()), res["bit_equal"]
        assert res["prefetch_on"]["counts"]["error"] == 0, res
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 11: sharded runs (ltjax_torch.shard, dist, run.run_sharded) and the
# native NetCDF reader
# ---------------------------------------------------------------------------

TOL_TILE = 1e-3        # m, a tiled run against the single rank (bit-equal
                       # expected: the tiles locate on the whole grid's axes)


def capture_fd(fn):
    """fn() with file descriptor 1 sent to a file (spawned ranks write
    their lines there): (its result, the JSON lines written)."""
    import tempfile
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile("w+") as f:
        os.dup2(f.fileno(), 1)
        try:
            res = fn()
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        text = f.read()
    lines = []
    for ln in text.splitlines():
        log(f"[run] {ln}")
        if ln.startswith("{"):
            lines.append(json.loads(ln))
    return res, lines


def tiled_vs_single(torch, name, single, tiled):
    """A tiled run's particles (pid order, on the CPU) against the single
    rank's: pids, statuses and hit_land equal, positions bit-equal or
    within TOL_TILE."""
    order = torch.argsort(single.pid.cpu())
    ref = {k: getattr(single, k).cpu()[order] for k in
           ("pid", "status", "hit_land", "x", "y", "z")}
    got = {k: getattr(tiled, k).cpu() for k in ref}
    res = {"phase": name, "n": int(tiled.n)}
    for k in ("pid", "status", "hit_land"):
        res[k + "_equal"] = bool(torch.equal(got[k], ref[k]))
    for k in ("x", "y", "z"):
        d = (got[k].double() - ref[k].double()).abs()
        res["max_abs_d" + k] = float(d.max())
    res["positions_bit_equal"] = all(
        torch.equal(got[k], ref[k]) for k in ("x", "y", "z"))
    log(res)
    assert res["pid_equal"] and res["status_equal"] and res[
        "hit_land_equal"], res
    assert max(res["max_abs_dx"], res["max_abs_dy"],
               res["max_abs_dz"]) <= TOL_TILE, res
    return res


def phase11(torch, device):
    """Sharded runs on the card and the native reader (phase11a-e)."""
    t0 = time.perf_counter()
    out = {"a": phase11a(torch, device)}
    out["b"] = phase11b(torch, device)
    out["c"] = phase11c(torch, device)
    out["d"] = phase11d(torch, device)
    out["e"] = phase11e(torch, device)
    out["phase_wall_seconds"] = time.perf_counter() - t0
    log({"phase": 11, "phase_wall_seconds": out["phase_wall_seconds"]})
    return out


def strip_particles(case, n, ylo, yhi, seed):
    """n water particles of phase 1's grid with y in [ylo, yhi]."""
    xs, ys = [], []
    while sum(len(a) for a in xs) < n:
        x, y, _ = water_particles(case, 4 * n, 2e3, 198e3, seed=seed)
        keep = (y >= ylo) & (y <= yhi)
        xs.append(x[keep])
        ys.append(y[keep])
        seed += 1
    return np.concatenate(xs)[:n], np.concatenate(ys)[:n]


def phase11a(torch, device, n=65536, nx=200, us=20):
    """K1 and K2 on a tile: phase 1's grid (land block, open rim) cut into
    4 strips with the halo of halo_rows_needed, tile 1's strip (LTX_TILE
    builds): 65,536 particles of the strip, halo rows included, one in 16
    slots EMPTY; K1 (advection: float32, float64, and float32 on phase
    9c's stretched axes) one external step against its plain version
    (PERF.md section 2's gates), every EMPTY slot bit-unchanged; K2 on
    the float32 strip with a random w against its plain version."""
    from ltjax_torch import packed as pk, shard, state as st, synth
    from ltjax_torch.kernels import build, ext_step as kx, rk4_step as kr
    from ltjax_torch.step import _sort
    f32, f64 = torch.float32, torch.float64
    out = {}
    for name, dtype, axes in (("11a-f32", f32, 1.0), ("11a-f64", f64, 1.0),
                              ("11a-axes", f32, AXES_STRETCH)):
        case = bench_case(torch, device, nx=nx, ny=nx, us=us, dtype=dtype,
                          axes=axes)
        ctx = context(case)
        cfg = make_cfg(n, us=us, ws=us + 1, TrackCollisions=True,
                       dtype_pos=dtype_name(dtype))
        y_ax = case.grid.y_rho.cpu().numpy()
        # the bench case's fastest water: 5e-5 rad/s at the corner
        halo = shard.halo_rows_needed(5e-5 * 100e3 * np.sqrt(2.0),
                                      float(cfg.dt),
                                      float(np.diff(y_ax).min()))
        spec = shard.make_spec(cfg, nx, 4 * n, 1, 4, halo=halo)
        tiled = shard.build_tiled_static(case.grid, spec)
        tctx = shard.tile_context(ctx, spec, tiled, 1)
        g = tctx.grid
        fs = shard.strip_fieldset(synth.fieldset_for(
            case, t_center=0.0, dt=3600.0, device=device), spec, 1, nx)
        prec = pk.build_packed_records(g, fs)
        ys = g.y_rho.cpu().numpy()
        x, y = strip_particles(case, n, ys[1], ys[-2], seed=11)
        z = near_surface_and_bottom(n, case.h0, seed=4)
        p = st.init_particles(x, y, z, dtype=dtype, device=device)
        empty = torch.arange(n, device=device) % 16 == 5
        p = p.replace(
            status=torch.where(empty, shard.EMPTY, st.ACTIVE).to(torch.int32),
            pid=torch.where(empty, -1, p.pid).to(torch.int32))
        p, _ = _sort(g, p)
        kx.reset_launches()
        r = kernel_vs_plain(torch, name, tctx, cfg, p, prec, 3, 1)
        tag = build.tag("ext_step", kx.variant_of(tctx, cfg, dtype))
        out_k = kx.ext_step_fused(tctx, cfg, p, prec, 0.0)
        m = p.status == shard.EMPTY
        edges = tiled.tile_edges
        r.update({"variant": tag, "halo": halo, "strip_rows": spec.ny_ext,
                  "bound": kernel_bound(cfg, tctx, prec, p, out_k),
                  "launches": kx.ext_step_fused.launches,
                  "empty_slots": int(m.sum()),
                  "empty_bit_unchanged": all(
                      bool(torch.equal(getattr(out_k, k)[m],
                                       getattr(p, k)[m]))
                      for k in st.FIELDS),
                  "in_halo_rows": int(((y < edges[1]) | (y >= edges[2]))
                                      .sum())})
        log({k: r[k] for k in ("phase", "variant", "halo", "strip_rows",
                               "bound", "launches", "empty_slots",
                               "empty_bit_unchanged", "in_halo_rows")})
        if device.type == "cuda":
            assert "t1" in tag and r["launches"] >= 2, r
        assert r["empty_bit_unchanged"] and r["empty_slots"] > 0, r
        assert r["in_halo_rows"] > 0 and r["hit_land_plain"] > 0, r
        out[name] = r
        if name == "11a-f32":
            slow = bench_case(torch, device, nx=nx, ny=nx, us=us,
                              omega=5e-6)
            fv = shard.strip_fieldset(synth.with_vertical_motion(
                synth.fieldset_for(slow, t_center=0.0, dt=3600.0,
                                   device=device), seed=3), spec, 1, nx)
            kr.rk4_displacement_fused.launches = 0
            out["11a-rk4"] = rk4_vs_plain(
                torch, "11a-rk4", g, pk.stage_value_tables(
                    g, pk.build_packed_records(g, fv), 600.0,
                    float(cfg.idt)), p, cfg, reps=3, plain_reps=1)
            out["11a-rk4"]["launches"] = kr.rk4_displacement_fused.launches
            out["11a-rk4"]["bound"] = rk4_bound(g, n)
            log({"phase": "11a-rk4", "bound": out["11a-rk4"]["bound"]})
            if device.type == "cuda":
                assert out["11a-rk4"]["launches"] > 0
    return out


def phase11b(torch, device, n=1_000_000, nx=200, us=20, n_ext=4, n_fuse=2):
    """The tiled main path at full width: phase 2's case (1M particles,
    200x200x20 solid body) in float64, 4 external steps in fused chunks
    of 2 on the (dp, tile) meshes (1, 4) and (2, 2), 4 gloo ranks sharing
    the card (shard.run_tiled_steps), against the single rank's K1 route
    from the same state (11b's gates); then stochastic mortality (the
    per-step route, K2 per tile) for 2 external steps on (1, 4) against
    the single rank's per-step route: the same DEAD pids.  Migrations and
    particle-steps/s (not a gain: the ranks share one card)."""
    from ltjax_torch import shard, state as st, synth
    from ltjax_torch.step import make_fused_external_steps
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False,
                      dtype=torch.float64)
    ctx = context(case)
    cfg = make_cfg(n, us=us, ws=us + 1, dtype_pos="float64")
    dt = float(cfg.dt)
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_ext + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    p0 = st.init_particles(x0, y0, z0, dtype=torch.float64, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    # the particles' fastest water: 5e-5 rad/s at 85 km from the centre
    halo = shard.halo_rows_needed(5e-5 * 60e3 * np.sqrt(2.0), dt,
                                  float(np.diff(
                                      case.grid.y_rho.cpu().numpy()).min()))

    def single(c, steps):
        fused = make_fused_external_steps(ctx, c, n_fuse)
        p = p0
        for e0 in range(0, steps, n_fuse):
            p = fused(p, synth.fieldset_window(
                case, -dt / 2 + e0 * dt, dt, n_fuse + 2, device=device),
                e0 * dt, e0)
        sync(torch, device)
        return p

    ref = single(cfg, n_ext)
    cfg_s = make_cfg(n, us=us, ws=us + 1, dtype_pos="float64", **STOCHASTIC)
    ref_s = single(cfg_s, 2)
    out = {"halo": halo}
    for ndp, ntiles in ((1, 4), (2, 2)):
        # the particles fill the middle 60% of the rows: 3x slack
        spec = shard.make_spec(cfg, nx, n, ndp, ntiles, halo=halo,
                               slack=3.0)
        cases = [shard.TiledCase(ctx, cfg, p0, fsR, n_ext, spec, n_fuse)]
        if (ndp, ntiles) == (1, 4):
            cases.append(shard.TiledCase(ctx, cfg_s, p0, fsR, 2, spec,
                                         n_fuse))
        t0 = time.perf_counter()
        res = shard.run_tiled_steps(cases, device=device, backend="gloo")
        wall = time.perf_counter() - t0
        key = f"11b-{ndp}x{ntiles}"
        got, ranks = res[0]
        r = tiled_vs_single(torch, key, ref, got)
        sec = max(q["seconds"] for q in ranks)
        r.update({"mesh": [ndp, ntiles], "halo": halo, "cap": spec.cap,
                  "wall_seconds_with_spawn": wall,
                  "migrated": sum(q["sent"] for q in ranks),
                  "drops": sum(q["drops"] for q in ranks),
                  "k1_launches": [q["launches"] for q in ranks],
                  "rank_seconds": [q["seconds"] for q in ranks],
                  "peak_memory_bytes": [q["peak_memory_bytes"]
                                        for q in ranks],
                  "particle_steps_per_s": n * cfg.internal_steps * n_ext
                  / sec})
        log({k: v for k, v in r.items() if not k.startswith("max_abs")})
        assert r["drops"] == 0 and r["migrated"] > 0, r
        if device.type == "cuda":
            assert all(k == n_ext for k in r["k1_launches"]), r
        out[key] = r
        if len(res) > 1:
            got_s, ranks_s = res[1]
            rs = tiled_vs_single(torch, key + "-stochastic", ref_s, got_s)
            dead_t = set(got_s.pid[got_s.status == st.DEAD].tolist())
            dead_1 = set(ref_s.pid[ref_s.status == st.DEAD].cpu().tolist())
            rs.update({"dead": len(dead_1), "dead_equal": dead_t == dead_1,
                       "k2_launches": [q["rk4_launches"] for q in ranks_s],
                       "k3_launches": [q["lanes_launches"] for q in ranks_s],
                       "k1_launches": [q["launches"] for q in ranks_s],
                       "migrated": sum(q["sent"] for q in ranks_s)})
            log({k: v for k, v in rs.items() if not k.startswith("max_abs")})
            assert rs["dead_equal"] and rs["dead"] > 0, rs
            if device.type == "cuda":
                assert all(k == 2 * cfg.internal_steps
                           for k in rs["k2_launches"] + rs["k3_launches"]), rs
                assert not any(rs["k1_launches"]), rs
            out[key + "-stochastic"] = rs
    return out


def phase11c(torch, device, n=10_000, nx=60, us=10, n_ext=4):
    """The CLI: phase 3's planar run (float32) through run.run(...,
    backend="gloo") with 2 x 2 ranks on the card and checkpoints every 2
    external steps: its CSV equals the single rank's, and a --resume after
    deleting the last checkpoints, on the same mesh and on (1, 4), gives
    the uninterrupted run's particles; the startup line names the
    backend, the ranks and the reader."""
    import dataclasses
    import filecmp
    import shutil
    from ltjax_torch import run, shard, synth
    from ltjax_torch.config import config_from_namelist
    work = os.path.join(ROOT, "build", "chip_smoke_11c")
    shutil.rmtree(work, ignore_errors=True)
    case = synth.make_solid_body_case(nx=nx, ny=nx, us=us, lx=60e3, ly=60e3,
                                      h0=50.0, omega=5e-5,
                                      dtype=torch.float64)
    rng = np.random.default_rng(2)
    x0 = rng.uniform(15e3, 45e3, n)
    y0 = rng.uniform(15e3, 45e3, n)
    z0 = rng.uniform(-40.0, -5.0, n)
    dy = 60e3 / (nx - 1)
    nml = synth.write_run_files(
        case, work, x0, y0, z0, n_ext=n_ext, dt=3600, idt=120,
        iprint=3600, ext_fuse=2, dtype_pos="float32", checkpoint_every=2,
        halo_rows=shard.halo_rows_needed(5e-5 * 30e3 * np.sqrt(2.0),
                                         3600.0, dy),
        migrate_capacity=3.0)   # the particles fill the middle half
    base = config_from_namelist(nml)

    def cfg(name, **kw):
        return dataclasses.replace(base, outpath=f"{work}/{name}",
                                   checkpoint_dir=f"{work}/ck_{name}", **kw)

    mesh = dict(mesh_particles=2, mesh_tiles=2)
    p1, lines1 = capture_fd(lambda: run.run(cfg("one"), device=device))
    p4, lines4 = capture_fd(lambda: run.run(cfg("four", **mesh),
                                            device=device, backend="gloo"))
    start = lines4[0]
    res = {"phase": "11c", "n": n, "start": {k: start.get(k) for k in (
        "path", "backend", "ranks", "cards", "reader", "mesh", "halo")},
           "csv_equal": filecmp.cmp(f"{work}/one/run1.csv",
                                    f"{work}/four/run1.csv", shallow=False),
           "migrated": sum(ln.get("migrated", 0) for ln in lines4),
           "launches": [ln["kernel_launches"] for ln in lines4
                        if ln.get("event") == "rank_done"]}
    order = torch.argsort(p1.pid)
    res["final_equal"] = all(bool(torch.equal(getattr(p4, k).cpu(),
                                              getattr(p1, k)[order].cpu()))
                             for k in ("pid", "status", "x", "y", "z"))
    for name, m in (("resume_2x2", mesh),
                    ("resume_1x4", dict(mesh_particles=1, mesh_tiles=4))):
        ck = f"{work}/ck_{name}"
        shutil.copytree(f"{work}/ck_four", ck)
        for f in os.listdir(ck):
            if f.startswith(f"ckpt_{n_ext}_"):
                os.remove(os.path.join(ck, f))
        pr, _ = capture_fd(lambda: run.run(
            dataclasses.replace(cfg(name, **m), checkpoint_dir=ck),
            resume=True, device=device, backend="gloo"))
        res[name + "_equal"] = all(bool(torch.equal(getattr(pr, k),
                                                    getattr(p4, k)))
                                   for k in ("pid", "status", "x", "y", "z",
                                             "age"))
    log(res)
    assert res["start"]["backend"] == "gloo" and res["start"]["ranks"] == 4
    assert res["start"]["reader"] == "native", res
    assert res["csv_equal"] and res["final_equal"], res
    assert res["resume_2x2_equal"] and res["resume_1x4_equal"], res
    assert res["migrated"] > 0, res
    if device.type == "cuda":
        assert res["start"]["path"] == "cuda_ext_step", res
        assert all(sum(v.values()) > 0 for v in res["launches"]), res
    return res


def reader_rate(path, reps=2):
    """The native reader against scipy's netcdf_file (mmap) on the same
    record (zeta, u, v, w and AKs of record 1), in turn, each ``reps``
    times in one process: the seconds to open the file (its header) and
    to read the record from the open file, MB/s of the read; the arrays
    bit-equal."""
    from scipy.io import netcdf_file
    from ltjax_torch.native import NativeCDF
    names = ("zeta", "u", "v", "w", "AKs")
    out = {k: [] for k in ("native_open_s", "native_read_s", "scipy_open_s",
                           "scipy_read_s")}
    for _ in range(reps):
        t0 = time.perf_counter()
        f = NativeCDF(path)
        t1 = time.perf_counter()
        a = {k: f.read(k, 1, dtype="float32") for k in names}
        t2 = time.perf_counter()
        f.close()
        out["native_open_s"].append(t1 - t0)
        out["native_read_s"].append(t2 - t1)
        t0 = time.perf_counter()
        f = netcdf_file(path, "r", mmap=True)
        t1 = time.perf_counter()
        b = {k: np.array(f.variables[k][1], np.float32) for k in names}
        t2 = time.perf_counter()
        f.close()
        out["scipy_open_s"].append(t1 - t0)
        out["scipy_read_s"].append(t2 - t1)
    mb = sum(v.nbytes for v in a.values()) / 1e6
    out.update({"record_mb": mb,
                "native_mb_per_s": [mb / s for s in out["native_read_s"]],
                "scipy_mb_per_s": [mb / s for s in out["scipy_read_s"]],
                "bit_equal": all(np.array_equal(a[k], b[k])
                                 for k in names)})
    return out


def phase11d(torch, device, n=10_000_000, nx=800, ny=600, us=25, n_ext=4,
             fuse=2, ntiles=4):
    """BASELINE.json config 5 at size on one card: 10M particles on an
    800x600x25 solid-body series (written as 10d writes it, deleted at
    the end), mesh_tiles = 4 gloo ranks each reading its strip with the
    native reader, 4 external steps in chunks of 2 (float32, no output),
    against the single rank's run of the same particles (11b's gates);
    per rank and chunk the read, compute and stall seconds and the
    migrated particles, the total particle-steps/s and each rank's peak
    device memory; and the native reader's MB/s against scipy's on the
    same record."""
    import dataclasses
    import shutil
    import tempfile
    from ltjax_torch import run, shard, synth
    from ltjax_torch.config import config_from_namelist
    work = tempfile.mkdtemp(prefix="ltjax_11d_")
    try:
        case = synth.make_solid_body_case(nx=nx, ny=ny, us=us, lx=nx * 500.0,
                                          ly=ny * 500.0, h0=50.0,
                                          omega=1e-5, dtype=torch.float64)
        rng = np.random.default_rng(10)
        x0 = rng.uniform(0.2, 0.8, n) * nx * 500.0
        y0 = rng.uniform(0.2, 0.8, n) * ny * 500.0
        z0 = rng.uniform(-40.0, -5.0, n)
        t0 = time.perf_counter()
        # 1e-5 rad/s at the domain's corner, 3600 s, 500 m rows
        halo = shard.halo_rows_needed(
            1e-5 * 0.5 * np.hypot(nx, ny) * 500.0, 3600.0, 500.0)
        nml = synth.write_run_files(case, work, x0, y0, z0, n_ext=n_ext,
                                    dt=3600, idt=120, iprint=3600 * n_ext,
                                    ext_fuse=fuse, dtype_pos="float32",
                                    extra_records=1, writeCSV=False,
                                    halo_rows=halo, migrate_capacity=3.0)
        write_s = time.perf_counter() - t0
        base = config_from_namelist(nml)
        res = {"phase": "11d", "n": n, "grid": [nx, ny, us], "halo": halo,
               "ranks": ntiles, "write_seconds": write_s,
               "reader": reader_rate(os.path.join(
                   work, "ocean_his_0001.nc"))}
        log({"phase": "11d", "reader": res["reader"]})
        assert res["reader"]["bit_equal"], res["reader"]
        t0 = time.perf_counter()
        p1, lines1 = capture_fd(lambda: run.run(base, device=device))
        res["single"] = {"seconds": time.perf_counter() - t0, "chunks": [
            {k: ln[k] for k in ("ext", "hydro_read_s", "compute_s",
                                "stall_s", "steps_per_s")}
            for ln in lines1[1:] if "ext" in ln]}
        p1 = p1.to("cpu")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        p4, lines4 = capture_fd(lambda: run.run(
            dataclasses.replace(base, mesh_tiles=ntiles), device=device,
            backend="gloo"))
        res["tiled_seconds"] = time.perf_counter() - t0
        chunks = [ln for ln in lines4 if "ext" in ln and "rank" in ln]
        res["ranks_chunks"] = [
            {k: ln[k] for k in ("rank", "ext", "hydro_read_s", "compute_s",
                                "stall_s", "migrated")} for ln in chunks]
        done = [ln for ln in lines4 if ln.get("event") == "rank_done"]
        res["peak_memory_bytes"] = {ln["rank"]: ln.get("peak_memory_bytes")
                                    for ln in done}
        res["launches"] = {ln["rank"]: ln["kernel_launches"] for ln in done}
        compute = {}
        for ln in chunks:
            compute[ln["rank"]] = compute.get(ln["rank"], 0.0) + ln[
                "compute_s"]
        res["particle_steps_per_s"] = (n * base.internal_steps * n_ext
                                       / max(compute.values()))
        res["start"] = lines4[0]
        res["compare"] = tiled_vs_single(torch, "11d", p1, p4)
        res["migrated"] = sum(ln["migrated"] for ln in chunks)
        res["drops"] = max(ln["migration_drops"] for ln in chunks)
        log({k: v for k, v in res.items() if k not in ("compare",)})
        assert res["start"]["reader"] == "native", res["start"]
        assert res["migrated"] > 0 and res["drops"] == 0, res
        if device.type == "cuda":
            assert all(sum(v.values()) == n_ext
                       for v in res["launches"].values()), res["launches"]
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase11e(torch, device):
    """11b's advection case over NCCL, one rank per card, where the
    machine has two cards or more (world: up to 4 tiles)."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards < 2:
        res = {"phase": "11e", "ran": False, "cards": cards}
        log(res)
        return res
    from ltjax_torch import shard, state as st, synth
    from ltjax_torch.step import make_fused_external_steps
    n, nx, us, n_ext = 1_000_000, 200, 20, 2
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False,
                      dtype=torch.float64)
    ctx = context(case)
    cfg = make_cfg(n, us=us, ws=us + 1, dtype_pos="float64")
    dt = float(cfg.dt)
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_ext + 2, device=device)
    rng = np.random.default_rng(0)
    p0 = st.init_particles(rng.uniform(40e3, 160e3, n),
                           rng.uniform(40e3, 160e3, n),
                           rng.uniform(-40.0, -5.0, n), dtype=torch.float64,
                           device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    ref = make_fused_external_steps(ctx, cfg, n_ext)(p0, fsR, 0.0, 0)
    world = min(4, cards)
    spec = shard.make_spec(cfg, nx, n, 1, world, halo=17, slack=3.0)
    (got, ranks), = shard.run_tiled_steps(
        [shard.TiledCase(ctx, cfg, p0, fsR, n_ext, spec, n_fuse=n_ext)],
        device=device, backend="nccl")
    res = tiled_vs_single(torch, "11e", ref, got)
    res.update({"ran": True, "cards": cards, "ranks": world,
                "migrated": sum(q["sent"] for q in ranks)})
    log(res)
    assert res["migrated"] > 0
    return res


# ---------------------------------------------------------------------------
# phase 12: the depth-banded Hilbert sort on a sheared population
# ---------------------------------------------------------------------------

SHEAR_A = 0.01    # phase 12: rotation rate 1 + 0.01 z (half at the bed)
# phase 12b's sort settings: none, equal slabs, log2 bands
BAND_SETTINGS = {
    "none": {},
    "2x25m": dict(sort_depth_bands=2, sort_band_height=25.0),
    "3x16m": dict(sort_depth_bands=3, sort_band_height=16.0),
    "6x8m": dict(sort_depth_bands=6, sort_band_height=8.0),
    "log4x4m": dict(sort_depth_bands=4, sort_band_height=4.0,
                    sort_band_log=True),
}


def sheared_case(torch, device, dtype=None, nx=200, us=20):
    """Phase 2's grid (200x200x20, h0 50 m, solid body omega 5e-5) with a
    vertical shear, the rotation rate 1 + 0.01 z: no w and no
    turbulence, so every particle keeps its height and its band."""
    from ltjax_torch import synth
    return synth.make_solid_body_case(nx=nx, ny=nx, us=us, lx=200e3,
                                      ly=200e3, h0=50.0, omega=5e-5,
                                      shear_a=SHEAR_A,
                                      dtype=dtype or torch.float32,
                                      device=device)


def sheared_particles(torch, device, n, dtype, seed=0):
    """n active particles on phase 2's patch (40-160 km), uniform in depth
    from -49 m to -1 m: (particles, x0, y0, z0)."""
    from ltjax_torch import state as st
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    z0 = rng.uniform(-49.0, -1.0, n)
    p0 = st.init_particles(x0, y0, z0, dtype=dtype, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    return p0, x0, y0, z0


@contextlib.contextmanager
def timed_k1_and_sort(torch):
    """CUDA events around every external step (``step.route_step``: on
    the ext_step route one launch of K1 on views of the record table) and
    every Hilbert sort of make_fused_external_steps in the block: yields
    {"k1": [...], "sort": [...]} of (start, end) event pairs."""
    from ltjax_torch import step
    events = {"k1": [], "sort": []}

    def timed(fn, key):
        def call(*a, **kw):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = fn(*a, **kw)
            pair[1].record()
            events[key].append(pair)
            return out
        return call

    k1, srt = step.route_step, step._sort
    step.route_step, step._sort = timed(k1, "k1"), timed(srt, "sort")
    try:
        yield events
    finally:
        step.route_step, step._sort = k1, srt


def elapsed_ms(pairs):
    return sum(a.elapsed_time(b) for a, b in pairs)


def banded_cell(torch, device, name, ctx, cfg, p0, fsR, n_fuse, calls):
    """``calls`` calls of make_fused_external_steps (the first cold, after
    a call on 128 particles), every count set to 0 just before each: the
    particles of the last call, each call's particle-steps/s, and of the
    last call K1's and the sort's ms per external step, K1's launches and
    the staging counters."""
    from ltjax_torch.kernels import ext_step as kx
    from ltjax_torch.step import make_fused_external_steps
    fused = make_fused_external_steps(ctx, cfg, n_fuse)
    fused(p0.take(torch.arange(128, device=device)), fsR, 0.0, 0)
    rates = []
    for _ in range(calls):
        sync(torch, device)
        kx.reset_launches()
        with timed_k1_and_sort(torch) as ev:
            t0 = time.perf_counter()
            p = fused(p0, fsR, 0.0, 0)
            sync(torch, device)
            sec = time.perf_counter() - t0
        rates.append(p0.n * cfg.internal_steps * n_fuse / sec)
    staging = kx.counts()
    return p, {"phase": name, "n": p0.n, "ext_steps": n_fuse,
               "ext_sort_every": cfg.ext_sort_every,
               "launches": kx.ext_step_fused.launches,
               "particle_steps_per_s": rates,
               "k1_ms_per_ext_step": elapsed_ms(ev["k1"]) / n_fuse,
               "sort_ms_per_ext_step": elapsed_ms(ev["sort"]) / n_fuse,
               "sorts": len(ev["sort"]), "staging": staging,
               "staged_share": staged_share(staging)}


def phase12(torch, device):
    """The depth-banded sort (phase12a-d)."""
    t0 = time.perf_counter()
    out = {"a": phase12a(torch, device), "b": phase12b(torch, device),
           "c": phase12c(torch, device), "d": phase12d(torch, device)}
    out["phase_wall_seconds"] = time.perf_counter() - t0
    log({"phase": 12, "phase_wall_seconds": out["phase_wall_seconds"]})
    return out


def bit_equal(torch, name, got, want, **extra):
    """Every column of two runs' particles (pid order) bit for bit."""
    from ltjax_torch import state as st
    og = torch.argsort(got.pid.cpu())
    ow = torch.argsort(want.pid.cpu())
    res = {"phase": name, "n": int(got.n), **extra,
           "unequal_columns": [k for k in st.FIELDS if not torch.equal(
               getattr(got, k).cpu()[og], getattr(want, k).cpu()[ow])]}
    log(res)
    assert not res["unequal_columns"], res
    return res


def phase12a(torch, device, n=65536, n_ext=2):
    """Banded against unbanded, bit for bit, at 65,536 particles on the
    sheared case: K1 in float32 and float64 (3 bands of 16 m and 4 log
    bands, sorted every step), the per-step route with stochastic
    mortality (the same DEAD pids), and 2 gloo tiles (1, 2) on the card
    with bands against the single unbanded rank."""
    from dataclasses import replace
    from ltjax_torch import shard, state as st, synth
    from ltjax_torch.kernels import ext_step as kx, rk4_step as kr
    from ltjax_torch.kernels import step_lanes as sl
    from ltjax_torch.step import _sort, make_fused_external_steps
    out = {}
    dt = 3600.0
    for dtype in (torch.float32, torch.float64):
        case = sheared_case(torch, device, dtype=dtype)
        ctx = context(case)
        fsR = synth.fieldset_window(case, -dt / 2, dt, n_ext + 2,
                                    device=device)
        p0 = sheared_particles(torch, device, n, dtype)[0]
        plain = make_cfg(n, dtype_pos=dtype_name(dtype), ext_sort_every=1)
        runs = {"none": plain,
                "3x16m": replace(plain, **BAND_SETTINGS["3x16m"]),
                "log4x4m": replace(plain, **BAND_SETTINGS["log4x4m"])}
        if dtype == torch.float32:
            runs["per_step-none"] = replace(plain, **dict(
                STOCHASTIC, deadage=3600.0))
            runs["per_step-3x16m"] = replace(runs["per_step-none"],
                                             **BAND_SETTINGS["3x16m"])
        got, launches = {}, {}
        for key, cfg in runs.items():
            kx.reset_launches()
            kr.rk4_displacement_fused.launches = 0
            sl.step_lanes_fused.launches = 0
            got[key] = make_fused_external_steps(ctx, cfg, n_ext)(
                p0, fsR, 0.0, 0)
            sync(torch, device)
            launches[key] = [kx.ext_step_fused.launches,
                             kr.rk4_displacement_fused.launches,
                             sl.step_lanes_fused.launches]
        tag = dtype_name(dtype)
        for key in ("3x16m", "log4x4m", "per_step-3x16m"):
            if key not in runs:
                continue
            base = "per_step-none" if key.startswith("per_step") else "none"
            reordered = not torch.equal(_sort(case.grid, p0, runs[key])[1],
                                        _sort(case.grid, p0, runs[base])[1])
            dead = int((got[key].status == st.DEAD).sum())
            r = bit_equal(torch, f"12a-{tag}-{key}", got[key], got[base],
                          launches=launches[key], reordered=reordered,
                          dead=dead)
            assert reordered, r
            if device.type == "cuda":
                n_int = n_ext * plain.internal_steps
                assert r["launches"] == ([0, n_int, n_int]
                                         if base.startswith("per_step")
                                         else [n_ext, 0, 0]), r
            if key.startswith("per_step"):
                assert dead > 0.5 * n, r
            out[f"{tag}-{key}"] = r
    # 2 gloo tiles sharing the card, banded, against the unbanded rank
    case = sheared_case(torch, device)
    ctx = context(case)
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_ext + 2, device=device)
    p0 = sheared_particles(torch, device, n, torch.float32)[0]
    plain = make_cfg(n)
    banded = replace(plain, **BAND_SETTINGS["3x16m"])
    ref = make_fused_external_steps(ctx, plain, n_ext)(p0, fsR, 0.0, 0)
    # the fastest water: 5e-5 rad/s at 85 km from the centre, 1 km rows
    halo = shard.halo_rows_needed(5e-5 * 60e3 * np.sqrt(2.0), dt, 1e3)
    spec = shard.make_spec(banded, 200, n, 1, 2, halo=halo, slack=3.0)
    (got, ranks), = shard.run_tiled_steps(
        [shard.TiledCase(ctx, banded, p0, fsR, n_ext, spec, n_fuse=n_ext)],
        device=device, backend="gloo")
    r = bit_equal(torch, "12a-tiles-1x2-3x16m", got, ref,
                  launches=[q["launches"] for q in ranks],
                  migrated=sum(q["sent"] for q in ranks),
                  drops=sum(q["drops"] for q in ranks))
    assert r["drops"] == 0 and r["migrated"] > 0, r
    if device.type == "cuda":
        assert r["launches"] == [n_ext, n_ext], r
    out["tiles"] = r
    return out


def phase12b(torch, device, sizes=((1_000_000, 2), (4_000_000, 1)),
             n_fuse=16, sort_every=(2, 1), nx=200, us=20):
    """K1 on the sheared population at full width: 16 x 30 steps through
    make_fused_external_steps at 1M (about 70 particles a cell) and 4M
    (about 280), for each of BAND_SETTINGS with ext_sort_every 2 and 1:
    particle-steps/s of each call (1M: a cold call and a warm one; 4M:
    the cold call only), K1's and the sort's ms per external step, the
    staging counters and the staged share, and the distance from the
    closed form of the particles between the outer rho levels (the
    closed form knows no bottom log layer and no extrapolation above the
    top level), held to phase 2's tolerance."""
    from dataclasses import replace
    from ltjax_torch import synth
    from ltjax_torch.step import summary_counts
    case = sheared_case(torch, device, nx=nx, us=us)
    ctx = context(case)
    dt = 3600.0
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_fuse + 2, device=device)
    z_rho = (50.0 * case.grid.s_rho).cpu().numpy()
    out = {}
    for n, calls in sizes:
        p0, x0, y0, z0 = sheared_particles(torch, device, n, torch.float32)
        xa, ya, _ = case.analytic(x0, y0, z0, n_fuse * dt)
        inner = (z0 > z_rho.min()) & (z0 < z_rho.max())
        for se in sort_every:
            for bands, kw in BAND_SETTINGS.items():
                cfg = replace(make_cfg(n, us=us, ws=us + 1,
                                       ext_sort_every=se), **kw)
                key = f"12b-{n / 1e6:g}M-{bands}-every{se}"
                p, res = banded_cell(torch, device, key, ctx, cfg, p0, fsR,
                                     n_fuse, calls)
                err = np.hypot(p.x.cpu().numpy() - xa,
                               p.y.cpu().numpy() - ya)
                counts = summary_counts(p)
                res.update({"bands": bands,
                            "max_err_vs_analytic_m": float(err[inner].max()),
                            "max_err_outside_rho_levels_m": float(
                                err[~inner].max()),
                            "outside_rho_levels": int((~inner).sum()),
                            "counts": counts})
                log(res)
                if device.type == "cuda":
                    assert res["launches"] == n_fuse, res
                assert counts["active"] == n, res
                assert np.isfinite(err).all(), res
                assert res["max_err_vs_analytic_m"] < TOL_ANALYTIC, res
                out[key] = res
        del p0, p
    log({"phase": "12b-table", "columns": [
        "cell", "particle_steps_per_s (last call)", "k1_ms_per_ext_step",
        "staged_share", "staged_misses", "sort_ms_per_ext_step"],
        "rows": [[k, r["particle_steps_per_s"][-1], r["k1_ms_per_ext_step"],
                  r["staged_share"], r["staging"]["staged_misses"],
                  r["sort_ms_per_ext_step"]] for k, r in out.items()]})
    return out


def phase12c(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16):
    """Phase 4's turb cell (Visser on the parabolic Aks: band membership
    is transient) at 1M, unbanded and with 3 bands of 16 m, a cold call
    and a warm one each: the numbers of 12b (no closed form)."""
    from dataclasses import replace
    from ltjax_torch import state as st, synth
    from ltjax_torch.step import summary_counts
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False,
                      parabolic_aks=True)
    ctx = context(case)
    dt = 3600.0
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_fuse + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    z0 = np.random.default_rng(1).uniform(-40.0, -5.0, n)
    p0 = st.init_particles(x0, y0, z0, dtype=torch.float32, device=device)
    p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
    out = {}
    for bands in ("none", "3x16m"):
        cfg = replace(make_cfg(n, us=us, ws=us + 1, **LARVAL["turb"]),
                      **BAND_SETTINGS[bands])
        p, res = banded_cell(torch, device, f"12c-turb-{bands}", ctx, cfg,
                             p0, fsR, n_fuse, 2)
        res["counts"] = summary_counts(p)
        res["bands"] = bands
        log(res)
        if device.type == "cuda":
            assert res["launches"] == n_fuse, res
        assert res["counts"]["active"] == n, res
        assert all(bool(torch.isfinite(getattr(p, k)).all())
                   for k in ("x", "y", "z")), res
        out[bands] = res
    return out


def phase12d(torch, device, n=10_000, nx=60, us=10, n_ext=2):
    """The entry point with sort_depth_bands = 3 (16 m, sorted every
    step) on a sheared planar series (float32): ltjax_torch.run.run on the
    ext_step, per-step (stochastic mortality) and native routes writes
    the unbanded run's CSV byte for byte, and so does a (1, 2) mesh of
    gloo ranks on the card; each startup line names its route's path."""
    import dataclasses
    import filecmp
    import shutil
    from ltjax_torch import run, shard, synth
    from ltjax_torch.config import config_from_namelist
    work = os.path.join(ROOT, "build", "chip_smoke_12d")
    shutil.rmtree(work, ignore_errors=True)
    case = synth.make_solid_body_case(nx=nx, ny=nx, us=us, lx=60e3, ly=60e3,
                                      h0=50.0, omega=5e-5, shear_a=SHEAR_A,
                                      dtype=torch.float64)
    rng = np.random.default_rng(5)
    nml = synth.write_run_files(
        case, work, rng.uniform(15e3, 45e3, n), rng.uniform(15e3, 45e3, n),
        rng.uniform(-49.0, -1.0, n), n_ext=n_ext, dt=3600, idt=120,
        iprint=3600, ext_fuse=n_ext, ext_sort_every=1, dtype_pos="float32",
        halo_rows=shard.halo_rows_needed(5e-5 * 30e3 * np.sqrt(2.0),
                                         3600.0, 60e3 / (nx - 1)),
        migrate_capacity=3.0)
    base = config_from_namelist(nml)
    routes = {"ext_step": ({}, "cuda_ext_step"),
              "per_step": (dict(STOCHASTIC, deadage=3600.0),
                           "cuda_rk4_step"),
              "native": (dict(fast_interp=False), "cuda_native")}
    out = {}
    for route, (kw, path) in routes.items():
        csv = {}
        for bands in (1, 3):
            name = f"{route}-{bands}"
            cfg = dataclasses.replace(base, outpath=f"{work}/{name}",
                                      sort_depth_bands=bands,
                                      sort_band_height=16.0, **kw)
            _, lines = capture_fd(lambda: run.run(cfg, device=device))
            csv[bands] = f"{work}/{name}/run1.csv"
            if bands == 3:
                start = lines[0]
        if route == "ext_step":
            cfg = dataclasses.replace(cfg, outpath=f"{work}/mesh-3",
                                      mesh_particles=1, mesh_tiles=2)
            _, lines = capture_fd(lambda: run.run(cfg, device=device,
                                                  backend="gloo"))
            mesh = {"start": {k: lines[0].get(k) for k in (
                "path", "route", "ranks")}, "csv_equal": filecmp.cmp(
                csv[1], f"{work}/mesh-3/run1.csv", shallow=False)}
        r = {"phase": f"12d-{route}", "n": n, "path": start.get("path"),
             "route": start.get("route"),
             "csv_equal": filecmp.cmp(csv[1], csv[3], shallow=False)}
        log(r)
        assert r["csv_equal"] and r["route"] == route, r
        if device.type == "cuda":
            assert r["path"] == path, r
        out[route] = r
    r = {"phase": "12d-mesh-1x2", **mesh}
    log(r)
    assert r["csv_equal"] and r["start"]["ranks"] == 2, r
    if device.type == "cuda":
        assert r["start"]["path"] == "cuda_ext_step", r
    out["mesh"] = r
    return out


# phase 13: the packed route (kernel_interp = False: ltjax's packed scheme,
# per-column fits evaluated on each corner's knots and blended; PyTorch
# ops, no kernel)
TOL_PACKED_H = TOL_NATIVE_H      # m, float64 card vs CPU, per internal step
TOL_PACKED_V = TOL_NATIVE_V
TOL_PACKED_F32_H = TOL_H_STEP    # m, float32 card vs CPU, per internal step
TOL_PACKED_F32_V = TOL_V
PACKED_LANES = {
    "advection": {},
    "turb": dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                 readAks=True),
    "behavior4-salt": dict(SETTLE_SALT["salt"]),
    "behavior7": dict(Behavior=7, mortality=True),
    "settlement": dict(SETTLE_SALT["settle"]),
    "stochastic": dict(STOCHASTIC, deadage=3600.0),
}
# the lanes held on each grid (13a): every lane on the uniform grid
PACKED_GRIDS = {"uniform": tuple(PACKED_LANES),
                "stretched": ("advection", "stochastic"),
                "curvilinear": ("advection", "turb")}


def phase13(torch, device):
    """The packed route (phase13a-c)."""
    return {"a": phase13a(torch, device), "b": phase13b(torch, device),
            "c": phase13c(torch, device)}


def phase13a(torch, device, n=65536, nx=200, us=20):
    """The packed route on the card against the same route on the CPU, one
    internal step from the same state: phase 1's particles (near the
    surface and in the log layer; the uniform grid with its land block,
    the grid on axes stretched x1.002 a cell, bench.py's curvilinear
    grid) with a seeded random w and zeta, the parabolic Aks profile and
    the halocline; every lane of PACKED_LANES on the uniform grid, some
    on the others (PACKED_GRIDS).  float64 (positions, grid and fields):
    |dx|, |dy| <= TOL_PACKED_H,
    |dz| <= TOL_PACKED_V, equal statuses (the same dead pids), salt and
    temp 1e-9; float32 (advection and turb, uniform): TOL_PACKED_F32_H,
    TOL_PACKED_F32_V.  Neither kernel launches.  Then the packed route's
    displacement minus the collapsed route's over one internal step
    (printed, no gate)."""
    from dataclasses import replace
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import ext_step as kx, rk4_step as kr
    from ltjax_torch.step import _sort, internal_step, mode_flags
    cpu = torch.device("cpu")
    out = {}

    def setup(dev, grid, dtype):
        kw = dict(parabolic_aks=True, halocline=True, dtype=dtype)
        if grid == "curvilinear":
            case = curv_bench_case(torch, dev, nx=nx, ny=nx, us=us,
                                   omega=5e-6, **kw)
        else:
            case = bench_case(torch, dev, nx=nx, ny=nx, us=us, omega=5e-6,
                              axes=1.002 if grid == "stretched" else 1.0,
                              **kw)
        fs = synth.with_vertical_motion(synth.fieldset_for(
            case, t_center=0.0, dt=3600.0, dtype=dtype, device=dev), seed=3)
        return case, context(case), fs, pk.build_packed_records(case.grid,
                                                                 fs)

    runs = [(g, lane, torch.float64) for g, lanes in PACKED_GRIDS.items()
            for lane in lanes]
    runs += [("uniform", lane, torch.float32) for lane in ("advection",
                                                            "turb")]
    built = {}
    for grid, lane, dtype in runs:
        if (grid, dtype) not in built:
            built[grid, dtype] = (setup(device, grid, dtype),
                                  setup(cpu, grid, dtype)[1:])
        (case, ctx, fs, prec), (ctx_c, fs_c, prec_c) = built[grid, dtype]
        if grid == "curvilinear":
            x, y, _ = curv_water_particles(case, n, seed=1)
        else:
            x, y, _ = water_particles(case, n, 2e3, 198e3, seed=1)
        z = near_surface_and_bottom(n, case.h0, seed=4)
        p = st.init_particles(x, y, z, dtype=dtype, device=device)
        p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
        p, _ = _sort(case.grid, p)
        cfg = make_cfg(n, us=us, ws=us + 1, dtype_pos=dtype_name(dtype),
                       TrackCollisions=True, kernel_interp=False,
                       **PACKED_LANES[lane])
        if cfg.settlementon:
            ctx, ctx_c = with_polygons(ctx), with_polygons(ctx_c)
        assert mode_flags(ctx, cfg) == "packed", lane
        kx.reset_launches()
        kr.rk4_displacement_fused.launches = 0
        a = internal_step(ctx, cfg, 5, p, fs, 0.0, 0, prec, mode="packed")
        b = internal_step(ctx_c, cfg, 5, p.to(cpu), fs_c, 0.0, 0, prec_c,
                          mode="packed")
        sync(torch, device)
        name = f"13a-{grid}-{lane}-{dtype_name(dtype)}"
        same = (a.status.cpu() == b.status).numpy()
        res = {"phase": name, "n": n, "launches": kx.ext_step_fused.launches
               + kr.rk4_displacement_fused.launches,
               "status_mismatch": int((~same).sum()),
               "status_counts": np.bincount(b.status.numpy(),
                                            minlength=6).tolist(),
               "max_vertical_move_m": float((b.z - p.z.cpu()).abs().max())}
        for k in ("x", "y", "z", "salt", "temp"):
            d = (getattr(a, k).cpu() - getattr(b, k)).abs().numpy()
            res["max_abs_d" + k] = float(d[same].max(initial=0.0))
        for k in ("hit_land", "hit_bottom", "settle_poly"):
            res[k + "_mismatch"] = int((getattr(a, k).cpu()
                                        != getattr(b, k)).sum())
        log(res)
        f64 = dtype == torch.float64
        tol_h = TOL_PACKED_H if f64 else TOL_PACKED_F32_H
        tol_v = TOL_PACKED_V if f64 else TOL_PACKED_F32_V
        assert a.x.device.type == device.type and a.x.dtype == dtype, res
        assert res["launches"] == 0, res
        assert max(res["max_abs_dx"], res["max_abs_dy"]) <= tol_h, res
        assert res["max_abs_dz"] <= tol_v, res
        assert max(res["max_abs_dsalt"], res["max_abs_dtemp"]) <= (
            1e-9 if f64 else TOL_SALT), res
        assert res["status_mismatch"] == 0, res
        assert res["settle_poly_mismatch"] == 0, res
        assert res["max_vertical_move_m"] > 0.1, res
        if lane == "stochastic":
            assert res["status_counts"][st.DEAD] > 0, res
        if lane == "settlement":
            assert res["status_counts"][st.SETTLED] > 0, res
        out[name] = res
    (case, ctx, fs, prec), _ = built["uniform", torch.float64]
    x, y, _ = water_particles(case, n, 2e3, 198e3, seed=1)
    p = st.init_particles(x, y, near_surface_and_bottom(n, case.h0, seed=4),
                          dtype=torch.float64, device=device)
    p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
    cfg = make_cfg(n, us=us, ws=us + 1, dtype_pos="float64")
    a = internal_step(ctx, replace(cfg, kernel_interp=False), 5, p, fs, 0.0,
                      0, prec, mode="packed")
    b = internal_step(ctx, cfg, 5, p, fs, 0.0, 0, prec, mode="collapsed")
    out["packed_minus_collapsed"] = {
        "phase": "13a-packed-minus-collapsed", "internal_steps": 1,
        **{"max_abs_d" + k: float((getattr(a, k) - getattr(b, k)).abs()
                                  .max()) for k in ("x", "y", "z")}}
    log(out["packed_minus_collapsed"])
    return out


def phase13b(torch, device, n=1_000_000, nx=200, us=20, n_ext=2,
             prof_steps=2):
    """The main path's cell with kernel_interp = False: phase 2's case
    (the 200x200x20 bench grid, 1M particles, the closed form) in float32
    and float64, n_ext external steps x 30 internal steps through
    make_fused_external_steps (Hilbert-sorted as the route sorts): no
    kernel launched, particle-steps/s, the peak of device memory, the
    closed form within TOL_ANALYTIC, and the largest gap to K1's
    collapsed scheme on the same particles (phase 2's route, run here);
    per internal step the wall and device ms, the idle share and the top
    device kernels (route_profile) on the sorted batch."""
    from dataclasses import replace
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.step import _sort, fieldset_slice, summary_counts
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = dtype_name(dtype)
        case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False,
                          dtype=None if dtype == torch.float32 else dtype)
        ctx = context(case)
        cfg0 = make_cfg(n, us=us, ws=us + 1, dtype_pos=name)
        cfg = replace(cfg0, kernel_interp=False)
        dt = float(cfg0.dt)
        fsR = synth.fieldset_window(case, -dt / 2, dt, n_ext + 2,
                                    device=device)
        rng = np.random.default_rng(0)
        x0 = rng.uniform(40e3, 160e3, n)
        y0 = rng.uniform(40e3, 160e3, n)
        z0 = rng.uniform(-40.0, -5.0, n)
        p0 = st.init_particles(x0, y0, z0, dtype=dtype, device=device)
        p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
        pk1, sec_k1, launches_k1, _ = fused_cell(torch, ctx, cfg0, p0, fsR,
                                                  n_ext, warm=False)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        before = (torch.cuda.memory_allocated()
                  if device.type == "cuda" else 0)
        p, sec, launches, _ = fused_cell(torch, ctx, cfg, p0, fsR, n_ext,
                                         warm=False)
        peak = (torch.cuda.max_memory_allocated()
                if device.type == "cuda" else 0)
        counts = summary_counts(p)
        xa, ya, _ = case.analytic(x0, y0, z0, n_ext * dt)
        err = np.hypot(p.x.cpu().numpy() - xa, p.y.cpu().numpy() - ya)
        steps = n * cfg.internal_steps * n_ext
        f3 = fieldset_slice(fsR, 0)
        ps, _ = _sort(case.grid, p0, cfg)
        r = {"phase": f"13b-{name}", "n": n, "ext_steps": n_ext,
             "internal_steps": cfg.internal_steps, "launches": launches,
             "seconds": sec, "particle_steps_per_s": steps / sec,
             "k1_seconds": sec_k1, "k1_launches": launches_k1,
             "k1_particle_steps_per_s": steps / sec_k1,
             "memory_before_gb": before / 1e9, "peak_memory_gb": peak / 1e9,
             "max_err_vs_analytic_m": float(err.max()), "counts": counts,
             "max_gap_to_k1_h_m": float(torch.hypot(p.x - pk1.x,
                                                    p.y - pk1.y).max()),
             "max_gap_to_k1_v_m": float((p.z - pk1.z).abs().max()),
             "profile": route_profile(torch, ctx, cfg, ps, f3, prof_steps,
                                      mode="packed",
                                      prec=pk.build_packed_records(
                                          case.grid, f3))}
        log(r)
        assert launches == {}, r
        assert p.x.dtype == dtype, r
        assert counts["error"] == 0 and counts["active"] == n, r
        assert np.isfinite(err).all() and err.max() < TOL_ANALYTIC, r
        assert r["max_gap_to_k1_h_m"] < TOL_H, r
        assert r["max_gap_to_k1_v_m"] < TOL_V, r
        out[name] = r
    return out


def phase13c(torch, device, n=10_000, nx=60, us=10, n_ext=4):
    """The entry point with kernel_interp = False on phase 3's planar
    series (float32 positions): ltjax_torch.run.run on the card (startup
    line: route "packed", path "cuda_packed", no kernel launched) against
    the same run on the CPU, the final CSV rows' ids, statuses and polys
    equal and positions within 13a's float32 gates (lon/lat, depth: the
    CSV's 4 decimals); with checkpoint_every = 2, a run resumed from the
    first checkpoint after the last was deleted ends with the
    uninterrupted run's particles (every column equal); and a (1, 2)
    mesh of gloo ranks on the card writes the single rank's CSV byte for
    byte."""
    import dataclasses
    import filecmp
    import shutil
    from ltjax_torch import checkpoint as ckpt, run, shard, synth
    from ltjax_torch.config import config_from_namelist
    from ltjax_torch.kernels import ext_step as kx, rk4_step as kr
    work = os.path.join(ROOT, "build", "chip_smoke13")
    shutil.rmtree(work, ignore_errors=True)
    case = synth.make_solid_body_case(nx=nx, ny=nx, us=us, lx=60e3, ly=60e3,
                                      h0=50.0, omega=5e-5,
                                      dtype=torch.float64)
    rng = np.random.default_rng(2)
    nml = synth.write_run_files(
        case, work, rng.uniform(15e3, 45e3, n), rng.uniform(15e3, 45e3, n),
        rng.uniform(-40.0, -5.0, n), n_ext=n_ext, dt=3600, idt=120,
        iprint=3600 * n_ext, ext_fuse=2, dtype_pos="float32",
        kernel_interp=False, checkpoint_every=2,
        checkpoint_dir=os.path.join(work, "ckpt"),
        halo_rows=shard.halo_rows_needed(5e-5 * 30e3 * np.sqrt(2.0),
                                         3600.0, 60e3 / (nx - 1)),
        migrate_capacity=3.0)
    base = config_from_namelist(nml)

    def go(name, dev, resume=False, ckpt_of=None, **kw):
        cfg = dataclasses.replace(
            base, outpath=f"{work}/{name}",
            checkpoint_dir=f"{work}/{ckpt_of or name}/ckpt", **kw)
        kx.reset_launches()
        kr.rk4_displacement_fused.launches = 0
        backend = "gloo" if cfg.mesh_tiles > 1 else None
        _, lines = capture_fd(lambda: run.run(cfg, resume=resume, device=dev,
                                              backend=backend))
        rows = np.loadtxt(f"{work}/{name}/run1.csv", delimiter=",")
        last = rows[rows[:, 0] == rows[:, 0].max()]
        return (lines, last[np.argsort(last[:, 1])],
                kx.ext_step_fused.launches
                + kr.rk4_displacement_fused.launches)

    card, card_rows, launches = go("card", device)
    _, cpu_rows, _ = go("cpu", "cpu")
    full = ckpt.load(f"{work}/card/ckpt/ckpt_{n_ext}.npz")
    os.remove(f"{work}/card/ckpt/ckpt_{n_ext}.npz")
    resumed, _, _ = go("resumed", device, resume=True, ckpt_of="card")
    again = ckpt.load(f"{work}/card/ckpt/ckpt_{n_ext}.npz")
    equal = {k: bool(torch.equal(getattr(full[0], k), getattr(again[0], k)))
             for k in ("x", "y", "z", "status", "age", "dob", "pid",
                       "settle_poly", "hit_land", "hit_bottom")}
    mesh, _, _ = go("mesh", device, mesh_tiles=2)
    start = card[0]
    res = {"phase": "13c", "n": n, "path": start["path"],
           "route": start["route"], "launches": launches,
           "counts": card[-1],
           "max_abs_dlonlat_m": float(np.abs(card_rows[:, 2:4]
                                             - cpu_rows[:, 2:4]).max()),
           "max_abs_ddepth_m": float(np.abs(card_rows[:, 4]
                                            - cpu_rows[:, 4]).max()),
           "ids_status_poly_equal": bool(np.array_equal(
               card_rows[:, [1, 5, -1]], cpu_rows[:, [1, 5, -1]])),
           "resumed_from": resumed[1]["ext"], "resumed_equal": equal,
           "mesh_ranks": mesh[0].get("ranks"),
           "mesh_csv_equal": filecmp.cmp(f"{work}/card/run1.csv",
                                         f"{work}/mesh/run1.csv",
                                         shallow=False)}
    log(res)
    want = "cuda_packed" if device.type == "cuda" else "plain"
    assert start["route"] == "packed" and start["path"] == want, res
    assert res["launches"] == 0 and res["counts"]["error"] == 0, res
    assert res["ids_status_poly_equal"] and card_rows.shape[0] == n, res
    assert res["max_abs_dlonlat_m"] <= TOL_PACKED_F32_H, res
    assert res["max_abs_ddepth_m"] <= TOL_PACKED_F32_V + 1e-4, res
    assert res["resumed_from"] == 2 and all(equal.values()), res
    assert res["mesh_ranks"] == 2 and res["mesh_csv_equal"], res
    return res


def profile_cells(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16):
    """Where the time goes (``--profile``): each bench.py variant at 1M
    particles, 16 x 30 steps through make_fused_external_steps on phase
    2's grid and window (settle with phase 6's polygons, salt on its
    halocline, curv on phase 7's curvilinear grid, stochastic on the
    per-step route, its kernel the RK4 kernel), and phase 9's cells
    (advect-f64 in float64, advect-axes on stretched axes, curv-stochastic
    on the curvilinear grid through the per-step route): a cold call, three
    timed warm calls, then torch.profiler over one more warm call: the
    kernel's device time (K1, or on the per-step route K2, and there K3's
    beside it), all device time, the wall time, the kernel's share of
    device time and the idle share of the call (1 - device time / wall
    time)."""
    from ltjax_torch import state as st, synth
    from ltjax_torch.step import make_fused_external_steps, mode_flags
    case = bench_case(torch, device, nx=nx, ny=nx, us=us, land=False,
                      parabolic_aks=True, halocline=True)
    dt = 3600.0
    fsR = synth.fieldset_window(case, -dt / 2, dt, n_fuse + 2, device=device)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(40e3, 160e3, n)
    y0 = rng.uniform(40e3, 160e3, n)
    out = {}
    curv = curv_bench_case(torch, device, nx=nx, ny=nx, us=us, land=False)
    grids = {"curv": curv,
             "f64": bench_case(torch, device, nx=nx, ny=nx, us=us,
                               land=False, dtype=torch.float64),
             "axes": bench_case(torch, device, nx=nx, ny=nx, us=us,
                                land=False, axes=AXES_STRETCH)}
    windows = {k: synth.fieldset_window(c, -dt / 2, dt, n_fuse + 2,
                                        device=device)
               for k, c in grids.items()}
    cells = {"advect": {}, **LARVAL, **SETTLE_SALT, "curv": {},
             "stochastic": STOCHASTIC, "advect-f64": {}, "advect-axes": {},
             "curv-stochastic": STOCHASTIC}
    for name, kw in cells.items():
        key = next((k for k in grids if name.startswith(k)
                    or name.endswith(k)), None)
        ctx = context(grids[key] if key else case)
        fs_cell = windows[key] if key else fsR
        if kw.get("settlementon"):
            ctx = with_polygons(ctx)
        dtype = torch.float64 if key == "f64" else torch.float32
        cfg = make_cfg(n, us=us, ws=us + 1, dtype_pos=dtype_name(dtype),
                       **kw)
        z0 = np.random.default_rng(1).uniform(
            -25.0 if name in ("behavior", "settle", "stochastic",
                              "curv-stochastic") else -40.0, -5.0, n)
        p0 = st.init_particles(x0, y0, z0, dtype=dtype, device=device)
        p0 = p0.replace(status=torch.full_like(p0.status, st.ACTIVE))
        fused = make_fused_external_steps(ctx, cfg, n_fuse)
        fused(p0, fs_cell, 0.0, 0)
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            fused(p0, fs_cell, 0.0, 0)
            torch.cuda.synchronize()
            rates.append(n * cfg.internal_steps * n_fuse
                         / (time.perf_counter() - t0))
        per_step = mode_flags(ctx, cfg) == "per_step"
        n_kern = n_fuse * (cfg.internal_steps if per_step else 1)
        dev_ev, wall, windows, _ = profile_window(
            torch, lambda: fused(p0, fs_cell, 0.0, 0),
            {"rk4_step_kernel" if per_step else "ext_step_kernel": n_kern,
             "step_lanes_kernel": n_kern if per_step else 0})
        all_ms = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
        kern = [e for e in dev_ev if ("rk4_step_kernel" if per_step
                                      else "ext_step_kernel") in e.name]
        kern_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        lanes = [e for e in dev_ev if "step_lanes_kernel" in e.name]
        res = {"profile": name, "n": n, "ext_steps": n_fuse,
               "kernel_launches": len(kern), "kernel_device_ms": kern_ms,
               "lanes_launches": len(lanes),
               "lanes_device_ms": sum(e.time_range.elapsed_us()
                                      for e in lanes) / 1e3,
               "all_device_ms": all_ms, "wall_ms": wall,
               "profiled_windows": windows,
               "kernel_share_of_device": kern_ms / all_ms,
               "idle_share": 1.0 - all_ms / wall,
               "warm_rates": rates}
        log(res)
        assert len(kern) == n_kern, res
        assert len(lanes) == (n_kern if per_step else 0), res
        out[name] = res
    return out


def lanes_variant(kw=None, **geometry):
    """K3's build for STOCHASTIC (updated with ``kw``) on a geometry of
    ext_step.kernel_variant: the whole-step kernel's flags less
    LTX_MORTALITY."""
    from ltjax_torch.kernels import ext_step as kx
    v = kx.kernel_variant(make_cfg(1, **{**STOCHASTIC, **(kw or {})}),
                          **geometry)
    del v["LTX_MORTALITY"]
    return v


def kernel_targets():
    """Every kernel library the phases run, as (source, variant) pairs
    for build.prebuild: the whole-step kernel in each variant, the
    per-step RK4 kernel and the per-step lanes kernel."""
    from ltjax_torch.kernels import ext_step as kx
    cfgs = [make_cfg(1, **kw) for kw in [
        {}, *LARVAL.values(), *LANE_CHECKS.values(), *SETTLE_SALT.values(),
        *({**SWIM, **kw} for kw in LANE_CHECKS6.values()), OYSTER_CLI]]
    variants = [kx.kernel_variant(c) for c in cfgs] + [
        kx.kernel_variant(make_cfg(1, **{**SWIM, **kw}), curv=True)
        for kw in [{}, *CURV_LANES.values()]] + [
        kx.kernel_variant(make_cfg(1), pos64=True),
        kx.kernel_variant(make_cfg(1), axes=True),
        kx.kernel_variant(make_cfg(1), pos64=True, axes=True)] + [
        # phase 11's tiles
        kx.kernel_variant(make_cfg(1), tile=True),
        kx.kernel_variant(make_cfg(1), pos64=True, tile=True),
        kx.kernel_variant(make_cfg(1), axes=True, tile=True)]
    return [("ext_step", v) for v in variants] + [
        ("rk4_step", v or None) for v in (
            {}, {"LTX_POS64": 1}, {"LTX_AXES": 1},
            {"LTX_AXES": 1, "LTX_POS64": 1}, {"LTX_CURV": 1},
            {"LTX_CURV": 1, "LTX_POS64": 1}, {"LTX_TILE": 1},
            {"LTX_POS64": 1, "LTX_TILE": 1})] + [
        ("step_lanes", lanes_variant(kw, **geo)) for kw, geo in (
            (None, {}), (None, {"pos64": True}), (None, {"axes": True}),
            (None, {"curv": True}), (None, {"tile": True}),
            (None, {"pos64": True, "tile": True}),
            *((kw, {}) for kw in list(LANES8.values())[1:]))]


def staging_report(targets, us=20, ws=21):
    """Per whole-step library at the bench shape (us 20, ws 21): the
    record lanes it reads, its dynamic shared memory per block (three
    tiles of tile_points points) and the blocks one SM holds (occupancy
    calculator)."""
    from ltjax_torch import packed as pk
    from ltjax_torch.kernels import build, ext_step as kx
    nv = pk.n_value_lanes(us, ws)
    out = {}
    for name, v in targets:
        if name != "ext_step":
            continue
        salt = v.get("LTX_SALT") or v["LTX_BEHAVIOR"] in (4, 5)
        nl = (nv + (ws if v["LTX_VTURB"] == kx.VTURB_AKS else 0)
              + (2 * us if salt else 0))
        out[build.tag(name, v)] = {"nl": nl, "tile_points": kx.tile_points(nl),
                                   "dynamic_smem_bytes": kx.stage_bytes(nl),
                                   "blocks_per_sm": kx.blocks_per_sm(v, nl)}
    return out


def main(argv=None):
    import torch
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = {int(v) for v in argv[1].split(",")}
    elif argv == ["--profile"]:
        only = set()
    elif argv:
        raise SystemExit("usage: chip_smoke.py [--only 1,2,...,13 | "
                         "--profile]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the GPU path only")
    from ltjax_torch.kernels import build, ext_step as kx
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    targets = kernel_targets()
    build.prebuild(targets)
    log({"build": sorted({name for name, _ in targets}),
         "libraries": len(targets), "seconds": time.perf_counter() - t0,
         "ptxas": {k: v["ptxas"] for k, v in build.report.items()},
         "staging": staging_report(targets)})

    phases = {1: lambda: phase1(torch, device),
              2: lambda: phase2(torch, device),
              3: lambda: (phase3(torch, device),
                          phase3_larval(torch, device),
                          phase3_oyster(torch, device)),
              4: lambda: phase4(torch, device),
              5: lambda: phase5(torch, device),
              6: lambda: phase6(torch, device),
              7: lambda: phase7(torch, device),
              8: lambda: phase8(torch, device),
              9: lambda: phase9(torch, device),
              10: lambda: phase10(torch, device),
              11: lambda: phase11(torch, device),
              12: lambda: phase12(torch, device),
              13: lambda: phase13(torch, device)}
    res, wall = {}, {}
    for k, fn in phases.items():
        if only is None or k in only:
            t0 = time.perf_counter()
            res[k] = fn()
            wall[k] = time.perf_counter() - t0
    if argv == ["--profile"]:
        profile_cells(torch, device)
    log({"phase_wall_seconds": wall})
    if only is not None:
        log({"only": sorted(only), "passed": True})
        return
    (r1, r1s, r1v, r1g), r2, r4, r6, r7, r8, r9 = (res[k] for k in
                                                   (1, 2, 4, 6, 7, 8, 9))
    rk = r2["kernel"]          # timed at the main path's shape (1M)
    errs = ("max_abs_dx", "max_abs_dy", "max_abs_dz", "max_abs_dsalt",
            "max_abs_dtemp")

    def entry(name, launches, err, ms, plain_ms, bound):
        # one launch per external step computes the whole step: no single
        # PyTorch call computes the same function (library_ms null)
        return {"name": f"ext_step_fused[{name}]", "route": "cuda",
                "source": KERNEL_SRC, "replaces": KERNEL_REPLACES,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "library_ms": None}

    kernels = [entry("advect", r2["launches"],
                     max(r.get(k, 0.0) for r in (r1, r1s, r1v, rk,
                                                 *r1g.values())
                         for k in errs),
                     rk["kernel_ms"], rk["plain_ms"], r2["bound"])]
    for name, r in {**r4, **{k: r6[k] for k in SETTLE_SALT}}.items():
        kernels.append(entry(
            name, sum(r["launches"].values()),
            max(r["stepwise"].get(k, 0.0) for k in errs),
            r["kernel_ms_1M"], r["plain_ms_1M"], r["bound"]))
    rc = r7["b"]["kernel"]
    kernels.append(entry(
        "curv", sum(r7["b"]["launches"].values()),
        max(max(r.get(k, 0.0) for r in (r7["a"], rc) for k in errs),
            *(r7[c].get(k, 0.0) for c in ("c-turb", "c-oyster")
              for k in errs)),
        rc["kernel_ms"], rc["plain_ms"], r7["b"]["bound"]))
    # the per-step RK4 kernel: launches of the main path (8b), errors of
    # every comparison with its plain version, times per launch at 1M
    k8 = r8["b"]["kernel"]["1M"]
    rk4_errs = ("max_abs_dx", "max_abs_dy", "max_abs_dz")
    kernels.append({
        "name": "rk4_displacement_fused", "route": "cuda",
        "source": RK4_SRC, "replaces": RK4_REPLACES,
        "launches": r8["b"]["launches"]["rk4_displacement_fused"],
        "max_abs_err": max(r[k] for r in (*(r8[c] for c in r8
                                            if c.startswith("a")),
                                          *r8["b"]["kernel"].values(),
                                          r8["b"]["stepwise"],
                                          r8["c-lanes"]) for k in rk4_errs),
        "ms": k8["kernel_ms"], "plain_ms": k8["plain_ms"],
        "bound_ms": r8["b"]["bound"]["bound_ms"],
        "bound_by": r8["b"]["bound"]["bound_by"], "library_ms": None})
    # phase 9's builds: the launches of their main paths (9b-9e), the
    # errors of every comparison with their plain versions (9a and the
    # first launches), times at 1M on their main paths' inputs
    r9a = r9["a"]
    for name, r, small in (("advect-f64", r9["b"], ("9a-f64", "9a-f64-axes")),
                           ("advect-axes", r9["c"],
                            ("9a-axes", "9a-axes-grid", "9a-f64-axes"))):
        kernels.append(entry(
            name, sum(r["launches"].values()),
            max(q.get(k, 0.0) for q in (r["kernel"],
                                        *(r9a[c] for c in small))
                for k in errs),
            r["kernel"]["kernel_ms"], r["kernel"]["plain_ms"], r["bound"]))
    for name, r, main, small in (
            ("f64", r9["b"], r9["e"]["stochastic"],
             ("9a-rk4-f64", "9a-rk4-f64-axes", "9a-rk4-f64-curv")),
            ("axes", r9["c"], r9["c-stochastic"],
             ("9a-rk4-axes", "9a-rk4-f64-axes")),
            ("curv", r9["d"], r9["d"],
             ("9a-rk4-curv", "9a-rk4-f64-curv"))):
        k1m = r["rk4"]["1M"] if "1M" in r["rk4"] else r["rk4"]
        comps = [k1m, *(r9a[c] for c in small)]
        if "stepwise" in main:
            comps.append(main["stepwise"])
        kernels.append({
            "name": f"rk4_displacement_fused[{name}]", "route": "cuda",
            "source": RK4_SRC, "replaces": RK4_REPLACES,
            "launches": sum(v for k, v in main["launches"].items()
                            if k.startswith("rk4_step")),
            "max_abs_err": max(q[k] for q in comps for k in rk4_errs),
            "ms": k1m["kernel_ms"], "plain_ms": k1m["plain_ms"],
            "bound_ms": r["rk4_bound"]["bound_ms"],
            "bound_by": r["rk4_bound"]["bound_by"], "library_ms": None})
    # the per-step lanes kernel K3: launches of the main paths (8b; 9c,
    # 9d, 9e), the errors of every comparison with its plain version, times
    # per launch at 1M on the main paths' first internal step
    lane_errs = errs + ("max_abs_dage",)
    for name, main, launches, comps in (
            ("", r8["b"]["lanes"]["1M"], r8["b"]["launches"]["step_lanes"],
             [r8[c] for c in r8 if c.startswith("a-lanes")]
             + list(r8["b"]["lanes"].values())),
            ("[axes]", r9["c-stochastic"]["lanes"],
             r9["c-stochastic"]["launches"][
                 r9["c-stochastic"]["lanes_variant"]], []),
            ("[curv]", r9["d"]["lanes"],
             r9["d"]["launches"][r9["d"]["lanes_variant"]], []),
            ("[f64]", r9["b"]["lanes"],
             r9["e"]["stochastic"]["launches"]["step_lanes-b6h0p1v0"], [])):
        kernels.append({
            "name": "step_lanes_fused" + name, "route": "cuda",
            "source": LANES_SRC, "replaces": LANES_REPLACES,
            "launches": launches,
            "max_abs_err": max(q[k] for q in [main, *comps]
                               for k in lane_errs),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound"]["bound_ms"],
            "bound_by": main["bound"]["bound_by"], "library_ms": None})
    log({"kernels": kernels})
    log(card)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
