#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ltjax_torch) once on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --only 4,5 # some phases (no summary lines)
    python3 chip_smoke.py --profile  # where the time goes, per bench cell

Builds the variants of the external-step CUDA kernel and the per-step
RK4 kernel from ltjax_torch/kernels/csrc (one nvcc each, all started
together), then runs eight phases and fails (non-zero exit, no final
line) if any of them fails:

1. the kernel against its plain PyTorch version on the card: one
   external step (30 internal steps) of 65,536 particles on the
   200x200x20 bench grid with a land block (reflection) and an open rim
   (exits), particles near the surface and in the bottom log layer; then
   the same with a seeded random w and zeta, internal step by internal
   step (w fit, surface and bottom reflection);
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
8. stochastic mortality through the per-step route (the per-internal-
   step RK4 kernel and the PyTorch lanes): the RK4 kernel against its
   plain version at 65,536 particles on phase 1's inputs and its random-w
   case; bench.py's behavior cell with stochastic mortality at 1M (16 x
   30 steps through make_fused_external_steps: 480 RK4 launches and none
   of the whole-step kernel, timed, the dead share against 1 -
   exp(-t/deadage), the circles), per internal step against the plain
   route, the RK4 kernel timed at 1M and 65,536, and the internal step
   split by the profiler; the oyster CLI run with stochastic mortality in
   chunks of 2 and 4, and its lanes per step at 65,536.

Stdout carries the card's name and power limit, the build report, each
phase's numbers and its wall time, then the per-kernel JSON summary
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
               omega=5e-5, parabolic_aks=False, halocline=False):
    """The bench.py advect case (200 km square, solid-body rotation,
    omega 5e-5, h0 50 m), optionally with a land block in its path,
    bench.py's turb-variant Aks profile and the synthetic halocline
    (salt and temperature, synth.halocline_fields)."""
    from ltjax_torch import synth
    return synth.make_solid_body_case(nx=nx, ny=ny, us=us, lx=200e3,
                                      ly=200e3, h0=50.0, omega=omega,
                                      dtype=torch.float32, device=device,
                                      mask=land_mask(nx, ny, land),
                                      parabolic_aks=parabolic_aks,
                                      halocline=halocline)


def land_mask(nx, ny, land):
    mask = np.ones((ny, nx), np.int32)
    if land:
        # a 16 x 10 cell island east of the centre, in the rotation path
        mask[int(0.47 * ny):int(0.52 * ny), int(0.62 * nx):int(0.70 * nx)] = 0
    return mask


def curv_bench_case(torch, device, nx=200, ny=200, us=20, land=True,
                    omega=5e-5, parabolic_aks=False, halocline=False):
    """bench.py's curv case (the 200 km square distorted by 3%, solid-body
    rotation, omega 5e-5, h0 50 m), optionally with phase 1's land block,
    the turb-variant Aks profile and the halocline."""
    from ltjax_torch import synth
    return synth.make_curv_case(nx=nx, ny=ny, us=us, lx=200e3, ly=200e3,
                                h0=50.0, omega=omega, amp=0.03,
                                mask=land_mask(nx, ny, land),
                                dtype=torch.float32, device=device,
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
        i = np.clip(np.rint((x - xa[0]) / (xa[1] - xa[0])).astype(int), 0,
                    len(xa) - 1)
        j = np.clip(np.rint((y - ya[0]) / (ya[1] - ya[0])).astype(int), 0,
                    len(ya) - 1)
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
    out = kx.ext_step_fused(ctx, cfg, p, prec, 0.0)
    if p.x.device.type == "cuda":
        torch.cuda.synchronize()
    res = {"phase": phase, "n": p.n, **compare(phase, p, out, ref)}
    ms = plain_ms = None
    if p.x.device.type == "cuda":
        ms = cuda_time(torch, lambda: kx.ext_step_fused(ctx, cfg, p, prec,
                                                        0.0), reps)
        plain_ms = cuda_time(torch, lambda: kx.ext_step_reference(
            ctx, cfg, p, prec, 0.0), plain_reps)
    res.update({
        "status_counts_plain": np.bincount(ref.status.cpu().numpy(),
                                           minlength=6).tolist(),
        "hit_land_plain": int(ref.hit_land.sum()),
        "hit_bottom_plain": int(ref.hit_bottom.sum()),
        "kernel_ms": ms, "plain_ms": plain_ms})
    log(res)
    check(res, p.n)
    return res


def kernel_vs_plain_stepwise(torch, phase, ctx, cfg, p, prec):
    """The internal steps of one external step, each launched on its own
    (cfg.dt = cfg.idt) from the plain trajectory's state, kernel against
    plain at every step.  With random w the whole-step comparison is
    ill-conditioned: near the bottom the log layer turns round-off in z
    into metres of horizontal drift, which moves w, so f32 against f64 of
    the plain version alone differs by hundreds of metres after 30 steps.
    Step by step both sides start from the same state."""
    from dataclasses import replace
    from ltjax_torch.kernels import ext_step as kx
    cfg1 = replace(cfg, dt=cfg.idt)
    idt = float(cfg.idt)
    res = {"phase": phase, "n": p.n, "steps": cfg.internal_steps,
           "max_abs_dx": 0.0, "max_abs_dy": 0.0, "max_abs_dz": 0.0,
           "status_mismatch": 0, "hit_land_mismatch": 0,
           "hit_bottom_mismatch": 0, "hit_bottom_plain": 0,
           "surface_crossings_plain": 0}
    q = p
    for i in range(cfg.internal_steps):
        t = i * idt
        out = kx.ext_step_fused(ctx, cfg1, q, prec, t)
        ref = kx.ext_step_reference(ctx, cfg1, q, prec, t)
        r = compare(phase, q, out, ref)
        check(r, p.n)                  # per-step bounds
        for k, v in r.items():
            res[k] = (max(res.get(k, 0.0), v) if k.startswith("max")
                      else res.get(k, 0) + v)
        res["hit_bottom_plain"] += int((ref.hit_bottom - q.hit_bottom).sum())
        res["surface_crossings_plain"] += surface_crossings(ctx, cfg1, q,
                                                           prec, t)
        q = ref
    res["max_vertical_move_plain_m"] = float((q.z - p.z).abs().max())
    res["status_counts_plain"] = np.bincount(q.status.cpu().numpy(),
                                             minlength=6).tolist()
    log(res)
    return res


def lanes_stepwise(torch, phase, ctx, cfg, p, prec, fields, t0, steps,
                   seed=5, per_step=False):
    """The stochastic, settlement and salt lanes, internal step by
    internal step from the plain trajectory's state (cfg.dt = cfg.idt;
    step i draws with step index i): horizontal TOL_H_STEP, vertical
    TOL_V, age 1e-3 s, salt and temp TOL_SALT, equal statuses and
    settle_poly, hit_land / hit_bottom mismatches <= 0.01%.

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
        flip = ((((out.x - ref.x).abs() > TOL_H_STEP)
                 | ((out.y - ref.y).abs() > TOL_H_STEP)
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
        check(r, p.n, TOL_H_STEP, strict_status=True)
        assert r["max_abs_dage"] <= 1e-3, r
        for k, v in r.items():
            res[k] = max(res[k], v) if k.startswith("max") else res[k] + v
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
    """Kernel vs plain version on the same inputs, two checks.

    1. One external step (30 internal steps in one launch, timed) of
       solid-body rotation with the land block (reflection) and the open
       rim (exits); a third of the particles 0.1-1 m above the bottom,
       in the log layer, a third within a metre of the surface.
    2. Rotation ten times slower (<= 0.7 m/s) with a seeded random w
       (+-5 mm/s) and zeta (std 0.3 m), step by step: the w-ladder fit,
       the zeta-moved knots and the surface and bottom reflections.

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
    p = st.init_particles(x, y, z, dtype=torch.float32, device=device)
    p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
    p, _ = _sort(case.grid, p)         # as the main path hands it over
    res = kernel_vs_plain(torch, 1, ctx, cfg, p,
                          pk.build_packed_records(case.grid, fs), reps, 2)
    # the land block and the open rim were both exercised
    assert res["hit_land_plain"] > 0, res
    assert res["status_counts_plain"][st.OUT_OF_DOMAIN] > 0, res

    slow = bench_case(torch, device, nx=nx, ny=nx, us=us, omega=5e-6)
    prec_v = pk.build_packed_records(case.grid, synth.with_vertical_motion(
        synth.fieldset_for(slow, t_center=0.0, dt=3600.0, device=device),
        seed=3))
    res_v = kernel_vs_plain_stepwise(torch, "1-vertical", ctx, cfg, p,
                                     prec_v)
    # the bottom and the surface were both hit, and particles moved
    assert res_v["hit_bottom_plain"] > 0, res_v
    assert res_v["surface_crossings_plain"] > 0, res_v
    assert res_v["max_vertical_move_plain_m"] > 1.0, res_v
    return res, res_v


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
    kx.ext_step_fused.launches = 0
    t0 = time.perf_counter()
    p = fused(p0, fsR, 0.0, 0)
    sync()
    sec_on = time.perf_counter() - t0
    launches = kx.ext_step_fused.launches

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
           "counts": counts}
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
    log({"phase": 2, "bound": res["bound"]})
    return res


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


def run_cli(run, nml):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main([nml])
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
        tag = build.tag("ext_step", kx.kernel_variant(cfg))
        counts = summary_counts(p)
        res = {"phase": f"4-{name}", "n": n, "ext_steps": n_fuse,
               "internal_steps": cfg.internal_steps, "variant": tag,
               "launches": launches, "seconds": sec,
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


def rk4_bound(grid, n, stage1=False):
    """The least time the card could take for one launch of rk4_step on n
    particles: the three stage tables read once, x, y, z read and dx, dy,
    dz (and u1, v1) written once, over the HBM rate, against every
    particle's operations (the kernel computes all of them, whatever
    their status) over the f32 rate."""
    from ltjax_torch import packed as pk
    nv = pk.n_value_lanes(grid.us, grid.ws)
    nbytes = 3 * grid.ny * grid.nx * nv * 4 + n * 4 * (6 + 2 * int(stage1))
    f32 = n * rk4_ops(grid.us, grid.ws)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32 / FP32_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "f32_ops": f32, "f64_ops": 0.0}


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


def ops_per_step(cfg, us, ws, curv=False):
    """f32 operations of one active particle's internal step in the
    variant of cfg (integer Threefry words counted at the f32 rate); on
    a curvilinear grid plus its inverse-map solves."""
    stage = 10 + 2 * 31 + fit_ops(us, 2) + fit_ops(ws, 1) + 12
    ops = 4 * stage + 40 + 60 + 82 + 5          # RK4, reflect, vertical
    threefry = 120
    if cfg.HTurbOn:
        ops += threefry + 12
    if cfg.VTurbOn:
        ops += threefry + 4
        if cfg.readAks:
            ops += 72 + fit_ops(ws, 1) + 2 * ws + 2 * (ws + 62 + 20)
    if cfg.Behavior:
        ops += 80
        if cfg.Behavior in (1, 2, 3, 4, 5):
            ops += 2 * threefry + 10
        if cfg.Behavior in (4, 5):
            ops += fit_ops(us, 1)
    if cfg.SaltTempOn:
        ops += fit_ops(us, 2)
    if curv:
        plain, resid = curv_solves(cfg)
        ops += (plain + resid) * CURV_SOLVE_OPS + resid * CURV_RESID_OPS
    return ops


def kernel_bound(cfg, ctx, prec, p_in, p_out):
    """The least time the card could take for one external step of the
    kernel on these inputs: the larger of the bytes it must move (each
    input read once, each output written once) over the HBM rate, and
    its operations over the peak rate of their type.  The work of a
    particle-step is counted only while the particle is active (mean of
    the active counts before and after, as the kernel skips the rest);
    settlement adds the f64 ray cast of each candidate edge of the
    particle's cell, counted at these particles' positions."""
    import torch
    from ltjax_torch import state as st
    from ltjax_torch.kernels import ext_step as kx
    n, n_int = p_in.n, cfg.internal_steps
    act = 0.5 * (int((p_in.status == st.ACTIVE).sum())
                 + int((p_out.status == st.ACTIVE).sum())) * n_int
    cols_in = 7 + (1 if cfg.settlementon else 0) + (2 if cfg.SaltTempOn
                                                     else 0)
    cols_out = cols_in
    nbytes = (prec.tab.numel() * 4 + kx.boundary_rows_table(ctx).numel() * 4
              + n * 4 * (cols_in + cols_out))
    curv = ctx.grid.curv is not None
    if curv:
        xy, seeds, _, _ = kx.curv_tables(ctx)
        nbytes += xy.numel() * 4 + seeds.numel() * 4
    f32 = act * ops_per_step(cfg, ctx.grid.us, ctx.grid.ws, curv)
    f64 = 0.0
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
        f64 = act * (8 + 9 * edges)
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
        tag = build.tag("ext_step", kx.kernel_variant(cfg))
        counts = summary_counts(p)
        res = {"phase": f"6-{name}", "n": n, "ext_steps": n_fuse,
               "internal_steps": cfg.internal_steps, "variant": tag,
               "launches": launches, "seconds": sec,
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
    tag = build.tag("ext_step", kx.kernel_variant(cfg, curv=True))
    counts = summary_counts(pb)
    xa, ya, _ = case.analytic(x0, y0, z0, n_fuse * dt)
    err = np.hypot(pb.x.cpu().numpy() - xa, pb.y.cpu().numpy() - ya)
    rb = {"phase": "7b", "n": n, "ext_steps": n_fuse,
          "internal_steps": cfg.internal_steps, "variant": tag,
          "launches": launches, "seconds": sec,
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


def phase8(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16,
           n_small=65536):
    """Stochastic mortality through the per-step route (the per-internal-
    step RK4 kernel K2 and the PyTorch lanes): (a) K2 against its plain
    version at 65,536 particles on phase 1's inputs and on its random-w
    case; (b) bench.py's behavior cell with stochastic mortality at 1M,
    16 x 30 steps through make_fused_external_steps (launches counted,
    timed, dead share, circles), per internal step against the plain
    route, K2 timed, the internal step split by the profiler; (c) the
    oyster CLI run with stochastic mortality, and its lanes per step at
    65,536."""
    from ltjax_torch import packed as pk, state as st, synth
    from ltjax_torch.kernels import ext_step as kx, rk4_step as kr
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
    t0 = time.perf_counter()
    pb = fused(p0, fsR, 0.0, 0)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"rk4_displacement_fused": kr.rk4_displacement_fused.launches,
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
                           pk.build_packed_records(case.grid, fs), fs, t0,
                           steps=5, per_step=True)
    counts = np.bincount(q.status.cpu().numpy(), minlength=6)
    assert counts[st.DEAD] > 0 and counts[st.SETTLED] > 0, rc
    assert float(q.salt.max() - q.salt.min()) > 1.0, rc
    out["c-lanes"] = rc
    return out


def per_step_profile(torch, ctx, cfg, p, prec, fields):
    """Where an internal step of the per-step route spends the device's
    time: torch.profiler over one warm external step (cfg.internal_steps
    internal steps) for K2's device time (by kernel name) and all device
    time, and over the stage-table builds of those steps alone; the
    PyTorch lanes take the rest.  Idle share: 1 - device time / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ltjax_torch import packed as pk
    from ltjax_torch.step import per_step_external
    idt, n_int = float(cfg.idt), cfg.internal_steps

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        k2 = [e for e in ev if "rk4_step_kernel" in e.name]
        return (sum(e.time_range.elapsed_us() for e in ev) / 1e3,
                sum(e.time_range.elapsed_us() for e in k2) / 1e3, len(k2),
                wall)

    all_ms, k2_ms, k2_n, wall = device_ms(
        lambda: per_step_external(ctx, cfg, p, prec, 0.0, fields, 0))
    tab_ms, _, _, _ = device_ms(
        lambda: [pk.stage_value_tables(ctx.grid, prec, i * idt, idt)
                 for i in range(n_int)])
    res = {"internal_steps": n_int, "k2_launches": k2_n,
           "device_ms": all_ms, "k2_ms": k2_ms, "stage_tables_ms": tab_ms,
           "lanes_ms": all_ms - k2_ms - tab_ms, "wall_ms": wall,
           "idle_share": 1.0 - all_ms / wall,
           "k2_share_of_device": k2_ms / all_ms}
    assert k2_n == n_int, res
    return res


def phase8_cli(torch, device):
    """Phase 3's oyster CLI run with stochastic mortality: the per-step
    route on the card, chunks of 2 and of 4 external steps give the same
    particles, and some die."""
    from ltjax_torch.kernels import ext_step as kx, rk4_step as kr
    kx.reset_launches()
    kr.rk4_displacement_fused.launches = 0
    finals, lines = oyster_cli_runs(torch, "stochastic", OYSTER_STOCHASTIC)
    f = finals[4]
    res = {"phase": "8c", "n": f.shape[0],
           "chunks_identical": bool(np.array_equal(finals[2], finals[4])),
           "path": lines[4][0]["path"], "route": lines[4][0]["route"],
           "lanes": lines[4][0]["lanes"], "counts": lines[4][-1],
           "launches": {"rk4_displacement_fused":
                        kr.rk4_displacement_fused.launches,
                        "ext_step_fused": kx.ext_step_fused.launches}}
    log(res)
    assert res["chunks_identical"] and np.isfinite(f).all(), res
    assert res["path"] == "cuda_rk4_step" and res["route"] == "per_step", res
    assert res["counts"]["dead"] > 0, res
    # both runs: 4 external steps x 30 internal steps each
    assert res["launches"] == {"rk4_displacement_fused": 2 * 4 * 30,
                               "ext_step_fused": 0}, res
    return res


def profile_cells(torch, device, n=1_000_000, nx=200, us=20, n_fuse=16):
    """Where the time goes (``--profile``): each bench.py variant at 1M
    particles, 16 x 30 steps through make_fused_external_steps on phase
    2's grid and window (settle with phase 6's polygons, salt on its
    halocline, curv on phase 7's curvilinear grid, stochastic on the
    per-step route, its kernel the RK4 kernel): a cold call, three
    timed warm calls, then torch.profiler over one more warm call: the
    kernel's device time, all device time, the wall time, the kernel's
    share of device time and the idle share of the call (1 - device time
    / wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    fs_curv = synth.fieldset_window(curv, -dt / 2, dt, n_fuse + 2,
                                    device=device)
    for name, kw in {"advect": {}, **LARVAL, **SETTLE_SALT,
                     "curv": {}, "stochastic": STOCHASTIC}.items():
        ctx = context(curv if name == "curv" else case)
        fs_cell = fs_curv if name == "curv" else fsR
        if kw.get("settlementon"):
            ctx = with_polygons(ctx)
        cfg = make_cfg(n, us=us, ws=us + 1, **kw)
        z0 = np.random.default_rng(1).uniform(
            -25.0 if name in ("behavior", "settle", "stochastic") else -40.0,
            -5.0, n)
        p0 = st.init_particles(x0, y0, z0, dtype=torch.float32,
                               device=device)
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fused(p0, fs_cell, 0.0, 0)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        all_ms = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
        per_step = mode_flags(ctx, cfg) == "per_step"
        kern = [e for e in dev_ev if ("rk4_step_kernel" if per_step
                                      else "ext_step_kernel") in e.name]
        kern_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        res = {"profile": name, "n": n, "ext_steps": n_fuse,
               "kernel_launches": len(kern), "kernel_device_ms": kern_ms,
               "all_device_ms": all_ms, "wall_ms": wall,
               "kernel_share_of_device": kern_ms / all_ms,
               "idle_share": 1.0 - all_ms / wall,
               "warm_rates": rates}
        log(res)
        assert len(kern) == n_fuse * (cfg.internal_steps if per_step
                                      else 1), res
        out[name] = res
    return out


def kernel_targets():
    """Every kernel library the phases run, as (source, variant) pairs
    for build.prebuild: the whole-step kernel in each variant, and the
    per-step RK4 kernel."""
    from ltjax_torch.kernels import ext_step as kx
    cfgs = [make_cfg(1, **kw) for kw in [
        {}, *LARVAL.values(), *LANE_CHECKS.values(), *SETTLE_SALT.values(),
        *({**SWIM, **kw} for kw in LANE_CHECKS6.values()), OYSTER_CLI]]
    variants = [kx.kernel_variant(c) for c in cfgs] + [
        kx.kernel_variant(make_cfg(1, **{**SWIM, **kw}), curv=True)
        for kw in [{}, *CURV_LANES.values()]]
    return [("ext_step", v) for v in variants] + [("rk4_step", None)]


def main(argv=None):
    import torch
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = {int(v) for v in argv[1].split(",")}
    elif argv == ["--profile"]:
        only = set()
    elif argv:
        raise SystemExit("usage: chip_smoke.py [--only 1,2,3,4,5,6,7,8 | "
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
         "ptxas": {k: v["ptxas"] for k, v in build.report.items()}})

    phases = {1: lambda: phase1(torch, device),
              2: lambda: phase2(torch, device),
              3: lambda: (phase3(torch, device),
                          phase3_larval(torch, device),
                          phase3_oyster(torch, device)),
              4: lambda: phase4(torch, device),
              5: lambda: phase5(torch, device),
              6: lambda: phase6(torch, device),
              7: lambda: phase7(torch, device),
              8: lambda: phase8(torch, device)}
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
    (r1, r1v), r2, r4, r6, r7, r8 = (res[k] for k in (1, 2, 4, 6, 7, 8))
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
                     max(r.get(k, 0.0) for r in (r1, r1v, rk) for k in errs),
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
        "max_abs_err": max(r[k] for r in (r8["a"], r8["a-vertical"],
                                          *r8["b"]["kernel"].values(),
                                          r8["b"]["stepwise"],
                                          r8["c-lanes"]) for k in rk4_errs),
        "ms": k8["kernel_ms"], "plain_ms": k8["plain_ms"],
        "bound_ms": r8["b"]["bound"]["bound_ms"],
        "bound_by": r8["b"]["bound"]["bound_by"], "library_ms": None})
    log({"kernels": kernels})
    log(card)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
