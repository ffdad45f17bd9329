#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ltjax_torch) once on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --only 4,5 # some phases (no summary lines)

Builds the variants of the external-step CUDA kernel from
ltjax_torch/kernels/csrc (one nvcc each, all started together), then
runs five phases and fails (non-zero exit, no final line) if any of them
fails:

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
   chunks of 2 and of 4 external steps (identical particles), and a
   diel-vertical-migration run;
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
   particles.

Earlier stdout lines carry the card's name and power limit, the build
report and each phase's numbers; the line before the last is the
per-kernel JSON summary; the last line is
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
               omega=5e-5, parabolic_aks=False):
    """The bench.py advect case (200 km square, solid-body rotation,
    omega 5e-5, h0 50 m), optionally with a land block in its path and
    bench.py's turb-variant Aks profile."""
    from ltjax_torch import synth
    mask = np.ones((ny, nx), np.int32)
    if land:
        # a 16 x 10 cell island east of the centre, in the rotation path
        mask[int(0.47 * ny):int(0.52 * ny), int(0.62 * nx):int(0.70 * nx)] = 0
    return synth.make_solid_body_case(nx=nx, ny=ny, us=us, lx=200e3,
                                      ly=200e3, h0=50.0, omega=omega,
                                      dtype=torch.float32, device=device,
                                      mask=mask, parabolic_aks=parabolic_aks)


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
    bounds = bd.build_boundaries(g.mask_rho.cpu().numpy(),
                                 g.x_rho.cpu().numpy(), g.y_rho.cpu().numpy(),
                                 device=g.device)
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
    input ``p``: max |dx|, |dy|, |dz| over particles of equal status,
    and the status / collision-count mismatches (each logged)."""
    s_ref = ref.status.cpu().numpy()
    s_out = out.status.cpu().numpy()
    same = s_ref == s_out
    res = {"max_abs_d" + k: float(np.abs(
        getattr(out, k).cpu().numpy()[same]
        - getattr(ref, k).cpu().numpy()[same]).max(initial=0.0))
        for k in ("x", "y", "z")}
    res["status_mismatch"] = int((~same).sum())
    for k in ("hit_land", "hit_bottom"):
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
    for k in ("status_mismatch", "hit_land_mismatch", "hit_bottom_mismatch"):
        assert res[k] <= MAX_MISMATCH * n, res
    assert not strict_status or res["status_mismatch"] == 0, res


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
            res[k] = max(res[k], v) if k.startswith("max") else res[k] + v
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
                   seed=5):
    """The stochastic lanes, internal step by internal step from the plain
    trajectory's state (cfg.dt = cfg.idt; step i draws with step index
    i): horizontal TOL_H_STEP, vertical TOL_V, age 1e-3 s, equal
    statuses, hit_land / hit_bottom mismatches <= 0.01%.

    Behaviors 1, 2, 3 and 7 decide by a threshold on a continuous value
    (zone edge, light threshold, riding speed); a particle within
    round-off of it may take the other branch, one swim step (or TST
    ride) away.  Those "decision flips" are counted and allowed for at
    most 0.01% of the particles (as hit-count mismatches are); the other
    particles keep the tolerances.  Turbulence and the other lanes allow
    none."""
    from dataclasses import replace
    from ltjax_torch.kernels import ext_step as kx
    cfg1 = replace(cfg, dt=cfg.idt)
    idt = float(cfg.idt)
    thresholds = cfg.Behavior in (1, 2, 3, 7)
    res = {"phase": phase, "n": p.n, "steps": steps, "max_abs_dx": 0.0,
           "max_abs_dy": 0.0, "max_abs_dz": 0.0, "max_abs_dage": 0.0,
           "status_mismatch": 0, "hit_land_mismatch": 0,
           "hit_bottom_mismatch": 0, "decision_flips": 0}
    q = p
    for i in range(steps):
        t = t0 + i * idt
        out = kx.ext_step_fused(ctx, cfg1, q, prec, t, fields=fields,
                                seed=seed, ext_idx=i)
        ref = kx.ext_step_reference(ctx, cfg1, q, prec, t, fields=fields,
                                    seed=seed, ext_idx=i)
        torch.cuda.synchronize()
        flip = (((out.x - ref.x).abs() > TOL_H_STEP)
                | ((out.y - ref.y).abs() > TOL_H_STEP)
                | ((out.z - ref.z).abs() > TOL_V)) & (out.status == ref.status)
        n_flip = int(flip.sum())
        q_cmp, ref_cmp = q, ref
        if thresholds and 0 < n_flip <= MAX_MISMATCH * p.n:
            for qi in torch.nonzero(flip)[:10, 0].tolist():
                log({"phase": phase, "decision_flip": qi,
                     "z0": float(q.z[qi]), "dz_kernel": float(out.z[qi]
                                                              - q.z[qi]),
                     "dz_plain": float(ref.z[qi] - q.z[qi])})
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
                                                        "plain_ms"))})
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


def main(argv=None):
    import torch
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = {int(v) for v in argv[1].split(",")}
    elif argv:
        raise SystemExit("usage: chip_smoke.py [--only 1,2,3,4,5]")
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
    # every variant the phases run, built together (one nvcc each)
    cfgs = [make_cfg(1)] + [make_cfg(1, **kw) for kw in LARVAL.values()] + [
        make_cfg(1, **kw) for kw in LANE_CHECKS.values()]
    variants = [kx.kernel_variant(c) for c in cfgs]
    t0 = time.perf_counter()
    build.prebuild("ext_step", variants)
    log({"build": "ext_step", "variants": len(variants),
         "seconds": time.perf_counter() - t0,
         "ptxas": {k: v["ptxas"] for k, v in build.report.items()}})

    run = (lambda k: only is None or k in only)
    r1 = r1v = r2 = r4 = None
    if run(1):
        r1, r1v = phase1(torch, device)
    if run(2):
        r2 = phase2(torch, device)
    if run(3):
        phase3(torch, device)
        phase3_larval(torch, device)
    if run(4):
        r4 = phase4(torch, device)
    if run(5):
        phase5(torch, device)
    if only is not None:
        log({"only": sorted(only), "passed": True})
        return
    rk = r2["kernel"]          # timed at the main path's shape (1M)
    kernels = [{
        "name": "ext_step_fused[advect]", "route": "cuda",
        "source": KERNEL_SRC, "replaces": KERNEL_REPLACES,
        "launches": r2["launches"],
        "max_abs_err": max(r[k] for r in (r1, r1v, rk)
                           for k in ("max_abs_dx", "max_abs_dy",
                                     "max_abs_dz")),
        "ms": rk["kernel_ms"], "plain_ms": rk["plain_ms"]}]
    for name, r in r4.items():
        kernels.append({
            "name": f"ext_step_fused[{name}]", "route": "cuda",
            "source": KERNEL_SRC, "replaces": KERNEL_REPLACES,
            "launches": sum(r["launches"].values()),
            "max_abs_err": max(r["stepwise"][k] for k in
                               ("max_abs_dx", "max_abs_dy", "max_abs_dz")),
            "ms": r["kernel_ms_1M"], "plain_ms": r["plain_ms_1M"]})
    log({"kernels": kernels})
    log(card)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
