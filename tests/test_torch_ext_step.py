"""The external-step kernel module: ltjax_torch.kernels.ext_step.

On the CPU ``ext_step_fused`` runs its plain version
(``ext_step_reference``), which is held against

* the JAX Pallas megakernel ``ltjax.kernels.ext_step.ext_step_fused`` in
  interpret mode at f32-exact precision (HIGHEST), on the particles that
  stayed inside their block's window (the JAX kernel's own contract);
* the JAX collapsed-mode scan of ``internal_step``, on every particle.

Setup: tests/test_kernel.py's ext-step case (41x41 grid, us = 6, 256
clustered particles, staggered releases) plus a land block in the flow;
its "vertical-motion" variant turns ten times slower, adds a seeded
random w (+-5 mm/s) and zeta (std 0.3 m) and starts a third of the
particles within a metre of the surface and a third 0.1-1 m above the
bottom (slow flow and the 0.1 m floor keep the log layer's round-off
sensitivity near the bottom far below the tolerance; chip_smoke.py
phase 1 says why).
Tolerances (float32, as tests/test_kernel.py): horizontal 0.5 m,
vertical 1e-3 m; statuses and collision counts equal.  The CUDA kernel
itself is compared with this plain version on the card by
chip_smoke.py (phase 1) and tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import packed as jpk
from ltjax import spatial as jsp
from ltjax import state as jst
from ltjax import synth as jsynth
from ltjax.config import Config
from ltjax.grid import locate as jlocate
from ltjax.kernels import ext_step as jes
from ltjax.physics import boundary as jbd
from ltjax.physics import settlement as jstl
from ltjax.step import StepContext as JContext, internal_step
from ltjax_torch import interop
from ltjax_torch import packed as pk
from ltjax_torch import synth
from ltjax_torch import step as tstep
from ltjax_torch.kernels import ext_step as kx

torch.set_num_threads(1)

TOL_H = 0.5
TOL_V = 1e-3


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _mask(nx=41, ny=41):
    mask = np.ones((ny, nx), np.int32)
    mask[19:22, 21:23] = 0      # x 52.5-55 km, y 47.5-52.5 km
    return mask


@pytest.fixture(scope="module", params=["solid-body", "vertical-motion"])
def setup(request):
    vertical = request.param == "vertical-motion"
    dtype = jnp.float32
    c = jsynth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                    h0=50.0, omega=1e-5 if vertical else 1e-4,
                                    dtype=dtype)
    grid = c.grid._replace(mask_rho=jnp.asarray(_mask()))
    fs = jsynth.fieldset_for(c, t_center=900.0, dt=1800.0, dtype=dtype)
    bounds = jbd.build_boundaries(_mask(), np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    jctx = JContext(grid=grid, bounds=bounds, polys=None, holes=None)
    cfg = Config(numpar=256, dt=1800, idt=450, us=6, ws=7,
                 OpenOceanBoundary=True, dtype_pos="float32",
                 reflect_iters=2, TrackCollisions=True)
    rng = np.random.default_rng(5)
    n = 256
    x = rng.uniform(38e3, 52e3, n)
    y = rng.uniform(38e3, 52e3, n)
    z = rng.uniform(-40.0, -5.0, n)
    if vertical:
        fs = fs._replace(
            zeta=jnp.asarray(0.3 * rng.standard_normal(fs.zeta.shape), dtype),
            w=jnp.asarray(rng.uniform(-5e-3, 5e-3, fs.w.shape), dtype))
        k = n // 3
        z = rng.permutation(np.concatenate([
            rng.uniform(-1.0, 0.0, k), rng.uniform(-49.9, -49.0, k),
            rng.uniform(-49.0, -1.0, n - 2 * k)]))
    p = jst.init_particles(x, y, z, dtype=dtype)
    p = p._replace(dob=jnp.asarray(rng.choice([0.0, 900.0], n), dtype))
    i, _ = jlocate(grid.x_rho, p.x, grid.uniform)
    j, _ = jlocate(grid.y_rho, p.y, grid.uniform)
    p, _ = jsp.sort_by_cell(p, i, j)
    prec = jpk.build_packed_records(grid, fs)

    # JAX collapsed-mode scan (the megakernel's oracle)
    pp = p
    for ii in range(cfg.internal_steps):
        pp = internal_step(jctx, cfg, jr.key(0), pp, fs,
                           ii * float(cfg.idt), ii, prec, mode="collapsed")

    # the port's plain version on the same inputs
    ctx = tstep.StepContext(grid=interop.grid_from_numpy(_np(grid)),
                            bounds=interop.boundaries_from_numpy(
                                _np(bounds)))
    rec = pk.build_packed_records(ctx.grid,
                                  interop.fieldset_from_numpy(_np(fs)))
    kx.ext_step_fused.launches = 0
    out = kx.ext_step_fused(ctx, cfg, interop.particles_from_numpy(_np(p)),
                            rec, 0.0)
    return dict(grid=grid, fs=fs, bounds=bounds, cfg=cfg, p=p, prec=prec,
                scan=pp, out=interop.particles_to_numpy(out),
                vertical=vertical)


def test_reference_matches_jax_collapsed_scan(setup):
    out, scan = setup["out"], setup["scan"]
    np.testing.assert_array_equal(out["status"], np.asarray(scan.status))
    np.testing.assert_allclose(out["x"], np.asarray(scan.x), rtol=0,
                               atol=TOL_H)
    np.testing.assert_allclose(out["y"], np.asarray(scan.y), rtol=0,
                               atol=TOL_H)
    np.testing.assert_allclose(out["z"], np.asarray(scan.z), rtol=0,
                               atol=TOL_V)
    np.testing.assert_allclose(out["age"], np.asarray(scan.age), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(out["hit_land"], np.asarray(scan.hit_land))
    np.testing.assert_array_equal(out["hit_bottom"],
                                  np.asarray(scan.hit_bottom))
    # releases were staggered; the land block was hit (solid-body), or
    # the bottom was hit and particles moved vertically
    assert (np.asarray(setup["p"].dob) > 0).any()
    if not setup["vertical"]:
        assert out["hit_land"].sum() > 0
    else:
        assert out["hit_bottom"].sum() > 0
        assert np.abs(out["z"] - np.asarray(setup["p"].z)).max() > 1.0


def test_reference_matches_jax_megakernel_interpret(setup):
    grid, bounds, cfg, p = (setup[k] for k in ("grid", "bounds", "cfg", "p"))
    fs, prec = setup["fs"], setup["prec"]
    rtab = jpk.build_record_tables(grid, prec)
    brows = jnp.asarray(jes.boundary_rows_table(bounds, grid.ny, grid.nx))
    s_max = (int(bounds.cell_rows.shape[1]) - 8) // 8
    params = jes.params_array_ext(grid, bounds, cfg.z0, 0.0, fs.times,
                                  float(cfg.idt), cfg.internal_steps)
    (xo, yo, zo, sto, _, _, _, hitl, hitb, oob) = jes.ext_step_fused(
        grid, rtab, brows, params, p.x, p.y, p.z, p.dob, p.status,
        cfg.tension_sigma, cfg.internal_steps, float(cfg.idt),
        n_iter=cfg.reflect_iters, p_block=256, s_max=s_max,
        precision=jax.lax.Precision.HIGHEST, open_exits=True,
        interpret=True)
    out = setup["out"]
    ok = ~np.asarray(oob)
    assert ok.sum() > 0.9 * p.n
    np.testing.assert_array_equal(out["status"][ok], np.asarray(sto)[ok])
    np.testing.assert_allclose(out["x"][ok], np.asarray(xo)[ok], rtol=0,
                               atol=TOL_H)
    np.testing.assert_allclose(out["y"][ok], np.asarray(yo)[ok], rtol=0,
                               atol=TOL_H)
    np.testing.assert_allclose(out["z"][ok], np.asarray(zo)[ok], rtol=0,
                               atol=TOL_V)
    np.testing.assert_array_equal(out["hit_land"][ok], np.asarray(hitl)[ok])
    np.testing.assert_array_equal(out["hit_bottom"][ok],
                                  np.asarray(hitb)[ok])


def test_launch_counter_stays_zero_on_cpu(setup):
    # the fixture ran ext_step_fused on CPU tensors: the plain version,
    # never the kernel
    assert kx.ext_step_fused.launches == 0


def test_turbulent_swimming_step_matches_jax_megakernel_interpret():
    """Horizontal turbulence, Visser on a parabolic Aks profile, behavior
    1 and mortality: the plain version against the JAX megakernel
    (interpret, HIGHEST) on the same Threefry streams (seed 3 here,
    jax.random.key(3) there).  The megakernel derives the behavior and
    mortality age as t - dob where internal_step carries p.age; the two
    agree when every particle is released at the step's start with age 0
    (the divergence is listed in ROADMAP.md Queue 3)."""
    dtype = jnp.float32
    c = jsynth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                    h0=50.0, omega=1e-4, dtype=dtype)
    grid = c.grid._replace(mask_rho=jnp.asarray(_mask()))
    fs = jsynth.fieldset_for(c, t_center=900.0, dt=1800.0, dtype=dtype)
    z_w = 50.0 * np.asarray(grid.s_w)
    K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / 50.0 + 1.0) ** 2)
    fs = fs._replace(aks=jnp.broadcast_to(jnp.asarray(K, dtype),
                                          fs.aks.shape))
    bounds = jbd.build_boundaries(_mask(), np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    cfg = Config(numpar=256, dt=1800, idt=450, us=6, ws=7,
                 OpenOceanBoundary=True, dtype_pos="float32",
                 reflect_iters=2, TrackCollisions=True, HTurbOn=True,
                 ConstantHTurb=5.0, VTurbOn=True, readAks=True, Behavior=1,
                 swimslow=1e-3, swimfast=4e-3, pediage=3600.0,
                 mortality=True, deadage=900.0)
    rng = np.random.default_rng(7)
    n = 256
    p = jst.init_particles(rng.uniform(38e3, 52e3, n),
                           rng.uniform(38e3, 52e3, n),
                           rng.uniform(-45.0, -2.0, n), dtype=dtype)
    i, _ = jlocate(grid.x_rho, p.x, grid.uniform)
    j, _ = jlocate(grid.y_rho, p.y, grid.uniform)
    p, _ = jsp.sort_by_cell(p, i, j)
    prec = jpk.build_packed_records(grid, fs, with_aks=True)
    rtab = jpk.build_record_tables(grid, prec)
    brows = jnp.asarray(jes.boundary_rows_table(bounds, grid.ny, grid.nx))
    s_max = (int(bounds.cell_rows.shape[1]) - 8) // 8
    params = jes.params_array_ext(grid, bounds, cfg.z0, 0.0, fs.times,
                                  float(cfg.idt), cfg.internal_steps,
                                  const_hturb=cfg.ConstantHTurb,
                                  deadage=cfg.deadage)
    beh = dict(pediage=cfg.pediage, swimstart=cfg.swimstart,
               swimslow=cfg.swimslow, swimfast=cfg.swimfast, Kp=cfg.Kp,
               thresh=cfg.thresh)
    rngk = jes.rng_keys_array(jr.key(3), 0, cfg.internal_steps,
                              behave=True)
    (xo, yo, zo, sto, _, _, _, hitl, hitb, oob) = jes.ext_step_fused(
        grid, rtab, brows, params, p.x, p.y, p.z, p.dob, p.status,
        cfg.tension_sigma, cfg.internal_steps, float(cfg.idt),
        n_iter=cfg.reflect_iters, p_block=256, s_max=s_max,
        precision=jax.lax.Precision.HIGHEST, open_exits=True, pids=p.pid,
        rngk=rngk, hturb_on=True, vturb_on=True, with_aks=True,
        mortality=True, behavior=1, beh=beh, interpret=True)

    ctx = tstep.StepContext(grid=interop.grid_from_numpy(_np(grid)),
                            bounds=interop.boundaries_from_numpy(
                                _np(bounds)))
    tfs = interop.fieldset_from_numpy(_np(fs))
    out = interop.particles_to_numpy(kx.ext_step_fused(
        ctx, cfg, interop.particles_from_numpy(_np(p)),
        pk.build_packed_records(ctx.grid, tfs, with_aks=True), 0.0,
        fields=tfs, seed=interop.seed_from_key_data(jr.key_data(jr.key(3))),
        ext_idx=0))
    ok = ~np.asarray(oob)
    assert ok.sum() > 0.9 * n
    np.testing.assert_array_equal(out["status"][ok], np.asarray(sto)[ok])
    for k, v, tol in (("x", xo, TOL_H), ("y", yo, TOL_H), ("z", zo, TOL_V)):
        np.testing.assert_allclose(out[k][ok], np.asarray(v)[ok], rtol=0,
                                   atol=tol)
    np.testing.assert_array_equal(out["hit_bottom"][ok],
                                  np.asarray(hitb)[ok])
    # turbulence moved them, some died (900 s death age), the walk swam
    assert np.abs(out["z"] - np.asarray(p.z)).max() > 1.0
    assert (out["status"] == jst.DEAD).sum() > 0


def test_settle_salt_oyster_step_matches_jax_collapsed_scan():
    """The oyster configuration (behavior 4 on the halocline cue,
    SaltTempOn, settlement on a habitat with a hole, mortality; pediage
    inside the ages) through the plain version of the kernel, one
    external step, against ltjax's collapsed-mode scan of internal_step
    on the same inputs, in float32: positions to 0.5 m / 1e-3 m, salt and
    temp to 1e-3, statuses and settle_poly equal."""
    dtype = jnp.float32
    c = jsynth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                    h0=50.0, omega=1e-4, dtype=dtype)
    grid = c.grid._replace(mask_rho=jnp.asarray(_mask()))
    fs = jsynth.fieldset_for(c, t_center=900.0, dt=1800.0, dtype=dtype)
    salt, temp = synth.halocline_fields(interop.grid_from_numpy(_np(grid)))
    fs = fs._replace(
        salt=jnp.broadcast_to(jnp.asarray(np.moveaxis(salt, 0, -1), dtype),
                              fs.salt.shape),
        temp=jnp.broadcast_to(jnp.asarray(np.moveaxis(temp, 0, -1), dtype),
                              fs.temp.shape))
    bounds = jbd.build_boundaries(_mask(), np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    xe, ye = np.asarray(bounds.x_edges), np.asarray(bounds.y_edges)
    jpol = jstl.build_polygons([(5, np.array([[38e3, 38e3], [52e3, 39e3],
                                              [50e3, 52e3], [39e3, 50e3]]))],
                               xe, ye)
    jhol = jstl.build_polygons([(1, np.array([[43e3, 43e3], [47e3, 43e3],
                                              [45e3, 47e3]]))], xe, ye)
    cfg = Config(numpar=256, dt=1800, idt=450, us=6, ws=7,
                 OpenOceanBoundary=True, dtype_pos="float32",
                 reflect_iters=2, TrackCollisions=True, Behavior=4,
                 readSalt=True, readTemp=True, SaltTempOn=True,
                 settlementon=True, holesExist=True, mortality=True,
                 deadage=2 * 86400.0, pediage=86400.0, swimslow=2e-3,
                 swimfast=5e-3, Sgradient=0.5)
    rng = np.random.default_rng(8)
    n = 256
    age = rng.uniform(0.0, 2.5 * 86400.0, n)
    p = jst.init_particles(rng.uniform(36e3, 54e3, n),
                           rng.uniform(36e3, 54e3, n),
                           rng.uniform(-16.0, -4.0, n), dtype=dtype)
    p = p._replace(dob=jnp.asarray(-age, dtype), age=jnp.asarray(age, dtype),
                   status=jnp.full(n, jst.ACTIVE, jnp.int32))
    jctx = JContext(grid=grid, bounds=bounds, polys=jpol, holes=jhol)
    prec = jpk.build_packed_records(grid, fs)
    pp = p
    for ii in range(cfg.internal_steps):
        pp = internal_step(jctx, cfg, jr.key(4), pp, fs, ii * float(cfg.idt),
                           ii, prec, mode="collapsed")
    ctx = tstep.StepContext(
        grid=interop.grid_from_numpy(_np(grid)),
        bounds=interop.boundaries_from_numpy(_np(bounds)),
        polys=interop.polygons_from_numpy(_np(jpol)),
        holes=interop.polygons_from_numpy(_np(jhol)))
    tfs = interop.fieldset_from_numpy(_np(fs))
    out = interop.particles_to_numpy(kx.ext_step_fused(
        ctx, cfg, interop.particles_from_numpy(_np(p)),
        pk.build_packed_records(ctx.grid, tfs, with_scalars=True), 0.0,
        fields=tfs, seed=interop.seed_from_key_data(jr.key_data(jr.key(4)))))
    for k in ("status", "settle_poly", "hit_land", "hit_bottom"):
        np.testing.assert_array_equal(out[k], np.asarray(getattr(pp, k)))
    for k, tol in (("x", TOL_H), ("y", TOL_H), ("z", TOL_V),
                   ("salt", 1e-3), ("temp", 1e-3)):
        np.testing.assert_allclose(out[k], np.asarray(getattr(pp, k)),
                                   rtol=0, atol=tol)
    assert (out["status"] == jst.SETTLED).sum() > 0
    assert (out["status"] == jst.DEAD).sum() > 0
    assert np.ptp(out["salt"]) > 1.0


@pytest.mark.parametrize("extra,want", [
    (0, (-1, -1)), (7, (21, -1)), (12, (-1, 21)), (19, (21, 28))],
    ids=["values", "aks", "salt", "aks-salt"])
def test_lane_offsets(extra, want):
    # us 6, ws 7: nv = 21 value lanes, then [7 Aks] [6 salt + 6 temp]
    assert kx.lane_offsets(21 + extra, 6, 7) == want


def test_lane_offsets_reject_other_tables():
    with pytest.raises(ValueError, match="lanes"):
        kx.lane_offsets(24, 6, 7)
