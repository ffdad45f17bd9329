"""The slice as a whole: ltjax_torch.step.make_fused_external_steps vs
ltjax.step.make_fused_external_steps, ``internal_step`` with turbulence,
behaviors, mortality, settlement and salt sampling vs ltjax's
collapsed-mode ``internal_step``, the per-step route of stochastic
mortality (``mode_flags``, ``internal_step(mode="kernel")``), and the
options ``check_supported`` accepts.

Setup of the fused comparison: tests/test_kernel.py's fused multi-step
case (41x41 grid, us = 6, 256 particles, a 4-record window, n_fuse = 2)
plus a land block.  The JAX side runs its Pallas megakernel in interpret
mode at f32-exact precision (kernel_precision="highest"), with its exact
out-of-window patch, so every particle is comparable.  Tolerances
(float32, as tests/test_kernel.py): horizontal 0.5 m, vertical 1e-3 m;
statuses equal.

Setup of the per-step comparison: the same 41x41 case with type-6
sinking and stochastic mortality (death age 1 h, so most particles die
in the two external steps), through the port's fused driver against a
loop of ltjax's collapsed-mode ``internal_step`` over the same two
external steps (step indices e * internal_steps + i).  Float32,
tolerances as above; statuses equal, DEAD included (the DEATH draws are
bit-equal).

Setup of the internal-step comparison: a 21x21 float64 grid with a land
block, a seeded random free surface and w, a parabolic Aks profile
perturbed per node; 256 particles with staggered releases and ages
across the swim ramp and the death age; strong horizontal turbulence
drives some into land (reflections, stuck particles that die in the same
step).  Both packages draw from the same streams (seed 9 here,
``jax.random.key(9)`` there).  Tolerance 1e-6 m per step in float64 over
three chained steps; statuses and collision counts equal.  The
settlement and salt cases add the halocline of ``synth.halocline_fields``
(perturbed per record and node), a square habitat with a square hole and
a slanted hexagon with a slanted hole, and a pediage inside the ages:
settle_poly equal, salt and temp to 1e-9 psu / degC.
"""

import dataclasses

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import packed as jpk
from ltjax import state as jst
from ltjax import synth as jsynth
from ltjax.config import Config
from ltjax.physics import boundary as jbd
from ltjax.physics import settlement as jstl
from ltjax.step import StepContext as JContext
from ltjax.step import internal_step as j_internal_step
from ltjax.step import make_fused_external_steps as j_fused
from ltjax_torch import interop
from ltjax_torch import packed as tpk
from ltjax_torch import state as tst
from ltjax_torch import step as tstep
from ltjax_torch import synth
from ltjax_torch.physics import behavior as tbh
from ltjax_torch.physics import boundary as bd

torch.set_num_threads(1)


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _mask():
    mask = np.ones((41, 41), np.int32)
    mask[19:22, 21:23] = 0
    return mask


def _cfg(**kw):
    base = dict(numpar=256, dt=1800, idt=450, us=6, ws=7,
                OpenOceanBoundary=True, dtype_pos="float32",
                reflect_iters=2, kernel_block=256,
                kernel_precision="highest", TrackCollisions=True)
    base.update(kw)
    return Config(**base)


def test_fused_steps_match_ltjax():
    dtype = jnp.float32
    c = jsynth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                    h0=50.0, omega=5e-5, dtype=dtype)
    grid = c.grid._replace(mask_rho=jnp.asarray(_mask()))
    dt = 1800.0
    fsR = jsynth.fieldset_window(c, -0.5 * dt, dt, 4, dtype=dtype)
    bounds = jbd.build_boundaries(_mask(), np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    cfg = _cfg()
    rng = np.random.default_rng(3)
    n = 256
    p = jst.init_particles(rng.uniform(38e3, 52e3, n),
                           rng.uniform(38e3, 52e3, n),
                           rng.uniform(-40.0, -5.0, n), dtype=dtype)
    p = p._replace(status=jnp.full(n, jst.ACTIVE, jnp.int32))
    pj = j_fused(JContext(grid=grid, bounds=bounds, polys=None, holes=None),
                 cfg, jr.key(0), 2, interpret=True)(p, fsR, 0.0, 0)

    ctx = tstep.StepContext(grid=interop.grid_from_numpy(_np(grid)),
                            bounds=interop.boundaries_from_numpy(
                                _np(bounds)))
    pt = tstep.make_fused_external_steps(ctx, cfg, 2)(
        interop.particles_from_numpy(_np(p)),
        interop.fieldset_from_numpy(_np(fsR)), 0.0, 0)
    out = interop.particles_to_numpy(pt)
    np.testing.assert_array_equal(out["status"], np.asarray(pj.status))
    np.testing.assert_array_equal(out["pid"], np.arange(n))
    np.testing.assert_allclose(out["x"], np.asarray(pj.x), rtol=0, atol=0.5)
    np.testing.assert_allclose(out["y"], np.asarray(pj.y), rtol=0, atol=0.5)
    np.testing.assert_allclose(out["z"], np.asarray(pj.z), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(out["hit_land"], np.asarray(pj.hit_land))
    assert out["hit_land"].sum() > 0          # the land block was hit
    # and against the closed form for the particles that never touched it
    xa, ya, _ = c.analytic(np.asarray(p.x, np.float64),
                           np.asarray(p.y, np.float64),
                           np.asarray(p.z, np.float64), 2 * dt)
    free = (out["hit_land"] == 0) & (out["status"] == jst.ACTIVE)
    assert free.sum() > 0.5 * n
    np.testing.assert_allclose(out["x"][free], xa[free], rtol=0, atol=0.5)
    np.testing.assert_allclose(out["y"][free], ya[free], rtol=0, atol=0.5)


def test_per_step_route_matches_ltjax_scan():
    dtype = jnp.float32
    c = jsynth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                    h0=50.0, omega=5e-5, dtype=dtype)
    grid = c.grid._replace(mask_rho=jnp.asarray(_mask()))
    dt, n_ext = 1800.0, 2
    fsR = jsynth.fieldset_window(c, -0.5 * dt, dt, n_ext + 2, dtype=dtype)
    bounds = jbd.build_boundaries(_mask(), np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    cfg = _cfg(Behavior=6, sink=5e-4, mortality=True,
               stochastic_mortality=True, deadage=3600.0, seed=4)
    rng = np.random.default_rng(3)
    n = 256
    p = jst.init_particles(rng.uniform(38e3, 52e3, n),
                           rng.uniform(38e3, 52e3, n),
                           rng.uniform(-40.0, -5.0, n), dtype=dtype)
    p = p._replace(status=jnp.full(n, jst.ACTIVE, jnp.int32))
    jctx = JContext(grid=grid, bounds=bounds, polys=None, holes=None)
    n_int, idt = cfg.internal_steps, float(cfg.idt)
    pj = p
    for e in range(n_ext):
        f3 = fsR._replace(**{k: getattr(fsR, k)[e:e + 3]
                             for k in fsR._fields})
        prec = jpk.build_packed_records(grid, f3)
        for i in range(n_int):
            pj = j_internal_step(jctx, cfg, jr.key(4), pj, f3,
                                 e * dt + i * idt, e * n_int + i, prec,
                                 mode="collapsed")

    ctx = tstep.StepContext(grid=interop.grid_from_numpy(_np(grid)),
                            bounds=interop.boundaries_from_numpy(
                                _np(bounds)))
    assert tstep.mode_flags(ctx, cfg) == "per_step"
    pt = tstep.make_fused_external_steps(ctx, cfg, n_ext)(
        interop.particles_from_numpy(_np(p)),
        interop.fieldset_from_numpy(_np(fsR)), 0.0, 0)
    out = interop.particles_to_numpy(pt)
    np.testing.assert_array_equal(out["status"], np.asarray(pj.status))
    np.testing.assert_array_equal(out["pid"], np.arange(n))
    for k, tol in (("x", 0.5), ("y", 0.5), ("z", 1e-3), ("age", 1e-3)):
        np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                   rtol=0, atol=tol)
    np.testing.assert_array_equal(out["hit_land"], np.asarray(pj.hit_land))
    dead = (out["status"] == jst.DEAD).sum()
    assert 0.3 * n < dead < n                 # ~62% expected
    assert (out["status"] == jst.ACTIVE).sum() > 0


MODES = [
    (dict(), "ext_step"),
    (dict(mortality=True), "ext_step"),
    (dict(stochastic_mortality=True), "ext_step"),     # no mortality at all
    (dict(mortality=True, stochastic_mortality=True), "per_step"),
    (dict(Behavior=4, readSalt=True, SaltTempOn=True, settlementon=True,
          holesExist=True, mortality=True, stochastic_mortality=True),
     "per_step"),
    (dict(fast_interp=False), "native"),
    (dict(tension_sigma=-1.0), "native"),
    # the native route takes precedence over the per-step route, as in
    # ltjax (its stochastic mortality runs in the native scan)
    (dict(fast_interp=False, mortality=True, stochastic_mortality=True),
     "native"),
]


@pytest.mark.parametrize("kw,route", MODES,
                         ids=["advection", "mortality", "stochastic-off",
                              "stochastic", "oyster-stochastic",
                              "fast-interp-off", "adaptive-tension",
                              "native-stochastic"])
def test_mode_flags_routes_stochastic_mortality(kw, route):
    assert tstep.mode_flags(_ctx(), _cfg(us=4, ws=5, **kw)) == route


def test_ext_step_kernel_refuses_stochastic_mortality():
    """The whole-step kernel draws no DEATH words: its wrapper refuses
    stochastic mortality on every device and names the per-step route."""
    from ltjax_torch.kernels import ext_step as kx
    ctx = _ctx()
    g = ctx.grid
    p = tst.init_particles(np.full(4, 4e3), np.full(4, 4e3),
                           np.full(4, -5.0), dtype=torch.float32)
    fs = synth.fieldset_for(synth.make_solid_body_case(
        nx=9, ny=9, us=4, dtype=torch.float32), t_center=900.0, dt=1800.0)
    prec = tpk.build_packed_records(g, fs)
    cfg = _cfg(us=4, ws=5, mortality=True, stochastic_mortality=True)
    with pytest.raises(ValueError, match="per-step route"):
        kx.ext_step_fused(ctx, cfg, p, prec, 0.0, fields=fs)


def _ctx():
    g = synth.make_solid_body_case(nx=9, ny=9, us=4,
                                   dtype=torch.float32).grid
    return tstep.StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.numpy(), g.x_rho.numpy(), g.y_rho.numpy()))


def test_cuda_only_restrictions(monkeypatch):
    """On CUDA the kernels take float64 positions, stretched (searched)
    axes and, on the per-step route, curvilinear grids, as on the CPU:
    none of them is refused (checked by presenting the grid as on CUDA),
    nor are the native route, adaptive tension, sharding and the
    depth-banded sort (up to 6 bands, equal or log2 slabs)."""
    ctx = _ctx()
    monkeypatch.setattr(type(ctx.grid), "device",
                        property(lambda self: torch.device("cuda")))
    tstep.check_supported(_cfg(us=4, ws=5, dtype_pos="float64"), ctx)
    stretched = dataclasses.replace(ctx, grid=dataclasses.replace(
        ctx.grid, uniform=False))
    tstep.check_supported(_cfg(us=4, ws=5), stretched)
    tstep.check_supported(_cfg(us=4, ws=5, checkpoint_every=2), ctx)
    tstep.check_supported(_cfg(us=4, ws=5), ctx)       # the slice itself
    tstep.check_supported(_cfg(us=4, ws=5, tension_sigma=-1.0), stretched)
    tstep.check_supported(_cfg(us=4, ws=5, fast_interp=False), stretched)
    tstep.check_supported(_cfg(us=4, ws=5, mesh_particles=2, mesh_tiles=2),
                          stretched)
    for kw in (dict(sort_depth_bands=2),
               dict(sort_depth_bands=6, sort_band_log=True),
               dict(sort_depth_bands=3, mesh_particles=2, mesh_tiles=2)):
        tstep.check_supported(_cfg(us=4, ws=5, **kw), ctx)
        tstep.check_supported(_cfg(us=4, ws=5, **kw), stretched)


def test_stochastic_mortality_on_curvilinear_cuda_refused(monkeypatch):
    """No longer refused: the per-step kernel locates curvilinear cells
    through the inverse map (its LTX_CURV build), so stochastic mortality
    on a curvilinear grid is accepted on CUDA (checked by presenting the
    grid as on CUDA) as on the CPU."""
    c = synth.make_curv_case(nx=9, ny=9, us=4, lx=8e3, ly=8e3, h0=20.0,
                             dtype=torch.float32)
    g = c.grid
    ctx = tstep.StepContext(grid=g, bounds=bd.build_boundaries_curv(
        g.mask_rho.numpy(), c.x2d, c.y2d, g.curv))
    stochastic = _cfg(us=4, ws=5, mortality=True, stochastic_mortality=True)
    tstep.check_supported(stochastic, ctx)              # CPU: the plain path
    monkeypatch.setattr(type(ctx.grid), "device",
                        property(lambda self: torch.device("cuda")))
    assert tstep.mode_flags(ctx, stochastic) == "per_step"
    tstep.check_supported(stochastic, ctx)
    tstep.check_supported(_cfg(us=4, ws=5, mortality=True), ctx)


SLICE = [dict(HTurbOn=True), dict(VTurbOn=True, readAks=True),
         dict(VTurbOn=True, readAks=False, ConstantVTurb=1e-3)] + [
    dict(Behavior=b, mortality=True) for b in (0, 1, 2, 3, 6, 7)] + [
    dict(Behavior=b, readSalt=True) for b in (4, 5)] + [
    dict(settlementon=True, holesExist=True),
    dict(SaltTempOn=True, readSalt=True, readTemp=True),
    dict(Behavior=4, readSalt=True, SaltTempOn=True, settlementon=True,
         holesExist=True, HTurbOn=True, VTurbOn=True, readAks=True,
         mortality=True),
    dict(Behavior=6, mortality=True, stochastic_mortality=True),
    dict(fast_interp=False), dict(tension_sigma=-1.0),
    dict(sort_depth_bands=3, sort_band_height=8.0),
    dict(sort_depth_bands=4, sort_band_log=True)]


@pytest.mark.parametrize("kw", SLICE, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_slice_options_accepted(kw):
    tstep.check_supported(_cfg(us=4, ws=5, **kw), _ctx())


def _f64_case():
    c = jsynth.make_solid_body_case(nx=21, ny=21, us=6, lx=50e3, ly=50e3,
                                    h0=40.0, omega=1e-4,
                                    dtype=jnp.float64)
    mask = np.ones((21, 21), np.int32)
    mask[9:12, 12:15] = 0
    grid = c.grid._replace(mask_rho=jnp.asarray(mask))
    fs = jsynth.fieldset_for(c, t_center=1800.0, dt=3600.0,
                             dtype=jnp.float64)
    rng = np.random.default_rng(6)
    z_w = 40.0 * np.asarray(grid.s_w)
    K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / 40.0 + 1.0) ** 2)
    fs = fs._replace(
        aks=jnp.asarray(K * (1.0 + 0.3 * rng.uniform(-1, 1, fs.aks.shape))),
        zeta=jnp.asarray(0.3 * rng.standard_normal(fs.zeta.shape)),
        w=jnp.asarray(rng.uniform(-2e-3, 2e-3, fs.w.shape)))
    bounds = jbd.build_boundaries(mask, np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    n = 256
    x = np.concatenate([rng.uniform(2e3, 48e3, n // 2),
                        rng.uniform(28e3, 37e3, n - n // 2)])
    y = np.concatenate([rng.uniform(2e3, 48e3, n // 2),
                        rng.uniform(21e3, 29e3, n - n // 2)])
    k = n // 3
    z = rng.permutation(np.concatenate([
        rng.uniform(-1.0, 0.0, k), rng.uniform(-39.9, -39.0, k),
        rng.uniform(-39.0, -1.0, n - 2 * k)]))
    p = jst.init_particles(x, y, z, dtype=jnp.float64)
    p = p._replace(dob=jnp.asarray(rng.choice([0.0, 300.0], n)),
                   age=jnp.asarray(rng.uniform(0.0, 3 * 86400.0, n)),
                   pid=jnp.asarray(rng.permutation(n).astype(np.int32)))
    return grid, fs, bounds, p


SLICE_STEP = {
    "turb": dict(HTurbOn=True, ConstantHTurb=2e4, VTurbOn=True,
                 readAks=True),
    "turb-const": dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                       readAks=False, ConstantVTurb=2e-3),
    **{f"behavior{b}": dict(Behavior=b, mortality=True, HTurbOn=True,
                            ConstantHTurb=2e4, VTurbOn=True, readAks=True)
       for b in (1, 2, 3, 6, 7)},
    # the per-step route: RK4 and TST's stage-1 currents through the
    # per-step kernel's wrapper (its plain version on the CPU)
    "behavior7-stochastic": dict(Behavior=7, mortality=True,
                                 stochastic_mortality=True, deadage=3600.0,
                                 HTurbOn=True, ConstantHTurb=2e4,
                                 VTurbOn=True, readAks=True),
}


def _mode(cfg):
    return "kernel" if cfg.stochastic_mortality else "collapsed"
BEH = dict(deadage=2 * 86400.0, pediage=86400.0, swimstart=3600.0,
           swimslow=2e-3, swimfast=5e-3, sink=5e-4, Hswimspeed=0.1,
           Swimdepth=3.0)


@pytest.mark.parametrize("name", list(SLICE_STEP))
def test_internal_step_matches_ltjax_collapsed(name):
    grid, fs, bounds, p = _f64_case()
    cfg = Config(numpar=p.n, dt=1800, idt=300, us=6, ws=7,
                 OpenOceanBoundary=True, dtype_pos="float64",
                 reflect_iters=2, TrackCollisions=True,
                 **{**BEH, **SLICE_STEP[name]})
    jctx = JContext(grid=grid, bounds=bounds, polys=None, holes=None)
    jprec = jpk.build_packed_records(grid, fs)
    ctx = tstep.StepContext(grid=interop.grid_from_numpy(_np(grid)),
                            bounds=interop.boundaries_from_numpy(
                                _np(bounds)))
    tfs = interop.fieldset_from_numpy(_np(fs))
    prec = tpk.build_packed_records(ctx.grid, tfs)
    pj = p
    pt = interop.particles_from_numpy(_np(p))
    for i in range(3):
        t = i * 300.0
        pj = j_internal_step(jctx, cfg, jr.key(9), pj, fs, t, 40 + i,
                             jprec, mode="collapsed")
        pt = tstep.internal_step(ctx, cfg, 9, pt, tfs, t, 40 + i, prec,
                                 mode=_mode(cfg))
        out = interop.particles_to_numpy(pt)
        np.testing.assert_array_equal(out["status"], np.asarray(pj.status))
        for k in ("x", "y", "z", "age"):
            np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                       rtol=0, atol=1e-6)
        for k in ("hit_land", "hit_bottom"):
            np.testing.assert_array_equal(out[k],
                                          np.asarray(getattr(pj, k)))
    st_ = out["status"]
    if cfg.Behavior != 7:       # TST holds 0.5 m above the bottom
        assert out["hit_bottom"].sum() > 0
    if cfg.ConstantHTurb > 100:
        # strong turbulence: land hits and stuck particles; with
        # mortality some of the stuck died in the same step (DEAD wins)
        assert out["hit_land"].sum() > 0
        assert (st_ == jst.ERROR).sum() + (st_ == jst.DEAD).sum() > 0
    if cfg.mortality:
        assert (st_ == jst.DEAD).sum() > 0


def test_fused_turbulent_run_invariant_to_sort():
    """The plain fused run gives the same particles whatever the Hilbert
    sort cadence: draws are keyed by particle id, not storage slot."""
    c = synth.make_solid_body_case(nx=21, ny=21, us=6, lx=50e3, ly=50e3,
                                   h0=40.0, omega=1e-4, dtype=torch.float64)
    g = c.grid
    ctx = tstep.StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.numpy(), g.x_rho.numpy(), g.y_rho.numpy()))
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 5, dtype=torch.float64)
    fsR.aks[:] = 2e-3
    rng = np.random.default_rng(2)
    n = 200
    p = tst.init_particles(rng.uniform(10e3, 40e3, n),
                           rng.uniform(10e3, 40e3, n),
                           rng.uniform(-35.0, -5.0, n))
    outs = []
    for every in (1, 1000):
        cfg = Config(numpar=n, dt=1800, idt=450, us=6, ws=7,
                     OpenOceanBoundary=True, dtype_pos="float64",
                     HTurbOn=True, VTurbOn=True, readAks=True,
                     Behavior=1, swimslow=1e-3, swimfast=1e-3,
                     ext_sort_every=every)
        outs.append(interop.particles_to_numpy(
            tstep.make_fused_external_steps(ctx, cfg, 3)(p, fsR, 0.0, 2)))
    for k in tst.FIELDS:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert np.abs(outs[0]["z"] - p.z.numpy()).max() > 0.5


def _polygons():
    """A square habitat with a square hole, a slanted hexagon with a
    slanted triangular hole (metres, on the _f64_case grid)."""
    th = np.linspace(0.0, 2 * np.pi, 7)[:-1] + 0.3
    hexagon = np.stack([36e3 + 7e3 * np.cos(th), 38e3 + 6e3 * np.sin(th)],
                       -1)
    habitat = [(11, np.array([[8e3, 8e3], [22e3, 8e3], [22e3, 22e3],
                              [8e3, 22e3]])), (12, hexagon)]
    holes = [(1, np.array([[13e3, 13e3], [17e3, 13e3], [17e3, 17e3],
                           [13e3, 17e3]])),
             (2, np.array([[34e3, 36e3], [39e3, 37e3], [35e3, 41e3]]))]
    return habitat, holes


def _with_halocline(grid, fs, seed=7):
    """fs with synth.halocline_fields' salt and temp, perturbed per record
    and node."""
    tg = interop.grid_from_numpy(_np(grid))
    salt, temp = synth.halocline_fields(tg)
    rng = np.random.default_rng(seed)

    def per_record(a, amp):
        a = np.moveaxis(a, 0, -1)[None]
        return a + amp * rng.uniform(-1, 1, (3,) + a.shape[1:])

    return fs._replace(salt=jnp.asarray(per_record(salt, 0.2)),
                       temp=jnp.asarray(per_record(temp, 0.3)))


SALT = dict(readSalt=True, readTemp=True, Sgradient=0.5, swimslow=1e-3,
            swimfast=3e-3)
SETTLE_STEP = {
    "settle": dict(settlementon=True, holesExist=True, HTurbOn=True,
                   ConstantHTurb=2e4, mortality=True),
    "salt": dict(SaltTempOn=True, VTurbOn=True, readAks=True, **SALT),
    "behavior4": dict(Behavior=4, mortality=True, **SALT),
    "behavior5": dict(Behavior=5, HTurbOn=True, ConstantHTurb=1.0, **SALT),
    "behavior4-salt-settle": dict(Behavior=4, SaltTempOn=True,
                                  settlementon=True, holesExist=True,
                                  HTurbOn=True, ConstantHTurb=2e4,
                                  mortality=True, **SALT),
    "behavior5-salt": dict(Behavior=5, SaltTempOn=True, **SALT),
    "oyster-stochastic": dict(Behavior=4, SaltTempOn=True, settlementon=True,
                              holesExist=True, HTurbOn=True,
                              ConstantHTurb=2e4, VTurbOn=True, readAks=True,
                              mortality=True, stochastic_mortality=True,
                              deadage=3600.0, **SALT),
}


@pytest.mark.parametrize("name", list(SETTLE_STEP))
def test_settlement_and_salt_step_matches_ltjax_collapsed(name):
    grid, fs, bounds, p = _f64_case()
    fs = _with_halocline(grid, fs)
    cfg = Config(numpar=p.n, dt=1800, idt=300, us=6, ws=7,
                 OpenOceanBoundary=True, dtype_pos="float64",
                 reflect_iters=2, TrackCollisions=True,
                 **{**BEH, **SETTLE_STEP[name]})
    cfg.validate()
    habitat, holes = _polygons()
    xe, ye = np.asarray(bounds.x_edges), np.asarray(bounds.y_edges)
    jpol = jstl.build_polygons(habitat, xe, ye)
    jhol = jstl.build_polygons(holes, xe, ye)
    jctx = JContext(grid=grid, bounds=bounds, polys=jpol, holes=jhol)
    jprec = jpk.build_packed_records(grid, fs)
    ctx = tstep.StepContext(
        grid=interop.grid_from_numpy(_np(grid)),
        bounds=interop.boundaries_from_numpy(_np(bounds)),
        polys=interop.polygons_from_numpy(_np(jpol)),
        holes=interop.polygons_from_numpy(_np(jhol)))
    tfs = interop.fieldset_from_numpy(_np(fs))
    prec = tpk.build_packed_records(ctx.grid, tfs)
    pj = p
    pt = interop.particles_from_numpy(_np(p))
    cues = 0
    for i in range(3):
        t = i * 300.0
        pj = j_internal_step(jctx, cfg, jr.key(9), pj, fs, t, 40 + i,
                             jprec, mode="collapsed")
        pt = tstep.internal_step(ctx, cfg, 9, pt, tfs, t, 40 + i, prec,
                                 mode=_mode(cfg))
        out = interop.particles_to_numpy(pt)
        for k in ("status", "settle_poly", "hit_land", "hit_bottom"):
            np.testing.assert_array_equal(out[k], np.asarray(getattr(pj, k)))
        for k in ("x", "y", "z", "age"):
            np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                       rtol=0, atol=1e-6)
        for k in ("salt", "temp"):
            np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                       rtol=0, atol=1e-9)
    st_, poly = out["status"], out["settle_poly"]
    if cfg.settlementon:
        # both habitat polygons took settlers, none settled in a hole
        assert set(poly[st_ == jst.SETTLED]) == {11, 12}
        assert (poly[st_ != jst.SETTLED] == -1).all()
        hx, hy = out["x"][st_ == jst.SETTLED], out["y"][st_ == jst.SETTLED]
        assert not ((hx > 13e3) & (hx < 17e3) & (hy > 13e3)
                    & (hy < 17e3)).any()
    if cfg.SaltTempOn:
        moved = st_ != jst.NOT_RELEASED
        assert (out["salt"][moved] > 15.0).all()
        assert (out["temp"][moved] > 8.0).all()
    else:
        assert (out["salt"] == 0).all()
    if cfg.stochastic_mortality:
        assert (st_ == jst.DEAD).sum() > 0
    if cfg.Behavior in (4, 5):
        # the halocline cue fired for some particles and not for others
        q = interop.particles_from_numpy(_np(p))
        dsdz, _ = tbh._salt_gradient(ctx.grid, tfs, q.x, q.y, q.z,
                                     torch.tensor(0.0, dtype=torch.float64),
                                     0.0)
        cue = dsdz.abs() >= cfg.Sgradient
        assert 0 < int(cue.sum()) < p.n


# rho axes spaced x1.02 a cell (rho axes and cell edges not uniform), or
# x(1 + 5e-7) (rho axes not uniform at grid.py's 1e-9, edges uniform at
# boundary.py's 1e-4)
STRETCH = {"stretched": 1.02, "stretched-grid": 1 + 5e-7}
STRETCH_STEP = [("turb", "stretched"), ("turb", "stretched-grid"),
                ("settle", "stretched")]


def _stretched_case(ratio):
    """_f64_case's inputs on the port's stretched solid-body grid
    (``synth.make_solid_body_case(stretch=ratio)``), as both packages take
    them (float64)."""
    from ltjax.fields import FieldSet as JFieldSet
    from ltjax.grid import make_grid as j_make_grid
    mask = np.ones((21, 21), np.int32)
    mask[9:12, 12:15] = 0
    c = synth.make_solid_body_case(nx=21, ny=21, us=6, lx=50e3, ly=50e3,
                                   h0=40.0, omega=1e-4, dtype=torch.float64,
                                   mask=mask, stretch=ratio)
    g = c.grid
    x, y = g.x_rho.numpy(), g.y_rho.numpy()
    grid = j_make_grid(x, y, g.h.numpy(), mask, g.s_rho.numpy(),
                       g.Cs_r.numpy(), g.s_w.numpy(), g.Cs_w.numpy(), g.hc,
                       g.vtransform, dtype=jnp.float64)
    tfs = synth.fieldset_for(c, t_center=1800.0, dt=3600.0,
                             dtype=torch.float64)
    rng = np.random.default_rng(6)
    z_w = 40.0 * g.s_w.numpy()
    K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / 40.0 + 1.0) ** 2)
    fs = JFieldSet(**{k: jnp.asarray(getattr(tfs, k).numpy())
                      for k in JFieldSet._fields})
    fs = fs._replace(
        aks=jnp.asarray(K * (1.0 + 0.3 * rng.uniform(-1, 1, fs.aks.shape))),
        zeta=jnp.asarray(0.3 * rng.standard_normal(fs.zeta.shape)),
        w=jnp.asarray(rng.uniform(-2e-3, 2e-3, fs.w.shape)))
    bounds = jbd.build_boundaries(mask, x, y)
    n = 256
    px = np.concatenate([rng.uniform(2e3, 48e3, n // 2),
                         rng.uniform(28e3, 37e3, n - n // 2)])
    py = np.concatenate([rng.uniform(2e3, 48e3, n // 2),
                         rng.uniform(21e3, 29e3, n - n // 2)])
    pz = -rng.uniform(0.1, 39.9, n)
    p = jst.init_particles(px, py, pz, dtype=jnp.float64)
    p = p._replace(dob=jnp.asarray(rng.choice([0.0, 300.0], n)),
                   age=jnp.asarray(rng.uniform(0.0, 3 * 86400.0, n)),
                   pid=jnp.asarray(rng.permutation(n).astype(np.int32)))
    return grid, fs, bounds, p


@pytest.mark.parametrize("name,geometry", STRETCH_STEP,
                         ids=[f"{a}-{b}" for a, b in STRETCH_STEP])
def test_stretched_grid_f64_matches_ltjax_collapsed(name, geometry):
    """The plain float64 path on stretched rectilinear axes (searched
    locate, searched or arithmetic cell edges) against ltjax's collapsed
    ``internal_step`` in x64: three chained steps to 1e-6 m, statuses,
    settle_poly and collision counts equal."""
    grid, fs, bounds, p = _stretched_case(STRETCH[geometry])
    assert not bool(grid.uniform)
    assert bool(bounds.uniform) == (geometry == "stretched-grid")
    cfg = Config(numpar=p.n, dt=1800, idt=300, us=6, ws=7,
                 OpenOceanBoundary=True, dtype_pos="float64",
                 reflect_iters=2, TrackCollisions=True,
                 **{**BEH, **(SLICE_STEP if name == "turb"
                              else SETTLE_STEP)[name]})
    jpol = jhol = None
    if cfg.settlementon:
        habitat, holes = _polygons()
        xe, ye = np.asarray(bounds.x_edges), np.asarray(bounds.y_edges)
        jpol = jstl.build_polygons(habitat, xe, ye)
        jhol = jstl.build_polygons(holes, xe, ye)
    jctx = JContext(grid=grid, bounds=bounds, polys=jpol, holes=jhol)
    jprec = jpk.build_packed_records(grid, fs)
    ctx = tstep.StepContext(
        grid=interop.grid_from_numpy(_np(grid)),
        bounds=interop.boundaries_from_numpy(_np(bounds)),
        polys=jpol and interop.polygons_from_numpy(_np(jpol)),
        holes=jhol and interop.polygons_from_numpy(_np(jhol)))
    assert not ctx.grid.uniform
    tfs = interop.fieldset_from_numpy(_np(fs))
    prec = tpk.build_packed_records(ctx.grid, tfs)
    pj = p
    pt = interop.particles_from_numpy(_np(p))
    for i in range(3):
        t = i * 300.0
        pj = j_internal_step(jctx, cfg, jr.key(9), pj, fs, t, 40 + i,
                             jprec, mode="collapsed")
        pt = tstep.internal_step(ctx, cfg, 9, pt, tfs, t, 40 + i, prec)
        out = interop.particles_to_numpy(pt)
        for k in ("status", "settle_poly", "hit_land", "hit_bottom"):
            np.testing.assert_array_equal(out[k], np.asarray(getattr(pj, k)))
        for k in ("x", "y", "z", "age"):
            np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                       rtol=0, atol=1e-6)
    assert out["hit_land"].sum() > 0
    if cfg.settlementon:
        assert (out["status"] == jst.SETTLED).sum() > 0
