"""The native route (``fast_interp = False``) and adaptive tension
(``tension_sigma < 0``) in the port against ltjax's, on the CPU.

ltjax sends both options down its native route: ``make_external_step``
scans ``internal_step(prec=None)``, whose advection is
``physics.advect.rk4_displacement`` in the reference's order (per record
b/c/f a bilinear blend of every s-level, a tension-spline fit on that
record's own s-depths evaluated at z, then ``polintd`` across the
records).  The port's collapsed scheme (its CUDA kernels' scheme)
interpolates in time first and fits once; the two agree only when zeta
is constant in time and the fields are linear in x and y.

Setup: a 15 x 15 float64 solid-body grid (us 5) with a land block, a
numpy-seeded free surface and w (``synth.with_vertical_motion``, the same
arrays on both sides), a parabolic Aks profile perturbed per node and
record, and the halocline of ``synth.halocline_fields`` perturbed per
record; 256 particles, a third near the surface, a third in the bottom
log layer, staggered releases, ages across the swim ramp.  Both packages
draw from the same streams (seed 9 here, ``jax.random.key(9)`` there).

Tolerances (float64, the same formulas in the same order; differences
are round-off): positions 1e-8 m horizontally and 1e-10 m vertically,
statuses, settle_poly and collision counts equal, salt and temp 1e-9;
spline values and locations 1e-9 (fractions 1e-12).  The first test
shows the fault this route repairs: before it, a run file with
``fast_interp = False`` ran the collapsed scheme without complaint, and
the second test shows that scheme misses ltjax's native result by far
more than the tolerance on this case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import interp as jinterp
from ltjax import state as jst
from ltjax import synth as jsynth
from ltjax import tension as jt
from ltjax.config import Config
from ltjax.grid import make_grid as j_make_grid
from ltjax.physics import advect as jadv
from ltjax.physics import behavior as jbh
from ltjax.physics import boundary as jbd
from ltjax.physics import settlement as jstl
from ltjax.physics import turb as jtb
from ltjax.step import StepContext as JContext
from ltjax.step import internal_step as j_internal_step
from ltjax.step import make_external_step as j_make_external_step
from ltjax_torch import interop
from ltjax_torch import interp as tinterp
from ltjax_torch import step as tstep
from ltjax_torch import synth
from ltjax_torch import tension as tt
from ltjax_torch.physics import advect as tadv
from ltjax_torch.physics import behavior as tbh
from ltjax_torch.physics import turb as ttb

torch.set_num_threads(1)

TOL_H = 1e-8       # m, horizontal
TOL_V = 1e-10      # m, vertical
NX, US, N = 15, 5, 256


def _np(nt):
    """numpy fields of an ltjax NamedTuple; a CurvMap as a dict."""
    d = {k: np.asarray(v) for k, v in nt._asdict().items() if k != "curv"}
    if "curv" in nt._fields:
        d["curv"] = None if nt.curv is None else _np(nt.curv)
    return d


def _mask():
    mask = np.ones((NX, NX), np.int32)
    mask[6:8, 9:11] = 0
    return mask


def _fields(grid, fs, seed=3):
    """fs with with_vertical_motion's zeta and w, a parabolic Aks profile
    perturbed per node and record, and the halocline perturbed per
    record, as numpy arrays both packages take."""
    tfs = synth.with_vertical_motion(interop.fieldset_from_numpy(_np(fs)),
                                     seed=seed, w_amp=2e-3, zeta_std=0.3)
    rng = np.random.default_rng(seed + 1)
    z_w = float(np.asarray(grid.h).max()) * np.asarray(grid.s_w)
    h0 = float(np.asarray(grid.h).max())
    K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / h0 + 1.0) ** 2)
    salt, temp = synth.halocline_fields(interop.grid_from_numpy(_np(grid)))

    def per_record(a, amp):
        a = np.moveaxis(a, 0, -1)[None]
        return a + amp * rng.uniform(-1, 1, (3,) + a.shape[1:])

    return fs._replace(
        zeta=jnp.asarray(tfs.zeta.numpy()), w=jnp.asarray(tfs.w.numpy()),
        aks=jnp.asarray(K * (1.0 + 0.3 * rng.uniform(-1, 1, fs.aks.shape))),
        salt=jnp.asarray(per_record(salt, 0.2)),
        temp=jnp.asarray(per_record(temp, 0.3)))


def _particles(lo, hi, h0, seed=6, n=N):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, n)
    y = rng.uniform(lo, hi, n)
    k = n // 3
    z = rng.permutation(np.concatenate([
        rng.uniform(-1.0, 0.0, k), rng.uniform(0.1 - h0, 1.0 - h0, k),
        rng.uniform(1.0 - h0, -1.0, n - 2 * k)]))
    p = jst.init_particles(x, y, z, dtype=jnp.float64)
    return p._replace(dob=jnp.asarray(rng.choice([0.0, 300.0], n)),
                      age=jnp.asarray(rng.uniform(0.0, 3 * 86400.0, n)),
                      pid=jnp.asarray(rng.permutation(n).astype(np.int32)))


def _rect_case():
    c = jsynth.make_solid_body_case(nx=NX, ny=NX, us=US, lx=28e3, ly=28e3,
                                    h0=40.0, omega=1e-4, dtype=jnp.float64)
    grid = c.grid._replace(mask_rho=jnp.asarray(_mask()))
    fs = _fields(grid, jsynth.fieldset_for(c, t_center=900.0, dt=1800.0,
                                           dtype=jnp.float64))
    bounds = jbd.build_boundaries(_mask(), np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    return grid, fs, bounds, _particles(1e3, 27e3, 40.0)


def _stretched_grid():
    """The port's solid-body grid on rho axes spaced x1.05 a cell, as
    both packages take it."""
    c = synth.make_solid_body_case(nx=NX, ny=NX, us=US, lx=28e3, ly=28e3,
                                   h0=40.0, omega=1e-4, dtype=torch.float64,
                                   mask=_mask(), stretch=1.05)
    g = c.grid
    return j_make_grid(g.x_rho.numpy(), g.y_rho.numpy(), g.h.numpy(),
                       _mask(), g.s_rho.numpy(), g.Cs_r.numpy(),
                       g.s_w.numpy(), g.Cs_w.numpy(), g.hc, g.vtransform,
                       dtype=jnp.float64)


def _curv_case():
    mask = np.ones((NX, NX), np.int32)
    mask[6:8, 9:11] = 0
    c = jsynth.make_curv_case(nx=NX, ny=NX, us=US, lx=28e3, ly=28e3,
                              h0=40.0, omega=1e-4, amp=0.02, mask=mask,
                              dtype=jnp.float64)
    fs = _fields(c.grid, jsynth.fieldset_for(c, t_center=900.0, dt=1800.0,
                                             dtype=jnp.float64))
    bounds = jbd.build_boundaries_curv(mask, c.x2d, c.y2d, c.grid.curv)
    x, y = synth.logical_to_xy(c.x2d, c.y2d,
                               *np.random.default_rng(8).uniform(
                                   1.0, NX - 2.0, (2, N)))
    p = _particles(0.0, 1.0, 40.0)
    return c.grid, fs, bounds, p._replace(x=jnp.asarray(x),
                                          y=jnp.asarray(y))


def _port_ctx(grid, bounds, polys=None, holes=None):
    return tstep.StepContext(
        grid=interop.grid_from_numpy(_np(grid)),
        bounds=interop.boundaries_from_numpy(_np(bounds)),
        polys=None if polys is None else interop.polygons_from_numpy(
            _np(polys)),
        holes=None if holes is None else interop.polygons_from_numpy(
            _np(holes)))


def _cfg(**kw):
    base = dict(numpar=N, dt=1800, idt=600, us=US, ws=US + 1,
                OpenOceanBoundary=True, dtype_pos="float64",
                reflect_iters=2, TrackCollisions=True, fast_interp=False)
    base.update(kw)
    return Config(**base)


def _assert_particles(out, pj, salt=False):
    for k in ("status", "settle_poly", "hit_land", "hit_bottom", "pid"):
        np.testing.assert_array_equal(out[k], np.asarray(getattr(pj, k)))
    for k, tol in (("x", TOL_H), ("y", TOL_H), ("z", TOL_V),
                   ("age", 1e-9)):
        np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                   rtol=0, atol=tol)
    if salt:
        for k in ("salt", "temp"):
            np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                       rtol=0, atol=1e-9)


# --- the fault: fast_interp = False ran the collapsed scheme ------------

@pytest.fixture(scope="module")
def external_step():
    """One external step (3 internal steps) of ltjax's native route on
    the rectilinear case, and the port's inputs."""
    grid, fs, bounds, p = _rect_case()
    cfg = _cfg(seed=9)
    jctx = JContext(grid=grid, bounds=bounds, polys=None, holes=None)
    pj = j_make_external_step(jctx, cfg, jr.key(9))(p, fs, 0.0, 0)
    ctx = _port_ctx(grid, bounds)
    return (cfg, ctx, interop.particles_from_numpy(_np(p)),
            interop.fieldset_from_numpy(_np(fs)), jax.block_until_ready(pj))


def test_native_route_matches_ltjax(external_step):
    cfg, ctx, p, tfs, pj = external_step
    assert tstep.mode_flags(ctx, cfg) == "native"
    out = interop.particles_to_numpy(
        tstep.make_fused_external_steps(ctx, cfg, 1)(p, tfs, 0.0, 0))
    _assert_particles(out, pj)
    # the case moves particles vertically and hits the bottom
    assert np.abs(out["z"] - p.z.numpy()).max() > 1.0
    assert out["hit_bottom"].sum() > 0


def test_collapsed_route_differs_from_native(external_step):
    """The collapsed scheme (fast_interp on) misses ltjax's native result
    on this case by far more than the tolerance: the case tells the two
    schemes apart."""
    cfg, ctx, p, tfs, pj = external_step
    collapsed = dataclasses.replace(cfg, fast_interp=True)
    assert tstep.mode_flags(ctx, collapsed) == "ext_step"
    out = interop.particles_to_numpy(
        tstep.make_fused_external_steps(ctx, collapsed, 1)(p, tfs, 0.0, 0))
    dh = np.hypot(out["x"] - np.asarray(pj.x), out["y"] - np.asarray(pj.y))
    assert dh.max() > 1e3 * TOL_H
    assert np.abs(out["z"] - np.asarray(pj.z)).max() > 1e3 * TOL_V


# --- adaptive tension -----------------------------------------------------

def _profiles(kind, batch=48, k=9, seed=2):
    rng = np.random.default_rng(seed)
    xk = np.cumsum(rng.uniform(0.3, 2.0, (batch, k)), axis=-1) - 10.0
    if kind == "monotone":            # steps a cubic overshoots
        yk = np.cumsum(rng.choice([0.01, 0.02, 0.9], (batch, k)), axis=-1)
    else:
        yk = np.sin(xk) + 0.2 * rng.standard_normal((batch, k))
    xq = rng.uniform(xk[:, 0] - 0.5, xk[:, -1] + 0.5)
    return xk, yk, xq


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["monotone", "non-monotone"])
def test_adaptive_sigma_and_fit_eval_match_ltjax(kind, dtype):
    """Per batch element: each profile gets its own per-interval sigma;
    fit_eval with a negative sigma fits with it.  float32 allows 2e-5
    (tests/test_torch_tension.py), sigma 10x that (up to 15)."""
    xk, yk, xq = _profiles(kind)
    tol = 1e-9 if dtype == "float64" else 2e-5
    tdt = getattr(torch, dtype)
    sj = np.asarray(jt.adaptive_sigma(jnp.asarray(xk, dtype),
                                      jnp.asarray(yk, dtype)))
    st_ = tt.adaptive_sigma(torch.tensor(xk, dtype=tdt),
                            torch.tensor(yk, dtype=tdt))
    assert st_.shape == (48, 8) and st_.dtype == tdt
    np.testing.assert_allclose(st_.numpy(), sj, rtol=0, atol=10 * tol)
    assert (st_ > 0).any(dim=-1).sum() > 10   # most profiles get tension
    assert (st_ == 0).any()
    for sigma in (-1.0, 0.0, 3.0):
        vj = np.asarray(jt.fit_eval(jnp.asarray(xk, dtype),
                                    jnp.asarray(yk, dtype), sigma,
                                    jnp.asarray(xq, dtype)))
        vt = tt.fit_eval(torch.tensor(xk, dtype=tdt),
                         torch.tensor(yk, dtype=tdt), sigma,
                         torch.tensor(xq, dtype=tdt))
        np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=tol)
    # each row's sigma is that row's alone
    one = tt.adaptive_sigma(torch.tensor(xk[5], dtype=tdt),
                            torch.tensor(yk[5], dtype=tdt))
    np.testing.assert_array_equal(one.numpy(), st_[5].numpy())


def test_adaptive_tension_keeps_monotone_data_monotone():
    """tests/test_tension.py's step-like data: the cubic overshoots, the
    adaptive spline stays within the data (5e-3) and interpolates."""
    xk = torch.tensor([0.0, 1, 2, 3, 4, 5, 6, 7.0], dtype=torch.float64)
    yk = torch.tensor([0.0, 0.01, 0.02, 0.5, 0.98, 0.99, 1.0, 1.0],
                      dtype=torch.float64)
    xs = torch.linspace(0, 7, 400, dtype=torch.float64)
    xkb, ykb = xk.expand(400, 8), yk.expand(400, 8)
    cubic = tt.fit_eval(xkb, ykb, 0.0, xs)
    assert cubic.min() < -1e-4 or cubic.max() > 1 + 1e-4
    vals = tt.fit_eval(xkb, ykb, -1.0, xs)
    assert vals.min() >= -5e-3 and vals.max() <= 1 + 5e-3
    at_knots = tt.fit_eval(xk.expand(8, 8), yk.expand(8, 8), -1.0, xk)
    np.testing.assert_allclose(at_knots.numpy(), yk.numpy(), atol=1e-9)


# --- staggered locators ---------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "stretched", "curvilinear"])
def test_locate_uvr_matches_ltjax(kind):
    if kind == "curvilinear":
        grid, _, _, p = _curv_case()
        x, y = np.asarray(p.x), np.asarray(p.y)
    else:
        grid = _rect_case()[0] if kind == "uniform" else _stretched_grid()
        rng = np.random.default_rng(4)
        # inside, and outside the axes (clamped to the edge cells)
        x = rng.uniform(-2e3, 30e3, 500)
        y = rng.uniform(-2e3, 30e3, 500)
    tg = interop.grid_from_numpy(_np(grid))
    assert tg.uniform == (kind == "uniform")
    lj = jinterp.locate_uvr(grid, jnp.asarray(x), jnp.asarray(y))
    lt = tinterp.locate_uvr(tg, torch.tensor(x), torch.tensor(y))
    for a, b in zip(lj, lt):
        for k, (vj, vt) in enumerate(zip(a, b)):
            if k < 2:
                assert vt.dtype == torch.int32
                np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
            else:
                np.testing.assert_allclose(vt.numpy(), np.asarray(vj),
                                           rtol=0, atol=1e-12)
    for fj, ft in ((jinterp.locate_u, tinterp.locate_u),
                   (jinterp.locate_v, tinterp.locate_v)):
        for vj, vt in zip(fj(grid, jnp.asarray(x), jnp.asarray(y)),
                          ft(tg, torch.tensor(x), torch.tensor(y))):
            np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                                       atol=1e-12)


# --- the native advection ---------------------------------------------------

@pytest.mark.parametrize("kind,sigma", [("uniform", 0.0),
                                        ("uniform", -1.0),
                                        ("curvilinear", -1.0)])
def test_advect_matches_ltjax(kind, sigma):
    """find_currents, rk4_displacement and zeta_h_at in float64:
    velocities to 1e-12 m/s, displacements and zeta to 1e-9 m."""
    grid, fs, _, p = _rect_case() if kind == "uniform" else _curv_case()
    tg = interop.grid_from_numpy(_np(grid))
    tfs = interop.fieldset_from_numpy(_np(fs))
    params = dict(sigma=sigma, z0=0.0005, idt=600.0)
    xs = (p.x, p.y, p.z)
    txs = [torch.tensor(np.asarray(a)) for a in xs]
    t = 350.0
    cj = jadv.find_currents(grid, fs, *xs, t, jadv.AdvectParams(**params))
    ct = tadv.find_currents(tg, tfs, *txs, t, tadv.AdvectParams(**params))
    for a, b in zip(cj, ct):
        assert b.dtype == torch.float64
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12)
    dj = jadv.rk4_displacement(grid, fs, *xs, t,
                               jadv.AdvectParams(**params))
    dt_ = tadv.rk4_displacement(tg, tfs, *txs, t,
                                tadv.AdvectParams(**params))
    for a, b in zip(dj, dt_):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-9)
    assert float(dt_[2].abs().max()) > 0.1      # w moves particles
    for a, b in zip(jadv.zeta_h_at(grid, fs, xs[0], xs[1], t),
                    tadv.zeta_h_at(tg, tfs, txs[0], txs[1], t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-9)


def test_negative_sigma_lanes_take_the_series():
    """With tension_sigma < 0 the Visser K(z) fit, the salinity-gradient
    fit and SaltTempOn's sampling call no adaptive_sigma in ltjax: the
    negative tension goes into the small-u series, which is even in u
    (u^2 = sigma^2).  The port computes the same: the tridiagonal
    coefficients of sigma = -1 are the series at u = 1, and each lane at
    sigma = -1 equals ltjax's to 1e-9 (and differs from sigma = 0)."""
    h = torch.tensor([0.5, 2.0], dtype=torch.float64)
    off, dia = tt._coefs(torch.full((2,), -1.0, dtype=torch.float64), h)
    np.testing.assert_allclose(off.numpy(), h.numpy() * (
        1 / 6 - 7 / 360 + 31 / 15120), rtol=1e-15)
    np.testing.assert_allclose(dia.numpy(), h.numpy() * (
        1 / 3 - 1 / 45 + 2 / 945), rtol=1e-15)
    grid, fs, _, p = _rect_case()
    tg = interop.grid_from_numpy(_np(grid))
    tfs = interop.fieldset_from_numpy(_np(fs))
    jx = (p.x, p.y, p.z)
    tx = [torch.tensor(np.asarray(a)) for a in jx]
    t = 350.0
    lanes = {
        "sample_scalar": (
            lambda s: jadv.sample_scalar(grid, fs, fs.salt, *jx, t, s),
            lambda s: tadv.sample_scalar(tg, tfs, tfs.salt, *tx, t, s)),
        "salt_gradient": (
            lambda s: jbh._salt_gradient(grid, fs, *jx, t, s)[0],
            lambda s: tbh._salt_gradient(tg, tfs, *tx, t, s)[0]),
        "visser": (
            lambda s: jtb.vturb(grid, fs, jr.key(9), 3, p.pid, *jx,
                                jnp.asarray(t), jtb.TurbParams(
                                    sigma=s, idt=600.0)),
            lambda s: ttb.vturb(tg, tfs, 9, 3, torch.tensor(
                np.asarray(p.pid)), *tx, t, ttb.TurbParams(
                    sigma=s, idt=600.0))),
    }
    for name, (fj, ft) in lanes.items():
        neg = ft(-1.0)
        np.testing.assert_allclose(neg.numpy(), np.asarray(fj(-1.0)),
                                   rtol=0, atol=1e-9, err_msg=name)
        assert float((neg - ft(0.0)).abs().max()) > 1e-6, name


# --- internal_step(mode="native") against ltjax's prec=None ----------------

BEH = dict(deadage=2 * 86400.0, pediage=86400.0, swimstart=3600.0,
           swimslow=2e-3, swimfast=5e-3, sink=5e-4, Sgradient=0.5)
NATIVE_STEP = {
    "sigma0": dict(),
    "adaptive": dict(tension_sigma=-1.0, fast_interp=True),
    "turb-adaptive": dict(tension_sigma=-1.0, HTurbOn=True,
                          ConstantHTurb=2e4, VTurbOn=True, readAks=True),
    "behavior7-adaptive": dict(tension_sigma=-1.0, Behavior=7,
                               mortality=True),
    "stochastic-adaptive": dict(tension_sigma=-1.0, Behavior=6,
                                mortality=True, stochastic_mortality=True,
                                deadage=3600.0),
    "oyster-adaptive": dict(tension_sigma=-1.0, Behavior=4, readSalt=True,
                            readTemp=True, SaltTempOn=True,
                            settlementon=True, holesExist=True,
                            HTurbOn=True, ConstantHTurb=2e4, VTurbOn=True,
                            readAks=True, mortality=True),
    "curv": dict(HTurbOn=True, ConstantHTurb=1.0),
    "curv-adaptive": dict(tension_sigma=-1.0, Behavior=7),
}


def _polygons():
    """A square habitat with a square hole, a slanted hexagon with a
    slanted hole (metres, on the rectilinear case)."""
    th = np.linspace(0.0, 2 * np.pi, 7)[:-1] + 0.3
    hexagon = np.stack([19e3 + 5e3 * np.cos(th), 20e3 + 4e3 * np.sin(th)],
                       -1)
    habitat = [(11, np.array([[3e3, 3e3], [12e3, 3e3], [12e3, 12e3],
                              [3e3, 12e3]])), (12, hexagon)]
    holes = [(1, np.array([[6e3, 6e3], [9e3, 6e3], [9e3, 9e3],
                           [6e3, 9e3]])),
             (2, np.array([[17e3, 18e3], [21e3, 19e3], [18e3, 22e3]]))]
    return habitat, holes


@pytest.mark.parametrize("name", list(NATIVE_STEP))
def test_internal_step_matches_ltjax_native(name):
    curv = name.startswith("curv")
    grid, fs, bounds, p = _curv_case() if curv else _rect_case()
    cfg = _cfg(**{**BEH, **NATIVE_STEP[name]})
    cfg.validate()
    polys = holes = None
    if cfg.settlementon:
        xe, ye = np.asarray(bounds.x_edges), np.asarray(bounds.y_edges)
        habitat, hole = _polygons()
        polys = jstl.build_polygons(habitat, xe, ye)
        holes = jstl.build_polygons(hole, xe, ye)
    jctx = JContext(grid=grid, bounds=bounds, polys=polys, holes=holes)
    ctx = _port_ctx(grid, bounds, polys, holes)
    assert tstep.mode_flags(ctx, cfg) == "native"
    tfs = interop.fieldset_from_numpy(_np(fs))
    pj = p
    pt = interop.particles_from_numpy(_np(p))
    for i in range(3):
        t = i * 300.0
        pj = j_internal_step(jctx, cfg, jr.key(9), pj, fs, t, 40 + i, None)
        pt = tstep.internal_step(ctx, cfg, 9, pt, tfs, t, 40 + i,
                                 mode="native")
        out = interop.particles_to_numpy(pt)
        _assert_particles(out, pj, salt=cfg.SaltTempOn)
    st_ = out["status"]
    assert (st_ == jst.ACTIVE).sum() > 0
    assert np.abs(out["z"] - np.asarray(p.z)).max() > 0.1
    if cfg.mortality and cfg.stochastic_mortality:
        assert (st_ == jst.DEAD).sum() > 0
    if cfg.settlementon:
        assert (st_ == jst.SETTLED).sum() > 0
    if cfg.ConstantHTurb > 100:
        assert out["hit_land"].sum() > 0
