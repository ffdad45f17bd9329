"""ltjax_torch.packed (collapsed scheme) vs ltjax.packed in float64.

Both packages get the same grid, fields and particles (built once by
ltjax, carried over as numpy through ltjax_torch.interop).  Parametrised
on affine (theta_s = 0) and stretched (theta_s = 4) ladders and on
Vtransform 1/2.  Tolerances: tables 1e-12 (same arithmetic in float64);
velocities 1e-9 m/s and RK4 displacements 1e-6 m (algorithm checks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltjax import grid as jgr
from ltjax import packed as jpk
from ltjax import synth as jsynth
from ltjax_torch import grid as tgr
from ltjax_torch import interop
from ltjax_torch import packed as pk

torch.set_num_threads(1)

SIGMA = 0.0
Z0M = 5e-4
IDT = 300.0


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module",
                params=[(0.0, 1), (4.0, 1), (0.0, 2), (4.0, 2)],
                ids=["affine-vt1", "stretched-vt1", "affine-vt2",
                     "stretched-vt2"])
def case(request):
    theta_s, vt = request.param
    c = jsynth.make_solid_body_case(nx=21, ny=17, us=6, lx=40e3, ly=32e3,
                                    h0=40.0, omega=1e-4, shear_a=0.01,
                                    ramp_b=1e-5, vtransform=vt,
                                    theta_s=theta_s, dtype=jnp.float64)
    fs = jsynth.fieldset_for(c, t_center=1800.0, dt=3600.0,
                             dtype=jnp.float64)
    # a non-zero free surface so the knot ladders move with zeta, and a
    # non-zero w so the w-ladder fit is held too
    rng = np.random.default_rng(7)
    fs = fs._replace(zeta=jnp.asarray(
        0.3 * rng.standard_normal(fs.zeta.shape)),
        w=jnp.asarray(rng.uniform(-5e-3, 5e-3, fs.w.shape)))
    n = 300
    x = rng.uniform(1e3, 39e3, n)
    y = rng.uniform(1e3, 31e3, n)
    z = rng.uniform(-39.0, -0.5, n)
    jrec = jpk.build_packed_records(c.grid, fs)
    grid = interop.grid_from_numpy(_np(c.grid))
    rec = pk.build_packed_records(grid, interop.fieldset_from_numpy(_np(fs)))
    return c.grid, jrec, grid, rec, x, y, z


def test_packed_records_and_stage_tables(case):
    jgrid, jrec, grid, rec, *_ = case
    nv = pk.n_value_lanes(grid.us, grid.ws)
    lj, lt = jgr.affine_ladders(jgrid), tgr.affine_ladders(grid)
    assert (lt is None) == (lj is None)
    if lt is not None:
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(rec.tab.numpy(), np.asarray(jrec.tab),
                               rtol=0, atol=1e-12)
    jt = jpk.stage_value_tables(jgrid, jrec, 100.0, IDT)
    tt = pk.stage_value_tables(grid, rec, 100.0, IDT)
    for a, b in zip(tt, jt):
        assert a.t == pytest.approx(float(b.t))
        np.testing.assert_allclose(a.full.numpy(),
                                   np.asarray(b.full)[..., :nv],
                                   rtol=0, atol=1e-12)


def test_find_currents_and_rk4(case):
    jgrid, jrec, grid, rec, x, y, z = case
    jt = jpk.stage_value_tables(jgrid, jrec, 100.0, IDT)
    tt = pk.stage_value_tables(grid, rec, 100.0, IDT)
    xj, yj, zj = (jnp.asarray(a) for a in (x, y, z))
    xt, yt, zt = (torch.tensor(a) for a in (x, y, z))
    cur_j = jpk.find_currents_collapsed(jgrid, jt[1], xj, yj, zj, SIGMA, Z0M)
    cur_t = pk.find_currents_collapsed(grid, tt[1], xt, yt, zt, SIGMA, Z0M)
    for a, b in zip(cur_t, cur_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    d_j = jpk.rk4_displacement_collapsed(jgrid, jt, xj, yj, zj, SIGMA, Z0M,
                                         IDT)
    d_t = pk.rk4_displacement_collapsed(grid, tt, xt, yt, zt, SIGMA, Z0M,
                                        IDT)
    for a, b in zip(d_t, d_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    zh_t = pk.zeta_h_packed(grid, tt[2], xt, yt)
    zh_j = jpk.zeta_h_packed(jgrid, jt[2], xj, yj)
    for a, b in zip(zh_t, zh_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)


def test_locate_matches_ltjax_on_both_axis_kinds():
    """Arithmetic locate on a uniform axis, searchsorted on a stretched
    one; queries outside the axis clamp to the edge cells."""
    rng = np.random.default_rng(2)
    q = rng.uniform(-500.0, 10500.0, 400)
    for ax in (np.linspace(0.0, 1e4, 21),
               np.cumsum(np.linspace(200.0, 800.0, 21)) - 200.0):
        uni = bool(np.allclose(np.diff(ax), ax[1] - ax[0]))
        ij, fj = jgr.locate(jnp.asarray(ax), jnp.asarray(q), uni)
        it, ft = tgr.locate(torch.tensor(ax), torch.tensor(q), uni)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0,
                                   atol=1e-12)
