"""ltjax_torch.physics.turb vs ltjax.physics.turb on identical inputs.

Setup: a 9x9 solid-body grid (us = 6), float64, three records with a
seeded random free surface and a parabolic Aks(z) profile (bench.py's
turb variant) perturbed per node and record; particles anywhere in the
water column.  The same draws feed both packages (seed 7 here,
``jax.random.key(7)`` there).  Tolerance 1e-9 m: the same formulas in
the same order, differences are float64 round-off.  Plus the port of
tests/test_turb.py's well-mixed condition.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import synth as jsynth
from ltjax.physics import turb as jtb
from ltjax.physics.boundary import reflect_vertical as j_reflect_vertical
from ltjax_torch import interop, synth
from ltjax_torch.physics import turb as tb
from ltjax_torch.physics.boundary import reflect_vertical

torch.set_num_threads(1)

TOL = 1e-9
SEED = 7


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def case():
    c = jsynth.make_solid_body_case(nx=9, ny=9, us=6, lx=20e3, ly=20e3,
                                    h0=30.0, omega=1e-4, dtype=jnp.float64)
    fs = jsynth.fieldset_for(c, t_center=1800.0, dt=3600.0,
                             dtype=jnp.float64)
    rng = np.random.default_rng(4)
    z_w = 30.0 * np.asarray(c.grid.s_w)
    K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / 30.0 + 1.0) ** 2)
    aks = K * (1.0 + 0.3 * rng.uniform(-1, 1, fs.aks.shape))
    fs = fs._replace(aks=jnp.asarray(aks),
                     zeta=jnp.asarray(0.3 * rng.standard_normal(
                         fs.zeta.shape)))
    n = 512
    x = rng.uniform(0.0, 20e3, n)
    y = rng.uniform(0.0, 20e3, n)
    z = rng.uniform(-30.5, 0.5, n)          # incl. outside the column
    pids = rng.permutation(n).astype(np.int32) * 3
    tgrid = interop.grid_from_numpy(_np(c.grid))
    tfs = interop.fieldset_from_numpy(_np(fs))
    return dict(grid=c.grid, fs=fs, tgrid=tgrid, tfs=tfs, x=x, y=y, z=z,
                pids=pids)


def test_hturb_matches_ltjax(case):
    pids = case["pids"]
    for step in (0, 5):
        jx, jy = jtb.hturb(jr.key(SEED), step, jnp.asarray(pids), 120.0,
                           2.5, jnp.float64)
        tx, ty = tb.hturb(SEED, step, torch.tensor(pids), 120.0, 2.5,
                          torch.float64)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("use_aks,sigma", [(True, 0.0), (True, 4.0),
                                           (False, 0.0)],
                         ids=["aks", "aks-tension", "constant"])
def test_vturb_matches_ltjax(case, use_aks, sigma):
    x, y, z, pids = (case[k] for k in ("x", "y", "z", "pids"))
    jp = jtb.TurbParams(ConstantVTurb=2e-3, use_aks=use_aks, sigma=sigma,
                        idt=120.0)
    tp = tb.TurbParams(ConstantVTurb=2e-3, use_aks=use_aks, sigma=sigma,
                       idt=120.0)
    for step, t in ((0, 0.0), (3, 1000.0)):
        dj = jtb.vturb(case["grid"], case["fs"], jr.key(SEED), step,
                       jnp.asarray(pids), jnp.asarray(x), jnp.asarray(y),
                       jnp.asarray(z), jnp.asarray(t), jp)
        dt_ = tb.vturb(case["tgrid"], case["tfs"], SEED, step,
                       torch.tensor(pids), torch.tensor(x),
                       torch.tensor(y), torch.tensor(z), t, tp)
        np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=0,
                                   atol=TOL)
        assert np.abs(np.asarray(dj)).max() > 0.1    # a real kick


def test_vturb_well_mixed_condition():
    """Port of tests/test_turb.py::test_vturb_well_mixed_condition: a
    uniform concentration stays uniform under the parabolic K(z).  The
    same mixing time (24,000 s) in 200 steps of 120 s, the bench's idt,
    instead of 400 of 60 s."""
    h0, us, n = 50.0, 20, 3000
    c = synth.make_solid_body_case(nx=5, ny=5, us=us, lx=10e3, ly=10e3,
                                   h0=h0, omega=0.0, dtype=torch.float64)
    g = c.grid
    z_w = h0 * g.s_w.numpy()
    K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / h0 + 1.0) ** 2)
    fs = synth.fieldset_for(c, t_center=3600.0, dt=3600.0,
                            dtype=torch.float64)
    fs.aks[:] = torch.tensor(K)
    rng = np.random.default_rng(0)
    z = torch.tensor(rng.uniform(-h0, 0.0, n))
    x = torch.full((n,), 5e3, dtype=torch.float64)
    y = torch.full((n,), 5e3, dtype=torch.float64)
    pids = torch.arange(n, dtype=torch.int32)
    params = tb.TurbParams(use_aks=True, idt=120.0)
    zeta = torch.zeros(n, dtype=torch.float64)
    h = torch.full((n,), h0, dtype=torch.float64)
    for i in range(200):
        dz = tb.vturb(g, fs, 1, i, pids, x, y, z, 3600.0, params)
        z, _, _ = reflect_vertical(z + dz, zeta, h)
    hist, _ = np.histogram(z.numpy(), bins=10, range=(-h0, 0.0))
    expected = n / 10
    chi2 = np.sum((hist - expected) ** 2 / expected)
    assert chi2 < 35.0, f"well-mixed condition violated: chi2={chi2}, {hist}"
    # the same reflection as ltjax's
    zr, _, _ = j_reflect_vertical(jnp.asarray(z.numpy() - 60.0),
                                  jnp.zeros(n), jnp.full(n, h0))
    np.testing.assert_array_equal(
        reflect_vertical(z - 60.0, zeta, h)[0].numpy(), np.asarray(zr))
