"""Salt and temperature: ltjax_torch.physics.advect.sample_scalar,
physics.behavior._salt_gradient and behave for types 4/5 against
ltjax.physics on the same fields and particles.

The fields are synth.halocline_fields on a 21 x 21 float64 grid (a
halocline nonlinear in z that varies in x: a field linear in z would be
reproduced exactly by any spline, right or wrong), perturbed per record
and node from a numpy seed so the time interpolation and the bilinear
blend matter, under a seeded random free surface; vertical transforms 1
and 2 (stretched) and a tension sigma.  Particles sit across the whole
column, some above the surface and below the bottom (clamped ends), and
a band around the halocline at z = -10 m where |dS/dz| crosses the cue
threshold.  Tolerance 1e-9 (psu, degC, psu/m, m) in float64: the same
formulas in the same order.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import synth as jsynth
from ltjax.physics import advect as jadv
from ltjax.physics import behavior as jbh
from ltjax_torch import interop, synth
from ltjax_torch.physics import advect as tadv
from ltjax_torch.physics import behavior as bh

torch.set_num_threads(1)

TOL = 1e-9
SEED = 5


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def halocline_case(vtransform=1, theta_s=0.0, n=3000, seed=2):
    """(ltjax grid, ltjax FieldSet, port grid, port FieldSet, particles)"""
    c = jsynth.make_solid_body_case(nx=21, ny=21, us=8, lx=50e3, ly=50e3,
                                    h0=40.0, omega=1e-4,
                                    vtransform=vtransform, theta_s=theta_s,
                                    dtype=jnp.float64)
    fs = jsynth.fieldset_for(c, t_center=1800.0, dt=3600.0,
                             dtype=jnp.float64)
    grid = interop.grid_from_numpy(_np(c.grid))
    salt, temp = synth.halocline_fields(grid)           # (us, ny, nx)
    rng = np.random.default_rng(seed)

    def per_record(a, amp):
        a = np.moveaxis(a, 0, -1)[None]                  # (1, ny, nx, us)
        return a + amp * rng.uniform(-1, 1, (3,) + a.shape[1:])

    fs = fs._replace(salt=jnp.asarray(per_record(salt, 0.2)),
                     temp=jnp.asarray(per_record(temp, 0.3)),
                     zeta=jnp.asarray(0.3 * rng.standard_normal(
                         fs.zeta.shape)))
    x = rng.uniform(1e3, 49e3, n)
    y = rng.uniform(1e3, 49e3, n)
    z = np.concatenate([rng.uniform(-41.0, 1.0, n // 2),
                        rng.uniform(-14.0, -6.0, n - n // 2)])
    return c.grid, fs, grid, interop.fieldset_from_numpy(_np(fs)), (x, y, z)


CASES = {"vt1": dict(), "vt2-stretched": dict(vtransform=2, theta_s=3.0)}


@pytest.mark.parametrize("sigma", [0.0, 2.0], ids=["cubic", "tension"])
@pytest.mark.parametrize("case", list(CASES))
def test_sample_scalar_matches_ltjax(case, sigma):
    jg, jfs, tg, tfs, (x, y, z) = halocline_case(**CASES[case])
    t = 2400.0
    for k in ("salt", "temp"):
        want = np.asarray(jadv.sample_scalar(
            jg, jfs, getattr(jfs, k), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(z), jnp.asarray(t), sigma))
        got = tadv.sample_scalar(tg, tfs, getattr(tfs, k), torch.tensor(x),
                                 torch.tensor(y), torch.tensor(z),
                                 torch.tensor(t, dtype=torch.float64), sigma)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the halocline is there: salt spans the 25 +- 5 psu range
    assert np.ptp(want) > 1.0 and np.ptp(got.numpy()) > 1.0


@pytest.mark.parametrize("sigma", [0.0, 2.0], ids=["cubic", "tension"])
@pytest.mark.parametrize("case", list(CASES))
def test_salt_gradient_matches_ltjax(case, sigma):
    jg, jfs, tg, tfs, (x, y, z) = halocline_case(**CASES[case])
    t = 600.0
    dj, sj = jbh._salt_gradient(jg, jfs, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(z), jnp.asarray(t), sigma)
    dt, st = bh._salt_gradient(tg, tfs, torch.tensor(x), torch.tensor(y),
                               torch.tensor(z),
                               torch.tensor(t, dtype=torch.float64), sigma)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=TOL)
    # the cue threshold of the configurations below is crossed both ways
    g = np.abs(dt.numpy())
    assert (g >= 0.5).any() and (g < 0.5).any() and g.max() < 2.5


@pytest.mark.parametrize("behavior", [4, 5])
def test_behave_salinity_cue_matches_ltjax(behavior):
    jg, jfs, tg, tfs, (x, y, z) = halocline_case()
    n = len(x)
    rng = np.random.default_rng(9)
    age = rng.uniform(0.0, 3 * 86400.0, n)
    zeta = rng.uniform(-0.3, 0.3, n)
    h = np.full(n, 40.0)
    pids = rng.permutation(n).astype(np.int32)
    kw = dict(behavior=behavior, mortality=True, deadage=2.5 * 86400.0,
              pediage=86400.0, swimstart=3600.0, swimslow=1e-3,
              swimfast=3e-3, Sgradient=0.5, idt=120.0)
    t = 900.0
    out_j = jbh.behave(jg, jfs, jr.key(SEED), 11, jnp.asarray(pids),
                       jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                       jnp.asarray(t), jnp.asarray(age), jnp.asarray(zeta),
                       jnp.asarray(h), (jnp.zeros(n), jnp.zeros(n)),
                       jbh.BehaveParams(**kw))
    T = {k: torch.tensor(v) for k, v in dict(x=x, y=y, z=z, age=age,
                                            zeta=zeta, h=h).items()}
    out_t = bh.behave(tg, tfs, SEED, 11, torch.tensor(pids), T["x"], T["y"],
                      T["z"], torch.tensor(t, dtype=torch.float64), T["age"],
                      T["zeta"], T["h"], (torch.zeros(n), torch.zeros(n)),
                      bh.BehaveParams(**kw))
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    # all three branches ran: the cue (a full swim step up or down), no
    # cue (the random walk, or type 5's half-up walk), the pediveliger
    dz = out_t[2].numpy()
    young = age < kw["pediage"]
    assert (dz[young] != 0).any() and (dz[~young] != 0).any()
    assert len(np.unique(np.round(np.abs(dz[young]), 9))) > 10
