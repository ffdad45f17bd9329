"""ltjax_torch.physics.behavior vs ltjax.physics.behavior on identical
inputs: types 0, 1, 2, 3, 6 and 7, with deterministic mortality (types
4 and 5, which cue on the salt field, in test_torch_salt.py), and
stochastic mortality (constant hazard 1/deadage on the DEATH substream):
deaths bit-equal to ltjax's, the death rate of 20,000 particles within 5
standard deviations of 1 - exp(-idt/deadage), as tests/test_behavior.py
holds ltjax, and the walk draws unchanged when the mode toggles.

Inputs are made with numpy from a seed: positions anywhere in and just
outside the water column, ages across the swim ramp and the death age,
a free surface and depth per particle, currents straddling the TST
riding speed; two times of day so that type 3 sees daylight (light above
and below the threshold) and night.  The same draws feed both packages
(seed 5 here, ``jax.random.key(5)`` there).  Tolerance 1e-9 m in
float64: the same formulas in the same order.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax.physics import behavior as jbh
from ltjax_torch.physics import behavior as bh

torch.set_num_threads(1)

TOL = 1e-9
SEED = 5
PARAMS = dict(mortality=True, deadage=3 * 86400.0, pediage=2 * 86400.0,
              swimstart=3600.0, swimslow=1e-3, swimfast=4e-3, sink=2e-4,
              Hswimspeed=0.1, Swimdepth=3.0, idt=120.0)


def _inputs(n=2000, seed=8):
    r = np.random.default_rng(seed)
    h = r.uniform(10.0, 60.0, n)
    zeta = r.uniform(-0.5, 0.5, n)
    return dict(
        x=r.uniform(0.0, 1e4, n), y=r.uniform(0.0, 1e4, n),
        z=r.uniform(-h - 0.5, zeta + 0.5), zeta=zeta, h=h,
        age=r.uniform(0.0, 4 * 86400.0, n),
        u=r.uniform(-0.1, 0.1, n), v=r.uniform(-0.1, 0.1, n),
        pids=r.permutation(n).astype(np.int32))


@pytest.mark.parametrize("hour", [9.0, 23.0])
@pytest.mark.parametrize("behavior", [0, 1, 2, 3, 6, 7])
def test_behave_matches_ltjax(behavior, hour):
    d = _inputs()
    t = hour * 3600.0 + 5 * 86400.0
    jp = jbh.BehaveParams(behavior=behavior, **PARAMS)
    tp = bh.BehaveParams(behavior=behavior, **PARAMS)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    T = {k: torch.tensor(v) for k, v in d.items()}
    out_j = jbh.behave(None, None, jr.key(SEED), 17, J["pids"], J["x"],
                       J["y"], J["z"], jnp.asarray(t), J["age"], J["zeta"],
                       J["h"], (J["u"], J["v"]), jp)
    out_t = bh.behave(None, None, SEED, 17, T["pids"], T["x"], T["y"],
                      T["z"], torch.tensor(t, dtype=torch.float64),
                      T["age"], T["zeta"], T["h"], (T["u"], T["v"]), tp)
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    assert 0 < out_t[3].sum() < len(d["x"])             # some die
    if behavior:
        assert out_t[2].abs().max() > 0                 # a real move
    if behavior == 7:
        assert out_t[0].abs().max() > 0


def test_surface_irradiance_and_swim_speed_match_ltjax():
    p = bh.BehaveParams(**PARAMS)
    t = np.linspace(0.0, 2 * 86400.0, 997)
    age = np.linspace(0.0, 3 * 86400.0, 997)
    np.testing.assert_allclose(
        bh.surface_irradiance(torch.tensor(t), p, torch.float64).numpy(),
        np.asarray(jbh.surface_irradiance(jnp.asarray(t),
                                          jbh.BehaveParams(**PARAMS),
                                          jnp.float64)), rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        bh.swim_speed(torch.tensor(age), p, torch.float64).numpy(),
        np.asarray(jbh.swim_speed(jnp.asarray(age),
                                  jbh.BehaveParams(**PARAMS),
                                  jnp.float64)), rtol=0, atol=1e-15)


@pytest.mark.parametrize("behavior", [0, 1, 6])
def test_stochastic_mortality_matches_ltjax(behavior):
    n = 20000
    d = _inputs(n, seed=9)
    deadage, idt = 7200.0, 60.0
    kw = dict(PARAMS, behavior=behavior, deadage=deadage, idt=idt)
    # ages across release: unreleased particles (age < 0) never die
    d["age"] = np.where(np.arange(n) % 10 == 0, -100.0, 100.0)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    T = {k: torch.tensor(v) for k, v in d.items()}
    t = 5 * 86400.0

    def both(step, stochastic):
        jp = jbh.BehaveParams(stochastic=stochastic, **kw)
        tp = bh.BehaveParams(stochastic=stochastic, **kw)
        out_j = jbh.behave(None, None, jr.key(6), step, J["pids"], J["x"],
                           J["y"], J["z"], jnp.asarray(t), J["age"],
                           J["zeta"], J["h"], (J["u"], J["v"]), jp)
        out_t = bh.behave(None, None, 6, step, T["pids"], T["x"], T["y"],
                          T["z"], torch.tensor(t, dtype=torch.float64),
                          T["age"], T["zeta"], T["h"], (T["u"], T["v"]), tp)
        return out_t, out_j

    out_t, out_j = both(3, True)
    dies = out_t[3].numpy()
    np.testing.assert_array_equal(dies, np.asarray(out_j[3]))
    assert not dies[d["age"] < 0].any()
    released = d["age"] >= 0
    frac = dies[released].mean()
    p_die = -np.expm1(-idt / deadage)
    m = released.sum()
    assert abs(frac - p_die) < 5 * np.sqrt(p_die * (1 - p_die) / m), frac
    # another step draws other deaths
    assert not np.array_equal(dies, both(4, True)[0][3].numpy())
    # the walk draws do not depend on the mode
    off_t, _ = both(3, False)
    for a, b in zip(out_t[:3], off_t[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


def test_unknown_behavior_type_raises():
    d = {k: torch.tensor(v) for k, v in _inputs(8).items()}
    with pytest.raises(ValueError, match="Behavior=8"):
        bh.behave(None, None, SEED, 0, d["pids"], d["x"], d["y"], d["z"],
                  0.0, d["age"], d["zeta"], d["h"], (d["u"], d["v"]),
                  bh.BehaveParams(behavior=8))
