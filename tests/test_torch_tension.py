"""ltjax_torch.tension vs ltjax.tension on identical numpy inputs.

Tolerances: float64 is an algorithm check, 1e-9 on O(1) spline values
(the same formulas in the same order; differences are round-off);
float32 allows 2e-5, a few hundred ulps of O(1) values after a
~12-level Thomas sweep.  Knot second derivatives (O(10) here) get 10x
those.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltjax import tension as jt
from ltjax_torch import tension as tt

torch.set_num_threads(1)

TOL = {"float64": 1e-9, "float32": 2e-5}


def _inputs(seed, batch=64, k=12):
    rng = np.random.default_rng(seed)
    xk = np.cumsum(rng.uniform(0.2, 2.0, (batch, k)), axis=-1) - 10.0
    yk = np.sin(xk) + 0.1 * rng.standard_normal((batch, k))
    xq = rng.uniform(xk[:, 0] - 1.0, xk[:, -1] + 1.0)   # incl. clamping
    return xk, yk, xq


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("sigma", [0.0, 4.0])
def test_fit_evaluate_match_ltjax(sigma, dtype):
    xk, yk, xq = _inputs(3)
    z2_j = jt.fit(jnp.asarray(xk, dtype), jnp.asarray(yk, dtype),
                  jnp.asarray(sigma, dtype))
    v_j = jt.evaluate(jnp.asarray(xk, dtype), jnp.asarray(yk, dtype), z2_j,
                      jnp.asarray(sigma, dtype), jnp.asarray(xq, dtype))
    tdt = getattr(torch, dtype)
    xk_t, yk_t = torch.tensor(xk, dtype=tdt), torch.tensor(yk, dtype=tdt)
    z2_t = tt.fit(xk_t, yk_t, sigma)
    v_t = tt.evaluate(xk_t, yk_t, z2_t, sigma, torch.tensor(xq, dtype=tdt))
    np.testing.assert_allclose(z2_t.numpy(), np.asarray(z2_j), rtol=0,
                               atol=TOL[dtype] * 10)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_basis_functions_match_ltjax(dtype):
    """gs/ds on both sides of the small-tension series crossover."""
    u = np.array([0.0, 0.01, 0.3, 0.6, 1.0, 4.0, 20.0])[:, None]
    B = np.linspace(0.0, 1.0, 11)[None, :]
    u, B = np.broadcast_arrays(u, B)
    tdt = getattr(torch, dtype)
    for jf, tf in ((jt._gs, tt._gs), (jt._ds, tt._ds)):
        vj = np.asarray(jf(jnp.asarray(u, dtype), jnp.asarray(B, dtype)))
        vt = tf(torch.tensor(u, dtype=tdt), torch.tensor(B, dtype=tdt))
        np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=TOL[dtype])
