"""ltjax_torch.physics.boundary vs ltjax.physics.boundary.

``build_boundaries`` must give exactly the arrays ltjax builds (same
numpy code); ``reflect``/``reflect_vertical`` must agree on paths that
hit land, exit through the open rim, tunnel over a one-cell spit, and
exceed the displacement guard.  Float64, tolerance 1e-6 m (algorithm
check); status flags and hit counts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltjax.physics import boundary as jbd
from ltjax_torch import interop
from ltjax_torch.physics import boundary as bd

torch.set_num_threads(1)

NX, NY = 24, 20
DX = 1000.0


def _mask():
    mask = np.ones((NY, NX), np.int32)
    mask[8:12, 10:14] = 0          # land block
    mask[2:18, 18] = 0             # one-cell spit (tunnel target)
    return mask


@pytest.fixture(scope="module", params=["uniform", "stretched"])
def bounds_pair(request):
    """Uniform 1 km cells (arithmetic cell location), or x cells
    stretched 0.8-1.2 km (searchsorted cell location)."""
    x = np.arange(NX) * DX
    if request.param == "stretched":
        x = np.concatenate([[0.0], np.cumsum(np.linspace(800.0, 1200.0,
                                                          NX - 1))])
    y = np.arange(NY) * DX
    jb = jbd.build_boundaries(_mask(), x, y)
    tb = bd.build_boundaries(_mask(), x, y)
    return jb, tb


def _paths(seed=0, n=3000):
    """Random short moves (most hit nothing) plus scripted ones."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-400.0, (NX - 1) * DX + 400.0, n)
    y0 = rng.uniform(-400.0, (NY - 1) * DX + 400.0, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(0.0, 1800.0, n)
    x1 = x0 + r * np.cos(ang)
    y1 = y0 + r * np.sin(ang)
    scripted = np.array([
        [9200.0, 9500.0, 10700.0, 9600.0],    # into the land block
        [14800.0, 9900.0, 13300.0, 10100.0],  # into it from the east
        [22500.0, 5000.0, 23800.0, 5200.0],   # out through the east rim
        [5000.0, 600.0, 5100.0, -700.0],      # out through the south rim
        [17300.0, 9000.0, 19700.0, 9100.0],   # over the spit (tunnel)
        [3000.0, 3000.0, 6500.0, 3000.0],     # beyond the guard radius
        [9200.0, 7200.0, 10600.0, 8600.0],    # into the block's corner
    ])
    x0 = np.concatenate([x0, scripted[:, 0]])
    y0 = np.concatenate([y0, scripted[:, 1]])
    x1 = np.concatenate([x1, scripted[:, 2]])
    y1 = np.concatenate([y1, scripted[:, 3]])
    return x0, y0, x1, y1


def test_build_boundaries_arrays_equal(bounds_pair):
    jb, tb = bounds_pair
    for k in ("seg_a", "seg_b", "seg_kind", "bucket", "x_edges", "y_edges",
              "water", "cell_rows"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    assert tb.uniform == jb.uniform
    # the interop path carries the same arrays
    tb2 = interop.boundaries_from_numpy(
        {k: np.asarray(v) for k, v in jb._asdict().items()})
    np.testing.assert_array_equal(tb2.cell_rows.numpy(),
                                  tb.cell_rows.numpy())
    assert tb2.edges == tb.edges


@pytest.mark.parametrize("open_exits", [True, False])
def test_reflect_matches_ltjax(bounds_pair, open_exits):
    jb, tb = bounds_pair
    x0, y0, x1, y1 = _paths()
    rj = jbd.reflect(jb, *(jnp.asarray(a) for a in (x0, y0, x1, y1)),
                     open_exits=open_exits, n_iter=3)
    rt = bd.reflect(tb, *(torch.tensor(a) for a in (x0, y0, x1, y1)),
                    open_exits=open_exits, n_iter=3)
    xr_j, yr_j, hits_j, ex_j, stuck_j = (np.asarray(a) for a in rj)
    xr_t, yr_t, hits_t, ex_t, stuck_t = (a.numpy() for a in rt)
    np.testing.assert_array_equal(ex_t, ex_j)
    np.testing.assert_array_equal(stuck_t, stuck_j)
    np.testing.assert_array_equal(hits_t, hits_j)
    np.testing.assert_allclose(xr_t, xr_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(yr_t, yr_j, rtol=0, atol=1e-6)
    assert hits_t.sum() > 10 and stuck_t.sum() > 2
    if not tb.uniform:
        return
    # every scripted case did what it was written for (1 km cells)
    k = len(x0) - 7
    assert hits_t[k] >= 1 and hits_t[k + 1] >= 1
    if open_exits:
        assert ex_t[k + 2] and ex_t[k + 3]
    assert stuck_t[k + 4] and stuck_t[k + 5]


def test_reflect_vertical_matches_ltjax():
    rng = np.random.default_rng(4)
    n = 500
    h = rng.uniform(5.0, 60.0, n)
    zeta = rng.uniform(-0.5, 0.5, n)
    z = rng.uniform(-1.3 * h, 1.0 + zeta)
    rj = jbd.reflect_vertical(jnp.asarray(z), jnp.asarray(zeta),
                              jnp.asarray(h))
    rt = bd.reflect_vertical(torch.tensor(z), torch.tensor(zeta),
                             torch.tensor(h))
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(rt[1].numpy(), np.asarray(rj[1]))
    np.testing.assert_array_equal(rt[2].numpy(), np.asarray(rj[2]))
    assert rt[1].any() and rt[2].any()
