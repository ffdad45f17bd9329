"""ltjax_torch.spatial vs ltjax.spatial: bit-equal Hilbert keys, the same
sort permutation (frozen particles last), and sort then unsort is the
identity on every column; the depth-banded key (band major, frozen
particles and a sharded run's EMPTY slots band 7) gives ltjax's
permutation, and more than 6 bands are refused with ltjax's message."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltjax import spatial as jsp
from ltjax import state as jst
from ltjax_torch import interop
from ltjax_torch import spatial as sp
from ltjax_torch import state as st

torch.set_num_threads(1)


def test_hilbert_key_bit_equal():
    rng = np.random.default_rng(0)
    i = rng.integers(0, 1 << 15, 20000).astype(np.int32)
    j = rng.integers(0, 1 << 15, 20000).astype(np.int32)
    i[:4] = [0, (1 << 15) - 1, 0, 40000]      # corners + a clamped value
    j[:4] = [0, (1 << 15) - 1, (1 << 15) - 1, -3]
    kj = np.asarray(jsp.hilbert_key(jnp.asarray(i), jnp.asarray(j)))
    kt = sp.hilbert_key(torch.tensor(i), torch.tensor(j)).numpy()
    np.testing.assert_array_equal(kt, kj)
    # small grids: every key distinct (a bijection on the 2^b square)
    g = np.arange(64)
    gi, gj = np.meshgrid(g, g)
    k = sp.hilbert_key(torch.tensor(gi.ravel()), torch.tensor(gj.ravel()))
    assert len(np.unique(k.numpy())) == 64 * 64


def test_sort_unsort_roundtrip_matches_ltjax():
    rng = np.random.default_rng(1)
    n = 1000
    p = jst.init_particles(rng.uniform(0, 5e4, n), rng.uniform(0, 5e4, n),
                           rng.uniform(-30, 0, n), dtype=jnp.float32)
    status = rng.choice([st.ACTIVE, st.OUT_OF_DOMAIN, st.NOT_RELEASED], n)
    p = p._replace(status=jnp.asarray(status, jnp.int32),
                   hit_land=jnp.asarray(rng.integers(0, 5, n), jnp.int32))
    ci = rng.integers(0, 50, n).astype(np.int32)
    cj = rng.integers(0, 50, n).astype(np.int32)
    ps_j, perm_j = jsp.sort_by_cell(p, jnp.asarray(ci), jnp.asarray(cj))
    pt = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()})
    ps_t, perm_t = sp.sort_by_cell(pt, torch.tensor(ci), torch.tensor(cj))
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    sorted_np = interop.particles_to_numpy(ps_t)
    for k, v in ps_j._asdict().items():
        np.testing.assert_array_equal(sorted_np[k], np.asarray(v))
    # frozen particles sort last
    s = ps_t.status.numpy()
    assert (s[: (s < st.SETTLED).sum()] < st.SETTLED).all()
    back = interop.particles_to_numpy(sp.unsort(ps_t, perm_t))
    for k, v in interop.particles_to_numpy(pt).items():
        np.testing.assert_array_equal(back[k], v)


def _banded_inputs(n, n_bands, lo, hi, seed):
    """A float32 batch with frozen and not-released particles, cells on a
    50 x 50 grid and depth bands in [lo, hi] (outside [0, n_bands - 1]
    they clip)."""
    rng = np.random.default_rng(seed)
    p = jst.init_particles(rng.uniform(0, 5e4, n), rng.uniform(0, 5e4, n),
                           rng.uniform(-30, 0, n), dtype=jnp.float32)
    status = rng.choice([st.ACTIVE, st.ACTIVE, st.NOT_RELEASED, st.SETTLED,
                         st.DEAD, st.OUT_OF_DOMAIN, st.ERROR], n)
    p = p._replace(status=jnp.asarray(status, jnp.int32))
    ci = rng.integers(0, 50, n).astype(np.int32)
    cj = rng.integers(0, 50, n).astype(np.int32)
    band = rng.integers(lo, hi + 1, n).astype(np.int32)
    return p, ci, cj, band


BANDED = {"2-in-range": (2, 0, 1), "3-clipped": (3, -3, 6),
          "6-clipped": (6, -2, 9)}


@pytest.mark.parametrize("name", list(BANDED))
def test_banded_sort_matches_ltjax(name):
    """The banded key (band major, 14-bit Hilbert minor, frozen band 7):
    ltjax's permutation and sorted columns, bands in order, frozen
    particles last."""
    nb, lo, hi = BANDED[name]
    p, ci, cj, band = _banded_inputs(2000, nb, lo, hi, seed=nb)
    ps_j, perm_j = jsp.sort_by_cell(p, jnp.asarray(ci), jnp.asarray(cj),
                                    depth_band=jnp.asarray(band), n_bands=nb)
    pt = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()})
    ps_t, perm_t = sp.sort_by_cell(pt, torch.tensor(ci), torch.tensor(cj),
                                   depth_band=torch.tensor(band),
                                   n_bands=nb)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    sorted_np = interop.particles_to_numpy(ps_t)
    for k, v in ps_j._asdict().items():
        np.testing.assert_array_equal(sorted_np[k], np.asarray(v))
    s = ps_t.status.numpy()
    live = s < st.SETTLED
    assert live[: live.sum()].all() and not live[live.sum():].any()
    b = np.clip(band, 0, nb - 1)[perm_t.numpy()][: live.sum()]
    assert (np.diff(b) >= 0).all() and len(np.unique(b)) == nb


def test_banded_sort_parks_empty_slots():
    """A sharded run's EMPTY slots (status -1) take the frozen band 7:
    after every live particle, in ltjax's order for the same batch with
    the slots frozen (ltjax's key has no EMPTY status)."""
    p, ci, cj, band = _banded_inputs(1500, 3, 0, 2, seed=11)
    status = np.asarray(p.status).copy()
    empty = np.random.default_rng(12).random(status.size) < 0.2
    status[empty] = -1
    pt = interop.particles_from_numpy(
        {**{k: np.asarray(v) for k, v in p._asdict().items()},
         "status": status})
    _, perm_t = sp.sort_by_cell(pt, torch.tensor(ci), torch.tensor(cj),
                                depth_band=torch.tensor(band), n_bands=3)
    frozen = np.where(empty, st.DEAD, status).astype(np.int32)
    _, perm_j = jsp.sort_by_cell(p._replace(status=jnp.asarray(frozen)),
                                 jnp.asarray(ci), jnp.asarray(cj),
                                 depth_band=jnp.asarray(band), n_bands=3)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    s = status[perm_t.numpy()]
    live = (s >= 0) & (s < st.SETTLED)
    assert live[: live.sum()].all() and (s[live.sum():] != st.ACTIVE).all()


@pytest.mark.parametrize("n_bands", [0, 7])
def test_banded_sort_refuses_n_bands(n_bands):
    p, ci, cj, band = _banded_inputs(10, 3, 0, 2, seed=1)
    pt = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()})
    with pytest.raises(ValueError, match=r"n_bands must be in \[1, 6\]"):
        sp.sort_by_cell(pt, torch.tensor(ci), torch.tensor(cj),
                        depth_band=torch.tensor(band), n_bands=n_bands)
