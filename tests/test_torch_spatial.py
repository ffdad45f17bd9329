"""ltjax_torch.spatial vs ltjax.spatial: bit-equal Hilbert keys, the same
sort permutation (frozen particles last), and sort then unsort is the
identity on every column."""

import jax.numpy as jnp
import numpy as np
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
