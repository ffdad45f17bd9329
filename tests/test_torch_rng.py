"""ltjax_torch.rng vs ltjax.rng on identical inputs.

Words (Threefry blocks, derived stream keys, per-particle bits, the
kernel's per-step key table) must be bit-equal.  The float maps:
``bits_to_uniform``/``bits_to_symmetric`` are exact in both packages
(a 24-bit integer times a power of two), so they are equal; the three
transcendental factors of Box-Muller (log, cos, sin) agree to 1 ulp
between XLA's and PyTorch's CPU libraries, so each deviate r cos(th) /
r sin(th), a product of two such factors, agrees to 2 ulp of r.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import rng as jrng
from ltjax.kernels import ext_step as jes
from ltjax_torch import rng
from ltjax_torch.kernels import ext_step as kx

SEEDS = [0, 7, 2 ** 33 + 5]
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def _pids(n=5000, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 31 - 1, n,
                                                dtype=np.int64
                                                ).astype(np.int32)


def _u32(a):
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_words_follow_jax_key(seed):
    """An int seed reads as jax.random.key(seed) (64-bit integers on, as
    under the tests' x64 setting); a word pair passes through."""
    k = jr.key(seed)
    assert rng.seed_words(seed) == tuple(int(v) for v in
                                         jrng.seed_words(k))
    kd = tuple(int(v) for v in np.asarray(jr.key_data(k)))
    assert rng.seed_words(kd) == kd


def test_threefry_words_equal():
    r = np.random.default_rng(1)
    k0, k1, x0, x1 = (r.integers(0, 2 ** 32, 4096, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    j0, j1 = jrng.threefry2x32(k0, k1, x0, x1)
    t0, t1 = rng.threefry2x32(torch.tensor(k0.astype(np.int64)),
                              torch.tensor(k1.astype(np.int64)),
                              torch.tensor(x0.astype(np.int64)),
                              torch.tensor(x1.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy(), _u32(j0))
    np.testing.assert_array_equal(t1.numpy(), _u32(j1))


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_key_and_particle_bits_equal(seed):
    pids = _pids()
    for step in (0, 29, 123456):
        for sub in (rng.HTURB, rng.VTURB, rng.BEHAVE, rng.MORTALITY,
                    rng.DEATH):
            js = jrng.stream_key(jr.key(seed), step, sub)
            ts = rng.stream_key(seed, step, sub)
            assert [int(v) for v in ts] == [int(v) for v in js]
            jb = jrng.particle_bits(js[0], js[1], jnp.asarray(pids))
            tb = rng.particle_bits(ts[0], ts[1], torch.tensor(pids))
            np.testing.assert_array_equal(tb[0].numpy(), _u32(jb[0]))
            np.testing.assert_array_equal(tb[1].numpy(), _u32(jb[1]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("behave", [False, True])
def test_rng_keys_array_equal(seed, behave):
    """The kernel's per-internal-step key table."""
    for ext_idx in (0, 3):
        j = np.asarray(jes.rng_keys_array(jr.key(seed), ext_idx, 30,
                                          behave=behave)).view(np.uint32)
        t = kx.rng_keys_array(seed, ext_idx, 30, behave=behave)
        assert t.dtype == np.uint32
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["float32", "float64"])
def test_uniform_maps_and_box_muller(jdt, tdt):
    js = jrng.stream_key(jr.key(3), 11, rng.HTURB)
    jb = jrng.particle_bits(js[0], js[1], jnp.asarray(_pids(20000, 2)))
    tb = (torch.tensor(_u32(jb[0])), torch.tensor(_u32(jb[1])))
    np.testing.assert_array_equal(rng.bits_to_uniform(tb[0], tdt).numpy(),
                                  np.asarray(jrng.bits_to_uniform(jb[0],
                                                                  jdt)))
    np.testing.assert_array_equal(
        rng.bits_to_symmetric(tb[1], tdt).numpy(),
        np.asarray(jrng.bits_to_symmetric(jb[1], jdt)))
    # the transcendental factors: 1 ulp
    u1 = np.asarray(jrng.bits_to_uniform(jb[0], jdt))
    th = np.asarray(jdt(2.0 * 3.14159265358979)
                    * jrng.bits_to_uniform(jb[1], jdt))
    for jf, tf, a in ((jnp.log, torch.log, u1), (jnp.cos, torch.cos, th),
                      (jnp.sin, torch.sin, th)):
        ref = np.asarray(jf(a))
        got = tf(torch.tensor(a)).numpy()
        assert (np.abs(got - ref) <= np.spacing(np.abs(ref))).all()
    # the deviates: 2 ulp of the radius
    j0, j1 = jrng.box_muller(jb[0], jb[1], jdt)
    t0, t1 = rng.box_muller(tb[0], tb[1], tdt)
    r = np.sqrt(-2.0 * np.log(u1.astype(np.float64))).astype(u1.dtype)
    for t, j in ((t0, j0), (t1, j1)):
        assert (np.abs(t.numpy() - np.asarray(j))
                <= 2 * np.spacing(r)).all()
    # and the draws of the public helpers follow from them
    pids = torch.tensor(_pids(20000, 2))
    un = rng.uniform(3, 11, rng.HTURB, pids, (2,), -1.0, 1.0, tdt)
    uj = jrng.uniform(jr.key(3), 11, rng.HTURB, jnp.asarray(pids.numpy()),
                      (2,), -1.0, 1.0, jdt)
    np.testing.assert_array_equal(un.numpy(), np.asarray(uj))
    nn = rng.normal(3, 11, rng.HTURB, pids, (2,), tdt)
    np.testing.assert_array_equal(nn[:, 0].numpy(), t0.numpy())
