"""The Hilbert sort key (``kernels/sort_key.py``) on the CPU:

* CPU tensors take the plain version and launch nothing;
* the int32 key sorts as the int64 key that ``spatial.sort_by_cell``
  built before the kernel (a frozen copy below): the same stable
  permutation, unbanded and banded, with parked and EMPTY slots, cells
  clamped at the mask and many ties;
* the kernel's unsigned 32-bit walk of the curve (``csrc/sort_key.cu``,
  emulated in numpy) gives the plain version's keys bit for bit;
* the wrapper's checks, and ``run.kernel_targets`` naming the key's
  build on every route.

The kernel itself runs in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from ltjax_torch import run as trun
from ltjax_torch import spatial as sp
from ltjax_torch import state as st
from ltjax_torch import synth
from ltjax_torch.config import Config
from ltjax_torch.kernels import sort_key as sk

torch.set_num_threads(1)

STATUSES = [st.NOT_RELEASED, st.ACTIVE, st.SETTLED, st.DEAD,
            st.OUT_OF_DOMAIN, st.ERROR, -1]


def _int64_key(i, j, status, depth_band=None, n_bands=1):
    """sort_by_cell's key before the kernel, as it was (int64)."""
    parked = (status >= st.SETTLED) | (status < 0)
    if depth_band is None:
        key = sk.hilbert_key(i, j).to(torch.int64)
        return key + parked.to(torch.int64) * (1 << 30)
    band = depth_band.to(torch.int64).clamp(0, n_bands - 1)
    band = torch.where(parked, 7, band)
    return sk.hilbert_key(i, j, bits=14).to(torch.int64) + (band << 28)


def _slots(n, seed, hi=1 << 15, cells=None, statuses=STATUSES):
    """Cells over [-8, hi + 8) (clamped at both ends), or drawn from
    ``cells`` values only (ties), and statuses from ``statuses``."""
    rng = np.random.default_rng(seed)
    if cells is None:
        i = rng.integers(-8, hi + 8, n)
        j = rng.integers(-8, hi + 8, n)
    else:
        i = rng.choice(cells, n)
        j = rng.choice(cells, n)
    i[:6] = [0, hi - 1, 0, hi + 40000, -3, hi - 1]
    j[:6] = [0, hi - 1, hi - 1, -3, hi + 7, 0]
    status = rng.choice(statuses, n)
    band = rng.integers(-2, 9, n)
    t = (lambda a: torch.tensor(a, dtype=torch.int32))
    return t(i), t(j), t(status), t(band)


def _particles(status):
    n = status.shape[0]
    p = st.init_particles(np.arange(n, dtype=np.float64), np.zeros(n),
                          np.zeros(n))
    return p.replace(status=status, pid=torch.arange(n, dtype=torch.int32))


CASES = {
    "unbanded": dict(bands=None),
    "unbanded-ties": dict(bands=None, cells=[0, 1, 5, 40000]),
    "unbanded-live-only": dict(bands=None, statuses=[0, 1]),
    "unbanded-parked-only": dict(bands=None, statuses=[2, 3, 4, 5, -1]),
    "banded-1": dict(bands=1),
    "banded-3": dict(bands=3),
    "banded-6": dict(bands=6),
    "banded-6-ties": dict(bands=6, cells=[0, 3, 20000]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_int32_key_sorts_as_the_int64_key(name):
    kw = dict(CASES[name])
    nb = kw.pop("bands")
    hi = 1 << (15 if nb is None else 14)
    i, j, status, band = _slots(20000, 7, hi=hi, **kw)
    depth_band = None if nb is None else band
    key = sk.sort_key(i, j, status, depth_band, nb or 1)
    old = _int64_key(i, j, status, depth_band, nb or 1)
    assert key.dtype == torch.int32
    assert int(key.min()) >= 0
    torch.testing.assert_close(key.to(torch.int64), old, rtol=0, atol=0)
    want = torch.argsort(old, stable=True)
    _, perm = sp.sort_by_cell(_particles(status), i, j, depth_band, nb or 1)
    assert torch.equal(perm, want)
    # parked and EMPTY slots sort after every live one
    parked = ((status >= st.SETTLED) | (status < 0))[perm]
    n_live = int((~parked).sum())
    assert not parked[:n_live].any() and parked[n_live:].all()


def test_cpu_tensors_take_the_plain_version():
    i, j, status, band = _slots(4096, 3)
    before = sk.sort_key.launches
    for depth_band, nb in ((None, 1), (band, 4)):
        got = sk.sort_key(i, j, status, depth_band, nb)
        assert torch.equal(got, sk.plain_key(i, j, status, depth_band, nb))
    sp.sort_by_cell(_particles(status), i, j)
    assert sk.sort_key.launches == before == 0


def _kernel_walk(i, j, status, band, bits, n_bands):
    """csrc/sort_key.cu's arithmetic on numpy uint32 (wrapping) values."""
    top = (1 << bits) - 1
    x = np.clip(i, 0, top).astype(np.uint32)
    y = np.clip(j, 0, top).astype(np.uint32)
    d = np.zeros_like(x)
    s = np.uint32(1 << (bits - 1))
    one = np.uint32(1)
    with np.errstate(over="ignore"):
        while s:
            rx = ((x & s) != 0).astype(np.uint32)
            ry = ((y & s) != 0).astype(np.uint32)
            d += s * s * ((np.uint32(3) * rx) ^ ry)
            flip = (ry == 0) & (rx == 1)
            x = np.where(flip, s - one - x, x).astype(np.uint32)
            y = np.where(flip, s - one - y, y).astype(np.uint32)
            swap = ry == 0
            x, y = np.where(swap, y, x), np.where(swap, x, y)
            s = np.uint32(s >> 1)
    parked = (status >= st.SETTLED) | (status < 0)
    if band is None:
        hi = np.where(parked, 1 << 30, 0).astype(np.uint32)
    else:
        hi = (np.where(parked, 7, np.clip(band, 0, n_bands - 1))
              .astype(np.uint32) << np.uint32(28))
    return (d + hi).astype(np.int32)


@pytest.mark.parametrize("bits,n_bands", [(15, None), (14, 2), (14, 6)])
def test_kernel_arithmetic_matches_the_plain_key(bits, n_bands):
    """The kernel walks the curve on wrapping uint32 where the plain
    version goes negative in int64: the keys agree bit for bit."""
    i, j, status, band = _slots(50000, bits, hi=1 << bits)
    depth_band = None if n_bands is None else band
    want = sk.plain_key(i, j, status, depth_band, n_bands or 1).numpy()
    got = _kernel_walk(i.numpy(), j.numpy(), status.numpy(),
                       None if depth_band is None else band.numpy(), bits,
                       n_bands or 1)
    np.testing.assert_array_equal(got, want)
    # every cell of a small square, live
    g = np.arange(64, dtype=np.int32)
    gi, gj = (a.ravel() for a in np.meshgrid(g, g))
    zero = np.zeros_like(gi)
    want = sk.plain_key(torch.tensor(gi), torch.tensor(gj),
                        torch.tensor(zero)).numpy()
    np.testing.assert_array_equal(_kernel_walk(gi, gj, zero, None, 15, 1),
                                  want)


def test_wrapper_checks_its_inputs():
    i, j, status, band = _slots(64, 5)
    with pytest.raises(ValueError, match="int32"):
        sk._check(i.long(), j, status, None)
    with pytest.raises(ValueError, match="contiguous"):
        sk._check(i, torch.stack([j, j], 1)[:, 0], status, None)
    with pytest.raises(ValueError, match="int32"):
        sk._check(i, j, status, band[:10])
    sk._check(i, j, status, band)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.sort_key(i.to("meta"), j.to("meta"), status.to("meta"))
    with pytest.raises(ValueError, match=r"n_bands must be in \[1, 6\]"):
        sk.sort_key(i, j, status, band, 7)


@pytest.mark.parametrize("route", ["native", "packed", "ext_step"])
def test_kernel_targets_name_the_sort_key_on_every_route(route):
    g = synth.make_solid_body_case(nx=9, ny=9, us=4, lx=8e3, ly=8e3).grid
    kw = {"native": dict(fast_interp=False),
          "packed": dict(kernel_interp=False), "ext_step": {}}[route]
    targets = trun.kernel_targets(Config(numpar=1, us=4, ws=5, **kw), g)
    assert targets[-1] == ("sort_key", None)
    assert [t[0] for t in targets] == (
        ["sort_key"] if route != "ext_step" else ["ext_step", "sort_key"])
