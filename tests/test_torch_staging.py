"""The staged corner source's sizing rule, ``kernels.ext_step.block_boxes``
(plain PyTorch, the rule of the whole-step CUDA kernel and its wrapper),
and the stretched ladder with hc < h0 that the kernels are checked on.

block_boxes gives each block of BLOCK particles the rho points of its
active particles' cells grown by one cell on each side; the kernel stages
three tiles of those points (csrc ext_step.cu) when they number at most
tile_points(nl), one tile at a time in the same bytes ("split") when they
number at most three times that, and runs the block from device memory
otherwise:

* a Hilbert-sorted batch as dense as the main path's (chip_smoke.py
  phase 2: ~70 particles a 1 km cell) fits, the same batch unsorted
  overflows both tiers;
* the same sorted batch spread over -49..-1 m and carried an hour by a
  rotation sheared in depth (rate x (1 + 0.01 z), the sheared cell's)
  drifts apart at different depths: most of its blocks stage split;
* the one-cell margin holds every RK4 stage of one internal step at the
  main path's speeds (solid-body rotation, omega 5e-5 on the 200 km
  bench grid: up to 4.2 m/s, 0.5 km in 120 s on 1 km cells);
* nl padding (odd lanes) and the byte counts follow the formula of the
  kernel note, and the kernel's block size and padding are the module's.

The stretched ladder (theta_s = 4, hc = 10 m < h0 = 50 m) makes the
s-level depths depend on both Cs and hc; the port's synthetic grid and
the plain RK4 displacement on it are held against ltjax's (its grid given
the same hc) in float64 to 1e-9.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltjax import packed as jpk
from ltjax import scoord as jsc
from ltjax import synth as jsynth
from ltjax_torch import interop
from ltjax_torch import packed as pk
from ltjax_torch import scoord
from ltjax_torch import state as st
from ltjax_torch import synth
from ltjax_torch.kernels import ext_step as kx
from ltjax_torch.kernels import rk4_step as kr
from ltjax_torch.step import _sort

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(kx.__file__), "csrc")


def _bench(nx=200):
    """chip_smoke.py's bench grid: 200 km square, 1 km cells, omega 5e-5."""
    return synth.make_solid_body_case(nx=nx, ny=nx, us=4, lx=200e3,
                                      ly=200e3, h0=50.0, omega=5e-5,
                                      dtype=torch.float32)


def _batch(case, n, lo, hi, seed, sort=True, z=(-40.0, -5.0)):
    rng = np.random.default_rng(seed)
    p = st.init_particles(rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                          rng.uniform(*z, n), dtype=torch.float32)
    p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
    return _sort(case.grid, p)[0] if sort else p


@pytest.mark.parametrize("nl", [63, 84, 103])
def test_sorted_batch_fits_and_unsorted_overflows(nl):
    """Phase 2's density (~70 a cell) on a 40 x 40 km patch."""
    case = _bench()
    p = _batch(case, 112_000, 80e3, 120e3, seed=0, sort=False)
    ps, _ = _sort(case.grid, p)
    b = kx.block_boxes(case.grid, ps.x, ps.y, ps.status, nl)
    assert bool(b["live"].all())
    assert float(b["fits"].double().mean()) > 0.97
    assert not bool((b["fits"] & b["split"]).any())
    assert int(b["points"].median()) <= 25
    u = kx.block_boxes(case.grid, p.x, p.y, p.status, nl)
    assert not bool(u["fits"].any()) and not bool(u["split"].any())
    assert int(u["points"].min()) > 30 * 30


@pytest.mark.parametrize("nl", [63, 124])
def test_sheared_sorted_batch_stages_split(nl):
    """Phase 2's density on a 40 x 40 km patch 20-60 km east and north of
    the centre, sorted, then an hour of the sheared rotation: the boxes
    grow past three tiles' budget and stay within a split tile's, whose
    one tile takes no more than the launch's shared memory."""
    case = synth.make_solid_body_case(nx=200, ny=200, us=4, lx=200e3,
                                      ly=200e3, h0=50.0, omega=5e-5,
                                      shear_a=0.01, dtype=torch.float32)
    p = _batch(case, 112_000, 120e3, 160e3, seed=3, z=(-49.0, -1.0))
    b0 = kx.block_boxes(case.grid, p.x, p.y, p.status, nl)
    assert float(b0["fits"].double().mean()) > 0.97
    x, y, _ = case.analytic(*(v.double().numpy() for v in (p.x, p.y, p.z)),
                            3600.0)
    b = kx.block_boxes(case.grid, torch.tensor(x, dtype=torch.float32),
                       torch.tensor(y, dtype=torch.float32), p.status, nl)
    pts, ls = kx.tile_points(nl), kx.tile_lanes(nl)
    split = b["split"]
    assert float(split.double().mean()) > 0.9
    assert not bool((b["fits"] & split).any())
    assert bool((b["points"][split] > pts).all())
    assert bool((b["points"][split] <= 3 * pts).all())
    assert bool((4 * ls * b["points"][split] <= kx.stage_bytes(nl)).all())
    # nbytes stays the bytes of three tiles of the box
    assert torch.equal(b["nbytes"], 3 * 4 * ls * b["points"])


def test_margin_holds_one_internal_step_at_main_path_speeds():
    """Every RK4 stage position of one internal step (the analytic
    velocity; stage 4 at x + u idt reaches furthest) lies in a cell whose
    four corners are in its block's box."""
    case = _bench()
    idt = 120.0
    p = _batch(case, 65_536, 40e3, 160e3, seed=1)
    b = kx.block_boxes(case.grid, p.x, p.y, None, 63)
    x, y = p.x.double().numpy(), p.y.double().numpy()
    u, v, _ = case.velocity(x, y, 0.0, 0.0)
    dx = float(case.grid.x_rho[1] - case.grid.x_rho[0])
    assert float(np.hypot(u, v).max()) * idt < 0.55 * dx
    blk = np.arange(p.n) // kx.BLOCK
    for f in (0.5, 1.0):                          # stages 2-3, stage 4
        xs = torch.tensor(x + f * u * idt, dtype=torch.float32)
        ys = torch.tensor(y + f * v * idt, dtype=torch.float32)
        q = kx.block_boxes(case.grid, xs, ys, None, 63, block=1)
        i, j = q["i0"].numpy() + 1, q["j0"].numpy() + 1   # the cells
        assert (i >= b["i0"].numpy()[blk]).all()
        assert (i + 1 <= b["i1"].numpy()[blk]).all()
        assert (j >= b["j0"].numpy()[blk]).all()
        assert (j + 1 <= b["j1"].numpy()[blk]).all()


def test_box_bounds_padding_and_bytes():
    case = _bench(nx=41)           # cells of 5 km
    g = case.grid
    # block 0: cells (3, 7) and (5, 8); block 1: cell (0, 39) at the rim
    # and one frozen particle far away; block 2: no active particle
    xs = [17e3, 27e3, 1e3, 150e3, 100e3, 110e3]
    ys = [37e3, 42e3, 199e3, 10e3, 100e3, 110e3]
    status = [st.ACTIVE, st.ACTIVE, st.ACTIVE, st.DEAD, st.SETTLED,
              st.NOT_RELEASED]
    b = kx.block_boxes(g, torch.tensor(xs, dtype=torch.float32),
                       torch.tensor(ys, dtype=torch.float32),
                       torch.tensor(status, dtype=torch.int32), nl=84,
                       block=2)
    assert b["i0"].tolist() == [2, 0, -1] and b["i1"].tolist() == [7, 2, -1]
    assert b["j0"].tolist() == [6, 38, -1] and b["j1"].tolist() == [10, 40,
                                                                      -1]
    assert b["live"].tolist() == [True, True, False]
    assert b["points"].tolist() == [30, 9, 0]
    ls = kx.tile_lanes(84)
    assert ls == 85 and kx.tile_lanes(63) == 63 and kx.tile_lanes(124) == 125
    assert b["nbytes"].tolist() == [3 * 4 * ls * 30, 3 * 4 * ls * 9, 0]
    assert b["fits"].tolist() == [True, True, False]
    assert b["split"].tolist() == [False, False, False]
    for nl in (63, 84, 103, 124):
        pts = kx.tile_points(nl)
        assert pts == min(kx.STAGE_POINTS,
                          kx.STAGE_BYTES // (12 * kx.tile_lanes(nl)))
        assert kx.stage_bytes(nl) == 12 * kx.tile_lanes(nl) * pts
        assert kx.stage_bytes(nl) <= kx.STAGE_BYTES
    assert kx.tile_points(63) == 36 and kx.tile_points(124) == 32


def test_kernel_uses_the_modules_block_and_padding():
    """The CUDA source launches BLOCK threads and pads lanes as tile_lanes
    does: the host's sizing rule is the kernel's."""
    with open(os.path.join(CSRC, "ext_step.cu")) as f:
        src = f.read()
    assert f"#define LTX_BLOCK {kx.BLOCK}" in src
    assert "(nl | 1)" in src and "<<<blocks, LTX_BLOCK, smem" in src


def test_counters_start_at_zero_and_cpu_launches_nothing():
    kx.reset_launches()
    assert kx.counts() == dict.fromkeys(kx.COUNTERS, 0)


def _stretched_pair(hc=10.0):
    c = jsynth.make_solid_body_case(nx=41, ny=41, us=10, lx=100e3, ly=100e3,
                                    h0=50.0, omega=1e-4, shear_a=0.004,
                                    theta_s=4.0, dtype=jnp.float64)
    jgrid = c.grid._replace(hc=hc)
    tc = synth.make_solid_body_case(nx=41, ny=41, us=10, lx=100e3, ly=100e3,
                                    h0=50.0, omega=1e-4, shear_a=0.004,
                                    theta_s=4.0, hc=hc, dtype=torch.float64)
    return c, jgrid, tc


def test_stretched_hc_depths_match_ltjax_and_depend_on_cs_and_hc():
    c, jgrid, tc = _stretched_pair()
    g = tc.grid
    assert g.hc == 10.0
    h = np.full(3, 50.0)
    zeta = np.array([-0.3, 0.0, 0.4])
    for s, cs, js, jcs in ((g.s_rho, g.Cs_r, jgrid.s_rho, jgrid.Cs_r),
                           (g.s_w, g.Cs_w, jgrid.s_w, jgrid.Cs_w)):
        s, cs = s.numpy(), cs.numpy()
        z = scoord.s_depths(zeta, h, s, cs, g.hc, g.vtransform)
        np.testing.assert_allclose(z, np.asarray(jsc.s_depths(
            jnp.asarray(zeta), jnp.asarray(h), js, jcs, jgrid.hc,
            jgrid.vtransform)), rtol=0, atol=1e-9)
        assert np.abs(z - scoord.s_depths(zeta, h, s, s, g.hc, 1)).max() > 1
        assert np.abs(z - scoord.s_depths(zeta, h, s, cs, 50.0, 1)).max() > 1


def test_stretched_hc_rk4_matches_ltjax_collapsed_f64():
    c, jgrid, tc = _stretched_pair()
    fs = jsynth.fieldset_for(c, t_center=1800.0, dt=3600.0,
                             dtype=jnp.float64)
    jtabs = jpk.stage_value_tables(jgrid, jpk.build_packed_records(jgrid,
                                                                   fs),
                                   100.0, 120.0)
    tabs = pk.stage_value_tables(tc.grid, pk.build_packed_records(
        tc.grid, interop.fieldset_from_numpy(
            {k: np.asarray(v) for k, v in fs._asdict().items()})), 100.0,
        120.0)
    rng = np.random.default_rng(5)
    x, y = rng.uniform(30e3, 70e3, 256), rng.uniform(30e3, 70e3, 256)
    z = rng.uniform(-49.0, -1.0, 256)
    want = jpk.rk4_displacement_collapsed(jgrid, jtabs, jnp.asarray(x),
                                          jnp.asarray(y), jnp.asarray(z),
                                          0.0, 5e-4, 120.0)
    out = kr.rk4_displacement_fused(tc.grid, tabs, *(torch.from_numpy(v)
                                                     for v in (x, y, z)),
                                    0.0, 5e-4, 120.0)
    for a, b in zip(out, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    assert float(out[0].abs().max()) > 1.0
