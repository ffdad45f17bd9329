"""The slice as a whole: ltjax_torch.step.make_fused_external_steps vs
ltjax.step.make_fused_external_steps, and the options outside the slice.

Setup: tests/test_kernel.py's fused multi-step case (41x41 grid, us = 6,
256 particles, a 4-record window, n_fuse = 2) plus a land block.  The
JAX side runs its Pallas megakernel in interpret mode at f32-exact
precision (kernel_precision="highest"), with its exact out-of-window
patch, so every particle is comparable.  Tolerances (float32, as
tests/test_kernel.py): horizontal 0.5 m, vertical 1e-3 m; statuses
equal.
"""

import dataclasses

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import state as jst
from ltjax import synth as jsynth
from ltjax.config import Config
from ltjax.physics import boundary as jbd
from ltjax.step import StepContext as JContext
from ltjax.step import make_fused_external_steps as j_fused
from ltjax_torch import interop
from ltjax_torch import step as tstep
from ltjax_torch import synth
from ltjax_torch.physics import boundary as bd

torch.set_num_threads(1)


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _mask():
    mask = np.ones((41, 41), np.int32)
    mask[19:22, 21:23] = 0
    return mask


def _cfg(**kw):
    base = dict(numpar=256, dt=1800, idt=450, us=6, ws=7,
                OpenOceanBoundary=True, dtype_pos="float32",
                reflect_iters=2, kernel_block=256,
                kernel_precision="highest", TrackCollisions=True)
    base.update(kw)
    return Config(**base)


def test_fused_steps_match_ltjax():
    dtype = jnp.float32
    c = jsynth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                    h0=50.0, omega=5e-5, dtype=dtype)
    grid = c.grid._replace(mask_rho=jnp.asarray(_mask()))
    dt = 1800.0
    fsR = jsynth.fieldset_window(c, -0.5 * dt, dt, 4, dtype=dtype)
    bounds = jbd.build_boundaries(_mask(), np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    cfg = _cfg()
    rng = np.random.default_rng(3)
    n = 256
    p = jst.init_particles(rng.uniform(38e3, 52e3, n),
                           rng.uniform(38e3, 52e3, n),
                           rng.uniform(-40.0, -5.0, n), dtype=dtype)
    p = p._replace(status=jnp.full(n, jst.ACTIVE, jnp.int32))
    pj = j_fused(JContext(grid=grid, bounds=bounds, polys=None, holes=None),
                 cfg, jr.key(0), 2, interpret=True)(p, fsR, 0.0, 0)

    ctx = tstep.StepContext(grid=interop.grid_from_numpy(_np(grid)),
                            bounds=interop.boundaries_from_numpy(
                                _np(bounds)))
    pt = tstep.make_fused_external_steps(ctx, cfg, 2)(
        interop.particles_from_numpy(_np(p)),
        interop.fieldset_from_numpy(_np(fsR)), 0.0, 0)
    out = interop.particles_to_numpy(pt)
    np.testing.assert_array_equal(out["status"], np.asarray(pj.status))
    np.testing.assert_array_equal(out["pid"], np.arange(n))
    np.testing.assert_allclose(out["x"], np.asarray(pj.x), rtol=0, atol=0.5)
    np.testing.assert_allclose(out["y"], np.asarray(pj.y), rtol=0, atol=0.5)
    np.testing.assert_allclose(out["z"], np.asarray(pj.z), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(out["hit_land"], np.asarray(pj.hit_land))
    assert out["hit_land"].sum() > 0          # the land block was hit
    # and against the closed form for the particles that never touched it
    xa, ya, _ = c.analytic(np.asarray(p.x, np.float64),
                           np.asarray(p.y, np.float64),
                           np.asarray(p.z, np.float64), 2 * dt)
    free = (out["hit_land"] == 0) & (out["status"] == jst.ACTIVE)
    assert free.sum() > 0.5 * n
    np.testing.assert_allclose(out["x"][free], xa[free], rtol=0, atol=0.5)
    np.testing.assert_allclose(out["y"][free], ya[free], rtol=0, atol=0.5)


UNSUPPORTED = [
    ("HTurbOn", dict(HTurbOn=True)),
    ("VTurbOn", dict(VTurbOn=True)),
    ("Behavior", dict(Behavior=6)),
    ("mortality", dict(mortality=True)),
    ("settlementon", dict(settlementon=True)),
    ("SaltTempOn", dict(SaltTempOn=True)),
    ("tension_sigma", dict(tension_sigma=-1.0)),
    ("mesh_particles", dict(mesh_particles=2)),
    ("checkpoint_every", dict(checkpoint_every=4)),
    ("sort_depth_bands", dict(sort_depth_bands=2)),
]


def _ctx():
    g = synth.make_solid_body_case(nx=9, ny=9, us=4,
                                   dtype=torch.float32).grid
    return tstep.StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.numpy(), g.x_rho.numpy(), g.y_rho.numpy()))


@pytest.mark.parametrize("name,kw", UNSUPPORTED,
                         ids=[u[0] for u in UNSUPPORTED])
def test_unsupported_option_raises(name, kw):
    with pytest.raises(NotImplementedError, match=name):
        tstep.make_fused_external_steps(_ctx(), _cfg(us=4, ws=5, **kw), 1)


def test_resume_raises():
    with pytest.raises(NotImplementedError, match="--resume"):
        tstep.check_supported(_cfg(us=4, ws=5), _ctx(), resume=True)


def test_cuda_only_restrictions(monkeypatch):
    """On CUDA the kernel needs f32 positions on a uniform grid: both are
    refused up front (checked here by presenting the grid as on CUDA)."""
    ctx = _ctx()
    monkeypatch.setattr(type(ctx.grid), "device",
                        property(lambda self: torch.device("cuda")))
    with pytest.raises(NotImplementedError, match="dtype_pos"):
        tstep.check_supported(_cfg(us=4, ws=5, dtype_pos="float64"), ctx)
    curved = dataclasses.replace(ctx, grid=dataclasses.replace(
        ctx.grid, uniform=False))
    with pytest.raises(NotImplementedError, match="uniform grid"):
        tstep.check_supported(_cfg(us=4, ws=5), curved)
    tstep.check_supported(_cfg(us=4, ws=5), ctx)       # the slice itself
