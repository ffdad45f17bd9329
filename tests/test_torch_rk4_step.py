"""ltjax_torch.kernels.rk4_step (the per-internal-step RK4 kernel's
wrapper) vs ltjax on the same inputs.

1. The wrapper on CPU tensors (its plain version) against ltjax's Pallas
   kernel ``gather_interp.rk4_displacement_fused`` in interpret mode, on
   tests/test_kernel.py's case: a 41x41 grid, us = 10, 512 Hilbert-sorted
   particles, affine (theta_s = 0) and stretched (theta_s = 4) ladders,
   ltjax's constant-ladder ("sfast") vertical scheme on and off.  Both
   read stage tables built from the same fields; tolerance rtol = atol =
   2e-4 in float32, as test_kernel.py's.
2. The wrapper against ltjax's ``packed.rk4_displacement_collapsed`` (and
   the stage-1 currents against ``find_currents_collapsed``) in float64,
   to 1e-9.
3. The wrapper's contract: a CPU call launches nothing; positions or
   tables of the wrong shape or dtype raise ValueError, and so does a
   device that is neither the CPU nor CUDA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltjax import packed as jpk
from ltjax import spatial as jsp
from ltjax import synth as jsynth
from ltjax.grid import locate as jlocate
from ltjax.kernels import gather_interp as gi
from ltjax_torch import interop
from ltjax_torch import packed as pk
from ltjax_torch.kernels import rk4_step as kr

torch.set_num_threads(1)

Z0M = 5e-4
IDT = 120.0


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _case(theta_s, dtype):
    """test_kernel.py's case in ``dtype``: both packages' grids and stage
    tables at t = 100 s and 512 Hilbert-sorted positions."""
    c = jsynth.make_solid_body_case(nx=41, ny=41, us=10, lx=100e3, ly=100e3,
                                    h0=50.0, omega=1e-4, shear_a=0.004,
                                    theta_s=theta_s, dtype=dtype)
    fs = jsynth.fieldset_for(c, t_center=1800.0, dt=3600.0, dtype=dtype)
    jtabs = jpk.stage_value_tables(c.grid, jpk.build_packed_records(c.grid,
                                                                    fs),
                                   100.0, IDT)
    rng = np.random.default_rng(11)
    n = 512
    x = jnp.asarray(rng.uniform(35e3, 55e3, n), dtype)
    y = jnp.asarray(rng.uniform(35e3, 55e3, n), dtype)
    z = jnp.asarray(rng.uniform(-40.0, -5.0, n), dtype)
    i, _ = jlocate(c.grid.x_rho, x, c.grid.uniform)
    j, _ = jlocate(c.grid.y_rho, y, c.grid.uniform)
    perm = jnp.argsort(jsp.hilbert_key(i, j))
    x, y, z = x[perm], y[perm], z[perm]
    grid = interop.grid_from_numpy(_np(c.grid))
    tabs = pk.stage_value_tables(grid, pk.build_packed_records(
        grid, interop.fieldset_from_numpy(_np(fs))), 100.0, IDT)
    pos = [torch.from_numpy(np.array(v)) for v in (x, y, z)]
    return c.grid, jtabs, (x, y, z), grid, tabs, pos


@pytest.fixture(scope="module", params=[0.0, 4.0],
                ids=["affine-ladder", "stretched"])
def case32(request):
    return _case(request.param, jnp.float32)


@pytest.mark.parametrize("sfast", [True, False])
def test_plain_matches_ltjax_kernel_interpret(case32, sfast):
    jgrid, jtabs, (x, y, z), grid, tabs, pos = case32
    dxj, dyj, dzj, ovf = gi.rk4_displacement_fused(
        jgrid, jtabs, x, y, z, 0.0, Z0M, IDT, p_block=256, sfast=sfast,
        interpret=True)
    assert not bool(ovf.any())
    n0 = kr.rk4_displacement_fused.launches
    out = kr.rk4_displacement_fused(grid, tabs, *pos, 0.0, Z0M, IDT)
    assert kr.rk4_displacement_fused.launches == n0        # CPU: no launch
    for a, b in zip(out, (dxj, dyj, dzj)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)
    assert float(out[0].abs().max()) > 1.0                  # a real move


@pytest.mark.parametrize("theta_s", [0.0, 4.0],
                         ids=["affine-ladder", "stretched"])
def test_plain_matches_ltjax_collapsed_f64(theta_s):
    jgrid, jtabs, (x, y, z), grid, tabs, pos = _case(theta_s, jnp.float64)
    want = jpk.rk4_displacement_collapsed(jgrid, jtabs, x, y, z, 0.0, Z0M,
                                          IDT)
    cur = jpk.find_currents_collapsed(jgrid, jtabs[0], x, y, z, 0.0, Z0M)
    out = kr.rk4_displacement_fused(grid, tabs, *pos, 0.0, Z0M, IDT,
                                    stage1=True)
    assert len(out) == 5
    for a, b in zip(out, tuple(want) + tuple(cur[:2])):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)


def _small():
    return _case(0.0, jnp.float32)[3:]


@pytest.mark.parametrize("bad", ["position-shape", "position-dtype",
                                 "table-shape", "table-dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    grid, tabs, (x, y, z) = _small()
    if bad == "position-shape":
        y = y[:-1]
    elif bad == "position-dtype":
        z = z.double()
    elif bad == "table-shape":
        tabs = (pk.ValueTable(full=tabs[0].full[..., :-1], t=tabs[0].t),
                *tabs[1:])
    else:
        tabs = (tabs[0], pk.ValueTable(full=tabs[1].full.double(),
                                       t=tabs[1].t), tabs[2])
    n0 = kr.rk4_displacement_fused.launches
    with pytest.raises(ValueError, match="rk4_displacement_fused"):
        kr.rk4_displacement_fused(grid, tabs, x, y, z, 0.0, Z0M, IDT)
    assert kr.rk4_displacement_fused.launches == n0


def test_wrapper_rejects_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused
    (no fallback to the plain version)."""
    grid, tabs, pos = _small()
    meta = [v.to("meta") for v in pos]
    with pytest.raises(ValueError, match="unsupported device"):
        kr.rk4_displacement_fused(grid, tabs, *meta, 0.0, Z0M, IDT)


def test_params_layout():
    """The kernel's params vector: uniform axes, hc, z0m, sigma, then the
    four ladders, in float32."""
    grid, _, _ = _small()
    par = kr.params_array(grid, 2.0, Z0M).numpy()
    us, ws = grid.us, grid.ws
    assert par.dtype == np.float32
    assert par.shape == (kr.Q_HEAD + 2 * (us + ws),)
    xr = grid.x_rho.numpy().astype(np.float32)
    assert par[kr.Q_X0] == xr[0] and par[kr.Q_DX] == xr[1] - xr[0]
    assert par[kr.Q_SIGMA] == 2.0 and par[kr.Q_Z0M] == np.float32(Z0M)
    np.testing.assert_array_equal(
        par[kr.Q_HEAD + 2 * us:kr.Q_HEAD + 2 * us + ws],
        grid.s_w.numpy().astype(np.float32))
