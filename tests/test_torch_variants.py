"""The kernels' builds for float64 positions, searched axes and K2 on a
curvilinear grid, on the host side (the CUDA code runs on the card:
tests/test_torch_gpu.py, chip_smoke.py phase 9).

* ``ext_step.kernel_variant`` and ``rk4_step.kernel_variant`` add
  LTX_POS64 / LTX_AXES / LTX_CURV only when on, so every earlier build
  keeps its tag (library name): the 21 whole-step tags of chip_smoke.py
  and ``rk4_step`` for K2's rectilinear float32 build.
* ``ext_step.variant_of`` searches the axes exactly where the plain
  version does: the rho axes when ``grid.uniform`` is false (1e-9), the
  boundary cell edges when ``bounds.uniform`` is false (1e-4);
  ``axes_tables`` hands the kernel those axes and nothing else.
* The float64 params vectors hold what the plain version computes in
  float64 (rho spacing, turbulence scales), the float32 ones what it
  computes in float32, bit for bit.
* ``synth.make_solid_body_case(stretch=)`` spaces the rho axes
  geometrically, and the plain float64 path on such a grid stays on the
  analytic circles (0.01 m after an hour).
* On CPU tensors the wrappers take float64 positions on a stretched grid
  and return their plain versions unchanged (the kernels are the card's).
"""

import numpy as np
import pytest
import torch

from ltjax_torch import packed as pk
from ltjax_torch import state as st
from ltjax_torch import synth
from ltjax_torch.config import Config
from ltjax_torch.kernels import build
from ltjax_torch.kernels import ext_step as kx
from ltjax_torch.kernels import rk4_step as kr
from ltjax_torch.physics import boundary as bd
from ltjax_torch.step import StepContext, make_fused_external_steps

torch.set_num_threads(1)

# the whole-step libraries of chip_smoke.py before these builds existed
OLD_K1 = {
    (): "ext_step-b0h0m0v0",
    (("HTurbOn", True), ("VTurbOn", True), ("readAks", True)):
        "ext_step-b0h1m0v2",
    (("Behavior", 6), ("mortality", True)): "ext_step-b6h0m1v0",
    (("Behavior", 3),): "ext_step-b3h0m0v0",
    (("HTurbOn", True), ("VTurbOn", True), ("readAks", False)):
        "ext_step-b0h1m0v1",
    (("Behavior", 6), ("settlementon", True)): "ext_step-b6h0m0se1v0",
    (("Behavior", 4), ("SaltTempOn", True)): "ext_step-b4h0m0sa1v0",
    (("Behavior", 4), ("HTurbOn", True), ("VTurbOn", True),
     ("readAks", True), ("mortality", True), ("settlementon", True),
     ("SaltTempOn", True)): "ext_step-b4h1m1sa1se1v2",
}


def _cfg(**kw):
    return Config(numpar=1, us=4, ws=5, **kw)


@pytest.mark.parametrize("kw", list(OLD_K1), ids=list(OLD_K1.values()))
def test_existing_whole_step_tags_unchanged(kw):
    cfg = _cfg(**dict(kw))
    v = kx.kernel_variant(cfg)
    assert build.tag("ext_step", v) == OLD_K1[kw]
    assert not {"LTX_POS64", "LTX_AXES", "LTX_CURV"} & set(v)
    # the float64 build's tag is the same with p1 in its sorted place
    tag64 = build.tag("ext_step", kx.kernel_variant(cfg, pos64=True))
    assert "p1" in tag64 and tag64.replace("p1", "") == OLD_K1[kw]


def test_new_whole_step_tags():
    cfg = _cfg()
    tags = {build.tag("ext_step", kx.kernel_variant(cfg, **kw))
            for kw in (dict(pos64=True), dict(axes=True),
                       dict(pos64=True, axes=True),
                       dict(curv=True, pos64=True))}
    assert tags == {"ext_step-b0h0m0p1v0", "ext_step-a1b0h0m0v0",
                    "ext_step-a1b0h0m0p1v0", "ext_step-b0c1h0m0p1v0"}
    assert set(build._macros("ext_step")) >= {"POS64", "AXES"}


def test_rk4_tags_and_library_name():
    """K2's rectilinear float32 build keeps the tag and the library name
    prefix ``rk4_step-<hash>.so`` it had before it had variants."""
    assert build._macros("rk4_step") == ("CURV", "POS64", "AXES", "TILE")
    uni = synth.make_solid_body_case(nx=9, ny=9, us=4,
                                     dtype=torch.float32).grid
    streched = synth.make_solid_body_case(nx=9, ny=9, us=4, stretch=1.05,
                                          dtype=torch.float32).grid
    curv = synth.make_curv_case(nx=9, ny=9, us=4, lx=8e3, ly=8e3, h0=20.0,
                                dtype=torch.float32).grid
    f64 = torch.float64
    assert kr.kernel_variant(uni) == {}
    assert build.tag("rk4_step", kr.kernel_variant(uni)) == "rk4_step"
    so = build._target("rk4_step", kr.kernel_variant(uni))[2]
    assert so.split("/")[-1].startswith("rk4_step-")
    assert len(so.split("/")[-1]) == len("rk4_step-") + 16 + len(".so")
    got = {build.tag("rk4_step", kr.kernel_variant(g, dt)) for g, dt in (
        (uni, f64), (streched, torch.float32), (streched, f64),
        (curv, torch.float32), (curv, f64))}
    assert got == {"rk4_step-p1", "rk4_step-a1", "rk4_step-a1p1",
                   "rk4_step-c1", "rk4_step-c1p1"}
    # a tile's strip of a sharded run (ltjax_torch.shard)
    from ltjax_torch import shard
    spec = shard.make_spec(Config(), 9, 10, 1, 2, halo=1)
    bounds = bd.build_boundaries(uni.mask_rho.numpy(), uni.x_rho.numpy(),
                                 uni.y_rho.numpy())
    ctx = shard.tile_context(StepContext(grid=uni, bounds=bounds), spec,
                             shard.build_tiled_static(uni, spec), 1)
    assert build.tag("rk4_step", kr.kernel_variant(ctx.grid, f64)) == (
        "rk4_step-p1t1")


def _ctx(stretch, dtype=torch.float64):
    c = synth.make_solid_body_case(nx=21, ny=17, us=4, lx=40e3, ly=30e3,
                                   h0=30.0, omega=1e-4, dtype=dtype,
                                   stretch=stretch)
    g = c.grid
    return c, StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.numpy(), g.x_rho.numpy(), g.y_rho.numpy()))


@pytest.mark.parametrize("stretch,grid_uniform,edges_uniform", [
    (1.0, True, True), (1.02, False, False), (1 + 5e-7, False, True)],
    ids=["uniform", "stretched", "stretched-grid"])
def test_variant_of_searches_what_the_plain_version_searches(
        stretch, grid_uniform, edges_uniform):
    _, ctx = _ctx(stretch)
    assert ctx.grid.uniform == grid_uniform
    assert ctx.bounds.uniform == edges_uniform
    v = kx.variant_of(ctx, _cfg(), torch.float64)
    assert v["LTX_POS64"] == 1
    assert ("LTX_AXES" in v) == (not grid_uniform)
    rho, edges, settle = kx.axes_tables(ctx, torch.float64)
    assert (rho is None) == grid_uniform
    assert (edges is None) == (settle is None) == edges_uniform
    if rho is not None:
        np.testing.assert_array_equal(rho[0].numpy(), ctx.grid.x_rho.numpy())
    if edges is not None:
        np.testing.assert_array_equal(edges[1].numpy(),
                                      ctx.bounds.y_edges.numpy())
        assert settle[0].dtype == torch.float64
        f32 = kx.axes_tables(ctx, torch.float32)[1]
        assert f32[0].dtype == torch.float32        # cell_of's .to(x.dtype)
    assert kx.axes_tables(ctx, torch.float64) is kx.axes_tables(
        ctx, torch.float64)                         # cached
    assert "LTX_POS64" not in kx.variant_of(ctx, _cfg(), torch.float32)


def test_params_in_the_positions_dtype():
    _, ctx = _ctx(1.02)
    cfg = _cfg(HTurbOn=True, ConstantHTurb=0.7, VTurbOn=True,
               ConstantVTurb=3e-3, idt=150)
    p64 = kx.params_static(ctx, cfg, np.float64)
    p32 = kx.params_static(ctx, cfg)
    assert p64.dtype == np.float64 and p32.dtype == np.float32
    x = ctx.grid.x_rho.numpy()
    assert p64[kx.P_DX] == x[1] - x[0]
    assert p32[kx.P_DX] == np.float32(x[1]) - np.float32(x[0])
    t64 = torch.tensor(150.0, dtype=torch.float64)
    assert p64[kx.P_HSCALE] == float(torch.sqrt(2.0 * 0.7 * t64))
    assert p32[kx.P_HSCALE] == np.float32(torch.sqrt(
        2.0 * 0.7 * torch.tensor(150.0, dtype=torch.float32)))
    assert p64[kx.P_VCONST] == float(torch.sqrt(
        2.0 * torch.tensor(3e-3, dtype=torch.float64) * t64 / (1.0 / 3.0)))
    fin = kx.finish_params(p64, 3600.0, torch.tensor([0.0, 3600.0, 7200.0],
                                                     dtype=torch.float64),
                           150.0, 4)
    fin32 = kx.finish_params(p32, 3600.0, torch.tensor(
        [0.0, 3600.0, 7200.0], dtype=torch.float64), 150.0, 4)
    assert fin.dtype == np.float64 and fin[kx.P_T0] == 3600.0
    # the weights: the float32 vector's, the kernel reads them from there
    np.testing.assert_array_equal(fin[len(p64):], fin32[len(p32):])
    q64 = kr.params_array(ctx.grid, 2.0, 0.01, np.float64).numpy()
    assert q64.dtype == np.float64 and q64[kr.Q_DX] == x[1] - x[0]
    assert kr.params_array(ctx.grid, 2.0, 0.01).dtype == torch.float32


def test_stretched_solid_body_case():
    x = synth.stretched_axis(11, 50e3, 1.1)
    d = np.diff(x)
    np.testing.assert_allclose(d[1:] / d[:-1], 1.1, rtol=1e-12)
    assert x[0] == 0.0 and abs(x[-1] - 50e3) < 1e-6
    np.testing.assert_array_equal(synth.stretched_axis(5, 4.0, 1.0),
                                  np.linspace(0.0, 4.0, 5))
    c, ctx = _ctx(1.02)
    cfg = Config(numpar=64, dt=1800, idt=300, us=4, ws=5,
                 OpenOceanBoundary=True, dtype_pos="float64")
    rng = np.random.default_rng(3)
    x0, y0 = rng.uniform(14e3, 26e3, 64), rng.uniform(9e3, 21e3, 64)
    z0 = rng.uniform(-25.0, -5.0, 64)
    p = st.init_particles(x0, y0, z0)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 4, dtype=torch.float64)
    out = make_fused_external_steps(ctx, cfg, 2)(p, fsR, 0.0, 0)
    xa, ya, _ = c.analytic(x0, y0, z0, 3600.0)
    err = np.hypot(out.x.numpy() - xa, out.y.numpy() - ya)
    assert err.max() < 0.01, err.max()


def test_wrappers_take_f64_on_stretched_axes_on_cpu():
    c, ctx = _ctx(1.02)
    cfg = Config(numpar=32, dt=600, idt=300, us=4, ws=5,
                 OpenOceanBoundary=True, dtype_pos="float64")
    rng = np.random.default_rng(4)
    p = st.init_particles(rng.uniform(5e3, 35e3, 32),
                          rng.uniform(5e3, 25e3, 32),
                          rng.uniform(-25.0, -5.0, 32))
    rec = pk.build_packed_records(c.grid, synth.fieldset_for(
        c, t_center=300.0, dt=600.0))
    out = kx.ext_step_fused(ctx, cfg, p, rec, 0.0)
    ref = kx.ext_step_reference(ctx, cfg, p, rec, 0.0)
    assert out.x.dtype == torch.float64
    for k in ("x", "y", "z", "status"):
        assert torch.equal(getattr(out, k), getattr(ref, k))
    tabs = pk.stage_value_tables(c.grid, rec, 0.0, 300.0)
    n0 = kr.rk4_displacement_fused.launches
    d = kr.rk4_displacement_fused(c.grid, tabs, p.x, p.y, p.z, 0.0, 0.01,
                                  300.0)
    r = pk.rk4_displacement_collapsed(c.grid, tabs, p.x, p.y, p.z, 0.0, 0.01,
                                      300.0)
    assert kr.rk4_displacement_fused.launches == n0
    for a, b in zip(d, r):
        assert a.dtype == torch.float64 and torch.equal(a, b)
