"""The CUDA external-step kernel against its plain version (jax-free, so
it runs on a machine with a GPU and no JAX):

    python -m pytest tests/test_torch_gpu.py -q

Tests marked ``gpu`` need a CUDA device and skip elsewhere (a CUDA
kernel has no CPU mode); the wrapper's input checks run anywhere.
Tolerances (float32): horizontal 0.5 m, vertical 1e-3 m; statuses and
collision counts equal except for at most 0.01% of particles, whose
reflection decisions may flip on f32 round-off (FMA contraction).  A
third of the particles start within a metre of the surface and a third
0.1-1 m above the bottom (the log layer).  The vertical test adds a
seeded random w and zeta to a ten times slower rotation and compares
every internal step on its own, from the same state: over many steps
its trajectories are too sensitive to round-off for any f32 comparison
(see chip_smoke.py phase 1).

The turbulence, behavior and mortality variants of the kernel are held
the same way, step by step from the plain trajectory's state (one
compiled variant per case): horizontal 0.05 m, vertical 1e-3 m, equal
statuses.  Their draws are bit-equal (same Threefry words); what is
left is f32 round-off, FMA contraction and the order of the Aks blend
(collapse-then-blend in the kernel, blend-then-collapse in the plain
version).  Ages straddle the swim ramp and the death age, and strong
horizontal turbulence drives particles onto land in the same step as
they die, so DEAD must override ERROR.  The settlement and salt lanes
are held the same way on the halocline of synth.halocline_fields, with
a habitat square, a square hole and a slanted hexagon: statuses and
settle_poly equal, salt and temp within 1e-3; behavior 4 without
SaltTempOn leaves salt and temp at 0.

K1's staged corner source is held on each of its paths (three tiles,
split, device memory, misses) against the plain version, and on the
staged paths against the same launch with every block in device memory,
bit for bit; the three-tile and split paths also with the turbulence and
behavior 4 lanes, whose reads at t after a split box's t + idt restage
are counted misses.  K1's device counter ``active_steps`` equals the plain
version's count of the particles active after each internal step's
release, in float32 and float64, with releases inside the run and exits
through the open boundary; its staging counters follow
``ext_step.block_boxes``.

The curvilinear variant (LTX_CURV) is held the same way on
synth.make_curv_case with a land block: one external step against its
plain version (tolerances as above, land hits and rim exits on curved
segments), the per-step lanes (turbulence, behavior 3, the oyster
lanes), and one launch per external step through the fused driver.

The per-internal-step RK4 kernel (csrc/rk4_step.cu) is held against its
plain version (packed.rk4_displacement_collapsed) on one internal step
with a random w and zeta: horizontal 0.05 m, vertical 1e-3 m, the
stage-1 currents to 0.05 m / idt.  The per-step route (stochastic
mortality) launches it once per internal step and never calls the plain
version.

The per-step lanes kernel (csrc/step_lanes.cu, K3) is held against its
plain version at 65,536 particles on K2's displacement, internal step by
internal step, in every variant the per-step route takes (behaviors 3,
4, 6 and 7, turbulence on Aks, settlement, salt, a curvilinear grid,
float64, stretched axes, a tile with EMPTY slots): 0.05 m, 1e-3 m,
statuses and DEATH decisions equal; the per-step route launches K2 and
K3 once each per internal step and never the plain lanes.

The native and packed routes (PyTorch ops, no kernel) on the card are
held against the same routes on the CPU.

The depth-banded Hilbert sort (``sort_depth_bands``) reorders the batch
and nothing else: banded runs on the ext_step and per-step routes, and
on two gloo tiles, equal the unbanded runs bit for bit.

The Hilbert sort key's kernel (csrc/sort_key.cu) gives the plain
version's keys bit for bit on 1M random cells and the edge cases
(corners, cells clamped at the mask, parked and EMPTY slots, bands out
of range), unbanded and banded; ``sort_by_cell`` on the card gives the
CPU's permutation from the same cells; make_fused_external_steps launches it once
a sort.

The migration's kernels (csrc/migrate.cu) give the plain version's new
block, send rows and counts, drops and sent count byte for byte (the
plain version on the same block on the CPU), in float32 and float64: a
mixed block with y on the strips' edges and at NaN and +-inf, no
leavers, every slot a leaver, every slot EMPTY, mig_cap 2 (leavers stay
as ERROR), arrivals past cap (dropped; some arrivals EMPTY), and a
rank's block of the four-card cell (7.5M slots, 4.2M live, 2.8%
leaving); one launch count a call, and one synchronizing call (the
exchange's read of the counts).
"""
import warnings
from dataclasses import replace


import numpy as np
import pytest
import torch

from ltjax_torch import packed as pk
from ltjax_torch import shard
from ltjax_torch import spatial as sp
from ltjax_torch import state as st
from ltjax_torch import synth
from ltjax_torch.config import Config
from ltjax_torch.kernels import ext_step as kx
from ltjax_torch.kernels import migrate as km
from ltjax_torch.kernels import rk4_step as kr
from ltjax_torch.kernels import sort_key as sk
from ltjax_torch.physics import boundary as bd
from ltjax_torch.physics import settlement as stl
from ltjax_torch.step import StepContext, _sort, make_fused_external_steps

torch.set_num_threads(1)

TOL_H = 0.5
TOL_V = 1e-3


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(device, vtransform=1, theta_s=0.0, sigma=0.0, n=4096,
          omega=1e-4, hc=None, dtype=torch.float32, stretch=1.0):
    mask = np.ones((41, 41), np.int32)
    mask[19:22, 30:33] = 0        # x 75-80 km, y 47.5-52.5 km (uniform)
    c = synth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                   h0=50.0, omega=omega, shear_a=0.004,
                                   vtransform=vtransform, theta_s=theta_s,
                                   dtype=dtype, device=device,
                                   mask=mask, hc=hc, stretch=stretch)
    g = c.grid
    ctx = StepContext(grid=g, bounds=bd.build_boundaries(
        mask, g.x_rho.cpu().numpy(), g.y_rho.cpu().numpy(), device=device))
    cfg = Config(numpar=n, dt=1800, idt=450, us=6, ws=7,
                 OpenOceanBoundary=True,
                 dtype_pos=str(dtype).replace("torch.", ""),
                 reflect_iters=2, TrackCollisions=True,
                 tension_sigma=sigma)
    rng = np.random.default_rng(9)
    # half over the whole domain (open-rim exits), half in the flow just
    # upstream (south) of the land block (reflections)
    h = n // 2
    x = np.concatenate([rng.uniform(2e3, 98e3, h),
                        rng.uniform(72e3, 83e3, n - h)])
    y = np.concatenate([rng.uniform(2e3, 98e3, h),
                        rng.uniform(38e3, 45e3, n - h)])
    # a third within 1 m of the surface, a third 0.1-1 m above the bottom
    k = n // 3
    z = np.concatenate([rng.uniform(-1.0, 0.0, k),
                        rng.uniform(-49.9, -49.0, k),
                        rng.uniform(-49.0, -1.0, n - 2 * k)])
    p = st.init_particles(x, y, rng.permutation(z),
                          dob=rng.choice([0.0, 900.0], n),
                          dtype=dtype, device=device)
    p, _ = _sort(g, p)
    return c, ctx, cfg, p


# stretched-hc: theta_s 4 and hc 10 m < h0, so the depths depend on both
# Cs and hc (with Cs = s or hc = h0 a kernel that misreads one passes)
VARIANTS = pytest.mark.parametrize(
    "vtransform,theta_s,sigma,hc",
    [(1, 0.0, 0.0, None), (2, 4.0, 0.0, None), (1, 4.0, 4.0, None),
     (1, 4.0, 0.0, 10.0)],
    ids=["affine", "stretched-vt2", "tension", "stretched-hc"])


def _compare(out, ref, n):
    same = (out.status == ref.status).cpu().numpy()
    assert (~same).sum() <= 1e-4 * n
    for k, tol in (("x", TOL_H), ("y", TOL_H), ("z", TOL_V)):
        np.testing.assert_allclose(getattr(out, k).cpu().numpy()[same],
                                   getattr(ref, k).cpu().numpy()[same],
                                   rtol=0, atol=tol)
    for k in ("hit_land", "hit_bottom"):
        agree = (getattr(out, k) == getattr(ref, k)).cpu().numpy()
        assert (~agree).sum() <= 1e-4 * n


@pytest.mark.gpu
@VARIANTS
def test_kernel_matches_plain(gpu, vtransform, theta_s, sigma, hc):
    c, ctx, cfg, p = _case(gpu, vtransform, theta_s, sigma, hc=hc)
    rec = pk.build_packed_records(
        c.grid, synth.fieldset_for(c, t_center=900.0, dt=1800.0))
    n0 = kx.ext_step_fused.launches
    out = kx.ext_step_fused(ctx, cfg, p, rec, 0.0)
    ref = kx.ext_step_reference(ctx, cfg, p, rec, 0.0)
    torch.cuda.synchronize()
    assert kx.ext_step_fused.launches == n0 + 1
    _compare(out, ref, p.n)
    assert ref.hit_land.sum() > 0
    assert (ref.status == st.OUT_OF_DOMAIN).sum() > 0


@pytest.mark.gpu
@VARIANTS
def test_kernel_matches_plain_vertical(gpu, vtransform, theta_s, sigma, hc):
    """Random w and zeta, every internal step launched on its own from
    the plain trajectory's state."""
    c, ctx, cfg, p = _case(gpu, vtransform, theta_s, sigma, omega=1e-5,
                           hc=hc)
    rec = pk.build_packed_records(c.grid, synth.with_vertical_motion(
        synth.fieldset_for(c, t_center=900.0, dt=1800.0), seed=11))
    cfg1 = replace(cfg, dt=cfg.idt)
    q, surf = p, 0
    for i in range(cfg.internal_steps):
        t = i * float(cfg.idt)
        out = kx.ext_step_fused(ctx, cfg1, q, rec, t)
        ref = kx.ext_step_reference(ctx, cfg1, q, rec, t)
        _compare(out, ref, p.n)
        surf += _surface_crossings(ctx, cfg1, q, rec, t)
        q = ref
    # the vertical path really ran: particles moved vertically, hit the
    # bottom and were carried above the surface (reflected)
    assert (q.z - p.z).abs().max() > 1.0
    assert q.hit_bottom.sum() > 0
    assert surf > 0


def _surface_crossings(ctx, cfg, p, rec, t):
    """Particles that the plain version's internal step from t carries
    above the surface, before reflection."""
    g, idt = ctx.grid, float(cfg.idt)
    tabs = pk.stage_value_tables(g, rec, t, idt)
    dx, dy, dz = pk.rk4_displacement_collapsed(
        g, tabs, p.x, p.y, p.z, cfg.tension_sigma, cfg.z0, idt)
    xr, yr, *_ = bd.reflect(ctx.bounds, p.x, p.y, p.x + dx, p.y + dy,
                            open_exits=cfg.OpenOceanBoundary,
                            n_iter=cfg.reflect_iters)
    zeta1, h1 = pk.zeta_h_packed(g, tabs[2], xr, yr)
    _, above, _ = bd.reflect_vertical(p.z + dz, zeta1, h1)
    live = (p.status == st.ACTIVE) | ((p.status == st.NOT_RELEASED)
                                      & (p.dob <= t))
    return int((above & live).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [{}, dict(HTurbOn=True, VTurbOn=True,
                                            readAks=True, Behavior=3)],
                         ids=["advection", "turb-dvm"])
def test_fused_steps_launch_once_per_external_step(gpu, lanes):
    c, ctx, cfg, p = _case(gpu)
    c.parabolic_aks = True
    cfg = replace(cfg, swimslow=1e-3, swimfast=1e-3, **lanes)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 5)
    n0 = kx.ext_step_fused.launches
    out = make_fused_external_steps(ctx, cfg, 3)(p, fsR, 0.0, 0)
    assert kx.ext_step_fused.launches == n0 + 3
    assert torch.isfinite(out.x).all() and torch.isfinite(out.z).all()


@pytest.mark.gpu
def test_empty_batch_launches_nothing(gpu):
    c, ctx, cfg, p = _case(gpu, n=256)
    rec = pk.build_packed_records(
        c.grid, synth.fieldset_for(c, t_center=900.0, dt=1800.0))
    n0 = kx.ext_step_fused.launches
    out = kx.ext_step_fused(ctx, cfg, p.take(p.x[:0].long()), rec, 0.0)
    assert out.n == 0 and kx.ext_step_fused.launches == n0


LANES = {
    "turb-aks": dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                     readAks=True),
    "turb-const": dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                       readAks=False, ConstantVTurb=2e-3),
    "dead-over-error": dict(HTurbOn=True, ConstantHTurb=2e4, mortality=True),
    **{f"behavior{b}": dict(Behavior=b, mortality=True) for b in
       (1, 2, 3, 6, 7)},
    **{f"behavior{b}": dict(Behavior=b, readSalt=True, Sgradient=0.5,
                            mortality=b == 4) for b in (4, 5)},
    "salt": dict(SaltTempOn=True, readSalt=True, readTemp=True),
    "settle": dict(settlementon=True, holesExist=True, HTurbOn=True,
                   ConstantHTurb=2e4, mortality=True),
}


def _polygons():
    """A habitat square (id 101) with a square hole and a slanted hexagon
    (id 102) on the 100 km case."""
    th = np.linspace(0.0, 2 * np.pi, 7)[:-1] + 0.3
    hexagon = np.stack([30e3 + 5e3 * np.cos(th), 60e3 + 5e3 * np.sin(th)],
                       -1)
    square = np.array([[60e3, 60e3], [72e3, 60e3], [72e3, 72e3],
                       [60e3, 72e3]])
    return [(101, square), (102, hexagon)], [(1, square / 2 + 32e3)]
BEH = dict(deadage=2 * 86400.0, pediage=86400.0, swimstart=3600.0,
           swimslow=2e-3, swimfast=5e-3, sink=5e-4, Hswimspeed=0.1,
           Swimdepth=3.0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(LANES))
def test_kernel_lanes_match_plain_stepwise(gpu, name):
    """Four internal steps, each launched on its own from the plain
    trajectory's state, at 9 h of the day (DVM in daylight)."""
    c, ctx, cfg, p = _case(gpu, omega=1e-5)
    c.parabolic_aks = True
    c.halocline = True
    cfg1 = replace(cfg, dt=cfg.idt, **BEH, **LANES[name])
    if cfg1.settlementon:
        habitat, holes = _polygons()
        xe = ctx.bounds.x_edges.cpu().numpy()
        ye = ctx.bounds.y_edges.cpu().numpy()
        ctx.polys = stl.build_polygons(habitat, xe, ye, device=gpu)
        ctx.holes = stl.build_polygons(holes, xe, ye, device=gpu)
    rng = np.random.default_rng(10)
    age = rng.uniform(0.0, 3 * 86400.0, p.n)
    p = p.replace(age=torch.tensor(age, dtype=torch.float32, device=gpu),
                  dob=torch.tensor(-age, dtype=torch.float32, device=gpu),
                  pid=torch.tensor(rng.permutation(p.n), dtype=torch.int32,
                                   device=gpu))
    t0 = 9 * 3600.0
    fs = synth.with_vertical_motion(
        synth.fieldset_for(c, t_center=t0 + 900.0, dt=1800.0), seed=12)
    rec = pk.build_packed_records(c.grid, fs, with_aks=cfg1.VTurbOn,
                                  with_scalars=cfg1.needs_salt_fields())
    q = p
    moved = 0.0
    for i in range(4):
        t = t0 + i * float(cfg1.idt)
        out = kx.ext_step_fused(ctx, cfg1, q, rec, t, fields=fs, seed=5,
                                ext_idx=i)
        ref = kx.ext_step_reference(ctx, cfg1, q, rec, t, fields=fs, seed=5,
                                    ext_idx=i)
        torch.cuda.synchronize()
        assert (out.status != ref.status).sum() == 0
        assert (out.settle_poly != ref.settle_poly).sum() == 0
        for k, tol in (("x", 0.05), ("y", 0.05), ("z", 1e-3), ("age", 1e-3),
                       ("salt", 1e-3), ("temp", 1e-3)):
            np.testing.assert_allclose(getattr(out, k).cpu().numpy(),
                                       getattr(ref, k).cpu().numpy(),
                                       rtol=0, atol=tol)
        assert (out.hit_bottom != ref.hit_bottom).sum() <= 1e-4 * p.n
        moved = max(moved, float((ref.z - q.z).abs().max()))
        q = ref
    assert moved > 0.1
    if cfg1.mortality:
        assert (q.status == st.DEAD).sum() > 0
    if cfg1.SaltTempOn:
        assert float(q.salt.max() - q.salt.min()) > 1.0
    else:
        assert (q.salt == 0).all() and (q.temp == 0).all()
    if cfg1.settlementon:
        settled = q.settle_poly[q.status == st.SETTLED]
        assert set(settled.tolist()) == {101, 102}
    if name == "dead-over-error":
        # some of the dead were stuck on land in the step they died
        alive = kx.ext_step_reference(ctx, replace(cfg1, mortality=False), p,
                                      rec, t0, fields=fs, seed=5, ext_idx=0)
        dead = kx.ext_step_reference(ctx, cfg1, p, rec, t0, fields=fs,
                                     seed=5, ext_idx=0)
        assert ((alive.status == st.ERROR) & (dead.status == st.DEAD)
                ).sum() > 0


@pytest.mark.gpu
def test_hturb_deviates_match_plain_exactly(gpu):
    """Zero flow on a grid centred on the origin, particles within a
    metre of it: positions carry the horizontal random walk alone with
    ~1e-6 m of f32 resolution, so the kernel's Box-Muller deviates are
    held to the plain version's at 1e-5 m (a fast-math logf moves them
    by more)."""
    c = synth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                   h0=50.0, omega=0.0, dtype=torch.float32,
                                   device=gpu)
    g = replace(c.grid, x_rho=c.grid.x_rho - 50e3, y_rho=c.grid.y_rho - 50e3,
                x_u=c.grid.x_u - 50e3, y_v=c.grid.y_v - 50e3)
    c = replace(c, grid=g)
    ctx = StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.cpu().numpy(), g.x_rho.cpu().numpy(),
        g.y_rho.cpu().numpy(), device=gpu))
    cfg = Config(numpar=65536, dt=120, idt=120, us=6, ws=7,
                 dtype_pos="float32", HTurbOn=True, ConstantHTurb=1.0)
    rng = np.random.default_rng(3)
    n = 65536
    p = st.init_particles(rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                          rng.uniform(-40, -10, n), dtype=torch.float32,
                          device=gpu)
    p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
    rec = pk.build_packed_records(g, synth.fieldset_for(c, 60.0, 3600.0))
    out = kx.ext_step_fused(ctx, cfg, p, rec, 0.0, seed=2, ext_idx=7)
    ref = kx.ext_step_reference(ctx, cfg, p, rec, 0.0, seed=2, ext_idx=7)
    for k in ("x", "y"):
        d = (getattr(out, k) - getattr(ref, k)).abs().max().item()
        assert d <= 1e-5, (k, d)
    assert (ref.x - p.x).std().item() > 10.0


def test_wrapper_rejects_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused
    (no fallback to the plain version)."""
    c, ctx, cfg, p = _case("cpu", n=256)
    rec = pk.build_packed_records(
        c.grid, synth.fieldset_for(c, t_center=900.0, dt=1800.0))
    meta = p.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kx.ext_step_fused(ctx, cfg, meta, rec, 0.0)


def _curv_case(device, n=4096, omega=1e-4, **kw):
    mask = np.ones((41, 41), np.int32)
    mask[18:22, 26:30] = 0        # logical i 26-29, j 18-21
    c = synth.make_curv_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                             h0=50.0, omega=omega, amp=0.03, mask=mask,
                             dtype=torch.float32, device=device, **kw)
    g = c.grid
    ctx = StepContext(grid=g, bounds=bd.build_boundaries_curv(
        mask, c.x2d, c.y2d, g.curv, device=device))
    cfg = Config(numpar=n, dt=1800, idt=450, us=6, ws=7,
                 OpenOceanBoundary=True, dtype_pos="float32",
                 reflect_iters=2, TrackCollisions=True)
    rng = np.random.default_rng(9)
    # half over the whole mesh, half just upstream (south) of the land
    # block, whose south face is at logical tj = 17.5
    h = n // 2
    ti = np.concatenate([rng.uniform(0.5, 39.5, h),
                         rng.uniform(25.0, 31.0, n - h)])
    tj = np.concatenate([rng.uniform(0.5, 39.5, h),
                         rng.uniform(14.5, 17.3, n - h)])
    x, y = synth.logical_to_xy(c.x2d, c.y2d, ti, tj)
    k = n // 3
    z = np.concatenate([rng.uniform(-1.0, 0.0, k),
                        rng.uniform(-49.9, -49.0, k),
                        rng.uniform(-49.0, -1.0, n - 2 * k)])
    p = st.init_particles(x, y, rng.permutation(z),
                          dob=rng.choice([0.0, 900.0], n),
                          dtype=torch.float32, device=device)
    p, _ = _sort(g, p)
    return c, ctx, cfg, p


@pytest.mark.gpu
def test_curv_kernel_matches_plain(gpu):
    from ltjax_torch.kernels import build
    c, ctx, cfg, p = _curv_case(gpu)
    rec = pk.build_packed_records(
        c.grid, synth.fieldset_for(c, t_center=900.0, dt=1800.0))
    kx.reset_launches()
    out = kx.ext_step_fused(ctx, cfg, p, rec, 0.0)
    ref = kx.ext_step_reference(ctx, cfg, p, rec, 0.0)
    torch.cuda.synchronize()
    tag = build.tag("ext_step", kx.kernel_variant(cfg, curv=True))
    assert kx.ext_step_fused.variant_launches == {tag: 1}
    _compare(out, ref, p.n)
    assert ref.hit_land.sum() > 0
    assert (ref.status == st.OUT_OF_DOMAIN).sum() > 0


CURV_LANES = {
    "turb-aks": LANES["turb-aks"],
    "behavior3": LANES["behavior3"],
    "oyster": dict(Behavior=4, readSalt=True, readTemp=True, SaltTempOn=True,
                   Sgradient=0.5, settlementon=True, holesExist=True,
                   HTurbOn=True, ConstantHTurb=300.0, mortality=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CURV_LANES))
def test_curv_kernel_lanes_match_plain_stepwise(gpu, name):
    c, ctx, cfg, p = _curv_case(gpu, omega=1e-5, parabolic_aks=True,
                                halocline=True)
    cfg1 = replace(cfg, dt=cfg.idt, **BEH, **CURV_LANES[name])
    if cfg1.settlementon:
        habitat, holes = _polygons()
        xe = ctx.bounds.x_edges.cpu().numpy()
        ye = ctx.bounds.y_edges.cpu().numpy()
        ctx.polys = stl.build_polygons(habitat, xe, ye, device=gpu)
        ctx.holes = stl.build_polygons(holes, xe, ye, device=gpu)
    rng = np.random.default_rng(10)
    age = rng.uniform(0.0, 3 * 86400.0, p.n)
    p = p.replace(age=torch.tensor(age, dtype=torch.float32, device=gpu),
                  dob=torch.tensor(-age, dtype=torch.float32, device=gpu),
                  pid=torch.tensor(rng.permutation(p.n), dtype=torch.int32,
                                   device=gpu))
    t0 = 9 * 3600.0
    fs = synth.with_vertical_motion(
        synth.fieldset_for(c, t_center=t0 + 900.0, dt=1800.0), seed=12)
    rec = pk.build_packed_records(c.grid, fs, with_aks=cfg1.VTurbOn,
                                  with_scalars=cfg1.needs_salt_fields())
    q = p
    for i in range(4):
        t = t0 + i * float(cfg1.idt)
        out = kx.ext_step_fused(ctx, cfg1, q, rec, t, fields=fs, seed=5,
                                ext_idx=i)
        ref = kx.ext_step_reference(ctx, cfg1, q, rec, t, fields=fs, seed=5,
                                    ext_idx=i)
        torch.cuda.synchronize()
        assert (out.status != ref.status).sum() == 0
        assert (out.settle_poly != ref.settle_poly).sum() == 0
        for k, tol in (("x", 0.05), ("y", 0.05), ("z", 1e-3), ("age", 1e-3),
                       ("salt", 1e-3), ("temp", 1e-3)):
            np.testing.assert_allclose(getattr(out, k).cpu().numpy(),
                                       getattr(ref, k).cpu().numpy(),
                                       rtol=0, atol=tol)
        assert (out.hit_land != ref.hit_land).sum() <= 1e-4 * p.n
        q = ref
    if cfg1.HTurbOn:
        assert q.hit_land.sum() > 0
    if cfg1.settlementon:
        settled = q.settle_poly[q.status == st.SETTLED]
        assert set(settled.tolist()) == {101, 102}
        assert float(q.salt.max() - q.salt.min()) > 1.0


@pytest.mark.gpu
def test_curv_fused_steps_launch_once_per_external_step(gpu):
    c, ctx, cfg, p = _curv_case(gpu)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 5)
    kx.reset_launches()
    out = make_fused_external_steps(ctx, cfg, 3)(p, fsR, 0.0, 0)
    assert kx.ext_step_fused.launches == 3
    assert [k for k in kx.ext_step_fused.variant_launches] == [
        "ext_step-b0c1h0m0v0"]
    assert torch.isfinite(out.x).all() and torch.isfinite(out.z).all()


@pytest.mark.gpu
@VARIANTS
def test_rk4_kernel_matches_plain(gpu, vtransform, theta_s, sigma, hc):
    c, ctx, cfg, p = _case(gpu, vtransform, theta_s, sigma, omega=1e-5,
                           hc=hc)
    rec = pk.build_packed_records(c.grid, synth.with_vertical_motion(
        synth.fieldset_for(c, t_center=900.0, dt=1800.0), seed=11))
    idt = float(cfg.idt)
    tabs = pk.stage_value_tables(c.grid, rec, 450.0, idt)
    n0 = kr.rk4_displacement_fused.launches
    out = kr.rk4_displacement_fused(c.grid, tabs, p.x, p.y, p.z, sigma,
                                    cfg.z0, idt, stage1=True)
    assert kr.rk4_displacement_fused.launches == n0 + 1
    ref = pk.rk4_displacement_collapsed(c.grid, tabs, p.x, p.y, p.z, sigma,
                                        cfg.z0, idt)
    cur = pk.find_currents_collapsed(c.grid, tabs[0], p.x, p.y, p.z, sigma,
                                     cfg.z0)[:2]
    for a, b, tol in zip(out, ref + cur, (0.05, 0.05, 1e-3, 0.05 / idt,
                                          0.05 / idt)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    assert float(ref[2].abs().max()) > 0.1          # w moved them


@pytest.mark.gpu
def test_per_step_route_launches_rk4_per_internal_step(gpu, monkeypatch):
    calls = []
    plain = pk.rk4_displacement_collapsed
    monkeypatch.setattr(pk, "rk4_displacement_collapsed",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    c, ctx, cfg, p = _case(gpu)
    cfg = replace(cfg, Behavior=7, Hswimspeed=0.1, swimslow=1e-3,
                  swimfast=1e-3, mortality=True, stochastic_mortality=True,
                  deadage=3600.0)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 5)
    kx.reset_launches()
    n0 = kr.rk4_displacement_fused.launches
    out = make_fused_external_steps(ctx, cfg, 3)(p, fsR, 0.0, 0)
    assert kr.rk4_displacement_fused.launches == n0 + 3 * cfg.internal_steps
    assert kx.ext_step_fused.launches == 0 and not calls
    assert torch.isfinite(out.x).all() and (out.status == st.DEAD).any()


def _staging_case(device, path):
    """The staged corner source's paths (csrc ext_step.cu) on the 100 km
    case without land: 4096 particles on a 10 x 10 km patch west of the
    centre (~250 a 2.5 km cell), Hilbert-sorted ("sorted": every block
    stages three tiles), unsorted over the whole domain ("unsorted": every
    block overflows and runs from device memory), sorted in a flow 2.5
    times faster ("fast": 5-7.5 m/s, 0.9-1.4 cells an internal step, so
    stencils leave the box; within the displacement guard's 1.5 cells),
    or sorted and then carried two hours by a rotation sheared in depth,
    its rate times 1 + 0.01 z ("split": the blocks' particles drift apart
    at different depths, so their boxes hold 42-64 points, more than the
    36 of three tiles and within the 108 of a split tile).  A suffix
    names lanes beyond advection (STAGING_LANES): "-turb" on the parabolic
    Aks profile, "-behavior" on the halocline with ages 0-3 days."""
    base, _, lanes = path.partition("-")
    omega = 2.5e-4 if base == "fast" else 1e-4
    c = synth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                   h0=50.0, omega=omega,
                                   shear_a=0.01 if base == "split" else 0.004,
                                   parabolic_aks=lanes == "turb",
                                   halocline=lanes == "behavior",
                                   dtype=torch.float32, device=device)
    g = c.grid
    ctx = StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.cpu().numpy(), g.x_rho.cpu().numpy(),
        g.y_rho.cpu().numpy(), device=device))
    n = 4096
    cfg = Config(numpar=n, dt=1800, idt=450, us=6, ws=7,
                 OpenOceanBoundary=True, dtype_pos="float32",
                 reflect_iters=2, TrackCollisions=True,
                 **STAGING_LANES.get(lanes, {}))
    rng = np.random.default_rng(13)
    lo, hi = ((2e3, 98e3), (2e3, 98e3)) if base == "unsorted" else \
        ((20e3, 30e3), (45e3, 55e3))
    p = st.init_particles(rng.uniform(*lo, n), rng.uniform(*hi, n),
                          rng.uniform(-49.0, -1.0, n), dtype=torch.float32,
                          device=device)
    p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
    if lanes == "behavior":
        age = torch.tensor(rng.uniform(0.0, 3 * 86400.0, n),
                           dtype=torch.float32, device=device)
        p = p.replace(age=age, dob=-age)
    if base != "unsorted":
        p, _ = _sort(g, p)
    if base == "split":
        x, y, _ = c.analytic(*(v.double().cpu().numpy()
                               for v in (p.x, p.y, p.z)), 7200.0)
        p = p.replace(x=torch.tensor(x, dtype=torch.float32, device=device),
                      y=torch.tensor(y, dtype=torch.float32, device=device))
    return c, ctx, cfg, p


def _path_counter(staging, path):
    path, _, lanes = path.partition("-")
    if lanes and path == "split":
        # Visser's Aks column, the behavior's zeta/h and its salt cue at
        # t, read after the split box's t + idt restage: counted misses
        assert staging["staged_misses"] > 0
    if path == "sorted":
        # all but a block at a jump of the Hilbert curve
        assert staging["staged_block_steps"] > 9 * staging[
            "global_block_steps"]
        assert staging["split_block_steps"] < staging["staged_block_steps"]
    elif path == "split":
        assert staging["split_block_steps"] > 0
        assert staging["split_block_steps"] > 9 * (
            staging["global_block_steps"]
            + staging["staged_block_steps"] - staging["split_block_steps"])
    elif path == "unsorted":
        assert staging["global_block_steps"] > 0
        assert staging["staged_block_steps"] == 0
    else:
        assert staging["staged_misses"] > 0


# the lanes beyond advection that read the corner source at a stage time
# other than the RK4 stage's (step_lanes: the stage-1 column at t)
STAGING_LANES = {
    "turb": dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
                 readAks=True),
    "behavior": dict(Behavior=4, readSalt=True, Sgradient=0.5, **BEH),
}
STAGING = pytest.mark.parametrize("path", [
    "sorted", "unsorted", "fast", "split", "sorted-turb", "split-turb",
    "sorted-behavior", "split-behavior"])


@pytest.mark.gpu
@STAGING
def test_staged_kernel_paths_match_plain(gpu, path, monkeypatch):
    """K1 (advection, or with the turbulence or behavior 4 lanes): one
    internal step at a time from the same state (horizontal 0.05 m,
    vertical 1e-3 m, equal statuses) for 4 steps; on the staged paths the
    launch equals the same launch with no staging bit for bit."""
    c, ctx, cfg, p = _staging_case(gpu, path)
    fs = synth.fieldset_for(c, t_center=900.0, dt=1800.0)
    rec = pk.build_packed_records(c.grid, fs, with_aks=cfg.VTurbOn,
                                  with_scalars=cfg.needs_salt_fields())
    fields = fs if "-" in path else None
    cfg1 = replace(cfg, dt=cfg.idt)
    staging = dict.fromkeys(kx.COUNTERS, 0)
    q = p
    for i in range(4):
        t = i * float(cfg.idt)
        kx.reset_launches()
        out = kx.ext_step_fused(ctx, cfg1, q, rec, t, fields=fields, seed=5,
                                ext_idx=i)
        staging = {k: v + staging[k] for k, v in kx.counts().items()}
        ref = kx.ext_step_reference(ctx, cfg1, q, rec, t, fields=fields,
                                    seed=5, ext_idx=i)
        torch.cuda.synchronize()
        assert (out.status != ref.status).sum() == 0
        for k, tol in (("x", 0.05), ("y", 0.05), ("z", 1e-3)):
            np.testing.assert_allclose(getattr(out, k).cpu().numpy(),
                                       getattr(ref, k).cpu().numpy(),
                                       rtol=0, atol=tol)
        if path != "unsorted":
            # a staged launch equals the launch with every block in device
            # memory (STAGE_POINTS 0) bit for bit: a lookup returns the
            # same value whichever path served it
            with monkeypatch.context() as m:
                m.setattr(kx, "STAGE_POINTS", 0)
                glob = kx.ext_step_fused(ctx, cfg1, q, rec, t, fields=fields,
                                         seed=5, ext_idx=i)
            for k in ("x", "y", "z", "status"):
                assert torch.equal(getattr(out, k), getattr(glob, k)), k
        q = ref
    _path_counter(staging, path)
    assert float((q.x - p.x).abs().max()) > 100.0
    assert float((q.status == st.ACTIVE).float().mean()) > 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_active_steps_count_the_particle_steps_that_ran(gpu, dtype):
    """K1's fourth device counter, ``active_steps``, equals the plain
    version's count of the particles ACTIVE after each internal step's
    release, launch by launch from the plain trajectory's state (one
    internal step a launch): half the particles released at dates of
    birth inside the run, a flow that carries corner particles out
    through the open boundary.  Its staging counters equal block_boxes'
    rule on the same state: the blocks that fit staged in three tiles,
    those that fit split staged one tile at a time, the others from
    device memory."""
    c = synth.make_solid_body_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                   h0=50.0, omega=2e-4, shear_a=0.004,
                                   dtype=dtype, device=gpu)
    g = c.grid
    ctx = StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.cpu().numpy(), g.x_rho.cpu().numpy(),
        g.y_rho.cpu().numpy(), device=gpu))
    n, idt, n_int = 4096, 150, 12
    cfg = Config(numpar=n, dt=idt, idt=idt, us=6, ws=7,
                 OpenOceanBoundary=True, reflect_iters=2,
                 dtype_pos=str(dtype).split(".")[-1])
    rng = np.random.default_rng(29)
    p = st.init_particles(rng.uniform(1e3, 99e3, n), rng.uniform(1e3, 99e3, n),
                          rng.uniform(-49.0, -1.0, n), dtype=dtype,
                          device=gpu)
    late = torch.as_tensor(rng.random(n) < 0.5, device=gpu)
    dob = torch.as_tensor(rng.uniform(-idt, n_int * idt, n), dtype=dtype,
                          device=gpu)
    p = p.replace(status=torch.where(late, st.NOT_RELEASED, st.ACTIVE).to(
        torch.int32), dob=torch.where(late, dob, torch.zeros_like(dob)))
    p, _ = _sort(g, p)
    rec = pk.build_packed_records(
        g, synth.fieldset_for(c, t_center=900.0, dt=1800.0))
    nl = rec.tab.shape[-1]
    kx.reset_launches()
    want = {"active_steps": 0, "staged_block_steps": 0,
            "global_block_steps": 0, "split_block_steps": 0}
    q = p
    for i in range(n_int):
        t = i * idt
        released = ((q.status == st.NOT_RELEASED)
                    & (torch.tensor(t, dtype=dtype, device=gpu) >= q.dob))
        status = torch.where(released, st.ACTIVE, q.status)
        boxes = kx.block_boxes(g, q.x, q.y, status, nl)
        want["active_steps"] += int((status == st.ACTIVE).sum())
        want["staged_block_steps"] += int(
            (boxes["fits"] | boxes["split"]).sum())
        want["split_block_steps"] += int(boxes["split"].sum())
        want["global_block_steps"] += int(
            (boxes["live"] & ~boxes["fits"] & ~boxes["split"]).sum())
        kx.ext_step_fused(ctx, cfg, q, rec, t)
        q = kx.ext_step_reference(ctx, cfg, q, rec, t)
    got = kx.counts()
    assert {k: got[k] for k in want} == want
    assert got["staged_misses"] >= 0
    # the case holds what the count has to get right
    assert 0 < int((q.status == st.OUT_OF_DOMAIN).sum()) < n // 4
    assert int(late.sum()) > int((q.status == st.NOT_RELEASED).sum()) > 0
    assert want["active_steps"] < n * n_int


# ---- the builds for LTRANS v2b run files: float64 positions (LTX_POS64),
# searched axes (LTX_AXES) and K2 on a curvilinear grid (LTX_CURV) -------

F64 = torch.float64
# stretched: spacing x1.01 a cell (rho axes and cell edges searched);
# stretched-grid: x(1 + 5e-7) a cell, non-uniform at grid.py's 1e-9 but
# uniform at the edges' 1e-4 (rho axes searched, edges arithmetic)
GEOMETRY = {"uniform": 1.0, "stretched": 1.01, "stretched-grid": 1 + 5e-7}
K1_NEW = pytest.mark.parametrize("dtype,geometry", [
    (F64, "uniform"), (F64, "stretched"), (torch.float32, "stretched"),
    (torch.float32, "stretched-grid"), (F64, "stretched-grid"),
    (F64, "curv")], ids=["f64", "f64-stretched", "f32-stretched",
                         "f32-stretched-grid", "f64-stretched-grid",
                         "f64-curv"])


def _new_case(device, dtype, geometry, **kw):
    if geometry == "curv":
        c, ctx, cfg, p = _curv_case(device, **kw)
        if dtype == F64:
            c = synth.make_curv_case(nx=41, ny=41, us=6, lx=100e3, ly=100e3,
                                     h0=50.0, omega=kw.get("omega", 1e-4),
                                     amp=0.03, mask=c.grid.mask_rho.cpu()
                                     .numpy(), dtype=F64, device=device)
            g = c.grid
            ctx = StepContext(grid=g, bounds=bd.build_boundaries_curv(
                g.mask_rho.cpu().numpy(), c.x2d, c.y2d, g.curv,
                device=device))
            cfg = replace(cfg, dtype_pos="float64")
            p = p.replace(**{k: getattr(p, k).to(F64) for k in
                             ("x", "y", "z", "dob", "age", "salt", "temp")})
        return c, ctx, cfg, p
    return _case(device, dtype=dtype, stretch=GEOMETRY[geometry], **kw)


@pytest.mark.gpu
@K1_NEW
def test_new_kernel_variants_match_plain(gpu, dtype, geometry):
    """K1 in its LTX_POS64 / LTX_AXES builds against the plain version in
    the same dtype: one external step (whole-step tolerances)."""
    from ltjax_torch.kernels import build
    c, ctx, cfg, p = _new_case(gpu, dtype, geometry)
    g = c.grid
    assert g.uniform == (geometry == "uniform")
    assert ctx.bounds.uniform == (geometry != "stretched")
    rec = pk.build_packed_records(
        g, synth.fieldset_for(c, t_center=900.0, dt=1800.0))
    kx.reset_launches()
    out = kx.ext_step_fused(ctx, cfg, p, rec, 0.0)
    ref = kx.ext_step_reference(ctx, cfg, p, rec, 0.0)
    torch.cuda.synchronize()
    v = kx.variant_of(ctx, cfg, dtype)
    assert ("LTX_POS64" in v) == (dtype == F64)
    assert ("LTX_AXES" in v) == (geometry.startswith("stretched"))
    assert kx.ext_step_fused.variant_launches == {build.tag("ext_step", v): 1}
    assert out.x.dtype == dtype
    _compare(out, ref, p.n)
    assert ref.hit_land.sum() > 0
    assert (ref.status == st.OUT_OF_DOMAIN).sum() > 0


F64_LANES = ["turb-aks", "dead-over-error", "behavior3", "behavior4",
             "behavior7", "salt", "settle"]


@pytest.fixture(scope="module")
def f64_lane_builds():
    """The float64, searched-axes builds of F64_LANES, built together (one
    nvcc each) before their tests run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ltjax_torch.kernels import build
    build.prebuild([("ext_step", kx.kernel_variant(
        Config(numpar=1, us=6, ws=7, **BEH, **LANES[name]), pos64=True,
        axes=True)) for name in F64_LANES])


@pytest.mark.gpu
@pytest.mark.parametrize("name", F64_LANES)
def test_f64_kernel_lanes_match_plain_stepwise(gpu, f64_lane_builds, name):
    """The float64 build's lanes (Visser, DVM, the 4/5 cue, TST, salt
    sampling, settlement), internal step by internal step from the plain
    float64 trajectory's state, on the stretched grid (searched axes):
    horizontal 0.05 m, vertical 1e-3 m, equal statuses."""
    c, ctx, cfg, p = _case(gpu, omega=1e-5, dtype=F64, stretch=1.01)
    c.parabolic_aks = True
    c.halocline = True
    cfg1 = replace(cfg, dt=cfg.idt, **BEH, **LANES[name])
    if cfg1.settlementon:
        habitat, holes = _polygons()
        xe = ctx.bounds.x_edges.cpu().numpy()
        ye = ctx.bounds.y_edges.cpu().numpy()
        ctx.polys = stl.build_polygons(habitat, xe, ye, device=gpu)
        ctx.holes = stl.build_polygons(holes, xe, ye, device=gpu)
    rng = np.random.default_rng(10)
    age = rng.uniform(0.0, 3 * 86400.0, p.n)
    p = p.replace(age=torch.tensor(age, dtype=F64, device=gpu),
                  dob=torch.tensor(-age, dtype=F64, device=gpu),
                  pid=torch.tensor(rng.permutation(p.n), dtype=torch.int32,
                                   device=gpu))
    t0 = 9 * 3600.0
    fs = synth.with_vertical_motion(
        synth.fieldset_for(c, t_center=t0 + 900.0, dt=1800.0), seed=12)
    rec = pk.build_packed_records(c.grid, fs, with_aks=cfg1.VTurbOn,
                                  with_scalars=cfg1.needs_salt_fields())
    q = p
    kx.reset_launches()
    for i in range(4):
        t = t0 + i * float(cfg1.idt)
        out = kx.ext_step_fused(ctx, cfg1, q, rec, t, fields=fs, seed=5,
                                ext_idx=i)
        ref = kx.ext_step_reference(ctx, cfg1, q, rec, t, fields=fs, seed=5,
                                    ext_idx=i)
        torch.cuda.synchronize()
        assert (out.status != ref.status).sum() == 0
        assert (out.settle_poly != ref.settle_poly).sum() == 0
        for k, tol in (("x", 0.05), ("y", 0.05), ("z", 1e-3), ("age", 1e-3),
                       ("salt", 1e-3), ("temp", 1e-3)):
            np.testing.assert_allclose(getattr(out, k).cpu().numpy(),
                                       getattr(ref, k).cpu().numpy(),
                                       rtol=0, atol=tol)
        q = ref
    tags = list(kx.ext_step_fused.variant_launches)
    assert len(tags) == 1 and "a1" in tags[0] and "p1" in tags[0], tags
    if cfg1.mortality:
        assert (q.status == st.DEAD).sum() > 0
    if cfg1.SaltTempOn:
        assert float(q.salt.max() - q.salt.min()) > 1.0
    if cfg1.settlementon:
        assert (q.status == st.SETTLED).sum() > 0


K2_NEW = pytest.mark.parametrize("dtype,geometry", [
    (F64, "uniform"), (torch.float32, "stretched"), (F64, "stretched"),
    (torch.float32, "curv"), (F64, "curv")],
    ids=["f64", "f32-stretched", "f64-stretched", "f32-curv", "f64-curv"])


@pytest.mark.gpu
@K2_NEW
def test_new_rk4_variants_match_plain(gpu, dtype, geometry):
    """K2 in its LTX_POS64 / LTX_AXES / LTX_CURV builds against its plain
    version on one internal step with a random w and zeta (per-step
    tolerances: 0.05 m, 1e-3 m, the stage-1 currents to 0.05 m / idt)."""
    c, ctx, cfg, p = _new_case(gpu, dtype, geometry, omega=1e-5)
    rec = pk.build_packed_records(c.grid, synth.with_vertical_motion(
        synth.fieldset_for(c, t_center=900.0, dt=1800.0), seed=11))
    idt = float(cfg.idt)
    tabs = pk.stage_value_tables(c.grid, rec, 450.0, idt)
    kr.rk4_displacement_fused.variant_launches = {}
    out = kr.rk4_displacement_fused(c.grid, tabs, p.x, p.y, p.z, 0.0,
                                    cfg.z0, idt, stage1=True)
    from ltjax_torch.kernels import build
    assert kr.rk4_displacement_fused.variant_launches == {
        build.tag("rk4_step", kr.kernel_variant(c.grid, dtype)): 1}
    ref = pk.rk4_displacement_collapsed(c.grid, tabs, p.x, p.y, p.z, 0.0,
                                        cfg.z0, idt)
    cur = pk.find_currents_collapsed(c.grid, tabs[0], p.x, p.y, p.z, 0.0,
                                     cfg.z0)[:2]
    for a, b, tol in zip(out, ref + cur, (0.05, 0.05, 1e-3, 0.05 / idt,
                                          0.05 / idt)):
        assert a.dtype == dtype
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)
    assert float(ref[2].abs().max()) > 0.1          # w moved them


@pytest.mark.gpu
def test_f64_kernel_carries_sub_ulp_motion(gpu):
    """A slow uniform flow (1e-5 m/s, 1.2 mm an internal step) moves a
    particle near x = 2e5 m by less than half a float32 ulp there
    (0.0156 m) each step: the float64 build accumulates the 30 steps'
    3.6 cm to within 1e-6 m of the plain float64 path, the float32 build's
    particle does not move."""
    outs = {}
    for dtype in (torch.float32, F64):
        c = synth.make_solid_body_case(nx=41, ny=41, us=6, lx=400e3,
                                       ly=400e3, h0=50.0, omega=0.0,
                                       dtype=dtype, device=gpu)
        g = c.grid
        ctx = StepContext(grid=g, bounds=bd.build_boundaries(
            g.mask_rho.cpu().numpy(), g.x_rho.cpu().numpy(),
            g.y_rho.cpu().numpy(), device=gpu))
        fs = synth.fieldset_for(c, t_center=1800.0, dt=3600.0)
        fs.u[:] = 1e-5
        rec = pk.build_packed_records(g, fs)
        cfg = Config(numpar=8, dt=3600, idt=120, us=6, ws=7,
                     OpenOceanBoundary=True,
                     dtype_pos=str(dtype).replace("torch.", ""))
        x = 2e5 + np.arange(8) * 0.37
        p = st.init_particles(x, np.full(8, 2e5), np.full(8, -20.0),
                              dtype=dtype, device=gpu)
        out = kx.ext_step_fused(ctx, cfg, p, rec, 0.0)
        ref = kx.ext_step_reference(ctx, cfg, p, rec, 0.0)
        torch.cuda.synchronize()
        outs[dtype] = (p, out, ref)
    p, out, ref = outs[torch.float32]
    assert torch.equal(out.x, p.x)
    p, out, ref = outs[F64]
    moved = (out.x - p.x).cpu().numpy()
    np.testing.assert_allclose(moved, 0.036, rtol=1e-3)
    np.testing.assert_allclose(out.x.cpu().numpy(), ref.x.cpu().numpy(),
                               rtol=0, atol=1e-6)


NATIVE_GPU = pytest.mark.parametrize("dtype,geometry,sigma", [
    (F64, "uniform", 0.0), (F64, "uniform", -1.0),
    (F64, "stretched", -1.0), (F64, "curv", 0.0),
    (torch.float32, "stretched", 0.0), (torch.float32, "curv", -1.0)],
    ids=["sigma0", "adaptive", "stretched-adaptive", "curv",
         "f32-stretched", "f32-curv-adaptive"])


@pytest.mark.gpu
@NATIVE_GPU
def test_native_route_on_gpu_matches_cpu(gpu, dtype, geometry, sigma):
    """The native route (fast_interp off or adaptive tension: PyTorch ops,
    no kernel) on the card against the same route on the CPU, one
    external step (4 internal steps) of a random w and zeta with
    turbulence: float64 1e-6 m horizontally, 1e-9 m vertically, statuses
    equal (round-off of the devices' transcendentals); float32 the
    whole-step tolerances of _compare (an ulp of exp or log may flip a
    reflection); its tensors stay on the card and neither kernel
    launches."""
    outs = {}
    for dev in (gpu, torch.device("cpu")):
        c, ctx, cfg, p = _new_case(dev, dtype, geometry, omega=1e-5)
        cfg = replace(cfg, fast_interp=False, tension_sigma=sigma,
                      HTurbOn=True, ConstantHTurb=1.0)
        fs = synth.with_vertical_motion(synth.fieldset_for(
            c, t_center=900.0, dt=1800.0), seed=3, w_amp=2e-3)
        kx.reset_launches()
        kr.rk4_displacement_fused.launches = 0
        out = make_fused_external_steps(ctx, cfg, 1)(p, fs, 0.0, 0)
        assert out.x.device.type == dev.type and out.x.dtype == dtype
        assert kx.ext_step_fused.launches == 0
        assert kr.rk4_displacement_fused.launches == 0
        outs[dev.type] = out
    a, b = outs["cuda"].to(torch.device("cpu")), outs["cpu"]
    if dtype == torch.float32:
        _compare(a, b, p.n)
    else:
        assert torch.equal(a.status, b.status)
        for k, tol in (("x", 1e-6), ("y", 1e-6), ("z", 1e-9)):
            np.testing.assert_allclose(getattr(a, k).numpy(),
                                       getattr(b, k).numpy(), rtol=0,
                                       atol=tol)
    assert (b.z - p.z.cpu()).abs().max() > 0.1


PACKED_GPU = pytest.mark.parametrize("dtype,geometry,lanes", [
    (F64, "uniform", dict(HTurbOn=True, ConstantHTurb=1.0)),
    (F64, "stretched", dict(Behavior=7, mortality=True,
                            stochastic_mortality=True, deadage=900.0)),
    (F64, "curv", dict(HTurbOn=True, ConstantHTurb=1.0)),
    (torch.float32, "uniform", dict(HTurbOn=True, ConstantHTurb=1.0))],
    ids=["f64", "f64-stretched-stochastic", "f64-curv", "f32"])


@pytest.mark.gpu
@PACKED_GPU
def test_packed_route_on_gpu_matches_cpu(gpu, dtype, geometry, lanes):
    """The packed route (kernel_interp off: per-column fits,
    eval-then-blend, PyTorch ops) on the card against the same route on
    the CPU, one external step (4 internal steps) of a random w and zeta:
    float64 (positions, grid and fields: float32 tables round differently
    on the two devices) 1e-6 m horizontally, 1e-9 m vertically, statuses
    equal;
    float32 the whole-step tolerances of _compare; neither kernel
    launches."""
    outs = {}
    for dev in (gpu, torch.device("cpu")):
        c, ctx, cfg, p = _new_case(dev, dtype, geometry, omega=1e-5)
        cfg = replace(cfg, kernel_interp=False, **lanes)
        fs = synth.with_vertical_motion(synth.fieldset_for(
            c, t_center=900.0, dt=1800.0, dtype=dtype), seed=3, w_amp=2e-3)
        kx.reset_launches()
        kr.rk4_displacement_fused.launches = 0
        out = make_fused_external_steps(ctx, cfg, 1)(p, fs, 0.0, 0)
        assert out.x.device.type == dev.type and out.x.dtype == dtype
        assert kx.ext_step_fused.launches == 0
        assert kr.rk4_displacement_fused.launches == 0
        outs[dev.type] = out
    a, b = outs["cuda"].to(torch.device("cpu")), outs["cpu"]
    if dtype == torch.float32:
        _compare(a, b, p.n)
    else:
        assert torch.equal(a.status, b.status)
        for k, tol in (("x", 1e-6), ("y", 1e-6), ("z", 1e-9)):
            np.testing.assert_allclose(getattr(a, k).numpy(),
                                       getattr(b, k).numpy(), rtol=0,
                                       atol=tol)
    assert (b.z - p.z.cpu()).abs().max() > 0.1
    if cfg.stochastic_mortality:
        assert (b.status == st.DEAD).sum() > 0


@pytest.mark.gpu
def test_cli_prefetch_bit_equal_on_gpu(gpu, tmp_path):
    """The CLI on the card with prefetch on (records copied to the card on
    a side stream) and off: final particles equal in every column; the
    prefetcher hands over CUDA tensors equal to the records read."""
    import contextlib
    import io
    from ltjax_torch import run
    from ltjax_torch.config import config_from_namelist
    from ltjax_torch.io.prefetch import Prefetcher
    from ltjax_torch.io.roms import RomsSeries
    c = synth.make_solid_body_case(nx=31, ny=31, us=6, lx=30e3, ly=30e3,
                                   h0=40.0, omega=1e-4, dtype=F64,
                                   parabolic_aks=True)
    rng = np.random.default_rng(4)
    n = 2000
    nml = synth.write_run_files(
        c, str(tmp_path), rng.uniform(8e3, 22e3, n),
        rng.uniform(8e3, 22e3, n), rng.uniform(-35.0, -3.0, n), n_ext=6,
        dt=1800, idt=450, iprint=6 * 1800, ext_fuse=2, HTurbOn=True,
        ConstantHTurb=1.0, VTurbOn=True, readAks=True)
    cfg = config_from_namelist(nml)
    finals = {}
    for on in (True, False):
        with contextlib.redirect_stdout(io.StringIO()):
            finals[on] = run.run(replace(cfg, prefetch=on), device="cuda")
    for k in st.FIELDS:
        assert torch.equal(getattr(finals[True], k),
                           getattr(finals[False], k)), k
    want = RomsSeries(cfg)
    pf = Prefetcher(RomsSeries(cfg).next_record, depth=3, device=gpu)
    for _ in range(4):
        rec, ref = pf.next(), want.next_record()
        assert rec["u"].device.type == "cuda" and rec["time"] == ref["time"]
        for k in ("zeta", "u", "v", "w", "aks"):
            assert torch.equal(rec[k].cpu(), torch.from_numpy(ref[k]))
    pf.close()
    want.close()


def _strip_case(device, dtype, n=8192, ntiles=3, tile=1):
    """Tile ``tile`` of _case's grid cut into ``ntiles`` strips (halo of
    shard.halo_rows_needed for omega 1e-4 at the domain's corner, 30 min):
    the tile's context and record table, and n of _case's particles moved
    into the strip (its halo rows included), one in 8 slots EMPTY."""
    from ltjax_torch import shard
    c, ctx, cfg, p = _case(device, n=n, dtype=dtype)
    halo = shard.halo_rows_needed(1e-4 * 71e3, 1800.0, 2.5e3)
    spec = shard.make_spec(cfg, 41, n, 1, ntiles, halo=halo)
    tctx = shard.tile_context(ctx, spec, shard.build_tiled_static(ctx.grid,
                                                                  spec), tile)
    fs = shard.strip_fieldset(synth.fieldset_for(c, t_center=900.0,
                                                 dt=1800.0), spec, tile, 41)
    ys = tctx.grid.y_rho
    y = ys[1] + (p.y - p.y.min()) / (p.y.max() - p.y.min()) * (ys[-2] - ys[1])
    empty = torch.arange(n, device=device) % 8 == 3
    q = p.replace(y=y.to(dtype), status=torch.where(
        empty, shard.EMPTY, p.status).to(torch.int32))
    q, _ = _sort(tctx.grid, q)
    return c, tctx, cfg, q, pk.build_packed_records(tctx.grid, fs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_kernels_on_a_strip_match_plain(gpu, dtype):
    """K1 and K2 in their LTX_TILE builds on a tile's strip with EMPTY
    slots, against their plain versions (K1: one external step, the
    tolerances above; K2: one internal step, 0.05 m / 1e-3 m); EMPTY
    slots come back bit-unchanged."""
    from ltjax_torch import shard
    from ltjax_torch.kernels import build
    c, tctx, cfg, p, prec = _strip_case(gpu, dtype)
    kx.reset_launches()
    out = kx.ext_step_fused(tctx, cfg, p, prec, 0.0)
    ref = kx.ext_step_reference(tctx, cfg, p, prec, 0.0)
    tag = build.tag("ext_step", kx.variant_of(tctx, cfg, dtype))
    assert "t1" in tag and kx.ext_step_fused.variant_launches == {tag: 1}
    _compare(out, ref, p.n)
    m = p.status == shard.EMPTY
    assert m.sum() > 0
    for k in st.FIELDS:
        assert torch.equal(getattr(out, k)[m], getattr(p, k)[m]), k
    idt = float(cfg.idt)
    tabs = pk.stage_value_tables(tctx.grid, prec, 450.0, idt)
    d = kr.rk4_displacement_fused(tctx.grid, tabs, p.x, p.y, p.z, 0.0,
                                  cfg.z0, idt)
    assert "LTX_TILE" in kr.kernel_variant(tctx.grid, dtype)
    r = pk.rk4_displacement_collapsed(tctx.grid, tabs, p.x, p.y, p.z, 0.0,
                                      cfg.z0, idt)
    for a, b, tol in zip(d, r, (0.05, 0.05, 1e-3)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=tol)


@pytest.mark.gpu
def test_two_gloo_ranks_on_the_card_match_one_rank(gpu):
    """2 tiles, 2 gloo ranks sharing the card, against one rank's K1
    route: 65,536 float64 particles, 2 external steps in one chunk, the
    same particles bit for bit (the tiles locate on the whole grid's
    axes), particles migrated, one launch per rank and external step."""
    from ltjax_torch import shard
    c, ctx, cfg, p = _case(gpu, n=65536, dtype=F64)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 4, device=gpu)
    ref = make_fused_external_steps(ctx, cfg, 2)(p, fsR, 0.0, 0)
    halo = shard.halo_rows_needed(1e-4 * 71e3, 1800.0, 2.5e3)
    spec = shard.make_spec(cfg, 41, p.n, 1, 2, halo=halo, slack=2.0)
    (got, ranks), = shard.run_tiled_steps(
        [shard.TiledCase(ctx, cfg, p, fsR, 2, spec, n_fuse=2)],
        device="cuda", backend="gloo")
    order = torch.argsort(ref.pid.cpu())
    for k in st.FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k).cpu()[order]), k
    assert [r["launches"] for r in ranks] == [2, 2]
    assert sum(r["sent"] for r in ranks) > 0
    assert sum(r["drops"] for r in ranks) == 0


@pytest.mark.gpu
def test_native_strip_reads_feed_the_prefetcher_on_gpu(gpu, tmp_path):
    """A rank's strip reads through the native reader, handed to the card
    by the prefetcher: the strip of the whole records, bit for bit."""
    from ltjax_torch import shard
    from ltjax_torch.config import Config
    from ltjax_torch.io.prefetch import Prefetcher
    from ltjax_torch.io.roms import RomsSeries
    c = synth.make_solid_body_case(nx=21, ny=25, us=5, lx=20e3, ly=24e3,
                                   parabolic_aks=True)
    _, paths = synth.write_roms_files(c, str(tmp_path), n_records=5,
                                      dt=1800.0, records_per_file=2)
    cfg = Config(us=5, ws=6, readAks=True)
    spec = shard.make_spec(cfg, 25, 100, 1, 3, halo=3)
    a, b = shard.strip_rows(spec, 2, 25)
    strip = RomsSeries(cfg, paths=paths, eta_slice=(a, b))
    assert strip.reader == "native"
    pf = Prefetcher(lambda: shard.strip_record(strip.next_record(), spec, 2,
                                               25, a), depth=3, device=gpu)
    whole = RomsSeries(cfg, paths=paths)
    idx_r = shard.strip_index(spec, 2, 25)
    idx_v = shard.strip_index(spec, 2, 24)
    for _ in range(5):
        rec, ref = pf.next(), whole.next_record()
        assert rec["u"].device.type == "cuda" and rec["time"] == ref["time"]
        for k in ("zeta", "u", "v", "w", "aks"):
            want = np.take(ref[k], idx_v if k == "v" else idx_r, axis=-2)
            assert torch.equal(rec[k].cpu(), torch.from_numpy(want)), k
    pf.close()
    strip.close()
    whole.close()


BANDED_ROUTES = {
    "ext_step": dict(HTurbOn=True, ConstantHTurb=1.0),
    "per_step": dict(Behavior=6, sink=1e-3, mortality=True,
                     stochastic_mortality=True, deadage=3600.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(BANDED_ROUTES))
def test_banded_sort_bit_equal_on_gpu(gpu, route):
    """The depth-banded sort on the card: 65,536 particles, 2 external
    steps through make_fused_external_steps, 3 bands of 16 m, sorted every
    step, against the unbanded run, every column bit for bit (the same
    DEAD pids on the per-step route); the kernel of the route launched."""
    c, ctx, cfg, p = _case(gpu, n=65536)
    plain = replace(cfg, ext_sort_every=1, **BANDED_ROUTES[route])
    banded = replace(plain, sort_depth_bands=3, sort_band_height=16.0)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 4, device=gpu)
    want = make_fused_external_steps(ctx, plain, 2)(p, fsR, 0.0, 0)
    kx.reset_launches()
    n0 = kr.rk4_displacement_fused.launches
    got = make_fused_external_steps(ctx, banded, 2)(p, fsR, 0.0, 0)
    for k in st.FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    if route == "per_step":
        assert (kr.rk4_displacement_fused.launches - n0
                == 2 * cfg.internal_steps)
        assert (got.status == st.DEAD).sum() > 1000
    else:
        assert kx.ext_step_fused.launches == 2


@pytest.mark.gpu
def test_banded_tiles_on_the_card_match_one_unbanded_rank(gpu):
    """2 tiles, 2 gloo ranks sharing the card, 3 depth bands of 16 m,
    against one rank's unbanded K1 route: 65,536 float64 particles, 2
    external steps, bit for bit, one launch per rank and step."""
    from ltjax_torch import shard
    c, ctx, cfg, p = _case(gpu, n=65536, dtype=F64)
    banded = replace(cfg, sort_depth_bands=3, sort_band_height=16.0)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 4, device=gpu)
    ref = make_fused_external_steps(ctx, cfg, 2)(p, fsR, 0.0, 0)
    halo = shard.halo_rows_needed(1e-4 * 71e3, 1800.0, 2.5e3)
    spec = shard.make_spec(banded, 41, p.n, 1, 2, halo=halo, slack=2.0)
    (got, ranks), = shard.run_tiled_steps(
        [shard.TiledCase(ctx, banded, p, fsR, 2, spec, n_fuse=2)],
        device="cuda", backend="gloo")
    order = torch.argsort(ref.pid.cpu())
    for k in st.FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k).cpu()[order]), k
    assert [r["launches"] for r in ranks] == [2, 2]
    assert sum(r["drops"] for r in ranks) == 0


# The per-step route's lanes kernel K3 (csrc/step_lanes.cu) against its
# plain version (kernels.step_lanes.lanes) at 65,536 particles: two
# internal steps, each from the plain trajectory's state and on K2's
# displacement of that state.  Gates per internal step (PERF.md §2):
# 0.05 m horizontally, 1e-3 m vertically, age, salt and temp 1e-3, equal
# statuses and settle_poly, the DEATH decisions equal; behaviors 1-5 and
# 7 and settlement decide on a threshold (PERF.md §2, chip_smoke.py
# lanes_stepwise), so a particle within round-off of one may take the
# other branch: such flips are allowed for at most 0.01% of the particles.
STOCHASTIC = dict(mortality=True, stochastic_mortality=True,
                  deadage=3600.0)
K3_CASES = {
    "advect-behavior6": ("uniform", torch.float32, dict(Behavior=6,
                                                        sink=5e-4)),
    "turb-aks": ("uniform", torch.float32, LANES["turb-aks"]),
    "behavior3": ("uniform", torch.float32, dict(Behavior=3)),
    "behavior4": ("uniform", torch.float32, LANES["behavior4"]),
    "behavior7": ("uniform", torch.float32, dict(Behavior=7)),
    "settle": ("uniform", torch.float32, LANES["settle"]),
    "salt": ("uniform", torch.float32, LANES["salt"]),
    "curv": ("curv", torch.float32, LANES["turb-aks"]),
    "f64": ("uniform", F64, dict(LANES["behavior4"], SaltTempOn=True,
                                 readTemp=True)),
    "stretched": ("stretched", torch.float32, LANES["settle"]),
    "tile": ("tile", torch.float32, dict(Behavior=6, sink=5e-4)),
    "oyster": ("uniform", torch.float32, dict(
        LANES["behavior4"], **LANES["turb-aks"], **LANES["salt"],
        settlementon=True, holesExist=True)),
}


def _k3_case(device, geometry, dtype, n=65536):
    """(case, ctx, cfg, particles): _case's, _curv_case's or a tile's
    strip (_strip_case) at n particles, ages straddling the swim ramp,
    pids permuted."""
    if geometry == "tile":
        c, ctx, cfg, p, _ = _strip_case(device, dtype, n=n)
    elif geometry == "curv":
        c, ctx, cfg, p = _curv_case(device, n=n, omega=1e-5)
    else:
        c, ctx, cfg, p = _case(device, n=n, omega=1e-5, dtype=dtype,
                               stretch=GEOMETRY[geometry])
    rng = np.random.default_rng(10)
    age = rng.uniform(0.0, 3 * 86400.0, p.n)
    p = p.replace(age=torch.tensor(age, dtype=dtype, device=device),
                  dob=torch.where(p.dob > 0, p.dob, torch.tensor(
                      -age, dtype=dtype, device=device)),
                  pid=torch.tensor(rng.permutation(p.n), dtype=torch.int32,
                                   device=device))
    return c, ctx, cfg, p


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(K3_CASES))
def test_lanes_kernel_matches_plain(gpu, name):
    from ltjax_torch.kernels import build
    from ltjax_torch.kernels import step_lanes as sl
    geometry, dtype, lanes = K3_CASES[name]
    c, ctx, cfg, p = _k3_case(gpu, geometry, dtype)
    c.parabolic_aks = True
    c.halocline = True
    cfg1 = replace(cfg, dt=cfg.idt, **{**BEH, **lanes, **STOCHASTIC})
    if cfg1.settlementon:
        habitat, holes = _polygons()
        xe = ctx.bounds.x_edges.cpu().numpy()
        ye = ctx.bounds.y_edges.cpu().numpy()
        ctx.polys = stl.build_polygons(habitat, xe, ye, device=gpu)
        ctx.holes = stl.build_polygons(holes, xe, ye, device=gpu)
    g = ctx.grid                   # a tile's: its strip
    t0 = 9 * 3600.0
    fs = synth.fieldset_for(c, t_center=t0 + 900.0, dt=1800.0)
    if geometry == "tile":
        from ltjax_torch import shard
        spec = shard.make_spec(cfg, 41, p.n, 1, 3, halo=shard.
                               halo_rows_needed(1e-4 * 71e3, 1800.0, 2.5e3))
        fs = shard.strip_fieldset(fs, spec, 1, 41)
    fs = synth.with_vertical_motion(fs, seed=12)
    prec = pk.build_packed_records(g, fs, with_aks=cfg1.VTurbOn,
                                   with_scalars=cfg1.needs_salt_fields())
    idt = float(cfg1.idt)
    tag = build.tag("step_lanes", sl.kernel_variant(ctx, cfg1, dtype))
    thresholds = cfg1.Behavior in (1, 2, 3, 4, 5, 7) or cfg1.settlementon
    q, dead = p, 0
    for i in range(2):
        t = t0 + i * idt
        tabs = pk.stage_value_tables(g, prec, t, idt)
        disp = kr.rk4_displacement_fused(g, tabs, q.x, q.y, q.z, 0.0,
                                         cfg1.z0, idt,
                                         stage1=cfg1.Behavior == 7)
        aux = sl.aux_tables(g, cfg1, prec, t, idt)
        sl.step_lanes_fused.variant_launches = {}
        out = sl.step_lanes_fused(ctx, cfg1, 5, i, q, fs, tabs, aux, t,
                                  disp)
        ref = sl.step_lanes_reference(ctx, cfg1, 5, i, q, fs, tabs, t,
                                      disp, aux)
        torch.cuda.synchronize()
        assert sl.step_lanes_fused.variant_launches == {tag: 1}
        assert torch.equal(out.status, ref.status)
        assert torch.equal(out.status == st.DEAD, ref.status == st.DEAD)
        assert torch.equal(out.settle_poly, ref.settle_poly)
        flip = (((out.x - ref.x).abs() > 0.05) | ((out.y - ref.y).abs() > 0.05)
                | ((out.z - ref.z).abs() > 1e-3))
        assert int(flip.sum()) <= (1e-4 * p.n if thresholds else 0)
        keep = ~flip
        for k in ("age", "salt", "temp"):
            np.testing.assert_allclose(getattr(out, k)[keep].cpu().numpy(),
                                       getattr(ref, k)[keep].cpu().numpy(),
                                       rtol=0, atol=1e-3)
        for k in ("hit_land", "hit_bottom"):
            assert (getattr(out, k) != getattr(ref, k)).sum() <= 1e-4 * p.n
        dead += int(((ref.status == st.DEAD) & (q.status != st.DEAD)).sum())
        empty = q.status == -1         # a tile's EMPTY slots: unchanged
        for k in st.FIELDS:
            assert torch.equal(getattr(out, k)[empty],
                               getattr(q, k)[empty]), k
        q = ref
    assert dead > 0
    assert (geometry == "tile") == bool((p.status == -1).any())
    if cfg1.SaltTempOn:
        assert float(q.salt.max() - q.salt.min()) > 1.0


@pytest.mark.gpu
def test_lanes_kernel_copies_nothing_from_the_host(gpu):
    """30 internal steps of the per-step route (the oyster lanes): the
    profiler records K2's and K3's 30 launches each, and no host-to-device
    copy and no pinned allocation after the first step (the static params
    and tables are made once per context)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ltjax_torch.kernels import step_lanes as sl
    from ltjax_torch.step import per_step_external
    c, ctx, cfg, p = _case(gpu, omega=1e-5)
    c.parabolic_aks = True
    c.halocline = True
    cfg = replace(cfg, **{**BEH, **K3_CASES["oyster"][2], **STOCHASTIC})
    habitat, holes = _polygons()
    xe = ctx.bounds.x_edges.cpu().numpy()
    ye = ctx.bounds.y_edges.cpu().numpy()
    ctx.polys = stl.build_polygons(habitat, xe, ye, device=gpu)
    ctx.holes = stl.build_polygons(holes, xe, ye, device=gpu)
    fs = synth.fieldset_for(c, t_center=900.0, dt=1800.0)
    prec = pk.build_packed_records(ctx.grid, fs, with_aks=True,
                                   with_scalars=True)
    # 30 internal steps of 60 s inside the records' span
    cfg1 = replace(cfg, idt=60, dt=60)
    per_step_external(ctx, cfg1, p, prec, 0.0, fs, 0)    # the static part
    torch.cuda.synchronize()
    cfg30 = replace(cfg1, dt=30 * 60)
    n3 = sl.step_lanes_fused.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = per_step_external(ctx, cfg30, p, prec, 0.0, fs, 1)
        torch.cuda.synchronize()
    assert sl.step_lanes_fused.launches == n3 + 30
    ev = prof.events()
    dev_ev = [e for e in ev if e.device_type == DeviceType.CUDA]
    assert sum("step_lanes_kernel" in e.name for e in dev_ev) == 30
    assert sum("rk4_step_kernel" in e.name for e in dev_ev) == 30
    h2d = [e.name for e in ev if "HtoD" in e.name or "Memcpy HtoD" in e.name
           or "pin_memory" in e.name or "cudaHostAlloc" in e.name]
    assert not h2d, h2d[:5]
    assert torch.isfinite(out.x).all() and torch.isfinite(out.salt).all()


@pytest.mark.gpu
def test_per_step_route_launches_lanes_kernel_per_internal_step(
        gpu, monkeypatch):
    """Stochastic mortality on the card: K2 and K3 once per internal step,
    never the plain lanes."""
    from ltjax_torch.kernels import step_lanes as sl
    calls = []
    plain = sl.lanes
    monkeypatch.setattr(sl, "lanes",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    c, ctx, cfg, p = _case(gpu)
    cfg = replace(cfg, Behavior=7, Hswimspeed=0.1, swimslow=1e-3,
                  swimfast=1e-3, **STOCHASTIC)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 5)
    n2 = kr.rk4_displacement_fused.launches
    n3 = sl.step_lanes_fused.launches
    out = make_fused_external_steps(ctx, cfg, 3)(p, fsR, 0.0, 0)
    assert kr.rk4_displacement_fused.launches == n2 + 3 * cfg.internal_steps
    assert sl.step_lanes_fused.launches == n3 + 3 * cfg.internal_steps
    assert not calls
    assert torch.isfinite(out.x).all() and (out.status == st.DEAD).any()


def _key_inputs(n, bits, seed):
    """Cells over [-8, 2^bits + 8) with the corners and clamped cells
    first, statuses of every kind (EMPTY -1 included), bands -2..8."""
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    i = rng.integers(-8, hi + 8, n)
    j = rng.integers(-8, hi + 8, n)
    i[:8] = [0, hi - 1, 0, hi - 1, hi + 40000, -3, -(1 << 30), 1 << 30]
    j[:8] = [0, hi - 1, hi - 1, 0, -3, hi + 7, 1 << 30, -(1 << 30)]
    status = rng.choice([-1, 0, 1, 2, 3, 4, 5], n)
    band = rng.integers(-2, 9, n)
    return [torch.tensor(a, dtype=torch.int32) for a in (i, j, status, band)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits,n_bands", [(15, None), (14, 1), (14, 3),
                                          (14, 6)])
def test_sort_key_kernel_matches_plain(gpu, bits, n_bands):
    """1M slots: the kernel's int32 keys equal the plain version's bit
    for bit, one launch a call."""
    i, j, status, band = _key_inputs(1_000_000, bits, bits + (n_bands or 0))
    depth_band = None if n_bands is None else band
    want = sk.sort_key(i, j, status, depth_band, n_bands or 1)
    n0 = sk.sort_key.launches
    got = sk.sort_key(i.to(gpu), j.to(gpu), status.to(gpu),
                      None if depth_band is None else depth_band.to(gpu),
                      n_bands or 1)
    torch.cuda.synchronize()
    assert sk.sort_key.launches == n0 + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    empty = torch.empty(0, dtype=torch.int32, device=gpu)
    assert sk.sort_key(empty, empty, empty).shape == (0,)
    assert sk.sort_key.launches == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_bands", [None, 4], ids=["unbanded", "banded"])
def test_sort_by_cell_on_gpu_matches_cpu(gpu, n_bands):
    """sort_by_cell on the card (the kernel's key, an int32 argsort)
    gives the CPU's permutation and columns from the same cells: 1M
    slots, many ties (cells of a 200 x 200 grid), every status."""
    i, j, status, band = _key_inputs(1_000_000, 8, 11)
    i, j = i.clamp(0, 199), j.clamp(0, 199)
    rng = np.random.default_rng(12)
    n = i.shape[0]
    p = st.init_particles(rng.uniform(0, 2e5, n), rng.uniform(0, 2e5, n),
                          rng.uniform(-40, -5, n)).replace(status=status)
    depth_band = None if n_bands is None else band
    ps, want = sp.sort_by_cell(p, i, j, depth_band, n_bands or 1)
    n0 = sk.sort_key.launches
    psg, got = sp.sort_by_cell(
        p.to(gpu), i.to(gpu), j.to(gpu),
        None if depth_band is None else depth_band.to(gpu), n_bands or 1)
    assert sk.sort_key.launches == n0 + 1
    assert torch.equal(got.cpu(), want)
    for k in st.FIELDS:
        assert torch.equal(getattr(psg, k).cpu(), getattr(ps, k)), k


@pytest.mark.gpu
@pytest.mark.parametrize("every,sorts", [(2, 2), (1, 4)])
def test_fused_steps_launch_the_sort_key_once_a_sort(gpu, every, sorts):
    """make_fused_external_steps over 4 external steps sorts every
    ``ext_sort_every`` of them: one launch of the key's kernel a sort."""
    c, ctx, cfg, p = _case(gpu)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 6, device=gpu)
    n0 = sk.sort_key.launches
    make_fused_external_steps(ctx, replace(cfg, ext_sort_every=every), 4)(
        p, fsR, 0.0, 0)
    assert sk.sort_key.launches == n0 + sorts


# (slots, live, leavers, arrivals, EMPTY arrivals, mig_cap, edge cases)
MIGRATIONS = {
    "mixed": (50_000, 30_000, 3_000, 2_500, 100, None, True),
    "no_leavers": (50_000, 30_000, 0, 1_000, 0, None, False),
    "all_leave": (20_000, 20_000, 20_000, 500, 0, 20_000, False),
    "all_empty": (20_000, 0, 0, 700, 50, None, False),
    "mig_cap_2": (20_000, 12_000, 600, 300, 0, 2, False),
    "past_cap": (5_000, 4_500, 100, 2_000, 30, None, False),
}


def _migration_case(dtype, device, n, live, leave, arrive, empty, mc,
                    edges_cases, seed=5):
    p, edges = synth.migration_block(n, live, leave, ntiles=4, my_t=1,
                                     dtype=dtype, device=device, seed=seed,
                                     edge_cases=edges_cases)
    a, _ = synth.migration_block(arrive, arrive, 0, ntiles=4, my_t=1,
                                 dtype=dtype, device=device, seed=seed + 1)
    status = a.status.clone()
    status[torch.randperm(arrive, generator=torch.Generator().manual_seed(
        seed))[:empty].to(device)] = shard.EMPTY
    arrivals = shard.pack_rows(a.replace(status=status))
    spec = shard.TileSpec(ndp=1, ntiles=4, halo=1, ny_loc=1, cap=n,
                          mig_cap=mc if mc is not None else n // 4)
    sent_row = shard.pack_rows(shard.sentinel(dtype, device, 5e4, 1.5e3))
    return p, spec, torch.as_tensor(edges, device=device), sent_row, arrivals


def _loopback(arrivals, log):
    """An exchange that keeps what was sent and returns ``arrivals``: the
    counts come to the host once, as over NCCL."""
    def exchange(send, counts):
        if isinstance(counts, torch.Tensor):
            counts = counts.tolist()
        log.append((send[:sum(counts)].clone(), list(counts)))
        return arrivals
    return exchange


def _bits(v):
    return v.view({8: torch.int64, 4: torch.int32}[v.element_size()]).cpu()


def _migrate_both(gpu, dtype, case):
    p, spec, edges, sent_row, arrivals = case
    want_log, got_log = [], []
    want = shard.migrate(p.to("cpu"), spec, edges.cpu(), 1, sent_row.cpu(),
                         _loopback(arrivals.cpu(), want_log))
    n0 = km.migrate.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = shard.migrate(p, spec, edges, 1, sent_row,
                                _loopback(arrivals, got_log))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    torch.cuda.synchronize()
    assert km.migrate.launches == n0 + 1
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    (gp, gd, gs), (wp, wd, ws) = got, want
    for k in st.FIELDS:
        assert torch.equal(_bits(getattr(gp, k)), _bits(getattr(wp, k))), k
    assert gd.device.type == "cuda" and gd.dtype == torch.int64
    assert (int(gd), int(gs)) == (int(wd), int(ws))
    assert got_log[0][1] == want_log[0][1]
    assert torch.equal(got_log[0][0].cpu(), want_log[0][0])
    return gp, int(gd), int(gs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(MIGRATIONS))
def test_migrate_kernel_matches_plain(gpu, dtype, name):
    n, live, leave, arrive, empty, mc, edge = MIGRATIONS[name]
    case = _migration_case(dtype, gpu, n, live, leave, arrive, empty, mc,
                           edge)
    p, drops, sent = _migrate_both(gpu, dtype, case)
    held = int((p.status != shard.EMPTY).sum())
    if name == "mig_cap_2":
        assert sent == 6 and drops == leave - 6
        assert int((p.status == st.ERROR).sum()) >= leave - 6
    if name == "past_cap":
        assert held == n and drops == live - sent + arrive - empty - n
    if name == "all_leave":
        assert sent == n and held == arrive
    if name == "no_leavers":
        assert sent == 0 and drops == 0 and held == live + arrive


@pytest.mark.gpu
def test_migrate_kernel_matches_plain_on_a_rank_of_the_four_card_cell(gpu):
    """7.5M slots, 4.2M live, 2.8% of them leaving, float64: the block of
    a middle rank of tiles-10m-4chip."""
    n, live = 7_500_000, 4_200_000
    leave = int(0.028 * live)
    case = _migration_case(F64, gpu, n, live, leave, leave, 0, n // 4,
                           False)
    p, drops, sent = _migrate_both(gpu, F64, case)
    assert sent == leave and drops == 0
    assert int((p.status != shard.EMPTY).sum()) == live
