"""The per-step route's lanes (``ltjax_torch.kernels.step_lanes``: the
lanes kernel K3's wrapper and its plain version) on the CPU.

Setup: a 60x60x10 float64 grid (150 km, a land block), a seeded random
free surface and w, a parabolic Aks profile perturbed per node, the
halocline of ``synth.halocline_fields`` perturbed per record and node, a
habitat square with a square hole and a slanted hexagon; 2,048 particles
with staggered releases and ages across the swim ramp, the settlement
age and the death age.  ``internal_step(mode="kernel")`` (the per-step
route: K2's and K3's plain versions on CPU tensors) is held against
ltjax's collapsed-mode ``internal_step`` over two chained internal
steps with stochastic mortality, turbulence, settlement and salt:
1e-6 m in float64, statuses, settle_poly and collision counts equal,
salt and temp to 1e-9 (tests/test_torch_step.py's tolerances), and
against the port's own collapsed mode bit for bit (every route runs the
same lanes function).  Then the wrapper's host side: the key vector's
DEATH pair, the death probability, the builds ``run.kernel_targets``
names for per-step configurations, and the record tables the per-step
route builds for K3.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import packed as jpk
from ltjax import state as jst
from ltjax import synth as jsynth
from ltjax.config import Config
from ltjax.physics import boundary as jbd
from ltjax.physics import settlement as jstl
from ltjax.step import StepContext as JContext
from ltjax.step import internal_step as j_internal_step
from ltjax_torch import interop, rng
from ltjax_torch import packed as tpk
from ltjax_torch import run as trun
from ltjax_torch import step as tstep
from ltjax_torch import synth
from ltjax_torch.kernels import build
from ltjax_torch.kernels import step_lanes as sl
from ltjax_torch.physics import behavior as tbh
from ltjax_torch.physics import boundary as bd
from ltjax_torch.physics import settlement as tstl

torch.set_num_threads(1)

N = 2048
BEH = dict(deadage=3600.0, pediage=86400.0, swimstart=3600.0,
           swimslow=1e-3, swimfast=3e-3, sink=5e-4, Hswimspeed=0.1,
           Swimdepth=3.0, Sgradient=0.5)
STOCHASTIC = dict(mortality=True, stochastic_mortality=True)
LANES = {
    "oyster": dict(Behavior=4, readSalt=True, readTemp=True,
                   SaltTempOn=True, settlementon=True, holesExist=True,
                   HTurbOn=True, ConstantHTurb=2e4, VTurbOn=True,
                   readAks=True),
    "behavior7": dict(Behavior=7, HTurbOn=True, ConstantHTurb=1.0),
}


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _polygons():
    th = np.linspace(0.0, 2 * np.pi, 7)[:-1] + 0.3
    hexagon = np.stack([100e3 + 12e3 * np.cos(th),
                        100e3 + 10e3 * np.sin(th)], -1)
    habitat = [(11, np.array([[30e3, 30e3], [60e3, 30e3], [60e3, 60e3],
                              [30e3, 60e3]])), (12, hexagon)]
    holes = [(1, np.array([[40e3, 40e3], [50e3, 40e3], [50e3, 50e3],
                           [40e3, 50e3]]))]
    return habitat, holes


def _case():
    """ltjax's float64 60x60x10 case: (grid, fields, bounds, particles)."""
    c = jsynth.make_solid_body_case(nx=60, ny=60, us=10, lx=150e3,
                                    ly=150e3, h0=40.0, omega=1e-4,
                                    dtype=jnp.float64)
    mask = np.ones((60, 60), np.int32)
    mask[27:32, 36:41] = 0
    grid = c.grid._replace(mask_rho=jnp.asarray(mask))
    fs = jsynth.fieldset_for(c, t_center=1800.0, dt=3600.0,
                             dtype=jnp.float64)
    r = np.random.default_rng(6)
    z_w = 40.0 * np.asarray(grid.s_w)
    K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / 40.0 + 1.0) ** 2)
    salt, temp = synth.halocline_fields(interop.grid_from_numpy(_np(grid)))

    def per_record(a, amp):
        a = np.moveaxis(a, 0, -1)[None]
        return a + amp * r.uniform(-1, 1, (3,) + a.shape[1:])

    fs = fs._replace(
        aks=jnp.asarray(K * (1.0 + 0.3 * r.uniform(-1, 1, fs.aks.shape))),
        zeta=jnp.asarray(0.3 * r.standard_normal(fs.zeta.shape)),
        w=jnp.asarray(r.uniform(-2e-3, 2e-3, fs.w.shape)),
        salt=jnp.asarray(per_record(salt, 0.2)),
        temp=jnp.asarray(per_record(temp, 0.3)))
    bounds = jbd.build_boundaries(mask, np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    x = np.concatenate([r.uniform(2e3, 148e3, N // 2),
                        r.uniform(25e3, 115e3, N - N // 2)])
    y = np.concatenate([r.uniform(2e3, 148e3, N // 2),
                        r.uniform(25e3, 110e3, N - N // 2)])
    k = N // 3
    z = r.permutation(np.concatenate([
        r.uniform(-1.0, 0.0, k), r.uniform(-39.9, -39.0, k),
        r.uniform(-39.0, -1.0, N - 2 * k)]))
    p = jst.init_particles(x, y, z, dtype=jnp.float64)
    p = p._replace(dob=jnp.asarray(r.choice([0.0, 300.0], N)),
                   age=jnp.asarray(r.uniform(0.0, 3 * 86400.0, N)),
                   pid=jnp.asarray(r.permutation(N).astype(np.int32)))
    return grid, fs, bounds, p


@pytest.fixture(scope="module")
def case():
    return _case()


def _contexts(grid, bounds, cfg):
    habitat, holes = _polygons()
    xe, ye = np.asarray(bounds.x_edges), np.asarray(bounds.y_edges)
    on = cfg.settlementon
    jctx = JContext(grid=grid, bounds=bounds,
                    polys=jstl.build_polygons(habitat, xe, ye) if on
                    else None,
                    holes=jstl.build_polygons(holes, xe, ye) if on
                    else None)
    ctx = tstep.StepContext(
        grid=interop.grid_from_numpy(_np(grid)),
        bounds=interop.boundaries_from_numpy(_np(bounds)),
        polys=tstl.build_polygons(habitat, xe, ye) if on else None,
        holes=tstl.build_polygons(holes, xe, ye) if on else None)
    return jctx, ctx


def _cfg(name):
    return Config(numpar=N, dt=1800, idt=300, us=10, ws=11,
                  OpenOceanBoundary=True, dtype_pos="float64",
                  reflect_iters=2, TrackCollisions=True,
                  **{**BEH, **LANES[name], **STOCHASTIC})


@pytest.mark.parametrize("source", ["fields", "tables"])
@pytest.mark.parametrize("name", list(LANES))
def test_per_step_lanes_match_ltjax_collapsed(case, name, source):
    """The plain version's two sources of Aks, salt and temp: ``fields``
    (a record table without those lanes: the FieldSet window, blended then
    collapsed, the collapsed route's own lanes bit for bit) and
    ``tables`` (the route's aux tables, collapsed then blended, what the
    kernel reads): both at ltjax's tolerances."""
    grid, fs, bounds, p = case
    cfg = _cfg(name)
    cfg.validate()
    assert tstep.mode_flags(None, cfg) == "per_step"
    jctx, ctx = _contexts(grid, bounds, cfg)
    jprec = jpk.build_packed_records(grid, fs)
    tfs = interop.fieldset_from_numpy(_np(fs))
    tables = source == "tables"
    prec = tpk.build_packed_records(ctx.grid, tfs, with_aks=tables,
                                    with_scalars=tables)
    assert (sl.aux_tables(ctx.grid, cfg, prec, 0.0, 300.0) is None) == (
        not tables and name == "oyster")
    pj, pt = p, interop.particles_from_numpy(_np(p))
    for i in range(2):
        t = i * 300.0
        pj = j_internal_step(jctx, cfg, jr.key(9), pj, fs, t, 40 + i,
                             jprec, mode="collapsed")
        q = tstep.internal_step(ctx, cfg, 9, pt, tfs, t, 40 + i, prec,
                                mode="kernel")
        c = tstep.internal_step(ctx, cfg, 9, pt, tfs, t, 40 + i, prec,
                                mode="collapsed")
        for k in ("x", "y", "z", "age", "status", "settle_poly", "salt",
                  "temp", "hit_land", "hit_bottom"):
            if tables and name == "oyster" and k in ("z", "salt", "temp"):
                # the other order of blend and collapse: float64 round-off
                torch.testing.assert_close(getattr(q, k), getattr(c, k),
                                           rtol=0, atol=1e-9)
            else:
                assert torch.equal(getattr(q, k), getattr(c, k)), k
        out = interop.particles_to_numpy(q)
        for k in ("status", "settle_poly", "hit_land", "hit_bottom"):
            np.testing.assert_array_equal(out[k], np.asarray(getattr(pj, k)))
        for k in ("x", "y", "z", "age"):
            np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                       rtol=0, atol=1e-6)
        for k in ("salt", "temp"):
            np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                       rtol=0, atol=1e-9)
        pt = q
    st_ = out["status"]
    assert (st_ == jst.DEAD).sum() > 0
    if cfg.ConstantHTurb > 100:        # strong turbulence: onto land
        assert out["hit_land"].sum() > 0
    if cfg.settlementon:
        assert set(out["settle_poly"][st_ == jst.SETTLED]) == {11, 12}
        assert np.ptp(out["salt"][st_ >= jst.ACTIVE]) > 1.0


def test_reference_equals_wrapper_on_cpu(case):
    """On CPU tensors the wrapper returns its plain version,
    step_lanes_reference, whatever route the lanes came from."""
    grid, fs, bounds, p = case
    cfg = _cfg("behavior7")
    _, ctx = _contexts(grid, bounds, cfg)
    tfs = interop.fieldset_from_numpy(_np(fs))
    prec = tpk.build_packed_records(ctx.grid, tfs)
    pt = interop.particles_from_numpy(_np(p))
    tabs = tpk.stage_value_tables(ctx.grid, prec, 0.0, 300.0)
    disp = (tpk.rk4_displacement_collapsed(ctx.grid, tabs, pt.x, pt.y,
                                           pt.z, 0.0, cfg.z0, 300.0)
            + tpk.find_currents_collapsed(ctx.grid, tabs[0], pt.x, pt.y,
                                          pt.z, 0.0, cfg.z0)[:2])
    aux = sl.aux_tables(ctx.grid, cfg, prec, 0.0, 300.0)
    assert aux == sl.Aux(None, None)        # behavior 7 reads no aux lane
    a = sl.step_lanes_fused(ctx, cfg, 9, 3, pt, tfs, tabs, aux, 0.0, disp)
    b = sl.step_lanes_reference(ctx, cfg, 9, 3, pt, tfs, tabs, 0.0, disp,
                                aux)
    n0 = sl.step_lanes_fused.launches
    for k in ("x", "y", "z", "age", "status", "hit_land"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert sl.step_lanes_fused.launches == n0       # no kernel on the CPU
    assert (b.status == jst.DEAD).sum() > 0


@pytest.mark.parametrize("derivation", ["host", "kernel"])
@pytest.mark.parametrize("seed,step", [(0, 0), (9, 41), (2**40 + 7, 123456),
                                       ((5, 11), 7)])
def test_key_vector_carries_the_death_pair(seed, step, derivation):
    """The (step, substream) key pairs of HTURB, VTURB, BEHAVE, MORTALITY
    and DEATH in that order (substream s at words 2s, 2s + 1), so the
    kernel's DEATH words are rng.stream_key(seed, step, DEATH): on the
    host (step_keys), and as the kernel derives them from its arguments
    (launch_words: the seed words, the step as a uint32 word; kernel_keys,
    its plain twin)."""
    if derivation == "host":
        keys = sl.step_keys(seed, step)
    else:
        k0, k1, word = sl.launch_words(seed, step)
        assert (k0, k1) == rng.seed_words(seed) and word == step
        keys = sl.kernel_keys(k0, k1, word).numpy().astype(np.uint32)
    assert keys.dtype == np.uint32 and keys.shape == (10,)
    assert tuple(int(w) for w in keys[2 * rng.DEATH:2 * rng.DEATH + 2]) == \
        rng.stream_key(seed, step, rng.DEATH)
    for sub in (rng.HTURB, rng.VTURB, rng.BEHAVE, rng.MORTALITY):
        assert tuple(int(w) for w in keys[2 * sub:2 * sub + 2]) == \
            rng.stream_key(seed, step, sub)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_death_probability_is_behaves(dtype):
    """The probability the kernel draws against is behave's own, and
    behave's DEATH decisions follow it: dies iff age >= 0 and u < p."""
    cfg = _cfg("behavior7")
    p_die = sl.death_probability(cfg, dtype)
    idt = torch.full((), 300.0, dtype=dtype)
    assert p_die == float(-torch.expm1(-idt / torch.full((), 3600.0,
                                                          dtype=dtype)))
    n = 4096
    pids = torch.arange(n, dtype=torch.int32)
    age = torch.linspace(-600.0, 3 * 86400.0, n, dtype=dtype)
    z = torch.zeros(n, dtype=dtype)
    beh = tbh.BehaveParams(mortality=True, stochastic=True, deadage=3600.0,
                           idt=300.0)
    dies = tbh.behave(None, None, 9, 40, pids, z, z, z, 0.0, age, z, z,
                      (z, z), beh)[3]
    u = rng.uniform(9, 40, rng.DEATH, pids, (), 0.0, 1.0, dtype)
    assert torch.equal(dies, (age >= 0) & (u < p_die))
    assert 0 < int(dies.sum()) < n


def _grid(kind):
    c = (synth.make_curv_case(nx=21, ny=19, us=6, lx=40e3, ly=36e3,
                              h0=40.0, omega=1e-4, amp=0.02)
         if kind == "curv" else
         synth.make_solid_body_case(nx=21, ny=21, us=6, lx=40e3, ly=40e3,
                                    stretch=1.02 if kind == "axes"
                                    else 1.0))
    g = c.grid
    if kind == "curv":
        mask = g.mask_rho.numpy()
        bounds = bd.build_boundaries_curv(mask, c.x2d, c.y2d, g.curv)
    else:
        bounds = bd.build_boundaries(g.mask_rho.numpy(), g.x_rho.numpy(),
                                     g.y_rho.numpy())
    return tstep.StepContext(grid=g, bounds=bounds)


K3_BUILDS = {
    "behavior": ("uniform", "float32", dict(Behavior=6)),
    "oyster-f64": ("uniform", "float64", LANES["oyster"]),
    "behavior7-axes": ("axes", "float32", LANES["behavior7"]),
    "curv": ("curv", "float32", dict(Behavior=3, VTurbOn=True,
                                     readAks=False)),
    "tile": ("uniform", "float64", dict(Behavior=1)),
}


@pytest.mark.parametrize("name", list(K3_BUILDS))
def test_kernel_targets_name_the_lanes_build(name):
    """For a per-step configuration run.kernel_targets names K2's build,
    K3's (the variant step_lanes_fused launches on that grid and dtype,
    sl.kernel_variant: a build of csrc/step_lanes.cu, its macros only,
    with LTX_TILE on a sharded run's tiles) and the sort key's."""
    kind, dtype, kw = K3_BUILDS[name]
    ctx = _grid(kind)
    cfg = Config(numpar=1, us=6, ws=7, dtype_pos=dtype,
                 **{**BEH, **kw, **STOCHASTIC})
    tile = name == "tile"
    targets = trun.kernel_targets(cfg, ctx.grid, tile=tile)
    names = [t[0] for t in targets]
    assert names == ["rk4_step", "step_lanes", "sort_key"]
    v = dict(targets[1][1])
    want = sl.kernel_variant(ctx, cfg, getattr(torch, dtype))
    if tile:
        want["LTX_TILE"] = 1
    assert v == want
    assert set(v) <= {"LTX_" + m for m in build._macros("step_lanes")}
    assert build.tag("step_lanes", v).startswith("step_lanes-")
    assert ("LTX_POS64" in v) == (dtype == "float64")
    assert ("LTX_CURV" in v) == (kind == "curv")
    assert ("LTX_AXES" in v) == (kind == "axes")
    ext = Config(numpar=1, us=6, ws=7, dtype_pos=dtype, **{**BEH, **kw})
    assert [t[0] for t in trun.kernel_targets(ext, ctx.grid)] == [
        "ext_step", "sort_key"]


def _lagrange(times, t):
    """polintd's weights at t, in float64 from the record times."""
    return [np.prod([(t - b) / (a - b) for b in times if b != a])
            for a in times]


@pytest.mark.parametrize("kind", ["float32", "float64", "tile"])
def test_aux_tables_are_the_collapsed_lanes(kind):
    """aux_tables: the Aks then salt lanes of the raw records collapsed to
    t and the salt then temp lanes collapsed to t + idt, as numpy's
    float64 Lagrange sums of the FieldSet's records (1e-6 of the largest
    value with float32 fields and positions, 1e-12 with float64); only
    the lanes a variant reads; on a tile's strip, the whole grid's tables
    at the strip's rows, bit for bit; and the plain version's salt
    profile from them (collapse, then blend) against the FieldSet's
    (blend, then collapse) at the particles, to the same tolerance."""
    from ltjax_torch import shard
    from ltjax_torch.physics.advect import scalar_profile
    dtype = torch.float64 if kind == "float64" else torch.float32
    c = synth.make_solid_body_case(nx=12, ny=10, us=4, lx=12e3, ly=10e3,
                                   parabolic_aks=True, halocline=True,
                                   dtype=dtype)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 3, dtype=dtype)
    cfg = Config(numpar=1, us=4, ws=5, dtype_pos=str(dtype)[6:],
                 **{**LANES["oyster"], **STOCHASTIC})
    g = c.grid
    prec = tpk.build_packed_records(g, fsR, with_aks=True, with_scalars=True)
    t, idt = 250.0, 120.0
    aux = sl.aux_tables(g, cfg, prec, t, idt)
    times = fsR.times.numpy()
    tol = 1e-12 if kind == "float64" else 1e-6

    def collapse(a, tt):
        a = a.double().numpy().reshape(3, g.ny * g.nx, -1)
        return np.tensordot(_lagrange(times, tt), a, axes=1)

    want0 = np.concatenate([collapse(fsR.aks, t), collapse(fsR.salt, t)], -1)
    want1 = np.concatenate([collapse(fsR.salt, t + idt),
                            collapse(fsR.temp, t + idt)], -1)
    for got, want in ((aux.t0, want0), (aux.t1, want1)):
        assert got.dtype == dtype and got.is_contiguous()
        np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())
    for kw, shapes in ((dict(Behavior=6), (None, None)),
                       (dict(VTurbOn=True, readAks=True), (5, None)),
                       (dict(Behavior=5, readSalt=True), (4, None)),
                       (dict(SaltTempOn=True, readSalt=True, readTemp=True),
                        (None, 8))):
        a = sl.aux_tables(g, Config(numpar=1, us=4, ws=5, **kw), prec, t,
                          idt)
        assert tuple(None if v is None else v.shape[-1] for v in a) == shapes
    if kind == "tile":
        spec = shard.make_spec(cfg, g.ny, 64, 1, 2, halo=2)
        tctx = shard.tile_context(tstep.StepContext(
            grid=g, bounds=bd.build_boundaries(
                g.mask_rho.numpy(), g.x_rho.numpy(), g.y_rho.numpy())),
            spec, shard.build_tiled_static(g, spec), 1)
        rows = torch.as_tensor(shard.strip_index(spec, 1, g.ny))
        strip = tpk.build_packed_records(
            tctx.grid, shard.strip_fieldset(fsR, spec, 1, g.ny),
            with_aks=True, with_scalars=True)
        got = sl.aux_tables(tctx.grid, cfg, strip, t, idt)
        for a, b in zip(got, aux):
            whole = b.reshape(g.ny, g.nx, -1)[rows].reshape(-1, b.shape[-1])
            assert torch.equal(a, whole)
        return
    r = np.random.default_rng(3)
    x = torch.tensor(r.uniform(0.0, 11e3, 64), dtype=dtype)
    y = torch.tensor(r.uniform(0.0, 9e3, 64), dtype=dtype)
    vt = tpk.stage_value_tables(g, prec, t, idt)
    zh = tpk.zeta_h_packed(g, vt[0], x, y)
    z_a, s_a = sl._aux_profile(g, aux.t0, 5, 4, False, x, y, *zh)
    z_f, s_f = scalar_profile(g, fsR, fsR.salt, x, y, t)
    for a, b in ((z_a, z_f), (s_a, s_f)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=tol * float(b.abs().max()))


def test_per_step_records_carry_the_lanes_k3_reads():
    """The per-step route's record tables carry the Aks lanes (Visser on
    Aks) and the salt/temp lanes (SaltTempOn, behaviors 4/5) that K3
    reads, as the whole-step route's do; the packed route's only the
    value lanes."""
    c = synth.make_solid_body_case(nx=9, ny=9, us=4, lx=8e3, ly=8e3,
                                   parabolic_aks=True, halocline=True)
    ctx = _grid("uniform")
    ctx = tstep.StepContext(grid=c.grid, bounds=ctx.bounds)
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 3)
    nv = tpk.n_value_lanes(4, 5)
    for kw, lanes in ((dict(VTurbOn=True, readAks=True), nv + 5),
                      (dict(SaltTempOn=True, readSalt=True, readTemp=True),
                       nv + 8),
                      (dict(Behavior=4, readSalt=True), nv + 8),
                      (dict(Behavior=6), nv)):
        cfg = Config(numpar=1, us=4, ws=5, **{**kw, **STOCHASTIC})
        for route, want in (("per_step", lanes), ("ext_step", lanes),
                            ("packed", nv)):
            prec = tstep.packed_window(ctx, cfg, route, fsR)
            assert prec.tab.shape[-1] == want, (kw, route)
