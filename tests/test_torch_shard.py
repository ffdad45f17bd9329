"""Sharded stepping of the port (``ltjax_torch.shard``, ``ltjax_torch.dist``)
against ltjax and against the port's own unsharded routes, on the CPU
with gloo ranks.

* ``summary_counts`` counts each status by equality, as ltjax does, so a
  batch with EMPTY slots (status -1) gives ltjax's counts (before the
  repair it counted them as not released).
* The host-side parts (``make_spec``, ``halo_rows_needed``, ``pad_eta``,
  ``build_tiled_static``, ``scatter_particles`` / ``gather_particles``)
  give ltjax's arrays exactly, and each tile's kernel operands the strip
  of ltjax's ``build_mega_tiled``: its boundary rows exactly, its first
  row r0 (ltjax's origins y0 + r0 * dy; the port's kernels locate on the
  whole grid's origins, P_Y0 / P_BY0 as on one device, and move r0 rows
  into the strip).
* ``migrate`` over 4 gloo ranks against ltjax's ``_migrate`` inside
  ``shard_map`` on the CPU mesh (after tests/test_shard.py's migration
  test), on the same slot blocks: the same particles per tile (sorted
  by pid, every column equal), the same ERROR flags with a tiny
  ``mig_cap``, the same drop counts, also when a tile receives more than
  it holds.
* A tiled run equals the unsharded run (after tests/test_shard.py's
  1-device == N-device test): meshes (1, 4), (2, 2) and (4, 1), three
  external steps in float64 on the ext_step route with horizontal
  turbulence (the plain K1 on the CPU), on the per-step route
  (stochastic mortality: the same particles die), on the native route
  and on stretched axes; a curvilinear grid on (2, 1) (ext_step,
  per-step and packed routes).  Equal pids,
  statuses and ``hit_land``; positions within 1e-9 m (the strips' origins
  differ from the grid's by round-off only).
* The tiled packed route (``kernel_interp = False``) equals the port's
  single rank bit for bit on (1, 4) and (2, 2), and matches ltjax's real
  sharded path off the TPU, ``make_tiled_step`` without ``mega`` on the
  CPU mesh (its ``internal_step(mode="packed")`` per tile), on the same
  float64 inputs (a land block, random zeta and w, horizontal
  turbulence): positions within 1e-8 m, statuses and ``hit_land``
  equal.  ltjax's tiles locate on each strip's own origin (y0 + r0 * dy),
  which rounds differently from the port's whole-grid axes (measured
  3.6e-12 m; the collapsed scheme on the same inputs misses by 0.14 m).
* The port's tiled ext_step route against ltjax's tiled megakernel
  (``make_tiled_step(..., mega=build_mega_tiled(...), interpret=True)``,
  ``kernel_precision = "highest"``; not ``pair2``, a known fault of
  ltjax), float32 with a land block: the tolerance of
  tests/test_torch_ext_step.py (0.5 m horizontal, 1e-3 m vertical),
  statuses equal.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ltjax import shard as jshard
from ltjax import state as jst
from ltjax import synth as jsynth
from ltjax.config import Config
from ltjax.fields import FieldSet as JFieldSet
from ltjax.grid import make_grid as j_make_grid
from ltjax.kernels import ext_step as jes
from ltjax.physics import boundary as jbd
from ltjax.step import StepContext as JContext
from ltjax.step import summary_counts as j_summary_counts
from ltjax_torch import interop, shard
from ltjax_torch import state as tst
from ltjax_torch import step as tstep
from ltjax_torch import synth
from ltjax_torch.kernels import ext_step as kx
from ltjax_torch.physics import boundary as bd

torch.set_num_threads(1)

TOL_F64 = 1e-9          # m, tiled vs unsharded, float64
TOL_H, TOL_V = 0.5, 1e-3   # m, float32 kernels (tests/test_torch_ext_step.py)


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def test_summary_counts_ignore_empty_slots():
    rng = np.random.default_rng(0)
    status = rng.integers(-1, 6, 400).astype(np.int32)
    assert (status == shard.EMPTY).sum() > 20
    z = np.zeros(400)
    pj = jst.init_particles(z, z, z)._replace(status=jnp.asarray(status))
    pt = tst.init_particles(z, z, z).replace(status=torch.as_tensor(status))
    assert tstep.summary_counts(pt) == j_summary_counts(pj)


def _jcase(ny=17, nx=13, dtype=jnp.float64, land=False):
    c = jsynth.make_solid_body_case(nx=nx, ny=ny, us=4, lx=12e3, ly=16e3,
                                    h0=40.0, omega=1e-4, dtype=dtype)
    grid = c.grid
    mask = np.ones((ny, nx), np.int32)
    if land:
        # east of the centre, in the rotation's path
        mask[ny // 2 - 2:ny // 2 + 2, nx - 6:nx - 4] = 0
        grid = grid._replace(mask_rho=jnp.asarray(mask))
    bounds = jbd.build_boundaries(mask, np.asarray(grid.x_rho),
                                  np.asarray(grid.y_rho))
    return c, grid, bounds


@pytest.mark.parametrize("ndp,ntiles", [(1, 4), (2, 2), (4, 1), (2, 3)])
def test_host_parts_match_ltjax(ndp, ntiles):
    c, grid, bounds = _jcase(land=True)
    cfg = Config(numpar=150, dt=1800, idt=450, us=4, ws=5,
                 dtype_pos="float32")
    jspec = jshard.make_spec(cfg, grid.ny, cfg.numpar, ndp, ntiles, halo=3,
                             slack=2.0)
    spec = shard.make_spec(cfg, grid.ny, cfg.numpar, ndp, ntiles, halo=3,
                           slack=2.0)
    assert tuple(spec) == tuple(jspec)
    assert spec.ny_ext == jspec.ny_ext and spec.ny_pad == jspec.ny_pad
    for v in (0.3, 1.7, 5.0):
        assert (shard.halo_rows_needed(v, 1800.0, 1000.0)
                == jshard.halo_rows_needed(v, 1800.0, 1000.0))
    a = np.random.default_rng(1).normal(size=(3, 13, 5))
    np.testing.assert_array_equal(shard.pad_eta(a, 1, 20),
                                  jshard.pad_eta(a, 1, 20))

    tg = interop.grid_from_numpy(_np(grid))
    tb = interop.boundaries_from_numpy(_np(bounds))
    jt = jshard.build_tiled_static(grid, jspec)
    tt = shard.build_tiled_static(tg, spec)
    for k in jt._fields:
        np.testing.assert_array_equal(getattr(tt, k),
                                      np.asarray(getattr(jt, k)), err_msg=k)

    rng = np.random.default_rng(2)
    n = cfg.numpar
    pj = jst.init_particles(rng.uniform(500, 11.5e3, n),
                            rng.uniform(0, 16e3, n),
                            rng.uniform(-30, -5, n))
    pj = pj._replace(status=jnp.asarray(rng.integers(0, 3, n), jnp.int32))
    pt = interop.particles_from_numpy(_np(pj))
    jb = jshard.scatter_particles(pj, jspec, jt.tile_edges)
    tb_ = shard.scatter_particles(pt, spec, tt.tile_edges)
    for k in tst.FIELDS:
        np.testing.assert_array_equal(getattr(tb_, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    jg = jshard.gather_particles(jb)
    tg_ = shard.gather_particles(tb_)
    for k in tst.FIELDS:
        np.testing.assert_array_equal(getattr(tg_, k).numpy(),
                                      np.asarray(getattr(jg, k)), err_msg=k)

    # each tile's kernel operands against build_mega_tiled's: the same
    # strip (ltjax's origins are its first row's, y0 + r0 * dy; the port
    # locates on the whole grid's origin and moves r0 rows into the strip)
    mega = jshard.build_mega_tiled(
        JContext(grid=grid, bounds=bounds, polys=None, holes=None), cfg,
        jspec)
    ctx = tstep.StepContext(grid=tg, bounds=tb)
    whole = kx.params_static(ctx, cfg)
    y, ye = np.asarray(grid.y_rho), np.asarray(bounds.y_edges)
    for t in range(ntiles):
        tctx = shard.tile_context(ctx, spec, tt, t)
        par = kx.params_static(tctx, cfg)
        pst = np.asarray(mega.pstat_t[t])
        r0 = par[kx.P_ROW0]
        assert r0 == t * spec.ny_loc - spec.halo and par[kx.P_NYG] == grid.ny
        assert pst[jes._IDX_Y0] == np.float32(y[0] + r0 * (y[1] - y[0]))
        assert pst[jes._IDX_BY0] == np.float32(ye[0] + r0 * (ye[1] - ye[0]))
        np.testing.assert_array_equal(par[:kx.P_ROW0], whole[:kx.P_ROW0])
        rows = kx.boundary_rows_table(tctx).numpy()
        L = rows.shape[1]
        np.testing.assert_array_equal(
            rows.reshape(spec.ny_ext, grid.nx, L),
            np.asarray(mega.brows_t[t])[..., :L])


def _migration_blocks(grid, spec, edges, seed, y_new):
    """Slot blocks of ltjax's scatter whose occupied slots then get new y
    (so that many leave their tile)."""
    rng = np.random.default_rng(seed)
    n = 96
    p = jst.init_particles(rng.uniform(500, 11.5e3, n),
                           rng.uniform(0, 16e3, n), rng.uniform(-30, -5, n))
    p = p._replace(status=jnp.asarray(rng.integers(0, 3, n), jnp.int32),
                   hit_land=jnp.asarray(rng.integers(0, 4, n), jnp.int32))
    pbuf = jshard.scatter_particles(p, spec, edges)
    occ = np.asarray(pbuf.status) != jshard.EMPTY
    y = np.asarray(pbuf.y).copy()
    y[occ] = y_new(rng, occ.sum())
    return pbuf._replace(y=jnp.asarray(y))


def _ltjax_migrate(pbuf, spec, edges, x_mid, y_mid):
    mesh = jshard.make_mesh(spec, jax.devices()[:spec.ndp * spec.ntiles])
    pspec = jax.tree.map(lambda _: P("dp", "tile"), jst.Particles(*(0,) * 12))

    def body(pb):
        q = jax.tree.map(lambda a: a.reshape(a.shape[2:]), pb)
        q, nd = jshard._migrate(q, spec, jnp.asarray(edges), x_mid, y_mid,
                                "tile")
        return (jax.tree.map(lambda a: a.reshape((1, 1) + a.shape), q),
                nd.reshape(1, 1))

    f = jax.shard_map(body, mesh=mesh, in_specs=(pspec,),
                      out_specs=(pspec, P("dp", "tile")), check_vma=False)
    return jax.jit(f)(pbuf)


def test_migration_matches_ltjax():
    _, grid, _ = _jcase()
    cfg = Config(numpar=96, us=4, ws=5)
    spec = jshard.make_spec(cfg, grid.ny, 96, 1, 4, halo=3, slack=3.0)
    edges = np.asarray(jshard.build_tiled_static(grid, spec).tile_edges)
    x_mid, y_mid = 6e3, 8e3
    uniform = _migration_blocks(grid, spec, edges, 3,
                                lambda r, k: r.uniform(0, 16e3, k))
    south = _migration_blocks(grid, spec, edges, 4,
                              lambda r, k: r.uniform(0, 3e3, k))
    cases = [(uniform, spec),                          # normal migration
             (uniform, spec._replace(mig_cap=2)),      # leavers stay, ERROR
             (south, spec._replace(mig_cap=spec.cap))]  # tile 0 overflows
    got = shard.run_migration(
        [([interop.particles_from_numpy(
            {k: np.asarray(getattr(pb, k))[0, t] for k in tst.FIELDS})
           for t in range(4)], shard.TileSpec(*sp_)) for pb, sp_ in cases],
        edges, x_mid, y_mid)
    n_err = []
    for (pb, sp_), ranks in zip(cases, got):
        jout, jdrop = _ltjax_migrate(pb, sp_, edges, x_mid, y_mid)
        for t, r in enumerate(ranks):
            want = {k: np.asarray(getattr(jout, k))[0, t] for k in tst.FIELDS}
            have = interop.particles_to_numpy(r["particles"])
            assert r["drops"] == int(np.asarray(jdrop)[0, t])
            kw, kh = want["status"] != -1, have["status"] != -1
            ow, oh = (np.argsort(want["pid"][kw]),
                      np.argsort(have["pid"][kh]))
            for k in tst.FIELDS:
                np.testing.assert_array_equal(have[k][kh][oh],
                                              want[k][kw][ow], err_msg=k)
            # every resident particle lies in its tile, unless it could
            # not leave (ERROR)
            y, s = have["y"][kh], have["status"][kh]
            inside = (y >= edges[t]) & (y < edges[t + 1])
            assert np.all(inside | (s == jst.ERROR))
        n_err.append(sum(int((interop.particles_to_numpy(r["particles"])
                              ["status"] == jst.ERROR).sum())
                         for r in ranks))
    assert sum(r["sent"] for r in got[0]) > 10
    assert n_err[1] > n_err[0]                        # the tiny mig_cap
    assert sum(r["drops"] for r in got[2]) > 0        # tile 0 overflowed


def _case(kind, n=200, seed=5):
    """(ctx, fsR, p0) of the tiled-vs-unsharded cases, float64: a 17 x 17
    solid body (omega 2e-4, 1 km cells) with a land block, on uniform or
    stretched axes, or a 17 x 15 curvilinear one."""
    mask = np.ones((17, 17), np.int32)
    mask[9:11, 11:13] = 0
    if kind == "curv":
        c = synth.make_curv_case(nx=17, ny=15, us=4, lx=16e3, ly=14e3,
                                 h0=40.0, omega=2e-4, amp=0.02)
        g = c.grid
        bounds = bd.build_boundaries_curv(g.mask_rho.numpy(), c.x2d, c.y2d,
                                          g.curv)
    else:
        c = synth.make_solid_body_case(
            nx=17, ny=17, us=4, lx=16e3, ly=16e3, h0=40.0, omega=2e-4,
            mask=mask, stretch=1.03 if kind == "stretched" else 1.0)
        g = c.grid
        bounds = bd.build_boundaries(g.mask_rho.numpy(), g.x_rho.numpy(),
                                     g.y_rho.numpy())
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 5, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    x = g.x_rho.numpy()
    y = g.y_rho.numpy()
    p0 = tst.init_particles(rng.uniform(x[2], x[-3], n),
                            rng.uniform(y[2], y[-3], n),
                            rng.uniform(-35.0, -3.0, n),
                            dob=rng.uniform(0.0, 2000.0, n))
    return tstep.StepContext(grid=g, bounds=bounds), fsR, p0


def _cfg(**kw):
    base = dict(numpar=200, dt=1800, idt=450, us=4, ws=5,
                OpenOceanBoundary=True, TrackCollisions=True,
                dtype_pos="float64", dtype_field="float64", seed=3)
    base.update(kw)
    return Config(**base)


ROUTES = {
    "ext_step-hturb": ("uniform", dict(HTurbOn=True, ConstantHTurb=1.0)),
    "per_step": ("uniform", dict(Behavior=6, sink=1e-3, mortality=True,
                                 stochastic_mortality=True,
                                 deadage=1800.0)),
    "native": ("uniform", dict(fast_interp=False)),
    "stretched": ("stretched", dict(HTurbOn=True, ConstantHTurb=1.0)),
    "packed": ("uniform", dict(kernel_interp=False, HTurbOn=True,
                               ConstantHTurb=1.0)),
}


def _check_equal(got, ref, name):
    ref = interop.particles_to_numpy(ref)
    order = np.argsort(ref["pid"], kind="stable")
    got = interop.particles_to_numpy(got)
    for k in ("pid", "status", "hit_land", "settle_poly"):
        np.testing.assert_array_equal(got[k], ref[k][order],
                                      err_msg=f"{name}: {k}")
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(got[k], ref[k][order], rtol=0,
                                   atol=TOL_F64, err_msg=f"{name}: {k}")


def _halo(ctx):
    # 2e-4 rad/s at the far corner (11.3 km), 1800 s, 1 km rows (stretched:
    # the smallest row)
    dy = float(np.diff(ctx.grid.y_rho.numpy()).min())
    return shard.halo_rows_needed(2e-4 * 11.4e3, 1800.0, dy)


def _megakernel_case():
    """ltjax's tiled megakernel (interpret mode, f32-exact blends) on a
    (1, 4) mesh, one external step of float32 particles with a land
    block: (its particles in pid order, the port's TiledCase of the same
    inputs)."""
    cfg = Config(numpar=96, dt=1800, idt=450, us=4, ws=5, HTurbOn=True,
                 ConstantHTurb=2.0, OpenOceanBoundary=True,
                 TrackCollisions=True, dtype_pos="float32",
                 dtype_field="float32", kernel_block=128, reflect_iters=2,
                 kernel_precision="highest")
    # ltjax's window (16 rows) must fit in a tile's strip: 41 rows
    c, grid, bounds = _jcase(ny=41, nx=17, dtype=jnp.float32, land=True)
    fs = jsynth.fieldset_for(c, t_center=900.0, dt=1800.0,
                             dtype=jnp.float32)
    rng = np.random.default_rng(3)
    n = cfg.numpar
    p0 = jst.init_particles(rng.uniform(2e3, 10e3, n),
                            rng.uniform(2e3, 14e3, n),
                            rng.uniform(-35.0, -5.0, n), dtype=jnp.float32)
    p0 = p0._replace(status=jnp.full(n, jst.ACTIVE, jnp.int32))
    jctx = JContext(grid=grid, bounds=bounds, polys=None, holes=None)
    # 1e-4 rad/s at 8.5 km from the centre, 1800 s, 400 m rows
    spec = jshard.make_spec(cfg, grid.ny, n, 1, 4,
                            halo=jshard.halo_rows_needed(0.85, 1800.0, 400.0),
                            slack=3.0)
    mesh = jshard.make_mesh(spec, jax.devices()[:4])
    tiled = jshard.build_tiled_static(grid, spec)
    step = jshard.make_tiled_step(
        jctx, cfg, spec, tiled, mesh, jr.key(cfg.seed),
        mega=jshard.build_mega_tiled(jctx, cfg, spec), interpret=True)
    pbuf, drops = step(jshard.scatter_particles(p0, spec, tiled.tile_edges),
                       jshard.pad_fieldset_eta(fs, spec.ny_pad), 0.0, 0)
    assert int(jnp.sum(drops)) == 0
    ctx = tstep.StepContext(grid=interop.grid_from_numpy(_np(grid)),
                            bounds=interop.boundaries_from_numpy(
                                _np(bounds)))
    return _np(jshard.gather_particles(pbuf)), shard.TiledCase(
        ctx, cfg, interop.particles_from_numpy(_np(p0)),
        interop.fieldset_from_numpy(_np(fs)), 1, shard.TileSpec(*spec))


@pytest.fixture(scope="module")
def tiled_runs():
    """Per mesh, one spawn of its ranks for every route of ROUTES (and on
    (1, 4) the megakernel comparison's case): {mesh: (refs, results)}."""
    cache = {}

    def get(ndp, ntiles):
        if (ndp, ntiles) not in cache:
            cases, refs = [], []
            for name, (kind, kw) in ROUTES.items():
                ctx, fsR, p0 = _case(kind)
                cfg = _cfg(**kw)
                spec = shard.make_spec(cfg, ctx.grid.ny, p0.n, ndp, ntiles,
                                       halo=_halo(ctx), slack=3.0)
                cases.append(shard.TiledCase(ctx, cfg, p0, fsR, 3, spec,
                                             n_fuse=2))
                refs.append(tstep.make_fused_external_steps(ctx, cfg, 3)(
                    p0, fsR, 0.0, 0))
            if (ndp, ntiles) == (1, 4):
                want, case = _megakernel_case()
                cases.append(case)
                refs.append(want)
            cache[ndp, ntiles] = (refs, shard.run_tiled_steps(cases))
        return cache[ndp, ntiles]

    return get


@pytest.mark.parametrize("ndp,ntiles", [(1, 4), (2, 2), (4, 1)])
def test_tiled_matches_unsharded(tiled_runs, ndp, ntiles):
    refs, out = tiled_runs(ndp, ntiles)
    for name, (got, ranks), ref in zip(ROUTES, out, refs):
        assert sum(r["drops"] for r in ranks) == 0, name
        if ntiles > 1:
            assert sum(r["sent"] for r in ranks) > 0, name
        _check_equal(got, ref, name)
        s = got.status.numpy()
        assert (s == tst.ACTIVE).sum() > 10, name
        if name == "per_step":
            assert (s == tst.DEAD).sum() > 50
        if name == "ext_step-hturb":
            assert got.hit_land.sum() > 0          # the land block was hit


def test_curvilinear_shards_over_particles():
    ctx, fsR, p0 = _case("curv")
    cases, refs = [], []
    for kw in (dict(HTurbOn=True, ConstantHTurb=1.0),
               dict(mortality=True, stochastic_mortality=True,
                    deadage=1800.0),
               dict(kernel_interp=False, HTurbOn=True, ConstantHTurb=1.0)):
        cfg = _cfg(**kw)
        spec = shard.make_spec(cfg, ctx.grid.ny, p0.n, 2, 1, halo=0,
                               slack=3.0)
        cases.append(shard.TiledCase(ctx, cfg, p0, fsR, 3, spec))
        refs.append(tstep.make_fused_external_steps(ctx, cfg, 3)(
            p0, fsR, 0.0, 0))
    for (got, ranks), ref in zip(shard.run_tiled_steps(cases), refs):
        assert [r["sent"] for r in ranks] == [0, 0]
        _check_equal(got, ref, "curv")
    with pytest.raises(NotImplementedError, match="PARTICLE axis only"):
        tstep.check_supported(_cfg(mesh_tiles=2), ctx)


def test_tiled_route_matches_ltjax_tiled_megakernel(tiled_runs):
    """One external step of ltjax's tiled megakernel against the port's
    tiled ext_step route on the same inputs (``_megakernel_case``)."""
    refs, out = tiled_runs(1, 4)
    want = refs[-1]
    got, ranks = out[-1]
    got = interop.particles_to_numpy(got)
    assert sum(r["sent"] for r in ranks) > 0
    np.testing.assert_array_equal(got["pid"], want["pid"])
    np.testing.assert_array_equal(got["status"], want["status"])
    np.testing.assert_array_equal(got["hit_land"], want["hit_land"])
    assert got["hit_land"].sum() > 0
    for k, tol in (("x", TOL_H), ("y", TOL_H), ("z", TOL_V)):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_tile_strip_rows_and_fields():
    """A rank's strip read (rows [a, b) of the files, edge-replicated to
    the strip) equals the strip of the whole field, for every tile of a
    grid whose last tile runs past the rim."""
    case = synth.make_solid_body_case(nx=9, ny=11, us=4, lx=8e3, ly=10e3)
    fs = synth.fieldset_for(case, 900.0, 1800.0, dtype=torch.float64)
    cfg = _cfg()
    spec = shard.make_spec(cfg, 11, 100, 1, 4, halo=2)
    assert spec.ny_pad == 12
    for t in range(4):
        a, b = shard.strip_rows(spec, t, 11)
        whole = shard.strip_fieldset(fs, spec, t, 11)
        rec = {"time": 0.0, "zeta": fs.zeta[1].numpy(),
               "u": fs.u[1].movedim(-1, 0).numpy()[..., a:b, :],
               "v": fs.v[1].movedim(-1, 0).numpy()[..., a:min(b, 10), :]}
        rec["zeta"] = rec["zeta"][a:b]
        strip = shard.strip_record(rec, spec, t, 11, a)
        np.testing.assert_array_equal(strip["zeta"], whole.zeta[1].numpy())
        np.testing.assert_array_equal(strip["u"],
                                      whole.u[1].movedim(-1, 0).numpy())
        np.testing.assert_array_equal(strip["v"],
                                      whole.v[1].movedim(-1, 0).numpy())
        assert whole.v.shape[1] == spec.ny_ext


@pytest.mark.parametrize("ndp,ntiles", [(1, 4), (2, 2)])
def test_tiled_packed_route_bit_equal_to_single_rank(tiled_runs, ndp,
                                                     ntiles):
    refs, out = tiled_runs(ndp, ntiles)
    k = list(ROUTES).index("packed")
    got = interop.particles_to_numpy(out[k][0])
    ref = interop.particles_to_numpy(refs[k])
    order = np.argsort(ref["pid"], kind="stable")
    assert sum(r["sent"] for r in out[k][1]) > 0
    for c in tst.FIELDS:
        np.testing.assert_array_equal(got[c], ref[c][order], err_msg=c)


def test_tiled_packed_route_matches_ltjax_tiled_step():
    """Three external steps of ltjax's tiled step off the megakernel
    (``make_tiled_step`` without ``mega``, one call per external step on
    records [e, e+1, e+2]) against the port's tiled packed route on
    (1, 4)."""
    mask = np.ones((33, 17), np.int32)
    mask[15:18, 11:13] = 0
    c = synth.make_solid_body_case(nx=17, ny=33, us=4, lx=16e3, ly=32e3,
                                   h0=40.0, omega=1e-4, mask=mask)
    g = c.grid
    ctx = tstep.StepContext(grid=g, bounds=bd.build_boundaries(
        mask, g.x_rho.numpy(), g.y_rho.numpy()))
    fsR = synth.with_vertical_motion(synth.fieldset_window(
        c, -900.0, 1800.0, 5, dtype=torch.float64), seed=4, w_amp=2e-3)
    rng = np.random.default_rng(6)
    n = 200
    p0 = tst.init_particles(rng.uniform(2e3, 14e3, n),
                            rng.uniform(2e3, 30e3, n),
                            rng.uniform(-35.0, -3.0, n),
                            dob=rng.uniform(0.0, 2000.0, n))
    cfg = _cfg(kernel_interp=False, HTurbOn=True, ConstantHTurb=1.0)
    jgrid = j_make_grid(g.x_rho.numpy(), g.y_rho.numpy(), g.h.numpy(), mask,
                        g.s_rho.numpy(), g.Cs_r.numpy(), g.s_w.numpy(),
                        g.Cs_w.numpy(), g.hc, g.vtransform,
                        dtype=jnp.float64)
    jctx = JContext(grid=jgrid, bounds=jbd.build_boundaries(
        mask, g.x_rho.numpy(), g.y_rho.numpy()), polys=None, holes=None)
    # 1e-4 rad/s at 16 km from the centre, 1800 s, 1 km rows
    spec = jshard.make_spec(cfg, g.ny, n, 1, 4,
                            halo=shard.halo_rows_needed(1.6, 1800.0, 1e3),
                            slack=3.0)
    tiled = jshard.build_tiled_static(jgrid, spec)
    step = jshard.make_tiled_step(jctx, cfg, spec, tiled,
                                  jshard.make_mesh(spec, jax.devices()[:4]),
                                  jr.key(cfg.seed))
    pj = jst.Particles(**{k: jnp.asarray(v) for k, v in
                          interop.particles_to_numpy(p0).items()})
    pbuf = jshard.scatter_particles(pj, spec, tiled.tile_edges)
    for e in range(3):
        f3 = JFieldSet(**{k: jnp.asarray(getattr(fsR, k)[e:e + 3].numpy())
                          for k in JFieldSet._fields})
        pbuf, drops = step(pbuf, jshard.pad_fieldset_eta(f3, spec.ny_pad),
                           float(e * cfg.dt), e)
        assert int(jnp.sum(drops)) == 0
    want = _np(jshard.gather_particles(pbuf))
    (got, ranks), = shard.run_tiled_steps([shard.TiledCase(
        ctx, cfg, p0, fsR, 3, shard.TileSpec(*spec))])
    got = interop.particles_to_numpy(got)
    assert sum(r["sent"] for r in ranks) > 0
    for k in ("pid", "status", "hit_land", "settle_poly"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["status"] == tst.ACTIVE).sum() > 10
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-8,
                                   err_msg=k)
