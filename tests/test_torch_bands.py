"""The depth-banded Hilbert sort (``cfg.sort_depth_bands``,
``sort_band_height``, ``sort_band_log``) in the port.

* ``step._sort_cells`` and ``step._sort_band`` against ltjax's on the same
  float32 inputs (a uniform, a stretched and a curvilinear grid, each
  with a bathymetry that varies over the grid; equal slabs and log2
  bands): the same cells, the same band integers, and ``step._sort``'s
  permutation equal to ltjax's ``sort_by_cell`` with its bands.  XLA and
  PyTorch may round ``log2`` and the division differently at a band's
  boundary, so the inputs keep only particles whose height above the
  bed over ``sort_band_height`` lies more than 1e-5 (relative) from a
  boundary, and on the curvilinear grid more than 1e-3 cells from a cell
  edge (the inverse maps' Newton iterates may differ by ulps).
* Sort order changes no particle's result: each lane is per particle and
  the random streams key on particle id, so a banded run through
  ``make_fused_external_steps`` equals the unbanded run bit for bit
  (every column) on the ext_step route (slab and log bands), the
  per-step route with stochastic mortality (the same DEAD pids), the
  native route, a curvilinear grid and in float64, while the banded sort
  does reorder the batch.
* On a tile of a sharded run the band is taken on the strip's rows of
  the strip's ``h`` and equals the whole grid's band for every particle
  of the strip, on a grid whose depth varies with eta (indexing the whole
  grid's ``h`` by strip rows gives other bands); a (2, 2) gloo mesh with
  bands equals the single unbanded rank bit for bit.
* ``check_supported`` refuses more than 6 bands with ltjax's message.
* The CLI with ``sort_depth_bands = 3``: on the ext_step, per-step and
  native routes and on a (1, 2) mesh the same CSV as without bands, bit
  for bit; on the ext_step route ltjax.run.run's particles at the CLI
  tests' tolerance (0.5 m horizontal, statuses equal; ltjax sorts only
  on a TPU, so its CPU run ignores the bands).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltjax import run as jrun
from ltjax import spatial as jsp
from ltjax import state as jst
from ltjax import step as jstep
from ltjax import synth as jsynth
from ltjax.config import Config as JConfig
from ltjax.config import config_from_namelist
from ltjax.grid import make_grid as j_make_grid
from ltjax_torch import interop, shard, synth
from ltjax_torch import state as tst
from ltjax_torch import step as tstep
from ltjax_torch.config import Config
from ltjax_torch.physics import boundary as bd

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = {"slab": dict(sort_depth_bands=3, sort_band_height=8.0),
         "log": dict(sort_depth_bands=4, sort_band_height=4.0,
                     sort_band_log=True)}


def _np(nt):
    """numpy fields of an ltjax NamedTuple; a CurvMap as a dict."""
    d = {k: np.asarray(v) for k, v in nt._asdict().items() if k != "curv"}
    if "curv" in nt._fields:
        d["curv"] = None if nt.curv is None else _np(nt.curv)
    return d


def _bathymetry(ny, nx):
    """Depths 15-50 m that vary along both axes."""
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    return 15.0 + 30.0 * j / (ny - 1) + 5.0 * np.sin(i / 3.0)


def _jgrid(kind):
    """An ltjax float32 grid of ``kind`` with _bathymetry's depths."""
    if kind == "curv":
        c = jsynth.make_curv_case(nx=21, ny=19, us=4, lx=20e3, ly=18e3,
                                  h0=40.0, amp=0.03, dtype=jnp.float32)
        return c.grid._replace(h=jnp.asarray(_bathymetry(19, 21),
                                             jnp.float32))
    ratio = 1.05 if kind == "stretched" else 1.0
    x = synth.stretched_axis(21, 20e3, ratio)
    y = synth.stretched_axis(19, 18e3, ratio)
    s_rho, s_w = synth.uniform_sigma_levels(4)
    return j_make_grid(x, y, _bathymetry(19, 21), np.ones((19, 21), np.int32),
                       s_rho, s_rho, s_w, s_w, 40.0, dtype=jnp.float32)


def _away_from_edges(grid, p, cfg):
    """Particles whose band and (curvilinear) cell no rounding can flip."""
    ci, cj = jstep._sort_cells(grid, p)
    hab = (np.asarray(p.z, np.float64)
           + np.asarray(grid.h, np.float64)[np.asarray(cj), np.asarray(ci)])
    if cfg.sort_band_log:
        q = np.maximum(hab, 1e-3) / cfg.sort_band_height
        b = 2.0 ** np.round(np.log2(q))            # the nearest boundary
        keep = np.abs(q - b) > 1e-5 * b
    else:
        q = hab / cfg.sort_band_height
        keep = np.abs(q - np.round(q)) > 1e-5 * np.maximum(np.abs(q), 1.0)
    if grid.curv is not None:
        from ltjax.grid import logical_coords
        for t in logical_coords(grid, p.x, p.y):
            t = np.asarray(t, np.float64)
            keep &= np.abs(t - np.round(t)) > 1e-3
    return keep


@pytest.mark.parametrize("bands", list(BANDS))
@pytest.mark.parametrize("kind", ["uniform", "stretched", "curv"])
def test_sort_band_matches_ltjax(kind, bands):
    jg = _jgrid(kind)
    cfg = Config(**BANDS[bands])
    jcfg = JConfig(**BANDS[bands])
    rng = np.random.default_rng(len(kind) + len(bands))
    n = 3000
    if jg.curv is None:
        x = rng.uniform(float(jg.x_rho[0]), float(jg.x_rho[-1]), n)
        y = rng.uniform(float(jg.y_rho[0]), float(jg.y_rho[-1]), n)
    else:
        xy = np.asarray(jg.curv.xy_flat, np.float64)
        x = rng.uniform(xy[:, 0].min() + 1e3, xy[:, 0].max() - 1e3, n)
        y = rng.uniform(xy[:, 1].min() + 1e3, xy[:, 1].max() - 1e3, n)
    # from the bed (and a little below it: clipped, log-clamped) to the top
    z = -rng.uniform(0.0, 1.05, n) * 52.0
    p = jst.init_particles(x, y, z, dtype=jnp.float32)
    status = rng.choice([jst.ACTIVE] * 6 + [jst.NOT_RELEASED, jst.SETTLED,
                                            jst.DEAD], n)
    p = p._replace(status=jnp.asarray(status, jnp.int32))
    keep = _away_from_edges(jg, p, jcfg)
    assert keep.mean() > 0.9
    p = jst.Particles(**{k: v[keep] for k, v in p._asdict().items()})

    ci_j, cj_j = jstep._sort_cells(jg, p)
    band_j = jstep._sort_band(jcfg, jg, p, ci_j, cj_j)
    _, perm_j = jsp.sort_by_cell(p, ci_j, cj_j, depth_band=band_j,
                                 n_bands=jcfg.sort_depth_bands)

    g = interop.grid_from_numpy(_np(jg))
    pt = interop.particles_from_numpy(_np(p))
    ci, cj = tstep._sort_cells(g, pt)
    np.testing.assert_array_equal(ci.numpy(), np.asarray(ci_j))
    np.testing.assert_array_equal(cj.numpy(), np.asarray(cj_j))
    band = tstep._sort_band(cfg, g, pt, ci, cj)
    np.testing.assert_array_equal(band.numpy(), np.asarray(band_j))
    # every band is populated, and some bands clip
    b = band.numpy()
    assert set(range(cfg.sort_depth_bands)) <= set(np.clip(
        b, 0, cfg.sort_depth_bands - 1))
    assert ((b < 0) | (b >= cfg.sort_depth_bands)).any()
    _, perm = tstep._sort(g, pt, cfg)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    assert tstep._sort_band(Config(), g, pt, ci, cj) is None


def test_check_supported_refuses_more_than_six_bands():
    c = synth.make_solid_body_case(nx=9, ny=9, us=4, dtype=torch.float32)
    g = c.grid
    ctx = tstep.StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.numpy(), g.x_rho.numpy(), g.y_rho.numpy()))
    for nb in (1, 2, 6):
        tstep.check_supported(Config(us=4, ws=5, sort_depth_bands=nb), ctx)
    with pytest.raises(ValueError, match=r"n_bands must be in \[1, 6\]"):
        tstep.make_fused_external_steps(
            ctx, Config(us=4, ws=5, sort_depth_bands=7), 1)


# --- banded runs equal unbanded runs, bit for bit ----------------------

TURB = dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True, readAks=True)
RUNS = {
    "ext_step": ("rect", torch.float32, dict(TURB, **BANDS["slab"])),
    "ext_step-log": ("rect", torch.float32, dict(TURB, **BANDS["log"])),
    "per_step": ("rect", torch.float32,
                 dict(Behavior=6, sink=1e-3, mortality=True,
                      stochastic_mortality=True, deadage=5400.0,
                      **BANDS["slab"])),
    "native": ("rect", torch.float64, dict(fast_interp=False, HTurbOn=True,
                                           **BANDS["slab"])),
    "curv": ("curv", torch.float32, dict(HTurbOn=True, ConstantHTurb=1.0,
                                         **BANDS["slab"])),
    "float64": ("rect", torch.float64, dict(TURB, **BANDS["log"])),
}


def _run_case(kind, dtype, n=300, seed=4):
    """(ctx, fsR, p0): a 21 x 21 solid body with a vertical shear (the
    rotation rate 1 + 0.02 z) and bench.py's Aks profile, or a
    curvilinear one; particles over the grid at every height."""
    if kind == "curv":
        c = synth.make_curv_case(nx=21, ny=21, us=6, lx=20e3, ly=20e3,
                                 h0=40.0, omega=2e-4, amp=0.02, dtype=dtype)
        g = c.grid
        bounds = bd.build_boundaries_curv(g.mask_rho.numpy(), c.x2d, c.y2d,
                                          g.curv)
    else:
        c = synth.make_solid_body_case(nx=21, ny=21, us=6, lx=20e3, ly=20e3,
                                       h0=40.0, omega=2e-4, shear_a=0.02,
                                       parabolic_aks=True, dtype=dtype)
        g = c.grid
        bounds = bd.build_boundaries(g.mask_rho.numpy(), g.x_rho.numpy(),
                                     g.y_rho.numpy())
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 5, dtype=dtype)
    rng = np.random.default_rng(seed)
    p0 = tst.init_particles(rng.uniform(3e3, 17e3, n),
                            rng.uniform(3e3, 17e3, n),
                            rng.uniform(-39.5, -0.5, n),
                            dob=rng.choice([0.0, 900.0], n), dtype=dtype)
    return tstep.StepContext(grid=g, bounds=bounds), fsR, p0


@pytest.mark.parametrize("name", list(RUNS))
def test_banded_run_equals_unbanded_bit_for_bit(name):
    kind, dtype, kw = RUNS[name]
    ctx, fsR, p0 = _run_case(kind, dtype)
    banded = Config(numpar=p0.n, dt=1800, idt=450, us=6, ws=7,
                    OpenOceanBoundary=True, TrackCollisions=True,
                    dtype_pos=str(dtype).replace("torch.", ""),
                    ext_sort_every=1, seed=5, **kw)
    plain = dataclasses.replace(banded, sort_depth_bands=1)
    route = {"per_step": "per_step", "native": "native"}.get(name,
                                                              "ext_step")
    assert tstep.mode_flags(ctx, banded) == route
    # the bands reorder the batch
    assert not torch.equal(tstep._sort(ctx.grid, p0, banded)[1],
                           tstep._sort(ctx.grid, p0, plain)[1])
    got = tstep.make_fused_external_steps(ctx, banded, 3)(p0, fsR, 0.0, 2)
    want = tstep.make_fused_external_steps(ctx, plain, 3)(p0, fsR, 0.0, 2)
    for k in tst.FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    s = got.status
    assert (s == tst.ACTIVE).sum() > 10
    if name == "per_step":
        assert (s == tst.DEAD).sum() > 20


# --- tiles --------------------------------------------------------------

def _eta_case(n=400, seed=6):
    """A 17 x 17 float64 solid body (shear 1 + 0.02 z) whose depth grows
    from 20 m to 44 m with eta, and horizontal turbulence."""
    c = synth.make_solid_body_case(nx=17, ny=17, us=4, lx=16e3, ly=16e3,
                                   h0=40.0, omega=2e-4, shear_a=0.02)
    h = np.broadcast_to(np.linspace(20.0, 44.0, 17)[:, None], (17, 17))
    c = dataclasses.replace(c, grid=dataclasses.replace(
        c.grid, h=torch.tensor(np.ascontiguousarray(h))))
    g = c.grid
    ctx = tstep.StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.numpy(), g.x_rho.numpy(), g.y_rho.numpy()))
    fsR = synth.fieldset_window(c, -900.0, 1800.0, 5, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    y = rng.uniform(2e3, 14e3, n)
    hy = np.interp(y, g.y_rho.numpy(), h[:, 0])
    p0 = tst.init_particles(rng.uniform(2e3, 14e3, n), y,
                            -rng.uniform(0.02, 0.98, n) * hy)
    cfg = Config(numpar=n, dt=1800, idt=450, us=4, ws=5,
                 OpenOceanBoundary=True, TrackCollisions=True,
                 dtype_pos="float64", dtype_field="float64", seed=3,
                 HTurbOn=True, ConstantHTurb=1.0, sort_depth_bands=3,
                 sort_band_height=6.0)
    return ctx, fsR, p0, cfg


def test_tile_bands_use_the_strip_rows_and_depths():
    ctx, _, p0, cfg = _eta_case()
    g = ctx.grid
    spec = shard.make_spec(cfg, g.ny, p0.n, 1, 3, halo=2, slack=3.0)
    tiled = shard.build_tiled_static(g, spec)
    ci, cj = tstep._sort_cells(g, p0)
    whole = tstep._sort_band(cfg, g, p0, ci, cj)
    edges = np.asarray(tiled.tile_edges)
    y = p0.y.numpy()
    for t in range(spec.ntiles):
        mine = torch.from_numpy((y >= edges[t]) & (y < edges[t + 1]))
        assert mine.sum() > 50
        q = p0.take(torch.nonzero(mine)[:, 0])
        tg = shard.tile_context(ctx, spec, tiled, t).grid
        ti, tj = tstep._sort_cells(tg, q)
        np.testing.assert_array_equal(ti.numpy(), ci[mine].numpy())
        np.testing.assert_array_equal(tj.numpy(),
                                      cj[mine].numpy() - tg.tile.row0)
        band = tstep._sort_band(cfg, tg, q, ti, tj)
        np.testing.assert_array_equal(band.numpy(), whole[mine].numpy())
        # the whole grid's depths at strip rows give other bands
        assert not torch.equal(tstep._sort_band(cfg, g, q, ti, tj), band)


def test_tiled_banded_run_equals_single_unbanded_rank():
    ctx, fsR, p0, cfg = _eta_case()
    plain = dataclasses.replace(cfg, sort_depth_bands=1)
    want = tstep.make_fused_external_steps(ctx, plain, 3)(p0, fsR, 0.0, 0)
    dy = float(np.diff(ctx.grid.y_rho.numpy()).min())
    spec = shard.make_spec(cfg, ctx.grid.ny, p0.n, 2, 2, slack=3.0,
                           halo=shard.halo_rows_needed(2e-4 * 8.5e3, 1800.0,
                                                       dy))
    (got, ranks), = shard.run_tiled_steps(
        [shard.TiledCase(ctx, cfg, p0, fsR, 3, spec, n_fuse=3)])
    assert sum(r["drops"] for r in ranks) == 0
    assert sum(r["sent"] for r in ranks) > 0
    order = torch.argsort(want.pid)
    for k in tst.FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)[order]), k


# --- the CLI ---------------------------------------------------------------

NO_JAX = ("import runpy, sys; sys.modules['jax'] = None; "
          "sys.argv = ['ltjax_torch.run'] + sys.argv[1:]; "
          "runpy.run_module('ltjax_torch.run', run_name='__main__')")
CLI = {"ext_step": {}, "per_step": dict(Behavior=6, sink=1e-3,
                                        mortality=True,
                                        stochastic_mortality=True,
                                        deadage=3600.0),
       "native": dict(fast_interp=False),
       "mesh-1x2": dict(mesh_particles=1, mesh_tiles=2, migrate_capacity=3.0,
                        # 1e-4 rad/s at 10 km from the centre, 1 km rows
                        halo_rows=shard.halo_rows_needed(1.0, 1800.0,
                                                         1e3))}


def _cli(nml, ranks=False):
    """The CLI on ``nml`` on the CPU, with jax blocked; a sharded run
    (``ranks``) runs as ``-m ltjax_torch.run``, since its spawned ranks
    import their entry point from the parent's main module by name."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = ["-m", "ltjax_torch.run"] if ranks else ["-c", NO_JAX]
    r = subprocess.run([sys.executable, *cmd, nml, "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]


def _final(rows):
    last = rows[rows[:, 0] == rows[:, 0].max()]
    return last[np.argsort(last[:, 1])]


@pytest.fixture(scope="module")
def cli_case():
    case = synth.make_solid_body_case(nx=31, ny=31, us=6, lx=30e3, ly=30e3,
                                      h0=40.0, omega=1e-4, shear_a=0.02,
                                      dtype=torch.float64)
    rng = np.random.default_rng(17)
    n = 200
    return case, (rng.uniform(8e3, 22e3, n), rng.uniform(8e3, 22e3, n),
                  rng.uniform(-39.0, -1.0, n))


@pytest.mark.parametrize("route", list(CLI))
def test_cli_with_depth_bands(cli_case, route, tmp_path):
    case, (x0, y0, z0) = cli_case
    out = {}
    for bands in (3, 1):
        d = str(tmp_path / f"bands{bands}")
        nml = synth.write_run_files(
            case, d, x0, y0, z0, n_ext=3, dt=1800, idt=450, iprint=1800,
            ext_fuse=2, ext_sort_every=1, sort_depth_bands=bands,
            sort_band_height=12.0, seed=4, **CLI[route])
        lines = _cli(nml, ranks=route.startswith("mesh"))
        rows = np.loadtxt(os.path.join(d, "out", "run1.csv"), delimiter=",")
        out[bands] = (nml, d, lines, rows)
    lines = out[3][2]
    want = {"mesh-1x2": "ext_step"}.get(route, route)
    assert lines[0]["route"] == want
    np.testing.assert_array_equal(out[3][3], out[1][3])
    final = _final(out[3][3])
    assert (final[:, 5] == jst.ACTIVE).sum() > 0
    if route == "per_step":
        assert (final[:, 5] == jst.DEAD).sum() > 0
    if route == "ext_step":
        nml, d = out[3][:2]
        cfg = config_from_namelist(nml, outpath=os.path.join(d, "jax_out"))
        assert cfg.sort_depth_bands == 3
        pj = jrun.run(cfg)
        np.testing.assert_allclose(final[:, 2], np.asarray(pj.x), rtol=0,
                                   atol=0.5)
        np.testing.assert_allclose(final[:, 3], np.asarray(pj.y), rtol=0,
                                   atol=0.5)
        np.testing.assert_array_equal(final[:, 5], np.asarray(pj.status))
