"""Curvilinear grids in the port against ltjax, on the CPU.

The fixtures of tests/test_curv.py: ltjax's gently curvilinear
solid-body case (41x41, us 8, a 2% sinusoidal distortion), here with a
4 x 4-cell land block in the rotation's path, and the 33x29x5 case of
its CLI test.  Both packages get the same numpy inputs (the grid, its
``CurvMap`` and the boundaries through ``ltjax_torch.interop``).

* ``curv_logical`` (seed raster + 3 Newton steps) and its residual in
  float64 to 1e-9 on points inside the mesh, outside it and on the rim
  cells; the seed rasters, the psi-mesh segments, buckets, cell rows and
  the residual tolerance are equal exactly.
* ``reflect`` on the curved island to 1e-9 m, with open exits and stuck
  particles.
* ``internal_step`` against ltjax's collapsed-mode ``internal_step`` in
  float64 over three chained steps: advection; HTurb + Visser on Aks;
  behavior 3; and the oyster lanes (behavior 4 on the halocline,
  SaltTempOn, settlement with a hole).  Positions to 1e-6 m, statuses,
  collision counts and settle_poly equal, salt and temp to 1e-6.
* ``make_fused_external_steps`` (two external steps, with the sort)
  against ltjax's collapsed scan, float64, 1e-6 m; on CPU tensors the
  wrapper launches nothing.
* The kernel's side on the host: ``kernel_variant(cfg, curv=True)`` adds
  LTX_CURV and leaves every other tag as it was, ``curv_tables`` packs
  the map as the kernel reads it, and ``check_supported`` accepts a
  curvilinear grid on CUDA (a non-uniform rectilinear one stays
  refused, tests/test_torch_step.py).
* The CLI with ``--device cpu`` on a geographic curvilinear ROMS series:
  statuses equal to ``ltjax.run.run``'s and positions within 0.5 m
  (float32 fields on disk; ltjax's CPU path interpolates fit-then-blend),
  within 20 m of the analytic circles (tests/test_curv.py's budget: the
  u/v nodes sit O(h^2 curvature) off the rho mesh); the startup line says
  ``"curvilinear": true``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import packed as jpk
from ltjax import run as jrun
from ltjax import state as jst
from ltjax import synth as jsynth
from ltjax.config import Config, config_from_namelist
from ltjax.grid import curv_logical as j_curv_logical
from ltjax.physics import boundary as jbd
from ltjax.physics import settlement as jstl
from ltjax.step import StepContext as JContext
from ltjax.step import internal_step as j_internal_step
from ltjax_torch import interop
from ltjax_torch import packed as tpk
from ltjax_torch import step as tstep
from ltjax_torch import synth
from ltjax_torch.grid import curv_logical
from ltjax_torch.kernels import build
from ltjax_torch.kernels import ext_step as kx
from ltjax_torch.physics import boundary as bd

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(nt):
    """numpy fields of an ltjax NamedTuple; a CurvMap as a dict."""
    d = {k: np.asarray(v) for k, v in nt._asdict().items() if k != "curv"}
    if "curv" in nt._fields:
        d["curv"] = None if nt.curv is None else _np(nt.curv)
    return d


def _mask():
    mask = np.ones((41, 41), np.int32)
    mask[18:22, 26:30] = 0          # logical i 26-29, j 18-21
    return mask


@pytest.fixture(scope="module")
def curv_case():
    c = jsynth.make_curv_case(nx=41, ny=41, us=8, lx=100e3, ly=100e3,
                              h0=40.0, omega=1e-4, amp=0.02, mask=_mask(),
                              dtype=jnp.float64)
    bounds = jbd.build_boundaries_curv(_mask(), c.x2d, c.y2d, c.grid.curv)
    return c, bounds


def _port(grid, bounds, polys=None, holes=None):
    return tstep.StepContext(
        grid=interop.grid_from_numpy(_np(grid)),
        bounds=interop.boundaries_from_numpy(_np(bounds)),
        polys=None if polys is None else interop.polygons_from_numpy(
            _np(polys)),
        holes=None if holes is None else interop.polygons_from_numpy(
            _np(holes)))


def _forward(c, ti, tj):
    """Physical position of logical coordinates (ti, tj)."""
    return synth.logical_to_xy(c.x2d, c.y2d, ti, tj)


def test_curv_logical_matches_ltjax(curv_case):
    c, _ = curv_case
    g = c.grid
    rng = np.random.default_rng(0)
    n = 600
    # inside the mesh, on the rim cells, and outside it (up to 4 km)
    ti = np.concatenate([rng.uniform(0.0, 40.0, n), rng.uniform(0, 40, n),
                         rng.choice([0.0, 40.0], n)])
    tj = np.concatenate([rng.uniform(0.0, 40.0, n), rng.choice([0.2, 39.8],
                                                               n),
                         rng.uniform(0, 40, n)])
    x, y = _forward(c, ti, tj)
    x = np.concatenate([x, rng.uniform(-4e3, 104e3, n)])
    y = np.concatenate([y, rng.choice([-3e3, 103e3], n)])
    want = j_curv_logical(g.curv, g.nx, g.ny, jnp.asarray(x), jnp.asarray(y))
    tg = interop.grid_from_numpy(_np(g))
    got = curv_logical(tg.curv, tg.nx, tg.ny, torch.tensor(x),
                       torch.tensor(y))
    for w, v in zip(want, got):
        np.testing.assert_allclose(v.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)
    # the rim and outside points clamp and leave a residual
    assert float(got[2][-n:].min()) > 1e6
    np.testing.assert_allclose(got[0][:n].numpy(), ti[:n], rtol=0,
                               atol=1e-6)


def test_curv_grid_and_boundaries_match_ltjax(curv_case):
    c, jb = curv_case
    tc = synth.make_curv_case(nx=41, ny=41, us=8, lx=100e3, ly=100e3,
                              h0=40.0, omega=1e-4, amp=0.02, mask=_mask())
    jg, tg = c.grid, tc.grid
    for k in ("seed_i", "seed_j", "xy_flat"):
        np.testing.assert_array_equal(getattr(tg.curv, k).numpy(),
                                      np.asarray(getattr(jg.curv, k)))
    for k in ("rx0", "ry0", "inv_rdx", "inv_rdy"):
        assert getattr(tg.curv, k) == float(getattr(jg.curv, k))
    for k in ("x_rho", "y_rho", "h", "mask_rho", "s_rho", "Cs_r", "s_w",
              "Cs_w"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)))
    tb = bd.build_boundaries_curv(tg.mask_rho.numpy(), tc.x2d, tc.y2d,
                                  tg.curv)
    for k in ("seg_a", "seg_b", "seg_kind", "bucket", "cell_rows", "x_edges",
              "y_edges", "water"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)))
    assert tb.curv_tol2 == float(jb.curv_tol2)
    # non-axis-aligned mesh: isotropic guard radii (lanes 3 and 4 equal)
    rows = tb.cell_rows.numpy()
    np.testing.assert_array_equal(rows[:, 3], rows[:, 4])
    assert (jb.seg_kind == jbd.LAND).any() and (jb.seg_kind == jbd.OPEN
                                                ).any()


def test_curv_reflect_matches_ltjax(curv_case):
    c, jb = curv_case
    tb = interop.boundaries_from_numpy(_np(jb))
    rng = np.random.default_rng(1)
    n = 400
    # around the island (logical i 26-29, j 18-21) and along the rim
    ti = np.concatenate([rng.uniform(23.0, 32.0, n), rng.uniform(0.3, 40.0,
                                                                 n)])
    tj = np.concatenate([rng.uniform(15.0, 24.0, n), rng.choice([0.8, 39.2],
                                                                n)])
    x0, y0 = _forward(c, ti, tj)
    ang = rng.uniform(0, 2 * np.pi, 2 * n)
    r = rng.uniform(0.0, 4.5e3, 2 * n)       # up to ~1.8 cells: some over
    x1, y1 = x0 + r * np.cos(ang), y0 + r * np.sin(ang)
    outs = []
    for open_exits in (True, False):
        want = jbd.reflect(jb, *(jnp.asarray(a) for a in (x0, y0, x1, y1)),
                           open_exits=open_exits, n_iter=4)
        got = bd.reflect(tb, *(torch.tensor(a) for a in (x0, y0, x1, y1)),
                         open_exits=open_exits, n_iter=4)
        for w, v in zip(want[:2], got[:2]):
            np.testing.assert_allclose(v.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-9)
        for w, v in zip(want[2:], got[2:]):
            np.testing.assert_array_equal(v.numpy(), np.asarray(w))
        outs.append(got)
    hits, exited, stuck = (v.numpy() for v in outs[0][2:])
    assert hits.sum() > 0 and exited.sum() > 0 and stuck.sum() > 0
    assert (~stuck & ~exited).sum() > n
    # without open exits the rim reflects: nobody leaves
    assert outs[1][3].numpy().sum() == 0


def _fields(c, seed=6):
    """ltjax's curvilinear triple buffer with a seeded random free
    surface and w and a perturbed parabolic Aks profile (float64)."""
    fs = jsynth.fieldset_for(c, t_center=1800.0, dt=3600.0,
                             dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    z_w = 40.0 * np.asarray(c.grid.s_w)
    K = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / 40.0 + 1.0) ** 2)
    return fs._replace(
        aks=jnp.asarray(K * (1.0 + 0.3 * rng.uniform(-1, 1, fs.aks.shape))),
        zeta=jnp.asarray(0.3 * rng.standard_normal(fs.zeta.shape)),
        w=jnp.asarray(rng.uniform(-2e-3, 2e-3, fs.w.shape)))


def _with_halocline(grid, fs, seed=7):
    """fs with synth.halocline_fields' salt and temp (a function of the
    curvilinear rho x), perturbed per record and node."""
    salt, temp = synth.halocline_fields(interop.grid_from_numpy(_np(grid)))
    rng = np.random.default_rng(seed)

    def per_record(a, amp):
        a = np.moveaxis(a, 0, -1)[None]
        return a + amp * rng.uniform(-1, 1, (3,) + a.shape[1:])

    return fs._replace(salt=jnp.asarray(per_record(salt, 0.2)),
                       temp=jnp.asarray(per_record(temp, 0.3)))


def _particles(c, n=256, seed=6):
    """Three eighths over the whole mesh, an eighth along the north rim
    where the rotation carries them out (open-rim exits), half just
    upstream (south) of the island; a third near the surface, a third
    near the bottom; staggered releases and ages across the swim ramp and
    the death age."""
    rng = np.random.default_rng(seed)
    k, h = n // 8, n // 2
    # logical coordinates: the island's south face is at tj = 17.5
    x, y = _forward(c, np.concatenate([rng.uniform(0.5, 39.5, h - k),
                                       rng.uniform(28.0, 39.5, k),
                                       rng.uniform(25.0, 31.0, n - h)]),
                    np.concatenate([rng.uniform(0.5, 39.5, h - k),
                                    rng.uniform(39.3, 40.0, k),
                                    rng.uniform(14.5, 17.3, n - h)]))
    k = n // 3
    z = rng.permutation(np.concatenate([
        rng.uniform(-1.0, 0.0, k), rng.uniform(-39.9, -39.0, k),
        rng.uniform(-39.0, -1.0, n - 2 * k)]))
    p = jst.init_particles(x, y, z, dtype=jnp.float64)
    return p._replace(dob=jnp.asarray(rng.choice([0.0, 300.0], n)),
                      age=jnp.asarray(rng.uniform(0.0, 3 * 86400.0, n)),
                      pid=jnp.asarray(rng.permutation(n).astype(np.int32)))


def _polygons():
    """A habitat square with a square hole under the particles upstream
    of the island, and a slanted hexagon 30 km across (metres)."""
    th = np.linspace(0.0, 2 * np.pi, 7)[:-1] + 0.3
    hexagon = np.stack([30e3 + 15e3 * np.cos(th), 30e3 + 15e3 * np.sin(th)],
                       -1)
    habitat = [(11, np.array([[60e3, 36e3], [77e3, 36e3], [77e3, 44.5e3],
                              [60e3, 44.5e3]])), (12, hexagon)]
    holes = [(1, np.array([[66e3, 39e3], [70e3, 39e3], [70e3, 42e3],
                           [66e3, 42e3]]))]
    return habitat, holes


BEH = dict(deadage=2 * 86400.0, pediage=86400.0, swimstart=3600.0,
           swimslow=2e-3, swimfast=5e-3)
SALT = dict(readSalt=True, readTemp=True, Sgradient=0.5, swimslow=1e-3,
            swimfast=3e-3)
STEP_CASES = {
    "advection": dict(),
    "turb-visser": dict(HTurbOn=True, ConstantHTurb=300.0, VTurbOn=True,
                        readAks=True),
    "behavior3": dict(Behavior=3, mortality=True, HTurbOn=True,
                      ConstantHTurb=300.0),
    "oyster": dict(Behavior=4, SaltTempOn=True, settlementon=True,
                   holesExist=True, HTurbOn=True, ConstantHTurb=300.0,
                   VTurbOn=True, readAks=True, mortality=True, **SALT),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_curv_internal_step_matches_ltjax_collapsed(curv_case, name):
    c, jb = curv_case
    g = c.grid
    cfg = Config(numpar=256, dt=1800, idt=300, us=8, ws=9,
                 OpenOceanBoundary=True, dtype_pos="float64",
                 reflect_iters=2, TrackCollisions=True,
                 **{**BEH, **STEP_CASES[name]})
    cfg.validate()
    fs = _fields(c)
    jpol = jhol = None
    if cfg.settlementon:
        fs = _with_halocline(g, fs)
        habitat, holes = _polygons()
        xe, ye = np.asarray(jb.x_edges), np.asarray(jb.y_edges)
        jpol = jstl.build_polygons(habitat, xe, ye)
        jhol = jstl.build_polygons(holes, xe, ye)
    jctx = JContext(grid=g, bounds=jb, polys=jpol, holes=jhol)
    jprec = jpk.build_packed_records(g, fs)
    ctx = _port(g, jb, jpol, jhol)
    tfs = interop.fieldset_from_numpy(_np(fs))
    prec = tpk.build_packed_records(ctx.grid, tfs)
    pj = _particles(c)
    pt = interop.particles_from_numpy(_np(pj))
    for i in range(3):
        t = i * 300.0
        pj = j_internal_step(jctx, cfg, jr.key(9), pj, fs, t, 40 + i, jprec,
                             mode="collapsed")
        pt = tstep.internal_step(ctx, cfg, 9, pt, tfs, t, 40 + i, prec)
        out = interop.particles_to_numpy(pt)
        for k in ("status", "settle_poly", "hit_land", "hit_bottom"):
            np.testing.assert_array_equal(out[k], np.asarray(getattr(pj, k)))
        for k in ("x", "y", "z", "age", "salt", "temp"):
            np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                       rtol=0, atol=1e-6)
    counts = np.bincount(out["status"], minlength=6)
    # the island reflected, the open rim let some out, the bottom was hit
    assert out["hit_land"].sum() > 0 and counts[jst.OUT_OF_DOMAIN] > 0
    assert out["hit_bottom"].sum() > 0
    if cfg.mortality:
        assert counts[jst.DEAD] > 0
    if cfg.settlementon:
        assert set(out["settle_poly"][out["status"] == jst.SETTLED]) == {
            11, 12}
        assert (out["salt"][out["status"] != jst.NOT_RELEASED] > 15.0).all()


def test_curv_fused_driver_matches_collapsed_scan(curv_case):
    c, jb = curv_case
    g = c.grid
    cfg = Config(numpar=256, dt=1800, idt=450, us=8, ws=9,
                 OpenOceanBoundary=True, dtype_pos="float64",
                 reflect_iters=2, TrackCollisions=True, HTurbOn=True,
                 ConstantHTurb=100.0, ext_sort_every=1, seed=9)
    fsR = jsynth.fieldset_window(c, -900.0, 1800.0, 4, dtype=jnp.float64)
    p0 = _particles(c, seed=8)
    n_launch = kx.ext_step_fused.launches
    pt = tstep.make_fused_external_steps(_port(g, jb), cfg, 2)(
        interop.particles_from_numpy(_np(p0)),
        interop.fieldset_from_numpy(_np(fsR)), 0.0, 0)
    jctx = JContext(grid=g, bounds=jb, polys=None, holes=None)
    pj = p0
    n_int = cfg.internal_steps
    for e in range(2):
        fs3 = type(fsR)(*(a[e:e + 3] for a in fsR[:-1]),
                        times=fsR.times[e:e + 3])
        prec = jpk.build_packed_records(g, fs3)
        for i in range(n_int):
            pj = j_internal_step(jctx, cfg, jr.key(9), pj, fs3,
                                 e * 1800.0 + i * 450.0, e * n_int + i, prec,
                                 mode="collapsed")
    assert kx.ext_step_fused.launches == n_launch
    out = interop.particles_to_numpy(pt)
    np.testing.assert_array_equal(out["pid"], np.asarray(p0.pid))
    for k in ("status", "hit_land"):
        np.testing.assert_array_equal(out[k], np.asarray(getattr(pj, k)))
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(pj, k)),
                                   rtol=0, atol=1e-6)
    assert (out["status"] == jst.ACTIVE).sum() > 0.5 * len(out["x"])
    assert out["hit_land"].sum() > 0


def test_curv_kernel_variant_and_tables(curv_case, monkeypatch):
    c, jb = curv_case
    ctx = _port(c.grid, jb)
    cfg = Config(numpar=1, us=8, ws=9, dtype_pos="float32")
    oyster = Config(numpar=1, us=8, ws=9, dtype_pos="float32", Behavior=4,
                    readSalt=True, SaltTempOn=True, settlementon=True)
    assert build.tag("ext_step", kx.kernel_variant(cfg)) == \
        "ext_step-b0h0m0v0"
    assert build.tag("ext_step", kx.kernel_variant(cfg, curv=True)) == \
        "ext_step-b0c1h0m0v0"
    assert build.tag("ext_step", kx.kernel_variant(oyster)) == \
        "ext_step-b4h0m0sa1se1v0"
    assert build.tag("ext_step", kx.kernel_variant(oyster, curv=True)) == \
        "ext_step-b4c1h0m0sa1se1v0"
    xy, seeds, (mx, my), scal = kx.curv_tables(ctx)
    cm = c.grid.curv
    assert xy.dtype == torch.float32 and tuple(xy.shape) == (41 * 41, 2)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(cm.xy_flat,
                                                         np.float32))
    assert (my, mx) == cm.seed_i.shape and seeds.dtype == torch.int32
    np.testing.assert_array_equal(seeds.numpy(), np.concatenate(
        [np.asarray(cm.seed_i).ravel(), np.asarray(cm.seed_j).ravel()]))
    assert scal == tuple(float(v) for v in (cm.rx0, cm.ry0, cm.inv_rdx,
                                            cm.inv_rdy, jb.curv_tol2))
    assert kx.curv_tables(ctx) is kx.curv_tables(ctx)      # cached
    rect = bd.build_boundaries(_mask(), np.asarray(c.grid.x_rho),
                               np.asarray(c.grid.y_rho))
    with pytest.raises(ValueError, match="curvilinear boundaries"):
        kx.curv_tables(tstep.StepContext(grid=ctx.grid, bounds=rect))
    # the slice takes a curvilinear grid on CUDA (presented as on CUDA)
    monkeypatch.setattr(type(ctx.grid), "device",
                        property(lambda self: torch.device("cuda")))
    tstep.check_supported(cfg, ctx)


NO_JAX = ("import runpy, sys; sys.modules['jax'] = None; "
          "sys.modules['ltjax'] = None; "
          "sys.argv = ['ltjax_torch.run'] + sys.argv[1:]; "
          "runpy.run_module('ltjax_torch.run', run_name='__main__')")


@pytest.fixture(scope="module")
def curv_cli(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_curv_cli"))
    case = synth.make_curv_case(nx=33, ny=29, us=5, lx=64e3, ly=56e3,
                                h0=40.0, omega=1e-4, amp=0.02)
    rng = np.random.default_rng(4)
    n = 64
    x0 = rng.uniform(20e3, 44e3, n)
    y0 = rng.uniform(16e3, 40e3, n)
    z0 = rng.uniform(-30.0, -5.0, n)
    nml = synth.write_run_files(case, d, x0, y0, z0, n_ext=2, dt=1800,
                                idt=450, iprint=2 * 1800, geographic=True,
                                lonmin=-76.0, latmin=37.0, ErrorFlag=0)
    r = subprocess.run([sys.executable, "-c", NO_JAX, nml, "--device",
                        "cpu"], cwd=ROOT, env=dict(os.environ,
                                                   PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    rows = np.loadtxt(os.path.join(d, "out", "run1.csv"), delimiter=",")
    last = rows[rows[:, 0] == rows[:, 0].max()]
    return case, nml, d, (x0, y0, z0), lines, last[np.argsort(last[:, 1])]


def test_curv_cli_on_cpu(curv_cli):
    from ltjax_torch import convert
    case, _, _, (x0, y0, z0), lines, final = curv_cli
    assert lines[0]["path"] == "plain" and lines[0]["curvilinear"] is True
    assert lines[0]["uniform"] is False
    assert lines[-1]["active"] == len(x0)
    # columns: time id lon lat depth status ...
    y = convert.lat2y(final[:, 3], 37.0)
    x = convert.lon2x(final[:, 2], final[:, 3], -76.0, 37.0)
    xa, ya, _ = case.analytic(x0, y0, z0, 2 * 1800.0)
    assert np.hypot(x - xa, y - ya).max() < 20.0
    np.testing.assert_allclose(final[:, 4], z0, rtol=0, atol=1e-3)


def test_curv_cli_matches_ltjax_run(curv_cli):
    from ltjax_torch import convert
    _, nml, d, _, _, final = curv_cli
    pj = jrun.run(config_from_namelist(nml,
                                       outpath=os.path.join(d, "jax_out")))
    np.testing.assert_array_equal(final[:, 5], np.asarray(pj.status))
    y = convert.lat2y(final[:, 3], 37.0)
    x = convert.lon2x(final[:, 2], final[:, 3], -76.0, 37.0)
    np.testing.assert_allclose(x, np.asarray(pj.x), rtol=0, atol=0.5)
    np.testing.assert_allclose(y, np.asarray(pj.y), rtol=0, atol=0.5)
