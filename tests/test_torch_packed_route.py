"""The packed route (``kernel_interp = False``) in the port against ltjax's
packed scheme, on the CPU.

ltjax runs ``internal_step(mode="packed")`` wherever its kernels do not
(``kernel_interp`` off, and every run off the TPU): per RK4 stage it
collapses the three records in time, fits the tension spline densely
per grid column (``packed.collapse_stage``), evaluates the fit at the
particle's depth on each of the 4 corners' own knots and blends the 4
values (``find_currents_packed``).  The port's collapsed scheme (its
kernels') blends the profiles first and fits once per particle: another
interpolant of the same data.

Tables, currents and RK4 (parametrised as tests/test_torch_packed.py:
affine and stretched ladders, Vtransform 1 and 2, plus stretched rho
axes and a curvilinear grid, each with a numpy-seeded free surface and
w): stage-table values and z2 lanes 1e-12 in float64; velocities 1e-9
m/s; RK4 displacements 1e-6 m; zeta and h 1e-9 m.

Internal and external steps (the cases of tests/test_torch_native.py:
a 15 x 15 float64 grid with a land block, random zeta and w, perturbed
Aks and halocline, 256 particles; both packages draw from seed 9):
positions 1e-8 m horizontally and 1e-10 m vertically, statuses,
settle_poly and collision counts equal, salt and temp 1e-9.  The first
test of the pair shows the fault this route repairs: before it, a run
file with ``kernel_interp = False`` ran the collapsed scheme; the second
shows that scheme misses ltjax's packed result by far more than the
tolerance on this case.

The CLI: ``python -m ltjax_torch.run --device cpu`` in the subprocess of
tests/test_torch_run.py that proves no jax is imported, against
``ltjax.run.run`` on the same namelist with ``kernel_interp = .FALSE.``,
on a planar turbulent run over a sloping bottom with vertical shear
(where the two schemes differ) and on the oyster run of
tests/test_torch_run.py.  The final particles come from the port's
checkpoint (full precision) and ltjax's returned particles; statuses and
settle_poly also from both CSVs.  With ``dtype_field = "float64"`` both
step in float64 from the same float32 records: 1e-8 m horizontally,
1e-10 m vertically, salt and temp 1e-9 (measured 6.6e-12 m).  With the
default float32 fields the tables are float32 on both sides and the two
packages round differently: 1e-3 m horizontally, 1e-5 m vertically, salt
and temp 1e-4 (measured 1.1e-4 m, 4.1e-7 m, 7.0e-6 psu).  Statuses and
settle_poly are equal in both.  On the planar run the collapsed scheme
(``kernel_interp`` on) lands 1.76 m from ltjax's packed result; on the
oyster run (a flat bottom, zeta 0, fields linear in x and y) the two
schemes coincide.  Chunks of 2 and of 4 external steps give the same
particles, bit for bit.
"""

import dataclasses
import os

import jax
import jax.random as jr
import numpy as np
import pytest
import torch

from ltjax import packed as jpk
from ltjax import run as jrun
from ltjax import state as jst
from ltjax import synth as jsynth
from ltjax.config import config_from_namelist as j_config
from ltjax.physics import settlement as jstl
from ltjax.step import StepContext as JContext
from ltjax.step import internal_step as j_internal_step
from ltjax.step import make_external_step as j_make_external_step
from ltjax_torch import interop
from ltjax_torch import packed as pk
from ltjax_torch import step as tstep
from ltjax_torch import synth
from test_torch_native import (BEH, _assert_particles, _cfg, _curv_case, _np,
                               _polygons, _port_ctx, _rect_case,
                               _stretched_grid)
from test_torch_run import OYSTER, _final, _run_cli, oyster_polygons

torch.set_num_threads(1)

SIGMA = 0.0
Z0M = 5e-4
IDT = 300.0
T = 350.0


# --- stage tables, currents and RK4 -----------------------------------------

def _ladder_case(theta_s, vt):
    c = jsynth.make_solid_body_case(nx=21, ny=17, us=6, lx=40e3, ly=32e3,
                                    h0=40.0, omega=1e-4, shear_a=0.01,
                                    ramp_b=1e-5, vtransform=vt,
                                    theta_s=theta_s, dtype=jax.numpy.float64)
    fs = jsynth.fieldset_for(c, t_center=1800.0, dt=3600.0,
                             dtype=jax.numpy.float64)
    rng = np.random.default_rng(7)
    fs = fs._replace(zeta=jax.numpy.asarray(
        0.3 * rng.standard_normal(fs.zeta.shape)),
        w=jax.numpy.asarray(rng.uniform(-5e-3, 5e-3, fs.w.shape)))
    n = 300
    return (c.grid, fs, rng.uniform(1e3, 39e3, n), rng.uniform(1e3, 31e3, n),
            rng.uniform(-39.0, -0.5, n))


def _grid_case(kind):
    if kind == "curvilinear":
        grid, fs, _, p = _curv_case()
    else:
        grid, fs, _, p = _rect_case()
        grid = _stretched_grid()
    return grid, fs, np.asarray(p.x), np.asarray(p.y), np.asarray(p.z)


CASES = {"affine-vt1": (0.0, 1), "stretched-vt1": (4.0, 1),
         "affine-vt2": (0.0, 2), "stretched-vt2": (4.0, 2),
         "stretched-axes": None, "curvilinear": None}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    lad = CASES[request.param]
    jgrid, fs, x, y, z = (_ladder_case(*lad) if lad is not None
                          else _grid_case(request.param))
    grid = interop.grid_from_numpy(_np(jgrid))
    assert grid.uniform == request.param.startswith(("affine", "stretched-v"))
    assert (grid.curv is not None) == (request.param == "curvilinear")
    jrec = jpk.build_packed_records(jgrid, fs)
    rec = pk.build_packed_records(grid, interop.fieldset_from_numpy(_np(fs)))
    return jgrid, jrec, grid, rec, x, y, z


@pytest.mark.parametrize("sigma", [0.0, 2.0])
def test_stage_tables_match_ltjax(case, sigma):
    """Values and z2 lanes of the 3 stage tables against ltjax's pair rows
    (cell c is the first half of row c: values, padding, z2 at HL)."""
    jgrid, jrec, grid, rec, *_ = case
    us, ws = grid.us, grid.ws
    nv, hl = pk.n_value_lanes(us, ws), jpk.half_lanes(us, ws)
    jt = jpk.stage_tables(jgrid, jrec, T, IDT, sigma)
    tt = pk.stage_tables(grid, rec, T, IDT, sigma)
    for a, b in zip(tt, jt):
        assert a.t == pytest.approx(float(b.t))
        assert a.full.shape == (grid.ny, grid.nx, nv + 2 * us + ws)
        cell = np.asarray(b.rows)[:, :2 * hl]
        got = a.full.reshape(grid.ny * grid.nx, -1).numpy()
        np.testing.assert_allclose(got[:, :nv], cell[:, :nv], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got[:, nv:], cell[:, hl:hl + 2 * us + ws],
                                   rtol=0, atol=1e-12)
        assert np.abs(got[:, nv:]).max() > 1e-9      # the fits are not flat


def test_find_currents_and_rk4_packed(case):
    jgrid, jrec, grid, rec, x, y, z = case
    jt = jpk.stage_tables(jgrid, jrec, T, IDT, SIGMA)
    tt = pk.stage_tables(grid, rec, T, IDT, SIGMA)
    xj, yj, zj = (jax.numpy.asarray(a) for a in (x, y, z))
    xt, yt, zt = (torch.tensor(a) for a in (x, y, z))
    cur_j = jpk.find_currents_packed(jgrid, jt[1], xj, yj, zj, SIGMA, Z0M)
    cur_t = pk.find_currents_packed(grid, tt[1], xt, yt, zt, SIGMA, Z0M)
    for a, b in zip(cur_t, cur_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    d_j = jpk.rk4_displacement_packed(jgrid, jt, xj, yj, zj, SIGMA, Z0M, IDT)
    d_t = pk.rk4_displacement_packed(grid, tt, xt, yt, zt, SIGMA, Z0M, IDT)
    for a, b in zip(d_t, d_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    assert float(d_t[2].abs().max()) > 0.1       # w moves particles
    for a, b in zip(pk.zeta_h_packed(grid, tt[2], xt, yt),
                    jpk.zeta_h_packed(jgrid, jt[2], xj, yj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)


# --- the fault: kernel_interp = False ran the collapsed scheme -----------------

@pytest.fixture(scope="module")
def external_step():
    """One external step (3 internal steps) of ltjax's external step on
    the CPU (its packed scheme) on the rectilinear case, and the port's
    inputs."""
    grid, fs, bounds, p = _rect_case()
    cfg = _cfg(seed=9, fast_interp=True, kernel_interp=False)
    jctx = JContext(grid=grid, bounds=bounds, polys=None, holes=None)
    pj = j_make_external_step(jctx, cfg, jr.key(9))(p, fs, 0.0, 0)
    return (cfg, _port_ctx(grid, bounds),
            interop.particles_from_numpy(_np(p)),
            interop.fieldset_from_numpy(_np(fs)), jax.block_until_ready(pj))


def test_packed_route_matches_ltjax(external_step):
    cfg, ctx, p, tfs, pj = external_step
    assert tstep.mode_flags(ctx, cfg) == "packed"
    out = interop.particles_to_numpy(
        tstep.make_fused_external_steps(ctx, cfg, 1)(p, tfs, 0.0, 0))
    _assert_particles(out, pj)
    assert np.abs(out["z"] - p.z.numpy()).max() > 1.0
    assert out["hit_bottom"].sum() > 0


def test_collapsed_route_differs_from_packed(external_step):
    """The collapsed scheme (kernel_interp on) misses ltjax's packed
    result on this case by far more than the tolerance."""
    cfg, ctx, p, tfs, pj = external_step
    collapsed = dataclasses.replace(cfg, kernel_interp=True)
    assert tstep.mode_flags(ctx, collapsed) == "ext_step"
    out = interop.particles_to_numpy(
        tstep.make_fused_external_steps(ctx, collapsed, 1)(p, tfs, 0.0, 0))
    dh = np.hypot(out["x"] - np.asarray(pj.x), out["y"] - np.asarray(pj.y))
    assert dh.max() > 1e3 * 1e-8
    assert np.abs(out["z"] - np.asarray(pj.z)).max() > 1e3 * 1e-10


def test_mode_flags_packed_route():
    """kernel_interp off takes the packed route (stochastic mortality
    too); fast_interp off and adaptive tension stay native."""
    ctx = None
    base = dict(kernel_interp=False)
    assert tstep.mode_flags(ctx, _cfg(**base, fast_interp=True)) == "packed"
    assert tstep.mode_flags(ctx, _cfg(
        **base, fast_interp=True, mortality=True,
        stochastic_mortality=True)) == "packed"
    assert tstep.mode_flags(ctx, _cfg(**base)) == "native"
    assert tstep.mode_flags(ctx, _cfg(**base, fast_interp=True,
                                      tension_sigma=-1.0)) == "native"
    assert tstep.mode_flags(ctx, _cfg(fast_interp=True, mortality=True,
                                      stochastic_mortality=True)) == "per_step"


# --- internal_step(mode="packed") against ltjax's ------------------------------

PACKED_STEP = {
    "turb": dict(HTurbOn=True, ConstantHTurb=2e4, VTurbOn=True, readAks=True),
    "behavior4": dict(Behavior=4, readSalt=True, mortality=True),
    "behavior5": dict(Behavior=5, readSalt=True, readTemp=True,
                      SaltTempOn=True),
    "behavior7": dict(Behavior=7, mortality=True, tension_sigma=2.0),
    "settlement": dict(Behavior=6, settlementon=True, holesExist=True,
                       HTurbOn=True, ConstantHTurb=2e4),
    "stochastic": dict(Behavior=6, mortality=True, stochastic_mortality=True,
                       deadage=3600.0),
    "curv": dict(HTurbOn=True, ConstantHTurb=1.0, Behavior=7),
}


@pytest.mark.parametrize("name", list(PACKED_STEP))
def test_internal_step_matches_ltjax_packed(name):
    curv = name == "curv"
    grid, fs, bounds, p = _curv_case() if curv else _rect_case()
    cfg = _cfg(**{**BEH, "fast_interp": True, "kernel_interp": False,
                  **PACKED_STEP[name]})
    cfg.validate()
    polys = holes = None
    if cfg.settlementon:
        xe, ye = np.asarray(bounds.x_edges), np.asarray(bounds.y_edges)
        habitat, hole = _polygons()
        polys = jstl.build_polygons(habitat, xe, ye)
        holes = jstl.build_polygons(hole, xe, ye)
    jctx = JContext(grid=grid, bounds=bounds, polys=polys, holes=holes)
    ctx = _port_ctx(grid, bounds, polys, holes)
    assert tstep.mode_flags(ctx, cfg) == "packed"
    tfs = interop.fieldset_from_numpy(_np(fs))
    jrec = jpk.build_packed_records(grid, fs)
    rec = tstep.packed_window(ctx, cfg, "packed", tfs)
    assert rec.tab.shape[-1] == pk.n_value_lanes(cfg.us, cfg.ws)
    pj = p
    pt = interop.particles_from_numpy(_np(p))
    for i in range(3):
        t = i * 300.0
        pj = j_internal_step(jctx, cfg, jr.key(9), pj, fs, t, 40 + i, jrec,
                             mode="packed")
        pt = tstep.internal_step(ctx, cfg, 9, pt, tfs, t, 40 + i, rec,
                                 mode="packed")
        out = interop.particles_to_numpy(pt)
        _assert_particles(out, pj, salt=cfg.SaltTempOn)
    st_ = out["status"]
    assert (st_ == jst.ACTIVE).sum() > 0
    assert np.abs(out["z"] - np.asarray(p.z)).max() > 0.1
    if cfg.mortality and cfg.stochastic_mortality:
        assert (st_ == jst.DEAD).sum() > 0
    if cfg.settlementon:
        assert (st_ == jst.SETTLED).sum() > 0
    if cfg.ConstantHTurb > 100:
        assert out["hit_land"].sum() > 0


# --- the CLI against ltjax.run.run -----------------------------------------------

N_EXT = 4
DT = 1800


def _planar(d, fuse, dtype_field):
    """A turbulent run over a bottom sloping from 30 to 50 m, with
    vertical shear: the column fits differ from corner to corner."""
    case = synth.make_solid_body_case(nx=31, ny=31, us=6, lx=30e3, ly=30e3,
                                      h0=40.0, omega=1e-4, shear_a=0.02,
                                      dtype=torch.float64, parabolic_aks=True)
    case.grid.h.copy_(torch.linspace(30.0, 50.0, 31, dtype=torch.float64
                                     ).expand(31, 31))
    rng = np.random.default_rng(17)
    n = 150
    return synth.write_run_files(
        case, d, rng.uniform(8e3, 22e3, n), rng.uniform(8e3, 22e3, n),
        rng.uniform(-25.0, -3.0, n), n_ext=N_EXT, dt=DT, idt=450,
        iprint=N_EXT * DT, ext_fuse=fuse, HTurbOn=True, ConstantHTurb=1.0,
        VTurbOn=True, readAks=True, seed=11, **_packed(d, dtype_field))


def _oyster(d, fuse, dtype_field):
    case = synth.make_solid_body_case(nx=31, ny=31, us=6, lx=30e3, ly=30e3,
                                      h0=40.0, omega=1e-4,
                                      dtype=torch.float64, parabolic_aks=True,
                                      halocline=True)
    rng = np.random.default_rng(15)
    n = 150
    habitat, holes = oyster_polygons()
    return synth.write_run_files(
        case, d, rng.uniform(8e3, 22e3, n), rng.uniform(8e3, 22e3, n),
        rng.uniform(-16.0, -4.0, n), n_ext=N_EXT, dt=DT, idt=450,
        iprint=N_EXT * DT, ext_fuse=fuse, habitat=habitat, holes=holes,
        **OYSTER, **_packed(d, dtype_field))


def _packed(d, dtype_field):
    """kernel_interp off, the field dtype, and a checkpoint after the last
    external step (the port's final particles at full precision)."""
    return dict(kernel_interp=False, dtype_field=dtype_field,
                checkpoint_every=N_EXT,
                checkpoint_dir=os.path.join(d, "ckpt"))


RUNS = {"planar": _planar, "oyster": _oyster}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """{(run, dtype_field, ext_fuse): (namelist, dir, lines, CSV rows)}."""
    cache = {}

    def get(name, dtype_field, fuse=4):
        key = (name, dtype_field, fuse)
        if key not in cache:
            d = str(tmp_path_factory.mktemp(f"packed_{name}_{dtype_field}"))
            nml = RUNS[name](d, fuse, dtype_field)
            cache[key] = (nml, d, _run_cli(nml), np.loadtxt(
                os.path.join(d, "out", "run1.csv"), delimiter=","))
        return cache[key]

    return get


def _port_final(d):
    with np.load(os.path.join(d, "ckpt", f"ckpt_{N_EXT}.npz")) as z:
        cols = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    order = np.argsort(cols["pid"])
    return {k: v[order] for k, v in cols.items()}


# (horizontal m, vertical m, salt/temp) per field dtype
CLI_TOL = {"float64": (1e-8, 1e-10, 1e-9), "float32": (1e-3, 1e-5, 1e-4)}


@pytest.mark.parametrize("dtype_field", list(CLI_TOL))
@pytest.mark.parametrize("name", list(RUNS))
def test_cli_packed_route_matches_ltjax_run(cli_runs, name, dtype_field):
    nml, d, lines, rows = cli_runs(name, dtype_field)
    start = lines[0]
    assert start["route"] == "packed" and start["path"] == "plain"
    assert start["dtype_pos"] == "float64"
    assert lines[-1]["error"] == 0
    pj = jrun.run(j_config(nml, outpath=os.path.join(d, "jax_out"),
                           checkpoint_every=0))
    got = _port_final(d)
    tol_h, tol_v, tol_s = CLI_TOL[dtype_field]
    for k in ("pid", "status", "settle_poly"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(pj, k)),
                                      err_msg=k)
    for k, tol in (("x", tol_h), ("y", tol_h), ("z", tol_v)):
        np.testing.assert_allclose(got[k], np.asarray(getattr(pj, k)),
                                   rtol=0, atol=tol, err_msg=k)
    want = _final(np.loadtxt(os.path.join(d, "jax_out", "run1.csv"),
                             delimiter=","))
    final = _final(rows)
    np.testing.assert_array_equal(final[:, [1, 5, -1]], want[:, [1, 5, -1]])
    if name == "oyster":
        for k in ("salt", "temp"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(pj, k)),
                                       rtol=0, atol=tol_s, err_msg=k)
        status = got["status"]
        assert (status == jst.SETTLED).sum() > 0 and (status == jst.DEAD
                                                       ).sum() > 0
    else:
        assert np.abs(got["z"] - got["z"].mean()).max() > 1.0


def test_cli_packed_route_independent_of_chunking(cli_runs):
    rows2 = cli_runs("oyster", "float32", fuse=2)[3]
    lines4, rows4 = cli_runs("oyster", "float32")[2:]
    assert [ln["n_fused"] for ln in lines4[1:]] == [4]
    np.testing.assert_array_equal(_final(rows2), _final(rows4))
