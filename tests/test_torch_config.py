"""The port's own host modules against ltjax's, and the port's imports.

* ``ltjax_torch.namelist`` / ``.config`` parse the ``&group ... /`` and
  ``$group ... $end`` namelists of tests/test_namelist.py, and one
  written by ``ltjax_torch.synth.write_run_files`` with settlement and
  salt keys, to a Config equal to ltjax's field by field;
  ``needs_salt_fields`` and ``validate`` agree.
* ``ltjax_torch.io.roms.read_grid`` synthesizes uniform levels for a
  grid file without s-levels, as ``ltjax.io.roms`` does, and
  ``run.load_grid`` accepts it.
* ``run.grid_from_roms`` builds the same curvilinear grid (projected rho
  points, seed raster) as ``ltjax.io.roms.grid_from_roms`` from grid data
  whose lon/lat vary along both axes, geographic or planar.
* No module of ``ltjax_torch`` nor ``chip_smoke.py`` imports ``ltjax`` or
  ``jax`` (an AST scan), and ``ltjax_torch.run`` runs a tiny CLI case in
  a subprocess where both are unimportable, with ``--device cpu``;
  without the flag and without a GPU it refuses to start.
"""

import ast
import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ltjax import config as jconfig
from ltjax import namelist as jnml
from ltjax.io import roms as jroms
from ltjax_torch import config as tconfig
from ltjax_torch import namelist as tnml
from ltjax_torch import run as trun
from ltjax_torch import synth
from ltjax_torch.io import nc as tnc
from ltjax_torch.io import roms as troms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

AMP = """
&numparticles
  numpar = 42
/
&timeparam
  days = 0.5, dt = 3600, idt = 120  ! trailing comment
/
&romsgrid
  NCgridfile = '/data/grid.nc'
/
&turbparam
  HTurbOn = .TRUE.
  ConstantHTurb = 1.5d1
/
&behavparam
  Behavior = 4, readSalt = T, pediage = 2.5D5, Sgradient = 0.4
/
&settleparam
  settlementon = .true., holesExist = .TRUE.
/
"""
DOLLAR = AMP.replace("&", "$").replace("/\n", "$end\n")


def _same_config(path, **kw):
    tc = tconfig.config_from_namelist(path, **kw)
    jc = jconfig.config_from_namelist(path, **kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.needs_salt_fields() == jc.needs_salt_fields()
    return tc


@pytest.mark.parametrize("text", [AMP, DOLLAR], ids=["ampersand", "dollar"])
def test_namelist_and_config_match_ltjax(tmp_path, text):
    assert tnml.parse_namelist(text) == jnml.parse_namelist(text)
    p = tmp_path / "LTRANS.data"
    p.write_text(text)
    cfg = _same_config(str(p), idt=120)
    assert (cfg.numpar, cfg.Behavior, cfg.pediage) == (42, 4, 2.5e5)
    assert cfg.settlementon and cfg.holesExist and cfg.needs_salt_fields()


def test_written_run_namelist_matches_ltjax(tmp_path):
    case = synth.make_solid_body_case(nx=9, ny=9, us=4, lx=8e3, ly=8e3,
                                      halocline=True)
    sq = np.array([[2e3, 2e3], [6e3, 2e3], [6e3, 6e3], [2e3, 6e3]])
    nml = synth.write_run_files(
        case, str(tmp_path), [4e3], [4e3], [-5.0], n_ext=1, dt=600,
        idt=300, habitat=[(7, sq)], holes=[(1, 0.5 * sq + 2e3)],
        Behavior=5, readSalt=True, readTemp=True, SaltTempOn=True,
        pediage=3600.0, Sgradient=0.3)
    cfg = _same_config(nml)
    assert cfg.settlementon and cfg.holesExist and cfg.SaltTempOn
    assert os.path.exists(cfg.habitatfile) and os.path.exists(cfg.holefile)
    # validate agrees on the salinity requirement of behaviors 4/5
    for c in (tconfig.Config, jconfig.Config):
        with pytest.raises(ValueError, match="readSalt"):
            c(Behavior=4).validate()
        c(Behavior=5, readSalt=True).validate()


def test_grid_without_levels_gets_uniform_levels(tmp_path):
    case = synth.make_solid_body_case(nx=9, ny=7, us=5, lx=8e3, ly=6e3,
                                      halocline=True)
    g = case.grid
    path = str(tmp_path / "grid.nc")
    x2 = np.broadcast_to(g.x_rho.numpy(), (7, 9))
    y2 = np.broadcast_to(g.y_rho.numpy()[:, None], (7, 9))
    tnc.write_netcdf(path, dims={"eta_rho": 7, "xi_rho": 9},
                     variables={"x_rho": (("eta_rho", "xi_rho"), x2),
                                "y_rho": (("eta_rho", "xi_rho"), y2),
                                "h": (("eta_rho", "xi_rho"), g.h.numpy())})
    cfg = tconfig.Config(us=5, ws=6, hc=50.0, NCgridfile=path,
                         dtype_pos="float64")
    want = jroms.read_grid(path, jconfig.Config(us=5, ws=6, hc=50.0))
    got = troms.read_grid(path, cfg)
    for k in ("s_rho", "s_w", "Cs_r", "Cs_w", "h", "lon_rho", "lat_rho"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.h.dtype.isnative
    grid = trun.load_grid(cfg, "cpu")
    np.testing.assert_allclose(grid.s_rho.numpy(), want.s_rho, rtol=0,
                               atol=0)
    assert grid.us == 5 and grid.ws == 6


@pytest.mark.parametrize("geographic", [True, False],
                         ids=["geographic", "planar"])
def test_curvilinear_roms_grid_matches_ltjax(geographic):
    import jax.numpy as jnp
    lon, lat = np.meshgrid(np.linspace(-76.0, -75.6, 9),
                           np.linspace(37.0, 37.3, 7))
    if not geographic:
        lon, lat = 4e4 * (lon + 76.0), 4e4 * (lat - 37.0)
    mask = np.ones((7, 9))
    mask[3, 4] = 0
    gd = dict(lon_rho=lon + 0.1 * (lat - lat.min()), lat_rho=lat,
              mask_rho=mask, h=np.full((7, 9), 10.0),
              s_rho=np.array([-0.75, -0.25]), s_w=np.array([-1.0, -0.5, 0.0]),
              Cs_r=np.array([-0.75, -0.25]), Cs_w=np.array([-1.0, -0.5, 0.0]),
              hc=10.0, vtransform=1, geographic=geographic)
    assert not troms.is_rectilinear(troms.RomsGridData(**gd))
    kw = dict(lonmin=-76.0, latmin=37.0, SphericalProjection=geographic)
    want = jroms.grid_from_roms(jroms.RomsGridData(**gd),
                                jconfig.Config(**kw), jnp.float64)
    got = trun.grid_from_roms(troms.RomsGridData(**gd), tconfig.Config(**kw),
                              torch.float64, "cpu")
    assert want.curv is not None and got.curv is not None
    for k in ("xy_flat", "seed_i", "seed_j"):
        np.testing.assert_array_equal(getattr(got.curv, k).numpy(),
                                      np.asarray(getattr(want.curv, k)))
    for k in ("rx0", "ry0", "inv_rdx", "inv_rdy"):
        assert getattr(got.curv, k) == float(getattr(want.curv, k))
    for k in ("x_rho", "y_rho", "h", "mask_rho", "mask_u", "mask_v"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    assert got.uniform is False


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_ltjax_nor_jax():
    files = glob.glob(os.path.join(ROOT, "ltjax_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("ltjax", "jax", "jaxlib")]
    assert bad == []


NO_LTJAX = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['ltjax'] = None; "
            "sys.argv = ['ltjax_torch.run'] + sys.argv[1:]; "
            "runpy.run_module('ltjax_torch.run', run_name='__main__')")


def test_cli_runs_without_ltjax(tmp_path):
    case = synth.make_solid_body_case(nx=11, ny=11, us=4, lx=10e3, ly=10e3,
                                      h0=20.0, halocline=True)
    rng = np.random.default_rng(4)
    n = 20
    nml = synth.write_run_files(
        case, str(tmp_path), rng.uniform(3e3, 7e3, n),
        rng.uniform(3e3, 7e3, n), rng.uniform(-15.0, -5.0, n), n_ext=1,
        dt=600, idt=300, habitat=[(3, np.array([[4e3, 4e3], [6e3, 4e3],
                                               [6e3, 6e3], [4e3, 6e3]]))],
        SaltTempOn=True, readSalt=True, readTemp=True)
    r = subprocess.run([sys.executable, "-c", NO_LTJAX, nml, "--device",
                        "cpu"], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    first = json.loads(r.stdout.splitlines()[0])
    assert first["lanes"] == ["advection", "settlement", "salt_temp"]
    rows = np.loadtxt(os.path.join(tmp_path, "out", "run1.csv"),
                      delimiter=",")
    # time id lon lat depth status salt temp age poly: salt sampled
    assert rows.shape[1] == 10 and (rows[rows[:, 0] > 0, 6] > 20.0).all()


def test_cli_refuses_to_start_without_gpu(tmp_path):
    """Without a CUDA device and without --device cpu the CLI stops with
    a message naming the flag: it never carries on on the CPU."""
    case = synth.make_solid_body_case(nx=9, ny=9, us=4, lx=8e3, ly=8e3)
    nml = synth.write_run_files(case, str(tmp_path), [4e3], [4e3], [-5.0],
                                n_ext=1, dt=600, idt=300)
    r = subprocess.run([sys.executable, "-c", NO_LTJAX, nml], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT,
                                CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert r.stdout == ""
    assert not os.path.exists(os.path.join(tmp_path, "out", "run1.csv"))


def test_run_sharded_refuses_to_start_without_gpu(tmp_path, monkeypatch):
    """run_sharded without a device takes the GPU, as run does: without a
    CUDA device it raises naming device='cpu', before it spawns a rank or
    writes a file; with device='cpu' it gets past that check."""
    case = synth.make_solid_body_case(nx=9, ny=9, us=4, lx=8e3, ly=8e3)
    nml = synth.write_run_files(case, str(tmp_path), [4e3], [4e3], [-5.0],
                                n_ext=1, dt=600, idt=300, mesh_particles=2)
    cfg = tconfig.config_from_namelist(nml)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device") as e:
        trun.run_sharded(cfg)
    assert "device='cpu'" in str(e.value)
    assert not os.path.exists(os.path.join(tmp_path, "out"))
    with pytest.raises(ValueError, match="NCCL"):
        trun.run_sharded(cfg, device="cpu", backend="nccl")
