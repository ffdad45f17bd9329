"""Checkpoint / resume and BoundaryBLNs in the port, against ltjax.

* ``ltjax_torch.checkpoint`` writes and reads ltjax's npz format: a
  checkpoint saved by either package loads in the other, array for array
  (exact, every column and dtype) with the same meta; ``latest`` picks
  the same file.
* ``io.roms.RomsSeries.seek`` puts the cursor where ltjax's seek does
  (the same record comes next, bit for bit).
* The CLI (``python -m ltjax_torch.run --device cpu`` in a process
  without jax) with ``checkpoint_every = 2`` over 4 external steps, the
  last checkpoint deleted and the run repeated with ``--resume``, ends
  with the uninterrupted run's particles, bit for bit (turbulence on:
  the draws are counter-based), and so does a run without checkpoints in
  one chunk of 4.  A checkpoint written by ``ltjax.run`` resumes in the
  port and ends within the CLI's float32 tolerance of ltjax's own end
  (0.5 m; statuses equal), the tolerance of tests/test_torch_run.py (the
  two packages interpolate float32 fields by different schemes).
* ``BoundaryBLNs`` writes xyBounds.csv and llBounds.csv text-equal to
  ltjax's ``dump_boundaries`` on the same grid, planar and geographic,
  and so does the CLI.
"""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltjax import checkpoint as jckpt
from ltjax import convert as jconvert
from ltjax import run as jrun
from ltjax import state as jst
from ltjax.config import config_from_namelist as j_config
from ltjax.io.roms import RomsSeries as JSeries
from ltjax.physics import boundary as jbd
from ltjax_torch import checkpoint as ckpt
from ltjax_torch import convert
from ltjax_torch import state as st
from ltjax_torch import synth
from ltjax_torch.config import config_from_namelist
from ltjax_torch.io.roms import RomsSeries
from ltjax_torch.physics import boundary as bd

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_JAX = ("import runpy, sys; sys.modules['jax'] = None; "
          "sys.argv = ['ltjax_torch.run'] + sys.argv[1:]; "
          "runpy.run_module('ltjax_torch.run', run_name='__main__')")
DT = 1800


def _cli(nml, *args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", NO_JAX, nml, "--device", "cpu",
                        *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.uniform(0, 3e4, n), y=rng.uniform(0, 3e4, n),
        z=rng.uniform(-30, 0, n), dob=rng.choice([0.0, 900.0], n),
        age=rng.uniform(0, 9e3, n),
        status=rng.integers(0, 6, n).astype(np.int32),
        pid=rng.permutation(n).astype(np.int32),
        settle_poly=rng.integers(-1, 3, n).astype(np.int32),
        hit_land=rng.integers(0, 4, n).astype(np.int32),
        hit_bottom=rng.integers(0, 4, n).astype(np.int32),
        salt=rng.uniform(20, 30, n), temp=rng.uniform(10, 20, n))


@pytest.mark.parametrize("direction", ["ltjax-to-port", "port-to-ltjax"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    cols = _columns(97, seed=1)
    path = str(tmp_path / "ckpt_6.npz")
    extra = {"t_base": 123.5}
    if direction == "ltjax-to-port":
        jckpt.save(path, jst.Particles(**{k: jnp.asarray(v)
                                          for k, v in cols.items()}),
                   6, 9, extra=extra)
        p, ext, rec, ex = ckpt.load(path)
        got = {k: getattr(p, k).numpy() for k in cols}
    else:
        ckpt.save(path, st.Particles(**{k: torch.as_tensor(v)
                                        for k, v in cols.items()}),
                  6, 9, extra=extra)
        p, ext, rec, ex = jckpt.load(path)
        got = {k: np.asarray(getattr(p, k)) for k in cols}
    assert (ext, rec, ex) == (6, 9, extra)
    for k, v in cols.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_latest_matches_ltjax(tmp_path):
    assert ckpt.latest(str(tmp_path / "none")) is None
    assert ckpt.latest(str(tmp_path)) is None
    for name in ("ckpt_2.npz", "ckpt_10.npz", "ckpt_x.npz", "other_40.npz",
                 "ckpt_7_h001.npz"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.latest(str(tmp_path)) == str(tmp_path / "ckpt_10.npz")
    for tag in ("", "_h001"):
        assert ckpt.latest(str(tmp_path), tag) == jckpt.latest(str(tmp_path),
                                                               tag)


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("seek"))
    case = synth.make_solid_body_case(nx=9, ny=9, us=3, lx=8e3, ly=8e3,
                                      h0=20.0, omega=1e-4,
                                      dtype=torch.float64)
    nml = synth.write_run_files(case, d, [4e3], [4e3], [-5.0], n_ext=8,
                                dt=DT, idt=450)
    return nml


@pytest.mark.parametrize("record", [0, 3, 4, 7, 9])
def test_series_seek_matches_ltjax(series, record):
    """tdim = 4 records a file: records 3 and 4 straddle a file."""
    port, ref = (RomsSeries(config_from_namelist(series)),
                 JSeries(j_config(series)))
    for s in (port, ref):
        s.seek(record)
    a, b = port.next_record(), ref.next_record()
    assert (port.file_idx, port.rec_idx) == (ref.file_idx, ref.rec_idx)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    port.close()
    ref.close()


def _run_files(d, **kw):
    case = synth.make_solid_body_case(nx=31, ny=31, us=6, lx=30e3, ly=30e3,
                                      h0=40.0, omega=1e-4,
                                      dtype=torch.float64, parabolic_aks=True)
    rng = np.random.default_rng(21)
    n = 120
    x0, y0 = rng.uniform(8e3, 22e3, n), rng.uniform(8e3, 22e3, n)
    z0 = rng.uniform(-35.0, -3.0, n)
    return synth.write_run_files(case, d, x0, y0, z0, n_ext=4, dt=DT,
                                 idt=450, iprint=4 * DT, **kw)


TURB = dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True, readAks=True,
            seed=11)


def test_cli_resume_equals_unsplit_run(tmp_path):
    """checkpoint_every = 2 over 4 external steps (default ext_fuse 8:
    the chunks clamp to 2); the last checkpoint deleted, --resume from
    the first ends with the same particles as the uninterrupted run, and
    as a run without checkpoints (one chunk of 4)."""
    d = str(tmp_path / "split")
    cdir = os.path.join(d, "ckpt")
    nml = _run_files(d, checkpoint_every=2, checkpoint_dir=cdir,
                     BoundaryBLNs=True, **TURB)
    lines = _cli(nml)
    assert [ln["n_fused"] for ln in lines[1:]] == [2, 2]
    assert sorted(os.listdir(cdir)) == ["ckpt_2.npz", "ckpt_4.npz"]
    full = ckpt.load(os.path.join(cdir, "ckpt_4.npz"))
    os.remove(os.path.join(cdir, "ckpt_4.npz"))
    resumed = _cli(nml, "--resume")
    assert resumed[0]["dtype_pos"] == "float64"
    assert [(ln["ext"], ln["n_fused"]) for ln in resumed[1:]] == [(2, 2)]
    again = ckpt.load(os.path.join(cdir, "ckpt_4.npz"))
    assert again[1:] == full[1:]
    assert full[0].x.dtype == torch.float64
    nml1 = _run_files(str(tmp_path / "one"), ext_fuse=4, **TURB)
    _cli(nml1)
    rows = np.loadtxt(os.path.join(tmp_path, "one", "out", "run1.csv"),
                      delimiter=",")
    last = rows[rows[:, 0] == rows[:, 0].max()]
    last = last[np.argsort(last[:, 1])]
    p = full[0]
    for k in ("x", "y", "z", "status", "age", "dob", "hit_land",
              "hit_bottom"):
        np.testing.assert_array_equal(getattr(again[0], k).numpy(),
                                      getattr(p, k).numpy())
    # the CSV's final snapshot of the unchunked run (lon lat = x y here)
    np.testing.assert_allclose(last[:, 2], p.x.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(last[:, 3], p.y.numpy(), rtol=0, atol=1e-3)


def test_cli_resumes_ltjax_checkpoint(tmp_path):
    """ltjax.run writes ckpt_2 and ckpt_4; the port resumes from ltjax's
    ckpt_2 and ends within 0.5 m of ltjax's ckpt_4, statuses equal."""
    d = str(tmp_path)
    cdir = os.path.join(d, "ckpt")
    nml = _run_files(d, checkpoint_every=2, checkpoint_dir=cdir)
    jdir = os.path.join(d, "ckpt_ltjax")
    jrun.run(j_config(nml, checkpoint_dir=jdir,
                      outpath=os.path.join(d, "jax_out")))
    os.makedirs(cdir)
    shutil.copy(os.path.join(jdir, "ckpt_2.npz"), cdir)
    lines = _cli(nml, "--resume")
    assert [ln["ext"] for ln in lines[1:]] == [2]
    ours = ckpt.load(os.path.join(cdir, "ckpt_4.npz"))
    ref = jckpt.load(os.path.join(jdir, "ckpt_4.npz"))
    assert ours[1:3] == ref[1:3]
    assert ours[3]["t_base"] == ref[3]["t_base"]
    for k in ("x", "y"):
        np.testing.assert_allclose(getattr(ours[0], k).numpy(),
                                   np.asarray(getattr(ref[0], k)), rtol=0,
                                   atol=0.5)
    np.testing.assert_array_equal(ours[0].status.numpy(),
                                  np.asarray(ref[0].status))


def _mask():
    mask = np.ones((12, 15), np.int32)
    mask[4:7, 6:9] = 0
    mask[0, :3] = 0
    return mask


@pytest.mark.parametrize("geographic", [False, True],
                         ids=["planar", "geographic"])
def test_boundary_blns_match_ltjax(tmp_path, geographic):
    x = np.linspace(0.0, 14e3, 15)
    y = np.cumsum(np.r_[0.0, np.linspace(900.0, 1300.0, 11)])
    lonmin, latmin = -76.0, 37.0
    ours = bd.build_boundaries(_mask(), x, y)
    ref = jbd.build_boundaries(_mask(), x, y)

    def lonlat(mod):
        if not geographic:
            return None
        return lambda a, b: (mod.x2lon(a, b, lonmin, latmin),
                             mod.y2lat(b, latmin))

    bd.dump_boundaries(ours, str(tmp_path / "port"), lonlat(convert))
    jbd.dump_boundaries(ref, str(tmp_path / "ltjax"), lonlat(jconvert))
    names = ["xyBounds.csv"] + (["llBounds.csv"] if geographic else [])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(names)
    for name in names:
        a = (tmp_path / "port" / name).read_text()
        assert a == (tmp_path / "ltjax" / name).read_text()
        assert a.count("LAND") > 0 and a.count("OPEN") > 0


def test_cli_boundary_blns_match_ltjax(tmp_path):
    """The CLI's BoundaryBLNs files equal ltjax's dump of the grid and
    boundaries ltjax.run builds from the same run file."""
    d = str(tmp_path)
    nml = _run_files(d, BoundaryBLNs=True)
    _cli(nml)
    cfg = j_config(nml)
    ctx = jrun.build_context(cfg, jrun.load_grid(cfg))
    jbd.dump_boundaries(ctx.bounds, os.path.join(d, "ref"), to_lonlat=(
        lambda a, b: (jconvert.x2lon(a, b, cfg.lonmin, cfg.latmin,
                                     cfg.Earth_Radius,
                                     cfg.SphericalProjection),
                      jconvert.y2lat(b, cfg.latmin, cfg.Earth_Radius,
                                     cfg.SphericalProjection))))
    for name in ("xyBounds.csv", "llBounds.csv"):
        with open(os.path.join(d, "out", name)) as f, \
                open(os.path.join(d, "ref", name)) as g:
            assert f.read() == g.read()
