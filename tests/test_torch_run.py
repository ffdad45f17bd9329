"""The port's CLI end to end: ``python -m ltjax_torch.run LTRANS.data`` on a
planar synthetic ROMS series (NetCDF3) + parfile, CSV output.

The run happens in a subprocess that first sets ``sys.modules["jax"] =
None``, which proves the port never imports jax, and asks for the CPU
(``--device cpu``).  Its final positions
are held against ``ltjax.run.run`` on the same namelist and against the
closed-form solid-body trajectory.  The fields are float32 on disk, and
ltjax's CPU path interpolates with another scheme (fit-then-blend
column splines), so both comparisons use the float32 horizontal
tolerance 0.5 m; statuses equal.

A turbulent run (HTurbOn, VTurbOn on the series' parabolic AKs profile)
and a diel-vertical-migration run (Behavior 3) go through the same
entry point: the startup line names their lanes, the turbulent
trajectories do not depend on how the external steps are chunked
(``ext_fuse`` 2 and 4 give the same particles, bit for bit: the random
draws are keyed by the global step index), and they follow ltjax.run's
draws (same seed, same streams) to the same 0.5 m / 1e-3 m tolerance.

The oyster run (behavior 4 on a halocline, SaltTempOn, settlement on a
habitat square with a hole and a slanted triangle written as polygon
CSVs, HTurb, Visser on Aks, mortality, pediage inside the run) does not
depend on the chunking either, and its CSV's statuses and settle_poly
equal ltjax.run's, salt and temp within 0.01 psu / degC (the positions
differ by the two interpolation schemes, and dS/dz reaches 1.7 psu/m).

A turbulent run with stochastic mortality takes the per-step route (the
startup line says so), gives the same particles in chunks of 2 and of 4,
kills some of them, and follows ltjax.run's draws: the same particles
die (the DEATH draws are bit-equal) and the positions agree to 0.5 m /
1e-3 m.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ltjax import run as jrun
from ltjax.config import config_from_namelist
from ltjax_torch import synth

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EXT = 3
DT = 1800
NO_JAX = ("import runpy, sys; sys.modules['jax'] = None; "
          "sys.argv = ['ltjax_torch.run'] + sys.argv[1:]; "
          "runpy.run_module('ltjax_torch.run', run_name='__main__')")


@pytest.fixture(scope="module")
def run_case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_run"))
    case = synth.make_solid_body_case(nx=31, ny=31, us=6, lx=30e3, ly=30e3,
                                      h0=40.0, omega=1e-4,
                                      dtype=torch.float64)
    rng = np.random.default_rng(12)
    n = 200
    x0 = rng.uniform(8e3, 22e3, n)
    y0 = rng.uniform(8e3, 22e3, n)
    z0 = rng.uniform(-35.0, -3.0, n)
    # two fused external steps, then one: an output at the end only
    nml = synth.write_run_files(case, d, x0, y0, z0, n_ext=N_EXT, dt=DT,
                                idt=450, iprint=N_EXT * DT, ext_fuse=2)
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", NO_JAX, nml, "--device",
                        "cpu"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    rows = np.loadtxt(os.path.join(d, "out", "run1.csv"), delimiter=",")
    return case, nml, d, (x0, y0, z0), lines, rows


def _run_cli(nml):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", NO_JAX, nml, "--device",
                        "cpu"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]


TURB = dict(HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True, readAks=True,
            seed=11)


@pytest.fixture(scope="module")
def turb_runs(tmp_path_factory):
    """The same turbulent series in chunks of 2 and of 4 external steps."""
    case = synth.make_solid_body_case(nx=31, ny=31, us=6, lx=30e3, ly=30e3,
                                      h0=40.0, omega=1e-4,
                                      dtype=torch.float64, parabolic_aks=True)
    rng = np.random.default_rng(13)
    n = 150
    x0 = rng.uniform(8e3, 22e3, n)
    y0 = rng.uniform(8e3, 22e3, n)
    z0 = rng.uniform(-35.0, -3.0, n)
    out = {}
    for fuse in (2, 4):
        d = str(tmp_path_factory.mktemp(f"torch_turb{fuse}"))
        nml = synth.write_run_files(case, d, x0, y0, z0, n_ext=4, dt=DT,
                                    idt=450, iprint=4 * DT, ext_fuse=fuse,
                                    **TURB)
        out[fuse] = (nml, d, _run_cli(nml),
                     np.loadtxt(os.path.join(d, "out", "run1.csv"),
                                delimiter=","))
    return case, (x0, y0, z0), out


STOCHASTIC = dict(TURB, mortality=True, stochastic_mortality=True,
                  deadage=5400.0)


@pytest.fixture(scope="module")
def stochastic_runs(tmp_path_factory):
    """A turbulent series with stochastic mortality in chunks of 2 and of
    4 external steps."""
    case = synth.make_solid_body_case(nx=31, ny=31, us=6, lx=30e3, ly=30e3,
                                      h0=40.0, omega=1e-4,
                                      dtype=torch.float64, parabolic_aks=True)
    rng = np.random.default_rng(16)
    n = 150
    x0 = rng.uniform(8e3, 22e3, n)
    y0 = rng.uniform(8e3, 22e3, n)
    z0 = rng.uniform(-35.0, -3.0, n)
    out = {}
    for fuse in (2, 4):
        d = str(tmp_path_factory.mktemp(f"torch_stochastic{fuse}"))
        nml = synth.write_run_files(case, d, x0, y0, z0, n_ext=4, dt=DT,
                                    idt=450, iprint=4 * DT, ext_fuse=fuse,
                                    **STOCHASTIC)
        out[fuse] = (nml, d, _run_cli(nml),
                     np.loadtxt(os.path.join(d, "out", "run1.csv"),
                                delimiter=","))
    return out


def test_cli_stochastic_mortality_run(stochastic_runs):
    lines2, rows2 = stochastic_runs[2][2], stochastic_runs[2][3]
    lines4, rows4 = stochastic_runs[4][2], stochastic_runs[4][3]
    assert lines4[0]["route"] == "per_step" and lines4[0]["path"] == "plain"
    assert lines4[0]["lanes"] == ["advection", "hturb", "vturb_aks",
                                  "mortality"]
    np.testing.assert_array_equal(_final(rows2), _final(rows4))
    status = _final(rows4)[:, 5]
    # p = 1 - exp(-450/5400) per step over 16 steps: ~74% dead
    assert 0 < (status == 3).sum() < len(status)
    assert lines4[-1]["dead"] == (status == 3).sum()


def test_cli_stochastic_mortality_run_matches_ltjax_run(stochastic_runs):
    nml, d, _, rows = stochastic_runs[4]
    cfg = config_from_namelist(nml, outpath=os.path.join(d, "jax_out"))
    pj = jrun.run(cfg)
    final = _final(rows)
    np.testing.assert_array_equal(final[:, 5], np.asarray(pj.status))
    np.testing.assert_allclose(final[:, 2], np.asarray(pj.x), rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(final[:, 3], np.asarray(pj.y), rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(final[:, 4], np.asarray(pj.z), rtol=0,
                               atol=1e-3)


def test_cli_turbulent_run_independent_of_chunking(turb_runs):
    case, (x0, y0, z0), out = turb_runs
    lines2, rows2 = out[2][2], out[2][3]
    lines4, rows4 = out[4][2], out[4][3]
    assert lines2[0]["lanes"] == ["advection", "hturb", "vturb_aks"]
    assert lines2[0]["seed"] == 11
    assert [ln["n_fused"] for ln in lines2[1:]] == [2, 2]
    assert [ln["n_fused"] for ln in lines4[1:]] == [4]
    np.testing.assert_array_equal(_final(rows2), _final(rows4))
    # turbulence moved the particles off the closed-form trajectory
    final = _final(rows4)
    xa, ya, _ = case.analytic(x0, y0, z0, 4 * DT)
    assert np.hypot(final[:, 2] - xa, final[:, 3] - ya).min() > 1.0
    assert np.abs(final[:, 4] - z0).max() > 1.0


def test_cli_turbulent_run_matches_ltjax_run(turb_runs):
    _, _, out = turb_runs
    nml, d, _, rows = out[4]
    cfg = config_from_namelist(nml, outpath=os.path.join(d, "jax_out"))
    pj = jrun.run(cfg)
    final = _final(rows)
    np.testing.assert_array_equal(final[:, 5], np.asarray(pj.status))
    np.testing.assert_allclose(final[:, 2], np.asarray(pj.x), rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(final[:, 3], np.asarray(pj.y), rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(final[:, 4], np.asarray(pj.z), rtol=0,
                               atol=1e-3)


def test_cli_dvm_run(tmp_path):
    case = synth.make_solid_body_case(nx=21, ny=21, us=6, lx=20e3, ly=20e3,
                                      h0=40.0, omega=1e-4,
                                      dtype=torch.float64)
    rng = np.random.default_rng(14)
    n = 100
    z0 = rng.uniform(-35.0, -3.0, n)
    nml = synth.write_run_files(
        case, str(tmp_path), rng.uniform(6e3, 14e3, n),
        rng.uniform(6e3, 14e3, n), z0, n_ext=2, dt=DT, idt=450,
        iprint=2 * DT, Behavior=3, swimslow=1e-3, swimfast=3e-3,
        pediage=5e6, mortality=True, deadage=1800.0)
    lines = _run_cli(nml)
    assert lines[0]["lanes"] == ["advection", "behavior3", "mortality"]
    final = _final(np.loadtxt(os.path.join(tmp_path, "out", "run1.csv"),
                              delimiter=","))
    # the night-time random walk moved them; all died at the 30 min death
    # age (the pre-step age reaches it in the second external step)
    assert np.abs(final[:, 4] - z0).max() > 0.1
    assert (final[:, 5] == 3).all() and lines[-1]["dead"] == n


def _final(rows):
    last = rows[rows[:, 0] == rows[:, 0].max()]
    return last[np.argsort(last[:, 1])]


def test_cli_runs_without_jax(run_case):
    case, nml, d, (x0, y0, z0), lines, rows = run_case
    assert lines[0]["path"] == "plain" and lines[0]["uniform"] is True
    assert lines[0]["route"] == "ext_step"
    assert [ln["n_fused"] for ln in lines[1:]] == [2, 1]
    assert lines[-1]["active"] == len(x0) and lines[-1]["error"] == 0
    # two snapshots: t = 0 and the end of the run
    assert sorted(set(rows[:, 0])) == [0.0, float(N_EXT * DT)]
    first = rows[rows[:, 0] == 0.0]
    np.testing.assert_allclose(first[:, 2], x0, rtol=0, atol=1e-6)
    final = _final(rows)
    xa, ya, _ = case.analytic(x0, y0, z0, N_EXT * DT)
    np.testing.assert_allclose(final[:, 2], xa, rtol=0, atol=0.5)
    np.testing.assert_allclose(final[:, 3], ya, rtol=0, atol=0.5)
    np.testing.assert_allclose(final[:, 4], z0, rtol=0, atol=1e-3)


def test_cli_matches_ltjax_run(run_case):
    case, nml, d, _, _, rows = run_case
    cfg = config_from_namelist(nml, outpath=os.path.join(d, "jax_out"))
    pj = jrun.run(cfg)
    final = _final(rows)
    np.testing.assert_allclose(final[:, 2], np.asarray(pj.x), rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(final[:, 3], np.asarray(pj.y), rtol=0,
                               atol=0.5)
    np.testing.assert_array_equal(final[:, 5], np.asarray(pj.status))


OYSTER = dict(Behavior=4, readSalt=True, readTemp=True, SaltTempOn=True,
              Sgradient=0.5, swimslow=1e-3, swimfast=3e-3, pediage=1800.0,
              HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True, readAks=True,
              mortality=True, deadage=6300.0, seed=3)


def oyster_polygons():
    """A habitat square with a square hole and a slanted triangle (metres,
    on the 30 km oyster case)."""
    habitat = [(21, np.array([[9e3, 9e3], [17e3, 9e3], [17e3, 17e3],
                              [9e3, 17e3]])),
               (22, np.array([[18e3, 12e3], [24e3, 14e3], [19e3, 20e3]]))]
    holes = [(1, np.array([[12e3, 12e3], [14e3, 12e3], [14e3, 14e3],
                           [12e3, 14e3]]))]
    return habitat, holes


@pytest.fixture(scope="module")
def oyster_runs(tmp_path_factory):
    case = synth.make_solid_body_case(nx=31, ny=31, us=6, lx=30e3, ly=30e3,
                                      h0=40.0, omega=1e-4,
                                      dtype=torch.float64, parabolic_aks=True,
                                      halocline=True)
    rng = np.random.default_rng(15)
    n = 150
    x0 = rng.uniform(8e3, 22e3, n)
    y0 = rng.uniform(8e3, 22e3, n)
    z0 = rng.uniform(-16.0, -4.0, n)
    habitat, holes = oyster_polygons()
    out = {}
    for fuse in (2, 4):
        d = str(tmp_path_factory.mktemp(f"torch_oyster{fuse}"))
        nml = synth.write_run_files(case, d, x0, y0, z0, n_ext=4, dt=DT,
                                    idt=450, iprint=4 * DT, ext_fuse=fuse,
                                    habitat=habitat, holes=holes, **OYSTER)
        out[fuse] = (nml, d, _run_cli(nml),
                     np.loadtxt(os.path.join(d, "out", "run1.csv"),
                                delimiter=","))
    return out


def test_cli_oyster_run_independent_of_chunking(oyster_runs):
    lines2, rows2 = oyster_runs[2][2], oyster_runs[2][3]
    lines4, rows4 = oyster_runs[4][2], oyster_runs[4][3]
    assert lines4[0]["lanes"] == ["advection", "hturb", "vturb_aks",
                                  "behavior4", "mortality", "settlement",
                                  "salt_temp"]
    np.testing.assert_array_equal(_final(rows2), _final(rows4))
    # columns: time id lon lat depth status salt temp age poly
    final = _final(rows4)
    status, poly = final[:, 5], final[:, 9]
    assert set(poly[status == 2]) == {21, 22} and (poly[status != 2] < 0
                                                   ).all()
    assert (status == 3).sum() > 0 and lines4[-1]["settled"] > 0
    assert np.ptp(final[:, 6]) > 1.0 and (final[:, 7] > 8.0).all()


def test_cli_oyster_run_matches_ltjax_run(oyster_runs):
    nml, d, _, rows = oyster_runs[4]
    cfg = config_from_namelist(nml, outpath=os.path.join(d, "jax_out"))
    jrun.run(cfg)
    want = _final(np.loadtxt(os.path.join(d, "jax_out", "run1.csv"),
                             delimiter=","))
    final = _final(rows)
    assert want.shape == final.shape
    for col in (1, 5, 9):                      # id, status, settle_poly
        np.testing.assert_array_equal(final[:, col], want[:, col])
    for col in (6, 7):                         # salt, temp
        np.testing.assert_allclose(final[:, col], want[:, col], rtol=0,
                                   atol=0.01)
    np.testing.assert_allclose(final[:, 4], want[:, 4], rtol=0, atol=1e-3)
