"""The port's CLI end to end: ``python -m ltjax_torch.run LTRANS.data`` on a
planar synthetic ROMS series (NetCDF3) + parfile, CSV output.

The run happens in a subprocess that first sets ``sys.modules["jax"] =
None``, which proves the port never imports jax.  Its final positions
are held against ``ltjax.run.run`` on the same namelist and against the
closed-form solid-body trajectory.  The fields are float32 on disk, and
ltjax's CPU path interpolates with another scheme (fit-then-blend
column splines), so both comparisons use the float32 horizontal
tolerance 0.5 m; statuses equal.
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
    r = subprocess.run([sys.executable, "-c", NO_JAX, nml], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    rows = np.loadtxt(os.path.join(d, "out", "run1.csv"), delimiter=",")
    return case, nml, d, (x0, y0, z0), lines, rows


def _final(rows):
    last = rows[rows[:, 0] == rows[:, 0].max()]
    return last[np.argsort(last[:, 1])]


def test_cli_runs_without_jax(run_case):
    case, nml, d, (x0, y0, z0), lines, rows = run_case
    assert lines[0]["path"] == "plain" and lines[0]["uniform"] is True
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
