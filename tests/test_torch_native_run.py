"""The CLI on the native route: ``ltjax_torch.run.run(cfg, device="cpu")``
against ``ltjax.run.run(cfg)`` on the same run files, with
``fast_interp = False`` and with ``tension_sigma = -1`` (adaptive
tension).

The run: a 15 x 15 planar solid-body series (us 5, float32 fields on
disk, the parabolic AKs profile), 120 particles, 2 external steps of 3
internal steps, horizontal and Visser vertical turbulence (seed 5), CSV
output, ``dtype_field = "float64"``.  Both packages read the same
float32 records, widen them to float64 and step in float64 (the files'
default ``dtype_pos``) through the same formulas in the same order:
1e-8 m horizontally and 1e-10 m vertically, statuses equal.  The
startup line names the route ("native") and the lanes
(``adaptive_tension`` under a negative sigma).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from ltjax import run as jrun
from ltjax.config import config_from_namelist as j_config
from ltjax_torch import run as trun
from ltjax_torch import synth
from ltjax_torch.config import config_from_namelist

torch.set_num_threads(1)

OPTIONS = {"fast_interp_off": dict(fast_interp=False),
           "adaptive_tension": dict(tension_sigma=-1.0)}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_cli_native_route_matches_ltjax_run(name, tmp_path):
    case = synth.make_solid_body_case(nx=15, ny=15, us=5, lx=20e3, ly=20e3,
                                      h0=30.0, omega=1e-4,
                                      dtype=torch.float64,
                                      parabolic_aks=True)
    rng = np.random.default_rng(22)
    n = 120
    d = str(tmp_path)
    nml = synth.write_run_files(
        case, d, rng.uniform(5e3, 15e3, n), rng.uniform(5e3, 15e3, n),
        rng.uniform(-25.0, -3.0, n), n_ext=2, dt=1800, idt=600,
        iprint=2 * 1800, HTurbOn=True, ConstantHTurb=1.0, VTurbOn=True,
        readAks=True, seed=5, dtype_field="float64", **OPTIONS[name])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pt = trun.run(config_from_namelist(nml), device="cpu")
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith("{")]
    assert lines[0]["route"] == "native" and lines[0]["path"] == "plain"
    assert lines[0]["dtype_pos"] == "float64"
    lanes = ["advection", "hturb", "vturb_aks"]
    if name == "adaptive_tension":
        lanes.insert(1, "adaptive_tension")
    assert lines[0]["lanes"] == lanes
    assert lines[-1]["error"] == 0 and lines[-1]["active"] == n
    pj = jrun.run(j_config(nml, outpath=os.path.join(d, "jax_out")))
    order = np.argsort(pt.pid.numpy())
    np.testing.assert_array_equal(pt.status.numpy()[order],
                                  np.asarray(pj.status))
    for k, tol in (("x", 1e-8), ("y", 1e-8), ("z", 1e-10)):
        np.testing.assert_allclose(getattr(pt, k).numpy()[order],
                                   np.asarray(getattr(pj, k)), rtol=0,
                                   atol=tol)
    assert np.abs(pt.z.numpy() - pt.z.numpy().mean()).max() > 0.1
