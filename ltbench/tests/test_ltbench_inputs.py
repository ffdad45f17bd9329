"""The benchmark's inputs repeat from the seed, and the configurations
and traffic mixes are found by name from data alone."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import ltbench_tiny
import parent_inputs
from ltbench import cell as cl, inputs
from ltbench.run import load_reader

CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", ["advect-1m", "oyster",
                                      "advect-sheared-1m",
                                      "tiles-10m-4chip"])
def test_inputs_repeat_from_the_seed(tmp_path, workload):
    root = ltbench_tiny.make(tmp_path)
    c = cl.find_cell(workload, root)
    a, b = (cl.make_inputs(c, 2 ** 31 + 7, CPU) for _ in range(2))
    other = cl.make_inputs(c, 2 ** 31 + 8, CPU)
    for k in ("x", "y", "z"):
        assert torch.equal(getattr(a.release, k), getattr(b.release, k))
        assert not torch.equal(getattr(a.release, k),
                               getattr(other.release, k))
    for x, y in zip(a.records.columns(), b.records.columns()):
        assert torch.equal(x, y)
    r = c.traffic["release"]
    for k in ("x", "y", "z"):
        v = getattr(a.release, k)
        assert v.dtype == torch.float64
        assert r[k][0] <= float(v.min()) and float(v.max()) <= r[k][1]
    assert torch.equal(inputs.sample_rows(1000, 64, 5),
                       inputs.sample_rows(1000, 64, 5))
    assert len(set(inputs.sample_rows(1000, 64, 5).tolist())) == 64


@pytest.mark.parametrize("workload", ["advect-1m", "advect-sheared-1m",
                                      "tiles-10m-4chip"])
def test_the_box_cells_inputs_are_the_parents(tmp_path, workload):
    """The accepted cells' grid arrays, records and release, made through
    the harness's dispatch on the grid and release kinds, equal the
    parent's code path (``parent_inputs``) bit for bit at the test
    size."""
    root = ltbench_tiny.make(tmp_path)
    c = cl.find_cell(workload, root)
    new = cl.make_inputs(c, 2 ** 31 + 77, CPU)
    ga, rec, rel = parent_inputs.make_inputs(c, 2 ** 31 + 77, CPU)
    for f in dataclasses.fields(ga):
        a, b = getattr(new.grid, f.name), getattr(ga, f.name)
        assert type(a) is type(b), f.name
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    for a, b in zip(new.records.columns(), rec.columns()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k in ("x", "y", "z"):
        assert torch.equal(getattr(new.release, k), getattr(rel, k))
    assert new.release.age == rel.age


def test_records_are_the_solid_body_case():
    ga = inputs.grid_arrays({"nx": 11, "ny": 9, "lx": 10e3, "ly": 8e3,
                             "h0": 20.0}, {"us": 4})
    rec = inputs.make_records(ga, {"omega": 1e-4, "shear_a": 0.01,
                                   "halocline": True, "parabolic_aks": True},
                              3, 3600.0, torch.float64, CPU)
    assert rec.u.shape == (3, 9, 10, 4) and rec.v.shape == (3, 8, 11, 4)
    assert rec.w.shape == (3, 9, 11, 5) and rec.salt.shape == (3, 9, 11, 4)
    # u = -omega (y - yc) (1 + a z) at the u points of row 0, level 0
    z0 = 20.0 * ga.s_rho[0]
    assert float(rec.u[0, 0, 0, 0]) == pytest.approx(
        -1e-4 * (0.0 - 4e3) * (1 + 0.01 * z0))
    assert torch.equal(rec.times, torch.tensor([-1800.0, 1800.0, 5400.0],
                                               dtype=torch.float64))
    assert float(rec.aks.min()) == pytest.approx(1e-4)
    assert not torch.equal(rec.salt[0], rec.salt[1])    # the tide heaves it


def test_records_follow_the_tide():
    """With a ``tide`` every record differs from the next: u and v scaled
    by 1 + A cos(phi), zeta heaving, w zero at the bed and the surface
    and not elsewhere."""
    ga = inputs.grid_arrays({"nx": 11, "ny": 9, "lx": 10e3, "ly": 8e3,
                             "h0": 20.0}, {"us": 4})
    tide = {"omega_amp": 0.3, "zeta_m": 0.5, "w_mps": 5e-4,
            "phase_rad": 0.7}
    rec = inputs.make_records(ga, {"omega": 1e-4, "tide": tide}, 4, 3600.0,
                              torch.float64, CPU)
    for k in range(3):
        for f in ("zeta", "u", "v", "w"):
            assert not torch.equal(getattr(rec, f)[k],
                                   getattr(rec, f)[k + 1]), (f, k)
    phi = 2 * torch.pi * rec.times / inputs.M2_PERIOD + 0.7
    m = 1 + 0.3 * torch.cos(phi)
    assert torch.allclose(rec.u[:, 0, 0, 0], m * -1e-4 * (0.0 - 4e3))
    assert torch.allclose(rec.zeta[:, 0, -1], 0.5 * torch.cos(phi) * 1.5)
    assert float(rec.w[..., [0, -1]].abs().max()) < 1e-15
    assert float(rec.w.abs().max()) > 1e-4


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    def edit(bench):
        bench["configs"].append({"name": "added-config", "source": "a test",
                                 "file": "ltbench/configs/added-config.json",
                                 "reduced": [], "why": "a test"})
        bench["workloads"].append({"name": "added-cell",
                                   "config": "added-config",
                                   "traffic": "added-traffic", "chips": 1,
                                   "why": "a test"})
        bench["per_layer"].append({"name": "added_metric", "unit": "%",
                                   "better": "higher", "layer": "device",
                                   "source": "device_trace",
                                   "moves": "particle_steps_per_s",
                                   "workloads": ["added-cell"]})

    root = ltbench_tiny.make(tmp_path, edit=edit)
    d = os.path.join(root, "ltbench")
    with open(os.path.join(d, "configs", "ltrans-advect.json")) as f:
        conf = json.load(f)
    conf["case"]["omega"] = 2e-5
    files = {"configs/added-config.json": conf,
             "traffic/added-traffic.json": {
                 "numpar": 300, "episode_ext_steps": 1, "sample": 100,
                 "release": {"x": [5e4, 6e4], "y": [5e4, 6e4],
                             "z": [-20.0, -10.0], "age": 0.0}},
             "limits/added-cell.json": {"limits": {"route_mismatch": 0}}}
    for name, body in files.items():
        with open(os.path.join(d, name), "w") as f:
            json.dump(body, f)
    with open(os.path.join(d, "metrics", "added_metric.py"), "w") as f:
        f.write("def read(obs):\n    return 42.0\n")
    c = cl.find_cell("added-cell", root)
    assert c.numpar == 300 and c.case["omega"] == 2e-5
    assert [m["name"] for m in c.per_layer] == ["added_metric"]
    assert load_reader(root, "added_metric")({}) == 42.0
    assert "added_metric" not in [
        m["name"] for m in cl.find_cell("advect-1m", root).per_layer]
    with pytest.raises(KeyError):
        cl.find_cell("no-such-cell", root)
