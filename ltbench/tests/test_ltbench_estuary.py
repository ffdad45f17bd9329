"""The estuary grid kind and the water release (``ltbench/estuary.py``)
on the CPU at a tiny size (``estuary_fixture``: 48 x 24 rho points, 6
levels, 4,096 particles, 4 h episodes; the curvilinear form and the
straight one; the program's plain versions stand in for its kernels): the
program passes against the reference and its control fails; the
reference reflects particles off the coast and loses some through the
mouth; and each fault planted in the program's set-up comes out not
correct.  The geometry holds at the fixture's own size too."""

import dataclasses

import numpy as np
import pytest
import torch

import estuary_fixture as ef
from ltbench import cell as cl, estuary, reference, run
from ltbench.ref import state as rst
from ltbench.ref.grid import (curv_logical, locate_rho_ij, make_curv_grid,
                              make_grid)
from ltbench.ref.physics import boundary as rbd

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4321
FORMS = [ef.CELL, ef.STRAIGHT]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return ef.make(tmp_path_factory.mktemp("estuary"))


def measure(root, workload, **kw):
    return run.measure(cl.find_cell(workload, root), SEED, 0.0, False, CPU,
                       root, **kw)


@pytest.mark.parametrize("workload", FORMS)
def test_the_program_passes_and_its_control_fails(root, workload):
    res = measure(root, workload)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    ctl = measure(root, workload, control="float32")
    assert not ctl["correct"], ctl["checks"]


@pytest.mark.parametrize("workload", FORMS)
def test_the_reference_hits_land_and_leaves_at_the_mouth(root, workload):
    """Over an episode the reference reflects particles off the coast
    (``hit_land``, counted with TrackCollisions) and particles leave
    through the mouth.  On the straight grid they leave as exits (status
    OUT_OF_DOMAIN).  On the curvilinear one the program and its frozen
    copy flag them ERROR first (PERF.md, open questions): the inside test
    of the inverse map ends a quarter cell beyond the mouth's rho column,
    the open segment lies half a cell beyond it, so a particle stops in
    between and is stuck; this test holds that behaviour as it is."""
    c = cl.find_cell(workload, root)
    inp = cl.make_inputs(c, SEED, CPU)
    p, _ = reference.run_episode(c, inp, torch.arange(c.numpar), 0, CPU)
    assert int(p.hit_land.sum()) > 0
    status = torch.bincount(p.status.long(), minlength=rst.ERROR + 1)
    ga = inp.grid
    if workload == ef.STRAIGHT:
        assert int(status[rst.OUT_OF_DOMAIN]) > 0
        return
    g = make_curv_grid(ga.x_rho, ga.y_rho, ga.h, ga.mask, ga.s_rho,
                       ga.s_rho, ga.s_w, ga.s_w, ga.hc, ga.vtransform)
    err = p.status == rst.ERROR
    ti, _, _ = curv_logical(g.curv, g.nx, g.ny, p.x[err], p.y[err])
    assert int(status[rst.OUT_OF_DOMAIN]) == 0
    assert int((ti < 0.5).sum()) > 0


def _geometry(est: estuary.Estuary):
    ga = est.arrays
    x2, y2 = est.x2, est.y2
    # every rho quad keeps its orientation: the cross product of its
    # edges along xi and eta is positive at each of its four corners
    exi = np.stack([x2[:, 1:] - x2[:, :-1], y2[:, 1:] - y2[:, :-1]], -1)
    eeta = np.stack([x2[1:] - x2[:-1], y2[1:] - y2[:-1]], -1)
    for ex in (exi[:-1], exi[1:]):
        for ee in (eeta[:, :-1], eeta[:, 1:]):
            assert (ex[..., 0] * ee[..., 1] - ex[..., 1] * ee[..., 0]
                    > 0).all()
    m = ga.mask
    assert not m[0].any() and not m[-1].any() and not m[:, -1].any()
    assert m[1:-1, 0].all() and m[1:-1, 1:].any()
    assert float(ga.h.min()) >= float(est.grid["shoal_depth_m"]) >= 2.0


@pytest.mark.parametrize("size", ["tiny", "fixture"])
@pytest.mark.parametrize("workload", FORMS)
def test_geometry_and_release(root, tmp_path, workload, size):
    """No folded cell; the rim land but the mouth column water; the depth
    2 m or more; every released particle in a water cell off the rim, at
    a fraction of its local water column within the traffic's range (the
    column read by the reference's own cell location)."""
    if size == "fixture":
        root = ef.make(tmp_path, tiny=False)
    c = cl.find_cell(workload, root)
    est = cl.estuary_of(c)
    _geometry(est)
    inp = cl.make_inputs(c, SEED, CPU)
    ga, r = inp.grid, inp.release
    curv = ga.x_rho.ndim == 2
    if curv:
        g = make_curv_grid(ga.x_rho, ga.y_rho, ga.h, ga.mask, ga.s_rho,
                           ga.s_rho, ga.s_w, ga.s_w, ga.hc, ga.vtransform)
        b = rbd.build_boundaries_curv(ga.mask, ga.x_rho, ga.y_rho, g.curv)
    else:
        g = make_grid(ga.x_rho, ga.y_rho, ga.h, ga.mask, ga.s_rho, ga.s_rho,
                      ga.s_w, ga.s_w, ga.hc, ga.vtransform)
        b = rbd.build_boundaries(ga.mask, ga.x_rho, ga.y_rho)
    assert len(r.x) == c.numpar
    assert bool(rbd.in_water(b, r.x, r.y).all())
    i, j = rbd.cell_of(b, r.x, r.y)
    lo, hi = c.traffic["release"]["i"]
    assert int(i.min()) >= max(1, lo) and int(i.max()) <= hi
    assert int(j.min()) >= 1 and int(j.max()) <= ga.mask.shape[0] - 2
    ii, jj, fx, fy = locate_rho_ij(g, r.x, r.y)
    h = g.h
    ii, jj = ii.long(), jj.long()
    hp = ((1 - fy) * ((1 - fx) * h[jj, ii] + fx * h[jj, ii + 1])
          + fy * ((1 - fx) * h[jj + 1, ii] + fx * h[jj + 1, ii + 1]))
    s = torch.as_tensor(est.s)[ii] + fx * (est.s[1] - est.s[0])
    zeta = estuary._surface(c.case, s, 0.0)
    frac = (r.z - zeta) / (hp + zeta)
    s_lo, s_hi = c.traffic["release"]["s"]
    assert float(frac.min()) >= s_lo - 1e-9 and float(frac.max()) <= (
        s_hi + 1e-9)


def _plant(monkeypatch, fault):
    """Break the program's set-up underneath the harness: the land mask
    ignored (all water); reflection off (no pass: a particle that crosses
    the coast stays on land); the mouth closed (the rim reflects); the
    curvilinear grid replaced by the rectilinear grid of its bounding
    box; the release's depths drawn in metres, not as fractions of the
    local water column.  Reflection off: a particle whose step crosses
    the coast ends where the step ends, on land, with no land hit."""
    from ltjax_torch.physics import boundary as bd
    grid_of, bounds_of, build = (cl.program_grid, cl.program_bounds,
                                 cl.build_program)

    def ga_of(ga):
        if fault == "all_water":
            return dataclasses.replace(ga, mask=np.ones_like(ga.mask))
        if fault == "bounding_grid":
            ny, nx = ga.mask.shape
            return dataclasses.replace(
                ga, x_rho=np.linspace(ga.x_rho.min(), ga.x_rho.max(), nx),
                y_rho=np.linspace(ga.y_rho.min(), ga.y_rho.max(), ny))
        return ga

    monkeypatch.setattr(cl, "program_grid", lambda ga, dtype, device:
                        grid_of(ga_of(ga), dtype, device))
    monkeypatch.setattr(cl, "program_bounds", lambda ga, grid, device:
                        bounds_of(ga_of(ga), grid, device))
    if fault == "no_reflection":
        reflect = bd.reflect

        def unreflected(bounds, x0, y0, x1, y1, **k):
            x, y, hits, exited, stuck = reflect(bounds, x0, y0, x1, y1, **k)
            land = hits > 0
            return (torch.where(land, x1, x), torch.where(land, y1, y),
                    torch.zeros_like(hits), exited, stuck)
        monkeypatch.setattr(bd, "reflect", unreflected)
    if fault == "mouth_closed":
        boxed = bd.build_boundaries
        monkeypatch.setattr(bd, "build_boundaries", lambda *a, **k: boxed(
            *a, **{**k, "closed_edges": True}))
    if fault == "absolute_depth":
        def program(cell, inp, device, dtype_pos=None):
            prog = build(cell, inp, device, dtype_pos)
            g = torch.Generator().manual_seed(SEED)
            lo, hi = cell.traffic["release"]["s"]
            h = float(inp.grid.h.max())
            z = h * (lo + (hi - lo) * torch.rand(prog.p0.n, generator=g,
                                                 dtype=torch.float64))
            prog.p0 = prog.p0.replace(z=z.to(prog.p0.z))
            return prog
        monkeypatch.setattr(cl, "build_program", program)


# the mouth closed changes nothing on the curvilinear grid, whose
# particles stop short of the open segment (see above); the bounding grid
# of the straight grid is the grid itself
FAULTS = [(w, f) for f, forms in (
    ("all_water", FORMS), ("no_reflection", FORMS),
    ("mouth_closed", [ef.STRAIGHT]), ("bounding_grid", [ef.CELL]),
    ("absolute_depth", FORMS)) for w in forms]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(root, monkeypatch, workload, fault):
    _plant(monkeypatch, fault)
    res = measure(root, workload)
    assert not res["correct"] and res["failed"] > 0, res["checks"]


def test_a_curvilinear_cell_refuses_several_cards(root):
    """At set-up, before any rank starts: the program cuts no eta strips
    of a curvilinear grid."""
    from ltbench import sharded
    c = dataclasses.replace(cl.find_cell(ef.CELL, root), chips=4)
    with pytest.raises(RuntimeError, match="curvilinear"):
        sharded.measure(c, SEED, 0.0, False, "cpu", root, 0.0)
