"""Settlement: ltjax_torch.physics.settlement against
ltjax.physics.settlement on the same polygons and points.

The cases: a concave polygon (an L), a polygon overlapping it (two
candidates in shared cells, the first in list order wins), a square
habitat with a square hole and a slanted hole, on a 10 x 10 cell
lattice; points drawn from a numpy seed, plus every vertex, points on
edges, and points exactly on cell edges.  Both sides test in float64
(the vertices' dtype) on the positions promoted, so booleans and ids are
equal, with no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltjax.physics import settlement as jstl
from ltjax_torch import interop
from ltjax_torch.physics import settlement as tstl

XE = np.linspace(0.0, 10.0, 11)
YE = np.linspace(0.0, 10.0, 11)
HABITAT = [
    (101, np.array([[1.0, 1.0], [5.0, 1.0], [5.0, 2.5], [2.5, 2.5],
                    [2.5, 6.0], [1.0, 6.0]])),                  # concave L
    (102, np.array([[2.0, 2.0], [4.5, 2.2], [4.0, 5.0]])),    # overlaps it
    (103, np.array([[6.0, 6.0], [9.5, 6.0], [9.5, 9.5], [6.0, 9.5]])),
]
HOLES = [
    (1, np.array([[7.0, 7.0], [8.0, 7.0], [8.0, 8.0], [7.0, 8.0]])),
    (2, np.array([[1.2, 4.0], [2.2, 4.6], [1.4, 5.5]])),       # slanted
]


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _points(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(0.0, 10.0, (n, 2))]
    for _, v in HABITAT + HOLES:
        pts.append(v)                                       # vertices
        w = np.roll(v, -1, axis=0)
        for f in (0.25, 0.5):
            pts.append(v + f * (w - v))                     # on edges
    g = np.linspace(0.0, 10.0, 21)
    pts.append(np.stack(np.meshgrid(g, g), -1).reshape(-1, 2))  # cell edges
    return np.concatenate(pts)


@pytest.fixture(scope="module")
def tables():
    jp = jstl.build_polygons(HABITAT, XE, YE)
    jh = jstl.build_polygons(HOLES, XE, YE)
    tp = tstl.build_polygons(HABITAT, XE, YE)
    th = tstl.build_polygons(HOLES, XE, YE)
    return jp, jh, tp, th


def test_build_polygons_equal(tables):
    jp, jh, tp, th = tables
    for j, t in ((jp, tp), (jh, th)):
        for k, v in _np(j).items():
            got = getattr(t, k).numpy()
            np.testing.assert_array_equal(got, v)
            assert got.dtype == v.dtype, k
    # the overlap puts two candidates in some cells
    assert tp.cell_cands.shape[2] == 2
    assert ((tp.cell_cands >= 0).sum(-1) == 2).any()
    # and interop carries ltjax's tables across unchanged
    for k, v in _np(jp).items():
        np.testing.assert_array_equal(
            getattr(interop.polygons_from_numpy(_np(jp)), k).numpy(), v)


@pytest.mark.parametrize("k", range(len(HABITAT + HOLES)))
def test_point_in_polygon_equal(k):
    _, v = (HABITAT + HOLES)[k]
    pts = _points()
    vmax = 8                                      # padded, as build_polygons
    vx = np.concatenate([v[:, 0], np.full(vmax - len(v), v[-1, 0])])
    vy = np.concatenate([v[:, 1], np.full(vmax - len(v), v[-1, 1])])
    n = len(pts)
    want = np.asarray(jstl.point_in_polygon(
        jnp.asarray(np.tile(vx, (n, 1))), jnp.asarray(np.tile(vy, (n, 1))),
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1])))
    got = tstl.point_in_polygon(
        torch.tensor(np.tile(vx, (n, 1))), torch.tensor(np.tile(vy, (n, 1))),
        torch.tensor(pts[:, 0]), torch.tensor(pts[:, 1])).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_holes", [True, False],
                         ids=["holes", "no-holes"])
@pytest.mark.parametrize("uniform", [True, False],
                         ids=["uniform", "searchsorted"])
def test_settlement_equal(tables, dtype, with_holes, uniform):
    jp, jh, tp, th = tables
    pts = _points().astype(dtype)
    eligible = np.random.default_rng(1).uniform(size=len(pts)) < 0.9
    js, jid = jstl.test_settlement(
        jp, jh if with_holes else None, jnp.asarray(XE), jnp.asarray(YE),
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]),
        jnp.asarray(eligible), uniform=uniform)
    ts, tid = tstl.test_settlement(
        tp, th if with_holes else None, torch.tensor(XE), torch.tensor(YE),
        torch.tensor(pts[:, 0]), torch.tensor(pts[:, 1]),
        torch.tensor(eligible), uniform=uniform)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert tid.dtype == torch.int32
    ids = set(tid.numpy().tolist())
    assert {101, 102, 103} <= ids and -1 in ids
    if with_holes:
        # nothing settles inside the square hole
        inside = ((pts[:, 0] > 7.0) & (pts[:, 0] < 8.0) & (pts[:, 1] > 7.0)
                  & (pts[:, 1] < 8.0))
        assert inside.any() and not ts.numpy()[inside].any()


def test_settlement_without_polygons():
    x = torch.zeros(5)
    s, pid = tstl.test_settlement(None, None, torch.tensor(XE),
                                  torch.tensor(YE), x, x,
                                  torch.ones(5, dtype=torch.bool))
    assert not s.any() and (pid == -1).all()


def test_polygon_csv_equal(tmp_path):
    p = tmp_path / "hab.csv"
    p.write_text("# habitat\n1.0,2.0,101\n3.0 2.0 101\n2.0,4.0,101\n\n"
                 "7.0,7.0,102\n9.0,7.0,102\n8.0,9.0,102\n")
    want = jstl.read_polygon_csv(str(p))
    got = tstl.read_polygon_csv(str(p))
    assert [g[0] for g in got] == [w[0] for w in want] == [101, 102]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])
