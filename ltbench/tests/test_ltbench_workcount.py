"""The frozen work count against hand counts on tiny shapes, and against
the smoke runs' count from the kernels' sources (``chip_smoke``) where
the two agree by definition.

Where they differ, and why: ``chip_smoke.rk4_bound`` and
``kernel_bound(..., lanes=True)`` charge K2 and K3 a value lane of 11
operations (one pre-collapsed table blended), the frozen count 31 (three
records collapsed and blended per particle, as K1 and LTRANS do): the
algorithm's work is the same whichever tables a kernel reads.  K2's
count here is per active particle-step (``rk4_bound`` counts every
particle, as the kernel computes them all).  Bytes: the smoke runs count
the port's packed table and boundary rows, the frozen count the record
fields, the bathymetry, the land mask and the polygon vertices a launch
needs."""

import dataclasses
import json
import os
import sys
import types

import pytest
import torch

import ltbench_tiny
from ltbench import cell as cl, run, workcount as wc
from ltbench.ref.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OYSTER = dict(HTurbOn=True, VTurbOn=True, readAks=True, Behavior=4,
              readSalt=True, SaltTempOn=True, mortality=True,
              stochastic_mortality=True, settlementon=True)


def test_hand_counts_on_tiny_shapes():
    # a fit on 2 knots of 1 profile: 31 + 31 + (31 + 37) + 2 + 14 + 9
    assert wc.fit_ops(2, 1) == 155
    assert wc.fit_ops(3, 2) == 31 + 62 + 2 * (31 + 74) + 6 + 14 + 18
    # a stage on us = 2, ws = 3: cell 10, zeta and h 62, fits, log 12
    assert wc.stage_ops(2, 3) == 10 + 62 + wc.fit_ops(2, 2) + \
        wc.fit_ops(3, 1) + 12
    assert wc.ops_per_step("k2", {}, 2, 3, False) == (
        4 * wc.stage_ops(2, 3) + 24, 0)
    f32, f64 = wc.ops_per_step("k1", {}, 2, 3, True)
    assert f64 == 4 * (10 + 12 + 8 * 5) + 40 + 147
    assert f32 + f64 == 4 * wc.stage_ops(2, 3) + 40 + 147
    # the lanes of a random walk alone: the bounds, one draw, 12
    assert wc.ops_per_step("k3", {"HTurbOn": True}, 2, 3, False) == (
        147 + 120 + 4 + 120 + 12, 0)
    # bytes of K2 on a 3 x 2 grid, us 1, ws 2, 10 particles in float64
    fields = 3 * 2 + 3 * 1 * 1 + 2 * 2 * 1 + 3 * 2 * 2      # zeta u v w
    assert wc.launch_bytes("k2", {}, 3, 2, 1, 2, 10, 8) == (
        3 * fields * 4 + 6 * (4 + 4) + 10 * 6 * 8)
    assert wc.least_seconds(67e12, 0, 0, {"fp32_per_s": 67e12,
                                          "fp64_per_s": 34e12,
                                          "hbm_bytes_per_s": 3.35e12}) == (
        1.0, "operations")


def test_hand_counts_of_the_estuary_terms():
    """On a curvilinear grid each internal step of K1 solves the inverse
    map 5 + reflect_iters times plainly (four stages, the vertical
    reflection's column, a reflection pass each) and twice with the
    residual (the inside tests), and a coastline takes every reflection
    pass: here 9 and 2 solves of 215, 2 residuals of 40 and 3 passes of
    60 more than the open box's count, all float64 with float64
    positions."""
    o = {"reflect_iters": 4}
    assert wc.CURV_SOLVE == 16 + 3 * 65 + 4 == 215
    k1 = wc.ops_per_step("k1", o, 2, 3, True)
    f32, f64 = wc.ops_per_step("k1", o, 2, 3, True, curv=True, passes=4)
    assert f32 == k1[0] and f64 - k1[1] == 3 * 60 + 11 * 215 + 2 * 40
    # the straight estuary: the passes alone
    assert wc.ops_per_step("k1", o, 2, 3, True, passes=4) == (
        k1[0], k1[1] + 3 * 60)
    # K2: the four stages' solves; K3: the rest, and the passes
    assert wc.ops_per_step("k2", o, 2, 3, False, curv=True, passes=4)[0] == (
        wc.ops_per_step("k2", o, 2, 3, False)[0] + 4 * 215)
    assert wc.ops_per_step("k3", o, 2, 3, False, curv=True, passes=4)[0] == (
        wc.ops_per_step("k3", o, 2, 3, False)[0] + 3 * 60 + 7 * 215
        + 2 * 40)
    # Visser on Aks and a behavior locate their stage-1 column too
    assert wc.curv_solves({"VTurbOn": True, "Behavior": 4}) == (11, 2)
    # bytes: the map of a 3 x 2 grid in float64 (6 points of 16 B) and
    # its seed raster (two int32 tables of 2 x 4 cells)
    assert wc.launch_bytes("k1", {}, 3, 2, 1, 2, 10, 8, curv=True) == (
        wc.launch_bytes("k1", {}, 3, 2, 1, 2, 10, 8) + 6 * 16 + 2 * 8 * 4)
    # the terms follow the configuration's grid kind alone
    grid = {"kind": "estuary", "curvilinear": True}
    assert wc.grid_terms({"grid": grid, "ltrans": {}}) == (True, 4)
    assert wc.grid_terms({"grid": {**grid, "curvilinear": False},
                          "ltrans": {"reflect_iters": 2}}) == (False, 2)
    assert wc.grid_terms({"grid": {"nx": 3}, "ltrans": {
        "reflect_iters": 2}}) == (False, 1)


def test_the_box_cells_counts_are_the_parents(tmp_path):
    """``run.work`` on the accepted cells' configurations, at the test
    size and their own, in float64 and float32 positions, gives the
    counts the harness gave before the estuary terms
    (``parent_counts.json``, written by the parent's code with this
    recipe) exactly."""
    with open(os.path.join(os.path.dirname(__file__),
                           "parent_counts.json")) as f:
        want = json.load(f)
    root = ltbench_tiny.make(tmp_path)
    inp = types.SimpleNamespace(habitat=[], holes=[], release=types.
                                SimpleNamespace(x=torch.zeros(3),
                                                y=torch.zeros(3)))
    got = {}
    for w in ("advect-1m", "advect-sheared-1m", "tiles-10m-4chip"):
        for size, r in (("tiny", root), ("full", REPO)):
            c = cl.find_cell(w, r)
            opts = dataclasses.asdict(Config(**c.ltrans))
            for pos in (8, 4):
                got[f"{w}|{size}|{pos}"] = run.work(
                    c, inp, opts, pos, [(0, c.numpar), (8, c.numpar - 3),
                                        (8, c.numpar - 5)], 30,
                    {"k1": 16, "k2": 2, "k3": 2})
    assert got == want


@pytest.mark.parametrize("curv", [False, True], ids=["box", "curv"])
@pytest.mark.parametrize("opts", [{}, OYSTER], ids=["advect", "oyster"])
@pytest.mark.parametrize("pos64", [False, True])
def test_agrees_with_the_smoke_runs_count(opts, pos64, curv):
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    cfg = Config(**opts)
    us, ws = 20, 21
    # K1: the same count, frozen (the smoke runs count one reflection
    # pass, as the frozen count does outside an estuary)
    assert wc.ops_per_step("k1", opts, us, ws, pos64, curv) == (
        cs.ops_per_step(cfg, us, ws, curv=curv, pos64=pos64))
    # K3: the smoke runs' lanes count with the records' lane of 31
    assert wc.ops_per_step("k3", opts, us, ws, pos64, curv) == (
        cs.ops_per_step(cfg, us, ws, curv=curv, pos64=pos64, rk4=False,
                        lane=31))
    # K2: rk4_ops with the lane of 31 in place of 11 (and kernel_bound's
    # four solves on a curvilinear grid)
    stage = 10 + 2 * 31 + cs.fit_ops(us, 2, 31) + cs.fit_ops(ws, 1, 31) + 12
    assert sum(wc.ops_per_step("k2", opts, us, ws, pos64, curv)) == (
        4 * stage + 24 + curv * 4 * cs.CURV_SOLVE_OPS)
    assert sum(wc.ops_per_step("k2", opts, us, ws, pos64)) > cs.rk4_ops(us,
                                                                        ws)
