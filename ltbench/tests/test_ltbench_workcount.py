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

import os
import sys

import pytest

from ltbench import workcount as wc
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


@pytest.mark.parametrize("opts", [{}, OYSTER], ids=["advect", "oyster"])
@pytest.mark.parametrize("pos64", [False, True])
def test_agrees_with_the_smoke_runs_count(opts, pos64):
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    cfg = Config(**opts)
    us, ws = 20, 21
    # K1: the same count, frozen
    assert wc.ops_per_step("k1", opts, us, ws, pos64) == cs.ops_per_step(
        cfg, us, ws, pos64=pos64)
    # K3: the smoke runs' lanes count with the records' lane of 31
    assert wc.ops_per_step("k3", opts, us, ws, pos64) == cs.ops_per_step(
        cfg, us, ws, pos64=pos64, rk4=False, lane=31)
    # K2: rk4_ops with the lane of 31 in place of 11
    stage = 10 + 2 * 31 + cs.fit_ops(us, 2, 31) + cs.fit_ops(ws, 1, 31) + 12
    assert sum(wc.ops_per_step("k2", opts, us, ws, pos64)) == 4 * stage + 24
    assert sum(wc.ops_per_step("k2", opts, us, ws, pos64)) > cs.rk4_ops(us,
                                                                        ws)
