"""The whole traced window's share of the card's peak [%]: the least
time of the LTRANS work of every kernel that ran (the frozen count) over
the window's length.  It bounds the kernels' roofline shares, whichever
kernels a route runs."""

from ltbench import workcount
from ltbench.layers import window_us


def read(obs):
    work = [w for k, w in obs["work"].items() if obs["launches"].get(k)]
    span = window_us(obs)
    if not work or span <= 0:
        return None
    least = sum(workcount.least_seconds(w["f32"], w["f64"], w["bytes"],
                                        obs["peaks"])[0] for w in work)
    return 100.0 * least / (1e-6 * span)
