"""The share of the traced window in which no operation ran on the
device [%]."""

from ltbench import trace
from ltbench.layers import window_us


def read(obs):
    t = obs["trace"]
    span = window_us(obs)
    if span <= 0 or not t["device"]:
        return None
    return 100.0 * (1.0 - trace.busy_us(t["device"], t["span"]) / span)
