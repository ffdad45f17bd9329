"""Kernel K3's share of its roofline in the traced window [%]."""

from ltbench.layers import roofline


def read(obs):
    r = roofline(obs, "k3")
    return None if r is None else r["pct"]
