"""K1's device nanoseconds per particle-step its lanes ran: K1's device
time in the traced window (the launches times the mean record,
``layers.roofline``) over the program's counter ``active_steps`` (the
particles ACTIVE after each internal step's release, summed)."""

from ltbench.layers import roofline


def read(obs):
    r = roofline(obs, "k1")
    act = (obs.get("staging") or {}).get("active_steps")
    return None if r is None or not act else 1e6 * r["device_ms"] / act
