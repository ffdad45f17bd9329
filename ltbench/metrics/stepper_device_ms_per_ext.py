"""Device milliseconds an external step in every operation that is not
K1, K2 or K3: the stepper's sort and unsort, its packed and aux tables,
the status counts."""

from ltbench.layers import KERNELS


def read(obs):
    dev = obs["trace"]["device"]
    if not dev:
        return None
    other = sum(e - s for name, s, e in dev
                if not any(k in name for k in KERNELS.values()))
    return 1e-3 * other / obs["ext_steps"]
