"""Quadratic-in-time interpolation (counterpart of ``ltjax.interp``).

Only ``polintd`` is ported: the main path interpolates horizontally
inside ``ltjax_torch.packed`` and the CUDA kernel.
"""

from __future__ import annotations


def polintd_coefs(times, t):
    """The three Lagrange weights of ``polintd`` at time t (python
    floats in float64, computed on the host)."""
    t0, t1, t2 = (float(v) for v in times)
    t = float(t)
    l0 = (t - t1) * (t - t2) / ((t0 - t1) * (t0 - t2))
    l1 = (t - t0) * (t - t2) / ((t1 - t0) * (t1 - t2))
    l2 = (t - t0) * (t - t1) / ((t2 - t0) * (t2 - t1))
    return l0, l1, l2


def polintd(f, times, t):
    """Quadratic Lagrange through 3 time records, evaluated at t.

    f: (3, ...) values at the 3 buffered records; times: 3 record times.
    The weights are host float64 scalars, applied in f's dtype."""
    l0, l1, l2 = polintd_coefs(times, t)
    return f[0] * l0 + f[1] * l1 + f[2] * l2
