"""Horizontal bilinear + quadratic-in-time interpolation (counterpart of
``ltjax.interp``, rectilinear grids).

The main path interpolates inside ``ltjax_torch.packed`` and the CUDA
kernel; ``interp2d``/``interp_columns`` serve the per-record field reads
of the turbulence operator (``physics.turb.vturb``).
"""

from __future__ import annotations

import torch

from .grid import Grid, locate_rho_ij


def bilinear_weights(fx, fy):
    """4 corner weights, order (j,i),(j,i+1),(j+1,i),(j+1,i+1)."""
    return ((1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy,
            fx * fy)


def _flat_corners(shape, i, j):
    """Flat row indices (L, N) of the 4 bilinear corners, the L leading
    (time) axes of a (..., Ny, Nx) field folded into the row index."""
    ny, nx = shape[-2], shape[-1]
    lead = 1
    for s in shape[:-2]:
        lead *= s
    base = j.long() * nx + i.long()
    offs = (torch.arange(lead, device=i.device) * (ny * nx))[:, None]
    i00 = offs + base
    return i00, i00 + 1, i00 + nx, i00 + nx + 1


def interp2d(field, i, j, fx, fy):
    """Bilinear interp of ``field[..., eta, xi]`` at fractional cells:
    field (..., Ny, Nx), i/j/fx/fy (N,) -> (..., N)."""
    flat = field.reshape(-1)
    i00, i01, i10, i11 = _flat_corners(field.shape, i, j)
    w00, w01, w10, w11 = bilinear_weights(fx, fy)
    out = (flat[i00] * w00 + flat[i01] * w01
           + flat[i10] * w10 + flat[i11] * w11)
    return out.reshape(field.shape[:-2] + i.shape)


def interp_columns(field, i, j, fx, fy):
    """Bilinear interp of a K-last level-resolved field to particle
    columns: field (..., Ny, Nx, K) -> (..., N, K)."""
    K = field.shape[-1]
    flat = field.reshape(-1, K)
    i00, i01, i10, i11 = _flat_corners(field.shape[:-1], i, j)
    w00, w01, w10, w11 = bilinear_weights(fx, fy)
    prof = (flat[i00] * w00[..., None] + flat[i01] * w01[..., None]
            + flat[i10] * w10[..., None] + flat[i11] * w11[..., None])
    return prof.reshape(field.shape[:-3] + i.shape + (K,))


def locate_rho(grid: Grid, x, y):
    """(i, j, fx, fy) on the rho-point lattice."""
    return locate_rho_ij(grid, x, y)


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
