"""Batched tension-spline interpolation (counterpart of ``ltjax.tension``).

C2 spline under tension (Cline, CACM 1974) with natural end conditions;
the dimensionless per-interval tension u = T*h (u -> 0 is the natural
cubic spline).  Knots may differ per batch element.  Interval form
(h = x_{j+1}-x_j, B2 = (x-x_j)/h, B1 = 1-B2):

  H(x)  = y_j*B1 + y_{j+1}*B2 + h^2 * (z_j*gs(u,B1) + z_{j+1}*gs(u,B2))
  H'(x) = (y_{j+1}-y_j)/h + h * (z_j*ds(u,B1) - z_{j+1}*ds(u,B2))
  gs(u,B) = (sinh(u*B)/sinh(u) - B) / u^2     -> (B^3-B)/6   as u->0
  ds(u,B) = (1 - u*cosh(u*B)/sinh(u)) / u^2   -> 1/6 - B^2/2 as u->0

Small-u branches use series accurate to O(u^6).  Static sigma >= 0 only:
adaptive tension (``ltjax.tension.adaptive_sigma``) is not ported yet.
"""

from __future__ import annotations

import torch


def _u_small(dtype) -> float:
    """Series/exact crossover: tight for f64, wide for f32."""
    return 0.02 if dtype == torch.float64 else 0.5


def _as(v, like: torch.Tensor) -> torch.Tensor:
    """v as a tensor of like's dtype and device (a Python scalar is filled
    in on the device: no host-to-device copy)."""
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _gs(u, B):
    """(sinh(uB)/sinh(u) - B)/u^2, stable for all u >= 0."""
    u = _as(u, B)
    small = _u_small(B.dtype)
    us = torch.where(u < small, torch.ones_like(u), u)
    ratio = torch.exp(us * (B - 1.0)) * (-torch.expm1(-2.0 * us * B)) / (
        -torch.expm1(-2.0 * us))
    exact = (ratio - B) / (us * us)
    u2 = u * u
    B2 = B * B
    c = u2 / 6.0 + u2 * u2 / 120.0 + u2 * u2 * u2 / 5040.0
    series = B * ((B2 - 1.0) / 6.0 + u2 * (B2 * B2 - 1.0) / 120.0
                  + u2 * u2 * (B2 * B2 * B2 - 1.0) / 5040.0) / (1.0 + c)
    return torch.where(u < small, series, exact)


def _ds(u, B):
    """(1 - u*cosh(uB)/sinh(u))/u^2, stable for all u >= 0."""
    u = _as(u, B)
    small = _u_small(B.dtype)
    us = torch.where(u < small, torch.ones_like(u), u)
    ratio = us * torch.exp(us * (B - 1.0)) * (
        1.0 + torch.exp(-2.0 * us * B)) / (-torch.expm1(-2.0 * us))
    exact = (1.0 - ratio) / (us * us)
    u2 = u * u
    B2 = B * B
    c = u2 / 6.0 + u2 * u2 / 120.0 + u2 * u2 * u2 / 5040.0
    series = ((1.0 / 6.0 - B2 / 2.0) + u2 * (1.0 / 120.0 - B2 * B2 / 24.0)
              + u2 * u2 * (1.0 / 5040.0 - B2 * B2 * B2 / 720.0)) / (1.0 + c)
    return torch.where(u < small, series, exact)


def _coefs(u, h):
    """Tridiagonal coefficients of one interval:
    off = (h/u^2)(1 - u/sinh u) -> h/6, diag = (h/u^2)(u coth u - 1) -> h/3."""
    small = _u_small(h.dtype)
    us = torch.where(u < small, torch.ones_like(u), u)
    em = -torch.expm1(-2.0 * us)
    u_over_sinh = 2.0 * us * torch.exp(-us) / em
    u_coth = us * (1.0 + torch.exp(-2.0 * us)) / em
    off_e = (h / (us * us)) * (1.0 - u_over_sinh)
    diag_e = (h / (us * us)) * (u_coth - 1.0)
    u2 = u * u
    off_s = h * (1.0 / 6.0 - 7.0 * u2 / 360.0 + 31.0 * u2 * u2 / 15120.0)
    diag_s = h * (1.0 / 3.0 - u2 / 45.0 + 2.0 * u2 * u2 / 945.0)
    return (torch.where(u < small, off_s, off_e),
            torch.where(u < small, diag_s, diag_e))


def _thomas(dl, d, du, b):
    """Batched Thomas tridiagonal solve along the last axis (a Python
    loop over the ~20 vertical levels; the batch axes are vectorized).
    dl[..., 0] and du[..., n-1] are ignored."""
    n = d.shape[-1]
    cp = torch.zeros_like(d[..., 0])
    dp = torch.zeros_like(d[..., 0])
    cps, dps = [], []
    for i in range(n):
        denom = d[..., i] - dl[..., i] * cp
        cp = du[..., i] / denom
        dp = (b[..., i] - dl[..., i] * dp) / denom
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(d[..., 0])
    xs = [None] * n
    for i in reversed(range(n)):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return torch.stack(xs, dim=-1)


def fit(xk, yk, sigma):
    """Knot second derivatives z2 of the natural tension spline.

    xk, yk: (..., n) knots (xk increasing along the last axis); sigma:
    scalar or (..., n-1) per-interval tension >= 0."""
    h = xk[..., 1:] - xk[..., :-1]
    dy = (yk[..., 1:] - yk[..., :-1]) / h
    sig = torch.broadcast_to(_as(sigma, h), h.shape)
    off, dia = _coefs(sig, h)
    one = torch.ones_like(off[..., :1])
    zero = torch.zeros_like(off[..., :1])
    # interior rows i = 1..n-2; identity end rows (z2 = 0)
    dl = torch.cat([zero, off[..., :-1], zero], dim=-1)
    du = torch.cat([zero, off[..., 1:], zero], dim=-1)
    d = torch.cat([one, dia[..., :-1] + dia[..., 1:], one], dim=-1)
    b = torch.cat([zero, dy[..., 1:] - dy[..., :-1], zero], dim=-1)
    return _thomas(dl, d, du, b)


def _interval_index(xk, x):
    """Index j of the interval containing x, clamped to [0, n-2]."""
    n = xk.shape[-1]
    j = (x[..., None] >= xk[..., 1:]).sum(dim=-1)
    return j.clamp(0, n - 2)


def _interval(xk, yk, z2, sigma, x):
    """x clamped to the knot range, and the endpoints (x0, x1, y0, y1,
    z2_0, z2_1) and tension u of its interval."""
    x = torch.minimum(torch.maximum(x, xk[..., 0]), xk[..., -1])
    j = _interval_index(xk, x)[..., None]
    x0 = xk.gather(-1, j)[..., 0]
    x1 = xk.gather(-1, j + 1)[..., 0]
    y0 = yk.gather(-1, j)[..., 0]
    y1 = yk.gather(-1, j + 1)[..., 0]
    s0 = z2.gather(-1, j)[..., 0]
    s1 = z2.gather(-1, j + 1)[..., 0]
    sig = torch.broadcast_to(_as(sigma, xk), xk[..., :-1].shape)
    u = sig.gather(-1, j)[..., 0]
    return x, x0, x1, y0, y1, s0, s1, u


def evaluate(xk, yk, z2, sigma, x):
    """Evaluate the tension spline at x, clamped to the knot range."""
    x, x0, x1, y0, y1, s0, s1, u = _interval(xk, yk, z2, sigma, x)
    h = x1 - x0
    B2 = (x - x0) / h
    B1 = 1.0 - B2
    return y0 * B1 + y1 * B2 + h * h * (s0 * _gs(u, B1) + s1 * _gs(u, B2))


def evaluate_deriv(xk, yk, z2, sigma, x):
    """dH/dx at x, clamped to the knot range."""
    x, x0, x1, y0, y1, s0, s1, u = _interval(xk, yk, z2, sigma, x)
    h = x1 - x0
    B2 = (x - x0) / h
    B1 = 1.0 - B2
    return (y1 - y0) / h + h * (s0 * _ds(u, B1) - s1 * _ds(u, B2))
