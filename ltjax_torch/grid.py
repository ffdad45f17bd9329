"""Arakawa-C grid container and structured cell location.

Counterpart of ``ltjax.grid`` for rectilinear grids: the grid stores 1-D
projected metre axes, and cell location is index arithmetic on uniform
axes (a searchsorted otherwise).  Curvilinear grids are not ported yet
(``make_curv_grid`` raises).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Grid:
    """Static grid tensors; axes are (eta, xi) = (y, x)."""
    x_rho: torch.Tensor     # (Nx,) xi-axis rho-point coords [m]
    y_rho: torch.Tensor     # (Ny,)
    x_u: torch.Tensor       # (Nx-1,) u points
    y_v: torch.Tensor       # (Ny-1,) v points
    h: torch.Tensor         # (Ny, Nx) bathymetry (positive depth)
    mask_rho: torch.Tensor  # (Ny, Nx) int32 1=water 0=land
    mask_u: torch.Tensor    # (Ny, Nx-1)
    mask_v: torch.Tensor    # (Ny-1, Nx)
    s_rho: torch.Tensor     # (us,)
    Cs_r: torch.Tensor      # (us,)
    s_w: torch.Tensor       # (ws,)
    Cs_w: torch.Tensor      # (ws,)
    hc: float
    vtransform: int         # 1 or 2
    uniform: bool = False   # all axes exactly uniform (arithmetic locate)

    @property
    def nx(self) -> int:
        return self.x_rho.shape[0]

    @property
    def ny(self) -> int:
        return self.y_rho.shape[0]

    @property
    def us(self) -> int:
        return self.s_rho.shape[0]

    @property
    def ws(self) -> int:
        return self.s_w.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x_rho.device

    @property
    def dtype(self) -> torch.dtype:
        return self.x_rho.dtype


def _is_uniform(ax: np.ndarray, rtol: float = 1e-9) -> bool:
    d = np.diff(np.asarray(ax, np.float64))
    if d.size == 0:
        return True
    d0 = float(np.mean(d))
    return bool(np.all(np.abs(d - d0) <= rtol * max(abs(d0), 1.0)))


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def make_grid(x_rho, y_rho, h, mask_rho, s_rho, Cs_r, s_w, Cs_w, hc,
              vtransform=1, dtype=torch.float64, device="cpu",
              uniform=None) -> Grid:
    """Build a Grid from rho-point axes + bathymetry (+ s-coordinates).

    uniform=None detects exactly-uniform axes once on the host."""
    if uniform is None:
        uniform = _is_uniform(np.asarray(x_rho)) and _is_uniform(
            np.asarray(y_rho))
    x_rho = _t(x_rho, dtype, device)
    y_rho = _t(y_rho, dtype, device)
    mask_rho = _t(mask_rho, torch.int32, device)
    return Grid(
        x_rho=x_rho, y_rho=y_rho,
        x_u=0.5 * (x_rho[1:] + x_rho[:-1]),
        y_v=0.5 * (y_rho[1:] + y_rho[:-1]),
        h=_t(h, dtype, device), mask_rho=mask_rho,
        mask_u=mask_rho[:, 1:] * mask_rho[:, :-1],
        mask_v=mask_rho[1:, :] * mask_rho[:-1, :],
        s_rho=_t(s_rho, dtype, device), Cs_r=_t(Cs_r, dtype, device),
        s_w=_t(s_w, dtype, device), Cs_w=_t(Cs_w, dtype, device),
        hc=float(np.asarray(hc)), vtransform=int(vtransform),
        uniform=bool(uniform))


def make_curv_grid(*args, **kwargs) -> Grid:
    raise NotImplementedError(
        "curvilinear grids are not ported to ltjax_torch yet "
        "(ltjax.grid.make_curv_grid is the reference)")


def locate(coords: torch.Tensor, x: torch.Tensor, uniform: bool = False):
    """Cell index + fractional coordinate along one axis.

    Returns (i, f) with i in [0, n-2] (int32) and f clipped to [0, 1];
    queries outside the axis clamp to the edge cells."""
    n = coords.shape[0]
    if uniform and n >= 2:
        c0 = coords[0]
        dx = coords[1] - coords[0]
        t = (x - c0) / dx
        i = torch.floor(t).to(torch.int32).clamp(0, n - 2)
        f = (t - i.to(t.dtype)).clamp(0.0, 1.0)
        return i, f
    i = (torch.searchsorted(coords, x.to(coords.dtype), right=True) - 1
         ).clamp(0, n - 2)
    c0 = coords[i]
    c1 = coords[i + 1]
    f = ((x - c0) / (c1 - c0)).clamp(0.0, 1.0)
    return i.to(torch.int32), f


def locate_rho_ij(grid: Grid, x, y):
    """(i, j, fx, fy) on the rho-point lattice."""
    i, fx = locate(grid.x_rho, x, grid.uniform)
    j, fy = locate(grid.y_rho, y, grid.uniform)
    return i, j, fx, fy


def affine_ladders(grid: Grid):
    """Fixed vertical knot ladders (L_r, L_w) when the s-level depths are
    an affine map of them (Cs == s, or hc == 0), else None.  See
    ltjax.grid.affine_ladders for the derivation."""
    s_r = grid.s_rho.double().cpu().numpy()
    cs_r = grid.Cs_r.double().cpu().numpy()
    s_w = grid.s_w.double().cpu().numpy()
    cs_w = grid.Cs_w.double().cpu().numpy()
    if (np.allclose(s_r, cs_r, rtol=0, atol=1e-12)
            and np.allclose(s_w, cs_w, rtol=0, atol=1e-12)):
        return s_r, s_w
    if float(grid.hc) == 0.0:
        return cs_r, cs_w
    return None


def song_haidvogel_cs(s, theta_s=0.0, theta_b=0.0):
    """Stretching curve C(s) (for building synthetic grids)."""
    s = np.asarray(s, np.float64)
    if theta_s > 0:
        return (1 - theta_b) * np.sinh(theta_s * s) / np.sinh(theta_s) + (
            theta_b * (np.tanh(theta_s * (s + 0.5))
                       / (2 * np.tanh(0.5 * theta_s)) - 0.5))
    return s


def uniform_sigma_levels(us: int):
    """Uniform s_rho / s_w in [-1, 0] (synthetic-dataset helper)."""
    s_w = np.linspace(-1.0, 0.0, us + 1)
    s_rho = 0.5 * (s_w[1:] + s_w[:-1])
    return s_rho, s_w
