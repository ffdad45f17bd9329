"""Arakawa-C grid container and structured cell location.

Counterpart of ``ltjax.grid``.  A rectilinear grid stores 1-D projected
metre axes, and cell location is index arithmetic on uniform axes (a
searchsorted otherwise).  A curvilinear grid (``make_curv_grid``) stores
its 2-D rho coordinates and a seed raster (``CurvMap``); every cell
location goes through ``curv_logical``, the seed plus three Newton steps
on the bilinear quad map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class CurvMap:
    """Inverse curvilinear map: the projected rho-point coordinates as
    (Ny*Nx, 2) rows, and a uniform raster over the bounding box whose
    nodes hold the rho CELL whose centre is nearest (the Newton start).
    The raster's origin and inverse spacings are host floats."""
    xy_flat: torch.Tensor   # (Ny*Nx, 2) projected rho coords [m]
    seed_i: torch.Tensor    # (My, Mx) int32 seed cell i
    seed_j: torch.Tensor    # (My, Mx) int32 seed cell j
    rx0: float              # raster origin x
    ry0: float
    inv_rdx: float          # 1 / raster spacing
    inv_rdy: float


@dataclass
class TileRows:
    """Where the strip of a tile of a sharded run (``ltjax_torch.shard``)
    lies in the whole grid: its first row (the halo's; negative for the
    first tile), the whole grid's rows and y axes, and the (clipped) whole
    grid's row of each strip row.  Cells are located on the whole grid's
    axes, the arithmetic of an unsharded run, then moved into the strip
    (``locate_y``; the kernels' LTX_TILE builds)."""
    row0: int
    ny: int
    y_rho: torch.Tensor     # (ny,) the whole grid's rho axis
    y_v: torch.Tensor       # (ny-1,)
    rows: torch.Tensor      # (strip rows,) int64


@dataclass
class Grid:
    """Static grid tensors; axes are (eta, xi) = (y, x).  On a
    curvilinear grid (``curv`` set) the 1-D axes are the middle row and
    column, for diagnostics only."""
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
    curv: Optional[CurvMap] = None   # curvilinear inverse map
    tile: Optional[TileRows] = None  # the strip of a sharded run's tile

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


def make_curv_grid(x2d, y2d, h, mask_rho, s_rho, Cs_r, s_w, Cs_w, hc,
                   vtransform=1, dtype=torch.float64, device="cpu",
                   raster_factor: float = 2.0) -> Grid:
    """Curvilinear Grid from 2-D projected rho coordinates.

    On the host, once: the seed raster of the inverse map, a uniform
    lattice over the bounding box (~raster_factor nodes per cell) whose
    nodes hold the rho cell with the nearest centre (cells scattered into
    the raster, holes filled by dilation)."""
    x2 = np.asarray(x2d, np.float64)
    y2 = np.asarray(y2d, np.float64)
    ny, nx = x2.shape
    cx = 0.25 * (x2[:-1, :-1] + x2[:-1, 1:] + x2[1:, :-1] + x2[1:, 1:])
    cy = 0.25 * (y2[:-1, :-1] + y2[:-1, 1:] + y2[1:, :-1] + y2[1:, 1:])
    My = max(4, int(raster_factor * (ny - 1)))
    Mx = max(4, int(raster_factor * (nx - 1)))
    pad_x = (x2.max() - x2.min()) * 0.01 + 1e-9
    pad_y = (y2.max() - y2.min()) * 0.01 + 1e-9
    rx0 = x2.min() - pad_x
    ry0 = y2.min() - pad_y
    rdx = (x2.max() + pad_x - rx0) / Mx
    rdy = (y2.max() + pad_y - ry0) / My
    seed_i = np.full((My, Mx), -1, np.int32)
    seed_j = np.full((My, Mx), -1, np.int32)
    ri = np.clip(((cx - rx0) / rdx).astype(np.int64), 0, Mx - 1)
    rj = np.clip(((cy - ry0) / rdy).astype(np.int64), 0, My - 1)
    jj, ii = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1),
                         indexing="ij")
    seed_i[rj, ri] = ii.astype(np.int32)
    seed_j[rj, ri] = jj.astype(np.int32)
    # fill the holes by nearest-neighbour dilation (bounded sweeps)
    for _ in range(My + Mx):
        holes = seed_i < 0
        if not holes.any():
            break
        for dj, di in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            src_i = np.roll(seed_i, (dj, di), axis=(0, 1))
            src_j = np.roll(seed_j, (dj, di), axis=(0, 1))
            valid = np.ones((My, Mx), bool)     # no wrap across the border
            if dj == 1:
                valid[0, :] = False
            elif dj == -1:
                valid[-1, :] = False
            if di == 1:
                valid[:, 0] = False
            elif di == -1:
                valid[:, -1] = False
            take = holes & valid & (src_i >= 0)
            seed_i[take] = src_i[take]
            seed_j[take] = src_j[take]
            holes = seed_i < 0
    assert (seed_i >= 0).all(), "seed raster fill failed"

    mask_rho = _t(mask_rho, torch.int32, device)
    xy_flat = np.stack([x2.reshape(-1), y2.reshape(-1)], axis=-1)
    curv = CurvMap(xy_flat=_t(xy_flat, dtype, device),
                   seed_i=_t(seed_i, torch.int32, device),
                   seed_j=_t(seed_j, torch.int32, device),
                   rx0=float(rx0), ry0=float(ry0), inv_rdx=float(1.0 / rdx),
                   inv_rdy=float(1.0 / rdy))
    x_ax = _t(x2[ny // 2, :], dtype, device)
    y_ax = _t(y2[:, nx // 2], dtype, device)
    return Grid(
        x_rho=x_ax, y_rho=y_ax,
        x_u=0.5 * (x_ax[1:] + x_ax[:-1]), y_v=0.5 * (y_ax[1:] + y_ax[:-1]),
        h=_t(h, dtype, device), mask_rho=mask_rho,
        mask_u=mask_rho[:, 1:] * mask_rho[:, :-1],
        mask_v=mask_rho[1:, :] * mask_rho[:-1, :],
        s_rho=_t(s_rho, dtype, device), Cs_r=_t(Cs_r, dtype, device),
        s_w=_t(s_w, dtype, device), Cs_w=_t(Cs_w, dtype, device),
        hc=float(np.asarray(hc)), vtransform=int(vtransform),
        uniform=False, curv=curv)


def curv_logical(cm: CurvMap, nx: int, ny: int, x, y, iters: int = 3):
    """Logical rho-lattice coordinates (ti, tj) of physical points, and
    resid2, the squared physical residual of the forward map at the
    clamped solution (large outside the mesh, where the point clamps to a
    rim cell).  Seed from the raster, then ``iters`` Newton steps on the
    bilinear quad map, each bounded to [-1.5, 2.5] cells; ti in
    [0, nx-1], floor(ti) the containing rho cell."""
    dtype, dev = x.dtype, x.device
    My, Mx = cm.seed_i.shape

    def s(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    ri = torch.floor((x - s(cm.rx0)) * s(cm.inv_rdx)).clamp(0, Mx - 1)
    rj = torch.floor((y - s(cm.ry0)) * s(cm.inv_rdy)).clamp(0, My - 1)
    rflat = rj.long() * Mx + ri.long()
    ti = cm.seed_i.reshape(-1)[rflat].to(dtype) + 0.5
    tj = cm.seed_j.reshape(-1)[rflat].to(dtype) + 0.5
    xyf = cm.xy_flat.to(dtype)

    def corners(ti, tj):
        i = torch.floor(ti).clamp(0.0, nx - 2.0)
        j = torch.floor(tj).clamp(0.0, ny - 2.0)
        base = (j * nx + i).long()
        return (i, j, ti - i, tj - j, xyf[base], xyf[base + 1],
                xyf[base + nx], xyf[base + nx + 1])

    for _ in range(iters):
        i, j, fx, fy, c00, c01, c10, c11 = corners(ti, tj)
        ax = c01 - c00
        ay = c10 - c00
        axy = c11 - c01 - c10 + c00
        p = (c00 + fx[:, None] * ax + fy[:, None] * ay
             + (fx * fy)[:, None] * axy)
        jx = ax + fy[:, None] * axy        # dP/dfx
        jy = ay + fx[:, None] * axy        # dP/dfy
        det = jx[:, 0] * jy[:, 1] - jx[:, 1] * jy[:, 0]
        det = torch.where(det.abs() < 1e-30, 1e-30, det)
        rx = x - p[:, 0]
        ry = y - p[:, 1]
        dfx = (jy[:, 1] * rx - jy[:, 0] * ry) / det
        dfy = (-jx[:, 1] * rx + jx[:, 0] * ry) / det
        ti = i + (fx + dfx).clamp(-1.5, 2.5)
        tj = j + (fy + dfy).clamp(-1.5, 2.5)
    ti = ti.clamp(0.0, nx - 1.0)
    tj = tj.clamp(0.0, ny - 1.0)
    _, _, fx, fy, c00, c01, c10, c11 = corners(ti, tj)
    p = (c00 + fx[:, None] * (c01 - c00) + fy[:, None] * (c10 - c00)
         + (fx * fy)[:, None] * (c11 - c01 - c10 + c00))
    resid2 = (x - p[:, 0]) ** 2 + (y - p[:, 1]) ** 2
    return ti, tj, resid2


def logical_coords(grid: Grid, x, y, iters: int = 3):
    """(ti, tj) of physical points on a curvilinear grid."""
    return curv_logical(grid.curv, grid.nx, grid.ny, x, y, iters)[:2]


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


def locate_y(grid: Grid, y: torch.Tensor, v: bool = False):
    """``locate`` along eta on the rho axis (or, ``v``, the v axis).  On
    a tile's strip: on the whole grid's axis, then moved into the strip's
    rows (clamped to them: only a particle that left the strip and its
    halo is moved)."""
    t = grid.tile
    if t is None:
        return locate(grid.y_v if v else grid.y_rho, y, grid.uniform)
    j, f = locate(t.y_v if v else t.y_rho, y, grid.uniform)
    n = (grid.y_v if v else grid.y_rho).shape[0]
    return (j - t.row0).clamp(0, n - 2), f


def logical_cells(grid: Grid, x, y):
    """(ti, tj, i, j, fx, fy) on a curvilinear grid: the inverse map's
    logical coordinates, the rho cells (int32) and their fractions."""
    ti, tj = logical_coords(grid, x, y)
    i = torch.floor(ti).clamp(0.0, grid.nx - 2.0)
    j = torch.floor(tj).clamp(0.0, grid.ny - 2.0)
    return (ti, tj, i.to(torch.int32), j.to(torch.int32),
            (ti - i).clamp(0.0, 1.0), (tj - j).clamp(0.0, 1.0))


def locate_rho_ij(grid: Grid, x, y):
    """(i, j, fx, fy) on the rho-point lattice: per-axis ``locate`` on a
    rectilinear grid, the inverse map on a curvilinear one."""
    if grid.curv is not None:
        return logical_cells(grid, x, y)[2:]
    i, fx = locate(grid.x_rho, x, grid.uniform)
    j, fy = locate_y(grid, y)
    return i, j, fx, fy


def stag_from_logical(t, n: int):
    """Staggered-lattice index (int32) and fraction from a continuous rho
    logical coordinate: u (or v) points sit at rho + 0.5 along their
    axis, so the staggered cell coordinate is t - 0.5 on an (n-1)-point
    lattice."""
    ts = t - 0.5
    i = torch.floor(ts).clamp(0.0, n - 3.0)
    return i.to(torch.int32), (ts - i).clamp(0.0, 1.0)


