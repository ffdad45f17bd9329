"""Coastline/land boundary handling (counterpart of
``ltjax.physics.boundary``).

Host side (numpy, once at init): boundary segments on the edges of the
rho-cell lattice (on a curvilinear grid, the quad edges of its psi
corner mesh, ``build_boundaries_curv``), a per-cell bucket of the segment ids in its 3x3
neighbourhood, and one flat row per cell:

    lane 0 water flag; lanes 3/4 per-axis squared displacement-guard
    radii; slot s at 8 + 8s = [ax, ay, bx, by, kind, valid, 0, 0]

Per internal step (``reflect``): intersect each displacement with the
segments of its pre-move cell's row, reflect specularly about the
earliest crossing, exit through open segments, repeat ``n_iter`` times;
endpoints on land, tunnelled midpoints and displacements beyond the
bucket's reach are reported ``stuck`` (status ERROR upstream).

One departure from ltjax, on curvilinear grids: a pass ignores the
segment that the previous pass reflected from.  A straight path that
leaves a wall never crosses it again, so in exact arithmetic (and in
float64, where the 1e-6 m nudge clears the wall) this changes nothing;
in float32 the nudge is below the resolution of 1e4-1e5 m coordinates,
the restart point lies on either side of a slanted wall by round-off,
and ltjax's next pass may "cross" the same segment at tp ~ 0 and
reflect the particle into land (stuck, ERROR).  On a rectilinear grid
the intersection with an axis-aligned wall rounds onto the wall
exactly, and reflect is ltjax's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..grid import CurvMap, _is_uniform, curv_logical

LAND = 0
OPEN = 1


@dataclass
class Boundaries:
    seg_a: torch.Tensor      # (S, 2) segment start xy
    seg_b: torch.Tensor      # (S, 2) segment end xy
    seg_kind: torch.Tensor   # (S,) LAND or OPEN
    bucket: torch.Tensor     # (Ny, Nx, S_max) segment ids per cell, -1 pad
    x_edges: torch.Tensor    # (Nx+1,) float64 cell-edge x coordinates
    y_edges: torch.Tensor    # (Ny+1,)   (curvilinear: a uniform bounding-
                             #   box raster, the settlement pruning lattice)
    water: torch.Tensor      # (Ny, Nx) int32 mask_rho
    cell_rows: torch.Tensor  # (Ny*Nx, 8 + 8*S_max) float64 cell rows
    uniform: bool            # edge axes uniform (arithmetic cell_of)
    edges: tuple             # host floats (x0, dx, y0, dy, x_last, y_last)
                             #   of the edge axes: no device sync to read
    curv: Optional[CurvMap] = None     # curvilinear inverse map (cell_of)
    curv_tol2: Optional[float] = None  # squared inside-mesh residual tol

    @property
    def s_max(self) -> int:
        return (self.cell_rows.shape[1] - 8) // 8


def _cell_edges(axis: np.ndarray) -> np.ndarray:
    mid = 0.5 * (axis[1:] + axis[:-1])
    first = axis[0] - (axis[1] - axis[0]) / 2
    last = axis[-1] + (axis[-1] - axis[-2]) / 2
    return np.concatenate([[first], mid, [last]])


def _psi_mesh(x2: np.ndarray, y2: np.ndarray):
    """Cell-corner (psi) mesh (Ny+1, Nx+1) of a rho-point mesh: interior
    corners average the 4 surrounding rho points, rim corners extrapolate
    linearly."""
    def pad(a):
        a = np.pad(a, 1, mode="edge").astype(np.float64)
        a[0, :] = 2 * a[1, :] - a[2, :]
        a[-1, :] = 2 * a[-2, :] - a[-3, :]
        a[:, 0] = 2 * a[:, 1] - a[:, 2]
        a[:, -1] = 2 * a[:, -2] - a[:, -3]
        return a
    xp = pad(x2)
    yp = pad(y2)
    px = 0.25 * (xp[:-1, :-1] + xp[:-1, 1:] + xp[1:, :-1] + xp[1:, 1:])
    py = 0.25 * (yp[:-1, :-1] + yp[:-1, 1:] + yp[1:, :-1] + yp[1:, 1:])
    return px, py


def _assemble(mask: np.ndarray, psi_x: np.ndarray, psi_y: np.ndarray,
              closed_edges: bool, dtype):
    """Segment extraction + 3x3 buckets + packed cell rows from the
    corner mesh."""
    ny, nx = mask.shape
    seg_a, seg_b, seg_kind = [], [], []
    seg_cells = []  # owning (j, i) of each segment
    edge_kind = LAND if closed_edges else OPEN

    def neighbor_state(j, i):
        if j < 0 or j >= ny or i < 0 or i >= nx:
            return "edge"
        return "water" if mask[j, i] else "land"

    def corner(j, i):
        return (psi_x[j, i], psi_y[j, i])

    for j in range(ny):
        for i in range(nx):
            if not mask[j, i]:
                continue
            sides = [
                (0, -1, corner(j, i), corner(j + 1, i)),           # west
                (0, +1, corner(j, i + 1), corner(j + 1, i + 1)),   # east
                (-1, 0, corner(j, i), corner(j, i + 1)),           # south
                (+1, 0, corner(j + 1, i), corner(j + 1, i + 1)),   # north
            ]
            for dj, di, a, b in sides:
                st = neighbor_state(j + dj, i + di)
                if st == "water":
                    continue
                seg_a.append(a)
                seg_b.append(b)
                seg_kind.append(LAND if st == "land" else edge_kind)
                seg_cells.append((j, i))

    if not seg_a:
        seg_a, seg_b, seg_kind, seg_cells = ([[0.0, 0.0]], [[0.0, 0.0]],
                                             [LAND], [(0, 0)])
    seg_a = np.asarray(seg_a, dtype)
    seg_b = np.asarray(seg_b, dtype)
    seg_kind = np.asarray(seg_kind, np.int32)

    cell_lists = [[[] for _ in range(nx)] for _ in range(ny)]
    for sid, (j, i) in enumerate(seg_cells):
        for jj in range(max(0, j - 1), min(ny, j + 2)):
            for ii in range(max(0, i - 1), min(nx, i + 2)):
                cell_lists[jj][ii].append(sid)
    s_max = max(1, max(len(cell_lists[j][i]) for j in range(ny)
                       for i in range(nx)))
    bucket = np.full((ny, nx, s_max), -1, np.int32)
    for j in range(ny):
        for i in range(nx):
            ids = cell_lists[j][i]
            bucket[j, i, :len(ids)] = ids

    rows = np.zeros((ny * nx, 8 + 8 * s_max), dtype)
    rows[:, 0] = mask.reshape(-1).astype(dtype)
    ms2x, ms2y = _cell_max_step2(psi_x, psi_y)
    rows[:, 3] = ms2x.reshape(-1)
    rows[:, 4] = ms2y.reshape(-1)
    for j in range(ny):
        for i in range(nx):
            for s, sid in enumerate(cell_lists[j][i]):
                o = 8 + 8 * s
                rows[j * nx + i, o:o + 6] = [
                    seg_a[sid, 0], seg_a[sid, 1], seg_b[sid, 0],
                    seg_b[sid, 1], float(seg_kind[sid]), 1.0]
    return seg_a, seg_b, seg_kind, bucket, rows


def _min3x3(a: np.ndarray) -> np.ndarray:
    """3x3-neighbourhood minimum (edge-padded)."""
    p = np.pad(a, 1, mode="edge")
    m = a
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            m = np.minimum(m, p[1 + dj:p.shape[0] - 1 + dj,
                               1 + di:p.shape[1] - 1 + di])
    return m


def _cell_max_step2(psi_x: np.ndarray, psi_y: np.ndarray):
    """Per-cell squared displacement-guard radii (ms2x, ms2y), each
    (Ny, Nx): 1.5 local cell edges per axis, the reach within which the
    3x3 bucket guarantees crossing detection."""
    hx = np.hypot(np.diff(psi_x, axis=1), np.diff(psi_y, axis=1))
    vy = np.hypot(np.diff(psi_x, axis=0), np.diff(psi_y, axis=0))
    cell_x = np.minimum(hx[:-1, :], hx[1:, :])
    cell_y = np.minimum(vy[:, :-1], vy[:, 1:])
    axis_aligned = (np.ptp(psi_x, axis=0).max() < 1e-9 * max(
        1.0, np.abs(psi_x).max())
        and np.ptp(psi_y, axis=1).max() < 1e-9 * max(
            1.0, np.abs(psi_y).max()))
    if axis_aligned:
        rx = 1.5 * _min3x3(cell_x)
        ry = 1.5 * _min3x3(cell_y)
    else:
        rx = ry = 1.5 * _min3x3(np.minimum(cell_x, cell_y))
    return (rx * rx).astype(np.float64), (ry * ry).astype(np.float64)


def build_boundaries(mask_rho, x_rho, y_rho, closed_edges=False,
                     dtype=np.float64, device="cpu") -> Boundaries:
    """createBounds analog (host numpy, once at init).

    closed_edges: treat the grid rim as land instead of open ocean."""
    mask = np.asarray(mask_rho).astype(np.int32)
    ny, nx = mask.shape
    xe = _cell_edges(np.asarray(x_rho, dtype))
    ye = _cell_edges(np.asarray(y_rho, dtype))
    psi_x = np.broadcast_to(xe[None, :], (ny + 1, nx + 1))
    psi_y = np.broadcast_to(ye[:, None], (ny + 1, nx + 1))
    seg_a, seg_b, seg_kind, bucket, rows = _assemble(
        mask, psi_x, psi_y, closed_edges, dtype)

    def t(a):
        return torch.as_tensor(a, device=device)

    # loose tolerance: f32-rounded images of a uniform axis still take
    # the arithmetic locate (buckets cover the 3x3 neighbourhood)
    return Boundaries(
        seg_a=t(seg_a), seg_b=t(seg_b), seg_kind=t(seg_kind),
        bucket=t(bucket), x_edges=t(xe), y_edges=t(ye), water=t(mask),
        cell_rows=t(rows),
        uniform=_is_uniform(xe, 1e-4) and _is_uniform(ye, 1e-4),
        edges=(float(xe[0]), float(xe[1] - xe[0]), float(ye[0]),
               float(ye[1] - ye[0]), float(xe[-1]), float(ye[-1])))


def build_boundaries_curv(mask_rho, x2d, y2d, curv: CurvMap,
                          closed_edges=False, dtype=np.float64,
                          device="cpu") -> Boundaries:
    """createBounds for a curvilinear grid: the segments are the quad
    edges of the psi mesh, cell location goes through the grid's inverse
    map, and x_edges / y_edges are a uniform bounding-box raster (the
    settlement pruning lattice)."""
    mask = np.asarray(mask_rho).astype(np.int32)
    ny, nx = mask.shape
    x2 = np.asarray(x2d, np.float64)
    y2 = np.asarray(y2d, np.float64)
    psi_x, psi_y = _psi_mesh(x2, y2)
    seg_a, seg_b, seg_kind, bucket, rows = _assemble(
        mask, psi_x, psi_y, closed_edges, dtype)
    xe = np.linspace(psi_x.min(), psi_x.max(), nx + 1)
    ye = np.linspace(psi_y.min(), psi_y.max(), ny + 1)
    # a point farther than a quarter of the shortest cell edge from its
    # clamped rim cell lies outside the domain
    ex = np.hypot(np.diff(x2, axis=1), np.diff(y2, axis=1)).min()
    ey = np.hypot(np.diff(x2, axis=0), np.diff(y2, axis=0)).min()
    tol = 0.25 * min(ex, ey)

    def t(a):
        return torch.as_tensor(a, device=device)

    return Boundaries(
        seg_a=t(seg_a), seg_b=t(seg_b), seg_kind=t(seg_kind),
        bucket=t(bucket), x_edges=t(xe), y_edges=t(ye), water=t(mask),
        cell_rows=t(rows), uniform=True,
        edges=(float(xe[0]), float(xe[1] - xe[0]), float(ye[0]),
               float(ye[1] - ye[0]), float(xe[-1]), float(ye[-1])),
        curv=curv, curv_tol2=float(tol * tol))


def _curv_cell(bounds: Boundaries, x, y):
    """Boundary cell (i, j) on a curvilinear grid: cell (j, i) spans the
    rho logical range [i - 0.5, i + 0.5]; and the map's resid2."""
    ny, nx = bounds.water.shape
    ti, tj, r2 = curv_logical(bounds.curv, nx, ny, x, y)
    i = torch.floor(ti + 0.5).clamp(0.0, nx - 1.0).to(torch.int32)
    j = torch.floor(tj + 0.5).clamp(0.0, ny - 1.0).to(torch.int32)
    return i, j, r2


def cell_of(bounds: Boundaries, x, y):
    """Rho-cell index (i, j) of a point, clamped to the grid."""
    ny, nx = bounds.water.shape
    if bounds.curv is not None:
        return _curv_cell(bounds, x, y)[:2]
    if bounds.uniform:
        x0, dx, y0, dy, _, _ = bounds.edges
        i = torch.floor((x - x0) / dx).to(torch.int32).clamp(0, nx - 1)
        j = torch.floor((y - y0) / dy).to(torch.int32).clamp(0, ny - 1)
        return i, j
    xe = bounds.x_edges.to(x.dtype)
    ye = bounds.y_edges.to(y.dtype)
    i = (torch.searchsorted(xe, x, right=True) - 1).clamp(0, nx - 1)
    j = (torch.searchsorted(ye, y, right=True) - 1).clamp(0, ny - 1)
    return i.to(torch.int32), j.to(torch.int32)


def in_water(bounds: Boundaries, x, y):
    """mbounds analog: is the point in a water cell of the domain?"""
    nx = bounds.water.shape[1]
    if bounds.curv is not None:
        i, j, r2 = _curv_cell(bounds, x, y)
        inside = r2 <= bounds.curv_tol2
    else:
        i, j = cell_of(bounds, x, y)
        x0, _, y0, _, x1, y1 = bounds.edges
        inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    wet = bounds.cell_rows[j.long() * nx + i.long(), 0] > 0.5
    return inside & wet


def reflect(bounds: Boundaries, x0, y0, x1, y1, open_exits: bool,
            n_iter: int = 4, eps: float = 1e-6):
    """intersect_reflect analog, vectorized over particles.

    Returns (x, y, hit_land_count, exited, stuck) — see the module
    docstring; ``stuck`` maps to status ERROR upstream."""
    dtype = x0.dtype
    n = x0.shape[0]
    nx_cells = bounds.water.shape[1]
    s_max = bounds.s_max
    hit_land = torch.zeros(n, dtype=torch.int32, device=x0.device)
    exited = torch.zeros(n, dtype=torch.bool, device=x0.device)
    px0, py0, px1, py1 = x0, y0, x1, y1
    tiny = torch.full((), 1e-30, dtype=dtype, device=x0.device)
    inf = torch.full((), float("inf"), dtype=dtype, device=x0.device)
    ms2x = ms2y = None
    # endpoints of the segment the previous pass reflected from (NaN: none;
    # kept on curvilinear grids only)
    last = torch.full((n, 1, 4), float("nan"), dtype=dtype, device=x0.device)
    skip_last = bounds.curv is not None

    for it in range(n_iter):
        ci, cj = cell_of(bounds, px0, py0)
        rows = bounds.cell_rows[cj.long() * nx_cells + ci.long()]
        if it == 0:
            # per-axis guard radii of the PRE-move cell (lanes 3/4)
            ms2x = rows[:, 3].to(dtype)
            ms2y = rows[:, 4].to(dtype)
        slots = rows[:, 8:].reshape(-1, s_max, 8).to(dtype)
        ax = slots[..., 0]
        ay = slots[..., 1]
        kind = slots[..., 4].to(torch.int32)
        valid = slots[..., 5] > 0.5

        dx = (px1 - px0)[:, None]
        dy = (py1 - py0)[:, None]
        ex = slots[..., 2] - ax
        ey = slots[..., 3] - ay
        apx = ax - px0[:, None]
        apy = ay - py0[:, None]
        denom = dx * ey - dy * ex
        denom_safe = torch.where(denom.abs() < 1e-30, tiny, denom)
        tp = (apx * ey - apy * ex) / denom_safe       # along particle path
        ts = (apx * dy - apy * dx) / denom_safe       # along segment
        crossing = (valid & (denom.abs() > 1e-30) & (tp > 0.0) & (tp <= 1.0)
                    & (ts >= 0.0) & (ts <= 1.0)
                    & ~(slots[..., :4] == last).all(dim=-1))
        tp_masked = torch.where(crossing, tp, inf)
        first = torch.argmin(tp_masked, dim=1, keepdim=True)
        act = crossing.gather(1, first)[:, 0] & ~exited

        tpf = torch.where(act, tp_masked.gather(1, first)[:, 0],
                          torch.zeros_like(px0))
        exf = ex.gather(1, first)[:, 0]
        eyf = ey.gather(1, first)[:, 0]
        kindf = kind.gather(1, first)[:, 0]
        segf = slots[..., :4].gather(1, first[..., None].expand(-1, 1, 4))

        ix = px0 + tpf * (px1 - px0)                  # intersection point
        iy = py0 + tpf * (py1 - py0)
        rx = px1 - ix                                 # remaining segment
        ry = py1 - iy
        elen2 = torch.maximum(exf * exf + eyf * eyf, tiny)
        proj = (rx * exf + ry * eyf) / elen2
        rrx = 2.0 * proj * exf - rx                   # specular reflection
        rry = 2.0 * proj * eyf - ry

        if open_exits:
            newly_exited = act & (kindf == OPEN)
            do_reflect = act & (kindf == LAND)
        else:
            newly_exited = torch.zeros_like(act)
            do_reflect = act

        # nudge the restart point off the wall
        nrm = torch.sqrt(torch.maximum(rrx * rrx + rry * rry, tiny))
        px0 = torch.where(do_reflect, ix + eps * rrx / nrm, px0)
        py0 = torch.where(do_reflect, iy + eps * rry / nrm, py0)
        px1 = torch.where(do_reflect, ix + rrx, px1)
        py1 = torch.where(do_reflect, iy + rry, py1)
        # exited particles stop at the open-boundary crossing point
        px1 = torch.where(newly_exited, ix, px1)
        py1 = torch.where(newly_exited, iy, py1)
        hit_land = hit_land + (do_reflect & (kindf == LAND)).to(torch.int32)
        exited = exited | newly_exited
        if skip_last:
            last = torch.where(do_reflect[:, None, None], segf, last)

    stuck = ~exited & ~in_water(bounds, px1, py1)
    # tunnel guard: a particle with no boundary interaction whose
    # straight-path midpoint is on land stepped over a spit
    no_interact = (hit_land == 0) & ~exited & ~stuck
    tunneled = no_interact & ~in_water(bounds, 0.5 * (x0 + px1),
                                       0.5 * (y0 + py1))
    stuck = stuck | tunneled
    # max-displacement guard: beyond 1.5 local cells per axis the 3x3
    # bucket no longer guarantees crossing detection
    over = ((x1 - x0) ** 2 > ms2x) | ((y1 - y0) ** 2 > ms2y)
    stuck = stuck | (~exited & over)
    return px1, py1, hit_land, exited, stuck


def reflect_vertical(z, zeta_p, h_p):
    """Surface/bottom specular reflection, then clamp to the column.
    Returns (z', hit_surface, hit_bottom)."""
    above = z > zeta_p
    z1 = torch.where(above, 2.0 * zeta_p - z, z)
    below = z1 < -h_p
    z2 = torch.where(below, -2.0 * h_p - z1, z1)
    z3 = torch.minimum(torch.maximum(z2, -h_p), zeta_p)
    return z3, above, below
