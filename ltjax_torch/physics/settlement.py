"""Habitat-polygon settlement (counterpart of ``ltjax.physics.settlement``).

Reference: settlement_module.f90 + point_in_polygon_module.f90
(``initSettlement`` loads habitat and hole polygons from CSV and maps
them to grid cells; ``testSettlement`` settles a particle older than
``pediage`` inside a habitat polygon and not inside a hole, freezing it
and recording the polygon id).

Polygons are padded vertex arrays kept in float64; a host raster pass
gives each cell of the boundary edge lattice its candidate polygons
(bounding-box overlap, -1 padded).  The test gathers a particle's
candidate list and ray-casts every candidate, in float64 on the
positions promoted.  The CUDA kernel (``kernels/csrc/ext_step.cu``) runs
the same test per particle, in double, in the same candidate order.

Polygon CSV format (``habitatfile``/``holefile``): rows of ``lon, lat,
polyid``, the vertices of each polygon contiguous.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class Polygons:
    verts_x: torch.Tensor     # (P, Vmax) f64, padded with the last vertex
    verts_y: torch.Tensor     # (P, Vmax)
    nverts: torch.Tensor      # (P,) int32
    poly_id: torch.Tensor     # (P,) int32 external polygon ids
    cell_cands: torch.Tensor  # (Ny, Nx, Cmax) int32 candidate rows, -1 pad

    @property
    def n_polys(self) -> int:
        return self.verts_x.shape[0]


def read_polygon_csv(path: str):
    """Parse a polygon CSV into [(poly_id, (V,2) vertices), ...]."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p for p in line.replace(",", " ").split() if p]
            if len(parts) < 3:
                continue
            rows.append((float(parts[0]), float(parts[1]),
                         int(float(parts[2]))))
    polys = []
    cur_id, cur = None, []
    for x, y, pid in rows:
        if cur_id is None or pid != cur_id:
            if cur:
                polys.append((cur_id, np.asarray(cur)))
            cur_id, cur = pid, []
        cur.append((x, y))
    if cur:
        polys.append((cur_id, np.asarray(cur)))
    return polys


def build_polygons(polys, x_edges, y_edges, dtype=np.float64,
                   device="cpu") -> Optional[Polygons]:
    """Pad polygons + rasterize candidate lists onto the cell lattice.

    polys: [(poly_id, (V, 2) xy-vertex array), ...] in internal metres
    (callers project lon/lat first); x_edges/y_edges: the cell edges."""
    if not polys:
        return None
    P = len(polys)
    vmax = max(len(v) for _, v in polys)
    vx = np.zeros((P, vmax), dtype)
    vy = np.zeros((P, vmax), dtype)
    nv = np.zeros(P, np.int32)
    pid = np.zeros(P, np.int32)
    for k, (i, v) in enumerate(polys):
        n = len(v)
        vx[k, :n] = v[:, 0]
        vy[k, :n] = v[:, 1]
        vx[k, n:] = v[-1, 0]   # pad by repeating the last vertex
        vy[k, n:] = v[-1, 1]   # (degenerate edges cross nothing)
        nv[k] = n
        pid[k] = i

    xe = np.asarray(x_edges)
    ye = np.asarray(y_edges)
    ny = len(ye) - 1
    nx = len(xe) - 1
    cell_lists = [[[] for _ in range(nx)] for _ in range(ny)]
    for k in range(P):
        x0, x1 = vx[k].min(), vx[k].max()
        y0, y1 = vy[k].min(), vy[k].max()
        i0 = max(0, int(np.searchsorted(xe, x0, "right")) - 1)
        i1 = min(nx - 1, int(np.searchsorted(xe, x1, "right")) - 1)
        j0 = max(0, int(np.searchsorted(ye, y0, "right")) - 1)
        j1 = min(ny - 1, int(np.searchsorted(ye, y1, "right")) - 1)
        for j in range(j0, j1 + 1):
            for i in range(i0, i1 + 1):
                cell_lists[j][i].append(k)
    cmax = max(1, max(len(cell_lists[j][i]) for j in range(ny)
                      for i in range(nx)))
    cands = np.full((ny, nx, cmax), -1, np.int32)
    for j in range(ny):
        for i in range(nx):
            ids = cell_lists[j][i]
            cands[j, i, :len(ids)] = ids

    def t(a):
        return torch.as_tensor(a, device=device)

    return Polygons(verts_x=t(vx), verts_y=t(vy), nverts=t(nv),
                    poly_id=t(pid), cell_cands=t(cands))


def point_in_polygon(vx, vy, px, py):
    """Ray-casting test, vectorized.

    vx, vy: (..., Vmax) padded vertex loops; px, py: (...,) points.
    Returns bool (...,).  The closing edge runs from the last padded
    vertex (the polygon's last) back to vertex 0."""
    x2 = torch.roll(vx, -1, dims=-1)
    y2 = torch.roll(vy, -1, dims=-1)
    p = px[..., None]
    q = py[..., None]
    straddles = (vy > q) != (y2 > q)
    dy = torch.where(straddles, y2 - vy, torch.ones_like(vy))
    x_cross = vx + (q - vy) * (x2 - vx) / dy
    crossings = (straddles & (p < x_cross)).sum(dim=-1)
    return (crossings % 2) == 1


def _locate_edges(edges, v, nmax: int, uniform: bool):
    """Cell index of v in an edge lattice (arithmetic on a uniform one)."""
    if uniform:
        t = (v - edges[0]) / (edges[1] - edges[0])
        return torch.floor(t).clamp(0, nmax - 1).long()
    return (torch.searchsorted(edges, v.contiguous(), right=True) - 1
            ).clamp(0, nmax - 1)


def _candidates_inside(polys: Polygons, x_edges, y_edges, x, y,
                       uniform: bool):
    """(N, Cmax) candidate rows of each point's cell and which contain it."""
    i = _locate_edges(x_edges, x, polys.cell_cands.shape[1], uniform)
    j = _locate_edges(y_edges, y, polys.cell_cands.shape[0], uniform)
    cands = polys.cell_cands[j, i].long()               # (N, Cmax)
    ck = cands.clamp(min=0)
    inside = point_in_polygon(polys.verts_x[ck], polys.verts_y[ck],
                              x[:, None], y[:, None]) & (cands >= 0)
    return ck, inside


def test_settlement(polys: Optional[Polygons], holes: Optional[Polygons],
                    x_edges, y_edges, x, y, eligible, uniform: bool = False):
    """testSettlement for the whole batch: (settles, poly_id).

    settles[i] if particle i is eligible, inside a habitat polygon and in
    no hole; poly_id is the first containing candidate's id, else -1.
    The test runs in float64 (the vertices' dtype) on the positions."""
    n = x.shape[0]
    if polys is None:
        return (torch.zeros(n, dtype=torch.bool, device=x.device),
                torch.full((n,), -1, dtype=torch.int32, device=x.device))
    xd = x.to(polys.verts_x.dtype)
    yd = y.to(polys.verts_y.dtype)
    xe = x_edges.to(device=x.device, dtype=xd.dtype)
    ye = y_edges.to(device=x.device, dtype=yd.dtype)
    ck, inside = _candidates_inside(polys, xe, ye, xd, yd, uniform)
    hit_any = inside.any(dim=1)
    first = inside.to(torch.int8).argmax(dim=1)
    pid = polys.poly_id[ck[torch.arange(n, device=x.device), first]]
    if holes is not None:
        _, in_hole = _candidates_inside(holes, xe, ye, xd, yd, uniform)
        hit_any = hit_any & ~in_hole.any(dim=1)
    settles = hit_any & eligible
    return settles, torch.where(settles, pid, torch.full_like(pid, -1)).to(
        torch.int32)
