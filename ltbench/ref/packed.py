"""Time-collapsed interpolation tables (counterpart of ``ltjax.packed``).

Reference semantics (``find_currents``): per time record, horizontal
bilinear of every s-level, vertical tension spline of the blended
profile, quadratic time interpolation.  The quadratic time weights are
shared by all particles, so collapsing the 3 records to a stage time
first commutes exactly with the bilinear blend.  Two schemes follow
the collapse, as in ltjax:

* the "collapsed" scheme (blend-then-fit, the reference ordering): one
  cell table per stage time with the value lanes

      [u (us) | v (us) | w (ws) | zeta | h]     (nv = 2*us + ws + 2)

  (the record tables may carry ws Aks lanes and then us salt + us temp
  lanes after h, see ``build_packed_records``), blended at the particle
  and fitted and evaluated per particle.  It is the plain version of
  the CUDA kernels in ``ltjax_torch.kernels``, which gather the raw
  record table (``PackedRecords.tab``) and collapse per corner instead;
* the "packed" scheme (fit-then-blend, ltjax's ``stage_tables`` /
  ``find_currents_packed``, ``kernel_interp = False``): the tension
  spline fitted densely per grid column of the stage table
  (``StageTable``: the value lanes and their z2 lanes), evaluated at
  the particle's depth on each of the 4 corners' own knots, and the 4
  values blended.  A different interpolant of the same data.

u and v are collocated to rho points in both.  Not ported (TPU
row-gather workarounds): the pair-row layout (``row c = [cell c | cell
c+1]``) and its 8-lane zeta/h rows, the record-row and stacked-table
helpers, and lane padding to 128: the corners are gathered from the
per-cell table.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import tension
from .fields import FieldSet
from .grid import Grid, locate_rho_ij
from .interp import polintd


@dataclass
class PackedRecords:
    """Per-record packed cell tables (built once per external step)."""
    tab: torch.Tensor    # (R, Ny*Nx, nv) value lanes
    times: torch.Tensor  # (R,) float64 on the CPU


@dataclass
class ValueTable:
    """One time-collapsed values table."""
    full: torch.Tensor   # (Ny, Nx, nv)
    t: float             # stage time [s]


@dataclass
class StageTable:
    """One time-collapsed table with its per-column spline fits (the
    packed scheme): per cell the nv value lanes, then the z2 lanes of u
    (us), v (us) and w (ws)."""
    full: torch.Tensor   # (Ny, Nx, nv + 2*us + ws)
    t: float             # stage time [s]


def _collocate_u(u):
    """(..., Ny, Nx-1, K) u-grid -> (..., Ny, Nx, K) rho-collocated."""
    mid = 0.5 * (u[..., :, 1:, :] + u[..., :, :-1, :])
    return torch.cat([u[..., :, :1, :], mid, u[..., :, -1:, :]], dim=-2)


def _collocate_v(v, ny: int):
    """(..., Ny-1, Nx, K) v-grid -> (..., Ny, Nx, K) rho-collocated.  A
    tile of a sharded run carries Ny v rows (row j between rho rows j and
    j+1, as ltjax's tiles do): its first row is taken as it is."""
    mid = 0.5 * (v[..., 1:, :, :] + v[..., :-1, :, :])
    if v.shape[-3] == ny:
        return torch.cat([v[..., :1, :, :], mid], dim=-3)
    if v.shape[-3] != ny - 1:
        raise ValueError(f"v has {v.shape[-3]} eta rows, the grid {ny}")
    return torch.cat([v[..., :1, :, :], mid, v[..., -1:, :, :]], dim=-3)


def n_value_lanes(us: int, ws: int) -> int:
    return us + us + ws + 2


def build_packed_records(grid: Grid, fields: FieldSet,
                         with_aks: bool = False,
                         with_scalars: bool = False) -> PackedRecords:
    """Dense per-record packing: collocate u, v onto rho points and
    concatenate the value lanes of every record.  ``with_aks`` appends
    the ws Aks lanes after h, ``with_scalars`` the us salt + us temp
    lanes after those (the layout of ltjax.packed); the CUDA kernel's
    Visser, SaltTempOn and behavior-4/5 lanes read them, the plain
    version reads the FieldSet and ignores them."""
    u = _collocate_u(fields.u)                       # (R, Ny, Nx, us)
    v = _collocate_v(fields.v, grid.ny)
    w = fields.w
    z = fields.zeta[..., None]
    h = torch.broadcast_to(grid.h.to(u.dtype)[None, ..., None], z.shape)
    lanes = [u, v, w, z, h]
    if with_aks:
        lanes.append(fields.aks.to(u.dtype))
    if with_scalars:
        lanes += [fields.salt.to(u.dtype), fields.temp.to(u.dtype)]
    tab = torch.cat(lanes, dim=-1)
    R, ny, nx, nv = tab.shape
    return PackedRecords(tab=tab.reshape(R, ny * nx, nv).contiguous(),
                         times=fields.times)


def _knots(zeta, h, s, cs, hc, vtransform):
    """s-level depths, broadcast over a trailing knot axis:
    zeta/h (...,); s/cs (K,) -> (..., K).  Mirrors scoord.s_depths."""
    zeta = zeta[..., None]
    h = h[..., None]
    if vtransform == 1:
        z0 = hc * s + (h - hc) * cs
        return z0 + zeta * (1.0 + z0 / h)
    s_ = (hc * s + h * cs) / (hc + h)
    return zeta + (zeta + h) * s_


def collapse_stage_values(grid: Grid, rec: PackedRecords, t) -> ValueTable:
    """Time-collapse the 3 records to stage time t (the nv value lanes)."""
    nv = n_value_lanes(grid.us, grid.ws)
    vals = polintd(rec.tab[..., :nv], rec.times, t)  # (C, nv)
    return ValueTable(full=vals.reshape(grid.ny, grid.nx, -1), t=float(t))


def stage_value_tables(grid: Grid, rec: PackedRecords, t, idt: float):
    """The 3 RK4 stage tables (t, t + idt/2, t + idt)."""
    t = float(t)
    return (collapse_stage_values(grid, rec, t),
            collapse_stage_values(grid, rec, t + 0.5 * idt),
            collapse_stage_values(grid, rec, t + idt))


def collapse_stage(grid: Grid, rec: PackedRecords, t,
                   sigma: float) -> StageTable:
    """Time-collapse the 3 records to stage time t and fit the vertical
    tension splines of u, v and w per grid column (the packed scheme):
    the knots are each column's own s-level depths at the collapsed
    zeta, made in the s-levels' dtype and cast to the table's."""
    us, ws = grid.us, grid.ws
    nv = n_value_lanes(us, ws)
    vals = polintd(rec.tab[..., :nv], rec.times, t)  # (C, nv)
    dtype = vals.dtype
    sdt = grid.s_rho.dtype
    zeta = vals[:, nv - 2].to(sdt)
    h = vals[:, nv - 1].to(sdt)
    z_r = _knots(zeta, h, grid.s_rho, grid.Cs_r, grid.hc,
                 grid.vtransform).to(dtype)
    z_w = _knots(zeta, h, grid.s_w, grid.Cs_w, grid.hc,
                 grid.vtransform).to(dtype)
    full = torch.cat([vals, tension.fit(z_r, vals[:, 0:us], sigma),
                      tension.fit(z_r, vals[:, us:2 * us], sigma),
                      tension.fit(z_w, vals[:, 2 * us:2 * us + ws], sigma)],
                     dim=-1)
    return StageTable(full=full.reshape(grid.ny, grid.nx, -1), t=float(t))


def stage_tables(grid: Grid, rec: PackedRecords, t, idt: float,
                 sigma: float):
    """The 3 packed-scheme stage tables (t, t + idt/2, t + idt)."""
    t = float(t)
    return (collapse_stage(grid, rec, t, sigma),
            collapse_stage(grid, rec, t + 0.5 * idt, sigma),
            collapse_stage(grid, rec, t + idt, sigma))


def _eval_cubic_like(zq, zk, yk, z2, sigma: float):
    """Evaluate the tension spline at zq given per-particle (or
    per-corner) knots.

    zq: (...,); zk/yk/z2: (..., K).  sigma is the static tension (0 =>
    natural cubic).  zq is clamped to the knot range."""
    K = zk.shape[-1]
    zq = torch.minimum(torch.maximum(zq, zk[..., 0]), zk[..., -1])
    j = (zq[..., None] >= zk[..., 1:]).sum(dim=-1).clamp(0, K - 2)[..., None]
    z0 = zk.gather(-1, j)[..., 0]
    z1 = zk.gather(-1, j + 1)[..., 0]
    y0 = yk.gather(-1, j)[..., 0]
    y1 = yk.gather(-1, j + 1)[..., 0]
    s0 = z2.gather(-1, j)[..., 0]
    s1 = z2.gather(-1, j + 1)[..., 0]
    hh = z1 - z0
    B2 = (zq - z0) / hh
    B1 = 1.0 - B2
    if sigma == 0.0:
        g1 = (B1 * B1 * B1 - B1) / 6.0
        g2 = (B2 * B2 * B2 - B2) / 6.0
    else:
        g1 = tension._gs(sigma, B1)
        g2 = tension._gs(sigma, B2)
    return y0 * B1 + y1 * B2 + hh * hh * (s0 * g1 + s1 * g2)


def _fit_eval_profile(grid: Grid, prof_u, prof_v, prof_w, zeta_p, h_p, z,
                      sigma: float):
    """Blend-then-fit vertical scheme on blended profiles.

    prof_u/v: (..., us); prof_w: (..., ws); zeta_p/h_p/z: (...,)."""
    dtype = prof_u.dtype
    sdt = grid.s_rho.dtype
    z_r = _knots(zeta_p.to(sdt), h_p.to(sdt), grid.s_rho, grid.Cs_r,
                 grid.hc, grid.vtransform).to(dtype)
    z_w = _knots(zeta_p.to(sdt), h_p.to(sdt), grid.s_w, grid.Cs_w,
                 grid.hc, grid.vtransform).to(dtype)
    z2u = tension.fit(z_r, prof_u, sigma)
    z2v = tension.fit(z_r, prof_v, sigma)
    z2w = tension.fit(z_w, prof_w, sigma)
    u = _eval_cubic_like(z, z_r, prof_u, z2u, sigma)
    v = _eval_cubic_like(z, z_r, prof_v, z2v, sigma)
    w = _eval_cubic_like(z, z_w, prof_w, z2w, sigma)
    return u, v, w, z_r[..., 0]


def gather_corners(grid: Grid, flat, x, y):
    """The 4 corner cells of each particle's rho cell from a (Ny*Nx, L)
    per-cell table: (cells, fx, fy), cells (N, 2, 2, L) with axes (eta
    corner, xi corner).  ltjax gathers them as two pair rows [cell c |
    cell c+1] of a table rolled by one cell, so the second half of a row
    at i = nx - 1 holds the next eta row's first cell (row C - 1: cell 0,
    wrapped by the roll).  ``locate_rho_ij`` clamps i to nx - 2 and j to
    ny - 2, as ltjax.grid.locate_rho_ij does, so no such row is read and
    the per-cell gather reads the same values."""
    i, j, fx, fy = locate_rho_ij(grid, x, y)
    nx = grid.nx
    c00 = j.long() * nx + i.long()
    idx = torch.stack([c00, c00 + 1, c00 + nx, c00 + nx + 1], dim=-1)
    return flat[idx].reshape(x.shape[0], 2, 2, -1), fx, fy


def _blend(vals, wx, wy):
    """Bilinear blend over the corner axes of vals (N, 2, 2[, L])."""
    shape = (-1,) + (1,) * (vals.dim() - 3)
    wx = wx.to(vals.dtype).reshape(shape)
    wy = wy.to(vals.dtype).reshape(shape)
    top = vals[:, 0, 0] * (1 - wx) + vals[:, 0, 1] * wx
    bot = vals[:, 1, 0] * (1 - wx) + vals[:, 1, 1] * wx
    return top * (1 - wy) + bot * wy


def _blend_rows(grid: Grid, flat, x, y):
    """Bilinear blend of the rows of a (Ny*Nx, L) cell table."""
    return _blend(*gather_corners(grid, flat, x, y))


def _log_layer(z, h_p, z_r0, z0m: float):
    """The near-bottom log-layer factor of u and v (1 above the lowest
    rho level): z, the particle's depth; h_p, z_r0 the blended depth and
    lowest rho-level depth at the particle."""
    zab = z + h_p
    ztb = torch.clamp(z_r0 + h_p, min=2.0 * z0m)
    decay = torch.log(torch.clamp(zab, min=z0m) / z0m) / torch.log(ztb / z0m)
    return torch.where(zab < ztb, decay.clamp(0.0, 1.0),
                       torch.ones_like(decay))


def find_currents_collapsed(grid: Grid, vt: ValueTable, x, y, z,
                            sigma: float, z0m: float):
    """(u, v, w) at particle positions from one stage table: bilinear
    blend of every lane, per-particle spline fit/eval, log-layer decay
    of u and v near the bottom."""
    dtype = x.dtype
    us, ws = grid.us, grid.ws
    nv = n_value_lanes(us, ws)
    flat = vt.full.reshape(-1, vt.full.shape[-1])
    blended = _blend_rows(grid, flat, x, y)                # (N, nv)
    zeta_p = blended[:, nv - 2]
    h_p = blended[:, nv - 1]
    u, v, w, z_r0 = _fit_eval_profile(
        grid, blended[:, 0:us], blended[:, us:2 * us],
        blended[:, 2 * us:2 * us + ws], zeta_p, h_p, z.to(blended.dtype),
        sigma)
    factor = _log_layer(z, h_p.to(dtype), z_r0.to(dtype), z0m)
    return u.to(dtype) * factor, v.to(dtype) * factor, w.to(dtype)


def find_currents_packed(grid: Grid, table: StageTable, x, y, z,
                         sigma: float, z0m: float):
    """(u, v, w) at particle positions from one packed stage table: the
    column splines evaluated at z on each corner's own knots, the 4
    values blended, log-layer decay of u and v near the bottom."""
    dtype = x.dtype
    us, ws = grid.us, grid.ws
    nv = n_value_lanes(us, ws)
    cells, wx, wy = gather_corners(
        grid, table.full.reshape(-1, table.full.shape[-1]), x, y)
    cd = cells.dtype
    zq = z.to(cd)[:, None, None].expand(cells.shape[:3])
    zeta_c = cells[..., nv - 2]
    h_c = cells[..., nv - 1]
    sdt = grid.s_rho.dtype
    z_r = _knots(zeta_c.to(sdt), h_c.to(sdt), grid.s_rho, grid.Cs_r,
                 grid.hc, grid.vtransform).to(cd)
    z_w = _knots(zeta_c.to(sdt), h_c.to(sdt), grid.s_w, grid.Cs_w,
                 grid.hc, grid.vtransform).to(cd)
    z2 = cells[..., nv:]
    u_c = _eval_cubic_like(zq, z_r, cells[..., 0:us], z2[..., 0:us], sigma)
    v_c = _eval_cubic_like(zq, z_r, cells[..., us:2 * us],
                           z2[..., us:2 * us], sigma)
    w_c = _eval_cubic_like(zq, z_w, cells[..., 2 * us:2 * us + ws],
                           z2[..., 2 * us:2 * us + ws], sigma)
    h_p = _blend(h_c, wx, wy).to(dtype)
    factor = _log_layer(z, h_p, _blend(z_r[..., 0], wx, wy).to(dtype), z0m)
    return (_blend(u_c, wx, wy).to(dtype) * factor,
            _blend(v_c, wx, wy).to(dtype) * factor,
            _blend(w_c, wx, wy).to(dtype))


def _rk4(find, tables, x, y, z, idt: float):
    """RK4 displacement from the 3 stage tables (t, t+idt/2, t+idt) with
    ``find(table, x, y, z) -> (u, v, w)``; stages 2 and 3 share the
    midpoint table."""
    t1, t2, t4 = tables
    dt = torch.as_tensor(idt, dtype=x.dtype)
    half = 0.5 * dt
    u1, v1, w1 = find(t1, x, y, z)
    u2, v2, w2 = find(t2, x + u1 * half, y + v1 * half, z + w1 * half)
    u3, v3, w3 = find(t2, x + u2 * half, y + v2 * half, z + w2 * half)
    u4, v4, w4 = find(t4, x + u3 * dt, y + v3 * dt, z + w3 * dt)
    sixth = dt / 6.0
    return (sixth * (u1 + 2 * u2 + 2 * u3 + u4),
            sixth * (v1 + 2 * v2 + 2 * v3 + v4),
            sixth * (w1 + 2 * w2 + 2 * w3 + w4))


def rk4_displacement_collapsed(grid: Grid, vtabs, x, y, z, sigma: float,
                               z0m: float, idt: float):
    """RK4 displacement on the collapsed scheme (3 ValueTables)."""
    return _rk4(lambda tab, *q: find_currents_collapsed(grid, tab, *q,
                                                        sigma, z0m),
                vtabs, x, y, z, idt)


def zeta_h_packed(grid: Grid, table, x, y):
    """Free surface + bathymetry at particles from one stage table of
    either scheme (a ValueTable or a StageTable: lanes nv-2, nv-1)."""
    nv = n_value_lanes(grid.us, grid.ws)
    flat = table.full.reshape(-1, table.full.shape[-1])[:, nv - 2:nv]
    zh = _blend_rows(grid, flat, x, y)
    return zh[:, 0].to(x.dtype), zh[:, 1].to(x.dtype)
