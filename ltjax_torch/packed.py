"""Time-collapsed interpolation tables (counterpart of ``ltjax.packed``).

Reference semantics (``find_currents``): per time record, horizontal
bilinear of every s-level, vertical tension spline of the blended
profile, quadratic time interpolation.  The quadratic time weights are
shared by all particles, so collapsing the 3 records to a stage time
first commutes exactly with the bilinear blend.  This module holds the
"collapsed" scheme only: one cell table per stage time with the value
lanes

    [u (us) | v (us) | w (ws) | zeta | h]     (nv = 2*us + ws + 2)

(the record tables may carry ws Aks lanes and then us salt + us temp
lanes after h, see ``build_packed_records``).

u and v collocated to rho points; the blended profile is then fitted
and evaluated per particle (blend-then-fit, the reference ordering).
It is the plain version of the CUDA kernel in
``ltjax_torch.kernels.ext_step``, which gathers the raw record table
(``PackedRecords.tab``) and collapses per corner instead.

Not ported (TPU row-gather workarounds): the pair-packed column-spline
scheme (``stage_tables``/``find_currents_packed``), the record-row and
stacked-table helpers, and lane padding to 128.
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


def _eval_cubic_like(zq, zk, yk, z2, sigma: float):
    """Evaluate the tension spline at zq given per-particle knots.

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


def _blend_rows(grid: Grid, flat, x, y):
    """Bilinear blend of the rows of a (Ny*Nx, L) cell table."""
    i, j, fx, fy = locate_rho_ij(grid, x, y)
    c00 = j.long() * grid.nx + i.long()
    fxd = fx.to(flat.dtype)[:, None]
    fyd = fy.to(flat.dtype)[:, None]
    r00 = flat[c00]
    r01 = flat[c00 + 1]
    r10 = flat[c00 + grid.nx]
    r11 = flat[c00 + grid.nx + 1]
    return ((r00 * (1 - fxd) + r01 * fxd) * (1 - fyd)
            + (r10 * (1 - fxd) + r11 * fxd) * fyd)


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
    u = u.to(dtype)
    v = v.to(dtype)
    w = w.to(dtype)
    zab = z + h_p.to(dtype)
    ztb = torch.clamp(z_r0.to(dtype) + h_p.to(dtype), min=2.0 * z0m)
    decay = torch.log(torch.clamp(zab, min=z0m) / z0m) / torch.log(ztb / z0m)
    factor = torch.where(zab < ztb, decay.clamp(0.0, 1.0),
                         torch.ones_like(decay))
    return u * factor, v * factor, w


def rk4_displacement_collapsed(grid: Grid, vtabs, x, y, z, sigma: float,
                               z0m: float, idt: float):
    """RK4 displacement from the 3 stage tables (t, t+idt/2, t+idt);
    stages 2 and 3 share the midpoint table."""
    t1, t2, t4 = vtabs
    dt = torch.as_tensor(idt, dtype=x.dtype)
    half = 0.5 * dt
    u1, v1, w1 = find_currents_collapsed(grid, t1, x, y, z, sigma, z0m)
    u2, v2, w2 = find_currents_collapsed(
        grid, t2, x + u1 * half, y + v1 * half, z + w1 * half, sigma, z0m)
    u3, v3, w3 = find_currents_collapsed(
        grid, t2, x + u2 * half, y + v2 * half, z + w2 * half, sigma, z0m)
    u4, v4, w4 = find_currents_collapsed(
        grid, t4, x + u3 * dt, y + v3 * dt, z + w3 * dt, sigma, z0m)
    sixth = dt / 6.0
    return (sixth * (u1 + 2 * u2 + 2 * u3 + u4),
            sixth * (v1 + 2 * v2 + 2 * v3 + v4),
            sixth * (w1 + 2 * w2 + 2 * w3 + w4))


def zeta_h_packed(grid: Grid, vt: ValueTable, x, y):
    """Free surface + bathymetry at particles from one stage table."""
    nv = vt.full.shape[-1]
    flat = vt.full.reshape(-1, nv)[:, nv - 2:]
    zh = _blend_rows(grid, flat, x, y)
    return zh[:, 0].to(x.dtype), zh[:, 1].to(x.dtype)
