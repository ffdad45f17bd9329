"""The native advection route and scalar sampling (counterpart of
``ltjax.physics.advect``).

The reference's own interpolation order (LTRANS.f90 ``find_currents``):

  find_currents(x, y, z, t) =
    per record b, c, f:
      bilinear blend of every s-level at the particle  -> its profile
      tension-spline fit on that record's own s-depths, evaluated at z
    quadratic time interpolation across the 3 records  (polintd)
    near-bottom log-layer decay of u, v to zero at roughness z0
  RK4:  k1 at t; k2, k3 at t+dt/2 (midpoint positions); k4 at t+dt;
        displacement = dt*(k1 + 2k2 + 2k3 + k4)/6 per component.

It runs as PyTorch ops on the positions' device (``cfg.fast_interp =
False`` or ``tension_sigma < 0``: ``step.internal_step(mode="native")``).
With a negative sigma each record's profile gets its own adaptive
per-interval tension (``tension.adaptive_sigma``).  The collapsed scheme
of the CUDA kernels (``ltjax_torch.packed``) interpolates in time first
and fits once; the two agree only when zeta is constant in time and the
fields are linear in x and y.

``sample_scalar`` is the optional salt/temp sampling (SaltTempOn): the
profile is interpolated in time first, then fitted on the particle's
s-depths at that time and evaluated at z.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tension
from ..fields import FieldSet
from ..grid import Grid
from ..interp import (interp2d, interp_columns, locate_rho, locate_uvr,
                      polintd)
from ..scoord import s_depths


class AdvectParams(NamedTuple):
    """Numerics of the native route."""
    sigma: float = 0.0        # spline tension (dimensionless); <0 adaptive
    z0: float = 0.0005        # bottom roughness height [m]
    idt: float = 120.0        # internal step [s]


def _columns(field, i, j, fx, fy, dtype):
    """A level-resolved field's (3, N, K) profiles at the particles, in
    the positions' dtype (blended in the field's)."""
    fd = field.dtype
    return interp_columns(field, i, j, fx.to(fd), fy.to(fd)).to(dtype)


def _eval_profile(zk, prof, z, sigma):
    """Fit and evaluate the vertical tension spline per record and
    particle: zk, prof (3, N, K), z (N,) -> (3, N)."""
    sig = tension.adaptive_sigma(zk, prof) if sigma < 0 else sigma
    z2 = tension.fit(zk, prof, sig)
    return tension.evaluate(zk, prof, z2, sig, z)


def find_currents(grid: Grid, fields: FieldSet, x, y, z, t,
                  params: AdvectParams = AdvectParams()):
    """(u, v, w) at the particles at time t (a host float), in the
    positions' dtype."""
    dtype = x.dtype
    ((iu, ju, fxu, fyu), (iv, jv, fxv, fyv),
     (ir, jr, fxr, fyr)) = locate_uvr(grid, x, y)
    u_prof = _columns(fields.u, iu, ju, fxu, fyu, dtype)       # (3,N,us)
    v_prof = _columns(fields.v, iv, jv, fxv, fyv, dtype)
    w_prof = _columns(fields.w, ir, jr, fxr, fyr, dtype)       # (3,N,ws)
    zd, hd = fields.zeta.dtype, grid.h.dtype
    zeta_p = interp2d(fields.zeta, ir, jr, fxr.to(zd),
                      fyr.to(zd)).to(dtype)                     # (3,N)
    h_p = interp2d(grid.h, ir, jr, fxr.to(hd), fyr.to(hd)).to(dtype)

    # the s-level depths of each record (zeta differs between them)
    z_r = s_depths(zeta_p, h_p, grid.s_rho.to(dtype), grid.Cs_r.to(dtype),
                   grid.hc, grid.vtransform)                    # (3,N,us)
    z_w = s_depths(zeta_p, h_p, grid.s_w.to(dtype), grid.Cs_w.to(dtype),
                   grid.hc, grid.vtransform)                    # (3,N,ws)
    u_t = polintd(_eval_profile(z_r, u_prof, z, params.sigma),
                  fields.times, t)
    v_t = polintd(_eval_profile(z_r, v_prof, z, params.sigma),
                  fields.times, t)
    w_t = polintd(_eval_profile(z_w, w_prof, z, params.sigma),
                  fields.times, t)

    # log layer: u, v decay to 0 at z0 below record c's lowest rho level
    z0 = torch.full((), params.z0, dtype=dtype, device=x.device)
    zab = z + h_p                                   # height above bottom
    ztb = torch.maximum(z_r[1, :, 0] + h_p, 2.0 * z0)
    decay = torch.log(torch.maximum(zab, z0) / z0) / torch.log(ztb / z0)
    factor = torch.where(zab < ztb, decay.clamp(0.0, 1.0),
                         torch.ones_like(decay))
    return u_t * factor, v_t * factor, w_t


def scalar_profile(grid: Grid, fields: FieldSet, field, x, y, t):
    """(z_r, prof): the rho-level depths (N, us) of the particles' columns
    at time t and the field's profile (N, us) there."""
    dtype = x.dtype
    ir, jr, fxr, fyr = locate_rho(grid, x, y)
    fd = field.dtype
    prof = interp_columns(field, ir, jr, fxr.to(fd),
                          fyr.to(fd)).to(dtype)                  # (3,N,us)
    zeta_l = interp2d(fields.zeta, ir, jr, fxr.to(fd),
                      fyr.to(fd)).to(dtype)
    hd = grid.h.dtype
    h_p = interp2d(grid.h, ir, jr, fxr.to(hd), fyr.to(hd)).to(dtype)
    prof_t = polintd(prof, fields.times, t)
    zeta_t = polintd(zeta_l, fields.times, t)
    z_r = s_depths(zeta_t, h_p, grid.s_rho.to(dtype), grid.Cs_r.to(dtype),
                   grid.hc, grid.vtransform)
    return z_r, prof_t


def sample_scalar(grid: Grid, fields: FieldSet, field, x, y, z, t,
                  sigma=0.0):
    """Sample a rho-grid scalar (salt/temp) at particle positions.  A
    negative sigma is not adaptive here: it takes the small-u series at
    |sigma|, as ltjax's does."""
    z_r, prof_t = scalar_profile(grid, fields, field, x, y, t)
    z2 = tension.fit(z_r, prof_t, sigma)
    return tension.evaluate(z_r, prof_t, z2, sigma, z)
