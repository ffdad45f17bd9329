"""Scalar sampling at particles (counterpart of ``ltjax.physics.advect``,
``sample_scalar`` only).

The reference's optional salt/temp sampling (SaltTempOn): a rho-grid
field is blended bilinearly per s-level and record, interpolated in time
(polintd), and the profile is fitted with the natural tension spline on
the particle's own s-level depths and evaluated at its z, the same
interpolation contract as ``find_currents``.  The rest of ltjax's
per-particle-spline path (``find_currents``, ``rk4_displacement``) is
not ported yet.
"""

from __future__ import annotations

from .. import tension
from ..fields import FieldSet
from ..grid import Grid
from ..interp import interp2d, interp_columns, locate_rho, polintd
from ..scoord import s_depths


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
    """Sample a rho-grid scalar (salt/temp) at particle positions."""
    z_r, prof_t = scalar_profile(grid, fields, field, x, y, t)
    z2 = tension.fit(z_r, prof_t, sigma)
    return tension.evaluate(z_r, prof_t, z2, sigma, z)
