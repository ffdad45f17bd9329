"""Horizontal and vertical turbulence (counterpart of
``ltjax.physics.turb``).

* ``hturb``: random-walk displacement N(0,1) * sqrt(2 ConstantHTurb idt)
  per horizontal axis (HTURB substream, Box-Muller).
* ``vturb``: Visser (1997) random-displacement model on the Aks(z)
  profile of the 3-record window, blended at the particle and
  interpolated to time t, clipped at >= 0 and tension-spline fitted:

      dz = K'(z) idt + R sqrt(2 K(z_mid) idt / r),
      z_mid = clip(z + K'(z) idt / 2, z_w[0], z_w[-1]),

  R ~ U(-1, 1) (VTURB substream), r = Var(R) = 1/3; or R sqrt(2 K idt / r)
  with the constant K = ConstantVTurb when ``use_aks`` is off.

Both take the seed in place of ltjax's key (``ltjax_torch.rng``) and
return displacements; reflection happens downstream in the step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng, tension
from ..fields import FieldSet
from ..grid import Grid
from ..interp import interp2d, interp_columns, locate_rho, polintd
from ..scoord import s_depths


class TurbParams(NamedTuple):
    ConstantHTurb: float = 0.0
    ConstantVTurb: float = 0.0
    use_aks: bool = True      # spline the ROMS Aks profile (readAks)
    sigma: float = 0.0        # spline tension for the K(z) profile
    idt: float = 120.0


def hturb(seed, step, pids, idt, constant_hturb, dtype):
    """(dx, dy) horizontal random-walk displacements."""
    r = rng.normal(seed, step, rng.HTURB, pids, (2,), dtype)
    idt = torch.as_tensor(idt, dtype=dtype, device=pids.device)
    scale = torch.sqrt(2.0 * constant_hturb * idt)
    return r[:, 0] * scale, r[:, 1] * scale


def vturb(grid: Grid, fields: FieldSet, seed, step, pids, x, y, z, t,
          params: TurbParams, profile=None):
    """dz vertical random displacement (Visser RDM).  ``profile(x, y) ->
    (z_w, aks)``, if given, takes the place of the FieldSet's Aks
    column at t: the w-level depths and the Aks profile (N, ws) in the
    particles' dtype."""
    dtype = x.dtype
    dev = x.device
    idt = torch.full((), params.idt, dtype=dtype, device=dev)
    R = rng.uniform(seed, step, rng.VTURB, pids, (), minval=-1.0,
                    maxval=1.0, dtype=dtype)
    r_var = 1.0 / 3.0

    if not params.use_aks:
        K = torch.full((), params.ConstantVTurb, dtype=dtype, device=dev)
        return R * torch.sqrt(2.0 * K * idt / r_var)

    if profile is not None:
        z_w, prof_t = profile(x, y)
    else:
        ir, jr, fxr, fyr = locate_rho(grid, x, y)
        fd = fields.aks.dtype
        aks_prof = interp_columns(fields.aks, ir, jr, fxr.to(fd),
                                  fyr.to(fd)).to(dtype)            # (3,N,ws)
        zeta_l = interp2d(fields.zeta, ir, jr, fxr.to(fd),
                          fyr.to(fd)).to(dtype)                    # (3,N)
        hd = grid.h.dtype
        h_p = interp2d(grid.h, ir, jr, fxr.to(hd), fyr.to(hd)).to(dtype)
        prof_t = polintd(aks_prof, fields.times, t)                # (N,ws)
        zeta_t = polintd(zeta_l, fields.times, t)
        z_w = s_depths(zeta_t, h_p, grid.s_w.to(dtype),
                       grid.Cs_w.to(dtype), grid.hc,
                       grid.vtransform)                            # (N,ws)
    # Aks is non-negative: clip before the fit and clip the spline too
    # (a tension spline can undershoot)
    prof_t = torch.clamp(prof_t, min=0.0)
    sig = params.sigma
    z2 = tension.fit(z_w, prof_t, sig)
    kprime = tension.evaluate_deriv(z_w, prof_t, z2, sig, z)
    z_mid = torch.minimum(torch.maximum(z + 0.5 * kprime * idt, z_w[..., 0]),
                          z_w[..., -1])
    k_mid = torch.clamp(tension.evaluate(z_w, prof_t, z2, sig, z_mid),
                        min=0.0)
    return kprime * idt + R * torch.sqrt(2.0 * k_mid * idt / r_var)
