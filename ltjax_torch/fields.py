"""Hydrodynamic record windows (counterpart of ``ltjax.fields``).

Level-resolved fields are stored K-last, (R, eta, xi, K), so a
particle's water-column gather reads one contiguous K-vector per corner
node.  ``times`` stays on the host in float64: record times only feed
host-side interpolation weights.  Salt and temperature are zeros unless
the caller passes them (``cfg.needs_salt_fields()``: SaltTempOn
sampling or a salinity-cued behavior 4/5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class FieldSet:
    zeta: torch.Tensor   # (R, Ny, Nx)
    u: torch.Tensor      # (R, Ny, Nx-1, us)
    v: torch.Tensor      # (R, Ny-1, Nx, us)
    w: torch.Tensor      # (R, Ny, Nx, ws)
    aks: torch.Tensor    # (R, Ny, Nx, ws) vertical diffusivity
    salt: torch.Tensor   # (R, Ny, Nx, us) (zeros unless read)
    temp: torch.Tensor   # (R, Ny, Nx, us)
    times: torch.Tensor  # (R,) float64 on the CPU [s since run start]


def _klast(a, dtype, device):
    """(R, K, eta, xi) -> (R, eta, xi, K), materialized contiguous (a
    tensor is moved on its device, then to ``device``)."""
    if isinstance(a, torch.Tensor):
        return a.movedim(1, -1).to(dtype).contiguous().to(device)
    a = np.ascontiguousarray(np.moveaxis(np.asarray(a), 1, -1))
    return torch.as_tensor(a, dtype=dtype, device=device)


def make_fieldset(zeta, u, v, w, aks, times, salt=None, temp=None,
                  dtype=torch.float32, device="cpu") -> FieldSet:
    """Inputs in ROMS record layout (R, K, eta, xi); stored K-last.
    Salt/temp (R, us, eta, xi) default to zeros."""
    w = _klast(w, dtype, device)
    u = _klast(u, dtype, device)
    rho_shape = tuple(w.shape[:3]) + (u.shape[-1],)

    def scalar(a):
        if a is None:
            return torch.zeros(rho_shape, dtype=dtype, device=device)
        return _klast(a, dtype, device)

    return FieldSet(
        zeta=torch.as_tensor(zeta if isinstance(zeta, torch.Tensor)
                             else np.asarray(zeta), dtype=dtype,
                             device=device),
        u=u, v=_klast(v, dtype, device), w=w,
        aks=_klast(aks, dtype, device), salt=scalar(salt),
        temp=scalar(temp), times=torch.as_tensor(np.array(times,
                                                          np.float64)))


def stack_records(recs, t_base, dtype=torch.float32, device="cpu",
                  with_salt_temp: bool = False) -> FieldSet:
    """R-record FieldSet window from record dicts as produced by
    ``ltjax_torch.io.roms.RomsSeries.next_record`` (ROMS ([K,] eta, xi)
    layout, host numpy, or tensors on the device as
    ``io.prefetch.Prefetcher`` hands them over; a window may mix both).
    Record e's time is ``rec['time'] - t_base``; ``with_salt_temp``
    stacks the records' salt and temp."""
    def pile(key):
        if any(isinstance(r[key], torch.Tensor) for r in recs):
            return torch.stack([torch.as_tensor(r[key], device=device)
                                for r in recs])
        return np.stack([np.asarray(r[key]) for r in recs])

    times = np.asarray([float(r["time"]) - float(t_base) for r in recs])
    scalars = ((pile("salt"), pile("temp")) if with_salt_temp
               else (None, None))
    return make_fieldset(pile("zeta"), pile("u"), pile("v"), pile("w"),
                         pile("aks"), times, *scalars, dtype=dtype,
                         device=device)
