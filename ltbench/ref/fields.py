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


