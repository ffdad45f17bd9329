"""Particle state: structure-of-arrays dataclass of tensors.

Counterpart of ``ltjax.state``.  The status lattice is unchanged:

  0 NOT_RELEASED  — before date of birth
  1 ACTIVE        — in the water column
  2 SETTLED       — frozen in a habitat polygon
  3 DEAD          — mortality (behavior module)
  4 OUT_OF_DOMAIN — exited through an open boundary
  5 ERROR         — interpolation/location failure (ErrorFlag policy)

``pid`` is carried for the counter-based random streams of the
turbulence port (keyed by particle id, not storage slot).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

NOT_RELEASED = 0
ACTIVE = 1
SETTLED = 2
DEAD = 3
OUT_OF_DOMAIN = 4
ERROR = 5

FIELDS = ("x", "y", "z", "dob", "age", "status", "pid", "settle_poly",
          "hit_land", "hit_bottom", "salt", "temp")


@dataclass
class Particles:
    x: torch.Tensor            # (N,) internal meters (east)
    y: torch.Tensor            # (N,) internal meters (north)
    z: torch.Tensor            # (N,) meters, negative below surface
    dob: torch.Tensor          # (N,) release time [s since run start]
    age: torch.Tensor          # (N,) seconds since release
    status: torch.Tensor       # (N,) int32 status lattice above
    pid: torch.Tensor          # (N,) int32 global particle id
    settle_poly: torch.Tensor  # (N,) int32 polygon id if settled, else -1
    hit_land: torch.Tensor     # (N,) int32 collision counters
    hit_bottom: torch.Tensor   # (N,) int32
    salt: torch.Tensor         # (N,) sampled salinity (SaltTempOn)
    temp: torch.Tensor         # (N,) sampled temperature

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def replace(self, **kw) -> "Particles":
        return dataclasses.replace(self, **kw)

    def take(self, idx: torch.Tensor) -> "Particles":
        """Every column gathered at ``idx`` (a permutation or subset)."""
        return Particles(**{k: getattr(self, k)[idx] for k in FIELDS})

    def to(self, device) -> "Particles":
        return Particles(**{k: getattr(self, k).to(device) for k in FIELDS})


