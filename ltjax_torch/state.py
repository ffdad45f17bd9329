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
import warnings
from dataclasses import dataclass

import numpy as np
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


def init_particles(x, y, z, dob=None, dtype=torch.float64,
                   device="cpu") -> Particles:
    x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    n = x.shape[0]

    def zeros():
        return torch.zeros(n, dtype=dtype, device=device)

    def ints(v):
        return torch.full((n,), v, dtype=torch.int32, device=device)

    return Particles(
        x=x,
        y=torch.as_tensor(np.asarray(y), dtype=dtype, device=device),
        z=torch.as_tensor(np.asarray(z), dtype=dtype, device=device),
        dob=(zeros() if dob is None else
             torch.as_tensor(np.asarray(dob), dtype=dtype, device=device)),
        age=zeros(),
        status=ints(NOT_RELEASED),
        pid=torch.arange(n, dtype=torch.int32, device=device),
        settle_poly=ints(-1),
        hit_land=ints(0),
        hit_bottom=ints(0),
        salt=zeros(),
        temp=zeros(),
    )


def read_parfile(path: str) -> np.ndarray:
    """Read the reference's initial-particle CSV: rows of (lon, lat,
    depth, date-of-birth-seconds), separated by commas or blanks, '#'
    comment lines skipped.  Returns an (N, 4) float64 array (missing
    columns zero).  A file without comments or blank lines whose rows
    all have the first row's column count is parsed in one numpy call
    (10^7 rows in seconds); any other file line by line."""
    with open(path, "rb") as f:
        data = f.read()
    if b"#" not in data and data.strip():
        text = data.replace(b",", b" ").decode()
        rows = text.strip().split("\n", 1)
        ncol = len(rows[0].split())
        nrow = text.strip().count("\n") + 1
        with warnings.catch_warnings():
            # a malformed file stops the parse early: the line loop
            # below then names the bad value
            warnings.simplefilter("ignore", DeprecationWarning)
            vals = np.fromstring(text, dtype=np.float64, sep=" ")
        if vals.size == nrow * ncol and ncol:
            return _four_columns(vals.reshape(nrow, ncol))
    out = []
    for line in data.decode().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p for p in line.replace(",", " ").split() if p]
        out.append([float(p) for p in parts[:4]])
    return _four_columns(np.asarray(out, np.float64))


def _four_columns(arr: np.ndarray) -> np.ndarray:
    arr = arr[:, :4]
    if arr.shape[1] < 4:
        arr = np.pad(arr, ((0, 0), (0, 4 - arr.shape[1])))
    return np.ascontiguousarray(arr)
