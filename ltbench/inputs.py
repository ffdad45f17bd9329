"""The benchmark's own inputs, made from a configuration, a traffic mix
and ``--seed``: frozen copies of the input makers the port's smoke runs use
(the bench grid, the solid-body records with their halocline and Aks
profile, the habitat polygons, a uniform release), so that a change to
the program cannot move the yardstick.

Everything here is plain NumPy or PyTorch.  The same raw arrays go to
the program (through its public constructors, in ``ltbench.cell``) and
to the plain reference (``ltbench.ref``).

The flow is solid-body rotation about the domain centre, with an
optional linear vertical shear of the rotation rate, modulated by an M2
tide, over a free surface that heaves with it and a vertical velocity
that vanishes at the bed and the surface:

    m(t) = 1 + A cos(phi),  phi = 2 pi t / T_M2 + phi0,
    u = -omega m (y - yc) (1 + a z),  v = omega m (x - xc) (1 + a z),
    zeta = Z cos(phi) (1/2 + (x - x0) / Lx),
    w = W sin(phi) sin(pi (z + h) / (zeta + h)) c(x),
    c(x) = 3/4 + cos(2 pi (x - xc) / Lx) / 4,

with A, Z, W and phi0 the case's ``tide`` (``omega_amp``, ``zeta_m``,
``w_mps``, ``phase_rad``; none without it), on a grid of uniform rho
axes and uniform s-levels with Cs = s and hc = h0 (so z = h s + zeta
(1 + s)).  No two records match, so a record window read one record
off, a time collapse left out or a field left out moves the particles.
With ``halocline`` the records carry salt S = 25 + 3 x/Lx - 5 tanh((z -
z_h(t)) / 3), heaved by an M2 internal tide about z_h = -10 m, and
temperature 8 + 12 exp(z / 15); with ``parabolic_aks`` Aks = 1e-4 +
4e-3 (1 - (2 (z_w - zeta) / (h + zeta) + 1)^2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .ref.scoord import s_depths

M2_PERIOD = 44714.0   # [s] principal lunar semidiurnal tide


@dataclass
class GridArrays:
    """Host arrays of a rectilinear grid and its s-levels."""
    x_rho: np.ndarray     # (nx,)
    y_rho: np.ndarray     # (ny,)
    h: np.ndarray         # (ny, nx)
    mask: np.ndarray      # (ny, nx) int32, 1 water
    s_rho: np.ndarray     # (us,)
    s_w: np.ndarray       # (ws,)
    hc: float
    vtransform: int


@dataclass
class Records:
    """A ring of hydrodynamic records on the device, K-last, in the
    fields' dtype; ``times`` float64 on the host [s]."""
    zeta: torch.Tensor    # (R, ny, nx)
    u: torch.Tensor       # (R, ny, nx-1, us)
    v: torch.Tensor       # (R, ny-1, nx, us)
    w: torch.Tensor       # (R, ny, nx, ws)
    aks: torch.Tensor     # (R, ny, nx, ws)
    salt: torch.Tensor    # (R, ny, nx, us)
    temp: torch.Tensor    # (R, ny, nx, us)
    times: torch.Tensor   # (R,)

    def columns(self):
        return (self.zeta, self.u, self.v, self.w, self.aks, self.salt,
                self.temp, self.times)


@dataclass
class Release:
    """Initial particles on the device (positions in float64)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    age: float


def grid_arrays(grid: dict, ltrans: dict) -> GridArrays:
    """The configuration's grid: ``nx`` x ``ny`` rho points spanning
    ``lx`` x ``ly`` metres, all water, depth ``h0``, ``us`` uniform
    s-levels."""
    nx, ny, us = int(grid["nx"]), int(grid["ny"]), int(ltrans["us"])
    s_w = np.linspace(-1.0, 0.0, us + 1)
    h0 = float(grid["h0"])
    return GridArrays(x_rho=np.linspace(0.0, float(grid["lx"]), nx),
                      y_rho=np.linspace(0.0, float(grid["ly"]), ny),
                      h=np.full((ny, nx), h0),
                      mask=np.ones((ny, nx), np.int32),
                      s_rho=0.5 * (s_w[1:] + s_w[:-1]), s_w=s_w, hc=h0,
                      vtransform=int(ltrans.get("Vtransform", 1)))


def record_times(n_records: int, dt: float) -> np.ndarray:
    """Record k at (k - 1/2) dt: external step e, from e dt to (e + 1) dt,
    reads records e, e + 1 and e + 2."""
    return (np.arange(n_records, dtype=np.float64) - 0.5) * dt


def make_records(ga: GridArrays, case: dict, n_records: int, dt: float,
                 dtype, device) -> Records:
    """``n_records`` records of the case at ``record_times``, computed on
    the device in float64 and stored in ``dtype``."""
    f64 = dict(dtype=torch.float64, device=device)
    x = torch.as_tensor(ga.x_rho, **f64)
    y = torch.as_tensor(ga.y_rho, **f64)
    h = torch.as_tensor(ga.h, **f64)
    s_r = torch.as_tensor(ga.s_rho, **f64)
    s_w = torch.as_tensor(ga.s_w, **f64)
    omega = float(case["omega"])
    a = float(case.get("shear_a", 0.0))
    tide = case.get("tide", {})
    amp = float(tide.get("omega_amp", 0.0))
    zeta_m = float(tide.get("zeta_m", 0.0))
    w_mps = float(tide.get("w_mps", 0.0))
    phi0 = float(tide.get("phase_rad", 0.0))
    lx = float(ga.x_rho[-1] - ga.x_rho[0])
    xc, yc = 0.5 * (ga.x_rho[0] + ga.x_rho[-1]), 0.5 * (ga.y_rho[0]
                                                         + ga.y_rho[-1])
    xf = ((x - x.min()) / (x.max() - x.min()))[None, :]
    w_x = 0.75 + 0.25 * torch.cos(2.0 * np.pi * (x - xc) / lx)[None, :, None]
    times = record_times(n_records, dt)
    cols = {k: [] for k in ("zeta", "u", "v", "w", "aks", "salt", "temp")}
    for t in times:
        phi = 2.0 * np.pi * t / M2_PERIOD + phi0
        m = 1.0 + amp * np.cos(phi)
        zeta = (zeta_m * np.cos(phi) * (0.5 + xf)).expand_as(h)
        z_r = s_depths(zeta, h, s_r, s_r, ga.hc, ga.vtransform)
        z_w = s_depths(zeta, h, s_w, s_w, ga.hc, ga.vtransform)
        d = (h + zeta)[..., None]
        # u at u points (between x-neighbours), v at v points, K last
        cols["u"].append((-omega * m * (y - yc))[:, None, None] * (
            1.0 + a * 0.5 * (z_r[:, 1:] + z_r[:, :-1])))
        cols["v"].append((omega * m * (x - xc))[None, :, None] * (
            1.0 + a * 0.5 * (z_r[1:, :] + z_r[:-1, :])))
        cols["w"].append(w_mps * np.sin(phi) * w_x * torch.sin(
            np.pi * (z_w + h[..., None]) / d))
        cols["zeta"].append(zeta)
        cols["aks"].append(
            1e-4 + 4e-3 * (1.0 - (2.0 * (z_w - zeta[..., None]) / d + 1.0)
                           ** 2) if case.get("parabolic_aks")
            else torch.zeros_like(z_w))
        if case.get("halocline"):
            z_h = -10.0 + 2.0 * np.sin(phi)
            cols["salt"].append(25.0 + 3.0 * xf[..., None]
                                - 5.0 * torch.tanh((z_r - z_h) / 3.0))
            cols["temp"].append(8.0 + 12.0 * torch.exp(z_r / 15.0))
        else:
            cols["salt"].append(torch.zeros_like(z_r))
            cols["temp"].append(torch.zeros_like(z_r))
        for v in cols.values():          # hold one record in float64
            v[-1] = v[-1].to(dtype)
    out = {k: torch.stack(v).contiguous() for k, v in cols.items()}
    return Records(**out, times=torch.as_tensor(times))


def polygons(spec: Optional[dict]) -> Tuple[List, List]:
    """(habitat, holes) as [(id, (V, 2) vertices in metres)]: squares
    ``[id, x0, x1, y0, y1]``, regular polygons ``[id, xc, yc, r, sides,
    phase]``, holes as squares."""
    if not spec:
        return [], []

    def square(id_, x0, x1, y0, y1):
        return (int(id_), np.array([[x0, y0], [x1, y0], [x1, y1],
                                    [x0, y1]], np.float64))

    habitat = [square(*s) for s in spec.get("squares", [])]
    for id_, xc, yc, r, sides, phase in spec.get("regular", []):
        th = np.linspace(0.0, 2.0 * np.pi, int(sides) + 1)[:-1] + phase
        habitat.append((int(id_), np.stack([xc + r * np.cos(th),
                                            yc + r * np.sin(th)], -1)))
    holes = [square(*s) for s in spec.get("holes", [])]
    return habitat, holes


def release(traffic: dict, seed: int, device) -> Release:
    """``numpar`` particles uniform in the traffic's x, y and z ranges,
    drawn on the device from ``seed``."""
    n = int(traffic["numpar"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = []
    for k in ("x", "y", "z"):
        lo, hi = traffic["release"][k]
        out.append(lo + (hi - lo) * torch.rand(n, generator=g,
                                               dtype=torch.float64,
                                               device=device))
    return Release(*out, age=float(traffic["release"].get("age", 0.0)))


def sample_rows(n: int, k: int, seed: int) -> torch.Tensor:
    """``k`` distinct particle indices of ``n``, drawn from ``seed`` on
    the host (sorted)."""
    g = torch.Generator()
    g.manual_seed(int(seed) ^ 0x5EED)
    return torch.randperm(n, generator=g)[:k].sort().values
