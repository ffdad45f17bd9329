"""The open box's input makers as the benchmark had them before the
estuary grid kind (``ltbench/inputs.py`` and ``ltbench/cell.py::
make_inputs`` of that tree, copied unchanged): the identity test holds
the accepted cells' inputs, made through the harness's dispatch on the
grid and release kinds, to them bit for bit."""

import numpy as np
import torch

from ltbench.inputs import M2_PERIOD, GridArrays, Records, Release
from ltbench.ref.scoord import s_depths


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



def make_inputs(cell, seed: int, device) -> tuple:
    """(grid arrays, records, release) of one run of ``cell``."""
    lt = cell.ltrans
    ga = grid_arrays(cell.config["grid"], lt)
    rec = make_records(
        ga, cell.case, cell.episode + 2, float(lt["dt"]),
        getattr(torch, lt.get("dtype_field", "float32")), device)
    return ga, rec, release(cell.traffic, seed, device)
