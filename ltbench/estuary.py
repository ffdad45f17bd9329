"""An estuary on a land-masked grid, made from a configuration's ``grid``
(``"kind": "estuary"``) and ``case`` and a traffic mix's ``water``
release: the benchmark's own inputs of a coastline deployment (LTRANS
v2b's ``boundary_module``: land reflection, open-boundary exits), plain
NumPy and PyTorch that import nothing of the program.

Geometry.  The channel's centreline runs along x from the mouth (s = 0)
to the head (s = ``length_m``) and meanders, y_c(s) = A sin(2 pi s /
L_m) (``meander_m``, ``meander_wavelength_m``).  Rho point (j, i) lies
at C(s_i) + n_j N(s_i): s_i uniform over [0, length_m], n_j uniform
over [-width_m / 2, width_m / 2] and N the unit normal of the
centreline, so the grid lines across the channel are normal to it and a
cell folds only where |n| exceeds the radius of curvature.  With
``curvilinear`` false the same estuary is straight (A = 0): 1-D axes x =
s, y = n, a rectilinear grid.  ``origin_m`` (default 0, 0) moves the
whole grid, so that a small estuary can keep a deployment's coordinate
magnitudes (and with them the rounding of float32 positions).

Water lies where |n| <= W(s) / 2,

    W(s) = (w_head + w_excess exp(-s / L_w)) (1 + sum_m a_m sin(2 pi s /
           l_m + p_m)),

the funnel (``head_width_m``, ``width_excess_m``, ``width_decay_m``)
and its coves and headlands (``coves``: [a_m, l_m, p_m]).  The rim is
land, but for the mouth column (i = 0), which keeps the water of its
width and whose seaward edge is the grid's open boundary.  The depth is
``shoal_depth_m`` on the shoals and on land with a Gaussian channel,

    h = h_s + (H(s) - h_s) exp(-ln 2 (n / (f W(s)))^2),

half its excess at |n| = f W (``channel_half_width`` f), H(s) falling
linearly from ``channel_depth_m[0]`` at the mouth to ``[1]`` at the
head.  The s-levels are uniform (Cs = s, hc = h_s).

Flow (``case``), with psi = 2 pi t / T_M2 - k s + phi0 (``tide``:
``wavelength_m`` = 2 pi / k, ``phase_rad``) and sigma the level's
s-coordinate:

    along  = U0 c cos(psi) - r (1 + 2 sigma),   c = sqrt(h / H(s)),
    across = a U0 c sin(psi),
    zeta   = Z cos(psi),
    w      = g h sin(psi) sin(pi (z + h) / (zeta + h)),

a progressive M2 tide along the channel, weaker on the shoals (``U0``),
a cross-channel part (``cross`` a), the gravitational residual
(``residual_mps`` r: seaward at the surface, landward at the bed, no
depth mean), the surface (``zeta_m`` Z) and the accepted cells' w form,
zero at the bed and the surface, its amplitude in proportion to the
local depth (``w_per_depth`` g: the accepted cells' 5e-4 m/s over 50 m
is 1e-5 1/s), so that no column squeezes its water to the bed or the
surface within a tide.  u and v are the east and north components at
the u and v points, as the program reads them (no grid angle), and zero
where a u or v point touches land.  With ``halocline`` and
``parabolic_aks`` the records carry the accepted cells' salt,
temperature and Aks forms (``ltbench/inputs.py``), the along-channel
fraction in place of x / Lx and psi in place of their phase.

A ``water`` release (traffic ``release``: ``"kind": "water"``) draws
``numpar`` particles uniform over the water cells of the logical window
``i`` = [i0, i1] (all rows, the rim excluded), each uniform inside its
boundary cell (logical [i - 1/2, i + 1/2] x [j - 1/2, j + 1/2]) and
placed by the bilinear map of the rho points, the map the program's
inverse inverts; its depth is the fraction ``s`` of the local water
column, z = zeta + s (h + zeta), at t = 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .inputs import (M2_PERIOD, GridArrays, Records, Release,
                     record_times)
from .ref.scoord import s_depths

EDGE = 1e-6      # a released particle keeps this far (logical) off its
                 # boundary cell's edges, so that no round-off in the
                 # inverse map puts it in the land cell beside


@dataclass
class Estuary:
    """An estuary's grid arrays and the channel coordinates they came
    from (float64, host)."""
    arrays: GridArrays
    grid: dict            # the configuration's ``grid``
    s: np.ndarray         # (nx,) along-channel coordinate of the rho columns
    n: np.ndarray         # (ny,) across-channel coordinate of the rho rows
    x2: np.ndarray        # (ny, nx) rho points (both forms)
    y2: np.ndarray


def _meander(grid: dict):
    a = float(grid.get("meander_m", 0.0)) if grid.get("curvilinear",
                                                        True) else 0.0
    return a, 2.0 * np.pi / float(grid.get("meander_wavelength_m", 1.0))


def frame(grid: dict, s):
    """(y_c, tx, ty): the centreline's y and its unit tangent at the
    along-channel coordinates ``s`` (NumPy or PyTorch); the unit normal
    is (-ty, tx)."""
    a, k = _meander(grid)
    lib = torch if isinstance(s, torch.Tensor) else np
    slope = a * k * lib.cos(k * s)
    norm = lib.sqrt(1.0 + slope * slope)
    return a * lib.sin(k * s), 1.0 / norm, slope / norm


def water_width(grid: dict, s):
    """W(s) [m], the width of the water at ``s``."""
    lib = torch if isinstance(s, torch.Tensor) else np
    w = (float(grid["head_width_m"]) + float(grid["width_excess_m"])
         * lib.exp(-s / float(grid["width_decay_m"])))
    m = 1.0
    for amp, wavelength, phase in grid.get("coves", []):
        m = m + amp * lib.sin(2.0 * np.pi * s / wavelength + phase)
    return w * m


def channel_depth(grid: dict, s):
    """H(s) [m], the depth of the channel's axis at ``s``."""
    h0, h1 = (float(v) for v in grid["channel_depth_m"])
    return h0 + (h1 - h0) * s / float(grid["length_m"])


def depth(grid: dict, s, n):
    """h(s, n) [m]: the shoals' depth with the Gaussian channel."""
    lib = torch if isinstance(s, torch.Tensor) else np
    hs = float(grid["shoal_depth_m"])
    f = float(grid["channel_half_width"]) * water_width(grid, s)
    return hs + (channel_depth(grid, s) - hs) * lib.exp(
        -np.log(2.0) * (n / f) ** 2)


def make(grid: dict, ltrans: dict) -> Estuary:
    """The estuary of a configuration's ``grid`` and its ``us`` uniform
    s-levels."""
    nx, ny, us = int(grid["nx"]), int(grid["ny"]), int(ltrans["us"])
    s = np.linspace(0.0, float(grid["length_m"]), nx)
    half = 0.5 * float(grid["width_m"])
    n = np.linspace(-half, half, ny)
    yc, tx, ty = frame(grid, s)
    x0, y0 = (float(v) for v in grid.get("origin_m", (0.0, 0.0)))
    x2 = x0 + s[None, :] - n[:, None] * ty[None, :]
    y2 = y0 + yc[None, :] + n[:, None] * tx[None, :]
    wet = np.abs(n)[:, None] <= 0.5 * water_width(grid, s)[None, :]
    mask = np.zeros((ny, nx), np.int32)
    mask[1:-1, :-1] = wet[1:-1, :-1]      # the rim is land, bar the mouth
    h = depth(grid, s[None, :], n[:, None])
    s_w = np.linspace(-1.0, 0.0, us + 1)
    curv = bool(grid.get("curvilinear", True))
    ga = GridArrays(x_rho=x2 if curv else x2[0].copy(),
                    y_rho=y2 if curv else y2[:, 0].copy(), h=h, mask=mask,
                    s_rho=0.5 * (s_w[1:] + s_w[:-1]), s_w=s_w,
                    hc=float(grid["shoal_depth_m"]),
                    vtransform=int(ltrans.get("Vtransform", 1)))
    return Estuary(arrays=ga, grid=grid, s=s, n=n, x2=x2, y2=y2)


def _phase(case: dict, s, t: float):
    tide = case.get("tide", {})
    k = 2.0 * np.pi / float(tide["wavelength_m"])
    return 2.0 * np.pi * t / M2_PERIOD - k * s + float(
        tide.get("phase_rad", 0.0))


def _surface(case: dict, s, t: float):
    return float(case.get("tide", {}).get("zeta_m", 0.0)) * torch.cos(
        _phase(case, s, t))


def make_records(est: Estuary, case: dict, n_records: int, dt: float,
                 dtype, device) -> Records:
    """``n_records`` records of the estuary's flow at ``record_times``,
    computed on the device in float64 and stored in ``dtype``."""
    f64 = dict(dtype=torch.float64, device=device)
    g, ga = est.grid, est.arrays
    s = torch.as_tensor(est.s, **f64)[None, :]          # (1, nx)
    n = torch.as_tensor(est.n, **f64)[:, None]          # (ny, 1)
    s_u, n_v = 0.5 * (s[:, 1:] + s[:, :-1]), 0.5 * (n[1:] + n[:-1])
    h = torch.as_tensor(ga.h, **f64)
    mask = torch.as_tensor(ga.mask, **f64)
    wet_u = (mask[:, 1:] * mask[:, :-1])[..., None]
    wet_v = (mask[1:] * mask[:-1])[..., None]
    s_r = torch.as_tensor(ga.s_rho, **f64)
    s_w = torch.as_tensor(ga.s_w, **f64)
    u0, r = float(case["U0"]), float(case.get("residual_mps", 0.0))
    a_x = float(case.get("cross", 0.0))
    gw = float(case.get("w_per_depth", 0.0))
    lf = float(g["length_m"])
    resid = -r * (1.0 + 2.0 * s_r)                      # (us,)

    def velocity(sp, npt, t):
        """(east, north) at points (sp, npt), every level: (.., us)."""
        hp = depth(g, sp, npt)
        c = torch.sqrt(hp / channel_depth(g, sp))
        psi = _phase(case, sp, t)
        along = (u0 * c * torch.cos(psi))[..., None] + resid
        across = (a_x * u0 * c * torch.sin(psi))[..., None]
        _, tx, ty = frame(g, sp)
        tx, ty = tx[..., None], ty[..., None]
        return along * tx - across * ty, along * ty + across * tx

    times = record_times(n_records, dt)
    cols = {k: [] for k in ("zeta", "u", "v", "w", "aks", "salt", "temp")}
    for t in times:
        psi = _phase(case, s, t).expand_as(h)
        zeta = _surface(case, s, t).expand_as(h)
        z_r = s_depths(zeta, h, s_r, s_r, ga.hc, ga.vtransform)
        z_w = s_depths(zeta, h, s_w, s_w, ga.hc, ga.vtransform)
        d = (h + zeta)[..., None]
        cols["u"].append(velocity(s_u, n, t)[0] * wet_u)
        cols["v"].append(velocity(s, n_v, t)[1] * wet_v)
        cols["w"].append((gw * h * torch.sin(psi))[..., None] * torch.sin(
            np.pi * (z_w + h[..., None]) / d))
        cols["zeta"].append(zeta)
        cols["aks"].append(
            1e-4 + 4e-3 * (1.0 - (2.0 * (z_w - zeta[..., None]) / d + 1.0)
                           ** 2) if case.get("parabolic_aks")
            else torch.zeros_like(z_w))
        if case.get("halocline"):
            z_h = (-10.0 + 2.0 * torch.sin(psi))[..., None]
            cols["salt"].append(25.0 + 3.0 * (s / lf).expand_as(h)[..., None]
                                - 5.0 * torch.tanh((z_r - z_h) / 3.0))
            cols["temp"].append(8.0 + 12.0 * torch.exp(z_r / 15.0))
        else:
            cols["salt"].append(torch.zeros_like(z_r))
            cols["temp"].append(torch.zeros_like(z_r))
        for v in cols.values():          # hold one record in float64
            v[-1] = v[-1].to(dtype)
    out = {k: torch.stack(v).contiguous() for k, v in cols.items()}
    return Records(**out, times=torch.as_tensor(times))


def _bilinear(a: torch.Tensor, ti: torch.Tensor, tj: torch.Tensor):
    """``a`` (ny, nx) at logical rho coordinates (ti, tj), bilinear in
    the rho cell that holds them."""
    ny, nx = a.shape
    i = torch.floor(ti).clamp(0, nx - 2)
    j = torch.floor(tj).clamp(0, ny - 2)
    fx, fy = ti - i, tj - j
    i, j = i.long(), j.long()
    return ((1 - fy) * ((1 - fx) * a[j, i] + fx * a[j, i + 1])
            + fy * ((1 - fx) * a[j + 1, i] + fx * a[j + 1, i + 1]))


def water_cells(est: Estuary, window) -> np.ndarray:
    """Flat indices (j * nx + i) of the water cells a release may take:
    columns ``window`` = [i0, i1] within the interior, rows off the
    rim."""
    mask = est.arrays.mask
    ny, nx = mask.shape
    i0, i1 = max(1, int(window[0])), min(nx - 2, int(window[1]))
    keep = np.zeros_like(mask, bool)
    keep[1:-1, i0:i1 + 1] = mask[1:-1, i0:i1 + 1] > 0
    return np.flatnonzero(keep)


def release(traffic: dict, est: Estuary, case: dict, seed: int,
            device) -> Release:
    """The traffic's ``water`` release on the estuary, drawn on the
    device from ``seed`` (positions in float64)."""
    r = traffic["release"]
    n = int(traffic["numpar"])
    nx = est.arrays.mask.shape[1]
    f64 = dict(dtype=torch.float64, device=device)
    cells = torch.as_tensor(water_cells(est, r["i"]), device=device)
    if not len(cells):
        raise ValueError(f"no water cell in the release window {r['i']}")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    c = cells[torch.randint(len(cells), (n,), generator=g, device=device)]
    off = 0.5 - EDGE

    def jitter():
        return off * (2.0 * torch.rand(n, generator=g, **f64) - 1.0)

    ti = (c % nx).to(torch.float64) + jitter()
    tj = (c // nx).to(torch.float64) + jitter()
    lo, hi = (float(v) for v in r["s"])
    frac = lo + (hi - lo) * torch.rand(n, generator=g, **f64)
    x = _bilinear(torch.as_tensor(est.x2, **f64), ti, tj)
    y = _bilinear(torch.as_tensor(est.y2, **f64), ti, tj)
    h = _bilinear(torch.as_tensor(est.arrays.h, **f64), ti, tj)
    s = _bilinear(torch.as_tensor(est.s, **f64).expand(
        est.arrays.mask.shape), ti, tj)
    zeta = _surface(case, s, 0.0)
    return Release(x, y, zeta + frac * (h + zeta),
                   age=float(r.get("age", 0.0)))
