"""Synthetic analytic ROMS-like test cases (counterpart of
``ltjax.synth``).

Solid-body rotation with linear vertical shear and a linear time ramp,

    u = -Omega (y - yc) (1 + a z) (1 + b t),  v = Omega (x - xc) (1 + a z)
    (1 + b t),  w = 0,  zeta = 0,

is exactly representable by the interpolation stack (bilinear, spline
of linear data, quadratic in time), so the only discrepancy from the
closed-form trajectory

    theta(t) = theta0 + Omega (1 + a zp) (t + b t^2 / 2)

is RK4 truncation (and float32 round-off in float32 runs).

With ``halocline=True`` the records also carry salt and temperature
(``halocline_fields``): a halocline that is nonlinear in z and varies in
x, so a spline fit that is wrong shows (a field linear in z is
reproduced exactly by every spline).  Polygons for settlement runs are
written by ``write_run_files(habitat=, holes=)``.

``make_curv_case`` samples the same rotation (without shear or ramp) on
a gently curvilinear mesh (``CurvSolidBodyCase``); its u/v nodes sit at
the logical midpoints of the rho nodes, O(h^2 curvature) off the rho
mesh, so trajectories follow the circles to metres over hours.

``migration_block`` makes one rank's slot block for ``shard.migrate``:
EMPTY slots, particles that stay and particles that leave for the other
strips, with every status and, on request, y on the strips' edges and
off the real line.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from . import convert
from .fields import FieldSet, make_fieldset
from .grid import (Grid, make_curv_grid, make_grid, song_haidvogel_cs,
                   uniform_sigma_levels)
from .io.nc import write_netcdf
from .scoord import s_depths


@dataclass
class SolidBodyCase:
    grid: Grid
    omega: float
    xc: float
    yc: float
    shear_a: float
    ramp_b: float
    h0: float
    parabolic_aks: bool = False   # Aks = bench.py's turb profile, else 0
    halocline: bool = False       # salt/temp = halocline_fields, else 0

    def velocity(self, x, y, z, t):
        f = (1.0 + self.shear_a * z) * (1.0 + self.ramp_b * t)
        u = -self.omega * (y - self.yc) * f
        v = self.omega * (x - self.xc) * f
        return u, v, np.zeros_like(u)

    def analytic(self, x0, y0, z0, t):
        """Exact particle position at time t (started at t=0)."""
        r = np.hypot(x0 - self.xc, y0 - self.yc)
        th0 = np.arctan2(y0 - self.yc, x0 - self.xc)
        th = th0 + self.omega * (1.0 + self.shear_a * z0) * (
            t + self.ramp_b * t * t / 2.0)
        return (self.xc + r * np.cos(th), self.yc + r * np.sin(th),
                np.full_like(np.asarray(th, np.float64), z0,
                             dtype=np.float64))

    def slabs(self, t):
        """Field arrays at record time t, in (level, eta, xi) layout."""
        g = self.grid
        nx, ny, us, ws = g.nx, g.ny, g.us, g.ws

        def host(a):
            return a.cpu().numpy()

        x_rho, y_rho, h = host(g.x_rho), host(g.y_rho), host(g.h)
        z_r = s_depths(np.zeros_like(h), h, host(g.s_rho), host(g.Cs_r),
                       g.hc, g.vtransform)
        z_r = np.moveaxis(z_r, -1, 0)                 # (us, ny, nx)
        ramp = 1.0 + self.ramp_b * t
        u = (-self.omega * (y_rho[:, None] - self.yc) * ramp)[None]
        u = np.broadcast_to(u, (us, ny, 1)) * (
            1.0 + self.shear_a * 0.5 * (z_r[:, :, 1:] + z_r[:, :, :-1]))
        v = (self.omega * (x_rho[None, :] - self.xc) * ramp)[None]
        v = np.broadcast_to(v, (us, 1, nx)) * (
            1.0 + self.shear_a * 0.5 * (z_r[:, 1:, :] + z_r[:, :-1, :]))
        w = np.zeros((ws, ny, nx))
        aks = np.zeros_like(w)
        if self.parabolic_aks:
            aks = parabolic_aks(g)
        salt = temp = np.zeros((us, ny, nx))
        if self.halocline:
            salt, temp = halocline_fields(g, t)
        return dict(zeta=np.zeros((ny, nx)), u=np.ascontiguousarray(u),
                    v=np.ascontiguousarray(v), w=w, aks=aks, salt=salt,
                    temp=temp)


def parabolic_aks(grid: Grid) -> np.ndarray:
    """(ws, Ny, Nx) vertical diffusivity of bench.py's turb variant,
    K = 1e-4 + 4e-3 (1 - (2 z_w / h + 1)^2) [m^2/s] at the w levels of the
    resting column: 1e-4 at the surface and the bottom, 4.1e-3 mid-depth,
    so the Visser drift term K' is real."""
    h = grid.h.cpu().numpy().astype(np.float64)
    z_w = s_depths(np.zeros_like(h), h, grid.s_w.cpu().numpy(),
                   grid.Cs_w.cpu().numpy(), grid.hc, grid.vtransform)
    k = 1e-4 + 4e-3 * (1.0 - (2.0 * z_w / h[..., None] + 1.0) ** 2)
    return np.ascontiguousarray(np.moveaxis(k, -1, 0))


M2_PERIOD = 44714.0   # [s] principal lunar semidiurnal tide


def rho_xy(grid: Grid):
    """(x, y), each (Ny, Nx) float64: the rho points of the grid."""
    if grid.curv is not None:
        xy = grid.curv.xy_flat.cpu().numpy().astype(np.float64)
        return (xy[:, 0].reshape(grid.ny, grid.nx),
                xy[:, 1].reshape(grid.ny, grid.nx))
    x = grid.x_rho.cpu().numpy().astype(np.float64)
    y = grid.y_rho.cpu().numpy().astype(np.float64)
    return (np.broadcast_to(x, (grid.ny, grid.nx)),
            np.broadcast_to(y[:, None], (grid.ny, grid.nx)))


def halocline_fields(grid: Grid, t: float = 0.0):
    """(salt, temp), each (us, Ny, Nx), at the rho levels of the resting
    column at time t: S = 25 + 3 x/Lx - 5 tanh((z - z_h(t))/3) psu, a
    halocline with |dS/dz| up to 5/3 psu/m, fresher to the west (x/Lx
    the rho point's x across the grid's x range), that an internal tide
    heaves about z = -10 m, z_h(t) = -10 + 2 sin(2 pi t / M2_PERIOD); and
    T = 8 + 12 exp(z/15) degC."""
    h = grid.h.cpu().numpy().astype(np.float64)
    z_r = s_depths(np.zeros_like(h), h, grid.s_rho.cpu().numpy(),
                   grid.Cs_r.cpu().numpy(), grid.hc, grid.vtransform)
    x, _ = rho_xy(grid)
    xf = ((x - x.min()) / (x.max() - x.min()))[:, :, None]
    z_h = -10.0 + 2.0 * np.sin(2.0 * np.pi * t / M2_PERIOD)
    salt = 25.0 + 3.0 * xf - 5.0 * np.tanh((z_r - z_h) / 3.0)
    temp = 8.0 + 12.0 * np.exp(z_r / 15.0)
    return (np.ascontiguousarray(np.moveaxis(salt, -1, 0)),
            np.ascontiguousarray(np.moveaxis(temp, -1, 0)))


def stretched_axis(n: int, length: float, ratio: float) -> np.ndarray:
    """n points from 0 to ``length`` whose spacing grows by ``ratio``
    from one cell to the next (1: uniform, np.linspace)."""
    if ratio == 1.0:
        return np.linspace(0.0, length, n)
    d = ratio ** np.arange(n - 1, dtype=np.float64)
    return np.concatenate([[0.0], np.cumsum(d)]) * (length / d.sum())


def make_solid_body_case(nx=41, ny=41, us=10, lx=100e3, ly=100e3,
                         h0=50.0, omega=1e-4, shear_a=0.0, ramp_b=0.0,
                         vtransform=1, theta_s=0.0, dtype=torch.float64,
                         device="cpu", mask=None, parabolic_aks=False,
                         halocline=False, hc=None,
                         stretch=1.0) -> SolidBodyCase:
    """Solid-body rotation about the domain centre on a uniform grid, or
    (``stretch`` != 1) on rho axes whose spacing grows geometrically by
    that ratio per cell (``stretched_axis``): the velocity does not depend
    on the grid, so ``analytic`` is the truth on either.

    hc = h0 (the default) and Cs = s (theta_s = 0) make the Vtransform-1
    levels z = h*s exactly; theta_s > 0 stretches the ladder, and with
    ``hc`` < h0 as well the depths depend on both Cs and hc.  ``mask``
    (Ny, Nx) marks land cells (0).  ``parabolic_aks`` gives the records
    bench.py's turb-variant Aks profile (``parabolic_aks``) instead of
    zeros, and ``halocline`` salt and temperature
    (``halocline_fields``)."""
    x_rho = stretched_axis(nx, lx, stretch)
    y_rho = stretched_axis(ny, ly, stretch)
    h = np.full((ny, nx), h0)
    if mask is None:
        mask = np.ones((ny, nx), np.int32)
    s_rho, s_w = uniform_sigma_levels(us)
    grid = make_grid(x_rho, y_rho, h, mask, s_rho,
                     song_haidvogel_cs(s_rho, theta_s), s_w,
                     song_haidvogel_cs(s_w, theta_s),
                     hc=h0 if hc is None else hc,
                     vtransform=vtransform, dtype=dtype, device=device)
    return SolidBodyCase(grid=grid, omega=omega, xc=lx / 2, yc=ly / 2,
                         shear_a=shear_a, ramp_b=ramp_b, h0=h0,
                         parabolic_aks=parabolic_aks, halocline=halocline)


def logical_to_xy(x2d, y2d, ti, tj):
    """Physical position of logical rho-lattice coordinates (ti, tj) on
    the mesh of rho points (x2d, y2d): the forward bilinear map that
    ``grid.curv_logical`` inverts (host numpy)."""
    ny, nx = np.shape(x2d)
    ti = np.asarray(ti, np.float64)
    tj = np.asarray(tj, np.float64)
    i = np.clip(np.floor(ti).astype(int), 0, nx - 2)
    j = np.clip(np.floor(tj).astype(int), 0, ny - 2)
    fx, fy = ti - i, tj - j

    def bil(a):
        a = np.asarray(a, np.float64)
        return (a[j, i] * (1 - fx) * (1 - fy) + a[j, i + 1] * fx * (1 - fy)
                + a[j + 1, i] * (1 - fx) * fy + a[j + 1, i + 1] * fx * fy)
    return bil(x2d), bil(y2d)


@dataclass
class CurvSolidBodyCase:
    """Solid-body rotation about (xc, yc) on a curvilinear mesh whose rho
    points are (x2d, y2d); u/v are stored east/north (no grid angle)."""
    grid: Grid
    x2d: np.ndarray
    y2d: np.ndarray
    omega: float
    xc: float
    yc: float
    h0: float
    parabolic_aks: bool = False   # Aks = bench.py's turb profile, else 0
    halocline: bool = False       # salt/temp = halocline_fields, else 0

    def velocity(self, x, y, z, t):
        u = -self.omega * (y - self.yc)
        v = self.omega * (x - self.xc)
        return u, v, np.zeros_like(u)

    def analytic(self, x0, y0, z0, t):
        r = np.hypot(x0 - self.xc, y0 - self.yc)
        th = np.arctan2(y0 - self.yc, x0 - self.xc) + self.omega * t
        return (self.xc + r * np.cos(th), self.yc + r * np.sin(th),
                np.full_like(np.asarray(th, np.float64), z0,
                             dtype=np.float64))

    def slabs(self, t):
        """Field arrays at record time t, in (level, eta, xi) layout; u
        and v at the logical midpoints of x- / y-adjacent rho nodes."""
        g = self.grid
        nx, ny, us, ws = g.nx, g.ny, g.us, g.ws
        x2, y2 = self.x2d, self.y2d
        yu = 0.5 * (y2[:, 1:] + y2[:, :-1])
        xv = 0.5 * (x2[1:, :] + x2[:-1, :])
        u = np.broadcast_to((-self.omega * (yu - self.yc))[None],
                            (us, ny, nx - 1))
        v = np.broadcast_to((self.omega * (xv - self.xc))[None],
                            (us, ny - 1, nx))
        w = np.zeros((ws, ny, nx))
        aks = parabolic_aks(g) if self.parabolic_aks else np.zeros_like(w)
        salt = temp = np.zeros((us, ny, nx))
        if self.halocline:
            salt, temp = halocline_fields(g, t)
        return dict(zeta=np.zeros((ny, nx)), u=np.ascontiguousarray(u),
                    v=np.ascontiguousarray(v), w=w, aks=aks, salt=salt,
                    temp=temp)


def make_curv_case(nx=41, ny=41, us=10, lx=100e3, ly=100e3, h0=50.0,
                   omega=1e-4, amp=0.02, mask=None, dtype=torch.float64,
                   device="cpu", parabolic_aks=False,
                   halocline=False) -> CurvSolidBodyCase:
    """Gently curvilinear analytic case (``ltjax.synth.make_curv_case``):
    a sinusoidal distortion of relative amplitude ``amp`` of the
    lx x ly rectangle, uniform levels with Cs = s and hc = h0."""
    X, Y = np.meshgrid(np.linspace(0.0, lx, nx), np.linspace(0.0, ly, ny))
    x2 = X + amp * lx * np.sin(np.pi * X / lx) * np.sin(2 * np.pi * Y / ly)
    y2 = Y + amp * ly * np.sin(2 * np.pi * X / lx) * np.sin(np.pi * Y / ly)
    if mask is None:
        mask = np.ones((ny, nx), np.int32)
    s_rho, s_w = uniform_sigma_levels(us)
    grid = make_curv_grid(x2, y2, np.full((ny, nx), h0), mask, s_rho, s_rho,
                          s_w, s_w, hc=h0, vtransform=1, dtype=dtype,
                          device=device)
    return CurvSolidBodyCase(grid=grid, x2d=x2, y2d=y2, omega=omega,
                             xc=lx / 2, yc=ly / 2, h0=h0,
                             parabolic_aks=parabolic_aks, halocline=halocline)


def fieldset_window(case: SolidBodyCase, t_first: float, dt: float,
                    n_records: int, dtype=torch.float32, device=None):
    """FieldSet with ``n_records`` records at t_first + k*dt — the
    (n_fuse + 2)-record window of step.make_fused_external_steps."""
    if device is None:
        device = case.grid.device
    times = [t_first + k * dt for k in range(n_records)]
    slabs = [case.slabs(t) for t in times]

    def stack(k):
        return np.stack([s[k] for s in slabs])

    return make_fieldset(stack("zeta"), stack("u"), stack("v"),
                         stack("w"), stack("aks"), np.asarray(times),
                         salt=stack("salt"), temp=stack("temp"),
                         dtype=dtype, device=device)


def fieldset_for(case: SolidBodyCase, t_center: float, dt: float,
                 dtype=torch.float32, device=None):
    """Triple buffer with records at t_center - dt, t_center,
    t_center + dt."""
    return fieldset_window(case, t_center - dt, dt, 3, dtype=dtype,
                           device=device)


def with_vertical_motion(fs: FieldSet, seed: int, w_amp: float = 5e-3,
                         zeta_std: float = 0.3) -> FieldSet:
    """``fs`` with a seeded random free surface (normal, std ``zeta_std``
    m) and vertical velocity (uniform in +-``w_amp`` m/s) at every record,
    node and w level.  Solid-body rotation has w = 0 and zeta = 0; these
    fields drive the w-ladder fit, the zeta-moved knots and the surface
    and bottom reflections.  Not an analytic case."""
    rng = np.random.default_rng(seed)
    zeta = zeta_std * rng.standard_normal(tuple(fs.zeta.shape))
    w = rng.uniform(-w_amp, w_amp, tuple(fs.w.shape))
    return replace(fs, zeta=torch.as_tensor(zeta, dtype=fs.zeta.dtype,
                                            device=fs.zeta.device),
                   w=torch.as_tensor(w, dtype=fs.w.dtype,
                                     device=fs.w.device))


def write_roms_files(case: SolidBodyCase, out_dir: str, n_records: int,
                     dt: float, records_per_file: int = 4,
                     prefix: str = "ocean_his_", numdigits: int = 4,
                     t0: float = 0.0, geographic: bool = False,
                     lonmin: float = 0.0, latmin: float = 0.0):
    """Write the case as a numbered multi-file ROMS history series + grid
    file (NetCDF3).  Returns (grid_path, [history_paths]).  With
    geographic=True the coordinates are written as lon/lat about
    (lonmin, latmin) with this package's projection inverse (pointwise
    on a curvilinear grid).  A ``halocline`` case writes salt and temp
    too."""
    os.makedirs(out_dir, exist_ok=True)
    g = case.grid
    nx, ny, us, ws = g.nx, g.ny, g.us, g.ws
    x2d, y2d = rho_xy(g)
    if geographic:
        lat2d = convert.y2lat(y2d, latmin)
        if g.curv is not None:
            lon2d = convert.x2lon(x2d, y2d, lonmin, latmin)
        else:
            # rectilinear in metres stays rectilinear in degrees: project
            # the x axis at the mid latitude (as run.rho_axes_from_grid)
            lon2d = convert.x2lon(x2d, np.full_like(x2d, float(y2d.mean())),
                                  lonmin, latmin)
        coord_vars = {"lon_rho": (("eta_rho", "xi_rho"), lon2d),
                      "lat_rho": (("eta_rho", "xi_rho"), lat2d)}
    else:
        coord_vars = {"x_rho": (("eta_rho", "xi_rho"), x2d),
                      "y_rho": (("eta_rho", "xi_rho"), y2d)}

    def host(a, dt_=np.float64):
        return a.cpu().numpy().astype(dt_)

    grid_path = os.path.join(out_dir, "grid.nc")
    write_netcdf(
        grid_path,
        dims={"eta_rho": ny, "xi_rho": nx, "s_rho": us, "s_w": ws},
        variables={
            **coord_vars,
            "mask_rho": (("eta_rho", "xi_rho"), host(g.mask_rho, np.int32)),
            "h": (("eta_rho", "xi_rho"), host(g.h)),
            "s_rho": (("s_rho",), host(g.s_rho)),
            "s_w": (("s_w",), host(g.s_w)),
            "Cs_r": (("s_rho",), host(g.Cs_r)),
            "Cs_w": (("s_w",), host(g.Cs_w)),
            "hc": ((), np.asarray(float(g.hc))),
            "Vtransform": ((), np.asarray(g.vtransform, np.int32)),
        })

    hist_paths = []
    rec = 0
    fileno = 1
    while rec < n_records:
        n_this = min(records_per_file, n_records - rec)
        times = t0 + dt * np.arange(rec, rec + n_this)
        slabs = [case.slabs(t) for t in times]

        def stack(k):
            return np.stack([s[k] for s in slabs]).astype(np.float32)

        path = os.path.join(out_dir, f"{prefix}{fileno:0{numdigits}d}.nc")
        write_netcdf(
            path,
            dims={"ocean_time": n_this, "eta_rho": ny, "xi_rho": nx,
                  "eta_u": ny, "xi_u": nx - 1, "eta_v": ny - 1,
                  "xi_v": nx, "s_rho": us, "s_w": ws},
            variables={
                "ocean_time": (("ocean_time",), np.asarray(times)),
                "zeta": (("ocean_time", "eta_rho", "xi_rho"),
                         stack("zeta")),
                "u": (("ocean_time", "s_rho", "eta_u", "xi_u"), stack("u")),
                "v": (("ocean_time", "s_rho", "eta_v", "xi_v"), stack("v")),
                "w": (("ocean_time", "s_w", "eta_rho", "xi_rho"),
                      stack("w")),
                "AKs": (("ocean_time", "s_w", "eta_rho", "xi_rho"),
                        stack("aks")),
                **({k: (("ocean_time", "s_rho", "eta_rho", "xi_rho"),
                        stack(k)) for k in ("salt", "temp")}
                   if case.halocline else {}),
            })
        hist_paths.append(path)
        rec += n_this
        fileno += 1
    return grid_path, hist_paths


def _nml_value(v) -> str:
    if isinstance(v, bool):
        return ".TRUE." if v else ".FALSE."
    if isinstance(v, str):
        return f"'{v}'"
    return repr(v)


def _write_polygons(path: str, polys, lonlat=None) -> None:
    """A polygon CSV (lon, lat, id rows; planar: lon = x, lat = y, else
    projected back about ``lonlat`` = (lonmin, latmin))."""
    with open(path, "w") as f:
        for pid, v in polys:
            v = np.asarray(v, np.float64)
            if lonlat is not None:
                v = np.stack([convert.x2lon(v[:, 0], v[:, 1], *lonlat),
                              convert.y2lat(v[:, 1], lonlat[1])], -1)
            for vx, vy in v:
                f.write(f"{vx:.9f},{vy:.9f},{int(pid)}\n")


def write_parfile(path: str, rows, decimals: int = 9,
                  chunk: int = 1 << 20) -> None:
    """Write rows (N, C) of finite floats as comma-separated fixed-point
    text with ``decimals`` digits (np.savetxt's "%.9f" layout, fields
    padded with leading blanks), formatted with numpy arithmetic rather
    than row by row: 10^7 rows take seconds.  The last digit is |v| *
    10^decimals rounded in float64, so it may differ from printf's by
    one."""
    rows = np.asarray(rows, np.float64)
    scale = 10 ** decimals
    with open(path, "wb") as f:
        for c0 in range(0, max(rows.shape[0], 1), chunk):
            r = rows[c0:c0 + chunk]
            q = np.rint(np.abs(r) * scale).astype(np.int64)
            ip, fp = np.divmod(q, scale)
            nd = np.ones_like(ip)
            while (ip >= 10 ** nd).any():
                nd += ip >= 10 ** nd
            w = int(nd.max(initial=1))          # integer digits
            buf = np.full(r.shape + (w + decimals + 3,), ord(" "), np.uint8)
            for k in range(decimals):
                buf[..., w + 2 + k] = 48 + (fp // 10 ** (decimals - 1 - k)) % 10
            buf[..., w + 1] = ord(".")
            for k in range(w):
                buf[..., w - k] = np.where(k < nd, 48 + (ip // 10 ** k) % 10,
                                           ord(" "))
            rr, cc = np.nonzero(r < 0)
            buf[rr, cc, w - nd[rr, cc]] = ord("-")
            buf[..., -1] = ord(",")
            buf[:, -1, -1] = ord("\n")
            f.write(buf.tobytes())


def write_run_files(case: SolidBodyCase, out_dir: str, x, y, z,
                    n_ext: int, dt: int, idt: int, habitat=None, holes=None,
                    geographic: bool = False, lonmin: float = 0.0,
                    latmin: float = 0.0, extra_records: int = 0,
                    **params) -> str:
    """Write a complete run of ``case`` (rectilinear or curvilinear): the
    ROMS grid + history series (n_ext + 2 + ``extra_records`` records at
    t = 0, dt, ...), a
    parfile of the particles (x, y, z) released at t = 0, and an
    ``LTRANS.data`` namelist; extra namelist ``params`` override the
    defaults.  Planar, or with ``geographic`` lon/lat files and parfile
    about (lonmin, latmin) and SphericalProjection on.  The series' AKs,
    salt and temp are the case's (``parabolic_aks=``, ``halocline=``).
    ``habitat`` and ``holes`` ([(id, (V, 2) xy vertices in metres)]) are
    written as polygon CSVs and turn settlement on
    (``habitatfile``, ``holesExist``/``holefile``).  Returns the namelist
    path (``python -m ltjax.run`` and ``ltjax_torch.run`` both read
    it)."""
    write_roms_files(case, out_dir, n_records=n_ext + 2 + extra_records,
                     dt=float(dt),
                     geographic=geographic, lonmin=lonmin, latmin=latmin)
    parfile = os.path.join(out_dir, "parfile.csv")
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if geographic:
        x, y = convert.x2lon(x, y, lonmin, latmin), convert.y2lat(y, latmin)
    rows = np.stack([x, y, -np.asarray(z, np.float64), np.zeros(len(x))],
                    axis=1)
    write_parfile(parfile, rows)
    g = case.grid
    lonlat = (lonmin, latmin) if geographic else None
    values = dict(
        numpar=len(x), days=n_ext * dt / 86400.0, dt=int(dt), idt=int(idt),
        iprint=int(dt), us=g.us, ws=g.ws, hc=float(g.hc),
        Vtransform=g.vtransform, SphericalProjection=bool(geographic),
        lonmin=float(lonmin), latmin=float(latmin),
        NCgridfile=os.path.join(out_dir, "grid.nc"), dirin=out_dir, prefix="ocean_his_", suffix=".nc", filenum=1,
        numdigits=4, tdim=4, parfile=parfile,
        outpath=os.path.join(out_dir, "out"), NCOutFile="run1",
        writeCSV=True, writeNC=False)
    if habitat is not None:
        values.update(settlementon=True,
                      habitatfile=os.path.join(out_dir, "habitat.csv"))
        _write_polygons(values["habitatfile"], habitat, lonlat)
    if holes is not None:
        values.update(holesExist=True,
                      holefile=os.path.join(out_dir, "holes.csv"))
        _write_polygons(values["holefile"], holes, lonlat)
    values.update(params)
    path = os.path.join(out_dir, "LTRANS.data")
    with open(path, "w") as f:
        f.write("&run\n")
        for k, v in values.items():
            f.write(f"  {k} = {_nml_value(v)}\n")
        f.write("/\n")
    return path


def migration_block(n: int, live: int, leave: int, ntiles: int = 4,
                    my_t: int = 1, dtype=torch.float64, device="cpu",
                    seed: int = 0, strip: float = 1e3, edge_cases=False):
    """One rank's block of ``n`` slots on ``ntiles`` eta strips of
    ``strip`` metres (ownership edges -inf, strip, 2 strip, ..., inf):
    ``live`` particles in random slots (the rest EMPTY), ``leave`` of them
    in the other strips (each a random one), the others in strip
    ``my_t``; every status but EMPTY, random columns.  ``edge_cases``
    puts the first live particles' y on the edges, one ulp either side,
    and at NaN and +-inf.  Returns (Particles, edges) with the edges as a
    float64 numpy array."""
    from .shard import EMPTY
    from .state import Particles
    rng = np.random.default_rng(seed)
    edges = np.concatenate([[-np.inf], strip * np.arange(1, ntiles),
                            [np.inf]])
    slots = rng.permutation(n)[:live]
    dest = np.full(live, my_t)
    if ntiles > 1 and leave:
        other = rng.integers(0, ntiles - 1, leave)
        dest[:leave] = other + (other >= my_t)
    dest = rng.permutation(dest)
    y = rng.uniform(-strip, (ntiles + 1) * strip, n)
    y[slots] = (dest + rng.uniform(0.0, 1.0, live)) * strip
    if edge_cases:
        special = np.concatenate([
            edges[1:-1], np.nextafter(edges[1:-1], -np.inf),
            np.nextafter(edges[1:-1], np.inf), [np.nan, np.inf, -np.inf]])
        k = min(live, special.size)
        y[slots[:k]] = special[:k]
    status = np.full(n, EMPTY, np.int32)
    status[slots] = rng.integers(0, 6, live)

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return Particles(
        x=f(rng.uniform(0.0, 1e5, n)), y=f(y), z=f(rng.uniform(-50, 0, n)),
        dob=f(rng.uniform(0, 1e5, n)), age=f(rng.uniform(0, 1e5, n)),
        status=i(status), pid=i(rng.permutation(n)),
        settle_poly=i(rng.integers(-1, 5, n)),
        hit_land=i(rng.integers(0, 9, n)), hit_bottom=i(rng.integers(0, 9, n)),
        salt=f(rng.uniform(0, 35, n)), temp=f(rng.uniform(0, 30, n))), edges
