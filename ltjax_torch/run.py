"""Run driver: init -> external-step loop -> output (single device).

Counterpart of ``ltjax.run.run`` for the ported slice.  CLI:

    python -m ltjax_torch.run path/to/LTRANS.data [--device cpu|cuda]
        [--resume]

The namelist is the reference's own ``LTRANS.data`` (read by
``ltjax_torch.config``, the port's copy of ``ltjax.config``).  The run
takes the CUDA path on the GPU, in the positions' dtype (``dtype_pos``,
float64 unless the namelist says otherwise), and refuses to start
without one unless asked for the CPU (``--device cpu``), where it takes
the plain PyTorch path.  The grid may be rectilinear (uniform or
stretched axes) or curvilinear (a ROMS file whose lon/lat vary along
both axes).  ``checkpoint_every`` saves the particles every that many
external steps (``ltjax_torch.checkpoint``, ltjax's npz format, in
``checkpoint_dir``); ``--resume`` restarts from the newest one (or from
the parfile when there is none), with the field series re-primed where
it stood.  ``BoundaryBLNs`` writes the boundary segments
(``xyBounds.csv``, ``llBounds.csv``) to ``outpath``.  With ``prefetch``
(the default) a worker thread reads the next records, and on the GPU
copies them to the device, while a chunk runs (``io.prefetch``).

The first stdout line is a JSON object naming the path taken
("cuda_ext_step": the whole-external-step kernel; "cuda_rk4_step": the
per-internal-step kernel of the "per_step" route, which stochastic
mortality takes; "cuda_native": the native route's PyTorch ops on the
card, which ``fast_interp = False`` and adaptive tension take; "plain"
on the CPU), the route, the grid kind and the enabled lanes, then one
JSON line per chunk of external steps with status counts,
particle-steps/s, the chunk's record-read and compute seconds and the
prefetcher's cumulative wait (``stall_s``).  Random streams are keyed
by ``cfg.seed`` as ``ltjax.run`` keys them (``jax.random.key(seed)``,
see ``ltjax_torch.rng``), and vertical turbulence with ``readAks`` reads
the series' AKs.  Settlement reads the habitat (and hole) polygon CSVs;
SaltTempOn and behaviors 4/5 read the series' salt and temp.  History
files must be NetCDF3 unless ``h5py`` is installed
(``ltjax_torch.io.nc``).

Diagnostic switches (environment variables, ltjax's names):

* ``LTJAX_PROFILE_DIR=/path``: a ``torch.profiler`` trace (CPU and, on
  the GPU, CUDA activity) of the chunks that start at external steps
  [start, stop), ``LTJAX_PROFILE_STEPS=start:stop`` (default ``1:3``),
  written there as a Chrome trace file;
* ``LTJAX_DEBUG_NANS=1``: after each chunk, check x, y, z (and salt and
  temp under SaltTempOn) of the released particles, and raise
  RuntimeError naming the external step and the count of NaNs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from . import convert
from . import state as st
from .config import Config, config_from_namelist
from .fields import stack_records
from .grid import Grid, make_curv_grid, make_grid
from .io.prefetch import Prefetcher
from .io.roms import (RomsGridData, RomsSeries, _coord_2d, is_rectilinear,
                      read_grid)
from .out.writer import TrajectoryWriter
from .physics import boundary as bd
from .physics import settlement as stl
from .step import (StepContext, check_supported, make_fused_external_steps,
                   mode_flags, summary_counts)


def _project_polys(polys, cfg: Config):
    """Polygon vertices from lon/lat to internal metres."""
    out = []
    for pid, v in polys:
        x = convert.lon2x(v[:, 0], v[:, 1], cfg.lonmin, cfg.latmin,
                          cfg.Earth_Radius, cfg.SphericalProjection)
        y = convert.lat2y(v[:, 1], cfg.latmin, cfg.Earth_Radius,
                          cfg.SphericalProjection)
        out.append((pid, np.stack([np.asarray(x), np.asarray(y)], -1)))
    return out


def build_context(cfg: Config, grid: Grid) -> StepContext:
    """Boundaries from the land mask (on the psi mesh of a curvilinear
    grid); the grid rim is OPEN (whether it exits or reflects is
    cfg.OpenOceanBoundary's call at reflect time).  With settlement, the
    habitat polygons (and holes) from their CSVs, projected and
    rasterized onto the boundary cell lattice."""
    mask = grid.mask_rho.cpu().numpy()
    if grid.curv is not None:
        xy = grid.curv.xy_flat.cpu().numpy().reshape(grid.ny, grid.nx, 2)
        bounds = bd.build_boundaries_curv(mask, xy[..., 0], xy[..., 1],
                                          grid.curv, closed_edges=False,
                                          device=grid.device)
    else:
        bounds = bd.build_boundaries(mask, grid.x_rho.cpu().numpy(),
                                     grid.y_rho.cpu().numpy(),
                                     closed_edges=False, device=grid.device)
    polys = holes = None
    if cfg.settlementon and cfg.habitatfile:
        xe, ye = bounds.x_edges.cpu().numpy(), bounds.y_edges.cpu().numpy()

        def load(path):
            return stl.build_polygons(
                _project_polys(stl.read_polygon_csv(path), cfg), xe, ye,
                device=grid.device)

        polys = load(cfg.habitatfile)
        if cfg.holesExist and cfg.holefile:
            holes = load(cfg.holefile)
    return StepContext(grid=grid, bounds=bounds, polys=polys, holes=holes)


def rho_axes_from_grid(gd: RomsGridData, cfg: Config):
    """1-D metre axes of a rectilinear grid (geographic axes projected
    about (lonmin, latmin) at the domain's mid latitude)."""
    lon2, lat2 = _coord_2d(gd)
    lon_axis = lon2[0, :]
    lat_axis = lat2[:, 0]
    if gd.geographic:
        x = convert.lon2x(lon_axis, np.full_like(lon_axis, lat_axis.mean()),
                          cfg.lonmin, cfg.latmin, cfg.Earth_Radius,
                          cfg.SphericalProjection)
        y = convert.lat2y(lat_axis, cfg.latmin, cfg.Earth_Radius,
                          cfg.SphericalProjection)
    else:
        x, y = lon_axis, lat_axis
    return np.asarray(x, np.float64), np.asarray(y, np.float64)


def grid_from_roms(gd: RomsGridData, cfg: Config, dtype, device) -> Grid:
    """The Grid of raw ROMS grid data: 1-D metre axes when lon varies
    only along xi and lat only along eta, else every rho point projected
    and the curvilinear inverse map (``make_curv_grid``)."""
    if not is_rectilinear(gd):
        lon2, lat2 = _coord_2d(gd)
        if gd.geographic:
            y2 = convert.lat2y(lat2, cfg.latmin, cfg.Earth_Radius,
                               cfg.SphericalProjection)
            x2 = convert.lon2x(lon2, lat2, cfg.lonmin, cfg.latmin,
                               cfg.Earth_Radius, cfg.SphericalProjection)
        else:
            x2, y2 = lon2, lat2
        return make_curv_grid(x2, y2, gd.h, gd.mask_rho, gd.s_rho, gd.Cs_r,
                              gd.s_w, gd.Cs_w, gd.hc, gd.vtransform,
                              dtype=dtype, device=device)
    x_axis, y_axis = rho_axes_from_grid(gd, cfg)
    return make_grid(x_axis, y_axis, gd.h, gd.mask_rho, gd.s_rho, gd.Cs_r,
                     gd.s_w, gd.Cs_w, gd.hc, gd.vtransform, dtype=dtype,
                     device=device)


def load_grid(cfg: Config, device) -> Grid:
    """The run's Grid; files without s-levels get cfg.us uniform levels."""
    hist = RomsSeries(cfg).path_for(0) if cfg.dirin else None
    gd = read_grid(cfg.NCgridfile, cfg, hist_path=hist)
    return grid_from_roms(gd, cfg, getattr(torch, cfg.dtype_pos), device)


def init_particles_from_parfile(cfg: Config, device) -> st.Particles:
    arr = st.read_parfile(cfg.parfile)
    lon, lat, depth, dob = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    x = convert.lon2x(lon, lat, cfg.lonmin, cfg.latmin, cfg.Earth_Radius,
                      cfg.SphericalProjection)
    y = convert.lat2y(lat, cfg.latmin, cfg.Earth_Radius,
                      cfg.SphericalProjection)
    return st.init_particles(x, y, -np.abs(depth), dob,
                             dtype=getattr(torch, cfg.dtype_pos),
                             device=device)


def enabled_lanes(cfg: Config) -> List[str]:
    """The physics a run takes, as named in the startup line: advection,
    adaptive_tension, hturb, vturb_aks / vturb_const, behavior<type>,
    mortality, settlement, salt_temp."""
    lanes = ["advection"]
    if cfg.tension_sigma < 0:
        lanes.append("adaptive_tension")
    if cfg.HTurbOn:
        lanes.append("hturb")
    if cfg.VTurbOn:
        lanes.append("vturb_aks" if cfg.readAks else "vturb_const")
    if cfg.Behavior:
        lanes.append(f"behavior{cfg.Behavior}")
    if cfg.mortality:
        lanes.append("mortality")
    if cfg.settlementon:
        lanes.append("settlement")
    if cfg.SaltTempOn:
        lanes.append("salt_temp")
    return lanes


class Timing:
    """WriteModelTiming analog: cumulative per-phase wall clock."""

    def __init__(self):
        self.acc = {}

    def add(self, phase: str, dt: float):
        self.acc[phase] = self.acc.get(phase, 0.0) + dt

    def summary(self):
        return dict(sorted(self.acc.items()))


class Profiler:
    """``LTJAX_PROFILE_DIR``: a torch.profiler trace of the chunks that
    start at external steps [start, stop) (``LTJAX_PROFILE_STEPS``,
    default 1:3), exported as ``trace_ext<start>-<stop>.json``."""

    def __init__(self, device: torch.device):
        self.dir = os.environ.get("LTJAX_PROFILE_DIR")
        a, _, b = os.environ.get("LTJAX_PROFILE_STEPS", "1:3").partition(":")
        self.start, self.stop = int(a), int(b or (int(a) + 2))
        self.device = device
        self.prof = None

    def tick(self, ext: int):
        if not self.dir:
            return
        if self.prof is None and self.start <= ext < self.stop:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        elif self.prof is not None and ext >= self.stop:
            self.close()

    def close(self):
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(
            self.dir, f"trace_ext{self.start}-{self.stop}.json"))
        self.prof = None


def check_nans(cfg: Config, p: st.Particles, ext: int):
    """``LTJAX_DEBUG_NANS``: raise if a released particle's x, y, z (or
    salt, temp under SaltTempOn) is NaN after the chunk ending at
    external step ``ext``."""
    keys = ("x", "y", "z") + (("salt", "temp") if cfg.SaltTempOn else ())
    bad = torch.zeros_like(p.status, dtype=torch.bool)
    for k in keys:
        bad |= torch.isnan(getattr(p, k))
    n_bad = int((bad & (p.status != st.NOT_RELEASED)).sum())
    if n_bad:
        raise RuntimeError(f"LTJAX_DEBUG_NANS: {n_bad} released particles "
                           f"have NaN state after external step {ext}")


def run(cfg: Config, resume: bool = False, device=None,
        series_paths: Optional[List[str]] = None) -> st.Particles:
    """Run the configured simulation; returns the final particles.  The
    run takes the CUDA device unless ``device`` names another; without
    one it raises rather than fall back to the CPU."""
    cfg.validate()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ltjax_torch.run: no CUDA device, and the run takes the GPU "
                "unless asked for the CPU: pass --device cpu (or "
                "run(cfg, device='cpu'))")
        device = "cuda"
    device = torch.device(device)
    timing = Timing()
    t0 = time.perf_counter()
    grid = load_grid(cfg, device)
    ctx = build_context(cfg, grid)
    check_supported(cfg, ctx)
    if cfg.BoundaryBLNs:
        bd.dump_boundaries(
            ctx.bounds, cfg.outpath,
            to_lonlat=lambda x, y: (
                convert.x2lon(x, y, cfg.lonmin, cfg.latmin,
                              cfg.Earth_Radius, cfg.SphericalProjection),
                convert.y2lat(y, cfg.latmin, cfg.Earth_Radius,
                              cfg.SphericalProjection)))
    series = RomsSeries(cfg, paths=series_paths)
    if cfg.WriteParfile and cfg.parfile:
        os.makedirs(cfg.outpath, exist_ok=True)
        shutil.copyfile(cfg.parfile,
                        os.path.join(cfg.outpath, "parfile_echo.csv"))
    start_ext = 0
    global_rec = 0
    resumed_extra = None
    path = ckpt.latest(cfg.checkpoint_dir) if resume else None
    if path:
        particles, start_ext, global_rec, resumed_extra = ckpt.load(
            path, device)
        pos = getattr(torch, cfg.dtype_pos)
        particles = particles.replace(**{
            k: getattr(particles, k).to(pos)
            for k in ("x", "y", "z", "dob", "age", "salt", "temp")})
        series.seek(global_rec - 3)       # re-prime the 3-record window
    else:
        particles = init_particles_from_parfile(cfg, device)

    # --- prime the record window (initHydro) -----------------------------
    window: List[dict] = [series.next_record() for _ in range(3)]
    if resumed_extra is None:
        global_rec += 3
        t_base = window[0]["time"]
    else:
        # global_rec already counts the re-primed records; field times
        # stay on the original run clock
        t_base = resumed_extra.get(
            "t_base", window[0]["time"] - (global_rec - 3) * cfg.dt)
    win_start = global_rec - 3
    timing.add("hydro_init", time.perf_counter() - t0)

    n_fuse = max(1, cfg.ext_fuse)
    route = mode_flags(ctx, cfg)
    print(json.dumps({
        "path": ("plain" if device.type != "cuda" else
                 {"per_step": "cuda_rk4_step", "native": "cuda_native",
                  "ext_step": "cuda_ext_step"}[route]),
        "route": route,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "uniform": bool(grid.uniform),
        "curvilinear": grid.curv is not None, "numpar": particles.n,
        "dtype_pos": cfg.dtype_pos, "n_fuse": n_fuse,
        "lanes": enabled_lanes(cfg), "seed": cfg.seed}), flush=True)

    writer = TrajectoryWriter(cfg)
    fused_cache = {}
    field_dtype = getattr(torch, cfg.dtype_field)
    n_ext = cfg.external_steps
    out_every = cfg.output_every_ext
    if not resume:
        writer.snapshot(0.0, particles)
    prefetch = (Prefetcher(series.next_record, depth=max(2, n_fuse + 1),
                           device=device) if cfg.prefetch else None)
    profiler = Profiler(device)
    debug_nans = bool(os.environ.get("LTJAX_DEBUG_NANS"))
    exhausted = False
    try:
        ext = start_ext
        while ext < n_ext:
            # --- chunk size: never straddle an output or checkpoint ------
            E = min(n_fuse, n_ext - ext, out_every - (ext % out_every))
            if cfg.checkpoint_every:
                E = min(E, cfg.checkpoint_every
                        - (ext % cfg.checkpoint_every))

            # --- updateHydro: extend the window to record ext+E+1 --------
            tw = time.perf_counter()
            while global_rec - 1 < ext + E + 1 and not exhausted:
                rec = prefetch.next() if prefetch else series.next_record()
                if rec is None:
                    exhausted = True
                    break
                window.append(rec)
                global_rec += 1
            if exhausted:
                E = min(E, global_rec - 2 - ext)
                if E < 1:
                    print(json.dumps({"event": "series_exhausted",
                                      "ext": ext}))
                    break
            while win_start < ext:                  # drop stale records
                window.pop(0)
                win_start += 1
            fsW = stack_records(window[:E + 2], t_base, field_dtype, device,
                                with_salt_temp=cfg.needs_salt_fields())
            read_s = time.perf_counter() - tw
            timing.add("hydro_read", read_s)

            # --- compute E external steps --------------------------------
            profiler.tick(ext)
            tc = time.perf_counter()
            t_ext = float(ext * cfg.dt)
            if E not in fused_cache:
                fused_cache[E] = make_fused_external_steps(ctx, cfg, E)
            particles = fused_cache[E](particles, fsW, t_ext, ext)
            counts = summary_counts(particles)      # waits for the device
            step_s = time.perf_counter() - tc
            timing.add("compute", step_s)
            ext += E
            if debug_nans:
                check_nans(cfg, particles, ext - 1)
            if cfg.ErrorFlag == 0 and counts["error"] > 0:
                raise RuntimeError(
                    f"{counts['error']} particles hit location/"
                    f"interpolation errors at ext step {ext - 1} "
                    f"(ErrorFlag=0 halts; set ErrorFlag>0 to continue)")
            if ext % out_every == 0:
                to = time.perf_counter()
                writer.snapshot(t_ext + E * cfg.dt, particles)
                timing.add("output", time.perf_counter() - to)
            if cfg.checkpoint_every and ext % cfg.checkpoint_every == 0:
                ckpt.save(os.path.join(cfg.checkpoint_dir,
                                       f"ckpt_{ext}.npz"),
                          particles, ext, global_rec,
                          extra={"t_base": float(t_base)})
            log = {"ext": ext - E, "n_fused": E, "sim_t": t_ext + E * cfg.dt,
                   "steps_per_s": particles.n * cfg.internal_steps * E
                   / step_s, "hydro_read_s": read_s, "compute_s": step_s,
                   "stall_s": prefetch.stall_s if prefetch else 0.0}
            log.update(counts)
            print(json.dumps(log), flush=True)
    finally:
        profiler.close()
        if prefetch:
            prefetch.close()
        writer.close()
        series.close()
    if cfg.WriteModelTiming:
        print(json.dumps({"timing": timing.summary()}))
    return particles


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ltjax_torch.run")
    ap.add_argument("namelist", help="the run's LTRANS.data")
    ap.add_argument("--resume", action="store_true",
                    help="restart from the newest checkpoint in "
                    "checkpoint_dir")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default cuda; cpu takes the plain PyTorch path")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    run(config_from_namelist(args.namelist), resume=args.resume,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
