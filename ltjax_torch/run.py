"""Run driver: init -> external-step loop -> output.

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
both axes).

One chunk loop (``_drive``) runs every run, on one of two placements:
``_Whole``, the whole grid and batch on one device (``run``), or
``_Tile``, one rank's tile of a sharded run (``mesh_particles *
mesh_tiles > 1``, ``run_sharded``, the counterpart of ltjax's: one
process a rank of the (dp, tile) mesh, started by ``torchrun`` or by the
run itself, ``ltjax_torch.dist``; NCCL, a card a rank, on CUDA, gloo on
the CPU).
The loop primes a 3-record window and steps chunks of up to
``ext_fuse`` external steps that never straddle an output or a
checkpoint.  With ``prefetch`` (the default) a worker thread reads the
next records, and on the GPU copies them to the device, while a chunk
runs (``io.prefetch``).  ``checkpoint_every`` saves the particles every
that many external steps (``ltjax_torch.checkpoint``, ltjax's npz
format, in ``checkpoint_dir``); ``--resume`` restarts from the newest
one (or from the parfile when there is none), with the series re-primed
where it stood.  ``BoundaryBLNs`` writes the boundary segments
(``xyBounds.csv``, ``llBounds.csv``) to ``outpath``.

The first stdout line (rank 0's) is a JSON object naming the path taken
("cuda_ext_step": the whole-external-step kernel; "cuda_rk4_step": the
per-internal-step kernels of the "per_step" route, RK4 (K2) and the
lanes (K3), which stochastic mortality takes; "cuda_native": the native
route's PyTorch ops on the card, which ``fast_interp = False`` and
adaptive tension take; "cuda_packed": the packed route's PyTorch ops on
the card, which ``kernel_interp = False`` takes; "plain" on the CPU),
the route, the grid kind and the enabled lanes, then one JSON line per
chunk of external steps (every rank's) with status counts,
particle-steps/s, the chunk's record-read and compute seconds and the
prefetcher's cumulative wait (``stall_s``).  Random streams are keyed by
``cfg.seed`` as ``ltjax.run`` keys them (``jax.random.key(seed)``, see
``ltjax_torch.rng``), and vertical turbulence with ``readAks`` reads the
series' AKs.  Settlement reads the habitat (and hole) polygon CSVs;
SaltTempOn and behaviors 4/5 read the series' salt and temp.  History
files must be NetCDF3 unless ``h5py`` is installed
(``ltjax_torch.io.nc``).

Diagnostic switches (environment variables, ltjax's names):

* ``LTJAX_PROFILE_DIR=/path``: a ``torch.profiler`` trace (``Profiler``;
  rank 0's) of the chunks that start at external steps
  ``LTJAX_PROFILE_STEPS=start:stop`` (default ``1:3``).  It names the
  port's layers as host spans (``ltjax_torch.trace``):
  ``ltjax_torch.read`` (a chunk's record window), ``ltjax_torch.chunk``
  (its fused external steps) with ``.tables``, ``.sort``, ``.unsort``
  and ``.k1`` (or ``.k2``/``.k3``, each with its ``.upload``) inside,
  ``ltjax_torch.counts`` (the host sync), ``ltjax_torch.output`` and
  ``ltjax_torch.checkpoint``;
* ``LTJAX_DEBUG_NANS=1``: after each chunk, raise if a released
  particle's state is NaN (``check_nans``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from . import convert, dist, shard
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
from .trace import span


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


def route_path(route: str, device) -> str:
    """The startup line's "path": the CUDA kernel or the PyTorch ops that
    a route runs on the card, "plain" on the CPU."""
    if torch.device(device).type != "cuda":
        return "plain"
    return {"ext_step": "cuda_ext_step", "per_step": "cuda_rk4_step",
            "native": "cuda_native", "packed": "cuda_packed"}[route]


def enabled_lanes(cfg: Config) -> List[str]:
    """The physics a run takes, as named in the startup line: advection,
    adaptive_tension, hturb, vturb_aks / vturb_const, behavior<type>,
    mortality, settlement, salt_temp."""
    vturb = "vturb_aks" if cfg.readAks else "vturb_const"
    return ["advection"] + [lane for on, lane in (
        (cfg.tension_sigma < 0, "adaptive_tension"), (cfg.HTurbOn, "hturb"),
        (cfg.VTurbOn, vturb), (cfg.Behavior, f"behavior{cfg.Behavior}"),
        (cfg.mortality, "mortality"), (cfg.settlementon, "settlement"),
        (cfg.SaltTempOn, "salt_temp")) if on]


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


def _device_or_cuda(device, call: str):
    """``device``, or "cuda" when it is None; without a CUDA device that
    raises, naming --device cpu and ``call``: a run takes the GPU unless
    asked for the CPU."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ltjax_torch.run: no CUDA device, and the run takes the GPU "
            f"unless asked for the CPU: pass --device cpu (or {call})")
    return "cuda"


def _emit(obj) -> None:
    """One JSON line in one write (the ranks share stdout)."""
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


class _Whole:
    """A single run's placement: the whole grid and batch on one device,
    ``make_fused_external_steps``, its own counts, one writer,
    ``ckpt_<ext>.npz``, a ``timing`` line at the end.  A placement gives
    ``_drive`` what differs: the eta rows read (``lay_out``), the
    starting particles ((p, ext, global record, checkpoint extra or
    None)), E steps ((p, what moved)), a chunk's counts and log fields
    (raising the ErrorFlag halt), snapshots and the end."""

    rank, tag, log_tag, ckpt_extra, startup = 0, "", {}, {}, {}

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg, self.device, self.steppers = cfg, device, {}

    def lay_out(self, grid: Grid, ctx: StepContext):
        self.ctx = ctx

    def strip(self, rec):
        return rec

    def start(self, resume: bool):
        path = ckpt.latest(self.cfg.checkpoint_dir) if resume else None
        if path:
            p, ext, grec, extra = ckpt.load(path, self.device)
        else:
            p, ext, grec, extra = init_particles_from_parfile(
                self.cfg, self.device), 0, 0, None
        self.n = p.n
        return p, ext, grec, extra

    def open_output(self):
        self.writer = TrajectoryWriter(self.cfg)

    def snapshot(self, t: float, p: st.Particles):
        self.writer.snapshot(t, p)

    def step(self, p, fsW, t_ext: float, ext: int, E: int):
        if E not in self.steppers:
            self.steppers[E] = make_fused_external_steps(self.ctx, self.cfg, E)
        return self.steppers[E](p, fsW, t_ext, ext), None

    def total(self, counts: dict, moved, ext: int):
        if self.cfg.ErrorFlag == 0 and counts["error"] > 0:
            raise RuntimeError(
                f"{counts['error']} particles hit location/"
                f"interpolation errors at ext step {ext} "
                f"(ErrorFlag=0 halts; set ErrorFlag>0 to continue)")
        return counts, {}

    def close(self):
        if self.writer:
            self.writer.close()

    def finish(self, p: st.Particles, timing: Counter):
        if self.cfg.WriteModelTiming:
            _emit({"timing": dict(sorted(timing.items()))})
        return p


class _Tile(_Whole):
    """One rank's placement in a sharded run: its tile's eta strip (with
    the halo) and slot block, ``shard.make_tiled_steps`` with migration,
    counts and migration drops summed over the ranks (so that all ranks
    halt together), snapshots gathered to rank 0 (NetCDF only: one shard
    file a rank, merged at the end), rank-tagged checkpoints with the
    mesh.  Its startup fields are the backend, ranks, cards, mesh and
    capacities; its chunk lines add ``rank`` and its own ``migrated``; its
    last line, ``rank_done``, has its kernel launches and peak memory."""

    def __init__(self, cfg: Config, me, device: torch.device, backend: str):
        super().__init__(cfg, device)
        self.me, self.rank, self.n = me, me.rank, cfg.numpar
        self.tag, self.log_tag = ckpt.rank_tag(me.rank), {"rank": me.rank}
        self.mesh, self.backend = [cfg.mesh_particles, cfg.mesh_tiles], backend
        self.ckpt_extra = {"mesh": self.mesh}

    def lay_out(self, grid: Grid, ctx: StepContext):
        cfg, me, curv = self.cfg, self.me, grid.curv is not None
        self.spec = spec = shard.make_spec(
            cfg, grid.ny, cfg.numpar, *self.mesh,
            halo=0 if curv else cfg.halo_rows, slack=cfg.migrate_capacity)
        self.ny, self.ctx, self.eta = grid.ny, ctx, None
        self.edges = np.array([-np.inf, np.inf])   # curvilinear: whole grid
        if not curv:
            tiled = shard.build_tiled_static(grid, spec)
            self.ctx = shard.tile_context(ctx, spec, tiled, me.tile)
            self.edges = tiled.tile_edges
            self.eta = shard.strip_rows(spec, me.tile, grid.ny)
        self.startup = {
            "backend": self.backend, "ranks": me.world,
            "cards": (min(me.world, torch.cuda.device_count())
                      if self.device.type == "cuda" else 0),
            "mesh": self.mesh, "halo": spec.halo, "cap": spec.cap,
            "mig_cap": spec.mig_cap}
        return self.eta

    def strip(self, rec):
        if rec is None or self.eta is None:
            return rec
        return shard.strip_record(rec, self.spec, self.me.tile, self.ny,
                                  self.eta[0])

    def start(self, resume: bool):
        """The parfile's particles scattered onto this tile, or the newest
        checkpoint's (``checkpoint.latest_sharded``): its own file on the
        same mesh, else every saved particle re-scattered onto this one."""
        cfg, me, spec = self.cfg, self.me, self.spec
        found = ckpt.latest_sharded(cfg.checkpoint_dir) if resume else None
        if not found:
            return shard.scatter_block(init_particles_from_parfile(
                cfg, "cpu"), spec, self.edges, me.dp, me.tile), 0, 0, None
        _, paths, mesh = found
        if mesh == (spec.ndp, spec.ntiles):
            p, ext, grec, extra = ckpt.load(paths[me.rank])
        else:
            loaded = [ckpt.load(path) for path in paths]
            p = shard.scatter_block(shard.gather_particles(
                [q[0] for q in loaded]), spec, self.edges, me.dp, me.tile)
            ext, grec, extra = loaded[0][1:]
        return p, ext, grec, extra

    def open_output(self):
        cfg = self.cfg
        self.stream = cfg.writeNC and not cfg.writeCSV
        self.writer = (TrajectoryWriter(cfg, shard_tag=self.tag)
                       if self.stream else TrajectoryWriter(cfg)
                       if self.rank == 0 else None)

    def snapshot(self, t: float, p: st.Particles):
        # NetCDF only: this rank's slots into its shard file; else the
        # whole batch, gathered to rank 0 in pid order
        if self.stream:
            self.writer.snapshot(t, p)
        elif self.cfg.writeCSV or self.cfg.writeNC:
            parts = self.me.gather_rows(shard.pack_rows(p))
            if self.rank == 0:
                self.writer.snapshot(t, shard.gather_particles(
                    [shard.unpack_rows(r, p.x.dtype) for r in parts]))

    def step(self, p, fsW, t_ext: float, ext: int, E: int):
        if E not in self.steppers:
            self.steppers[E] = shard.make_tiled_steps(
                self.ctx, self.cfg, self.spec, self.me.tile, self.edges, E,
                self.me.exchange)
        p, drops, sent = self.steppers[E](p, fsW, t_ext, ext)
        return p, (drops, sent)

    def total(self, local: dict, moved, ext: int):
        drops, sent = moved
        tot = self.me.sum(list(local.values()) + [int(drops), int(sent)])
        counts = dict(zip(local, tot))
        if self.cfg.ErrorFlag == 0 and (counts["error"] > 0 or tot[-2] > 0):
            raise RuntimeError(
                f"{counts['error']} errored particles / {tot[-2]} "
                f"migration overflows at ext step {ext} "
                f"(ErrorFlag=0 halts; raise migrate_capacity or set "
                f"ErrorFlag>0 to continue)")
        return counts, {"migrated": int(sent), "migration_drops": tot[-2]}

    def finish(self, p: st.Particles, timing: Counter) -> dict:
        from .kernels import ext_step as kx, rk4_step as kr, step_lanes as sl
        from .out.writer import merge_shards
        cfg, me = self.cfg, self.me
        if self.stream:
            # fold the ranks' shard files into the single-run layout
            me.barrier()
            if self.rank == 0:
                paths = [os.path.join(cfg.outpath, cfg.NCOutFile
                                      + ckpt.rank_tag(r) + ".nc")
                         for r in range(me.world)]
                merge_shards(paths, os.path.join(cfg.outpath,
                                                 cfg.NCOutFile + ".nc"))
                for path in paths:
                    os.remove(path)
            me.barrier()
        done = {"rank": self.rank, "event": "rank_done", "cap": self.spec.cap,
                "kernel_launches": {**kx.ext_step_fused.variant_launches,
                                    **kr.rk4_displacement_fused.variant_launches,
                                    **sl.step_lanes_fused.variant_launches}}
        if self.device.type == "cuda":
            done["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        if cfg.WriteModelTiming:
            done["timing"] = dict(sorted(timing.items()))
        _emit(done)
        return {"particles": p.to("cpu")}


def _drive(cfg: Config, place, resume: bool, series_paths):
    """The chunk loop of every run, on a placement (``_Whole`` or
    ``_Tile``).  Rank 0 (a single run's only one) alone writes the
    boundaries, the parfile echo, the startup line, the trace and the
    ``series_exhausted`` line.  Returns ``place.finish``'s result."""
    timing = Counter()      # WriteModelTiming: seconds a phase
    t0 = time.perf_counter()
    device, lead = place.device, place.rank == 0
    grid = load_grid(cfg, device)
    ctx = build_context(cfg, grid)
    check_supported(cfg, ctx)
    if lead and cfg.BoundaryBLNs:
        bd.dump_boundaries(
            ctx.bounds, cfg.outpath,
            to_lonlat=lambda x, y: (
                convert.x2lon(x, y, cfg.lonmin, cfg.latmin,
                              cfg.Earth_Radius, cfg.SphericalProjection),
                convert.y2lat(y, cfg.latmin, cfg.Earth_Radius,
                              cfg.SphericalProjection)))
    series = RomsSeries(cfg, paths=series_paths,
                        eta_slice=place.lay_out(grid, ctx))
    if lead and cfg.WriteParfile and cfg.parfile:
        os.makedirs(cfg.outpath, exist_ok=True)
        shutil.copyfile(cfg.parfile,
                        os.path.join(cfg.outpath, "parfile_echo.csv"))
    p, start_ext, global_rec, resumed_extra = place.start(resume)
    if resumed_extra is not None:
        pos = getattr(torch, cfg.dtype_pos)
        p = p.replace(**{k: getattr(p, k).to(pos) for k in shard.FLOATS})
        series.seek(global_rec - 3)       # re-prime the 3-record window
    p = p.to(device)                      # a tile's block comes on the CPU

    def read():
        return place.strip(series.next_record())

    # --- prime the record window (initHydro) -----------------------------
    window: List[dict] = [read() for _ in range(3)]
    if resumed_extra is None:
        global_rec += 3
        t_base = window[0]["time"]
    else:
        # global_rec already counts the re-primed records; field times
        # stay on the original run clock
        t_base = resumed_extra.get(
            "t_base", window[0]["time"] - (global_rec - 3) * cfg.dt)
    win_start = global_rec - 3
    timing["hydro_init"] += time.perf_counter() - t0

    n_fuse = max(1, cfg.ext_fuse)
    route = mode_flags(ctx, cfg)
    if lead:
        _emit({"path": route_path(route, device), "route": route,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "uniform": bool(grid.uniform),
               "curvilinear": grid.curv is not None, "numpar": place.n,
               "dtype_pos": cfg.dtype_pos, "n_fuse": n_fuse,
               "lanes": enabled_lanes(cfg), "seed": cfg.seed,
               "reader": series.reader, **place.startup})

    place.open_output()
    field_dtype = getattr(torch, cfg.dtype_field)
    n_ext, out_every = cfg.external_steps, cfg.output_every_ext
    if not resume:
        place.snapshot(0.0, p)
    prefetch = (Prefetcher(read, depth=max(2, n_fuse + 1), device=device)
                if cfg.prefetch else None)
    profiler = Profiler(device)
    if not lead:
        profiler.dir = None             # one trace, rank 0's
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
            profiler.tick(ext)
            tw = time.perf_counter()
            with span("ltjax_torch.read"):
                while global_rec - 1 < ext + E + 1 and not exhausted:
                    rec = prefetch.next() if prefetch else read()
                    if rec is None:
                        exhausted = True
                        break
                    window.append(rec)
                    global_rec += 1
                if exhausted:
                    E = min(E, global_rec - 2 - ext)
                    if E < 1:
                        if lead:
                            _emit({"event": "series_exhausted", "ext": ext})
                        break
                while win_start < ext:              # drop stale records
                    window.pop(0)
                    win_start += 1
                fsW = stack_records(window[:E + 2], t_base, field_dtype,
                                    device,
                                    with_salt_temp=cfg.needs_salt_fields())
            read_s = time.perf_counter() - tw
            timing["hydro_read"] += read_s

            # --- compute E external steps --------------------------------
            tc = time.perf_counter()
            t_ext = float(ext * cfg.dt)
            p, moved = place.step(p, fsW, t_ext, ext, E)
            local = summary_counts(p)               # waits for the device
            step_s = time.perf_counter() - tc
            timing["compute"] += step_s
            ext += E
            if debug_nans:
                check_nans(cfg, p, ext - 1)
            counts, own = place.total(local, moved, ext - 1)
            if ext % out_every == 0:
                to = time.perf_counter()
                with span("ltjax_torch.output"):
                    place.snapshot(t_ext + E * cfg.dt, p)
                timing["output"] += time.perf_counter() - to
            if cfg.checkpoint_every and ext % cfg.checkpoint_every == 0:
                with span("ltjax_torch.checkpoint"):
                    ckpt.save(os.path.join(cfg.checkpoint_dir,
                                           f"ckpt_{ext}{place.tag}.npz"),
                              p, ext, global_rec,
                              extra={"t_base": float(t_base),
                                     **place.ckpt_extra})
            _emit({**place.log_tag, "ext": ext - E, "n_fused": E,
                   "sim_t": t_ext + E * cfg.dt,
                   "steps_per_s": place.n * cfg.internal_steps * E / step_s,
                   "hydro_read_s": read_s, "compute_s": step_s,
                   "stall_s": prefetch.stall_s if prefetch else 0.0,
                   **own, **counts})
    finally:
        profiler.close()
        if prefetch:
            prefetch.close()
        place.close()
        series.close()
    return place.finish(p, timing)


def run(cfg: Config, resume: bool = False, device=None,
        series_paths: Optional[List[str]] = None,
        backend: Optional[str] = None) -> st.Particles:
    """Run the configured simulation; returns the final particles (a
    sharded run: see ``run_sharded``).  The run takes the CUDA device
    unless ``device`` names another; without one it raises rather than
    fall back to the CPU.  ``backend`` ("nccl" or "gloo") is the process
    group of a sharded run (default: NCCL on CUDA, gloo on the CPU)."""
    cfg.validate()
    device = torch.device(_device_or_cuda(device, "run(cfg, device='cpu')"))
    if cfg.mesh_particles * cfg.mesh_tiles > 1:
        return run_sharded(cfg, resume=resume, device=device,
                           series_paths=series_paths, backend=backend)
    if backend is not None:
        raise ValueError("run: backend applies to sharded runs "
                         "(mesh_particles * mesh_tiles > 1)")
    return _drive(cfg, _Whole(cfg, device), resume, series_paths)


def kernel_targets(cfg: Config, grid: Grid, tile: bool = False) -> list:
    """The (source, variant) pairs of the kernels that ``cfg`` runs on
    ``grid`` (for ``kernels.build.prebuild``; ``tile``: on the tiles of a
    sharded run): K1 on the ext_step route, K2 and the lanes kernel K3 on
    the per-step route, the Hilbert sort's key on every route, and the
    migration's kernels on the tiles of more than one strip."""
    from .kernels import ext_step as kx, rk4_step as kr
    from .physics.boundary import _cell_edges
    from .grid import _is_uniform
    route = mode_flags(None, cfg)
    key = [("sort_key", None)]
    if tile and cfg.mesh_tiles > 1:
        key.append(("migrate", None))
    if route in ("native", "packed"):
        return key
    dtype = getattr(torch, cfg.dtype_pos)
    curv = grid.curv is not None
    edges_uniform = all(_is_uniform(_cell_edges(a.cpu().numpy()), 1e-4)
                        for a in (grid.x_rho, grid.y_rho))
    lanes = kx.kernel_variant(
        cfg, curv=curv, pos64=dtype == torch.float64,
        axes=not curv and not (grid.uniform and edges_uniform), tile=tile)
    if route == "ext_step":
        return [("ext_step", lanes)] + key
    v = kr.kernel_variant(grid, dtype)
    if tile:
        v["LTX_TILE"] = 1
    del lanes["LTX_MORTALITY"]        # K3 always draws DEATH
    return [("rk4_step", v or None), ("step_lanes", lanes)] + key


def run_sharded(cfg: Config, resume: bool = False, device=None,
                series_paths: Optional[List[str]] = None,
                backend: Optional[str] = None) -> st.Particles:
    """A sharded run (counterpart of ``ltjax.run.run_sharded``):
    ``mesh_particles * mesh_tiles`` ranks, one process each.

    Under a launcher that sets RANK and WORLD_SIZE (``torchrun``; both or
    neither, WORLD_SIZE equal to the mesh), this process runs its rank and
    returns its slot block (EMPTY slots included).  Otherwise the run
    builds the kernels and the reader once, spawns the ranks on a free
    localhost port, and returns the particles of every rank in pid order
    on ``device``: the CUDA device unless ``device`` names another
    (without one it raises rather than fall back to the CPU, as ``run``).
    ``backend``: "nccl" (CUDA, one card per rank; the default there) or
    "gloo" (the CPU's; on CUDA several ranks may share a card)."""
    from . import native
    from .kernels import build
    device = torch.device(_device_or_cuda(device, "run_sharded(cfg, "
                                          "device='cpu')"))
    world = cfg.mesh_particles * cfg.mesh_tiles
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"sharded run: backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("sharded run: NCCL needs CUDA devices; the CPU "
                         "takes gloo")
    env = dist.launch_env()
    if env is not None:
        rank, w, local = env
        if w != world:
            raise RuntimeError(
                f"sharded run: WORLD_SIZE={w}, but mesh_particles * "
                f"mesh_tiles = {cfg.mesh_particles} * {cfg.mesh_tiles} = "
                f"{world}")
        return _rank_run(rank, w, "env://", cfg, resume, str(device),
                         series_paths, backend, local)["particles"]
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if backend == "nccl" and count < world:
            raise RuntimeError(f"sharded run: NCCL takes one card per rank: "
                               f"{world} ranks, {count} cards")
    native.get_lib()              # built once here, not once per rank
    grid = load_grid(cfg, "cpu")
    check_supported(cfg, StepContext(grid=grid, bounds=None))
    if device.type == "cuda":
        # one nvcc per kernel, not one per rank; rectilinear grids are tiled
        build.prebuild(kernel_targets(cfg, grid, tile=grid.curv is None))
    results = dist.launch(_rank_run, world,
                          (cfg, resume, str(device), series_paths, backend))
    return shard.gather_particles(
        [r["particles"] for r in results]).to(device)


def _rank_run(rank: int, world: int, init_method: str, cfg: Config,
              resume: bool, device: str, series_paths, backend: str,
              local_rank: Optional[int] = None) -> dict:
    """One rank of a sharded run: join the process group and run the
    chunk loop on this rank's tile (``_Tile``).  Returns {"particles":
    its final slot block on the CPU}."""
    dev = dist.rank_device(device, backend,
                           rank if local_rank is None else local_rank, world)
    me = dist.init(rank, world, cfg.mesh_particles, cfg.mesh_tiles, backend,
                   dev, init_method)
    return _drive(cfg, _Tile(cfg, me, dev, backend), resume, series_paths)


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
