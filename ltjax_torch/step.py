"""The time-stepping core (counterpart of ``ltjax.step``).

Per internal step each particle is released at its date of birth,
advected by RK4 through ``find_currents``, kicked by horizontal and
vertical turbulence and by its behavior, reflected at coastlines /
exited through open boundaries, reflected at the surface and bottom, its
status updated (mortality, then settlement on habitat polygons), and
salt and temperature sampled at its new position (reference
``run_Internal_Timestep``/``update_particles``).

An external step takes one of four routes (``mode_flags``, as ltjax's):

* ``"ext_step"``: ``cfg.internal_steps`` internal steps in one launch of
  the whole-external-step CUDA kernel on CUDA tensors
  (``kernels.ext_step.ext_step_fused``), or its plain version on CPU
  tensors (collapsed scheme: time first, then one fit);
* ``"per_step"`` (stochastic mortality, whose DEATH draw the
  whole-step kernel does not make): ``cfg.internal_steps`` calls of
  ``internal_step(mode="kernel")``, each taking its RK4 displacement
  from the per-internal-step CUDA kernel K2
  (``kernels.rk4_step.rk4_displacement_fused``) and every lane after it
  (release, turbulence, behavior, the DEATH draw, reflection, settlement,
  salt) from the lanes kernel K3 (``kernels.step_lanes.step_lanes_fused``),
  each on CPU tensors its plain version;
* ``"native"`` (``fast_interp = False``, or adaptive tension
  ``tension_sigma < 0``; it takes precedence over the others):
  ``cfg.internal_steps`` calls of ``internal_step(mode="native")``, the
  reference's interpolation order (``physics.advect``: per record fit,
  then time) as PyTorch ops on the positions' device, no kernel;
* ``"packed"`` (``kernel_interp = False``; before ``"per_step"``, so
  stochastic mortality takes it too): ``cfg.internal_steps`` calls of
  ``internal_step(mode="packed")``, ltjax's packed scheme (per stage a
  tension fit per grid column, evaluated on each corner's own knots,
  then blended: ``packed.stage_tables``, ``find_currents_packed``) as
  PyTorch ops, no kernel.  ltjax takes this route wherever its kernel
  does not run (off the TPU, f64 positions, stretched axes); the port
  has kernel builds for those, so there ``kernel_interp = True`` keeps
  the kernels and the collapsed scheme.

Random draws are keyed by (seed, step index, substream, particle id)
(``ltjax_torch.rng``); the step index of internal step i of external
step e is ``e * internal_steps + i``, as in ltjax.

Every route Hilbert-sorts the batch on its cells, optionally banded by
height above the seabed (``cfg.sort_depth_bands``, ``_sort_band``); the
order changes no particle's result, only which particles share a block
of the kernels' threads.  ``check_supported`` raises
``NotImplementedError`` for domain tiles on a curvilinear grid (not
silently dropped) and ``ValueError`` for more than 6 depth bands.  Every
grid (uniform or stretched rectilinear, curvilinear) and both position
dtypes run on both devices, on every route; sharded runs
(``ltjax_torch.shard``) take the same routes per tile (``route_step``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from . import packed as pk
from . import spatial as sp
from . import state as st
from .fields import FieldSet
from .grid import Grid, locate, locate_y, logical_coords
from .kernels import ext_step as kx
from .kernels import rk4_step as kr
from .kernels import step_lanes as sl
from .physics import behavior as bh
from .physics import boundary as bd
from .physics import settlement as stl
from .physics import turb as tb
from .physics.advect import (AdvectParams, find_currents, host_time,
                             rk4_displacement, zeta_h_at)


@dataclass
class StepContext:
    """Static per-run data of the stepper (plus derived kernel tables).
    On a tile of a sharded run (``shard.tile_context``) ``grid`` is the
    tile's strip (``grid.tile`` says where it lies in the whole grid),
    while ``bounds`` and the polygons stay those of the whole grid."""
    grid: Grid
    bounds: bd.Boundaries
    polys: Optional[stl.Polygons] = None   # habitat polygons (settlement)
    holes: Optional[stl.Polygons] = None   # hole polygons
    cache: dict = field(default_factory=dict)


def summary_counts(p: st.Particles) -> dict:
    """Per-status particle counts (one host sync for all six), each status
    counted by equality as ltjax counts it: the EMPTY slots of a sharded
    run's buffers (status -1) count as nothing."""
    c = torch.bincount((p.status.long() + 1).clamp(min=0),
                       minlength=st.ERROR + 2).tolist()
    return {"not_released": c[st.NOT_RELEASED + 1],
            "active": c[st.ACTIVE + 1], "settled": c[st.SETTLED + 1],
            "dead": c[st.DEAD + 1],
            "out_of_domain": c[st.OUT_OF_DOMAIN + 1],
            "error": c[st.ERROR + 1]}


def mode_flags(ctx: StepContext, cfg) -> str:
    """The route of a configuration's external steps (counterpart of
    ltjax.step.mode_flags): "native" for the reference's interpolation
    order (fast_interp off) or adaptive tension, which varies per
    interval and particle; "packed" for ltjax's packed scheme
    (kernel_interp off); "per_step" for stochastic mortality, whose
    DEATH draw is not in the whole-step kernel's key layout; else
    "ext_step"."""
    if not cfg.fast_interp or cfg.tension_sigma < 0:
        return "native"
    if not cfg.kernel_interp:
        return "packed"
    if cfg.mortality and cfg.stochastic_mortality:
        return "per_step"
    return "ext_step"


def check_supported(cfg, ctx: StepContext) -> None:
    """Raise ValueError for more than 6 depth bands of the sort (ltjax's
    message: the banded key's room), and NotImplementedError for domain
    tiles on a curvilinear grid (ltjax's message: eta strips assume
    rectilinear rows)."""
    if cfg.sort_depth_bands > 6:
        raise ValueError(f"sort_depth_bands = {cfg.sort_depth_bands}: "
                         "n_bands must be in [1, 6] (int32 key room)")
    if ctx.grid.curv is not None and cfg.mesh_tiles > 1:
        raise NotImplementedError(
            "curvilinear grids shard over the PARTICLE axis only "
            "(mesh_particles = N, mesh_tiles = 1): eta-strip domain "
            "tiles assume rectilinear row slicing.  Particle data "
            "parallelism covers the multi-chip scaling need — "
            "particles are independent given the (replicated) fields.")


def make_params(cfg):
    """The turbulence and behavior parameters of a configuration."""
    turb = tb.TurbParams(ConstantHTurb=cfg.ConstantHTurb,
                         ConstantVTurb=cfg.ConstantVTurb,
                         use_aks=cfg.readAks, sigma=cfg.tension_sigma,
                         idt=float(cfg.idt))
    beh = bh.BehaveParams(
        behavior=cfg.Behavior, mortality=cfg.mortality, deadage=cfg.deadage,
        pediage=cfg.pediage, swimstart=cfg.swimstart, swimslow=cfg.swimslow,
        swimfast=cfg.swimfast, Sgradient=cfg.Sgradient, sink=cfg.sink,
        Hswimspeed=cfg.Hswimspeed, Swimdepth=cfg.Swimdepth,
        twistart=cfg.twistart, twiend=cfg.twiend, Em=cfg.Em, Kp=cfg.Kp,
        thresh=cfg.thresh, idt=float(cfg.idt), sigma=cfg.tension_sigma,
        stochastic=cfg.stochastic_mortality)
    return turb, beh


def internal_step(ctx: StepContext, cfg, seed, p: st.Particles,
                  fields: FieldSet, t: float, step_idx: int,
                  prec: Optional[pk.PackedRecords] = None,
                  mode: str = "collapsed") -> st.Particles:
    """One internal timestep for the whole batch.  ``fields`` is the
    3-record window (vertical turbulence reads its Aks), ``prec`` its
    packed records; ``step_idx`` keys the random draws.  Settlement tests
    the reflected position against ``ctx.polys``/``ctx.holes``; SaltTempOn
    samples ``fields.salt``/``.temp`` at the new position at t + idt for
    every particle active at the step's start.

    ``mode``: "collapsed" computes the RK4 displacement (and behavior 7's
    stage-1 currents) in PyTorch on the collapsed scheme (the plain
    version of the CUDA kernels' per-thread step); "kernel" takes both
    from ``kernels.rk4_step.rk4_displacement_fused`` and the lanes after
    them from ``kernels.step_lanes.step_lanes_fused`` (the CUDA kernels K2
    and K3 on CUDA tensors, the same PyTorch code on CPU tensors), each
    reading the step's time-collapsed tables: K2 the three stage value
    tables, K3 zeta and h from those at t and t + idt and the Aks, salt
    and temp lanes from the step's aux tables, ``prec``'s lanes collapsed
    to t and t + idt once a step (``step_lanes.aux_tables``; without those
    lanes in ``prec`` the plain version reads ``fields``); the other
    modes run the lanes as PyTorch ops (``step_lanes.lanes``);
    "native" takes
    advection, the free surface and behavior 7's currents from
    ``physics.advect`` straight off ``fields`` (the reference's order,
    ltjax's ``prec=None``; ``prec`` is not read); "packed" takes them
    from the packed scheme's stage tables (``pk.stage_tables``:
    per-column fits, eval-then-blend), ltjax's ``mode="packed"``."""
    if mode not in ("collapsed", "kernel", "native", "packed"):
        raise ValueError(f"internal_step: mode {mode!r}")
    native = mode == "native"
    grid = ctx.grid
    dtype = p.x.dtype
    idt = float(cfg.idt)
    # t in the particles' dtype, on the host (polintd's weights are host
    # scalars)
    t0_h = host_time(t, dtype)
    if native:
        adv = AdvectParams(sigma=cfg.tension_sigma, z0=cfg.z0, idt=idt)
    elif mode == "packed":
        tabs = pk.stage_tables(grid, prec, t, idt, cfg.tension_sigma)
    else:
        tabs = pk.stage_value_tables(grid, prec, t, idt)

    # --- advection, then the lanes ---------------------------------------
    if mode == "kernel":
        disp = kr.rk4_displacement_fused(
            grid, tabs, p.x, p.y, p.z, cfg.tension_sigma, cfg.z0, idt,
            stage1=cfg.Behavior == 7)
        return sl.step_lanes_fused(ctx, cfg, seed, step_idx, p, fields, tabs,
                                   sl.aux_tables(grid, cfg, prec, t, idt), t,
                                   disp)
    if native:
        dx, dy, dz = rk4_displacement(grid, fields, p.x, p.y, p.z, t0_h,
                                      adv)
        t1_h = float(torch.tensor(t, dtype=dtype) + idt)

        def column(x, y, end):
            return zeta_h_at(grid, fields, x, y, t1_h if end else t0_h)

        def currents():
            return find_currents(grid, fields, p.x, p.y, p.z, t0_h, adv)[:2]
    else:
        if mode == "packed":
            dx, dy, dz = pk.rk4_displacement_packed(
                grid, tabs, p.x, p.y, p.z, cfg.tension_sigma, cfg.z0, idt)
            fc = pk.find_currents_packed
        else:
            dx, dy, dz = pk.rk4_displacement_collapsed(
                grid, tabs, p.x, p.y, p.z, cfg.tension_sigma, cfg.z0, idt)
            fc = pk.find_currents_collapsed

        def column(x, y, end):
            return pk.zeta_h_packed(grid, tabs[2 if end else 0], x, y)

        def currents():
            return fc(grid, tabs[0], p.x, p.y, p.z, cfg.tension_sigma,
                      cfg.z0)[:2]
    return sl.lanes(ctx, cfg, seed, step_idx, p, fields, t, dx, dy, dz,
                    column, currents)


def _sort_band(cfg, grid: Grid, p: st.Particles, ci, cj):
    """Depth-band ids of the Hilbert sort (ltjax.step._sort_band), or None
    when banding is off: ``cfg.sort_band_height``-metre slabs of height
    above the seabed at the particle's rho cell (ci, cj), or with
    ``cfg.sort_band_log`` log2 bands with boundaries at sort_band_height
    * 2^k.  On a tile's strip, cj is a strip row and ``grid.h`` the
    strip's."""
    if cfg.sort_depth_bands <= 1:
        return None
    hab = p.z + grid.h[cj.long(), ci.long()]      # height above bottom [m]
    if cfg.sort_band_log:
        return torch.floor(torch.log2(hab.clamp(min=1e-3)
                                      / cfg.sort_band_height)
                           ).to(torch.int32) + 1
    return torch.floor(hab / cfg.sort_band_height).to(torch.int32)


def _sort_cells(grid: Grid, p: st.Particles):
    """The rho cells (ci, cj) the sort keys on: per-axis ``locate`` (on a
    tile's strip, strip rows), or on a curvilinear grid the logical cells
    floor(ti), floor(tj)."""
    if grid.curv is not None:
        ti, tj = logical_coords(grid, p.x, p.y)
        ci = torch.floor(ti).clamp(0, grid.nx - 1).to(torch.int32)
        cj = torch.floor(tj).clamp(0, grid.ny - 1).to(torch.int32)
        return ci, cj
    ci, _ = locate(grid.x_rho, p.x, grid.uniform)
    cj, _ = locate_y(grid, p.y)
    return ci, cj


def _sort(grid: Grid, p: st.Particles, cfg=None):
    """Hilbert-sort the batch on its rho cells (``_sort_cells``), banded
    by ``cfg``'s depth bands when it has them."""
    ci, cj = _sort_cells(grid, p)
    band = None if cfg is None else _sort_band(cfg, grid, p, ci, cj)
    if band is None:
        return sp.sort_by_cell(p, ci, cj)
    return sp.sort_by_cell(p, ci, cj, depth_band=band,
                           n_bands=cfg.sort_depth_bands)


def fieldset_slice(fs: FieldSet, e: int, r: int = 3) -> FieldSet:
    """Records [e, e + r) of a record window."""
    return FieldSet(*(getattr(fs, k)[e:e + r] for k in
                      ("zeta", "u", "v", "w", "aks", "salt", "temp",
                       "times")))


def per_step_external(ctx: StepContext, cfg, p: st.Particles,
                      prec: Optional[pk.PackedRecords], t0: float,
                      fields: FieldSet, ext_idx: int, seed=None,
                      mode: str = "kernel") -> st.Particles:
    """One external step of ``cfg.internal_steps`` calls of
    ``internal_step(mode=mode)`` ("kernel": the per-step route; "native":
    the native route, which reads no ``prec``), internal step i with step
    index ext_idx * internal_steps + i (ltjax's per-step scan).  "packed"
    is the packed route."""
    seed = cfg.seed if seed is None else seed
    idt = float(cfg.idt)
    n_int = cfg.internal_steps
    for i in range(n_int):
        p = internal_step(ctx, cfg, seed, p, fields, t0 + i * idt,
                          int(ext_idx) * n_int + i, prec, mode=mode)
    return p


def packed_window(ctx: StepContext, cfg, route: str, fsR: FieldSet):
    """The packed records of a record window for ``route`` (None on the
    native route, which reads the FieldSet): the whole-step kernel K1 and
    the per-step route's lanes kernel K3 read the Aks and salt/temp lanes
    of the record table where their variant does; the PyTorch lanes of
    the packed route read the FieldSet, so its tables carry only the
    value lanes."""
    if route == "native":
        return None
    ext = route in ("ext_step", "per_step")
    return pk.build_packed_records(
        ctx.grid, fsR, with_aks=bool(cfg.VTurbOn and cfg.readAks) and ext,
        with_scalars=cfg.needs_salt_fields() and ext)


def route_step(ctx: StepContext, cfg, route: str, p: st.Particles,
               prec_all: Optional[pk.PackedRecords], fsR: FieldSet, e: int,
               t0: float, ext_idx0: int) -> st.Particles:
    """External step e of a record window on ``route``: records [e, e+1,
    e+2], start time t0 + e * dt, index ext_idx0 + e; one whole-step
    kernel launch or ``per_step_external`` (mode "kernel" on the per-step
    route, else the route's own)."""
    t_e, f3, ext = (float(t0) + e * float(cfg.dt), fieldset_slice(fsR, e),
                    int(ext_idx0) + e)
    prec3 = None if prec_all is None else pk.PackedRecords(
        tab=prec_all.tab[e:e + 3], times=prec_all.times[e:e + 3])
    if route == "ext_step":
        return kx.ext_step_fused(ctx, cfg, p, prec3, t_e, fields=f3,
                                 ext_idx=ext)
    return per_step_external(ctx, cfg, p, prec3, t_e, f3, ext,
                             mode="kernel" if route == "per_step" else route)


def make_fused_external_steps(ctx: StepContext, cfg, n_fuse: int):
    """``n_fuse`` consecutive external steps over an (n_fuse + 2)-record
    field window: external step e uses records [e, e+1, e+2], the same
    values as n_fuse calls on the rotating triple buffer (reference
    ``updateHydro``).  The batch is Hilbert-sorted every
    ``cfg.ext_sort_every`` external steps (banded by
    ``cfg.sort_depth_bands``) and returned in storage order (on every
    route: the native route's internal steps measured faster
    on a sorted batch, by more than the sort costs; PERF.md).  ``cfg.seed``
    keys the random streams.  Each external step takes the route of
    ``mode_flags`` (``route_step``): one whole-step kernel launch, or
    ``per_step_external`` (the per-step and packed routes; the native
    route, which builds no packed records).

    Returns ``fused(p, fsR, t0, ext_idx0) -> p'``; external step e of the
    call has index ext_idx0 + e."""
    check_supported(cfg, ctx)
    grid = ctx.grid
    se = max(1, cfg.ext_sort_every)
    route = mode_flags(ctx, cfg)

    def fused(p: st.Particles, fsR: FieldSet, t0: float,
              ext_idx0: int = 0) -> st.Particles:
        if fsR.times.shape[0] != n_fuse + 2:
            raise ValueError(f"fused step needs {n_fuse + 2} records, got "
                             f"{fsR.times.shape[0]}")
        prec_all = packed_window(ctx, cfg, route, fsR)
        cum = torch.arange(p.n, device=p.x.device)
        for e in range(n_fuse):
            if e % se == 0:
                p, perm = _sort(grid, p, cfg)
                cum = cum[perm]
            p = route_step(ctx, cfg, route, p, prec_all, fsR, e, t0,
                           ext_idx0)
        return sp.unsort(p, cum)

    return fused


def make_external_step(ctx: StepContext, cfg):
    """One external step over the classic 3-record triple buffer:
    ``ext_step(p, fields, t0, ext_idx) -> p'``."""
    return make_fused_external_steps(ctx, cfg, 1)
