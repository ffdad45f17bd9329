"""The time-stepping core (counterpart of ``ltjax.step``), advection only.

Per internal step each particle is released at its date of birth,
advected by RK4 through ``find_currents`` (collapsed scheme), reflected
at coastlines / exited through open boundaries, reflected at the
surface and bottom, and its status updated (reference
``run_Internal_Timestep``/``update_particles``).  An external step runs
``cfg.internal_steps`` of them through the CUDA kernel on CUDA tensors
(``kernels.ext_step.ext_step_fused``) or its plain version on CPU
tensors.

``check_supported`` raises ``NotImplementedError`` for every option
outside this slice (turbulence, behaviors, mortality, settlement, salt,
curvilinear grids, sharding, checkpoints): they are not silently
dropped.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import packed as pk
from . import spatial as sp
from . import state as st
from .fields import FieldSet
from .grid import Grid, locate
from .kernels import ext_step as kx
from .physics import boundary as bd


@dataclass
class StepContext:
    """Static per-run data of the stepper (plus derived kernel tables)."""
    grid: Grid
    bounds: bd.Boundaries
    cache: dict = field(default_factory=dict)


def summary_counts(p: st.Particles) -> dict:
    """Per-status particle counts (one host sync for all six)."""
    c = torch.bincount(p.status.long().clamp(0, st.ERROR),
                       minlength=6).tolist()
    return {"not_released": c[st.NOT_RELEASED], "active": c[st.ACTIVE],
            "settled": c[st.SETTLED], "dead": c[st.DEAD],
            "out_of_domain": c[st.OUT_OF_DOMAIN], "error": c[st.ERROR]}


def check_supported(cfg, ctx: StepContext, resume: bool = False) -> None:
    """Raise NotImplementedError naming the first option outside the
    ported slice (stands in for ltjax.step.mode_flags)."""
    unsupported = [
        ("HTurbOn", cfg.HTurbOn), ("VTurbOn", cfg.VTurbOn),
        ("Behavior", cfg.Behavior != 0), ("mortality", cfg.mortality),
        ("settlementon", cfg.settlementon),
        ("SaltTempOn", cfg.SaltTempOn),
        ("tension_sigma", cfg.tension_sigma < 0),
        ("mesh_particles*mesh_tiles",
         cfg.mesh_particles * cfg.mesh_tiles > 1),
        ("checkpoint_every", bool(cfg.checkpoint_every)),
        ("--resume", resume),
        ("sort_depth_bands", cfg.sort_depth_bands > 1),
    ]
    if ctx.grid.device.type == "cuda":
        unsupported += [
            ("non-uniform grid on CUDA",
             not (ctx.grid.uniform and ctx.bounds.uniform)),
            ("dtype_pos other than float32 on CUDA",
             cfg.dtype_pos != "float32"),
        ]
    for name, bad in unsupported:
        if bad:
            raise NotImplementedError(f"{name}: not ported to ltjax_torch yet")


def internal_step(ctx: StepContext, cfg, p: st.Particles,
                  prec: pk.PackedRecords, t: float) -> st.Particles:
    """One internal timestep for the whole batch, collapsed scheme (the
    plain version of the CUDA kernel's per-thread step)."""
    grid, bounds = ctx.grid, ctx.bounds
    dtype = p.x.dtype
    idt = float(cfg.idt)
    tt = torch.tensor(t, dtype=dtype, device=p.x.device)
    tabs = pk.stage_value_tables(grid, prec, t, idt)

    # --- release (DOB reached) & masks ---------------------------------
    release = (p.status == st.NOT_RELEASED) & (tt >= p.dob)
    status = torch.where(release, torch.full_like(p.status, st.ACTIVE),
                         p.status)
    active = status == st.ACTIVE

    # --- advection ------------------------------------------------------
    dx, dy, dz = pk.rk4_displacement_collapsed(
        grid, tabs, p.x, p.y, p.z, cfg.tension_sigma, cfg.z0, idt)

    # --- horizontal boundary reflection ---------------------------------
    xr, yr, hits, exited, stuck = bd.reflect(
        bounds, p.x, p.y, p.x + dx, p.y + dy,
        open_exits=cfg.OpenOceanBoundary, n_iter=cfg.reflect_iters)

    # --- vertical reflection at the new column (t + idt) ----------------
    zeta1, h1 = pk.zeta_h_packed(grid, tabs[2], xr, yr)
    zr, _, hit_bot = bd.reflect_vertical(p.z + dz, zeta1, h1)

    # --- apply updates under the active mask -----------------------------
    new_status = torch.where(active & exited,
                             torch.full_like(status, st.OUT_OF_DOMAIN),
                             status)
    new_status = torch.where(active & stuck,
                             torch.full_like(status, st.ERROR), new_status)
    out = p.replace(
        x=torch.where(active, xr, p.x), y=torch.where(active, yr, p.y),
        z=torch.where(active, zr, p.z),
        age=torch.where(status >= st.ACTIVE, tt + idt - p.dob, p.age),
        status=new_status)
    if cfg.TrackCollisions:
        out = out.replace(
            hit_land=p.hit_land + torch.where(active, hits, 0).to(
                torch.int32),
            hit_bottom=p.hit_bottom + (active & hit_bot).to(torch.int32))
    return out


def _sort(grid: Grid, p: st.Particles):
    ci, _ = locate(grid.x_rho, p.x, grid.uniform)
    cj, _ = locate(grid.y_rho, p.y, grid.uniform)
    return sp.sort_by_cell(p, ci, cj)


def make_fused_external_steps(ctx: StepContext, cfg, n_fuse: int):
    """``n_fuse`` consecutive external steps over an (n_fuse + 2)-record
    field window: external step e uses records [e, e+1, e+2], the same
    values as n_fuse calls on the rotating triple buffer (reference
    ``updateHydro``).  The batch is Hilbert-sorted every
    ``cfg.ext_sort_every`` external steps and returned in storage order.

    Returns ``fused(p, fsR, t0, ext_idx0) -> p'``."""
    check_supported(cfg, ctx)
    grid = ctx.grid
    dt = float(cfg.dt)
    se = max(1, cfg.ext_sort_every)

    def fused(p: st.Particles, fsR: FieldSet, t0: float,
              ext_idx0: int = 0) -> st.Particles:
        if fsR.times.shape[0] != n_fuse + 2:
            raise ValueError(f"fused step needs {n_fuse + 2} records, got "
                             f"{fsR.times.shape[0]}")
        prec_all = pk.build_packed_records(grid, fsR)
        cum = torch.arange(p.n, device=p.x.device)
        for e in range(n_fuse):
            if e % se == 0:
                p, perm = _sort(grid, p)
                cum = cum[perm]
            prec3 = pk.PackedRecords(tab=prec_all.tab[e:e + 3],
                                     times=prec_all.times[e:e + 3])
            p = kx.ext_step_fused(ctx, cfg, p, prec3, float(t0) + e * dt)
        return sp.unsort(p, cum)

    return fused


def make_external_step(ctx: StepContext, cfg):
    """One external step over the classic 3-record triple buffer:
    ``ext_step(p, fields, t0, ext_idx) -> p'``."""
    return make_fused_external_steps(ctx, cfg, 1)
