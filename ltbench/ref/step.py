"""The plain reference's time stepping: a frozen copy of the port's plain
version of one internal step (``ltjax_torch.step.internal_step`` in its
"collapsed" mode and ``ltjax_torch.kernels.step_lanes.lanes`` reading the
record window), as the CPU tests hold the CUDA kernels against it.

Per internal step each particle is released at its date of birth,
advected by RK4 through the collapsed scheme's ``find_currents`` (time
collapse of the three records, bilinear blend, tension-spline fit of u,
v and w, bottom log layer), kicked by horizontal and vertical turbulence
and by its behavior, reflected at coastlines or exited through open
boundaries, reflected at the surface and bottom, its status updated
(mortality, then settlement on habitat polygons), and salt and
temperature sampled at its new position (LTRANS v2b's
``run_Internal_Timestep``/``update_particles``).  Random draws are keyed
by (seed, step index, substream, particle id), the step index of
internal step i of external step e being ``e * internal_steps + i``.
"""

from __future__ import annotations

import torch

from . import packed as pk
from . import state as st
from .fields import FieldSet
from .physics import behavior as bh
from .physics import boundary as bd
from .physics import settlement as stl
from .physics import turb as tb
from .physics.advect import sample_scalar
from .scoord import s_depths


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


def internal_step(ctx, cfg, seed, p: st.Particles, fields: FieldSet,
                  t: float, step_idx: int, prec: pk.PackedRecords,
                  clear: torch.Tensor = None):
    """One internal timestep for the whole batch from time t.  ``fields``
    is the 3-record window, ``prec`` its packed records; ``ctx`` has
    ``grid``, ``bounds``, ``polys`` and ``holes``.  Returns the new
    particles and ``clear`` less the particles that end the step active
    at or below the lowest rho level of their column, in the bottom log
    layer (where a velocity's sensitivity to depth amplifies round-off
    without bound)."""
    grid, bounds = ctx.grid, ctx.bounds
    turb, beh = make_params(cfg)
    dtype = p.x.dtype
    dev = p.x.device
    idt = float(cfg.idt)
    tabs = pk.stage_value_tables(grid, prec, t, idt)
    dx, dy, dz = pk.rk4_displacement_collapsed(
        grid, tabs, p.x, p.y, p.z, cfg.tension_sigma, cfg.z0, idt)

    def column(x, y, end):
        return pk.zeta_h_packed(grid, tabs[2 if end else 0], x, y)

    idt_t = torch.full((), idt, dtype=dtype, device=dev)
    tt = torch.full((), t, dtype=dtype, device=dev)
    t1_h = float(torch.tensor(t, dtype=dtype) + idt)

    # --- release (DOB reached) & masks ---------------------------------
    release = (p.status == st.NOT_RELEASED) & (tt >= p.dob)
    status = torch.where(release, torch.full_like(p.status, st.ACTIVE),
                         p.status)
    active = status == st.ACTIVE

    # --- turbulence -----------------------------------------------------
    if cfg.HTurbOn:
        hx, hy = tb.hturb(seed, step_idx, p.pid, idt_t, cfg.ConstantHTurb,
                          dtype)
        dx = dx + hx
        dy = dy + hy
    if cfg.VTurbOn:
        dz = dz + tb.vturb(grid, fields, seed, step_idx, p.pid, p.x, p.y,
                           p.z, t, turb)

    # --- behavior (free surface, depth and currents at stage 1) ----------
    dies = torch.zeros_like(active)
    if cfg.Behavior != 0 or cfg.mortality:
        zeta_p, h_p = column(p.x, p.y, False)
        cur = (pk.find_currents_collapsed(grid, tabs[0], p.x, p.y, p.z,
                                          cfg.tension_sigma, cfg.z0)[:2]
               if cfg.Behavior == 7
               else (torch.zeros_like(p.x), torch.zeros_like(p.x)))
        bx, by, bz, dies = bh.behave(grid, fields, seed, step_idx, p.pid,
                                     p.x, p.y, p.z, tt, p.age, zeta_p, h_p,
                                     cur, beh)
        dx = dx + bx
        dy = dy + by
        dz = dz + bz

    # --- horizontal boundary reflection ---------------------------------
    xr, yr, hits, exited, stuck = bd.reflect(
        bounds, p.x, p.y, p.x + dx, p.y + dy,
        open_exits=cfg.OpenOceanBoundary, n_iter=cfg.reflect_iters)

    # --- vertical reflection at the new column (t + idt) ----------------
    zeta1, h1 = column(xr, yr, True)
    zr, _, hit_bot = bd.reflect_vertical(p.z + dz, zeta1, h1)
    if clear is not None:
        z_r0 = s_depths(zeta1, h1, grid.s_rho[:1].to(dtype),
                        grid.Cs_r[:1].to(dtype), grid.hc, grid.vtransform)
        clear = clear & ~(active & (zr <= z_r0[..., 0]))

    # --- settlement (habitat polygons at the reflected position) ---------
    settles = torch.zeros_like(active)
    spid = torch.full_like(p.settle_poly, -1)
    if cfg.settlementon and ctx.polys is not None:
        eligible = active & ((p.age + idt) >= cfg.pediage) & ~exited & ~stuck
        settles, spid = stl.test_settlement(
            ctx.polys, ctx.holes, bounds.x_edges, bounds.y_edges, xr, yr,
            eligible, uniform=bounds.uniform)

    # --- apply updates under the active mask -----------------------------
    # DEAD overrides a same-step ERROR but not an exit
    new_status = torch.where(active & exited,
                             torch.full_like(status, st.OUT_OF_DOMAIN),
                             status)
    new_status = torch.where(active & stuck,
                             torch.full_like(status, st.ERROR), new_status)
    if cfg.mortality:
        new_status = torch.where(active & dies & ~exited,
                                 torch.full_like(status, st.DEAD),
                                 new_status)
    if cfg.settlementon:
        new_status = torch.where(active & settles & (new_status == st.ACTIVE),
                                 torch.full_like(status, st.SETTLED),
                                 new_status)
    new_x = torch.where(active, xr, p.x)
    new_y = torch.where(active, yr, p.y)
    new_z = torch.where(active, zr, p.z)
    out = p.replace(
        x=new_x, y=new_y, z=new_z,
        age=torch.where(status >= st.ACTIVE, tt + idt - p.dob, p.age),
        status=new_status,
        settle_poly=torch.where((new_status == st.SETTLED)
                                & (p.settle_poly < 0), spid, p.settle_poly))
    if cfg.SaltTempOn:
        out = out.replace(**{
            k: torch.where(active, sample_scalar(
                grid, fields, getattr(fields, k), new_x, new_y, new_z,
                t1_h, cfg.tension_sigma), getattr(p, k))
            for k in ("salt", "temp")})
    if cfg.TrackCollisions:
        out = out.replace(
            hit_land=p.hit_land + torch.where(active, hits, 0).to(
                torch.int32),
            hit_bottom=p.hit_bottom + (active & hit_bot).to(torch.int32))
    return out, clear


def external_steps(ctx, cfg, p: st.Particles, fsR: FieldSet, t0: float,
                   ext_idx0: int, n_ext: int):
    """``n_ext`` external steps over an (n_ext + 2)-record window:
    external step e reads records [e, e+1, e+2], starts at t0 + e * dt and
    has index ext_idx0 + e.  Returns the particles and whether each kept
    clear of the bottom log layer at every internal step's end."""
    n_int, idt, dt = cfg.internal_steps, float(cfg.idt), float(cfg.dt)
    clear = torch.ones_like(p.status, dtype=torch.bool)
    for e in range(n_ext):
        f3 = FieldSet(*(getattr(fsR, k)[e:e + 3] for k in
                        ("zeta", "u", "v", "w", "aks", "salt", "temp",
                         "times")))
        prec = pk.build_packed_records(ctx.grid, f3)
        t_e = float(t0) + e * dt
        for i in range(n_int):
            p, clear = internal_step(ctx, cfg, cfg.seed, p, f3,
                                     t_e + i * idt,
                                     (int(ext_idx0) + e) * n_int + i, prec,
                                     clear)
    return p, clear
