"""One internal step's lanes: CUDA kernel wrapper (K3) + plain version.

The per-step route (``step.internal_step(mode="kernel")``, which
stochastic mortality takes) runs each internal step as two launches: the
RK4 displacement (K2, ``kernels.rk4_step``) and then, here, every lane
after it.  ``step_lanes_fused`` applies them to the whole batch:

* on CPU tensors it returns the plain version, ``lanes``: release, the
  horizontal random walk, Visser vertical turbulence, behavior with the
  mortality draw, horizontal reflection with exits, vertical reflection,
  settlement, the status updates and salt/temperature sampling as
  PyTorch ops (the code every route's ``internal_step`` runs);
* on CUDA tensors it launches ``csrc/step_lanes.cu`` (one thread per
  particle; lanes.cuh's ``step_lanes``, the lanes of the whole-step
  kernel's internal-step loop, plus the DEATH draw) in the variant of the
  configuration, grid and positions' dtype (``kernel_variant``) and
  counts the launch in ``step_lanes_fused.launches`` and, per variant, in
  ``.variant_launches``; a failed build or launch raises.

The kernel reads what the whole-step kernel reads for one internal step
(``kernels.ext_step``: the step's three packed records, with the Aks and
salt/temp lanes where the variant reads them, the boundary rows, the
polygon, curvilinear and axis tables, and the params vector with the
step's 9 polintd weights), K2's (dx, dy, dz) and, for behavior 7, its
stage-1 currents (u1, v1), and the key pairs of the step's substreams
HTURB..DEATH (``step_keys``).  Its death probability 1 - exp(-idt /
deadage) comes from ``death_probability``, the plain version's own
expression, so that no decision differs on it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import packed as pk
from .. import rng
from .. import state as st
from ..physics import behavior as bh
from ..physics import boundary as bd
from ..physics import settlement as stl
from ..physics import turb as tb
from ..physics.advect import sample_scalar
from . import build
from . import ext_step as kx

_C_ARGTYPES = ([ctypes.c_void_p] * 32 + [ctypes.c_int] * 18
               + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
               + [ctypes.c_double] * 5 + [ctypes.c_void_p] * 7)

P_PDIE = kx.P_NYG + 1     # csrc/lanes.cuh: the step's death probability
SUBSTREAMS = (rng.HTURB, rng.VTURB, rng.BEHAVE, rng.MORTALITY, rng.DEATH)


def kernel_variant(ctx, cfg, dtype) -> dict:
    """The compile-time options of csrc/step_lanes.cu: the whole-step
    kernel's (``ext_step.variant_of``) less LTX_MORTALITY, since this
    kernel always draws DEATH."""
    v = kx.variant_of(ctx, cfg, dtype)
    del v["LTX_MORTALITY"]
    return v


def step_keys(seed, step: int) -> np.ndarray:
    """(10,) uint32: the derived key pairs ``rng.stream_key(seed, step,
    sub)`` of substreams HTURB, VTURB, BEHAVE, MORTALITY and DEATH."""
    return np.array([w for sub in SUBSTREAMS
                     for w in rng.stream_key(seed, int(step), sub)],
                    np.uint32)


def death_probability(cfg, dtype, device="cpu") -> float:
    """1 - exp(-idt / deadage) in ``dtype`` on ``device``, as
    ``behavior.behave`` computes the probability that it draws stochastic
    mortality against (read once per configuration and device)."""
    key = (str(device), dtype, float(cfg.idt), float(cfg.deadage))
    if key not in _p_die:
        idt = torch.full((), float(cfg.idt), dtype=dtype, device=device)
        _p_die[key] = float(-torch.expm1(-idt / torch.full(
            (), float(cfg.deadage), dtype=dtype, device=device)))
    return _p_die[key]


_p_die = {}   # (device, dtype, idt, deadage) -> death probability


def lanes(ctx, cfg, seed, step_idx: int, p: st.Particles, fields, t: float,
          dx, dy, dz, column, currents) -> st.Particles:
    """Plain version: one internal step's lanes after the RK4 displacement
    (dx, dy, dz) of every particle from t, on any device.  ``column(x, y,
    end)`` gives (zeta, h) at the positions at t (end False) or t + idt;
    ``currents()`` the stage-1 currents (u, v) that behavior 7 rides.
    ``fields`` is the 3-record window (Visser's Aks, the 4/5 cue, salt
    sampling); ``step_idx`` keys the draws."""
    from ..step import make_params
    grid, bounds = ctx.grid, ctx.bounds
    turb, beh = make_params(cfg)
    dtype = p.x.dtype
    dev = p.x.device
    idt = float(cfg.idt)
    # scalars filled in on the device (a host copy would wait for it)
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
        cur = (currents() if cfg.Behavior == 7
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
                grid, fields, getattr(fields, k), new_x, new_y, new_z, t1_h,
                cfg.tension_sigma), getattr(p, k)) for k in ("salt", "temp")})
    if cfg.TrackCollisions:
        out = out.replace(
            hit_land=p.hit_land + torch.where(active, hits, 0).to(
                torch.int32),
            hit_bottom=p.hit_bottom + (active & hit_bot).to(torch.int32))
    return out


def step_lanes_reference(ctx, cfg, seed, step_idx: int, p: st.Particles,
                         fields, vtabs, t: float, disp) -> st.Particles:
    """The plain version at step_lanes_fused's signature (any device):
    ``lanes`` with zeta and h from the stage value tables ``vtabs`` (t and
    t + idt) and the stage-1 currents of ``disp``."""
    grid = ctx.grid

    def column(x, y, end):
        return pk.zeta_h_packed(grid, vtabs[2 if end else 0], x, y)

    return lanes(ctx, cfg, seed, step_idx, p, fields, t, *disp[:3], column,
                 lambda: disp[3:5])


def _lib(variant: dict):
    fn = build.load("step_lanes", variant).ltx_step_lanes
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _upload(ctx, cfg, seed, step_idx, prec, t, dtype, dev):
    """The step's params (float64 under float64 positions, then float32)
    and key words in one pinned host buffer, copied to the device without
    a wait: (device bytes, dparams offset or None, params offset, keys
    offset)."""
    dvm = None
    if cfg.Behavior == 3:
        from ..step import make_params
        dvm = make_params(cfg)[1]
    idt = float(cfg.idt)
    p_die = death_probability(cfg, dtype, dev)
    parts = []
    if dtype == torch.float64:
        d = kx.finish_params(kx.params_static(ctx, cfg, np.float64), t,
                             prec.times, idt, 1, dvm)
        d[P_PDIE] = p_die
        parts.append(d)
    f = kx.finish_params(kx.params_static(ctx, cfg), t, prec.times, idt, 1,
                         dvm)
    f[P_PDIE] = p_die
    parts += [f, step_keys(seed, step_idx)]
    raw = np.concatenate([a.view(np.uint8) for a in parts])
    host = torch.empty(raw.size, dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = raw
    offs = np.cumsum([0] + [a.nbytes for a in parts])
    buf = host.to(dev, non_blocking=True)
    if dtype == torch.float64:
        return buf, int(offs[0]), int(offs[1]), int(offs[2])
    return buf, None, int(offs[0]), int(offs[1])


def step_lanes_fused(ctx, cfg, seed, step_idx: int, p: st.Particles, fields,
                     prec, vtabs, t: float, disp) -> st.Particles:
    """One internal step's lanes from t for the whole batch, after K2's
    ``disp`` = (dx, dy, dz[, u1, v1]) (the stage-1 currents for behavior
    7); ``prec`` is the step's three packed records, ``vtabs`` its stage
    value tables (the plain version's zeta and h), ``fields`` its 3-record
    window (the plain version's Aks and salt); ``step_idx`` and ``seed``
    key the draws.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 or float64 positions, any grid, stochastic mortality: the
    per-step route's) or raise."""
    dev = p.x.device
    if dev.type == "cpu":
        return step_lanes_reference(ctx, cfg, seed, step_idx, p, fields,
                                    vtabs, t, disp)
    if dev.type != "cuda":
        raise ValueError(f"step_lanes_fused: unsupported device {dev}")
    if not (cfg.mortality and cfg.stochastic_mortality):
        raise ValueError("step_lanes_fused: the kernel draws stochastic "
                         "mortality (the per-step route's); the other "
                         "routes run the lanes as ops")
    if float(cfg.tension_sigma) < 0:
        raise NotImplementedError("step_lanes_fused: adaptive tension")
    g, b = ctx.grid, ctx.bounds
    n, us, ws = p.n, g.us, g.ws
    bh.check_ported(bh.BehaveParams(behavior=cfg.Behavior))
    pdt = p.x.dtype
    if pdt not in (torch.float32, torch.float64):
        raise ValueError(f"step_lanes_fused: positions must be float32 or "
                         f"float64, got {pdt}")
    if us > kx.MAX_LEVELS or ws > kx.MAX_LEVELS:
        raise ValueError(f"step_lanes_fused: {us}/{ws} levels exceed "
                         f"MAX_LEVELS={kx.MAX_LEVELS}")
    variant = kernel_variant(ctx, cfg, pdt)
    tab = prec.tab
    nl = tab.shape[-1]
    aks0, salt0 = kx.lane_offsets(nl, us, ws)
    if variant["LTX_VTURB"] == kx.VTURB_AKS and aks0 < 0:
        raise ValueError(f"step_lanes_fused: Visser on Aks needs the {ws} "
                         f"Aks lanes (build_packed_records(with_aks=True))")
    if cfg.needs_salt_fields() and salt0 < 0:
        raise ValueError(f"step_lanes_fused: SaltTempOn and behaviors 4/5 "
                         f"need the {2 * us} salt/temp lanes "
                         f"(build_packed_records(with_scalars=True))")
    if (tab.dtype != torch.float32 or tab.device != dev
            or tuple(tab.shape) != (3, g.ny * g.nx, nl)
            or not tab.is_contiguous()):
        raise ValueError(f"step_lanes_fused: record table must be a "
                         f"contiguous (3, {g.ny * g.nx}, {nl}) float32 "
                         f"tensor on {dev}, got {tuple(tab.shape)} "
                         f"{tab.dtype} on {tab.device}")
    for k in ("x", "y", "z", "dob", "age", "salt", "temp"):
        kx._check_col(k, getattr(p, k), n, pdt, dev)
    for k in ("status", "pid", "settle_poly"):
        kx._check_col(k, getattr(p, k), n, torch.int32, dev)
    need = 5 if cfg.Behavior == 7 else 3
    if len(disp) < need:
        raise ValueError(f"step_lanes_fused: needs {need} of K2's outputs "
                         f"(the stage-1 currents for behavior 7)")
    for k, v in zip(("dx", "dy", "dz", "u1", "v1"), disp[:need]):
        kx._check_col(k, v, n, pdt, dev)
    brows = kx.boundary_rows_table(ctx, pdt)
    settle = kx.settle_tables(ctx) if cfg.settlementon else None
    cxy, cseed, (c_mx, c_my), c_scal = (
        kx.curv_tables(ctx, pdt) if g.curv is not None
        else (None, None, (0, 0), (0.0,) * 5))
    axes = ((None,) * 3 if "LTX_AXES" not in variant
            else kx.axes_tables(ctx, pdt))
    for name, tbl in (("boundaries", brows),
                      ("polygons", settle and settle[0]),
                      ("curvilinear map", cxy),
                      ("grid axes", next((a[0] for a in axes if a), None))):
        if tbl is not None and tbl.device != dev:
            raise ValueError(f"step_lanes_fused: {name} on another device")
    if n == 0:
        return p
    buf, d_off, f_off, k_off = _upload(ctx, cfg, seed, step_idx, prec, t,
                                       pdt, dev)
    base = buf.data_ptr()
    x_o = torch.empty_like(p.x)
    y_o = torch.empty_like(p.y)
    z_o = torch.empty_like(p.z)
    age_o = torch.empty_like(p.age)
    st_o = torch.empty_like(p.status)
    hitl = torch.empty_like(p.status)
    hitb = torch.empty_like(p.status)
    spoly_o = torch.empty_like(p.settle_poly) if cfg.settlementon else None
    salt_o = torch.empty_like(p.salt) if cfg.SaltTempOn else None
    temp_o = torch.empty_like(p.temp) if cfg.SaltTempOn else None
    sd, si, (n_p, v_p, c_p), (n_h, v_h, c_h) = (
        settle if settle is not None else (None, None, (0, 1, 1), (0, 1, 1)))

    def ptr(v):
        return v.data_ptr() if v is not None else None

    u1, v1 = disp[3:5] if need == 5 else (None, None)
    ax_ptrs = [ptr(v) for pair in axes for v in (pair or (None, None))]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib(variant)(
        tab.data_ptr(), brows.data_ptr(), base + f_off,
        None if d_off is None else base + d_off, base + k_off,
        p.x.data_ptr(), p.y.data_ptr(), p.z.data_ptr(), p.dob.data_ptr(),
        p.age.data_ptr(), p.pid.data_ptr(), p.status.data_ptr(),
        p.settle_poly.data_ptr(), p.salt.data_ptr(), p.temp.data_ptr(),
        *(v.data_ptr() for v in disp[:3]), ptr(u1), ptr(v1),
        x_o.data_ptr(), y_o.data_ptr(), z_o.data_ptr(), age_o.data_ptr(),
        st_o.data_ptr(), hitl.data_ptr(), hitb.data_ptr(), ptr(spoly_o),
        ptr(salt_o), ptr(temp_o), ptr(sd), ptr(si), n, g.nx, g.ny, us, ws,
        nl, aks0, salt0, g.vtransform, int(cfg.reflect_iters),
        int(bool(cfg.OpenOceanBoundary)), b.s_max, n_p, v_p, c_p, n_h, v_h,
        c_h, ptr(cxy), ptr(cseed), c_mx, c_my, *c_scal, *ax_ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"step_lanes kernel launch failed: CUDA error "
                           f"{rc}")
    step_lanes_fused.launches += 1
    tag = build.tag("step_lanes", variant)
    step_lanes_fused.variant_launches[tag] = (
        step_lanes_fused.variant_launches.get(tag, 0) + 1)
    out = p.replace(x=x_o, y=y_o, z=z_o, status=st_o, age=age_o)
    if cfg.settlementon:
        out = out.replace(settle_poly=spoly_o)
    if cfg.SaltTempOn:
        out = out.replace(salt=salt_o, temp=temp_o)
    if cfg.TrackCollisions:
        out = out.replace(hit_land=p.hit_land + hitl,
                          hit_bottom=p.hit_bottom + hitb)
    return out


step_lanes_fused.launches = 0             # every launch
step_lanes_fused.variant_launches = {}    # launches per compiled variant
