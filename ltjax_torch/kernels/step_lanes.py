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
  ``.variant_launches``; a failed build or launch raises.  The call is
  the span ``ltjax_torch.k3`` (``ltjax_torch.trace``).

Both read the step's time-collapsed tables: zeta and h from the route's
stage value tables at t and t + idt (``vtabs[0]``, ``vtabs[2]``, K2's),
and the Aks, salt and temp lanes of the packed records collapsed once a
step to t (Visser, the 4/5 cue) and t + idt (SaltTempOn) by
``aux_tables`` (``Aux``), only the lanes the variant reads.  Without
them (a record table that lacks the lanes) the plain version reads the
FieldSet, as the other routes do, and the kernel refuses.  The kernel's
static params (``kernels.ext_step``'s head and ladders, the death
probability 1 - exp(-idt / deadage) from ``death_probability``, the
plain version's own expression) are built once per context,
configuration and dtype and stay on the device; the step's start, behavior
3's surface irradiance, the seed words and the step index go in by value,
and the kernel derives the key pairs of the step's substreams HTURB..DEATH
itself (``step_keys`` is their host twin), so that a launch allocates no
host memory and copies nothing to the device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import packed as pk
from .. import rng, tension
from .. import state as st
from ..physics import behavior as bh
from ..physics import boundary as bd
from ..physics import settlement as stl
from ..physics import turb as tb
from ..interp import polintd
from ..physics.advect import sample_scalar
from ..scoord import s_depths
from ..trace import span, spanned
from . import build
from . import ext_step as kx

_C_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_double] * 2
               + [ctypes.c_uint32] * 3 + [ctypes.c_void_p] * 27
               + [ctypes.c_int] * 15 + [ctypes.c_void_p] * 2
               + [ctypes.c_int] * 2 + [ctypes.c_double] * 5
               + [ctypes.c_void_p] * 7)

P_PDIE = kx.P_NYG + 1     # csrc/lanes.cuh: the step's death probability
SUBSTREAMS = (rng.HTURB, rng.VTURB, rng.BEHAVE, rng.MORTALITY, rng.DEATH)


class Aux(NamedTuple):
    """The step's aux tables, (Ny*Nx, w) cell tables of the packed
    records' lanes collapsed with polintd, or None where the variant reads
    none: ``t0`` at t, the ws Aks lanes (Visser on Aks) then the us salt
    lanes (behaviors 4/5, the cue); ``t1`` at t + idt, the us salt then
    the us temp lanes (SaltTempOn)."""
    t0: Optional[torch.Tensor]
    t1: Optional[torch.Tensor]


def aux_reads(cfg):
    """(aks, cue, sample): whether the lanes read the Aks and salt lanes
    at t and the salt and temp lanes at t + idt."""
    return (bool(cfg.VTurbOn and cfg.readAks), cfg.Behavior in (4, 5),
            bool(cfg.SaltTempOn))


def aux_tables(grid, cfg, prec, t: float, idt: float) -> Optional[Aux]:
    """The step's ``Aux`` from its 3 packed records (collapsed at t and at
    t + idt, the times of the stage tables ``vtabs[0]`` and ``vtabs[2]``),
    or None when the record table lacks lanes the configuration reads."""
    us, ws = grid.us, grid.ws
    aks, cue, sample = aux_reads(cfg)
    aks0, salt0 = kx.lane_offsets(prec.tab.shape[-1], us, ws)
    if (aks and aks0 < 0) or ((cue or sample) and salt0 < 0):
        return None

    def collapse(lo, hi, tt):
        return polintd(prec.tab[..., lo:hi], prec.times, tt)

    t = float(t)
    t0 = None
    if aks or cue:
        t0 = collapse(aks0 if aks else salt0,
                      salt0 + us if cue else aks0 + ws, t)
    t1 = collapse(salt0, salt0 + 2 * us, t + idt) if sample else None
    return Aux(t0, t1)


def kernel_variant(ctx, cfg, dtype) -> dict:
    """The compile-time options of csrc/step_lanes.cu: the whole-step
    kernel's (``ext_step.variant_of``) less LTX_MORTALITY, since this
    kernel always draws DEATH."""
    v = kx.variant_of(ctx, cfg, dtype)
    del v["LTX_MORTALITY"]
    return v


def step_keys(seed, step: int) -> np.ndarray:
    """(10,) uint32: the derived key pairs ``rng.stream_key(seed, step,
    sub)`` of substreams HTURB, VTURB, BEHAVE, MORTALITY and DEATH, the
    layout of the words the kernel derives per block (``kernel_keys``)."""
    return np.array([w for sub in SUBSTREAMS
                     for w in rng.stream_key(seed, int(step), sub)],
                    np.uint32)


def launch_words(seed, step: int):
    """(k0, k1, step word): the kernel's key arguments, the seed words
    (rng.seed_words) and the step index as a uint32 word."""
    k0, k1 = rng.seed_words(seed)
    return k0, k1, int(step) & rng.MASK


def kernel_keys(k0: int, k1: int, step: int) -> torch.Tensor:
    """(10,) int64 words: the plain twin of the kernel's key derivation
    from its arguments (``launch_words``), threads 0-4 of a block each
    running csrc/lanes.cuh's threefry2x32 on (step, substream) under (k0,
    k1), as one tensor call of rng.threefry2x32 (uint32 words held in
    int64, masked after every add and shift)."""
    x0 = torch.full((len(SUBSTREAMS),), step, dtype=torch.int64)
    x1 = torch.tensor(SUBSTREAMS, dtype=torch.int64)
    s0, s1 = rng.threefry2x32(k0, k1, x0, x1)
    return torch.stack([s0, s1], dim=-1).reshape(-1)


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


def _aux_profile(grid, tab, col, k, w_levels, x, y, zeta, h):
    """(knot depths, profile) of lanes [col, col + k) of an aux table at
    the particles: the blend in the table's dtype, then the particles'
    dtype; the w or rho ladder's depths from the stage table's zeta, h."""
    dtype = x.dtype
    prof = pk._blend_rows(grid, tab[:, col:col + k], x, y).to(dtype)
    s, cs = (grid.s_w, grid.Cs_w) if w_levels else (grid.s_rho, grid.Cs_r)
    return s_depths(zeta, h, s.to(dtype), cs.to(dtype), grid.hc,
                    grid.vtransform), prof


def lanes(ctx, cfg, seed, step_idx: int, p: st.Particles, fields, t: float,
          dx, dy, dz, column, currents, aux: Optional[Aux] = None
          ) -> st.Particles:
    """Plain version: one internal step's lanes after the RK4 displacement
    (dx, dy, dz) of every particle from t, on any device.  ``column(x, y,
    end)`` gives (zeta, h) at the positions at t (end False) or t + idt;
    ``currents()`` the stage-1 currents (u, v) that behavior 7 rides.
    Visser's Aks, the 4/5 cue's salt and the sampled salt and temp come
    from the step's aux tables ``aux`` (``aux_tables``) with the knots of
    ``column``, or without them from ``fields``, the 3-record window
    (each blended, then collapsed).  ``step_idx`` keys the draws."""
    from ..step import make_params
    grid, bounds = ctx.grid, ctx.bounds
    turb, beh = make_params(cfg)
    dtype = p.x.dtype
    dev = p.x.device
    idt = float(cfg.idt)
    us, ws = grid.us, grid.ws
    # scalars filled in on the device (a host copy would wait for it)
    idt_t = torch.full((), idt, dtype=dtype, device=dev)
    tt = torch.full((), t, dtype=dtype, device=dev)
    t1_h = float(torch.tensor(t, dtype=dtype) + idt)
    aks_prof = salt_prof = None
    if aux is not None:
        zh0 = column(p.x, p.y, False)
        aks = aux_reads(cfg)[0]

        def aks_prof(x, y):
            return _aux_profile(grid, aux.t0, 0, ws, True, x, y, *zh0)

        def salt_prof(x, y):
            return _aux_profile(grid, aux.t0, ws if aks else 0, us, False, x,
                                y, *zh0)

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
                           p.z, t, turb, profile=aks_prof)

    # --- behavior (free surface, depth and currents at stage 1) ----------
    dies = torch.zeros_like(active)
    if cfg.Behavior != 0 or cfg.mortality:
        zeta_p, h_p = column(p.x, p.y, False)
        cur = (currents() if cfg.Behavior == 7
               else (torch.zeros_like(p.x), torch.zeros_like(p.x)))
        bx, by, bz, dies = bh.behave(grid, fields, seed, step_idx, p.pid,
                                     p.x, p.y, p.z, tt, p.age, zeta_p, h_p,
                                     cur, beh, salt_profile=salt_prof)
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
        if aux is not None:
            # the new column at t + idt: its knots and the aux lanes
            zh1 = column(new_x, new_y, True)
            sig = cfg.tension_sigma
            for k, col in (("salt", 0), ("temp", us)):
                z_r, prof = _aux_profile(grid, aux.t1, col, us, False,
                                         new_x, new_y, *zh1)
                v = tension.evaluate(z_r, prof, tension.fit(z_r, prof, sig),
                                     sig, new_z)
                out = out.replace(**{k: torch.where(active, v,
                                                    getattr(p, k))})
        else:
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
    return out


def step_lanes_reference(ctx, cfg, seed, step_idx: int, p: st.Particles,
                         fields, vtabs, t: float, disp,
                         aux: Optional[Aux] = None) -> st.Particles:
    """The plain version at step_lanes_fused's signature (any device):
    ``lanes`` with zeta and h from the stage value tables ``vtabs`` (t and
    t + idt), the stage-1 currents of ``disp``, and the aux tables
    ``aux`` (or, without them, ``fields``)."""
    grid = ctx.grid

    def column(x, y, end):
        return pk.zeta_h_packed(grid, vtabs[2 if end else 0], x, y)

    return lanes(ctx, cfg, seed, step_idx, p, fields, t, *disp[:3], column,
                 lambda: disp[3:5], aux)


def _lib(variant: dict):
    fn = build.load("step_lanes", variant).ltx_step_lanes
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _device_params(ctx, cfg, dtype, dev):
    """The kernel's static params on the device, once per context,
    configuration and positions' dtype (cached on the context): one
    buffer with the float64 head and ladders under float64 positions,
    then the float32 ones, P_PDIE the step's death probability in both.
    Returns (buffer, float64 offset or None, float32 offset)."""
    statics = ([kx.params_static(ctx, cfg, np.float64)]
               if dtype == torch.float64 else []) + [
        kx.params_static(ctx, cfg)]
    # params_static caches its arrays on the context: their ids key them
    key = ("step_lanes_params", str(dev), dtype, *map(id, statics))
    if key not in ctx.cache:
        p_die = death_probability(cfg, dtype, dev)
        parts = []
        for a in statics:
            a = a.copy()
            a[P_PDIE] = p_die
            parts.append(a)
        raw = np.concatenate([a.view(np.uint8) for a in parts])
        buf = torch.from_numpy(raw).to(dev)
        f_off = parts[0].nbytes if len(parts) == 2 else 0
        ctx.cache[key] = (buf, 0 if len(parts) == 2 else None, f_off)
    return ctx.cache[key]


def _check_table(name, v, shape, dev):
    if (v is None or v.dtype != torch.float32 or v.device != dev
            or tuple(v.shape) != shape or not v.is_contiguous()):
        got = None if v is None else (tuple(v.shape), v.dtype, v.device)
        raise ValueError(f"step_lanes_fused: {name} must be a contiguous "
                         f"{shape} float32 tensor on {dev}, got {got}")


@spanned("ltjax_torch.k3")
def step_lanes_fused(ctx, cfg, seed, step_idx: int, p: st.Particles, fields,
                     vtabs, aux: Optional[Aux], t: float,
                     disp) -> st.Particles:
    """One internal step's lanes from t for the whole batch, after K2's
    ``disp`` = (dx, dy, dz[, u1, v1]) (the stage-1 currents for behavior
    7); ``vtabs`` are the step's stage value tables (zeta and h at t and
    t + idt), ``aux`` its aux tables (``aux_tables``; None: the plain
    version reads ``fields``, the 3-record window, and the kernel
    refuses); ``step_idx`` and ``seed`` key the draws.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 or float64 positions, any grid, stochastic mortality: the
    per-step route's) or raise."""
    dev = p.x.device
    if dev.type == "cpu":
        return step_lanes_reference(ctx, cfg, seed, step_idx, p, fields,
                                    vtabs, t, disp, aux)
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
    if aux is None:
        raise ValueError("step_lanes_fused: the kernel reads the step's aux "
                         "tables; the record table lacks the Aks or "
                         "salt/temp lanes of the configuration "
                         "(build_packed_records(with_aks=, with_scalars=))")
    variant = kernel_variant(ctx, cfg, pdt)
    C = g.ny * g.nx
    for name, vt in (("stage table at t", vtabs[0]),
                     ("stage table at t + idt", vtabs[2])):
        _check_table(name, vt.full, (g.ny, g.nx, pk.n_value_lanes(us, ws)),
                     dev)
    aks, cue, sample = aux_reads(cfg)
    for name, v, w, on in (("aux table at t", aux.t0,
                            ws * aks + us * cue, aks or cue),
                           ("aux table at t + idt", aux.t1, 2 * us, sample)):
        if on:
            _check_table(name, v, (C, w), dev)
        elif v is not None:
            raise ValueError(f"step_lanes_fused: {name} given, but the "
                             f"configuration reads none")
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
    with span("ltjax_torch.k3.upload"):
        buf, d_off, f_off = _device_params(ctx, cfg, pdt, dev)
    base = buf.data_ptr()
    e0 = 0.0
    if cfg.Behavior == 3:             # as behave computes it at t
        from ..step import make_params
        tdt = torch.float64 if pdt == torch.float64 else torch.float32
        e0 = float(bh.surface_irradiance(torch.tensor(t, dtype=tdt),
                                         make_params(cfg)[1], tdt))
    k0, k1, step_w = launch_words(seed, step_idx)
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
        vtabs[0].full.data_ptr(), vtabs[2].full.data_ptr(), ptr(aux.t0),
        ptr(aux.t1), brows.data_ptr(), base + f_off,
        None if d_off is None else base + d_off, float(t), e0, k0, k1,
        step_w, p.x.data_ptr(), p.y.data_ptr(), p.z.data_ptr(),
        p.dob.data_ptr(), p.age.data_ptr(), p.pid.data_ptr(),
        p.status.data_ptr(), p.settle_poly.data_ptr(), p.salt.data_ptr(),
        p.temp.data_ptr(), *(v.data_ptr() for v in disp[:3]), ptr(u1),
        ptr(v1), x_o.data_ptr(), y_o.data_ptr(), z_o.data_ptr(),
        age_o.data_ptr(), st_o.data_ptr(), hitl.data_ptr(), hitb.data_ptr(),
        ptr(spoly_o), ptr(salt_o), ptr(temp_o), ptr(sd), ptr(si), n, g.nx,
        g.ny, us, ws, g.vtransform, int(cfg.reflect_iters),
        int(bool(cfg.OpenOceanBoundary)), b.s_max, n_p, v_p, c_p, n_h, v_h,
        c_h, ptr(cxy), ptr(cseed), c_mx, c_my, *c_scal, *ax_ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"step_lanes kernel launch failed: CUDA error "
                           f"{rc}")
    step_lanes_fused.launches += 1
    tag = build.tag("step_lanes", variant)
    step_lanes_fused.variant_launches[tag] = (
        step_lanes_fused.variant_launches.get(tag, 0) + 1)
    cols = dict(x=x_o, y=y_o, z=z_o, status=st_o, age=age_o)
    if cfg.settlementon:
        cols.update(settle_poly=spoly_o)
    if cfg.SaltTempOn:
        cols.update(salt=salt_o, temp=temp_o)
    if cfg.TrackCollisions:
        cols.update(hit_land=p.hit_land + hitl,
                    hit_bottom=p.hit_bottom + hitb)
    return p.replace(**cols)


step_lanes_fused.launches = 0             # every launch
step_lanes_fused.variant_launches = {}    # launches per compiled variant
