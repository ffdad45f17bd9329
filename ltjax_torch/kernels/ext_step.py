"""Whole-external-step advection: CUDA kernel wrapper + plain version.

Counterpart of ``ltjax.kernels.ext_step.ext_step_fused`` (advection
lanes).  ``ext_step_fused`` runs ``cfg.internal_steps`` internal steps of
the whole batch:

* on CUDA tensors it launches ``csrc/ext_step.cu`` (one thread per
  particle, the internal-step loop inside the thread) and counts the
  launch in ``ext_step_fused.launches``;
* on CPU tensors it runs ``ext_step_reference``, the plain PyTorch
  version: a loop of ``step.internal_step`` (collapsed scheme).

The kernel reads the raw record table ``PackedRecords.tab`` (3, Ny*Nx,
nv) f32, the boundary cell rows (Ny*Nx, 8 + 8*s_max) f32 and a small
f32 params vector: the head scalars below, the s/Cs ladders, and the
quadratic time weights of every (internal step, RK4 stage), computed on
the host in float64 (as ``ltjax.kernels.ext_step.finish_params`` does
under x64) and rounded to f32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import state as st
from ..interp import polintd_coefs
from ..packed import PackedRecords, n_value_lanes
from . import build

MAX_LEVELS = 64   # compile-time level bound of the kernel (csrc MAX_LEVELS)

# params head layout (csrc/ext_step.cu enum P_*)
(P_X0, P_DX, P_Y0, P_DY, P_BX0, P_BDX, P_BY0, P_BDY, P_BX1, P_BY1, P_HC,
 P_Z0M, P_T0, P_IDT, P_SIGMA) = range(15)
P_HEAD = 16


def params_static(ctx, cfg) -> np.ndarray:
    """Head scalars + s/Cs ladders (f32), once per context."""
    key = ("ext_step_params", float(cfg.z0), float(cfg.idt),
           float(cfg.tension_sigma))
    if key in ctx.cache:
        return ctx.cache[key]
    g, b = ctx.grid, ctx.bounds
    f32 = np.float32
    xr = g.x_rho.cpu().numpy().astype(f32)
    yr = g.y_rho.cpu().numpy().astype(f32)
    bx0, bdx, by0, bdy, bx1, by1 = b.edges
    head = np.zeros(P_HEAD, f32)
    head[P_X0] = xr[0]
    head[P_DX] = xr[1] - xr[0]          # f32 arithmetic, as grid.locate
    head[P_Y0] = yr[0]
    head[P_DY] = yr[1] - yr[0]
    head[[P_BX0, P_BDX, P_BY0, P_BDY, P_BX1, P_BY1]] = (bx0, bdx, by0, bdy,
                                                       bx1, by1)
    head[P_HC] = g.hc
    head[P_Z0M] = cfg.z0
    head[P_IDT] = cfg.idt
    head[P_SIGMA] = cfg.tension_sigma
    lad = [t.cpu().numpy().astype(f32) for t in (g.s_rho, g.Cs_r, g.s_w,
                                                  g.Cs_w)]
    out = np.concatenate([head] + lad)
    ctx.cache[key] = out
    return out


def finish_params(static: np.ndarray, t0: float, times, idt: float,
                  n_int: int) -> np.ndarray:
    """Append the start time and the polintd weights of every internal
    step's 3 stage times (t, t + idt/2, t + idt): 9 per step."""
    head = static.copy()
    head[P_T0] = t0
    coef = [polintd_coefs(times, t0 + i * idt + off)
            for i in range(n_int) for off in (0.0, 0.5 * idt, idt)]
    return np.concatenate([head, np.asarray(coef, np.float64).reshape(-1)
                           .astype(np.float32)])


def boundary_rows_table(ctx) -> torch.Tensor:
    """(Ny*Nx, 8 + 8*s_max) f32 boundary cell rows, once per context."""
    if "brows" not in ctx.cache:
        ctx.cache["brows"] = ctx.bounds.cell_rows.to(torch.float32
                                                     ).contiguous()
    return ctx.cache["brows"]


def ext_step_reference(ctx, cfg, p: st.Particles, prec: PackedRecords,
                       t0: float) -> st.Particles:
    """Plain PyTorch version: cfg.internal_steps internal steps of the
    collapsed scheme (any device, any float dtype)."""
    from ..step import internal_step
    idt = float(cfg.idt)
    for i in range(cfg.internal_steps):
        p = internal_step(ctx, cfg, p, prec, t0 + i * idt)
    return p


_C_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 10
               + [ctypes.c_void_p])


def _lib():
    lib = build.load("ext_step")
    fn = lib.ltx_ext_step
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def ext_step_fused(ctx, cfg, p: st.Particles, prec: PackedRecords,
                   t0: float) -> st.Particles:
    """One external step (cfg.internal_steps internal steps) of RK4
    advection, reflection and status bookkeeping for the whole batch.

    CPU tensors take ``ext_step_reference``; CUDA tensors launch the
    kernel (f32 positions, uniform grid) or raise."""
    dev = p.x.device
    if dev.type == "cpu":
        return ext_step_reference(ctx, cfg, p, prec, t0)
    if dev.type != "cuda":
        raise ValueError(f"ext_step_fused: unsupported device {dev}")
    g, b = ctx.grid, ctx.bounds
    n, us, ws = p.n, g.us, g.ws
    nv = n_value_lanes(us, ws)
    if not (g.uniform and b.uniform):
        raise NotImplementedError("ext_step_fused: the CUDA kernel locates "
                                  "cells arithmetically; grid not uniform")
    if ws > MAX_LEVELS or us > MAX_LEVELS:
        raise ValueError(f"ext_step_fused: {us}/{ws} levels exceed "
                         f"MAX_LEVELS={MAX_LEVELS}")
    if float(cfg.tension_sigma) < 0:
        raise NotImplementedError("ext_step_fused: adaptive tension")
    cols = {"x": p.x, "y": p.y, "z": p.z, "dob": p.dob}
    for k, v in cols.items():
        if v.dtype != torch.float32 or v.device != dev or v.shape != (n,) \
                or not v.is_contiguous():
            raise ValueError(f"ext_step_fused: {k} must be a contiguous "
                             f"({n},) float32 tensor on {dev}")
    if p.status.dtype != torch.int32 or p.status.device != dev \
            or not p.status.is_contiguous():
        raise ValueError("ext_step_fused: status must be contiguous int32")
    tab = prec.tab
    if (tab.dtype != torch.float32 or tab.device != dev
            or tuple(tab.shape) != (3, g.ny * g.nx, nv)
            or not tab.is_contiguous()):
        raise ValueError(f"ext_step_fused: record table must be a "
                         f"contiguous (3, {g.ny * g.nx}, {nv}) float32 "
                         f"tensor on {dev}, got {tuple(tab.shape)} "
                         f"{tab.dtype} on {tab.device}")
    brows = boundary_rows_table(ctx)
    if brows.device != dev:
        raise ValueError("ext_step_fused: boundaries on another device")
    n_int = cfg.internal_steps
    idt = float(cfg.idt)
    if n == 0:
        return p
    par = torch.from_numpy(finish_params(params_static(ctx, cfg), t0,
                                         prec.times, idt, n_int)).to(dev)
    x_o = torch.empty_like(p.x)
    y_o = torch.empty_like(p.y)
    z_o = torch.empty_like(p.z)
    st_o = torch.empty_like(p.status)
    hitl = torch.empty_like(p.status)
    hitb = torch.empty_like(p.status)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(tab.data_ptr(), brows.data_ptr(), par.data_ptr(),
                p.x.data_ptr(), p.y.data_ptr(), p.z.data_ptr(),
                p.dob.data_ptr(), p.status.data_ptr(), x_o.data_ptr(),
                y_o.data_ptr(), z_o.data_ptr(), st_o.data_ptr(),
                hitl.data_ptr(), hitb.data_ptr(), n, g.nx, g.ny, us, ws,
                g.vtransform, n_int, int(cfg.reflect_iters),
                int(bool(cfg.OpenOceanBoundary)), b.s_max, stream)
    if rc != 0:
        raise RuntimeError(f"ext_step kernel launch failed: CUDA error {rc}")
    ext_step_fused.launches += 1
    t_end = t0 + n_int * idt
    age = torch.where(st_o >= st.ACTIVE, t_end - p.dob, p.age)
    out = p.replace(x=x_o, y=y_o, z=z_o, status=st_o, age=age)
    if cfg.TrackCollisions:
        out = out.replace(hit_land=p.hit_land + hitl,
                          hit_bottom=p.hit_bottom + hitb)
    return out


ext_step_fused.launches = 0
