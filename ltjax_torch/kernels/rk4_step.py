"""One internal step's RK4 displacement: CUDA kernel wrapper + plain
version.

Counterpart of ``ltjax.kernels.gather_interp.rk4_displacement_fused``,
the kernel of the per-internal-step path (``step.internal_step(...,
mode="kernel")``).  ``rk4_displacement_fused`` computes (dx, dy, dz) of
every particle from the three stage tables (t, t + idt/2, t + idt) of
``packed.stage_value_tables``:

* on CPU tensors it returns the plain version,
  ``packed.rk4_displacement_collapsed`` (and, with ``stage1``, the stage-1
  currents of ``packed.find_currents_collapsed``);
* on CUDA tensors it launches ``csrc/rk4_step.cu`` (one thread per
  particle) and counts the launch in ``rk4_displacement_fused.launches``;
  a failed build or launch raises.

The kernel reads the stage tables (Ny*Nx, nv) f32 and a small f32 params
vector: x0, dx, y0, dy of the uniform rho axes (dx and dy in f32
arithmetic, as ``grid.locate``), hc, z0m, sigma, then the s/Cs ladders
(s_rho, Cs_r, s_w, Cs_w).  It has no window, no out-of-window flag and no
exact patch: no particle can miss a window when the kernel gathers from
device memory.  Uniform rectilinear grids and a static tension only.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from .. import packed as pk
from . import build

MAX_LEVELS = 64   # compile-time level bound of the kernel (csrc MAX_LEVELS)

# params layout (csrc/rk4_step.cu enum Q_*)
Q_X0, Q_DX, Q_Y0, Q_DY, Q_HC, Q_Z0M, Q_SIGMA = range(7)
Q_HEAD = 7

_C_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_void_p])


def params_array(grid, sigma: float, z0m: float) -> torch.Tensor:
    """The kernel's f32 params vector (host), counterpart of
    ``gather_interp._params_array`` in this kernel's own layout."""
    f32 = np.float32
    xr = grid.x_rho.cpu().numpy().astype(f32)
    yr = grid.y_rho.cpu().numpy().astype(f32)
    head = np.zeros(Q_HEAD, f32)
    head[Q_X0] = xr[0]
    head[Q_DX] = xr[1] - xr[0]          # f32 arithmetic, as grid.locate
    head[Q_Y0] = yr[0]
    head[Q_DY] = yr[1] - yr[0]
    head[Q_HC] = grid.hc
    head[Q_Z0M] = z0m
    head[Q_SIGMA] = sigma
    lad = [t.cpu().numpy().astype(f32) for t in (grid.s_rho, grid.Cs_r,
                                                  grid.s_w, grid.Cs_w)]
    return torch.from_numpy(np.concatenate([head] + lad))


def _lib():
    fn = build.load("rk4_step").ltx_rk4_step
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _plain(grid, vtabs, x, y, z, sigma, z0m, idt, stage1):
    d = pk.rk4_displacement_collapsed(grid, vtabs, x, y, z, sigma, z0m, idt)
    if stage1:
        return d + pk.find_currents_collapsed(grid, vtabs[0], x, y, z, sigma,
                                              z0m)[:2]
    return d


def _check(grid, vtabs, x, y, z):
    """Positions: contiguous (N,) tensors of one float dtype and device;
    stage tables: three contiguous (Ny, Nx, nv) tensors of one float
    dtype (that of the fields, which may differ from the positions') on
    that device."""
    dev, dtype, n = x.device, x.dtype, x.shape[0]
    if not dtype.is_floating_point:
        raise ValueError(f"rk4_displacement_fused: positions must be float, "
                         f"got {dtype}")
    for name, v in (("x", x), ("y", y), ("z", z)):
        if (v.dtype != dtype or v.device != dev or tuple(v.shape) != (n,)
                or not v.is_contiguous()):
            raise ValueError(f"rk4_displacement_fused: {name} must be a "
                             f"contiguous ({n},) {dtype} tensor on {dev}")
    want = (grid.ny, grid.nx, pk.n_value_lanes(grid.us, grid.ws))
    if len(vtabs) != 3:
        raise ValueError("rk4_displacement_fused: needs the 3 stage tables")
    tdt = vtabs[0].full.dtype
    for vt in vtabs:
        t = vt.full
        if (t.dtype != tdt or not tdt.is_floating_point or t.device != dev
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f"rk4_displacement_fused: stage tables must be "
                             f"contiguous {want} tensors of one float dtype "
                             f"on {dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")


def rk4_displacement_fused(grid, vtabs, x, y, z, sigma: float, z0m: float,
                           idt: float, stage1: bool = False):
    """RK4 displacement (dx, dy, dz) of one internal step from the stage
    tables ``vtabs`` (t, t + idt/2, t + idt); with ``stage1`` also the
    stage-1 currents (u1, v1).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (f32, uniform rectilinear grid, sigma >= 0) or raise."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rk4_displacement_fused: unsupported device {dev}")
    _check(grid, vtabs, x, y, z)
    if dev.type == "cpu":
        return _plain(grid, vtabs, x, y, z, sigma, z0m, idt, stage1)
    if x.dtype != torch.float32 or vtabs[0].full.dtype != torch.float32:
        raise ValueError("rk4_displacement_fused: the CUDA kernel takes "
                         f"float32 positions and tables, got {x.dtype} and "
                         f"{vtabs[0].full.dtype}")
    if grid.curv is not None or not grid.uniform:
        raise NotImplementedError("rk4_displacement_fused: the CUDA kernel "
                                  "locates cells on uniform rectilinear "
                                  "axes only")
    if float(sigma) < 0:
        raise NotImplementedError("rk4_displacement_fused: adaptive tension")
    us, ws = grid.us, grid.ws
    if us > MAX_LEVELS or ws > MAX_LEVELS:
        raise ValueError(f"rk4_displacement_fused: {us}/{ws} levels exceed "
                         f"MAX_LEVELS={MAX_LEVELS}")
    key = (id(grid), float(sigma), float(z0m))
    hit = _params_cache.get(key)
    if hit is None or hit[0]() is not grid:
        hit = (weakref.ref(grid),
               params_array(grid, float(sigma), float(z0m)).to(dev))
        _params_cache[key] = hit
    par = hit[1]
    n = x.shape[0]
    out = [torch.empty_like(x) for _ in range(5 if stage1 else 3)]
    if n == 0:
        return tuple(out)
    u1, v1 = ((out[3].data_ptr(), out[4].data_ptr()) if stage1
              else (None, None))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(*(vt.full.data_ptr() for vt in vtabs), par.data_ptr(),
                x.data_ptr(), y.data_ptr(), z.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), u1, v1, n, grid.nx,
                grid.ny, us, ws, grid.vtransform, float(idt), stream)
    if rc != 0:
        raise RuntimeError(f"rk4_step kernel launch failed: CUDA error {rc}")
    rk4_displacement_fused.launches += 1
    return tuple(out)


rk4_displacement_fused.launches = 0     # every launch
_params_cache = {}   # (id(grid), sigma, z0m) -> (weakref, device params)
