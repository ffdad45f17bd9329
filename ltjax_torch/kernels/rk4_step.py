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
  particle) in the variant of the grid and the positions' dtype
  (``kernel_variant``) and counts the launch in
  ``rk4_displacement_fused.launches`` and, per variant, in
  ``.variant_launches``; a failed build or launch raises.

The kernel reads the stage tables (Ny*Nx, nv) f32 and a small params
vector in the positions' dtype (float32 or float64): x0, dx, y0, dy of
the rho axes (dx and dy in that dtype's arithmetic, as ``grid.locate``),
hc, z0m, sigma, then the s/Cs ladders (s_rho, Cs_r, s_w, Cs_w); on a
curvilinear grid the inverse map (``ext_step.curv_tables``), on rho axes
that are not uniform the axes themselves (searched).  It has no window,
no out-of-window flag and no exact patch: no particle can miss a window
when the kernel gathers from device memory.  A static tension only.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from .. import packed as pk
from . import build, ext_step

MAX_LEVELS = 64   # compile-time level bound of the kernel (csrc MAX_LEVELS)

# params layout (csrc/rk4_step.cu enum Q_*)
Q_X0, Q_DX, Q_Y0, Q_DY, Q_HC, Q_Z0M, Q_SIGMA = range(7)
Q_HEAD = 7

_C_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
               + [ctypes.c_double] + [ctypes.c_void_p] * 2
               + [ctypes.c_int] * 2 + [ctypes.c_double] * 4
               + [ctypes.c_void_p] * 3)


def kernel_variant(grid, dtype=torch.float32) -> dict:
    """The compile-time options of csrc/rk4_step.cu for a grid and the
    positions' dtype: LTX_CURV on a curvilinear grid, LTX_AXES on
    rectilinear rho axes that are not uniform, LTX_POS64 for float64
    positions, LTX_TILE on a tile's strip of a sharded run (grid.tile);
    each only when on (the rectilinear float32 build is ``rk4_step`` as
    before)."""
    out = {}
    if grid.curv is not None:
        out["LTX_CURV"] = 1
    elif not grid.uniform:
        out["LTX_AXES"] = 1
    if dtype == torch.float64:
        out["LTX_POS64"] = 1
    if grid.tile is not None:
        out["LTX_TILE"] = 1
    return out


def params_array(grid, sigma: float, z0m: float,
                 dtype=np.float32) -> torch.Tensor:
    """The kernel's params vector (host) in the positions' dtype,
    counterpart of ``gather_interp._params_array`` in this kernel's own
    layout; on a tile's strip (LTX_TILE) the whole grid's y origin and
    spacing, and after the ladders the strip's first row and the whole
    grid's rows."""
    f32 = np.dtype(dtype).type
    t = grid.tile
    xr = grid.x_rho.cpu().numpy().astype(f32)
    yr = (grid.y_rho if t is None else t.y_rho).cpu().numpy().astype(f32)
    head = np.zeros(Q_HEAD, f32)
    head[Q_X0] = xr[0]
    head[Q_DX] = xr[1] - xr[0]          # in dtype, as grid.locate
    head[Q_Y0] = yr[0]
    head[Q_DY] = yr[1] - yr[0]
    head[Q_HC] = grid.hc
    head[Q_Z0M] = z0m
    head[Q_SIGMA] = sigma
    lad = [a.cpu().numpy().astype(f32) for a in (grid.s_rho, grid.Cs_r,
                                                  grid.s_w, grid.Cs_w)]
    if t is not None:
        lad.append(np.array([t.row0, t.ny], f32))
    return torch.from_numpy(np.concatenate([head] + lad))


def _lib(variant: dict):
    fn = build.load("rk4_step", variant).ltx_rk4_step
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
    (float32 or float64 positions, float32 tables, any grid, sigma >= 0)
    or raise."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rk4_displacement_fused: unsupported device {dev}")
    _check(grid, vtabs, x, y, z)
    if dev.type == "cpu":
        return _plain(grid, vtabs, x, y, z, sigma, z0m, idt, stage1)
    if (x.dtype not in (torch.float32, torch.float64)
            or vtabs[0].full.dtype != torch.float32):
        raise ValueError("rk4_displacement_fused: the CUDA kernel takes "
                         "float32 or float64 positions and float32 tables, "
                         f"got {x.dtype} and {vtabs[0].full.dtype}")
    if float(sigma) < 0:
        raise NotImplementedError("rk4_displacement_fused: adaptive tension")
    us, ws = grid.us, grid.ws
    if us > MAX_LEVELS or ws > MAX_LEVELS:
        raise ValueError(f"rk4_displacement_fused: {us}/{ws} levels exceed "
                         f"MAX_LEVELS={MAX_LEVELS}")
    variant = kernel_variant(grid, x.dtype)
    npdt = np.float64 if x.dtype == torch.float64 else np.float32
    key = (id(grid), float(sigma), float(z0m), x.dtype)
    hit = _params_cache.get(key)
    if hit is None or hit[0]() is not grid:
        hit = (weakref.ref(grid), _device_tables(grid, float(sigma),
                                                 float(z0m), npdt, dev))
        _params_cache[key] = hit
    par, cxy, cseed, (c_mx, c_my), c_scal, axes = hit[1]
    n = x.shape[0]
    out = [torch.empty_like(x) for _ in range(5 if stage1 else 3)]
    if n == 0:
        return tuple(out)
    u1, v1 = ((out[3].data_ptr(), out[4].data_ptr()) if stage1
              else (None, None))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib(variant)(
        *(vt.full.data_ptr() for vt in vtabs), par.data_ptr(), x.data_ptr(),
        y.data_ptr(), z.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), u1, v1, n, grid.nx, grid.ny, us, ws,
        grid.vtransform, float(idt), _ptr(cxy), _ptr(cseed), c_mx, c_my,
        *c_scal, *(_ptr(a) for a in axes), stream)
    if rc != 0:
        raise RuntimeError(f"rk4_step kernel launch failed: CUDA error {rc}")
    rk4_displacement_fused.launches += 1
    tag = build.tag("rk4_step", variant)
    rk4_displacement_fused.variant_launches[tag] = (
        rk4_displacement_fused.variant_launches.get(tag, 0) + 1)
    return tuple(out)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _device_tables(grid, sigma, z0m, npdt, dev):
    """What the kernel reads besides the stage tables and the positions,
    on the device: the params vector, the curvilinear map (xy rows in the
    positions' dtype, the seed raster, its size and host scalars) and the
    searched rho axes (x_rho, y_rho), each None where the grid has none."""
    tdt = torch.float64 if npdt is np.float64 else torch.float32
    par = params_array(grid, sigma, z0m, npdt).to(dev)
    cxy = cseed = None
    size, scal = (0, 0), (0.0,) * 4
    if grid.curv is not None:
        cxy, cseed, size, scal = ext_step.curv_map(grid.curv, tdt)
        cxy, cseed = cxy.to(dev), cseed.to(dev)
    axes = (None, None)
    if grid.curv is None and not grid.uniform:
        yr = grid.y_rho if grid.tile is None else grid.tile.y_rho
        axes = (grid.x_rho.to(device=dev, dtype=tdt).contiguous(),
                yr.to(device=dev, dtype=tdt).contiguous())
    return par, cxy, cseed, size, scal, axes


rk4_displacement_fused.launches = 0     # every launch
rk4_displacement_fused.variant_launches = {}   # launches per variant
_params_cache = {}   # (id(grid), sigma, z0m, dtype) -> (weakref, tables)
