"""Whole-external-step kernel: CUDA kernel wrapper + plain version.

Counterpart of ``ltjax.kernels.ext_step.ext_step_fused`` (advection,
turbulence, behavior, mortality, settlement and salt lanes).
``ext_step_fused`` runs ``cfg.internal_steps`` internal steps of the
whole batch:

* on CUDA tensors it launches ``csrc/ext_step.cu`` (one thread per
  particle, the internal-step loop inside the thread) and counts the
  launch in ``ext_step_fused.launches`` and its staging (the blocks that
  staged their box in shared memory, those that ran from device memory,
  the lookups that left a staged box, the staged blocks that held one
  tile at a time) and the particle-steps its lanes ran
  (``active_steps``) in ``.counters``, read with ``counts``; the
  call is the span ``ltjax_torch.k1`` (``ltjax_torch.trace``);
* on CPU tensors it runs ``ext_step_reference``, the plain PyTorch
  version: a loop of ``step.internal_step`` (collapsed scheme).

The kernel is compiled once per combination of the options it covers
(``kernel_variant``: horizontal turbulence, vertical turbulence constant
or on the Aks profile, behavior type, mortality, settlement, salt
sampling, a curvilinear grid, float64 positions, searched axes), so each
configuration runs only its own lanes.  The particles' float columns
are float32 or float64 (``dtype_pos``): float64 takes the LTX_POS64
build, which keeps the particle state in float64 where the plain version
does (no column is cast).  On a curvilinear grid it also reads the
grid's inverse map (``curv_tables``: the rho xy rows in the positions'
dtype, the int32 seed raster and its scalars); on a rectilinear grid
whose rho axes or cell edges are not uniform, those axes
(``axes_tables``, the LTX_AXES build, which searches them).  It reads
the raw record table ``PackedRecords.tab`` (3, Ny*Nx, nl) f32 (the nv
value lanes, then the ws Aks lanes and the us salt + us temp lanes where
the table has them, at the offsets ``lane_offsets`` finds), the boundary
cell rows (Ny*Nx, 8 + 8*s_max) in the positions' dtype, the habitat and
hole polygons (``settle_tables``: f64 vertices, candidate rows per
cell), the per-step Threefry keys (``rng_keys_array``) and a small f32
params vector: the head scalars below, the s/Cs ladders, the quadratic
time weights of every (internal step, RK4 stage), computed on the host
in float64 (as ``ltjax.kernels.ext_step.finish_params`` does under x64)
and rounded to f32, and for behavior type 3 the surface irradiance of
every internal step.  Head scalars that the plain version computes in
the particles' dtype (turbulence scales, sinking, swim ramp) are
computed here the same way, in float32; with float64 positions the
same vector is also passed in float64 (``params_static(..., dtype)``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import rng
from .. import state as st
from ..interp import polintd_coefs
from ..packed import PackedRecords, n_value_lanes
from ..physics import behavior as bh
from ..trace import span, spanned
from . import build

MAX_LEVELS = 64   # compile-time level bound of the kernel (csrc MAX_LEVELS)

# params head layout (csrc/ext_step.cu enum P_*)
(P_X0, P_DX, P_Y0, P_DY, P_BX0, P_BDX, P_BY0, P_BDY, P_BX1, P_BY1, P_HC,
 P_Z0M, P_T0, P_IDT, P_SIGMA, P_HSCALE, P_VCONST, P_SINK, P_DEADAGE,
 P_SWIMSTART, P_SWIMDEN, P_SWIMSLOW, P_SWIMDIFF, P_KP, P_THRESH, P_HSWIM,
 P_SWIMDEPTH, P_PEDIAGE, P_SGRAD, P_ROW0, P_NYG) = range(31)
P_HEAD = 32

VTURB_OFF, VTURB_CONST, VTURB_AKS = 0, 1, 2
SWIM_TYPES = (1, 2, 3, 4, 5)   # behaviors drawing BEHAVE/MORTALITY words


def kernel_variant(cfg, curv: bool = False, pos64: bool = False,
                   axes: bool = False, tile: bool = False) -> dict:
    """The compile-time options of the kernel for a configuration on a
    rectilinear grid, or (``curv``) a curvilinear one, with float32 or
    (``pos64``) float64 positions, on uniform or (``axes``) searched
    rectilinear axes, on a whole grid or (``tile``) a tile's strip of a
    sharded run (the -D flags of csrc/ext_step.cu).  Settlement, salt
    sampling, the curvilinear map, float64 positions, searched axes and
    tiles appear only when on, so the variants without them build from
    the same flags as before they existed."""
    vt = (VTURB_OFF if not cfg.VTurbOn
          else VTURB_AKS if cfg.readAks else VTURB_CONST)
    out = {"LTX_HTURB": int(bool(cfg.HTurbOn)), "LTX_VTURB": vt,
           "LTX_BEHAVIOR": int(cfg.Behavior),
           "LTX_MORTALITY": int(bool(cfg.mortality))}
    if cfg.settlementon:
        out["LTX_SETTLE"] = 1
    if cfg.SaltTempOn:
        out["LTX_SALT"] = 1
    if curv:
        out["LTX_CURV"] = 1
    if pos64:
        out["LTX_POS64"] = 1
    if axes:
        out["LTX_AXES"] = 1
    if tile:
        out["LTX_TILE"] = 1
    return out


def variant_of(ctx, cfg, dtype) -> dict:
    """The kernel variant that runs ``cfg`` on ``ctx``'s grid with
    positions of ``dtype``: searched axes where the rectilinear grid's
    rho axes (grid.uniform) or its boundary cell edges (bounds.uniform)
    are not uniform; the tile build on a tile's strip (grid.tile)."""
    g, b = ctx.grid, ctx.bounds
    curv = g.curv is not None
    return kernel_variant(cfg, curv=curv, pos64=dtype == torch.float64,
                          axes=not curv and not (g.uniform and b.uniform),
                          tile=g.tile is not None)


def uses_rng(cfg) -> bool:
    return bool(cfg.HTurbOn or cfg.VTurbOn or cfg.Behavior in SWIM_TYPES)


def uses_age(cfg) -> bool:
    """The kernel carries the age itself (behavior, mortality and
    settlement read the pre-step age, as step.internal_step does)."""
    return bool(cfg.mortality or cfg.settlementon
                or cfg.Behavior in (1, 2, 3, 4, 5, 7))


def lane_offsets(nl: int, us: int, ws: int):
    """(aks0, salt0) of a record table with nl lanes: the first Aks lane
    (nv, or -1 without them) and the first salt lane (after the Aks
    lanes, or -1 without them; the us temp lanes follow the salt)."""
    nv = n_value_lanes(us, ws)
    layouts = {nv: (-1, -1), nv + ws: (nv, -1), nv + 2 * us: (-1, nv),
               nv + ws + 2 * us: (nv, nv + ws)}
    if nl not in layouts:
        raise ValueError(f"ext_step_fused: the record table has {nl} lanes; "
                         f"expected {nv} value lanes [+ {ws} Aks] "
                         f"[+ {2 * us} salt/temp]")
    return layouts[nl]


def params_static(ctx, cfg, dtype=np.float32) -> np.ndarray:
    """Head scalars + s/Cs ladders in ``dtype`` (float32, or float64 for
    the LTX_POS64 build), computed as the plain version computes them in
    the particles' dtype; once per context and options."""
    key = ("ext_step_params", np.dtype(dtype).name, float(cfg.z0),
           float(cfg.idt),
           float(cfg.tension_sigma), tuple(kernel_variant(cfg).items()),
           float(cfg.ConstantHTurb), float(cfg.ConstantVTurb),
           float(cfg.sink), float(cfg.deadage), float(cfg.swimstart),
           float(cfg.pediage), float(cfg.swimslow), float(cfg.swimfast),
           float(cfg.Kp), float(cfg.thresh), float(cfg.Hswimspeed),
           float(cfg.Swimdepth), float(cfg.Sgradient))
    if key in ctx.cache:
        return ctx.cache[key]
    g, b = ctx.grid, ctx.bounds
    f32 = np.dtype(dtype).type
    tdt = torch.float64 if f32 is np.float64 else torch.float32
    xr = g.x_rho.cpu().numpy().astype(f32)
    # a tile locates on the whole grid's y axis (LTX_TILE)
    yr = (g.y_rho if g.tile is None else g.tile.y_rho).cpu().numpy().astype(
        f32)
    bx0, bdx, by0, bdy, bx1, by1 = b.edges
    head = np.zeros(P_HEAD, f32)
    head[P_X0] = xr[0]
    head[P_DX] = xr[1] - xr[0]          # in dtype, as grid.locate
    head[P_Y0] = yr[0]
    head[P_DY] = yr[1] - yr[0]
    if g.tile is not None:
        head[P_ROW0] = g.tile.row0
        head[P_NYG] = g.tile.ny
    head[[P_BX0, P_BDX, P_BY0, P_BDY, P_BX1, P_BY1]] = (bx0, bdx, by0, bdy,
                                                       bx1, by1)
    head[P_HC] = g.hc
    head[P_Z0M] = cfg.z0
    head[P_IDT] = cfg.idt
    head[P_SIGMA] = cfg.tension_sigma
    # as physics.turb computes them in the particles' dtype
    idt_t = torch.tensor(float(cfg.idt), dtype=tdt)
    head[P_HSCALE] = torch.sqrt(2.0 * float(cfg.ConstantHTurb) * idt_t)
    head[P_VCONST] = torch.sqrt(
        2.0 * torch.tensor(float(cfg.ConstantVTurb), dtype=tdt)
        * idt_t / (1.0 / 3.0))
    head[P_SINK] = cfg.sink
    head[P_DEADAGE] = cfg.deadage
    head[P_SWIMSTART] = cfg.swimstart
    head[P_SWIMDEN] = max(cfg.pediage - cfg.swimstart, 1e-30)
    head[P_SWIMSLOW] = cfg.swimslow
    head[P_SWIMDIFF] = cfg.swimfast - cfg.swimslow
    head[P_KP] = cfg.Kp
    head[P_THRESH] = cfg.thresh
    head[P_HSWIM] = cfg.Hswimspeed
    head[P_SWIMDEPTH] = cfg.Swimdepth
    head[P_PEDIAGE] = cfg.pediage
    head[P_SGRAD] = cfg.Sgradient
    lad = [t.cpu().numpy().astype(f32) for t in (g.s_rho, g.Cs_r, g.s_w,
                                                  g.Cs_w)]
    out = np.concatenate([head] + lad)
    ctx.cache[key] = out
    return out


def finish_params(static: np.ndarray, t0: float, times, idt: float,
                  n_int: int, dvm=None) -> np.ndarray:
    """Append the start time and the polintd weights of every internal
    step's 3 stage times (t, t + idt/2, t + idt): 9 per step.  ``dvm``
    (BehaveParams) appends the surface irradiance of every internal step
    (behavior type 3), computed as the plain version computes it.  In
    static's dtype (the kernel reads the weights from the float32 vector
    only)."""
    dtype = static.dtype
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    head = static.copy()
    head[P_T0] = t0
    coef = [polintd_coefs(times, t0 + i * idt + off)
            for i in range(n_int) for off in (0.0, 0.5 * idt, idt)]
    parts = [head, np.asarray(coef, np.float64).reshape(-1)
             .astype(np.float32).astype(dtype)]
    if dvm is not None:
        t_i = torch.tensor([t0 + i * idt for i in range(n_int)], dtype=tdt)
        parts.append(bh.surface_irradiance(t_i, dvm, tdt).numpy()
                     .astype(dtype))
    return np.concatenate(parts)


def rng_keys_array(seed, ext_idx: int, n_int: int,
                   behave: bool = False) -> np.ndarray:
    """(n_int * 4 [or 8],) uint32: the derived Threefry key pairs of the
    HTURB and VTURB substreams for every internal step of external step
    ``ext_idx`` (``rng.stream_key(seed, ext_idx*n_int + i, sub)``; the
    layout of ltjax.kernels.ext_step.rng_keys_array).  ``behave`` appends
    the BEHAVE and MORTALITY pairs (behavior types 1-5)."""
    k0, k1 = rng.seed_words(seed)
    steps = int(ext_idx) * int(n_int) + torch.arange(n_int)
    subs = [rng.HTURB, rng.VTURB]
    if behave:
        subs += [rng.BEHAVE, rng.MORTALITY]
    # every (step, substream) pair in one Threefry call: (n_int, S) words
    step, sub = torch.broadcast_tensors(steps[:, None],
                                        torch.tensor(subs)[None, :])
    s0, s1 = rng.threefry2x32(k0, k1, step, sub)
    return torch.stack([s0, s1], dim=-1).reshape(-1).numpy().astype(np.uint32)


def boundary_rows_table(ctx, dtype=torch.float32) -> torch.Tensor:
    """(Ny*Nx, 8 + 8*s_max) boundary cell rows in the positions' dtype
    (reflect's), once per context and dtype; on a tile of a sharded run
    the rows of its strip (``grid.tile.rows``, clipped row indices: rim
    tiles edge-replicate)."""
    key = ("brows", dtype)
    if key not in ctx.cache:
        rows = ctx.bounds.cell_rows
        tile = ctx.grid.tile
        if tile is not None:
            ny, nx = ctx.bounds.water.shape
            rows = rows.view(ny, nx, -1)[tile.rows].reshape(
                -1, rows.shape[1])
        ctx.cache[key] = rows.to(dtype).contiguous()
    return ctx.cache[key]


def curv_map(cm, dtype=torch.float32):
    """A CurvMap as both kernels read it (csrc/curv.cuh): the (Ny*Nx, 2)
    rho xy rows in the positions' dtype, the int32 seed raster (seed_i
    then seed_j, each (My, Mx) flat), (Mx, My), and the host floats (rx0,
    ry0, inv_rdx, inv_rdy) that the kernels take in that dtype."""
    my, mx = cm.seed_i.shape
    return (cm.xy_flat.to(dtype).contiguous(),
            torch.cat([cm.seed_i.reshape(-1), cm.seed_j.reshape(-1)]
                      ).to(torch.int32).contiguous(), (mx, my),
            (cm.rx0, cm.ry0, cm.inv_rdx, cm.inv_rdy))


def curv_tables(ctx, dtype=torch.float32):
    """The curvilinear map as this kernel reads it, once per context and
    dtype: ``curv_map``'s tables, the host floats followed by the
    boundaries' curv_tol2."""
    key = ("curv", dtype)
    if key in ctx.cache:
        return ctx.cache[key]
    b = ctx.bounds
    if b.curv is None or b.curv_tol2 is None:
        raise ValueError("ext_step_fused: a curvilinear grid needs "
                         "curvilinear boundaries (build_boundaries_curv)")
    xy, seeds, size, scal = curv_map(ctx.grid.curv, dtype)
    out = (xy, seeds, size, scal + (b.curv_tol2,))
    ctx.cache[key] = out
    return out


def axes_tables(ctx, dtype=torch.float32):
    """The searched axes of the LTX_AXES build, once per context and
    dtype: the rho axes (x_rho, y_rho) where the grid is not uniform, the
    boundary cell edges in the positions' dtype (boundary.cell_of's) and
    in float64 (settlement's) where they are not; each pair None where
    uniform (the kernel then locates arithmetically)."""
    key = ("axes", dtype)
    if key in ctx.cache:
        return ctx.cache[key]
    g, b = ctx.grid, ctx.bounds

    def pair(u, v, dt):
        return (u.to(dt).contiguous(), v.to(dt).contiguous())

    # a tile searches the whole grid's axes (LTX_TILE)
    yr = g.y_rho if g.tile is None else g.tile.y_rho
    out = (None if g.uniform else pair(g.x_rho, yr, dtype),
           None if b.uniform else pair(b.x_edges, b.y_edges, dtype),
           None if b.uniform else pair(b.x_edges, b.y_edges, torch.float64))
    ctx.cache[key] = out
    return out


def settle_tables(ctx):
    """The habitat polygons and holes as the kernel reads them, once per
    context: (f64 table, int32 table, (n, vmax, cmax) of the polygons,
    the same of the holes), or None without polygons.  The f64 table is
    the cell-edge lattice (x0, dx, y0, dy), then each set's vertices (x,
    then y); the int32 table each set's vertex counts, ids and candidate
    rows, polygons first (csrc/ext_step.cu ltx_ext_step)."""
    if ctx.polys is None:
        return None
    if "settle" in ctx.cache:
        return ctx.cache["settle"]
    ny, nx = ctx.bounds.water.shape
    dev = ctx.grid.device
    x0, dx, y0, dy, _, _ = ctx.bounds.edges
    tile = ctx.grid.tile
    dbl = [torch.tensor([x0, dx, y0, dy], dtype=torch.float64)]
    ints, dims = [], []
    for ps in (ctx.polys, ctx.holes):
        if ps is None:
            dims.append((0, 1, 1))
            continue
        if tuple(ps.cell_cands.shape[:2]) != (ny, nx):
            raise ValueError("settle_tables: candidate rows must cover the "
                             f"({ny}, {nx}) cell lattice")
        cands = ps.cell_cands.cpu()
        if tile is not None:
            cands = cands[tile.rows.cpu()]       # the strip's rows
        dbl += [ps.verts_x.cpu().reshape(-1), ps.verts_y.cpu().reshape(-1)]
        ints += [ps.nverts.cpu(), ps.poly_id.cpu(), cands.reshape(-1)]
        dims.append((ps.n_polys, ps.verts_x.shape[1],
                     ps.cell_cands.shape[2]))
    out = (torch.cat([d.to(torch.float64) for d in dbl]).to(dev),
           torch.cat([i.to(torch.int32) for i in ints]).to(dev), *dims)
    ctx.cache["settle"] = out
    return out


# The staged corner source (csrc ext_step.cu): a block of BLOCK threads
# stages at most STAGE_POINTS rho points in three tiles, and at most
# STAGE_BYTES of shared memory, per internal step; a box of up to three
# times those points is staged split, one tile at a time in the same
# bytes.
BLOCK = 128
STAGE_POINTS = 36        # a 6 x 6 box: 2 x 2 cells and the margin
STAGE_BYTES = 48 * 1024


def tile_lanes(nl: int) -> int:
    """Floats per rho point in a tile: the table's nl lanes, padded to an
    odd count so that the points that the threads of a warp read fall in
    different banks."""
    return nl | 1


def tile_points(nl: int) -> int:
    """Rho points a block may stage: STAGE_POINTS, or fewer where three
    tiles (t, t + idt/2, t + idt) of that many points would exceed
    STAGE_BYTES."""
    return min(STAGE_POINTS, STAGE_BYTES // (3 * 4 * tile_lanes(nl)))


def stage_bytes(nl: int) -> int:
    """The dynamic shared memory of a launch: three tiles of
    tile_points(nl) points, or one split tile of three times that."""
    return 3 * 4 * tile_lanes(nl) * tile_points(nl)


def block_boxes(grid, x, y, status=None, nl: int = 0,
                block: int = BLOCK) -> dict:
    """Each block's staged box, as the kernels size it (plain PyTorch).

    Block b holds particles [b*block, (b+1)*block).  Its box is the rho
    points of the cells (``grid.locate_rho_ij``) of its ACTIVE particles
    (``status`` None: all), grown by one cell on each side and clipped to
    the grid: points i0..i1 x j0..j1 (inclusive; -1 for a block with no
    active particle).  ``points`` is the box's size, ``nbytes`` the shared
    memory of its three tiles (3 x points x tile_lanes(nl) x 4 bytes),
    ``fits`` whether it is within the launch's tile_points(nl) (three
    tiles), and ``split`` whether it does not fit but is within three
    times that (one tile at a time, in the launch's stage_bytes(nl)): a
    live block in neither runs from global memory."""
    from ..grid import locate_rho_ij
    n = x.shape[0]
    nb = -(-n // block)
    i, j, _, _ = locate_rho_ij(grid, x, y)
    act = (torch.ones(n, dtype=torch.bool, device=x.device)
           if status is None else status == st.ACTIVE)
    pad = nb * block - n

    def blocks(v, fill):
        v = torch.where(act, v.to(torch.int64), fill)
        return torch.nn.functional.pad(v, (0, pad), value=fill).view(nb,
                                                                     block)
    big = 1 << 40
    live = torch.nn.functional.pad(act, (0, pad)).view(nb, block).any(1)
    i0 = (blocks(i, big).amin(1) - 1).clamp(min=0)
    i1 = (blocks(i, -1).amax(1) + 2).clamp(max=grid.nx - 1)
    j0 = (blocks(j, big).amin(1) - 1).clamp(min=0)
    j1 = (blocks(j, -1).amax(1) + 2).clamp(max=grid.ny - 1)
    points = torch.where(live, (i1 - i0 + 1) * (j1 - j0 + 1), 0)
    neg = torch.full_like(i0, -1)
    return {"i0": torch.where(live, i0, neg), "i1": torch.where(live, i1, neg),
            "j0": torch.where(live, j0, neg), "j1": torch.where(live, j1, neg),
            "live": live, "points": points,
            "nbytes": 3 * 4 * tile_lanes(nl) * points,
            "fits": live & (points <= tile_points(nl)),
            "split": live & (points > tile_points(nl))
            & (points <= 3 * tile_points(nl))}


def ext_step_reference(ctx, cfg, p: st.Particles, prec: PackedRecords,
                       t0: float, fields=None, seed=None,
                       ext_idx: int = 0) -> st.Particles:
    """Plain PyTorch version: cfg.internal_steps internal steps of the
    collapsed scheme (any device, any float dtype).  ``fields`` is the
    3-record window (needed for vertical turbulence on Aks, salt
    sampling and behaviors 4/5); ``ctx.polys``/``ctx.holes`` are the
    habitat polygons."""
    from ..step import internal_step
    if fields is None and ((cfg.VTurbOn and cfg.readAks)
                           or cfg.needs_salt_fields()):
        raise ValueError("ext_step_reference: VTurbOn with readAks, "
                         "SaltTempOn and behaviors 4/5 need the 3-record "
                         "FieldSet")
    seed = cfg.seed if seed is None else seed
    idt = float(cfg.idt)
    n_int = cfg.internal_steps
    for i in range(n_int):
        p = internal_step(ctx, cfg, seed, p, fields, t0 + i * idt,
                          int(ext_idx) * n_int + i, prec)
    return p


_C_ARGTYPES = ([ctypes.c_void_p] * 27 + [ctypes.c_int] * 19
               + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
               + [ctypes.c_double] * 5 + [ctypes.c_int]
               + [ctypes.c_void_p] * 8)
# the device counters: the staging counters (staged_block_steps counts
# the split ones too), then the particle-steps the lanes ran (the threads
# ACTIVE after each internal step's release)
COUNTERS = ("staged_block_steps", "global_block_steps", "staged_misses",
            "split_block_steps", "active_steps")


def _counters(dev) -> torch.Tensor:
    """The device counters on device ``dev`` (int64, in COUNTERS order),
    made zero at first use; every launch adds to them there."""
    t = ext_step_fused.counters.get(dev)
    if t is None:
        t = ext_step_fused.counters[dev] = torch.zeros(
            len(COUNTERS), dtype=torch.int64, device=dev)
    return t


def counts() -> dict:
    """The device counters of the launches since reset_launches, summed
    over devices (a host read: it waits for those launches)."""
    tot = [0] * len(COUNTERS)
    for t in ext_step_fused.counters.values():
        tot = [a + int(b) for a, b in zip(tot, t.tolist())]
    return dict(zip(COUNTERS, tot))


def _lib(variant: dict):
    lib = build.load("ext_step", variant)
    fn = lib.ltx_ext_step
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(variant: dict, nl: int) -> int:
    """Blocks of a variant that one SM holds when each stages
    tile_points(nl) points (CUDA's occupancy calculator; builds the
    library)."""
    fn = build.load("ext_step", variant).ltx_ext_step_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(nl, tile_points(nl))


def _check_col(name, v, n, dtype, dev):
    if v.dtype != dtype or v.device != dev or v.shape != (n,) \
            or not v.is_contiguous():
        raise ValueError(f"ext_step_fused: {name} must be a contiguous "
                         f"({n},) {dtype} tensor on {dev}")


@spanned("ltjax_torch.k1")
def ext_step_fused(ctx, cfg, p: st.Particles, prec: PackedRecords,
                   t0: float, fields=None, seed=None,
                   ext_idx: int = 0) -> st.Particles:
    """One external step (cfg.internal_steps internal steps) of RK4
    advection, turbulence, behavior, reflection, settlement, salt
    sampling and status bookkeeping for the whole batch; ``ext_idx`` and
    ``seed`` (default cfg.seed) key the random draws.

    CPU tensors take ``ext_step_reference``; CUDA tensors launch the
    kernel (float32 or float64 positions, any grid) or raise.
    Stochastic mortality raises on both: the kernel draws no DEATH
    words."""
    if cfg.mortality and cfg.stochastic_mortality:
        # its DEATH draw is not in the kernel's key layout (step.mode_flags)
        raise ValueError("ext_step_fused: stochastic_mortality takes the "
                         "per-step route (step.per_step_external)")
    dev = p.x.device
    if dev.type == "cpu":
        return ext_step_reference(ctx, cfg, p, prec, t0, fields, seed,
                                  ext_idx)
    if dev.type != "cuda":
        raise ValueError(f"ext_step_fused: unsupported device {dev}")
    g, b = ctx.grid, ctx.bounds
    n, us, ws = p.n, g.us, g.ws
    bh.check_ported(bh.BehaveParams(behavior=cfg.Behavior))
    curv = g.curv is not None
    pdt = p.x.dtype
    if pdt not in (torch.float32, torch.float64):
        raise ValueError(f"ext_step_fused: positions must be float32 or "
                         f"float64, got {pdt}")
    variant = variant_of(ctx, cfg, pdt)
    # the Visser lanes read the Aks lanes; sampling and behaviors 4/5
    # the salt (and temp) lanes
    nl = prec.tab.shape[-1]
    aks0, salt0 = lane_offsets(nl, us, ws)
    if variant["LTX_VTURB"] == VTURB_AKS and aks0 < 0:
        raise ValueError(f"ext_step_fused: Visser on Aks needs the {ws} "
                         f"Aks lanes (build_packed_records(with_aks=True))")
    if cfg.needs_salt_fields() and salt0 < 0:
        raise ValueError(f"ext_step_fused: SaltTempOn and behaviors 4/5 "
                         f"need the {2 * us} salt/temp lanes "
                         f"(build_packed_records(with_scalars=True))")
    if ws > MAX_LEVELS or us > MAX_LEVELS:
        raise ValueError(f"ext_step_fused: {us}/{ws} levels exceed "
                         f"MAX_LEVELS={MAX_LEVELS}")
    if float(cfg.tension_sigma) < 0:
        raise NotImplementedError("ext_step_fused: adaptive tension")
    for k in ("x", "y", "z", "dob", "age", "salt", "temp"):
        _check_col(k, getattr(p, k), n, pdt, dev)
    for k in ("status", "pid", "settle_poly"):
        _check_col(k, getattr(p, k), n, torch.int32, dev)
    tab = prec.tab
    if (tab.dtype != torch.float32 or tab.device != dev
            or tuple(tab.shape) != (3, g.ny * g.nx, nl)
            or not tab.is_contiguous()):
        raise ValueError(f"ext_step_fused: record table must be a "
                         f"contiguous (3, {g.ny * g.nx}, {nl}) float32 "
                         f"tensor on {dev}, got {tuple(tab.shape)} "
                         f"{tab.dtype} on {tab.device}")
    brows = boundary_rows_table(ctx, pdt)
    if brows.device != dev:
        raise ValueError("ext_step_fused: boundaries on another device")
    settle = settle_tables(ctx) if cfg.settlementon else None
    if settle is not None and settle[0].device != dev:
        raise ValueError("ext_step_fused: polygons on another device")
    cxy, cseed, (c_mx, c_my), c_scal = (
        curv_tables(ctx, pdt) if curv else (None, None, (0, 0), (0.0,) * 5))
    if curv and cxy.device != dev:
        raise ValueError("ext_step_fused: curvilinear map on another device")
    axes = ((None,) * 3 if "LTX_AXES" not in variant
            else axes_tables(ctx, pdt))
    if any(a is not None and a[0].device != dev for a in axes):
        raise ValueError("ext_step_fused: grid axes on another device")
    n_int = cfg.internal_steps
    idt = float(cfg.idt)
    if n == 0:
        return p
    seed = cfg.seed if seed is None else seed
    dvm = None
    if cfg.Behavior == 3:
        from ..step import make_params
        dvm = make_params(cfg)[1]
    par = finish_params(params_static(ctx, cfg), t0, prec.times, idt,
                        n_int, dvm)
    dpar = (finish_params(params_static(ctx, cfg, np.float64), t0,
                          prec.times, idt, n_int, dvm)
            if pdt == torch.float64 else None)
    rngk = (rng_keys_array(seed, ext_idx, n_int,
                           behave=cfg.Behavior in SWIM_TYPES).view(np.int32)
            if uses_rng(cfg) else None)
    with span("ltjax_torch.k1.upload"):
        par, dpar, rngk = (None if a is None else torch.from_numpy(a).to(dev)
                           for a in (par, dpar, rngk))
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

    def ptr(t):
        return t.data_ptr() if t is not None else None

    stream = torch.cuda.current_stream(dev).cuda_stream
    ax_ptrs = [ptr(t) for pair in axes for t in (pair or (None, None))]
    rc = _lib(variant)(
        tab.data_ptr(), brows.data_ptr(), par.data_ptr(), ptr(dpar),
        ptr(rngk),
        p.x.data_ptr(), p.y.data_ptr(), p.z.data_ptr(), p.dob.data_ptr(),
        p.age.data_ptr(), p.pid.data_ptr(), p.status.data_ptr(),
        p.settle_poly.data_ptr(), p.salt.data_ptr(), p.temp.data_ptr(),
        x_o.data_ptr(), y_o.data_ptr(), z_o.data_ptr(), age_o.data_ptr(),
        st_o.data_ptr(), hitl.data_ptr(), hitb.data_ptr(), ptr(spoly_o),
        ptr(salt_o), ptr(temp_o), ptr(sd), ptr(si), n, g.nx, g.ny, us, ws,
        nl, aks0, salt0, g.vtransform, n_int, int(cfg.reflect_iters),
        int(bool(cfg.OpenOceanBoundary)), b.s_max, n_p, v_p, c_p, n_h, v_h,
        c_h, ptr(cxy), ptr(cseed), c_mx, c_my, *c_scal, tile_points(nl),
        _counters(dev).data_ptr(), *ax_ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"ext_step kernel launch failed: CUDA error {rc}")
    ext_step_fused.launches += 1
    key = build.tag("ext_step", variant)
    ext_step_fused.variant_launches[key] = (
        ext_step_fused.variant_launches.get(key, 0) + 1)
    if not uses_age(cfg):
        # the advection-only lanes do not carry the age: every particle
        # released by the end of the step is t_end - dob old
        t_end = t0 + n_int * idt
        age_o = torch.where(st_o >= st.ACTIVE, t_end - p.dob, p.age)
    out = p.replace(x=x_o, y=y_o, z=z_o, status=st_o, age=age_o)
    if cfg.settlementon:
        out = out.replace(settle_poly=spoly_o)
    if cfg.SaltTempOn:
        out = out.replace(salt=salt_o, temp=temp_o)
    if cfg.TrackCollisions:
        out = out.replace(hit_land=p.hit_land + hitl,
                          hit_bottom=p.hit_bottom + hitb)
    return out


ext_step_fused.launches = 0             # every launch
ext_step_fused.variant_launches = {}    # launches per compiled variant
ext_step_fused.counters = {}            # device -> device counters


def reset_launches() -> None:
    """Zero the launch counts and the device counters (on the device, no
    wait)."""
    ext_step_fused.launches = 0
    ext_step_fused.variant_launches = {}
    for t in ext_step_fused.counters.values():
        t.zero_()
