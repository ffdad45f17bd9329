"""Sharded runs: particle data-parallelism x eta-strip domain tiles, with
particle migration (counterpart of ``ltjax.shard``).

The mesh has ``mesh_particles`` (dp) x ``mesh_tiles`` (tile) ranks, one
process each (``ltjax_torch.dist``); rank r holds tile r % ntiles of
data-parallel row r // ntiles.

* ``tile`` cuts the domain into eta strips of ``ny_loc`` rho rows.  A
  rank reads the rows of its strip plus ``halo`` rows on each side from
  the history files (``strip_rows``), rows outside the grid
  edge-replicated (``strip_index``): the rows that ltjax's in-step halo
  exchange (``_halo_extend``) assembles, read instead of exchanged, so
  no collective moves fields.  The halo covers the farthest a particle
  moves in one external step plus the stencil (``halo_rows_needed``).
* Each rank's particles live in a fixed-capacity buffer of ``cap``
  slots; unoccupied slots have status ``EMPTY`` (-1), which no lane
  releases or moves.  After each external step, particles whose y left
  the strip are sent to their owner tile in one ``all_to_all`` over the
  ranks of the data-parallel row, at most ``mig_cap`` to each (``migrate``,
  ltjax's ``_migrate``; on the card the hand-written kernels of
  ``kernels/migrate.py``): leavers beyond ``mig_cap`` stay home flagged
  ERROR, arrivals beyond ``cap`` are dropped, both counted.
* A tile steps on the route that the configuration takes on one device
  (``step.mode_flags``: the whole-step kernel K1, the per-step route with
  K2 and K3, the native route or the packed route) with a local Grid of its strip, and the whole
  grid's boundaries and polygons (the kernels read their strip's rows).
  Every cell is located on the whole grid's axes and then moved into the
  strip (``grid.TileRows``, ``grid.locate_y``; the kernels' LTX_TILE
  builds): the same operations on the same values as the unsharded run,
  so a tiled run reproduces it bit for bit (tests/test_torch_shard.py).

Curvilinear grids shard over particles only (mesh_tiles = 1): every rank
holds the whole grid and no particle migrates.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from . import dist
from . import spatial as sp
from . import state as st
from .config import Config
from .fields import FieldSet
from .grid import Grid, TileRows
from .step import (StepContext, _sort, mode_flags, packed_window,
                   route_step)
from .trace import reset_counters, span

EMPTY = -1  # status code for an unoccupied particle slot

FLOATS = ("x", "y", "z", "dob", "age", "salt", "temp")
INTS = ("status", "pid", "settle_poly", "hit_land", "hit_bottom")


class TileSpec(NamedTuple):
    """Static decomposition parameters."""
    ndp: int          # particle-DP mesh axis size
    ntiles: int       # domain-tile mesh axis size (eta strips)
    halo: int         # halo rows per side (must cover max displacement
                      #   per external step + the interpolation stencil)
    ny_loc: int       # owned rho rows per tile (global pad = ntiles*ny_loc)
    cap: int          # particle slots per (dp, tile) shard
    mig_cap: int      # migration slots per destination tile

    @property
    def ny_pad(self) -> int:
        return self.ntiles * self.ny_loc

    @property
    def ny_ext(self) -> int:
        return self.ny_loc + 2 * self.halo


def make_spec(cfg: Config, ny: int, numpar: int, ndp: int, ntiles: int,
              halo: int = 4, slack: float = 1.5) -> TileSpec:
    ny_loc = -(-ny // ntiles)
    cap = max(8, int(np.ceil(numpar * slack / (ndp * ntiles))))
    mig_cap = max(8, cap // 4)
    return TileSpec(ndp=ndp, ntiles=ntiles, halo=halo, ny_loc=ny_loc,
                    cap=cap, mig_cap=mig_cap)


def halo_rows_needed(v_max: float, dt: float, dy_min: float) -> int:
    """Halo rows covering the worst-case displacement in one external
    step (particles only migrate between external steps, so within one
    they may interpolate up to v_max*dt past their strip) plus one row
    of interpolation stencil."""
    return int(np.ceil(v_max * dt / dy_min)) + 1


# ---------------------------------------------------------------------------
# eta padding / per-tile static-grid construction (host-side numpy, once)
# ---------------------------------------------------------------------------

def _extend_axis(ax: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Continue a strictly increasing axis by lo/hi rows of edge spacing."""
    d0 = ax[1] - ax[0]
    d1 = ax[-1] - ax[-2]
    below = ax[0] + d0 * np.arange(-lo, 0)
    above = ax[-1] + d1 * np.arange(1, hi + 1)
    return np.concatenate([below, ax, above])


def pad_eta(arr: np.ndarray, eta_axis: int, ny_pad: int) -> np.ndarray:
    """Edge-replicate an array's eta axis up to ny_pad rows.

    Edge replication (not zeros) preserves the unsharded engine's
    clamp-at-rim interpolation semantics exactly.
    """
    n = arr.shape[eta_axis]
    if n >= ny_pad:
        return arr
    pads = [(0, 0)] * arr.ndim
    pads[eta_axis] = (0, ny_pad - n)
    return np.pad(arr, pads, mode="edge")


class TiledStatic(NamedTuple):
    """Per-tile static grid data (leading axis = tile) plus the
    tile-ownership edges, host numpy."""
    y_rho_t: np.ndarray     # (ntiles, ny_ext)
    y_v_t: np.ndarray       # (ntiles, ny_ext)
    h_t: np.ndarray         # (ntiles, ny_ext, nx)
    mask_rho_t: np.ndarray  # (ntiles, ny_ext, nx)
    mask_u_t: np.ndarray    # (ntiles, ny_ext, nx-1)
    mask_v_t: np.ndarray    # (ntiles, ny_ext, nx)
    tile_edges: np.ndarray  # (ntiles+1,) y ownership boundaries


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_tiled_static(grid: Grid, spec: TileSpec) -> TiledStatic:
    """Precompute per-tile extended grid strips (numpy, once at init)."""
    H, ny_loc, ntiles = spec.halo, spec.ny_loc, spec.ntiles
    ny_pad = spec.ny_pad
    y_rho = _np(grid.y_rho)
    dtype = y_rho.dtype

    y_pad = pad_eta(y_rho, 0, ny_pad)
    # keep the padded axis strictly increasing (pad_eta replicates the
    # last coordinate; continue it uniformly instead)
    ny = grid.ny
    if ny_pad > ny:
        d = y_pad[ny - 1] - y_pad[ny - 2]
        y_pad[ny:] = y_pad[ny - 1] + d * np.arange(1, ny_pad - ny + 1)
    y_ext = _extend_axis(y_pad, H, H)                       # (ny_pad+2H,)

    # v axis: midpoints of the padded rho axis, padded to ny_pad rows,
    # then extended — aligned with the identically padded v field rows.
    y_v = 0.5 * (y_pad[1:] + y_pad[:-1])                    # (ny_pad-1,)
    y_v_pad = np.concatenate([y_v, [y_v[-1] + (y_v[-1] - y_v[-2])]])
    y_v_ext = _extend_axis(y_v_pad, H, H)

    def ext_rows(a):
        return np.pad(pad_eta(_np(a), 0, ny_pad), ((H, H), (0, 0)),
                      mode="edge")

    ny_ext = spec.ny_ext

    def strips(a):
        return np.stack([a[t * ny_loc: t * ny_loc + ny_ext]
                         for t in range(ntiles)])

    # ownership edges: cell-edge midpoints at strip boundaries; the
    # outermost edges are +-inf so clipping covers the whole real line
    edges = np.empty(ntiles + 1, dtype)
    edges[0] = -np.inf
    edges[-1] = np.inf
    for t in range(1, ntiles):
        r = t * ny_loc
        edges[t] = 0.5 * (y_pad[r - 1] + y_pad[r])

    return TiledStatic(
        y_rho_t=strips(y_ext), y_v_t=strips(y_v_ext),
        h_t=strips(ext_rows(grid.h)),
        mask_rho_t=strips(ext_rows(grid.mask_rho)).astype(np.int32),
        mask_u_t=strips(ext_rows(grid.mask_u)).astype(np.int32),
        mask_v_t=strips(ext_rows(grid.mask_v)).astype(np.int32),
        tile_edges=edges)


def strip_rows(spec: TileSpec, tile: int, ny: int):
    """The rho rows [a, b) that a rank of ``tile`` reads from every record
    (ltjax's ``process_tile_rows`` for one rank, halo included): its
    strip with the halo, clipped to the grid, at least two rows (so that
    the v axis, one row shorter, keeps one)."""
    r0 = tile * spec.ny_loc - spec.halo
    a = int(np.clip(r0, 0, ny - 2))
    b = int(np.clip(r0 + spec.ny_ext, a + 2, ny))
    return a, b


def strip_index(spec: TileSpec, tile: int, n: int, a: int = 0) -> np.ndarray:
    """(ny_ext,) indices into rows [a, ...) of an eta axis of n rows (rho:
    ny, v: ny - 1) that give the tile's strip: row r of the extended grid
    is row clip(r, 0, n - 1), the edge replication of ltjax's padding
    and halo exchange."""
    r0 = tile * spec.ny_loc - spec.halo
    return np.clip(np.arange(r0, r0 + spec.ny_ext), 0, n - 1) - a


def strip_record(rec: dict, spec: TileSpec, tile: int, ny: int,
                 a: int) -> dict:
    """A record dict of rows [a, b) (``RomsSeries(eta_slice=strip_rows)``,
    ROMS ([K,] eta, xi) layout) as the tile's strip of ny_ext rows; v
    (one row shorter) takes the v indices."""
    idx_r = strip_index(spec, tile, ny, a)
    idx_v = strip_index(spec, tile, ny - 1, a)
    out = {}
    for k, v in rec.items():
        if isinstance(v, np.ndarray) and v.ndim >= 2:
            v = np.take(v, idx_v if k == "v" else idx_r, axis=-2)
        out[k] = v
    return out


def strip_fieldset(fs: FieldSet, spec: TileSpec, tile: int,
                   ny: int) -> FieldSet:
    """The tile's strip of a whole-grid FieldSet (K-last layout, eta axis
    1): the fields a rank of ``tile`` reads from the files."""
    dev = fs.u.device
    idx_r = torch.as_tensor(strip_index(spec, tile, ny), device=dev)
    idx_v = torch.as_tensor(strip_index(spec, tile, ny - 1), device=dev)

    def take(a, idx):
        return a.index_select(1, idx).contiguous()

    return FieldSet(zeta=take(fs.zeta, idx_r), u=take(fs.u, idx_r),
                    v=take(fs.v, idx_v), w=take(fs.w, idx_r),
                    aks=take(fs.aks, idx_r), salt=take(fs.salt, idx_r),
                    temp=take(fs.temp, idx_r), times=fs.times)


# ---------------------------------------------------------------------------
# the tile context
# ---------------------------------------------------------------------------

def tile_context(ctx: StepContext, spec: TileSpec, tiled: TiledStatic,
                 tile: int) -> StepContext:
    """The StepContext of one tile (ltjax's per-tile local Grid): the
    strip's grid (the whole grid's x axis and ladders, the tile's y axes,
    depths and masks, and ``tile``: where the strip lies in the whole
    grid, whose axes locate the cells), the whole grid's boundaries and
    polygons (the kernels read the strip's rows of their tables).  One
    context per tile, so that the kernels' tables cached in ``ctx.cache``
    are the tile's.  A curvilinear grid is not tiled: its context is
    returned as it is."""
    grid = ctx.grid
    if grid.curv is not None:
        if spec.ntiles != 1:
            raise NotImplementedError("curvilinear grids shard over the "
                                      "particle axis only (mesh_tiles = 1)")
        return ctx
    dev, dt = grid.device, grid.dtype

    def t_(a, dtype=dt):
        return torch.as_tensor(np.ascontiguousarray(a[tile]), dtype=dtype,
                               device=dev)

    rows = TileRows(row0=tile * spec.ny_loc - spec.halo, ny=grid.ny,
                    y_rho=grid.y_rho, y_v=grid.y_v,
                    rows=torch.as_tensor(strip_index(spec, tile, grid.ny),
                                         device=dev))
    loc = Grid(x_rho=grid.x_rho, y_rho=t_(tiled.y_rho_t), x_u=grid.x_u,
               y_v=t_(tiled.y_v_t), h=t_(tiled.h_t),
               mask_rho=t_(tiled.mask_rho_t, torch.int32),
               mask_u=t_(tiled.mask_u_t, torch.int32),
               mask_v=t_(tiled.mask_v_t, torch.int32), s_rho=grid.s_rho,
               Cs_r=grid.Cs_r, s_w=grid.s_w, Cs_w=grid.Cs_w, hc=grid.hc,
               vtransform=grid.vtransform, uniform=grid.uniform, tile=rows)
    return StepContext(grid=loc, bounds=ctx.bounds, polys=ctx.polys,
                       holes=ctx.holes)


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def pack_rows(p: st.Particles) -> torch.Tensor:
    """(n, B) uint8 rows of the 12 columns (the float columns in the
    positions' dtype, then the int32 columns): what a collective moves."""
    fl = torch.stack([getattr(p, k) for k in FLOATS], 1)
    it = torch.stack([getattr(p, k).to(torch.int32) for k in INTS], 1)
    return torch.cat([fl.contiguous().view(torch.uint8),
                      it.contiguous().view(torch.uint8)], 1)


def unpack_rows(rows: torch.Tensor, dtype) -> st.Particles:
    """The inverse of ``pack_rows`` for positions of ``dtype``."""
    nb = torch.finfo(dtype).bits // 8 * len(FLOATS)
    fl = rows[:, :nb].contiguous().view(dtype)
    it = rows[:, nb:].contiguous().view(torch.int32)
    cols = {k: fl[:, i].contiguous() for i, k in enumerate(FLOATS)}
    cols.update({k: it[:, i].contiguous() for i, k in enumerate(INTS)})
    return st.Particles(**cols)


def _status_of(rows: torch.Tensor, dtype) -> torch.Tensor:
    nb = torch.finfo(dtype).bits // 8 * len(FLOATS)
    return rows[:, nb:nb + 4].contiguous().view(torch.int32)[:, 0]


def sentinel(dtype, device, x_mid: float, y_mid: float) -> st.Particles:
    """One EMPTY slot parked mid-tile (keeps cell location benign)."""
    def f(v):
        return torch.full((1,), v, dtype=dtype, device=device)

    def i(v):
        return torch.full((1,), v, dtype=torch.int32, device=device)

    return st.Particles(x=f(x_mid), y=f(y_mid), z=f(-1.0), dob=f(0.0),
                        age=f(0.0), status=i(EMPTY), pid=i(-1),
                        settle_poly=i(-1), hit_land=i(0), hit_bottom=i(0),
                        salt=f(0.0), temp=f(0.0))


def migrate(p: st.Particles, spec: TileSpec, tile_edges: torch.Tensor,
            my_t: int, sent: torch.Tensor, exchange):
    """Route particles to their owning tile with a fixed-capacity
    all_to_all (ltjax's ``_migrate``).

    ``tile_edges`` (ntiles + 1,) float64 on the particles' device;
    ``sent`` the packed sentinel row (``pack_rows(sentinel(...))``);
    ``exchange(rows, counts)`` the all_to_all over the data-parallel
    row (``dist.Rank.exchange``): ``counts[t]`` rows (at most mig_cap)
    for tile t, in tile order; returns the rows from every tile in tile
    order (only the leavers move: ltjax's fixed mig_cap blocks, without
    their EMPTY padding).  Leavers beyond mig_cap stay local flagged
    ERROR; merge overflow beyond cap is dropped.  Returns (p', drops,
    sent_count): drops counts both (as ltjax's overflow count),
    sent_count the particles that left (int64 device scalars).

    CPU tensors take the plain version, ``plain_migrate`` (counts a list
    of ints); CUDA tensors the hand-written kernels of
    ``kernels/migrate.py``, bit for bit the same (counts an int64 tensor
    on the card, the one host read left in the exchange)."""
    with span("ltjax_torch.migrate"):
        if p.x.device.type == "cpu":
            return plain_migrate(p, spec, tile_edges, my_t, sent, exchange)
        from .kernels import migrate as km
        return km.migrate(p, spec, tile_edges, my_t, sent, exchange)


def plain_migrate(p: st.Particles, spec: TileSpec, tile_edges: torch.Tensor,
                  my_t: int, sent: torch.Tensor, exchange):
    """``migrate`` as PyTorch ops: the CPU path, and the kernels' plain
    version."""
    ntiles, mc, n = spec.ntiles, spec.mig_cap, p.n
    dev, dtype = p.x.device, p.x.dtype
    valid = p.status != EMPTY
    dest = (torch.searchsorted(tile_edges, p.y.to(torch.float64),
                               right=True) - 1).clamp(0, ntiles - 1)
    dest = torch.where(valid, dest, torch.full_like(dest, my_t))
    leave = valid & (dest != my_t)
    # the first mig_cap leavers of each destination, in slot order
    order = torch.zeros_like(dest)
    for t in range(ntiles):
        m = leave & (dest == t)
        order = torch.where(m, torch.cumsum(m, 0) - 1, order)
    selected = leave & (order < mc)
    overflow = leave & ~selected
    p = p.replace(status=torch.where(overflow,
                                     torch.full_like(p.status, st.ERROR),
                                     p.status))
    rows = pack_rows(p)
    si = torch.nonzero(selected)[:, 0]
    si = si[torch.argsort(dest[si] * mc + order[si])]
    recv = exchange(rows[si], torch.bincount(dest[si], minlength=ntiles)
                    .tolist())
    keep = (valid & ~leave) | overflow
    cand = torch.cat([rows[keep], recv], 0)
    cvalid = torch.cat([torch.ones(int(keep.sum()), dtype=torch.bool,
                                   device=dev),
                        _status_of(recv, dtype) != EMPTY])
    fidx = torch.nonzero(cvalid)[:, 0]
    out = torch.cat([cand[fidx[:n]], sent.expand(max(0, n - fidx.numel()),
                                                 -1)], 0)
    drops = (fidx.numel() - min(fidx.numel(), n)) + overflow.sum()
    return unpack_rows(out, dtype), drops, selected.sum()


def make_tiled_steps(tctx: StepContext, cfg: Config, spec: TileSpec,
                     tile: int, tile_edges, n_fuse: int, exchange=None):
    """``n_fuse`` external steps of one tile over an (n_fuse + 2)-record
    window of its strip (ltjax's ``make_tiled_step`` body for one rank):
    each external step Hilbert-sorts the slots (banded by
    ``cfg.sort_depth_bands`` on the strip's rows and ``h``), takes the
    route of ``step.mode_flags`` (``step.route_step``: K1, the per-step,
    native or packed route, on the tile's context), restores the slot
    order and migrates (``exchange``: the all_to_all of the data-parallel
    row; not used with one tile, where nothing leaves).

    Returns ``fused(p, fsR, t0, ext_idx0) -> (p', drops, sent)`` with the
    drop and sent counts of the call (int64 device scalars)."""
    grid = tctx.grid
    route = mode_flags(tctx, cfg)
    dev = grid.device
    edges = torch.as_tensor(np.asarray(tile_edges, np.float64), device=dev)
    x_mid = float(grid.x_rho[grid.nx // 2])
    y_mid = float(grid.y_rho[grid.ny // 2])

    def fused(p: st.Particles, fsR: FieldSet, t0: float, ext_idx0: int = 0):
        if fsR.times.shape[0] != n_fuse + 2:
            raise ValueError(f"tiled step needs {n_fuse + 2} records, got "
                             f"{fsR.times.shape[0]}")
        with span("ltjax_torch.chunk"):
            prec_all = packed_window(tctx, cfg, route, fsR)
            sent_row = pack_rows(sentinel(p.x.dtype, dev, x_mid, y_mid))
            drops = torch.zeros((), dtype=torch.int64, device=dev)
            sent = torch.zeros((), dtype=torch.int64, device=dev)
            for e in range(n_fuse):
                with span("ltjax_torch.sort"):
                    p, perm = _sort(grid, p, cfg)
                p = route_step(tctx, cfg, route, p, prec_all, fsR, e, t0,
                               ext_idx0)
                with span("ltjax_torch.unsort"):
                    p = sp.unsort(p, perm)
                if spec.ntiles > 1:
                    p, nd, ns = migrate(p, spec, edges, tile, sent_row,
                                        exchange)
                    drops = drops + nd
                    sent = sent + ns
            return p, drops, sent

    return fused


# ---------------------------------------------------------------------------
# host-side scatter / gather
# ---------------------------------------------------------------------------

def _host(p) -> dict:
    return {k: _np(getattr(p, k)) for k in st.FIELDS}


def _park(spec: TileSpec, edges: np.ndarray, x: np.ndarray):
    """Where EMPTY slots park: mid-strip in y (per tile), the batch's
    mean x."""
    fin_lo = np.where(np.isfinite(edges[:-1]), edges[:-1], 0.0)
    fin_hi = np.where(np.isfinite(edges[1:]), edges[1:], 0.0)
    lo = np.where(np.isfinite(edges[:-1]), edges[:-1], fin_hi - 2.0)
    hi = np.where(np.isfinite(edges[1:]), edges[1:], fin_lo + 2.0)
    return float(x.mean()) if x.size else 0.0, 0.5 * (lo + hi)


def scatter_block(p, spec: TileSpec, tile_edges, dp: int,
                  tile: int) -> st.Particles:
    """Host-side: the (cap,) slot block of rank (dp, tile) of the whole
    batch ``p``: the tile's particles (by ownership of y), round-robin
    over dp in batch order, EMPTY slots parked mid-strip.  The block of
    ltjax's ``scatter_particles`` at [dp, tile]."""
    h = _host(p)
    edges = np.asarray(tile_edges)
    dest = np.clip(np.searchsorted(edges, h["y"], side="right") - 1, 0,
                   spec.ntiles - 1)
    counts = np.bincount(dest, minlength=spec.ntiles)
    if counts.size and counts.max() > spec.ndp * spec.cap:
        raise ValueError(
            f"a tile holds {counts.max()} particles > ndp*cap="
            f"{spec.ndp * spec.cap}; raise slack")
    mine = np.nonzero(dest == tile)[0][dp::spec.ndp]
    x_park, y_park = _park(spec, edges, h["x"])
    out = {}
    for f, a in h.items():
        fill = {"status": EMPTY, "pid": -1, "settle_poly": -1, "z": -1.0,
                "x": x_park, "y": y_park[tile]}.get(f, 0)
        buf = np.full((spec.cap,) + a.shape[1:], fill, a.dtype)
        buf[:mine.size] = a[mine]
        out[f] = torch.from_numpy(buf)
    return st.Particles(**out)


def scatter_particles(p, spec: TileSpec, tile_edges) -> st.Particles:
    """Host-side: every rank's block, as (ndp, ntiles, cap) columns (the
    layout of ltjax's ``scatter_particles``)."""
    blocks = [[scatter_block(p, spec, tile_edges, d, t)
               for t in range(spec.ntiles)] for d in range(spec.ndp)]
    return st.Particles(**{k: torch.stack([torch.stack(
        [getattr(b, k) for b in row]) for row in blocks])
        for k in st.FIELDS})


def gather_particles(blocks) -> st.Particles:
    """Host-side: slot blocks (a Particles of any shape, or a list of
    them) flattened back to a pid-ordered batch without EMPTY slots."""
    if isinstance(blocks, st.Particles):
        blocks = [blocks]
    flat = {k: np.concatenate([_np(getattr(b, k)).reshape(-1)
                               for b in blocks]) for k in st.FIELDS}
    keep = flat["status"] != EMPTY
    order = np.argsort(flat["pid"][keep], kind="stable")
    return st.Particles(**{k: torch.from_numpy(v[keep][order])
                           for k, v in flat.items()})


# ---------------------------------------------------------------------------
# step-level sharded runs (the stepper without the CLI)
# ---------------------------------------------------------------------------

def to_device(obj, device):
    """A copy of a dataclass of tensors (Grid, Boundaries, Polygons,
    CurvMap, FieldSet, Particles, StepContext; nested ones included) on
    ``device``; the FieldSet's record times stay on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if not dataclasses.is_dataclass(obj):
        return obj
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "cache":
            v = {}
        elif not (isinstance(obj, FieldSet) and f.name == "times"):
            v = to_device(v, device)
        kw[f.name] = v
    return type(obj)(**kw)


class TiledCase(NamedTuple):
    """One case of ``run_tiled_steps``: ``n_ext`` external steps of the
    batch ``p0`` (released or not, any storage order) with ``ctx`` and
    ``cfg`` on the mesh of ``spec``, over the whole-grid record window
    ``fsR`` (n_ext + 2 records, external step e on records [e, e+1,
    e+2]), in chunks of ``n_fuse``."""
    ctx: StepContext
    cfg: Config
    p0: st.Particles
    fsR: FieldSet
    n_ext: int
    spec: TileSpec
    n_fuse: int = 1


def _tiled_case(me, case: TiledCase, dev):
    from .kernels import (ext_step as kx, migrate as km, rk4_step as kr,
                          sort_key as sk, step_lanes as sl)
    ctx, cfg, spec = to_device(case.ctx, dev), case.cfg, case.spec
    ny = ctx.grid.ny
    if ctx.grid.curv is not None:
        tctx, edges, fs = ctx, np.array([-np.inf, np.inf]), case.fsR
    else:
        tiled = build_tiled_static(ctx.grid, spec)
        tctx, edges = tile_context(ctx, spec, tiled, me.tile), \
            tiled.tile_edges
        fs = strip_fieldset(case.fsR, spec, me.tile, ny)
    fs = to_device(fs, dev)
    p = scatter_block(case.p0, spec, edges, me.dp, me.tile).to(dev)
    steppers = {}
    reset_counters()
    drops = sent = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    me.barrier()
    t0 = time.perf_counter()
    for e0 in range(0, case.n_ext, case.n_fuse):
        E = min(case.n_fuse, case.n_ext - e0)
        if E not in steppers:
            steppers[E] = make_tiled_steps(tctx, cfg, spec, me.tile, edges,
                                           E, me.exchange)
        win = FieldSet(*(getattr(fs, k)[e0:e0 + E + 2] for k in
                         ("zeta", "u", "v", "w", "aks", "salt", "temp",
                          "times")))
        p, nd, ns = steppers[E](p, win, e0 * float(cfg.dt), e0)
        drops += int(nd)
        sent += int(ns)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sec = time.perf_counter() - t0
    return {"particles": p.to("cpu"), "drops": drops, "sent": sent,
            "seconds": sec, "launches": kx.ext_step_fused.launches,
            "rk4_launches": kr.rk4_displacement_fused.launches,
            "lanes_launches": sl.step_lanes_fused.launches,
            "sort_key_launches": sk.sort_key.launches,
            "migrate_launches": km.migrate.launches,
            "variant_launches": {**kx.ext_step_fused.variant_launches,
                                 **kr.rk4_displacement_fused.variant_launches,
                                 **sl.step_lanes_fused.variant_launches},
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else 0)}


def _tiled_rank(rank, world, init_method, cases, ndp, ntiles, device,
                backend):
    """One rank of ``run_tiled_steps``: every case in turn."""
    dev = dist.rank_device(device, backend, rank, world)
    me = dist.init(rank, world, ndp, ntiles, backend, dev, init_method)
    return [_tiled_case(me, c, dev) for c in cases]


def run_tiled_steps(cases, device="cpu", backend: str = "gloo"):
    """The stepper of a sharded run without the CLI, for comparison with
    ``step.make_fused_external_steps`` on one device: spawns the ranks of
    the cases' mesh once (``dist.launch``; every case has the same
    spec.ndp and spec.ntiles) and runs each ``TiledCase`` in turn: each
    rank takes its tile's strip of ``fsR``, its block of ``p0``
    (``scatter_block``) and ``make_tiled_steps``.  On CUDA, ``backend``
    "gloo" puts the ranks on the card(s) round-robin, "nccl" one rank per
    card.

    Returns, per case, (the particles in pid order on the CPU, a list per
    rank of {"drops", "sent", "seconds" (its stepping wall time, after a
    barrier), "launches" (K1), "rk4_launches" (K2), "lanes_launches" (K3),
    "sort_key_launches" (the sort key's kernel), "migrate_launches" (the
    migration's kernels, one a call), "variant_launches",
    "peak_memory_bytes"})."""
    spec = cases[0].spec
    if any((c.spec.ndp, c.spec.ntiles) != (spec.ndp, spec.ntiles)
           for c in cases):
        raise ValueError("run_tiled_steps: the cases' meshes differ")
    cpu = [c._replace(ctx=to_device(c.ctx, "cpu"), p0=c.p0.to("cpu"),
                      fsR=to_device(c.fsR, "cpu")) for c in cases]
    res = dist.launch(_tiled_rank, spec.ndp * spec.ntiles,
                      (cpu, spec.ndp, spec.ntiles, str(device), backend))
    out = []
    for k in range(len(cases)):
        ranks = [r[k] for r in res]
        out.append((gather_particles([r.pop("particles") for r in ranks]),
                    ranks))
    return out


def _migration_rank(rank, world, init_method, cases, tile_edges, x_mid,
                    y_mid):
    spec = cases[0][1]
    me = dist.init(rank, world, spec.ndp, spec.ntiles, "gloo",
                   dist.rank_device("cpu", "gloo", rank, world), init_method)
    edges = torch.as_tensor(np.asarray(tile_edges, np.float64))
    out = []
    for blocks, spec in cases:
        p = blocks[rank]
        p, drops, sent = migrate(p, spec, edges, me.tile,
                                 pack_rows(sentinel(p.x.dtype, "cpu", x_mid,
                                                    y_mid)), me.exchange)
        out.append({"particles": p, "drops": int(drops), "sent": int(sent)})
    return out


def run_migration(cases, tile_edges, x_mid: float, y_mid: float):
    """One ``migrate`` of every rank's slot block, per case, over one gloo
    process group on the CPU: ``cases`` a list of (blocks, spec), blocks
    one Particles of spec.cap slots per rank in rank order, the same mesh
    in every case; sentinels parked at (x_mid, y_mid).  The migration on
    its own, as the tests hold it against ltjax's ``_migrate``.  Returns
    per case a list per rank of {"particles", "drops", "sent"}."""
    spec = cases[0][1]
    res = dist.launch(_migration_rank, spec.ndp * spec.ntiles,
                      ([([b.to("cpu") for b in blocks], sp_)
                        for blocks, sp_ in cases], tile_edges, x_mid,
                       y_mid))
    return [[r[k] for r in res] for k in range(len(cases))]
