"""The work of the LTRANS algorithm on a cell's inputs, frozen: operations
and bytes of one launch of each kernel of the port's routes, counted
from the configuration's shapes and options, never from the program's
tables or sources.

* K1, the whole external step: ``internal_steps`` internal steps, each
  the four RK4 stages of ``find_currents`` and every enabled lane.
* K2, the per-step route's RK4 step: the four stages and the RK4 sums.
* K3, the per-step route's lanes: every enabled lane of one internal
  step, without the RK4 stages.

Operations are counted per active particle-step, the same for every
implementation: each stage collapses the three records in time and
blends the four corners per particle for every value it reads, whether
a kernel reads raw records or tables collapsed beforehand.  The counts
per lane are the ones the port's smoke runs took from its first kernels
(``fit_ops``: a knot 8, the small-tension coefficients 18, a Thomas row
4 + 4P, the backward sweep to the interval ~K/2 x 2P, the evaluation
14 + 9P; a value lane 31), frozen here.  With float64 positions the cell
location, the knots, the log layer, the RK4 sums, turbulence, behavior,
reflection, the vertical bounds and the scalar fits are float64; the
blends and ``find_currents``' fits stay float32.

Bytes count each record field the launch needs (three records, in the
fields' dtype), the bathymetry and land mask, each particle column it
reads and each it writes once, and the polygon vertices.

On a grid of the kind ``estuary`` (``grid_terms``) two more terms count:
on a curvilinear one every cell location is an inverse-map solve (the
raster seed 16, three Newton steps of 65, the clamp 4; an inside test's
residual 40 more), 5 + ``reflect_iters`` plain solves an internal step
in K1 (four RK4 stages, the vertical reflection's column, one a
reflection pass; Visser's and a behavior's stage-1 column where they
run) and 2 with residual (the two inside tests), as the smoke runs count
them, and each launch reads the map (the rho points in the positions'
dtype, the seed raster's two int32 tables); and a coastline is reflected
``reflect_iters`` passes (60 each) where the counts above hold one.  The
open box's counts are as they were.
"""

from __future__ import annotations

LANE = 31          # operations of a value lane: three records collapsed, blended
THREEFRY = 120     # one Threefry-2x32 block (integer words at the f32 rate)


def fit_ops(K: int, P: int, lane: int = LANE) -> int:
    """Operations of a tension-spline fit and evaluation on K knots for P
    profiles read through value lanes of ``lane`` operations each."""
    return (31 + lane * P + (K - 1) * (31 + (lane + 6) * P) + K * P + 14
            + 9 * P)


def stage_ops(us: int, ws: int) -> int:
    """One ``find_currents`` stage: the rho cell 10, the zeta and h lanes,
    the u/v and w fits, the log layer 12."""
    return 10 + 2 * LANE + fit_ops(us, 2) + fit_ops(ws, 1) + 12


def stage_ops_pos(us: int, ws: int) -> int:
    """The float64 part of a stage with float64 positions: the cell, the
    log layer and the knots."""
    return 10 + 12 + 8 * (us + ws)


def lane_extras(o: dict, us: int, ws: int) -> tuple:
    """(all, float64 with float64 positions) operations of the optional
    lanes of one internal step: turbulence, behavior, salt and
    temperature sampling; the Threefry words stay at the f32 rate."""
    ops = pos = 0
    if o.get("HTurbOn"):
        ops += THREEFRY + 12
        pos += 12
    if o.get("VTurbOn"):
        ops += THREEFRY + 4
        pos += 4
        if o.get("readAks", True):
            v = 72 + fit_ops(ws, 1) + 2 * ws + 2 * (ws + 62 + 20)
            ops += v
            pos += v
    b = int(o.get("Behavior", 0))
    if b:
        ops += 80
        pos += 80
        if b in (1, 2, 3, 4, 5):
            ops += 2 * THREEFRY + 10
            pos += 10
        if b in (4, 5):
            ops += fit_ops(us, 1)
            pos += fit_ops(us, 1)
    if o.get("SaltTempOn"):
        ops += fit_ops(us, 2)
        pos += fit_ops(us, 2)
    return ops, pos


REFLECT = 60             # one reflection pass
BOUNDS = REFLECT + 82 + 5     # reflection, the vertical bounds 82 + 5
CURV_SOLVE = 16 + 3 * 65 + 4  # an inverse-map solve
CURV_RESID = 40               # an inside test's residual


def grid_terms(config: dict) -> tuple:
    """(curvilinear, reflection passes) of a configuration file's grid:
    an ``estuary`` counts its inverse map where it is curvilinear and
    ``reflect_iters`` passes; the open box neither, and one pass."""
    g = config["grid"]
    if g.get("kind") != "estuary":
        return False, 1
    return (bool(g.get("curvilinear", True)),
            int(config["ltrans"].get("reflect_iters", 4)))


def curv_solves(o: dict) -> tuple:
    """(plain, with residual) inverse-map solves of one internal step of
    K1 on a curvilinear grid."""
    return (5 + int(o.get("reflect_iters", 4))
            + int(bool(o.get("VTurbOn")) and o.get("readAks", True))
            + int(int(o.get("Behavior", 0)) != 0)), 2


def ops_per_step(kernel: str, o: dict, us: int, ws: int, pos64: bool,
                 curv: bool = False, passes: int = 1) -> tuple:
    """(f32, f64) operations of one active particle-step of ``kernel``
    ("k1", "k2", "k3") under the LTRANS options ``o``: K1 the four stages,
    the RK4 sums 40, the bounds and the lanes; K2 the four stages and the
    RK4 combination 24; K3 the bounds, the lanes and the DEATH draw.  On
    a curvilinear grid (``curv``) plus the inverse-map solves (K2 the
    four stages', K3 all but those), and ``passes`` reflection passes in
    place of one; both float64 with float64 positions."""
    extra, extra_pos = lane_extras(o, us, ws)
    stage, stage_pos = stage_ops(us, ws), stage_ops_pos(us, ws)
    more = (passes - 1) * REFLECT if kernel != "k2" else 0
    if curv:
        plain, resid = curv_solves(o)
        if kernel == "k2":
            plain, resid = 4, 0
        elif kernel == "k3":
            plain -= 4
        more += (plain + resid) * CURV_SOLVE + resid * CURV_RESID
    if kernel == "k1":
        ops = 4 * stage + 40 + BOUNDS + extra
        pos = 4 * stage_pos + 40 + BOUNDS + extra_pos
    elif kernel == "k2":
        ops, pos = 4 * stage + 24, 4 * stage_pos + 24
    elif kernel == "k3":
        ops = BOUNDS + THREEFRY + 4 + extra
        pos = BOUNDS + 2 + extra_pos
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    ops, pos = ops + more, pos + more
    return (ops - pos, pos) if pos64 else (ops, 0)


def settle_ops(edges: float) -> float:
    """Float64 operations of the settlement ray cast of one particle-step
    against ``edges`` candidate polygon edges."""
    return 8 + 9 * edges


def curv_map_bytes(nx: int, ny: int, pos_bytes: int) -> int:
    """Bytes of a curvilinear grid's inverse map: the rho points in the
    positions' dtype and the seed raster's cells (two int32 tables of
    twice the cells along each axis)."""
    return ny * nx * 2 * pos_bytes + 2 * (2 * (ny - 1)) * (2 * (nx - 1)) * 4


def launch_bytes(kernel: str, o: dict, nx: int, ny: int, us: int, ws: int,
                 numpar: int, pos_bytes: int, field_bytes: int = 4,
                 n_vertices: int = 0, curv: bool = False) -> int:
    """Bytes one launch of ``kernel`` must move: the record fields it
    needs (three records), the bathymetry and land mask, each particle
    column read and each written once, the polygon vertices, and on a
    curvilinear grid (``curv``) its inverse map."""
    salt = o.get("SaltTempOn") or int(o.get("Behavior", 0)) in (4, 5)
    aks = o.get("VTurbOn") and o.get("readAks", True)
    settle = bool(o.get("settlementon"))
    sampled = 2 if o.get("SaltTempOn") else 0
    rho, w = ny * nx, ny * nx * ws
    fields = rho                                   # zeta
    if kernel in ("k1", "k2"):
        fields += ny * (nx - 1) * us + (ny - 1) * nx * us + w
    if kernel in ("k1", "k3"):
        fields += (w if aks else 0) + (rho * us if salt else 0) + (
            rho * us if o.get("SaltTempOn") else 0)
    nbytes = 3 * fields * field_bytes + rho * (field_bytes + 4)
    if kernel == "k2":
        cols_in, ints_in, cols_out, ints_out = 3, 0, 3, 0
        if int(o.get("Behavior", 0)) == 7:
            cols_out += 2
    else:
        # x y z dob age (+ salt temp), status pid (+ settle_poly); out x y
        # z age (+ salt temp), status (+ settle_poly); K3 reads K2's dx dy dz
        cols_in = 5 + sampled + (3 if kernel == "k3" else 0)
        ints_in = 2 + int(settle)
        cols_out, ints_out = 4 + sampled, 1 + int(settle)
        nbytes += 16 * n_vertices if settle else 0
    if curv:
        nbytes += curv_map_bytes(nx, ny, pos_bytes)
    return nbytes + numpar * ((cols_in + cols_out) * pos_bytes
                              + (ints_in + ints_out) * 4)


def least_seconds(f32: float, f64: float, nbytes: float, peaks: dict):
    """(seconds, "operations" or "bytes"): the larger of the operations
    over the peak rates of their type and the bytes over the memory
    rate."""
    t_ops = f32 / peaks["fp32_per_s"] + f64 / peaks["fp64_per_s"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
