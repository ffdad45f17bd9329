"""State carried across from the JAX package, as dicts of numpy arrays.

The functions take e.g. ``{k: np.asarray(v) for k, v in
jax_grid._asdict().items()}`` and build the port's containers with the
same values, so both packages can be fed identical inputs without this
package importing jax.  A curvilinear grid's or boundaries' ``curv`` is
given the same way, as a dict of the fields of ``ltjax.grid.CurvMap``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import state as st
from .fields import FieldSet
from .grid import CurvMap, Grid
from .physics.boundary import Boundaries
from .physics.settlement import Polygons


def _is_none(v) -> bool:
    return v is None or (isinstance(v, np.ndarray) and v.dtype == object
                         and v.ndim == 0 and v.item() is None)


def _t(v, device, dtype=None):
    return torch.as_tensor(np.array(v), dtype=dtype,
                           device=device)


def curv_from_numpy(c, device="cpu"):
    """CurvMap from the fields of an ``ltjax.grid.CurvMap`` (None stays
    None)."""
    if _is_none(c):
        return None
    return CurvMap(xy_flat=_t(c["xy_flat"], device),
                   seed_i=_t(c["seed_i"], device, torch.int32),
                   seed_j=_t(c["seed_j"], device, torch.int32),
                   **{k: float(np.asarray(c[k])) for k in
                      ("rx0", "ry0", "inv_rdx", "inv_rdy")})


def grid_from_numpy(d: dict, device="cpu") -> Grid:
    """Grid from the fields of an ``ltjax.grid.Grid``."""
    names = ("x_rho", "y_rho", "x_u", "y_v", "h", "mask_rho", "mask_u",
             "mask_v", "s_rho", "Cs_r", "s_w", "Cs_w")
    return Grid(**{k: _t(d[k], device) for k in names},
                hc=float(np.asarray(d["hc"])),
                vtransform=int(np.asarray(d["vtransform"])),
                uniform=bool(np.asarray(d.get("uniform", False))),
                curv=curv_from_numpy(d.get("curv"), device))


def boundaries_from_numpy(d: dict, device="cpu") -> Boundaries:
    """Boundaries from the fields of an ``ltjax.physics.boundary
    .Boundaries``."""
    tol2 = d.get("curv_tol2")
    xe = np.asarray(d["x_edges"], np.float64)
    ye = np.asarray(d["y_edges"], np.float64)
    return Boundaries(
        seg_a=_t(d["seg_a"], device), seg_b=_t(d["seg_b"], device),
        seg_kind=_t(d["seg_kind"], device), bucket=_t(d["bucket"], device),
        x_edges=_t(xe, device), y_edges=_t(ye, device),
        water=_t(d["water"], device, torch.int32),
        cell_rows=_t(d["cell_rows"], device),
        uniform=bool(np.asarray(d["uniform"])),
        edges=(float(xe[0]), float(xe[1] - xe[0]), float(ye[0]),
               float(ye[1] - ye[0]), float(xe[-1]), float(ye[-1])),
        curv=curv_from_numpy(d.get("curv"), device),
        curv_tol2=None if _is_none(tol2) else float(np.asarray(tol2)))


def fieldset_from_numpy(d: dict, device="cpu") -> FieldSet:
    """FieldSet from the fields of an ``ltjax.fields.FieldSet`` (K-last
    layout already, salt and temp included); record times go to a host
    float64 tensor."""
    names = ("zeta", "u", "v", "w", "aks", "salt", "temp")
    return FieldSet(**{k: _t(d[k], device) for k in names},
                    times=torch.as_tensor(np.array(d["times"],
                                                     np.float64)))


def polygons_from_numpy(d: dict, device="cpu") -> Polygons:
    """Polygons from the fields of an ``ltjax.physics.settlement
    .Polygons`` (f64 vertices, int32 counts, ids and candidate rows)."""
    return Polygons(verts_x=_t(d["verts_x"], device, torch.float64),
                    verts_y=_t(d["verts_y"], device, torch.float64),
                    **{k: _t(d[k], device, torch.int32) for k in
                       ("nverts", "poly_id", "cell_cands")})


def particles_from_numpy(d: dict, device="cpu") -> st.Particles:
    """Particles from the 12 columns of an ``ltjax.state.Particles``."""
    return st.Particles(**{k: _t(d[k], device) for k in st.FIELDS})


def seed_from_key_data(key_data) -> tuple:
    """The port's seed words of a JAX PRNG key, from its ``key_data`` (a
    numpy uint32 pair): pass the result as ``seed`` to draw the streams
    ltjax draws from that key."""
    k0, k1 = np.asarray(key_data).reshape(-1).astype(np.uint64)
    return int(k0), int(k1)


def particles_to_numpy(p: st.Particles) -> dict:
    return {k: getattr(p, k).cpu().numpy() for k in st.FIELDS}
