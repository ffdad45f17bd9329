"""ROMS grid + history-file series reading.

Reference: ``initGrid``/``initHydro``/``updateHydro`` in
hydrodynamic_module.f90 (SURVEY.md SS2.1 #3, SS3.3 [conf: H mechanism]):
open the grid NetCDF; then stream the numbered multi-file history
series ``dirin + prefix + zero-padded(filenum, numdigits) + suffix``,
keeping a triple buffer (back/center/forward) of one time record each
of zeta/u/v/w/Aks[/salt/temp], honoring the per-field read/const
switches.

Host-side NumPy only (the step driver moves records to the device).
The port's own copy of ``ltjax.io.roms``: ``RomsGridData``, ``read_grid``
(uniform levels synthesized by ``ltjax_torch.grid.uniform_sigma_levels``
where the files have none), ``RomsSeries``, ``_coord_2d`` and
``is_rectilinear`` (without ltjax's per-host row slices and
``seek``, which the port does not use yet); the port's
``run.grid_from_roms`` builds its Grid.
One difference: a series reads salt and temp whenever
``cfg.needs_salt_fields()`` (sampling on, or a salinity-cued behavior
4/5), and fills a field it does not read with its constant.
``ltjax.io.roms`` reads them under ``SaltTempOn`` alone and fills
nothing, so a Behavior-4 run without SaltTempOn has no salt record there.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..grid import uniform_sigma_levels
from .nc import NCFile

# ROMS variable-name candidates (first match wins)
_VAR_NAMES = {
    "zeta": ["zeta"],
    "u": ["u"],
    "v": ["v"],
    "w": ["w", "omega"],
    "aks": ["AKs", "Aks", "AKS", "aks"],
    "salt": ["salt"],
    "temp": ["temp"],
    "time": ["ocean_time", "scrum_time", "time"],
}

_GRID_NAMES = {
    "lon_rho": ["lon_rho", "x_rho"],
    "lat_rho": ["lat_rho", "y_rho"],
    "mask_rho": ["mask_rho"],
    "h": ["h"],
    "s_rho": ["s_rho", "sc_r"],
    "s_w": ["s_w", "sc_w"],
    "Cs_r": ["Cs_r"],
    "Cs_w": ["Cs_w"],
    "hc": ["hc"],
    "Vtransform": ["Vtransform"],
}


def _find(nc: NCFile, names: List[str]) -> Optional[str]:
    have = set(nc.variables())
    for n in names:
        if n in have:
            return n
    return None


@dataclass
class RomsGridData:
    """Raw grid arrays straight from the files (host numpy)."""
    lon_rho: np.ndarray     # (Ny, Nx) degrees (or meters for x_rho grids)
    lat_rho: np.ndarray
    mask_rho: np.ndarray    # (Ny, Nx)
    h: np.ndarray           # (Ny, Nx)
    s_rho: np.ndarray
    s_w: np.ndarray
    Cs_r: np.ndarray
    Cs_w: np.ndarray
    hc: float
    vtransform: int
    geographic: bool        # True if lon/lat in degrees


def read_grid(path: str, cfg: Optional[Config] = None,
              hist_path: Optional[str] = None) -> RomsGridData:
    """Read grid + s-coordinate data, falling back to a history file for
    the s-coordinate variables when the grid file lacks them."""
    nc = NCFile(path)
    hist = NCFile(hist_path) if hist_path and hist_path != path else None

    def get(key, required=True, record=False):
        for src in (nc, hist):
            if src is None:
                continue
            name = _find(src, _GRID_NAMES[key])
            if name:
                return src.read(name)
        if required:
            raise KeyError(f"grid variable {key} not found in {path}")
        return None

    lon = get("lon_rho")
    lat = get("lat_rho")
    geographic = _find(nc, ["lon_rho"]) is not None
    mask = get("mask_rho", required=False)
    if mask is None:
        mask = np.ones_like(lon)
    h = get("h")
    s_rho = get("s_rho", required=False)
    s_w = get("s_w", required=False)
    Cs_r = get("Cs_r", required=False)
    Cs_w = get("Cs_w", required=False)
    hc = get("hc", required=False)
    vt = get("Vtransform", required=False)
    if cfg is not None:
        if hc is None:
            hc = cfg.hc
        if vt is None:
            vt = cfg.Vtransform
    if s_rho is None:
        us = cfg.us if cfg else 20
        s_rho, s_w = uniform_sigma_levels(us)
        Cs_r, Cs_w = s_rho, s_w
    if Cs_r is None:
        Cs_r, Cs_w = s_rho, s_w
    out = RomsGridData(
        lon_rho=np.atleast_2d(np.asarray(lon, np.float64)),
        lat_rho=np.atleast_2d(np.asarray(lat, np.float64)),
        mask_rho=np.asarray(mask),
        h=np.asarray(h, np.float64),
        s_rho=np.asarray(s_rho, np.float64).ravel(),
        s_w=np.asarray(s_w, np.float64).ravel(),
        Cs_r=np.asarray(Cs_r, np.float64).ravel(),
        Cs_w=np.asarray(Cs_w, np.float64).ravel(),
        hc=float(np.asarray(hc).ravel()[0]),
        vtransform=int(np.asarray(vt).ravel()[0]),
        geographic=geographic,
    )
    nc.close()
    if hist:
        hist.close()
    return out


def _coord_2d(gd: RomsGridData):
    """(lon2, lat2) both as 2-D arrays (broadcasting 1-D inputs)."""
    lon = gd.lon_rho
    lat = gd.lat_rho
    if lon.ndim == 1:
        lon = lon[None, :]
    if lat.ndim == 1:
        lat = lat[:, None]
    ny = max(lon.shape[0], lat.shape[0])
    nx = max(lon.shape[1], lat.shape[1])
    return (np.broadcast_to(lon, (ny, nx)),
            np.broadcast_to(lat, (ny, nx)))


def is_rectilinear(gd: RomsGridData, rtol: float = 1e-6) -> bool:
    """True when lon varies only along xi and lat only along eta."""
    lon2, lat2 = _coord_2d(gd)
    s_lon = np.abs(lon2 - lon2[0, :][None, :]).max()
    s_lat = np.abs(lat2 - lat2[:, 0][:, None]).max()
    return (s_lon <= rtol * max(1.0, np.abs(lon2).max())
            and s_lat <= rtol * max(1.0, np.abs(lat2).max()))


class RomsSeries:
    """Cursor over the numbered multi-file ROMS history series.

    ``next_record()`` yields dicts of one time record of each enabled
    field, advancing across file boundaries (updateHydro semantics).
    """

    def __init__(self, cfg: Config, paths: Optional[List[str]] = None):
        self.cfg = cfg
        self._explicit_paths = paths
        self.file_idx = 0      # index into the series
        self.rec_idx = 0       # record within current file
        self._nc: Optional[NCFile] = None
        self._names: Dict[str, Optional[str]] = {}

    # -- file naming ------------------------------------------------------
    def path_for(self, file_idx: int) -> str:
        if self._explicit_paths is not None:
            return self._explicit_paths[file_idx]
        cfg = self.cfg
        num = cfg.filenum + file_idx
        return os.path.join(
            cfg.dirin, f"{cfg.prefix}{num:0{cfg.numdigits}d}{cfg.suffix}")

    def _open(self, file_idx: int):
        if self._nc is not None:
            self._nc.close()
        self._nc = NCFile(self.path_for(file_idx))
        self.file_idx = file_idx
        self._names = {k: _find(self._nc, v) for k, v in _VAR_NAMES.items()}

    # -- record streaming -------------------------------------------------
    def _read_field(self, key: str, rec: int, read_flag: bool,
                    const: float, shape_like: Optional[np.ndarray]):
        name = self._names.get(key)
        if read_flag and name:
            return self._nc.read(name, rec, dtype="float32")
        if shape_like is not None:
            return np.full(shape_like.shape, const, np.float32)
        return None

    def next_record(self) -> Dict[str, np.ndarray]:
        """Read the next time record, rolling over to the next file."""
        cfg = self.cfg
        if self._nc is None:
            self._open(0)
        tname = self._names["time"]
        nrec = self._nc.num_records(tname) if tname else cfg.tdim
        if self.rec_idx >= nrec:
            self._open(self.file_idx + 1)
            self.rec_idx = 0
        rec = self.rec_idx
        self.rec_idx += 1

        t = float(np.asarray(self._nc.read(tname, rec)).ravel()[0]) if tname \
            else float(rec * cfg.dt)
        zeta = self._read_field("zeta", rec, cfg.readZeta, cfg.constZeta, None)
        u = self._read_field("u", rec, cfg.readU, cfg.constU, None)
        v = self._read_field("v", rec, cfg.readV, cfg.constV, None)
        w = self._read_field("w", rec, cfg.readW, cfg.constW, None)
        aks = self._read_field("aks", rec, cfg.readAks, cfg.constAks, None)
        out = {"time": t, "zeta": zeta, "u": u, "v": v, "w": w, "aks": aks}
        # const fallbacks need shapes from whatever was read
        ref3 = u if u is not None else v
        if ref3 is None:
            raise ValueError("history file must contain at least u or v "
                             "when readU/readV are off, set constU/constV "
                             "and provide a grid-shaped template")
        # rho-grid shape from the staggered u/v shape actually read
        if u is not None:
            rho_shape = (ref3.shape[1], ref3.shape[2] + 1)
        else:
            rho_shape = (ref3.shape[1] + 1, ref3.shape[2])
        ws_shape = (ref3.shape[0] + 1,) + rho_shape
        if zeta is None:
            out["zeta"] = np.full(rho_shape, cfg.constZeta, np.float32)
        if w is None:
            out["w"] = np.full(ws_shape, cfg.constW, np.float32)
        if aks is None:
            out["aks"] = np.full(ws_shape, cfg.constAks, np.float32)
        if cfg.needs_salt_fields():
            rho_k = np.empty((ref3.shape[0],) + rho_shape, np.float32)
            out["salt"] = self._read_field("salt", rec, cfg.readSalt,
                                           cfg.constSalt, rho_k)
            out["temp"] = self._read_field("temp", rec, cfg.readTemp,
                                           cfg.constTemp, rho_k)
        return out

    def seek(self, global_record: int):
        """Position the cursor at a global record index (for resume),
        counting cfg.tdim records per file (the reference's fixed
        records-per-file series layout), as ltjax's seek does."""
        global_record = max(0, global_record)
        tdim = max(1, self.cfg.tdim)
        self._open(global_record // tdim)
        self.rec_idx = global_record % tdim

    def close(self):
        if self._nc is not None:
            self._nc.close()
            self._nc = None
