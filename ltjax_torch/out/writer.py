"""Trajectory output: CSV and NetCDF snapshots (counterpart of
``ltjax.out.writer``, single process).

Every output interval appends one snapshot: CSV rows (columns formatted
via numpy) and/or a NetCDF4 (HDF5) file with resizable (time, particle)
datasets, written through ``h5py`` (imported only when NetCDF output is
on; machines without h5py write CSV).
"""

from __future__ import annotations

import os

import numpy as np

from .. import convert
from ..state import Particles


class TrajectoryWriter:
    def __init__(self, cfg):
        self.cfg = cfg
        os.makedirs(cfg.outpath, exist_ok=True)
        self._csv = None
        self._nc = None           # h5py.File, created on first snapshot
        self._nt = 0
        if cfg.writeCSV:
            self._csv = open(os.path.join(cfg.outpath,
                                          cfg.NCOutFile + ".csv"), "w")
            if cfg.WriteHeaders:
                self._csv.write(",".join(self._csv_cols()) + "\n")

    def _csv_cols(self):
        cols = ["time", "id", "lon", "lat", "depth", "status"]
        if self.cfg.SaltTempOn:
            cols += ["salt", "temp"]
        cols += ["age", "poly"]
        if self.cfg.TrackCollisions:
            cols += ["hitLand", "hitBottom"]
        return cols

    def _nc_open(self, n_particles: int, pid: np.ndarray):
        import h5py
        cfg = self.cfg
        f = h5py.File(os.path.join(cfg.outpath, cfg.NCOutFile + ".nc"), "w")
        f.attrs["title"] = cfg.RunName
        f.attrs["run_by"] = cfg.RunBy
        f.attrs["institution"] = cfg.Institution
        f.attrs["source"] = "ltjax_torch (PyTorch/CUDA LTRANS v2b port)"

        def mk(name, dtype):
            f.create_dataset(name, shape=(0, n_particles),
                             maxshape=(None, n_particles), dtype=dtype,
                             chunks=(1, n_particles))
        f.create_dataset("model_time", shape=(0,), maxshape=(None,),
                         dtype=np.float64, chunks=(1024,))
        f.create_dataset("pid", data=pid)
        for name in ("lon", "lat", "depth", "age"):
            mk(name, np.float64)
        mk("color", np.int32)
        mk("settle_poly", np.int32)
        if cfg.SaltTempOn:
            mk("salt", np.float64)
            mk("temp", np.float64)
        if cfg.TrackCollisions:
            mk("hitLand", np.int32)
            mk("hitBottom", np.int32)
        self._nc = f

    def _nc_append(self, t: float, fields: dict):
        f = self._nc
        k = self._nt
        f["model_time"].resize((k + 1,))
        f["model_time"][k] = t
        for name, arr in fields.items():
            ds = f[name]
            ds.resize((k + 1, ds.shape[1]))
            ds[k, :] = arr
        self._nt += 1

    def snapshot(self, t: float, p: Particles):
        cfg = self.cfg
        host = {k: v.cpu().numpy() for k, v in vars(p).items()}
        x = host["x"].astype(np.float64)
        y = host["y"].astype(np.float64)
        lat = convert.y2lat(y, cfg.latmin, cfg.Earth_Radius,
                            cfg.SphericalProjection)
        lon = convert.x2lon(x, y, cfg.lonmin, cfg.latmin, cfg.Earth_Radius,
                            cfg.SphericalProjection)
        pid = host["pid"].astype(np.int32)
        depth = host["z"].astype(np.float64)
        status = host["status"].astype(np.int32)
        age = host["age"].astype(np.float64)
        poly = host["settle_poly"].astype(np.int32)
        extra = {}
        if cfg.SaltTempOn:
            extra["salt"] = host["salt"].astype(np.float64)
            extra["temp"] = host["temp"].astype(np.float64)
        if cfg.TrackCollisions:
            extra["hitLand"] = host["hit_land"].astype(np.int32)
            extra["hitBottom"] = host["hit_bottom"].astype(np.int32)

        if cfg.writeNC:
            if self._nc is None:
                self._nc_open(len(lon), pid)
            fields = {"lon": lon, "lat": lat, "depth": depth,
                      "color": status, "age": age, "settle_poly": poly}
            fields.update(extra)
            self._nc_append(float(t), fields)

        if self._csv is not None:
            cols = [np.full(len(lon), float(t)), pid, lon, lat, depth,
                    status]
            fmt = ["%.1f", "%d", "%.8f", "%.8f", "%.4f", "%d"]
            if cfg.SaltTempOn:
                cols += [extra["salt"], extra["temp"]]
                fmt += ["%.4f", "%.4f"]
            cols += [age, poly]
            fmt += ["%.1f", "%d"]
            if cfg.TrackCollisions:
                cols += [extra["hitLand"], extra["hitBottom"]]
                fmt += ["%d", "%d"]
            np.savetxt(self._csv, np.column_stack(cols),
                       fmt=",".join(fmt))

    def close(self):
        if self._csv is not None:
            self._csv.close()
            self._csv = None
        if self._nc is not None:
            self._nc.close()
            self._nc = None
