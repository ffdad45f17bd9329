"""Trajectory output: CSV and NetCDF snapshots (counterpart of
``ltjax.out.writer``).

Every output interval appends one snapshot: CSV rows (columns formatted
via numpy) and/or a NetCDF4 (HDF5) file with resizable (time, particle)
datasets, written through ``h5py`` (imported only when NetCDF output is
on; machines without h5py write CSV).  The ranks of a sharded run with
NetCDF output only write one shard file each (``shard_tag``: their slot
rows, EMPTY slots included, with a per-snapshot ``pid_t``), which
``merge_shards`` folds into the single-run layout.
"""

from __future__ import annotations

import os

import numpy as np

from .. import convert
from ..state import Particles


class TrajectoryWriter:
    def __init__(self, cfg, shard_tag: str = ""):
        """``shard_tag``: a suffix of the file names (e.g. "_h003"), for the
        shard file of one rank of a sharded run: slot occupancy changes
        as particles migrate, so ``pid`` is then a per-snapshot dataset
        ``pid_t``, and EMPTY slots carry color < 0."""
        self.cfg = cfg
        self.tag = shard_tag
        os.makedirs(cfg.outpath, exist_ok=True)
        self._csv = None
        self._nc = None           # h5py.File, created on first snapshot
        self._nt = 0
        if cfg.writeCSV:
            self._csv = open(os.path.join(
                cfg.outpath, cfg.NCOutFile + shard_tag + ".csv"), "w")
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
        f = h5py.File(os.path.join(cfg.outpath,
                                   cfg.NCOutFile + self.tag + ".nc"), "w")
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
        if self.tag:
            mk("pid_t", np.int32)
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
            if self.tag:
                fields["pid_t"] = pid
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


def merge_shards(shard_paths, out_path):
    """Merge per-rank trajectory shard files into one NetCDF file with the
    single-run layout (ltjax's ``merge_shards``): fixed ``pid`` (the
    sorted union over every snapshot of the pids of occupied slots, color
    >= 0) and (time, particle) datasets; a pid absent from a snapshot
    keeps the datasets' zero fill."""
    import h5py

    fs = [h5py.File(p, "r") for p in shard_paths]
    try:
        times = np.asarray(fs[0]["model_time"])
        for f in fs[1:]:
            np.testing.assert_allclose(np.asarray(f["model_time"]), times)
        names = [n for n in fs[0].keys()
                 if n not in ("model_time", "pid", "pid_t")]
        pid_parts = [np.asarray(f["pid_t"])[np.asarray(f["color"]) >= 0]
                     for f in fs]
        pids = (np.unique(np.concatenate(pid_parts))
                if sum(a.size for a in pid_parts) else np.zeros(0, np.int64))
        npar = int(pids.shape[0])
        with h5py.File(out_path, "w") as out:
            out.create_dataset("model_time", data=times)
            out.create_dataset("pid", data=pids.astype(np.int32))
            dsets = {n: out.create_dataset(
                n, shape=(len(times), npar), dtype=fs[0][n].dtype)
                for n in names}
            if npar == 0:
                return
            lookup = np.full(int(pids.max()) + 2, -1, np.int64)
            lookup[pids] = np.arange(npar)
            for k in range(len(times)):
                pid_k = np.concatenate([np.asarray(f["pid_t"][k])
                                        for f in fs])
                keep = np.concatenate([np.asarray(f["color"][k])
                                       for f in fs]) >= 0
                rows = lookup[pid_k[keep]]
                if (rows < 0).any():
                    raise ValueError(f"{out_path}: a shard pid outside "
                                     f"the union at snapshot {k}")
                for n in names:
                    col = np.concatenate([np.asarray(f[n][k]) for f in fs])
                    buf = np.zeros(npar, fs[0][n].dtype)
                    buf[rows] = col[keep]
                    dsets[n][k, :] = buf
    finally:
        for f in fs:
            f.close()
