"""Minimal NetCDF abstraction over scipy (NetCDF3) and h5py (NetCDF4).

The port's own copy of ``ltjax.io.nc`` (``NCFile``, ``write_netcdf``).
The reference links the NetCDF Fortran library and reads ROMS grid +
history files with nf90_open/get_var (hydrodynamic_module.f90,
SURVEY.md SS3.3).  Both classic files (CDF-1/2, via
scipy.io.netcdf_file) and NetCDF4/HDF5 files (via h5py, where it is
installed) are read, detected by magic bytes, one time record at a
time.  ltjax's C++ reader (``ltjax/native``) and its per-host row
slices are not copied: scipy reads the classic files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class NCFile:
    """Read-only NetCDF file with record-wise variable access."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic[:3] == b"CDF":
            from scipy.io import netcdf_file
            self._kind = "cdf"
            self._f = netcdf_file(path, "r", mmap=True)
        elif magic[1:4] == b"HDF":
            import h5py
            self._kind = "hdf"
            self._f = h5py.File(path, "r")
        else:
            raise ValueError(f"{path}: not a NetCDF file (magic {magic!r})")

    # -- introspection ----------------------------------------------------
    def variables(self):
        if self._kind == "cdf":
            return list(self._f.variables)
        return [k for k in self._f.keys()]

    def dims(self, name: str) -> Tuple[int, ...]:
        if self._kind == "cdf":
            return self._f.variables[name].shape
        return self._f[name].shape

    def num_records(self, name: str) -> int:
        """Length of the leading (time) axis of a variable."""
        return self.dims(name)[0]

    # -- data -------------------------------------------------------------
    def read(self, name: str, index=None, dtype=None) -> np.ndarray:
        """Read a whole variable or one leading-axis record (hyperslab),
        converted to ``dtype`` ("float32"/"float64") if given, in native
        byte order."""
        if self._kind == "cdf":
            var = self._f.variables[name]
            if var.shape == ():  # scalar var: scipy can't slice 0-d data
                data = var.getValue()
            else:
                data = var[index] if index is not None else var[:]
            out = np.array(data)  # copy out of the mmap
        else:
            ds = self._f[name]
            out = np.asarray(ds[index] if index is not None else ds[:])
        if dtype is not None:
            out = np.asarray(out, dtype)
        # NetCDF3 is big-endian on disk: hand out native byte order
        return out.astype(out.dtype.newbyteorder("="), copy=False)

    def close(self):
        self._f.close()


def write_netcdf(path: str, dims: Dict[str, Optional[int]],
                 variables: Dict[str, Tuple[Sequence[str], np.ndarray]]):
    """Write a classic NetCDF3 file via scipy.

    dims: name -> size (None for the unlimited/record dimension).
    variables: name -> (dim-name tuple, array).
    """
    from scipy.io import netcdf_file

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    f = netcdf_file(path, "w")
    try:
        for dname, size in dims.items():
            f.createDimension(dname, size)
        for vname, (vdims, data) in variables.items():
            data = np.asarray(data)
            if data.dtype == np.float64:
                tc = "d"
            elif data.dtype == np.float32:
                tc = "f"
            elif data.dtype.kind in "iu":
                tc = "i"
                data = data.astype(np.int32)
            else:
                tc = "d"
                data = data.astype(np.float64)
            var = f.createVariable(vname, tc, tuple(vdims))
            if data.ndim == 0:
                # scipy's assignValue does `self.data[:] = value`, which
                # IndexErrors on 0-d arrays under numpy>=2; poke the 0-d
                # backing array directly.
                var.data[()] = data
            else:
                var[:] = data
    finally:
        f.close()
