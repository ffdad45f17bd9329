"""Minimal NetCDF abstraction: the native C++ reader and scipy (NetCDF3),
h5py (NetCDF4).

The port's own copy of ``ltjax.io.nc`` (``NCFile``, ``write_netcdf``).
The reference links the NetCDF Fortran library and reads ROMS grid +
history files with nf90_open/get_var (hydrodynamic_module.f90,
SURVEY.md SS3.3).  Classic files (CDF-1/2) are read by the port's copy
of ltjax's C++ reader (``ltjax_torch.native``, kind ``"native"``), or by
``scipy.io.netcdf_file`` (kind ``"cdf"``) when the C++ parser refuses
one; NetCDF4/HDF5 files by h5py (kind ``"hdf"``, where it is
installed); the kind is picked by the file's magic bytes.  ``read``
takes one time record and, for the ranks of a sharded run, a range of
eta rows (``eta_slice``): the native reader fetches only those rows,
scipy's mmap and h5py slice lazily.
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
            # the native reader first (GIL-free reads for the prefetch
            # worker, row reads for sharded runs); scipy reads what its
            # parser refuses.  A failed build of the reader raises.
            from ..native import NativeCDF
            try:
                self._f = NativeCDF(path)
                self._kind = "native"
                return
            except OSError:
                pass
            from scipy.io import netcdf_file
            self._kind = "cdf"
            self._f = netcdf_file(path, "r", mmap=True)
        elif magic[1:4] == b"HDF":
            import h5py
            self._kind = "hdf"
            self._f = h5py.File(path, "r")
        else:
            raise ValueError(f"{path}: not a NetCDF file (magic {magic!r})")

    @property
    def kind(self) -> str:
        """"native", "cdf" (scipy) or "hdf" (h5py)."""
        return self._kind

    # -- introspection ----------------------------------------------------
    def variables(self):
        if self._kind == "native":
            return self._f.variables()
        if self._kind == "cdf":
            return list(self._f.variables)
        return [k for k in self._f.keys()]

    def dims(self, name: str) -> Tuple[int, ...]:
        if self._kind == "native":
            return self._f.dims(name)
        if self._kind == "cdf":
            return self._f.variables[name].shape
        return self._f[name].shape

    def num_records(self, name: str) -> int:
        """Length of the leading (time) axis of a variable."""
        return self.dims(name)[0]

    # -- data -------------------------------------------------------------
    def read(self, name: str, index=None, dtype=None,
             eta_slice=None) -> np.ndarray:
        """Read a whole variable or one leading-axis record (hyperslab),
        converted to ``dtype`` ("float32"/"float64") if given, in native
        byte order (the native reader converts while it reads, float64
        unless told otherwise).  ``eta_slice``: (lo, hi) rows of the
        second-to-last axis, the ROMS eta axis of ([K,] eta, xi)
        records."""
        es = slice(*eta_slice) if eta_slice is not None else slice(None)
        if self._kind == "native":
            out = self._f.read(name, index, dtype=dtype or "float64",
                               eta_slice=eta_slice)
        elif self._kind == "cdf":
            var = self._f.variables[name]
            if var.shape == ():  # scalar var: scipy can't slice 0-d data
                data = var.getValue()
            elif eta_slice is not None and len(var.shape) >= 2:
                data = (var[index][..., es, :] if index is not None
                        else var[:][..., es, :])
            else:
                data = var[index] if index is not None else var[:]
            out = np.array(data)  # copy out of the mmap
        else:
            ds = self._f[name]
            if eta_slice is not None and ds.ndim >= 2:
                key = ((index, Ellipsis, es, slice(None)) if index is not None
                       else (Ellipsis, es, slice(None)))
                out = np.asarray(ds[key])
            else:
                out = np.asarray(ds[index] if index is not None else ds[:])
        if dtype is not None:
            out = np.asarray(out, dtype)
        # NetCDF3 is big-endian on disk: hand out native byte order
        return out.astype(out.dtype.newbyteorder("="), copy=False)

    def read_attr(self, name: str, attr: str, default=None):
        """A variable's attribute (the native reader skips attributes:
        scipy parses them for it)."""
        try:
            if self._kind == "native":
                from scipy.io import netcdf_file
                with netcdf_file(self.path, "r", mmap=False) as f:
                    return getattr(f.variables[name], attr)
            if self._kind == "cdf":
                return getattr(self._f.variables[name], attr)
            return self._f[name].attrs[attr]
        except (AttributeError, KeyError):
            return default

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
