"""The native (C++) NetCDF3 reader (counterpart of ``ltjax.native``).

``ncread.cpp`` parses a classic (CDF-1/CDF-2) file's header, maps the
file read-only, and reads variables from the mapping (``pread`` where a
file cannot be mapped): a whole variable, one record, or (for the ranks
of a sharded run) rows [lo, hi) of a record's eta axis, converted to
float32 or float64 on the way.  Called through ``ctypes``, which
releases the GIL, so the CLI's prefetch worker reads while the main
thread steps.

The library is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/ltjax_torch/native/`` at the root of the
checkout (gitignored), keyed by a hash of the source and the flags, and
written atomically (a per-process temporary file, then ``os.replace``):
concurrent processes may build it at once.  A failed build raises with
the compiler's output; there is no quiet fallback.  A file the parser
refuses raises ``OSError`` from ``NativeCDF``, and ``io.nc.NCFile``
then reads it with scipy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "ncread.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "ltjax_torch", "native")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def library_path(src: str = SRC) -> str:
    """Where the library of ``src`` is (or will be) built."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"ltnc-{digest.hexdigest()[:16]}.so")


def build(src: str = SRC) -> str:
    """Compile ``src`` unless its library exists; returns the path.
    Raises RuntimeError with the compiler's output when g++ fails."""
    so = library_path(src)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(["g++", *FLAGS, "-o", tmp, src],
                           capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("ltjax_torch.native: g++ not found") from e
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"ltjax_torch.native: g++ failed on {src}:\n"
                           f"{r.stderr}")
    os.replace(tmp, so)
    return so


def _bind(lib):
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    sig = {"ltnc_open": (vp, [ctypes.c_char_p]),
           "ltnc_close": (None, [vp]),
           "ltnc_numrecs": (ll, [vp]),
           "ltnc_num_vars": (ci, [vp]),
           "ltnc_var_name": (ci, [vp, ci, ctypes.c_char_p, ci]),
           "ltnc_find_var": (ci, [vp, ctypes.c_char_p]),
           "ltnc_var_ndims": (ci, [vp, ci]),
           "ltnc_var_isrec": (ci, [vp, ci]),
           "ltnc_var_shape": (None, [vp, ci, ctypes.POINTER(ll)]),
           "ltnc_read": (ll, [vp, ci, ll, vp, ci]),
           "ltnc_read_rows": (ll, [vp, ci, ll, ll, ll, vp, ci])}
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def get_lib():
    """The loaded C library, built on first use (raises if it cannot be
    built)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib


class NativeCDF:
    """Read-only NetCDF3 classic file through the C++ reader: the subset
    of ``io.nc.NCFile`` that it serves (variables, dims, num_records,
    read, close).  Raises OSError if the file cannot be parsed."""

    def __init__(self, path: str):
        lib = get_lib()
        self._lib = lib
        self._h = lib.ltnc_open(path.encode())
        if not self._h:
            raise OSError(f"{path}: the native reader cannot parse it")
        self.path = path
        self._names = {}
        buf = ctypes.create_string_buffer(256)
        for vid in range(lib.ltnc_num_vars(self._h)):
            lib.ltnc_var_name(self._h, vid, buf, 256)
            self._names[buf.value.decode()] = vid

    def variables(self):
        return list(self._names)

    def dims(self, name):
        vid = self._names[name]
        nd = self._lib.ltnc_var_ndims(self._h, vid)
        shape = (ctypes.c_longlong * max(nd, 1))()
        self._lib.ltnc_var_shape(self._h, vid, shape)
        return tuple(int(shape[d]) for d in range(nd))

    def num_records(self, name):
        return self.dims(name)[0]

    def read(self, name, index=None, dtype="float64", eta_slice=None):
        """A whole variable, or one leading-axis record of it (``index``),
        as float32 or float64; ``eta_slice`` (lo, hi) reads only those
        rows of the second-to-last axis (one copy per level)."""
        vid = self._names[name]
        shape = self.dims(name)
        # one slab of the leading axis, a record dimension or not (the
        # time axis of a file written with a fixed one)
        rec = int(index) if (index is not None and shape) else -1
        out_shape = shape[1:] if rec >= 0 else shape
        want = 0 if np.dtype(dtype) == np.float32 else 1
        if eta_slice is not None and len(out_shape) >= 2:
            lo, hi = (int(v) for v in eta_slice)
            out_shape = out_shape[:-2] + (hi - lo, out_shape[-1])
        out = np.empty(out_shape, np.float32 if want == 0 else np.float64)
        ptr = out.ctypes.data_as(ctypes.c_void_p)
        if eta_slice is not None and len(out_shape) >= 2:
            n = self._lib.ltnc_read_rows(self._h, vid, rec, lo, hi, ptr,
                                         want)
        else:
            n = self._lib.ltnc_read(self._h, vid, rec, ptr, want)
        if n != out.size:
            raise OSError(f"{self.path}:{name}: native read failed")
        return out

    def close(self):
        if self._h:
            self._lib.ltnc_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
