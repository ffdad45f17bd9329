"""The Hilbert sort key of the particle batch: CUDA kernel wrapper + plain
version.

``sort_key(i, j, status, depth_band=None, n_bands=1)`` gives the int32
key that ``spatial.sort_by_cell`` sorts on, from each slot's rho cell
``(i, j)`` (``step._sort_cells``), its status and, where the sort is
banded, its depth band (``step._sort_band``):

* unbanded: ``hilbert_key(i, j, 15)``, plus ``2^30`` for a parked slot
  (status >= SETTLED, or < 0: a sharded run's EMPTY slots);
* banded: ``hilbert_key(i, j, 14) + (band << 28)``, the band clamped to
  ``[0, n_bands - 1]`` and 7 for a parked slot, ``n_bands`` in 1..6.

Every key lies below ``2^31``.  On CPU tensors the wrapper returns the
plain version, ``plain_key`` (``hilbert_key`` as PyTorch ops); on CUDA
tensors it launches ``csrc/sort_key.cu`` (one thread per slot, int32
cells, status and band) and counts the launch in
``sort_key.launches``; a failed build or launch raises.  The kernel
replaces no TPU kernel (``ltjax.spatial.hilbert_key`` is XLA ops): it
takes the plain version's ~300 elementwise launches over int64 tensors
a sort down to one launch, bound by its bytes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import state as st
from . import build

_C_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def hilbert_key(i, j, bits: int = 15):
    """Hilbert-curve index of non-negative int coords (i=x, j=y); the
    same int32 keys as ``ltjax.spatial.hilbert_key``."""
    mask = (1 << bits) - 1
    x = i.to(torch.int64).clamp(0, mask)
    y = j.to(torch.int64).clamp(0, mask)
    d = torch.zeros_like(x)
    s = 1 << (bits - 1)
    for _ in range(bits):
        rx = ((x & s) > 0).to(torch.int64)
        ry = ((y & s) > 0).to(torch.int64)
        d = d + s * s * ((3 * rx) ^ ry)
        # rotate the quadrant
        flip = (ry == 0) & (rx == 1)
        xf = torch.where(flip, s - 1 - x, x)
        yf = torch.where(flip, s - 1 - y, y)
        swap = ry == 0
        x, y = torch.where(swap, yf, xf), torch.where(swap, xf, yf)
        s >>= 1
    return d.to(torch.int32)


def _check_bands(n_bands: int) -> int:
    nb = int(n_bands)
    if not 1 <= nb <= 6:
        raise ValueError("n_bands must be in [1, 6] (int32 key room)")
    return nb


def plain_key(i, j, status, depth_band=None, n_bands: int = 1):
    """The sort key as PyTorch ops (int32; the values
    ``ltjax.spatial.sort_by_cell`` sorts on)."""
    parked = (status >= st.SETTLED) | (status < 0)
    if depth_band is None:
        key = hilbert_key(i, j).to(torch.int64)          # < 2^30
        key = key + parked.to(torch.int64) * (1 << 30)
    else:
        nb = _check_bands(n_bands)
        band = depth_band.to(torch.int64).clamp(0, nb - 1)
        band = torch.where(parked, 7, band)
        key = hilbert_key(i, j, bits=14).to(torch.int64) + (band << 28)
    return key.to(torch.int32)


def _lib():
    fn = build.load("sort_key").ltx_sort_key
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(i, j, status, depth_band):
    """Contiguous (N,) int32 tensors on one device."""
    dev, n = status.device, status.shape[0]
    for name, v in (("i", i), ("j", j), ("status", status),
                    ("depth_band", depth_band)):
        if v is None:
            continue
        if (v.dtype != torch.int32 or v.device != dev
                or tuple(v.shape) != (n,) or not v.is_contiguous()):
            raise ValueError(f"sort_key: {name} must be a contiguous ({n},) "
                             f"int32 tensor on {dev}, got {tuple(v.shape)} "
                             f"{v.dtype} on {v.device}")


def sort_key(i, j, status, depth_band=None, n_bands: int = 1):
    """The int32 Hilbert sort key of every slot (module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    dev = status.device
    if dev.type == "cpu":
        return plain_key(i, j, status, depth_band, n_bands)
    if dev.type != "cuda":
        raise ValueError(f"sort_key: unsupported device {dev}")
    _check(i, j, status, depth_band)
    nb = 1 if depth_band is None else _check_bands(n_bands)
    n = status.shape[0]
    key = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return key
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(i.data_ptr(), j.data_ptr(), status.data_ptr(),
                None if depth_band is None else depth_band.data_ptr(),
                key.data_ptr(), n, 15 if depth_band is None else 14, nb,
                st.SETTLED, stream)
    if rc != 0:
        raise RuntimeError(f"sort_key kernel launch failed: CUDA error {rc}")
    sort_key.launches += 1
    return key


sort_key.launches = 0     # every launch
