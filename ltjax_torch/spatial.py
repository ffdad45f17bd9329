"""Spatial locality: Hilbert ordering of the particle batch.

Counterpart of ``ltjax.spatial``.  On the GPU the sort gives each block
of the kernels' threads a small box of cells, which the block stages in
shared memory (``kernels.ext_step.block_boxes``); a block whose
particles are spread reads device memory instead.  The permutation
indexes each column directly: the TPU's packed-row gather workaround has
no purpose here.
"""

from __future__ import annotations

import torch

from . import state as st


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


def sort_by_cell(p: st.Particles, i, j, depth_band=None, n_bands: int = 1):
    """Hilbert-sort the state by cell index; returns (p_sorted, perm).

    Frozen particles (settled / dead / out of domain / errored) and the
    EMPTY slots of a sharded run's buffers (status -1) sort after all
    live ones, so they do not dilute the live blocks.

    ``depth_band`` (int array, clipped to ``[0, n_bands - 1]``,
    ``n_bands`` in 1..6): the band is the major key, Hilbert order (14
    bits) within each band, parked particles band 7, as
    ``ltjax.spatial.sort_by_cell``; ``step._sort_band`` makes the bands
    (``cfg.sort_depth_bands``)."""
    parked = (p.status >= st.SETTLED) | (p.status < 0)
    if depth_band is None:
        key = hilbert_key(i, j).to(torch.int64)          # < 2^30
        key = key + parked.to(torch.int64) * (1 << 30)
    else:
        nb = int(n_bands)
        if not 1 <= nb <= 6:
            raise ValueError("n_bands must be in [1, 6] (int32 key room)")
        band = depth_band.to(torch.int64).clamp(0, nb - 1)
        band = torch.where(parked, 7, band)
        key = hilbert_key(i, j, bits=14).to(torch.int64) + (band << 28)
    perm = torch.argsort(key, stable=True)
    return p.take(perm), perm


def unsort(p: st.Particles, perm) -> st.Particles:
    """Invert sort_by_cell's permutation (restores storage order)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return p.take(inv)
