"""Spatial locality: Hilbert ordering of the particle batch.

Counterpart of ``ltjax.spatial``.  On the GPU the sort gives each block
of the kernels' threads a small box of cells, which the block stages in
shared memory (``kernels.ext_step.block_boxes``); a block whose
particles are spread reads device memory instead.  The permutation
indexes each column directly: the TPU's packed-row gather workaround has
no purpose here.  The sort key (``kernels.sort_key``: ``hilbert_key``
and the parked and band terms) is one kernel launch on the card, its
plain version on the CPU.
"""

from __future__ import annotations

import torch

from . import state as st
from .kernels import sort_key as sk


def sort_by_cell(p: st.Particles, i, j, depth_band=None, n_bands: int = 1):
    """Hilbert-sort the state by cell index; returns (p_sorted, perm).

    Frozen particles (settled / dead / out of domain / errored) and the
    EMPTY slots of a sharded run's buffers (status -1) sort after all
    live ones, so they do not dilute the live blocks.

    ``depth_band`` (int array, clipped to ``[0, n_bands - 1]``,
    ``n_bands`` in 1..6): the band is the major key, Hilbert order (14
    bits) within each band, parked particles band 7, as
    ``ltjax.spatial.sort_by_cell``; ``step._sort_band`` makes the bands
    (``cfg.sort_depth_bands``).  Every key lies below 2^31: the stable
    sort runs on int32 keys."""
    key = sk.sort_key(i, j, p.status, depth_band, n_bands)
    perm = torch.argsort(key, stable=True)
    return p.take(perm), perm


def unsort(p: st.Particles, perm) -> st.Particles:
    """Invert sort_by_cell's permutation (restores storage order)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return p.take(inv)
