"""Particle migration between eta strips on the card: the wrapper of
``csrc/migrate.cu``.

``migrate(p, spec, tile_edges, my_t, sent, exchange)`` computes what
``shard.plain_migrate`` computes, slot for slot and byte for byte (the new
block's columns, the rows sent and their counts, ``drops`` and ``sent``),
with four kernels and one host read: the send counts go to ``exchange`` as
an int64 tensor on the card, whose all_to_all of counts and one copy of
the send and receive counts to the host are the only wait.
``shard.migrate`` calls it for CUDA tensors and takes the plain version
for CPU tensors; here a tensor off the card raises, and so does a failed
build or launch.  Every call counts one in ``migrate.launches``.

The kernels replace no TPU kernel (``ltjax.shard._migrate`` is XLA ops):
they take the plain version's some twenty passes over every slot of the
block (cumsums, packed rows, gathers, concatenations) down to two reads
of y and status, one copy of each particle that stays or arrives, and
the sentinel written into the rest, bound by their bytes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import state as st
from ..shard import EMPTY, FLOATS, INTS
from . import build

THREADS = 1024          # slots a block (csrc/migrate.cu)
MAX_TILES = 256         # destinations a block can count in shared memory

_P = ctypes.c_void_p
_I = ctypes.c_int
_SPLIT = [_I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
_MERGE = [_I, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P]


def _lib():
    lib = build.load("migrate")
    for fn, args in ((lib.ltx_migrate_split, _SPLIT),
                     (lib.ltx_migrate_merge, _MERGE)):
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def row_bytes(dtype) -> int:
    """Bytes of one packed row (``shard.pack_rows``) for positions of
    ``dtype``."""
    return torch.finfo(dtype).bits // 8 * len(FLOATS) + 4 * len(INTS)


def _blocks(n: int) -> int:
    return max(1, -(-n // THREADS))


def _check(p: st.Particles, tile_edges, sent, ntiles: int):
    dev, n, dtype = p.x.device, p.n, p.x.dtype
    if dev.type != "cuda":
        raise ValueError(f"migrate kernel: CUDA tensors only, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"migrate kernel: positions float32 or float64, "
                         f"got {dtype}")
    if not 1 <= ntiles <= MAX_TILES:
        raise ValueError(f"migrate kernel: 1 to {MAX_TILES} tiles, got "
                         f"{ntiles}")
    for k in FLOATS + INTS:
        v = getattr(p, k)
        want = dtype if k in FLOATS else torch.int32
        if (v.dtype != want or v.device != dev or tuple(v.shape) != (n,)
                or not v.is_contiguous()):
            raise ValueError(f"migrate kernel: {k} must be a contiguous "
                             f"({n},) {want} tensor on {dev}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")
    for name, v, want, shape in (
            ("tile_edges", tile_edges, torch.float64, (ntiles + 1,)),
            ("sent", sent, torch.uint8, (1, row_bytes(dtype)))):
        if (v.dtype != want or v.device != dev or tuple(v.shape) != shape
                or not v.is_contiguous()):
            raise ValueError(f"migrate kernel: {name} must be a contiguous "
                             f"{shape} {want} tensor on {dev}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")


def _ptrs(cols) -> ctypes.Array:
    return (ctypes.c_void_p * len(cols))(*(c.data_ptr() for c in cols))


def migrate(p: st.Particles, spec, tile_edges: torch.Tensor, my_t: int,
            sent: torch.Tensor, exchange):
    """``shard.plain_migrate`` on CUDA tensors (see the module's
    docstring): ``exchange(rows, counts)`` gets the send buffer (at least
    ``counts.sum()`` rows, the rest unused) and ``counts`` as an int64
    tensor on the card; it returns the rows received, uint8 on the card.
    Returns (p', drops, sent_count), int64 device scalars."""
    nt, mc, n = spec.ntiles, spec.mig_cap, p.n
    _check(p, tile_edges, sent, nt)
    dev, dtype = p.x.device, p.x.dtype
    rb, pos64 = row_bytes(dtype), int(dtype == torch.float64)
    nb = _blocks(n)
    scratch = torch.zeros(6 + nt + nb + nb * nt, dtype=torch.int32,
                          device=dev)
    out64 = torch.empty(nt + 2, dtype=torch.int64, device=dev)
    cols_in = [getattr(p, k) for k in FLOATS + INTS]
    cols_out = [torch.empty_like(c) for c in cols_in]
    send = torch.empty((min(n, (nt - 1) * mc), rb), dtype=torch.uint8,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    rc = lib.ltx_migrate_split(
        pos64, _ptrs(cols_in), _ptrs(cols_out), n, tile_edges.data_ptr(), nt,
        int(my_t), mc, EMPTY, st.ERROR, scratch.data_ptr(),
        out64.data_ptr(), send.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"migrate kernel launch failed: CUDA error {rc}")
    recv = exchange(send, out64[:nt])
    m = recv.shape[0]
    if (recv.dtype != torch.uint8 or recv.device != dev
            or tuple(recv.shape) != (m, rb) or not recv.is_contiguous()):
        raise ValueError(f"migrate kernel: the exchange must return "
                         f"contiguous (m, {rb}) uint8 rows on {dev}, got "
                         f"{tuple(recv.shape)} {recv.dtype} on {recv.device}")
    acount = torch.empty(_blocks(m), dtype=torch.int32, device=dev)
    rc = lib.ltx_migrate_merge(
        pos64, _ptrs(cols_out), n, nt, recv.data_ptr(), m, sent.data_ptr(),
        EMPTY, scratch.data_ptr(), acount.data_ptr(), out64.data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"migrate kernel launch failed: CUDA error {rc}")
    migrate.launches += 1
    out = st.Particles(**dict(zip(FLOATS + INTS, cols_out)))
    return out, out64[nt], out64[nt + 1]


migrate.launches = 0      # every call (its four kernels)
