"""The migration's kernels (``kernels/migrate.py``) from the CPU: what
surrounds them.  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``: bit for bit against the plain version).

* ``dist.Rank.exchange`` takes the send counts as an int64 tensor as well
  as a list, over gloo: the same rows either way, send rows beyond the
  counts' sum left unsent;
* ``shard.migrate`` on CPU tensors is the plain version, under the span
  ``ltjax_torch.migrate`` with ``ltjax_torch.exchange`` inside it;
* the wrapper refuses CPU tensors; a packed row is 76 bytes in float64
  and 48 in float32;
* ``run.kernel_targets`` names the kernels' library on the tiles of more
  than one strip, and only there;
* ``synth.migration_block`` makes the block its arguments ask for.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ltjax_torch import dist, run as trun, shard, synth
from ltjax_torch import state as st
from ltjax_torch.config import Config
from ltjax_torch.kernels import migrate as km

torch.set_num_threads(1)

WORLD = 3


def _rows(rank, counts, extra=0):
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randint(0, 256, (sum(counts) + extra, 48),
                         dtype=torch.uint8, generator=g)


def _exchange_rank(rank, world, init_method):
    me = dist.init(rank, world, 1, world, "gloo", torch.device("cpu"),
                   init_method)
    counts = [(rank + 2 * t) % 4 for t in range(world)]
    rows = _rows(rank, counts, extra=5)
    as_list = me.exchange(rows[:sum(counts)], counts)
    as_tensor = me.exchange(rows, torch.tensor(counts, dtype=torch.int64))
    # one migrate of a block of this tile's under the profiler
    p, edges = synth.migration_block(600, 400, 60, ntiles=world, my_t=rank,
                                     seed=rank)
    sent_row = shard.pack_rows(shard.sentinel(p.x.dtype, "cpu", 0.0, 0.0))
    spec = shard.TileSpec(ndp=1, ntiles=world, halo=1, ny_loc=1, cap=p.n,
                          mig_cap=p.n)
    edges = torch.as_tensor(edges)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = shard.migrate(p, spec, edges, rank, sent_row, me.exchange)
    want = shard.plain_migrate(p, spec, edges, rank, sent_row, me.exchange)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.name.startswith("ltjax_torch.")),
                   key=lambda s: s[1])
    return {"as_list": as_list, "as_tensor": as_tensor,
            "spans": spans, "got": got, "want": want}


@pytest.fixture(scope="module")
def exchanged():
    return dist.launch(_exchange_rank, WORLD)


def test_exchange_takes_device_counts_over_gloo(exchanged):
    for rank, r in enumerate(exchanged):
        assert torch.equal(r["as_list"], r["as_tensor"])
        # the rows from every tile in tile order, counts[t] of sender s
        want = []
        for s in range(WORLD):
            counts = [(s + 2 * t) % 4 for t in range(WORLD)]
            start = sum(counts[:rank])
            want.append(_rows(s, counts)[start:start + counts[rank]])
        assert torch.equal(r["as_tensor"], torch.cat(want))


def test_migrate_on_the_cpu_is_the_plain_version_under_its_spans(exchanged):
    for r in exchanged:
        (got, gd, gs), (want, wd, ws) = r["got"], r["want"]
        for k in st.FIELDS:
            assert torch.equal(getattr(got, k), getattr(want, k)), k
        assert int(gd) == int(wd) and int(gs) == int(ws) and int(gs) > 0
        names = [s[0] for s in r["spans"]]
        assert names == ["ltjax_torch.migrate", "ltjax_torch.exchange"]
        (_, m0, m1), (_, e0, e1) = r["spans"]
        assert m0 <= e0 and e1 <= m1


def _block(n=256, dtype=torch.float64):
    p, edges = synth.migration_block(n, n // 2, n // 8, dtype=dtype)
    spec = shard.TileSpec(ndp=1, ntiles=4, halo=1, ny_loc=1, cap=n,
                          mig_cap=n)
    sent_row = shard.pack_rows(shard.sentinel(dtype, "cpu", 0.0, 0.0))
    return p, spec, torch.as_tensor(edges), sent_row


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    p, spec, edges, sent_row = _block()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        km.migrate(p, spec, edges, 1, sent_row, None)
    assert km.row_bytes(torch.float64) == 76
    assert km.row_bytes(torch.float32) == 48
    assert shard.pack_rows(p).shape == (p.n, 76)


@pytest.mark.parametrize("tiles,tile,named", [(4, True, True),
                                              (1, True, False),
                                              (4, False, False)])
def test_kernel_targets_name_the_migration_on_strips(tiles, tile, named):
    g = synth.make_solid_body_case(nx=9, ny=9, us=4, lx=8e3, ly=8e3).grid
    for kw in ({}, dict(fast_interp=False)):
        cfg = Config(numpar=1, us=4, ws=5, mesh_tiles=tiles, **kw)
        targets = trun.kernel_targets(cfg, g, tile=tile)
        assert (("migrate", None) in targets) == named


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_migration_block_holds_what_it_was_asked_for(dtype):
    p, edges = synth.migration_block(5000, 3000, 300, ntiles=4, my_t=2,
                                     dtype=dtype, seed=3)
    live = p.status != shard.EMPTY
    assert int(live.sum()) == 3000
    dest = np.clip(np.searchsorted(edges, p.y.double().numpy(),
                                   side="right") - 1, 0, 3)
    assert int((dest[live.numpy()] != 2).sum()) == 300
    assert p.x.dtype == dtype and p.status.dtype == torch.int32
    assert set(p.status[live].tolist()) == set(range(6))
    q, _ = synth.migration_block(100, 100, 0, edge_cases=True)
    assert torch.isnan(q.y).sum() == 1 and torch.isinf(q.y).sum() == 2
    assert (q.y == 1000.0).sum() == 1
