"""Faults planted under the sharded timed path, one function each: each
runs first in every rank of ``ltbench.sharded.measure`` (``prepare``) and
breaks the program there."""

import torch


def _wrap_steps(after):
    """Make every tiled stepper return ``after(p_in, p_out)``."""
    from ltjax_torch import shard
    make = shard.make_tiled_steps

    def broken(*args, **kwargs):
        fused = make(*args, **kwargs)

        def call(p, fsR, t0, ext_idx0=0):
            out, drops, sent = fused(p, fsR, t0, ext_idx0)
            return after(p, out), drops, sent
        return call
    shard.make_tiled_steps = broken


def small_mig_cap(rank):
    """One migration slot a destination: leavers beyond it stay home
    flagged ERROR, counted as drops."""
    from ltjax_torch import shard
    make = shard.make_spec
    shard.make_spec = lambda *a, **k: make(*a, **k)._replace(mig_cap=1)


def lose_row(rank):
    """Rank 0's exchange loses the first row it receives."""
    from ltjax_torch import dist
    exchange = dist.Rank.exchange

    def lossy(self, send, counts):
        recv = exchange(self, send, counts)
        return recv[1:] if rank == 0 and len(recv) else recv
    dist.Rank.exchange = lossy


def other_strip(rank):
    """Every rank steps on the next strip's records."""
    from ltjax_torch import shard
    cut = shard.strip_fieldset
    shard.strip_fieldset = lambda fs, spec, tile, ny: cut(
        fs, spec, (tile + 1) % spec.ntiles, ny)


def no_exchange(rank):
    """No migration: leavers stay on their rank's strip."""
    from ltjax_torch import shard

    def stay(p, spec, edges, my_t, sent, exchange):
        zero = torch.zeros((), dtype=torch.int64, device=p.x.device)
        return p, zero, zero
    shard.migrate = stay


def unchanged(rank):
    """The steps return the state they were given."""
    _wrap_steps(lambda p, out: p)


def half(rank):
    """Half of each rank's slots left as they were given."""
    def after(p, out):
        h = p.n // 2
        return out.replace(**{k: torch.cat([getattr(out, k)[:h],
                                            getattr(p, k)[h:]])
                              for k in ("x", "y", "z", "status", "age")})
    _wrap_steps(after)


def altered(rank):
    """One answer in 64 moved 1 m where it is produced."""
    def after(p, out):
        x = out.x.clone()
        x[::64] += 1.0
        return out.replace(x=x)
    _wrap_steps(after)
