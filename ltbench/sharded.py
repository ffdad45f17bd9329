"""A cell on several cards: ``mesh_particles * mesh_tiles`` ranks, one
process a card, on the program's own sharded path (``ltjax_torch.shard``
with ``ltjax_torch.dist``), driven as its CLI drives it
(``ltjax_torch.run._rank_run``).

The parent (``measure``) builds the cell's kernel variants once
(``kernels.build.prebuild``: four ranks building one library at first use
would race) and starts the ranks with ``dist.launch`` (spawned, on a free
localhost port; NCCL on the cards, gloo on the CPU).  Each rank:

* makes the cell's inputs from the seed (``cell.make_inputs``), builds the
  program's context (``cell.build_program``) and cuts its strip:
  ``shard.make_spec`` (the configuration's ``halo_rows`` and
  ``migrate_capacity``), ``build_tiled_static``, ``tile_context``,
  ``strip_fieldset`` and ``scatter_block``.  It then drops the whole ring
  of records and the whole release from its card (both are the
  harness's) and resets the card's peak: ``peak_device_gib`` covers the
  program's context, strip, slots and steps from here on;
* warms one episode, then drives ``shard.make_tiled_steps(...,
  exchange=Rank.exchange)`` chunk by chunk through episodes from the
  release (``TiledRunner``), each chunk ending as the CLI's does: the
  status counts (the host sync) and one sum over the ranks of the counts,
  the drops and the migrated particles;
* opens the window at a barrier (``run.window``).  Rank 0 decides at
  each episode end whether the window closes and every rank learns it
  from a sum, so that
  all ranks stop on the same chunk.  The rate counts ``numpar`` particles,
  not the slots of the ranks' buffers (EMPTY ones included), over rank
  0's window;
* with ``--trace 1`` traces one more episode (every rank the same one;
  a window that lost records is traced again on every rank) and reads
  every per-layer metric from its own trace, with ``obs["ranks"]``: each
  rank's traced window, busy time, K1 ms, particles held at the
  episode's start and end, migrated and dropped.  The result takes the
  readings of the pace-setting rank, the one whose device worked longest
  outside NCCL's kernels: the others wait for it in every all_to_all,
  their NCCL kernels spinning (busy on the trace's timeline);
* at the end of the kept episode (drawn from the seed, as on one card)
  sends rank 0 its sampled particles by ``pid``.

Rank 0 then makes the inputs again from the seed, runs the plain
reference on the whole ring and compares as the one-card cells do
(``run.compare``), with two more numbers: ``migration_drops`` (the
window's drops summed over the ranks: leavers beyond ``mig_cap`` and
arrivals beyond ``cap``) and ``held_gap`` (``numpar`` less the particles
the ranks hold at the kept episode's end: a row the exchange lost or
duplicated); ``route_mismatch`` counts the ranks off the route.  A
sampled particle that no rank holds, or that two hold, counts as a
status mismatch.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import torch

from . import cell as cl, inputs, layers, run as lr, trace

MISSING, TWICE = -99, -98      # statuses no particle has: mismatches
FIELDS = ("zeta", "u", "v", "w", "aks", "salt", "temp", "times")


def mesh(cell: cl.Cell) -> tuple:
    """(mesh_particles, mesh_tiles) of the cell's configuration."""
    lt = cell.ltrans
    return int(lt.get("mesh_particles", 1)), int(lt.get("mesh_tiles", 1))


def prebuild(cell: cl.Cell, control: str = None) -> None:
    """Build the kernel variants the cell's ranks run, once."""
    from ltjax_torch.kernels import build
    from ltjax_torch.run import kernel_targets
    cfg = cl.program_config(cell, 0, control)
    grid = cl.program_grid(cl.grid_arrays(cell), getattr(torch, cfg.dtype_pos),
                           "cpu")
    build.prebuild(kernel_targets(cfg, grid, tile=True))


def measure(cell: cl.Cell, seed: int, seconds: float, with_trace: bool,
            device, root: str, t_start: float, control: str = None,
            logging: bool = False, prepare=None) -> dict:
    """One run of a cell on ``cell.chips`` ranks: ``run.measure``'s
    fields from rank 0, with the device's name (``kind``) and the modules
    of JAX any rank loaded (``banned``).  ``t_start`` is the process's
    start on the clock of ``time.perf_counter`` (CLOCK_MONOTONIC, one
    clock for every process of the machine); ``prepare(rank)``, a function
    importable by name, runs first in every rank (the tests plant faults
    with it).  Raises RuntimeError when a rank fails."""
    from ltjax_torch import dist
    if cl.grid_arrays(cell).x_rho.ndim == 2:
        raise RuntimeError(
            f"{cell.name}: a curvilinear grid runs on one card only (the "
            "program cuts no eta strips of a curvilinear grid)")
    ndp, ntiles = mesh(cell)
    if ndp * ntiles != cell.chips:
        raise ValueError(f"{cell.name}: a mesh of {ndp} x {ntiles} ranks "
                         f"on {cell.chips} cards")
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        prebuild(cell, control)
    out = dist.launch(_rank, cell.chips,
                      (cell, seed, seconds, with_trace, str(device), root,
                       t_start, control, backend, logging, prepare))
    res = out[0]
    res["banned"] = sorted({m for r in out for m in r["banned"]})
    return res


class TiledRunner(lr.Runner):
    """Drives one rank's tiled external steps chunk by chunk through
    episodes, as the CLI's sharded loop drives them; the episodes and the
    kept one as ``run.Runner``'s."""

    def __init__(self, cell, cfg, tctx, spec, me, edges, strip, block,
                 rows, seed: int):
        from ltjax_torch import shard
        super().__init__(cell, cfg, block, seed)
        self.shard = shard
        self.tctx, self.spec, self.me, self.edges = tctx, spec, me, edges
        self.cols = [getattr(strip, k) for k in FIELDS]
        self.fields = type(strip)
        self.held0 = sum(self.step.summary_counts(block).values())
        self.want = torch.zeros(cell.numpar, dtype=torch.bool,
                                device=block.x.device)
        self.want[rows.to(block.x.device)] = True
        self.drops = 0           # every rank's, since the start
        self.held = 0            # every rank's, after the last chunk
        self.kept_held = None    # every rank's, at the kept episode's end
        self.ep = {}             # this rank's, in the last episode

    def window(self, e0: int, n_ext: int):
        return self.fields(*(c[e0:e0 + n_ext + 2] for c in self.cols))

    def sample(self) -> dict:
        """This rank's particles of the sample, by pid, on the host."""
        p = self.p
        m = (p.status != self.shard.EMPTY) & self.want[
            p.pid.long().clamp(min=0)]
        idx = torch.nonzero(m)[:, 0]
        self.kept_held = self.held
        return {k: getattr(p, k)[idx].cpu() for k in ("pid",) + lr.COLUMNS}

    def chunk(self) -> dict:
        cfg, ep = self.cfg, self.cell.episode
        if self.e_in == 0:
            self.ep = {"held_start": self.held0, "migrated": 0, "drops": 0}
        E = min(max(1, cfg.ext_fuse), ep - self.e_in)
        if E not in self.fused:
            self.fused[E] = self.shard.make_tiled_steps(
                self.tctx, cfg, self.spec, self.me.tile, self.edges, E,
                self.me.exchange)
        self.p, drops, sent = self.fused[E](
            self.p, self.window(self.e_in, E), float(self.e_in * cfg.dt),
            self.ext)
        local = self.step.summary_counts(self.p)    # waits for the device
        mine = [int(drops), int(sent)]
        tot = self.me.sum(list(local.values()) + mine)   # the CLI's halt
        self.ep["migrated"] += mine[1]
        self.ep["drops"] += mine[0]
        self.ep["held_end"] = sum(local.values())
        self.drops += tot[-2]
        self.held = sum(tot[:-2])
        self.e_in += E
        self.ext += E
        self.particle_steps += self.cell.numpar * cfg.internal_steps * E
        self.chunks += 1
        if self.e_in == ep:
            self.end_episode()
        return local


def gather_sample(rows: torch.Tensor, parts: list, dtype) -> dict:
    """The ranks' sampled particles as one column each in the order of
    ``rows`` (sorted pids); a pid that no rank holds has status MISSING,
    one that two hold TWICE."""
    pid = torch.cat([p["pid"] for p in parts]).long()
    idx = torch.searchsorted(rows, pid)
    n = len(rows)
    seen = torch.bincount(idx, minlength=n)
    got = {}
    for k in lr.COLUMNS:
        v = torch.cat([p[k] for p in parts])
        col = torch.full((n,), float("nan"), dtype=v.dtype) \
            if v.is_floating_point() else torch.zeros(n, dtype=v.dtype)
        col[idx] = v
        got[k] = col
    st = got["status"]
    st[seen == 0] = MISSING
    st[seen > 1] = TWICE
    for k in ("x", "y", "z", "salt", "temp"):
        got[k] = got[k].to(dtype)
    return got


def _rank(rank, world, init_method, cell, seed, seconds, with_trace, device,
          root, t_start, control, backend, logging, prepare):
    """One rank of ``measure``; see the module's docstring."""
    import torch.distributed as tdist
    from ltjax_torch import dist, shard
    from ltjax_torch.step import mode_flags
    if prepare is not None:
        prepare(rank)
    phases = {"started": time.perf_counter() - t_start}
    ndp, ntiles = mesh(cell)
    dev = dist.rank_device(device, backend, rank, world)
    cuda = dev.type == "cuda"
    if cuda:
        torch.set_num_threads(2)
    me = dist.init(rank, world, ndp, ntiles, backend, dev, init_method)
    phases["joined"] = time.perf_counter() - t_start

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def log(obj):
        if logging:
            print(json.dumps({"rank": rank, **obj}), file=sys.stderr,
                  flush=True)

    inp = cl.make_inputs(cell, seed, dev)
    sync()
    phases["inputs"] = time.perf_counter() - t_start
    prog = cl.build_program(cell, inp, dev, dtype_pos=control)
    phases["program"] = time.perf_counter() - t_start
    cfg, grid = prog.cfg, prog.ctx.grid
    spec = shard.make_spec(cfg, grid.ny, cell.numpar, ndp, ntiles,
                           halo=cfg.halo_rows, slack=cfg.migrate_capacity)
    tiled = shard.build_tiled_static(grid, spec)
    tctx = shard.tile_context(prog.ctx, spec, tiled, me.tile)
    strip = shard.strip_fieldset(prog.fields(*inp.records.columns()), spec,
                                 me.tile, grid.ny)
    block = shard.scatter_block(prog.p0, spec, tiled.tile_edges, me.dp,
                                me.tile).to(dev)
    route = mode_flags(tctx, cfg)
    pos_bytes = block.x.element_size()
    # the whole ring and the whole release are the harness's: every rank
    # drops them from its card once its strip is cut (rank 0 makes them
    # again for the reference), and the peak counts from here
    prog = None
    r = inp.release
    inp.records = None
    inp.release = dataclasses.replace(r, x=r.x.cpu(), y=r.y.cpu(),
                                      z=r.z.cpu())
    r = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    rows = inputs.sample_rows(cell.numpar, min(cell.numpar,
                                               int(cell.traffic["sample"])),
                              seed)
    run = TiledRunner(cell, cfg, tctx, spec, me, tiled.tile_edges, strip,
                      block, rows, seed)
    phases["strip"] = time.perf_counter() - t_start
    run.episode()                                   # warm: every shape
    sync()
    phases["warm"] = time.perf_counter() - t_start

    # --- the window ---------------------------------------------------
    me.barrier()
    setup_s = time.perf_counter() - t_start
    drops0 = run.drops
    win = lr.window(run, lambda s: me.sum([int(rank == 0
                                                and s >= seconds)])[0])
    rate = win["particle_steps"] / win["window_s"]
    drops = run.drops - drops0
    route_ok, want = lr.on_route(cell, route, win, cfg.internal_steps, cuda)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log({"seed": seed, "setup_s": setup_s, "setup_phases": phases,
         "window_s": win["window_s"], "chunks": run.chunks, "route": route,
         "launches": win["launches"], "expected": want,
         "episodes": run.episodes, "chunk_s": win["chunk_s"],
         "cap": spec.cap, "mig_cap": spec.mig_cap, "halo": spec.halo,
         "held": run.held0, "last_episode": run.ep, "peak": peak})

    traced = None
    if with_trace:
        me.barrier()
        best = lr.trace_episode(
            run, sync, agree=lambda ok: me.sum([int(not ok)])[0] == 0)
        staging = best["info"]["staging"]
        obs = lr.observe(cell, inp, root, best, pos_bytes,
                         cfg.internal_steps, ny=spec.ny_ext,
                         numpar=0.5 * (run.ep["held_start"]
                                       + run.ep["held_end"]),
                         act=(staging or {}).get("active_steps") or None)
        k1 = layers.roofline(obs, "k1")
        own = [d for d in best["device"] if not d[0].startswith("nccl")]
        mine = {"rank": rank, "tile": me.tile,
                "window_s": 1e-6 * layers.window_us(obs),
                "busy_s": 1e-6 * trace.busy_us(best["device"], best["span"]),
                "work_s": 1e-6 * trace.busy_us(own, best["span"]),
                "k1_ms": k1["device_ms"] if k1 else None, **run.ep}
        ranks = [None] * world
        tdist.all_gather_object(ranks, mine)
        obs["ranks"] = ranks
        traced = lr.readings(cell, root, obs)
        traced[2]["ranks"] = ranks

    ext_first, sampled = run.kept
    held = run.kept_held
    mine = {"sampled": sampled, "peak": peak, "route_ok": route_ok,
            "traced": traced}
    parts = [None] * world if rank == 0 else None
    tdist.gather_object(mine, parts, dst=0)
    if rank:
        return {"banned": lr.banned_modules()}

    # --- the reference and the comparison (rank 0) --------------------
    n_episodes = run.episodes
    del run, block, strip, tctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = gather_sample(rows, [p["sampled"] for p in parts],
                        getattr(torch, cfg.dtype_pos))
    inp = cl.make_inputs(cell, seed, dev)        # the same, from the seed
    correct, failed, checks, values = lr.compare(
        cell, inp, rows, got, ext_first, dev, sync,
        {"route_mismatch": sum(not p["route_ok"] for p in parts),
         "migration_drops": drops, "held_gap": abs(cell.numpar - held)},
        log, episodes=n_episodes)
    peak = max(p["peak"] for p in parts)
    breakdown, extra = None, {}
    if with_trace:
        tr = [p["traced"] for p in parts]
        work = [r["work_s"] for r in tr[0][2]["ranks"]]
        pace = max(range(world), key=work.__getitem__)
        metrics, breakdown, extra = tr[pace]
        extra = {**extra, "pace_rank": pace,
                 "busy_s": sum(t[2]["busy_s"] for t in tr) / world,
                 "window_s": sum(t[2]["window_s"] for t in tr) / world}
    else:
        metrics = lr.end_to_end(cell, rate, peak, setup_s)
    return {"correct": bool(correct), "attempted": len(rows),
            "failed": failed, "metrics": metrics, "peak": peak,
            "breakdown": breakdown, "extra": extra, "checks": checks,
            "values": values, "sampled": got,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "particle_steps": win["particle_steps"],
            "window_s": win["window_s"], "banned": lr.banned_modules()}
