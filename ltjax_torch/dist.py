"""Process groups of a sharded run (counterpart of ltjax's
``JAX_COORDINATOR_ADDRESS`` handling, ltjax/run.py:352-377).

A sharded run has ``mesh_particles * mesh_tiles`` ranks, one process
each.  Two ways to start them:

* under ``torchrun`` (or any launcher that sets ``RANK`` and
  ``WORLD_SIZE``, with ``MASTER_ADDR``/``MASTER_PORT`` and, on cards,
  ``LOCAL_RANK``): each process is one rank (``launch_env``);
* otherwise ``launch`` starts the ranks itself with the ``spawn`` start
  method (CUDA does not survive ``fork``), on a free localhost port, and
  stops the others when one fails.

On CUDA the backend is NCCL, one rank per card; on the CPU it is gloo.
The function-level ``run.run(..., backend="gloo")`` may place several
ranks on one card: gloo's collectives take no CUDA tensors, so ``Rank``
moves their buffers through host tensors, explicitly.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .trace import span

# collectives wait this long for a late rank before failing
TIMEOUT_S = 1800


@dataclass
class Rank:
    """This process's place in the (dp, tile) mesh and its collectives."""
    rank: int
    world: int
    ndp: int
    ntiles: int
    backend: str
    device: torch.device
    row_group: object = None     # the ranks of this rank's dp row

    @property
    def dp(self) -> int:
        return self.rank // self.ntiles

    @property
    def tile(self) -> int:
        return self.rank % self.ntiles

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A collective's buffer: host memory under gloo."""
        return t.cpu() if self.backend == "gloo" else t

    def exchange(self, send: torch.Tensor, counts) -> torch.Tensor:
        """all_to_all over the dp row: ``send`` holds counts[t] rows for
        tile t, in tile order (rows beyond their sum are not sent);
        ``counts`` a list of ints or an int64 tensor on this rank's
        device.  Returns the rows from every tile, in tile order, on this
        rank's device.  The counts travel first, on the device under
        NCCL; the send and receive counts then come to the host in one
        copy, the one wait (under gloo the rows pass through the host
        besides)."""
        with span("ltjax_torch.exchange"):
            c = self._out(torch.as_tensor(counts, dtype=torch.int64,
                                          device=self.device))
            got = torch.empty_like(c)
            dist.all_to_all_single(got, c, group=self.row_group)
            sizes = torch.cat([c, got]).tolist()
            sc, rc = sizes[:c.numel()], sizes[c.numel():]
            buf = self._out(send[:sum(sc)].contiguous())
            recv = buf.new_empty((sum(rc),) + tuple(buf.shape[1:]))
            dist.all_to_all_single(recv, buf, output_split_sizes=rc,
                                   input_split_sizes=sc,
                                   group=self.row_group)
            return recv.to(self.device)

    def sum(self, values) -> list:
        """Element-wise sum over every rank of a list of ints."""
        t = torch.tensor(values, dtype=torch.int64)
        t = self._out(t.to(self.device))
        dist.all_reduce(t)
        return [int(v) for v in t.cpu()]

    def gather_rows(self, rows: torch.Tensor) -> Optional[list]:
        """Every rank's (m, ...) rows (m equal on every rank) on rank 0, in
        rank order (None elsewhere)."""
        buf = self._out(rows.contiguous())
        out = ([torch.empty_like(buf) for _ in range(self.world)]
               if self.rank == 0 else None)
        dist.gather(buf, out, dst=0)
        return out

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def launch_env():
    """(rank, world, local_rank) from a launcher's environment (RANK,
    WORLD_SIZE, LOCAL_RANK), or None outside one.  RANK and WORLD_SIZE
    come together or not at all."""
    r, w = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if (r is None) != (w is None):
        raise RuntimeError("sharded launch: set BOTH RANK and WORLD_SIZE "
                           "(as torchrun does), or neither to let the run "
                           "start its ranks itself")
    if r is None:
        return None
    return int(r), int(w), int(os.environ.get("LOCAL_RANK", r))


def rank_device(device, backend: str, local_rank: int,
                world: int) -> torch.device:
    """A rank's device: the CPU (the ranks share its cores); under NCCL
    card ``local_rank`` (refused with fewer cards than ranks); under gloo
    on CUDA the ranks share the cards round-robin."""
    device = torch.device(device)
    if device.type != "cuda":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= count:
        raise RuntimeError(f"sharded run: NCCL takes one card per rank; "
                           f"local rank {local_rank} needs {local_rank + 1} "
                           f"cards, the machine has {count}")
    return torch.device("cuda", local_rank % count)


def init(rank: int, world: int, ndp: int, ntiles: int, backend: str,
         device: torch.device, init_method: str) -> Rank:
    """Join the process group and make one subgroup per dp row (every
    rank makes every subgroup, in the same order)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **kw)
    me = Rank(rank=rank, world=world, ndp=ndp, ntiles=ntiles,
              backend=backend, device=device)
    for d in range(ndp):
        g = dist.new_group([d * ntiles + t for t in range(ntiles)])
        if d == me.dp:
            me.row_group = g
    return me


def close():
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, init_method, out_dir, args):
    """A spawned rank: run fn(rank, world, init_method, *args) and save
    its result (torch.save) or its error message for the launcher."""
    try:
        res = fn(rank, world, init_method, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException as e:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
        raise
    finally:
        close()


def launch(fn, world: int, args=(), poll_s: float = 0.5,
           grace_s: float = 10.0) -> list:
    """Start ``world`` ranks (spawn), each running ``fn(rank, world,
    init_method, *args)`` (``fn`` importable by name, ``args``
    picklable), and return their results in rank order.  If a rank
    fails, the others get ``grace_s`` seconds to end (ranks that decided
    to stop together all end with their own error) and are then stopped;
    RuntimeError names the failed ranks and their exit codes, with the
    first error."""
    import multiprocessing.connection as mpc
    ctx = torch.multiprocessing.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="ltjax_ranks_") as out_dir:
        procs = [ctx.Process(target=_entry, args=(fn, r, world, init_method,
                                                   out_dir, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            live, deadline = list(procs), None
            while live and (deadline is None or time.time() < deadline):
                mpc.wait([p.sentinel for p in live], timeout=poll_s)
                live = [p for p in live if p.exitcode is None]
                if deadline is None and any(p.exitcode not in (None, 0)
                                            for p in procs):
                    deadline = time.time() + grace_s
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.exitcode is None:
                    p.kill()
                    p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            msgs = []
            for r in failed:
                path = os.path.join(out_dir, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        msgs.append(f"rank {r}: {f.read()}")
            codes = {r: procs[r].exitcode for r in failed}
            raise RuntimeError(
                f"sharded run: ranks {failed} failed (exit codes {codes})"
                + ("\n" + msgs[0] if msgs else ""))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
