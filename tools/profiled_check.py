#!/usr/bin/env python3
"""Hold chip_smoke's fallback timing of K3 against the profiler's.

    python3 tools/profiled_check.py

Run from the root of a checkout of the port on one CUDA card.  For the
K3 builds b6, oyster and b7 of ``tools/lanes_ab.py`` (1,000,000
particles, the first launch's inputs), twice each: ``profiled_ms`` (the
profiler's device ms a launch), ``queued_ms`` (the calls queued behind a
spin kernel, CUDA events), ``profiled_ms`` on a kernel name that matches
nothing (its retries, then its fallback to ``queued_ms``) and
``cuda_time`` (the wrapper call's ms).  Prints one JSON line per build
and the card's name and power limit.
"""

import os
import sys

import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "tools"))

import chip_smoke as cs  # noqa: E402
import lanes_ab as lab  # noqa: E402
from ltjax_torch import packed as pk  # noqa: E402
from ltjax_torch.kernels import rk4_step as kr  # noqa: E402
from ltjax_torch.kernels import step_lanes as sl  # noqa: E402
from ltjax_torch.step import _sort, packed_window  # noqa: E402


def main(reps=10):
    if not torch.cuda.is_available():
        raise SystemExit("profiled_check: needs a CUDA device")
    dev = torch.device("cuda")
    cs.log(lab.card_name())
    for name in ("b6", "oyster", "b7"):
        ctx, cfg, p0, fs, t = lab.cell(name, dev)
        ps, _ = _sort(ctx.grid, p0)
        prec = packed_window(ctx, cfg, "per_step", fs)
        g, idt = ctx.grid, float(cfg.idt)
        tabs = pk.stage_value_tables(g, prec, t, idt)
        aux = sl.aux_tables(g, cfg, prec, t, idt)
        disp = kr.rk4_displacement_fused(g, tabs, ps.x, ps.y, ps.z,
                                         cfg.tension_sigma, cfg.z0, idt,
                                         stage1=cfg.Behavior == 7)

        def kernel():
            return sl.step_lanes_fused(ctx, cfg, cfg.seed, 0, ps, fs, tabs,
                                       aux, t, disp)

        r = {"build": name, "profiled": [], "queued": [], "fallback": [],
             "call": []}
        for _ in range(2):
            r["profiled"].append(cs.profiled_ms(torch, kernel, reps,
                                                "step_lanes_kernel"))
            r["queued"].append(cs.queued_ms(torch, kernel, reps))
            r["fallback"].append(cs.profiled_ms(torch, kernel, reps,
                                                "no_such_kernel"))
            r["call"].append(cs.cuda_time(torch, kernel, reps))
        cs.log(r)


if __name__ == "__main__":
    main()
