#!/usr/bin/env python3
"""Where a traced episode of a benchmark cell spends the device's time,
by the program's spans.

    python3 tools/span_breakdown.py WORKLOAD SEED

Run from the root of a checkout on a machine with a CUDA device.  Sets
up the cell as ``python3 -m ltbench`` does, warms it with one episode
and runs ``ltbench.run.traced`` (one episode under ``torch.profiler``).
Prints one JSON line: the cell's per-layer metrics; the device-idle
seconds by the innermost program span open at each idle stretch
(``idle_by_span``, ``outside`` for the caller between the program's
calls); K1's ``active_steps`` counter beside the frozen work count's
estimate of it; the device milliseconds an external step under each
span (``device_ms_per_ext``) beside ``stepper_device_ms_per_ext``,
with K1's own records taken out of the ``k1`` span (``coverage``); the
window's length and the card's name and power limit.
"""

import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from ltbench import cell as cl, run as lr, spans, trace  # noqa: E402
from ltbench.layers import KERNELS  # noqa: E402
from ltbench.ref.config import Config as RefConfig  # noqa: E402


def main(workload: str, seed: int) -> dict:
    lr.cache_dirs(cl.ROOT)
    dev = torch.device("cuda", 0)
    cell = cl.find_cell(workload)
    inp = cl.make_inputs(cell, seed, dev)
    prog = cl.build_program(cell, inp, dev)
    run = lr.Runner(cell, prog, torch.arange(16), seed)
    run.episode()
    torch.cuda.synchronize()
    kept = {}
    profile = trace.profile

    def keep(*args, **kwargs):
        kept["t"] = profile(*args, **kwargs)
        return kept["t"]

    trace.profile = keep
    try:
        layer, _, extra = lr.traced(run, cell, inp, cl.ROOT,
                                            torch.cuda.synchronize)
    finally:
        trace.profile = profile
    t = kept["t"]
    n_ext = cell.episode
    by = {name[len(spans.PREFIX):] if name != spans.OUTSIDE else name:
          1e-3 * trace.busy_us(recs, t["span"]) / n_ext
          for name, recs in spans.device_by_span(t).items()}
    k1_ms, _ = trace.kernel_ms(t["device"], KERNELS["k1"])
    covered = sum(by.values()) - k1_ms / n_ext
    stepper = layer.get("stepper_device_ms_per_ext", {}).get("value")
    info = t["info"]
    opts = dataclasses.asdict(RefConfig(**cell.ltrans))
    work = lr.work(cell, inp, opts, prog.p0.x.element_size(),
                   info["chunks"], prog.cfg.internal_steps, info["launched"])
    return {
        "workload": workload, "seed": seed,
        "metrics": {k: v["value"] for k, v in layer.items()},
        "idle_by_span": spans.idle_by_span(t),
        "active_steps": (info["staging"] or {}).get("active_steps"),
        "active_steps_estimate": work.get("k1", {}).get("active_steps"),
        "device_ms_per_ext": by,
        "coverage": {"spans_less_k1_kernel": covered,
                     "stepper_device_ms_per_ext": stepper},
        "window_s": extra["window_s"], "busy_s": extra["busy_s"],
        "trace_complete": extra["trace_complete"],
        "device": torch.cuda.get_device_name(dev),
        "power_limit": lr.power_limit()}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], int(sys.argv[2]))), flush=True)
