#!/usr/bin/env python3
"""Time the advection kernel on chip_smoke.py's phase-1 inputs two ways.

    python3 tools/kernel_ab.py LABEL

Run from the root of a checkout of the port (any commit whose
chip_smoke.py has phase 1; copy this file into an older checkout to
time it): 65,536 sorted particles on the 200x200x20 bench grid with a
land block, one external step of 30 internal steps.  Prints one JSON
line with the wrapper's time per call (CUDA events over 10 calls, three
times: it includes the host's preparation of each launch) and the
kernel's own device time (torch.profiler over 10 calls).  Compare two
checkouts in one machine session, in turns (A, B, B, A).
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from ltjax_torch import packed as pk, state as st, synth  # noqa: E402
from ltjax_torch.kernels import ext_step as kx  # noqa: E402
from ltjax_torch.step import _sort  # noqa: E402


def main(label: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    dev = torch.device("cuda")
    case = cs.bench_case(torch, dev)
    ctx = cs.context(case)
    n = 65536
    cfg = cs.make_cfg(n, TrackCollisions=True)
    fs = synth.fieldset_for(case, t_center=0.0, dt=3600.0, device=dev)
    x, y, _ = cs.water_particles(case, n, 2e3, 198e3, seed=1)
    z = cs.near_surface_and_bottom(n, case.h0, seed=4)
    p = st.init_particles(x, y, z, dtype=torch.float32, device=dev)
    p = p.replace(status=torch.full_like(p.status, st.ACTIVE))
    p, _ = _sort(case.grid, p)
    prec = pk.build_packed_records(case.grid, fs)

    def step():
        return kx.ext_step_fused(ctx, cfg, p, prec, 0.0)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wrapper_ms = [cs.cuda_time(torch, step, 10) for _ in range(3)]
    t = time.perf_counter()
    for _ in range(10):
        step()
    enqueue_ms = (time.perf_counter() - t) * 100
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
        torch.cuda.synchronize()
    device_ms = [e.device_time_total / e.count / 1e3
                 for e in prof.key_averages() if "ext_step_kernel" in e.key]
    print(json.dumps({"tree": label, "card": torch.cuda.get_device_name(0),
                      "wrapper_ms": wrapper_ms,
                      "enqueue_ms_per_call": enqueue_ms,
                      "kernel_device_ms": device_ms}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
