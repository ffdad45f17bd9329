"""Arithmetic the per-layer readers share: the traced window's busy time
and a kernel's share of its roofline, from the trace, the wrappers'
launch counts and the frozen work count (``ltbench.workcount``)."""

from __future__ import annotations

from typing import Optional

from . import trace, workcount

# the device functions of the kernels, as the profiler names them
KERNELS = {"k1": "ext_step_kernel", "k2": "rk4_step_kernel",
           "k3": "step_lanes_kernel"}


def window_us(obs: dict) -> float:
    a0, a1 = obs["trace"]["span"]
    return a1 - a0


def roofline(obs: dict, kernel: str) -> Optional[dict]:
    """The least time of ``kernel``'s launches in the traced window over
    their device time, or None where it did not run or the profiler kept
    none of its records.  The device time is the mean of the launches the
    profiler recorded times the launches the wrapper counted (the profiler
    loses a record now and then)."""
    work = obs["work"].get(kernel)
    launches = obs["launches"].get(kernel, 0)
    if not work or not launches:
        return None
    ms, records = trace.kernel_ms(obs["trace"]["device"], KERNELS[kernel])
    if not records:
        return None
    least, by = workcount.least_seconds(work["f32"], work["f64"],
                                        work["bytes"], obs["peaks"])
    device_s = 1e-3 * ms / records * launches
    return {"pct": 100.0 * least / device_s, "bound_by": by,
            "least_ms": 1e3 * least, "device_ms": 1e3 * device_s,
            "launches": launches, "records": records}
