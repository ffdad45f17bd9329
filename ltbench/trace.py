"""The traced window: ``torch.profiler`` over whole chunks, reduced to the
device's busy time, the kernels' device time and the idle gaps with what
the host was doing in each.

The profiler on the H100 loses a kernel record now and then (at times
every record of a window); a window whose records fall short of the
launches the wrappers counted is traced again, up to ``tries`` windows,
and the fullest one is kept (``complete`` says whether it held every
launch).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

SPAN = "ltbench.window"
NAME_CHARS = 96


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def split(events) -> tuple:
    """(device, host, span, annotations) of a profiler's events, each an
    interval (name, start us, end us): the window's span (``SPAN``'s
    host record); every other host record; the device records less the
    device-side copies of user annotations (``record_function`` ranges,
    NCCL's ``nccl:*`` among them: drawn on the device's timeline from
    their first kernel to their last, they are no device work); and
    those copies' microseconds by name."""
    from torch.autograd import DeviceType
    dev, host, span = [], [], None
    notes: Dict[str, float] = defaultdict(float)
    for e in events:
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name == SPAN:
                notes[e.name[:NAME_CHARS]] += iv[2] - iv[1]
            else:
                dev.append(iv)
        elif e.name == SPAN:
            span = iv[1:]
        else:
            host.append(iv)
    return dev, host, span, dict(notes)


def profile(run: Callable[[], dict], expect: Callable[[dict], Dict[str, int]],
            sync: Callable[[], None], tries: int = 3,
            agree: Callable[[bool], bool] = None) -> dict:
    """Trace ``run()`` (which returns its own counts, among them the
    wrappers' launches) up to ``tries`` times; ``expect(info)`` maps a
    kernel name to the launches the profiler must have recorded;
    ``sync()`` waits for the device; ``agree(complete)`` (several ranks
    tracing together) turns this window's completeness into every
    rank's, so that all ranks trace the same number of windows.
    Returns the fullest window: device events and host events as (name,
    start us, end us), the window's span, ``info``, ``windows``,
    ``complete`` and ``annotations`` (``split``)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function
    best = None
    for window in range(1, tries + 1):
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function(SPAN):
                info = run()
                sync()
            wall = time.perf_counter() - t0
        dev, host, span, notes = split(prof.events())
        want = expect(info)
        got = {k: sum(k in name for name, _, _ in dev) for k in want}
        complete = all(got[k] >= n for k, n in want.items())
        rec = {"device": dev, "host": host, "span": span, "wall_s": wall,
               "info": info, "recorded": got, "expected": want,
               "windows": window, "complete": complete,
               "annotations": notes}
        if best is None or sum(got.values()) > sum(best["recorded"].values()):
            best = rec
        if agree(complete) if agree else complete:
            break
    best["windows"] = window
    return best


def busy_us(dev, span) -> float:
    """Microseconds of the span in which some device operation ran."""
    a0, a1 = span
    return sum(min(b, a1) - max(a, a0) for a, b in
               _merge([(s, e) for _, s, e in dev]) if b > a0 and a < a1)


def device_ops(dev, top: int = 10) -> List[list]:
    """[[name, seconds]] of the device operations that took most time."""
    tot: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        tot[name[:NAME_CHARS]] += (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def idle_gaps(dev, host, span, top: int = 10) -> List[list]:
    """[[host activity, seconds]]: the idle stretches of the device in the
    span, each named by the innermost host operation running at its
    middle ("python" where none ran), summed by name, the largest
    first."""
    a0, a1 = span
    busy = _merge([(s, e) for _, s, e in dev])
    gaps, t = [], a0
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, a1)))
        t = max(t, e)
    if t < a1:
        gaps.append((t, a1))
    # sweep the gaps' middles in order over the host events by start: a
    # stack of the events open at the middle, the innermost on top
    host = sorted(host, key=lambda h: h[1])
    tot: Dict[str, float] = defaultdict(float)
    stack: List[tuple] = []
    k = 0
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        while k < len(host) and host[k][1] <= mid:
            while stack and stack[-1][2] < host[k][1]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "python"
        tot[name[:NAME_CHARS]] += (g1 - g0) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def kernel_ms(dev, kernel: str) -> Tuple[float, int]:
    """(device ms summed, records) of the events whose name holds
    ``kernel``."""
    ev = [(e - s) for name, s, e in dev if kernel in name]
    return sum(ev) * 1e-3, len(ev)
