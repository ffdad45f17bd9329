"""The program's spans in a traced window (``ltjax_torch.trace``): host
records named ``ltjax_torch.<layer>``, and the device operations each
one launched.

The accepted split of the trace (``trace.profile``) keeps each record as
(name, start, end) and drops the correlation ids that link a device
record to the host call that launched it.  The program's device work
runs on one stream, so its records run in the order of their launches:
the i-th launch call on the host (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ``cudaMemsetAsync`` and their kin) launched the
i-th device record.  Where the window lost records and the two counts
differ, the kernels' own launches (the first launch of a kernel span
after its ``.upload`` child) and their records, found by name, pin the
two sequences together, and each stretch between two of them is matched
only where its counts agree (the rest is left out).  A cell on several
cards adds NCCL's kernels, on NCCL's own stream: each collective's
stream waits for the program's and the program's for it, so they too run
in launch order; where the counts differ all the same (a launch that the
profiler did not record on the host), NCCL's kernels and the launches
inside the collectives' host ranges (``nccl:*``) are left out of the
matching first.  A device record belongs to the innermost program span
open at its launch, ``outside`` where none is.

The metrics read from these (``ltbench/metrics/``) give None where the
window holds no program span: a program without them.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import trace
from .layers import KERNELS

PREFIX = "ltjax_torch."
OUTSIDE = "outside"
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
            "cuMemcpy", "cuMemset")
COLLECTIVE = "nccl:"         # a collective's host range (ProcessGroupNCCL)
NCCL = "nccl"                # NCCL's kernels on the device


def program_spans(host) -> List[tuple]:
    """The program's spans, by start (an enclosing span before the spans
    it holds)."""
    return sorted((h for h in host if h[0].startswith(PREFIX)),
                  key=lambda h: (h[1], -h[2]))


def innermost(spans: List[tuple], times: List[float]) -> List[str]:
    """For each of ``times`` (ascending), the name of the innermost span
    open at it, or OUTSIDE."""
    out, stack, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][1] <= t:
            while stack and stack[-1][2] < spans[k][1]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else OUTSIDE)
    return out


def _pairs(launch: List[tuple], dev: List[tuple], spans: List[tuple]):
    """(launch index, record index) pairs; see the module's docstring."""
    if len(launch) == len(dev):
        return list(zip(range(len(launch)), range(len(dev))))
    pins_d = [i for i, d in enumerate(dev)
              if any(k in d[0] for k in KERNELS.values())]
    starts = [h[1] for h in launch]
    pins_l = []
    for s in spans:
        if s[0][len(PREFIX):] not in KERNELS:
            continue
        up = [u[2] for u in spans if u[0] == s[0] + ".upload"
              and s[1] <= u[1] and u[2] <= s[2]]
        j = bisect.bisect_left(starts, max(up, default=s[1]))
        if j < len(launch) and starts[j] <= s[2]:
            pins_l.append(j)
    pins_l.sort()
    if len(pins_l) != len(pins_d):
        return []
    out = list(zip(pins_l, pins_d))
    edges = list(zip([-1] + pins_l, [-1] + pins_d,
                     pins_l + [len(launch)], pins_d + [len(dev)]))
    for l0, d0, l1, d1 in edges:
        if l1 - l0 == d1 - d0:
            out += zip(range(l0 + 1, l1), range(d0 + 1, d1))
    return out


def _match(t: dict, spans: List[tuple]) -> tuple:
    """(launch calls, device records, their pairs) of the window ``t``;
    see the module's docstring."""
    launch = sorted((h for h in t["host"] if h[0].startswith(LAUNCHES)),
                    key=lambda h: h[1])
    dev = sorted((d for d in t["device"] if not d[0].startswith(PREFIX)),
                 key=lambda d: d[1])
    if len(launch) != len(dev):
        coll = trace._merge([(s, e) for n, s, e in t["host"]
                             if n.startswith(COLLECTIVE)])
        starts = [a for a, _ in coll]

        def inside(x):
            k = bisect.bisect_right(starts, x) - 1
            return k >= 0 and x <= coll[k][1]

        launch = [h for h in launch if not inside(h[1])]
        dev = [d for d in dev if not d[0].startswith(NCCL)]
    return launch, dev, _pairs(launch, dev, spans)


def device_by_span(t: dict) -> Dict[str, list]:
    """The device records of the traced window ``t`` (``trace.profile``'s
    record) by the innermost program span that launched them; {} where
    the window holds no program span."""
    spans = program_spans(t["host"])
    if not spans:
        return {}
    launch, dev, pairs = _match(t, spans)
    names = innermost(spans, [h[1] for h in launch])
    out: Dict[str, list] = defaultdict(list)
    for j, i in pairs:
        out[names[j]].append(dev[i])
    return dict(out)


def match_counts(t: dict) -> Optional[dict]:
    """How far the matching of ``device_by_span`` reached in the window
    ``t``: the launch calls and device records it matched over, and the
    pairs it made (every record matched where all three agree); None
    without program spans."""
    spans = program_spans(t["host"])
    if not spans:
        return None
    launch, dev, pairs = _match(t, spans)
    return {"launches": len(launch), "records": len(dev),
            "matched": len(pairs)}


def layer_device_ms(t: dict, layers: Tuple[str, ...]) -> Optional[float]:
    """Device milliseconds (merged and clipped to the window, as
    ``trace.busy_us``) of the records launched under the spans of
    ``layers`` and their children; None without such a span."""
    names = tuple(PREFIX + x for x in layers)
    if not any(h[0] in names for h in t["host"]):
        return None
    recs = [r for name, rs in device_by_span(t).items() for r in rs
            if name in names or name.startswith(tuple(n + "." for n in
                                                      names))]
    return 1e-3 * trace.busy_us(recs, t["span"])


def idle_gaps(dev, span) -> List[Tuple[float, float]]:
    """The stretches of the window in which no device operation ran."""
    a0, a1 = span
    gaps, t = [], a0
    for s, e in trace._merge([(s, e) for name, s, e in dev
                              if not name.startswith(PREFIX)]):
        if s > t:
            gaps.append((t, min(s, a1)))
        t = max(t, e)
    if t < a1:
        gaps.append((t, a1))
    return [(a, b) for a, b in gaps if b > a]


def overlap_us(a, b) -> float:
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_by_span(t: dict) -> Dict[str, float]:
    """Device-idle seconds of the window by the innermost program span
    open at the middle of each idle stretch (OUTSIDE where none is)."""
    gaps = idle_gaps(t["device"], t["span"])
    names = innermost(program_spans(t["host"]),
                      [0.5 * (a + b) for a, b in gaps])
    out: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, names):
        out[name] += 1e-6 * (b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def program_idle_us(t: dict) -> Optional[float]:
    """Device-idle microseconds of the window that fall inside the
    program's spans; None without spans."""
    spans = program_spans(t["host"])
    if not spans:
        return None
    return overlap_us(idle_gaps(t["device"], t["span"]),
                      trace._merge([(s, e) for _, s, e in spans]))


def self_ms(t: dict, layer: str) -> List[float]:
    """Each span of ``layer``'s duration less its children's, in ms."""
    name = PREFIX + layer
    spans = program_spans(t["host"])
    kids = [s for s in spans if s[0].startswith(name + ".")]
    return [1e-3 * ((e - s) - sum(ke - ks for _, ks, ke in kids
                                  if s <= ks and ke <= e))
            for n, s, e in spans if n == name]
