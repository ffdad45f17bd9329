"""Spans of the port's layers in a ``torch.profiler`` trace, and one reset
of the kernel wrappers' counters.

``span(name)`` marks a stretch of host code under ``name`` while a
profiler records (the ltbench harness's traced episode, the CLI's
``LTJAX_PROFILE_DIR``), and is a shared no-op context otherwise: a check
of the profiler's state (about 0.1 us on the host) where a bare
``record_function`` costs several microseconds.  The span is a host
record of the trace (a ``cpu_op`` in a Chrome trace), not a user
annotation: a user annotation is also drawn on the device's timeline
from its first kernel to its last, which readers of device time would
count as device work.

The spans, each named ``ltjax_torch.<layer>``:

* ``chunk``: one call of ``step.make_fused_external_steps``' fused (or
  of ``shard.make_tiled_steps``' fused);
* ``tables``: the packed records of a record window
  (``step.packed_window``), and each internal step's stage (and aux)
  tables where the step builds them as PyTorch ops (the per-step and
  packed routes, K1's plain version);
* ``sort``: one Hilbert sort of the batch with its permutation's
  update; ``unsort``: the batch back to storage order;
* ``k1``, ``k2``, ``k3``: one whole call of the wrapper of K1
  (``ext_step_fused``), K2 (``rk4_displacement_fused``) or K3
  (``step_lanes_fused``), each with a child ``<span>.upload`` around
  its host-to-device copies (the part that may wait on the stream);
* ``counts``: ``step.summary_counts``, a chunk's host sync;
* ``read``, ``output``, ``checkpoint``: the CLI's record window, its
  trajectory snapshot and its checkpoint of a chunk.

No name holds a kernel's device-function name (``ext_step_kernel``,
``rk4_step_kernel``, ``step_lanes_kernel``): readers count launches by
that substring.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_enabled = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler is active; the
    shared no-op context otherwise."""
    return _record(name) if _enabled() else _OFF


def spanned(name: str):
    """Decorator: each whole call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def reset_counters() -> None:
    """Zero the launch counts (``.launches``, ``.variant_launches``) of
    the wrappers of K1, K2 and K3 and K1's device counters (no wait)."""
    from .kernels import ext_step as kx, rk4_step as kr, step_lanes as sl
    kx.reset_launches()
    for fn in (kr.rk4_displacement_fused, sl.step_lanes_fused):
        fn.launches = 0
        fn.variant_launches = {}
