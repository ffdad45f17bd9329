"""Background record reads for the CLI (counterpart of
``ltjax.io.prefetch``).

The reference reads each hydrodynamic record synchronously between
external steps (``updateHydro``).  ``Prefetcher`` reads the next records
on a worker thread while the current chunk runs, keeping at most
``depth`` of them ready.  On a CUDA device the worker also copies each
record's arrays into pinned host tensors and starts their host-to-device
copies on a side stream; ``next()`` makes the consumer's stream wait for
that copy before it hands the tensors over.  On the CPU it only reads
ahead.  ``stall_s`` is the consumer's cumulative wait; an error in the
worker is raised in the consumer when it asks for the record.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch


class Prefetcher:
    """Bounded read-ahead of ``read_fn()``'s records (dicts of host numpy
    arrays and scalars, None at the end of the series)."""

    def __init__(self, read_fn: Callable[[], Optional[dict]], depth: int = 2,
                 device=None):
        self._read_fn = read_fn
        device = None if device is None else torch.device(device)
        if device is not None and device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = None
        self._device = device
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device is not None else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.stall_s = 0.0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _to_device(self, rec: dict):
        """Pinned copies of the record's arrays, copied to the device on
        the side stream; returns (record of device tensors, event)."""
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in rec.items():
                if isinstance(v, np.ndarray):
                    host = torch.from_numpy(np.ascontiguousarray(v))
                    v = host.pin_memory().to(self._device, non_blocking=True)
                out[k] = v
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, item) -> bool:
        """Queue item unless closed (blocks while the queue is full)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            if self._device is not None:
                torch.cuda.set_device(self._device)
            while not self._stop.is_set():
                rec = self._read_fn()
                if rec is None:
                    self._put(None)
                    return
                item = (self._to_device(rec) if self._device is not None
                        else (rec, None))
                if not self._put(item):
                    return
        except BaseException as e:        # raised in the consumer
            self._exc = e
            self._put(None)

    def next(self) -> Optional[dict]:
        """The next record (waits only if the reader is behind)."""
        t0 = time.perf_counter()
        item = self._q.get()
        self.stall_s += time.perf_counter() - t0
        if item is None:
            if self._exc is not None:
                raise self._exc
            return None
        rec, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(event)
            for v in rec.values():
                if isinstance(v, torch.Tensor):
                    # the allocator must not hand the block back to the
                    # side stream while the consumer's stream reads it
                    v.record_stream(cur)
        return rec

    def close(self):
        self._stop.set()
        try:                              # unblock a worker in put()
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
