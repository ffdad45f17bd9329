"""Checkpoint / resume (counterpart of ``ltjax.checkpoint``).

One ``npz`` per checkpoint, written atomically (a temporary file, then
``os.replace``): every particle column as ``p_<field>``, and ``meta``,
the UTF-8 bytes of a JSON object with the external step reached
(``ext_step``), the global record cursor of the field series
(``global_record``) and ``extra`` (the run stores ``t_base``, the field
clock's origin).  The format is ltjax's, so a checkpoint of either
package resumes in the other.  The random streams are counter-based on
(seed, step, substream, pid), so a resumed run draws what the unsplit
run draws.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from . import state as st


def save(path: str, particles: st.Particles, ext_step: int,
         global_record: int, extra: Optional[dict] = None) -> None:
    """Write the particles and the run cursor to ``path`` (atomically)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {f"p_{f.name}": getattr(particles, f.name).cpu().numpy()
               for f in dataclasses.fields(particles)}
    payload["meta"] = np.frombuffer(json.dumps({
        "ext_step": int(ext_step),
        "global_record": int(global_record),
        "extra": extra or {},
    }).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, device="cpu") -> Tuple[st.Particles, int, int, dict]:
    """(particles on ``device``, ext_step, global_record, extra) of a
    checkpoint; the columns keep the dtypes they were saved in."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        cols = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    p = st.Particles(**{k: torch.as_tensor(v, device=device)
                        for k, v in cols.items()})
    return p, meta["ext_step"], meta["global_record"], meta.get("extra", {})


def latest(ckpt_dir: str, tag: str = "") -> Optional[str]:
    """The newest ``ckpt_<ext>{tag}.npz`` in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    suffix = tag + ".npz"
    cands = []
    for f in os.listdir(ckpt_dir):
        if not (f.startswith("ckpt_") and f.endswith(suffix)):
            continue
        stem = f[5:-len(suffix)]
        if stem.isdigit():
            cands.append((int(stem), f))
    if not cands:
        return None
    cands.sort()
    return os.path.join(ckpt_dir, cands[-1][1])
