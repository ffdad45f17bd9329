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

Each rank of a sharded run saves its own slot block (EMPTY slots
included) as ``ckpt_<ext>_h<rank:03d>.npz``, with the mesh (ndp, ntiles)
in ``extra``; ``latest_sharded`` finds the newest complete set (or a
single run's file).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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


_NAME = re.compile(r"ckpt_(\d+)(?:_h(\d+))?\.npz$")


def read_meta(path: str) -> dict:
    """The meta object of a checkpoint (without reading its columns)."""
    with np.load(path) as z:
        return json.loads(bytes(z["meta"]).decode())


def rank_tag(rank: int) -> str:
    return f"_h{rank:03d}"


def latest_sharded(ckpt_dir: str):
    """(ext, paths, mesh) of the newest checkpoint that a sharded run can
    resume from: a single run's ``ckpt_<ext>.npz`` (mesh None), or the
    complete set of a sharded run's per-rank files (mesh (ndp, ntiles)
    from their meta; paths in rank order); None if there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    found = {}
    for f in os.listdir(ckpt_dir):
        m = _NAME.fullmatch(f)
        if m:
            rank = None if m.group(2) is None else int(m.group(2))
            found.setdefault(int(m.group(1)), {})[rank] = os.path.join(
                ckpt_dir, f)
    for ext in sorted(found, reverse=True):
        by_rank = found[ext]
        if None in by_rank:
            return ext, [by_rank[None]], None
        if 0 in by_rank:
            mesh = tuple(read_meta(by_rank[0])["extra"]["mesh"])
            n = mesh[0] * mesh[1]
            if all(r in by_rank for r in range(n)):
                return ext, [by_rank[r] for r in range(n)], mesh
    return None
