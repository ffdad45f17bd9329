"""One cell of the benchmark, found by name: its entry in
``BENCHMARK.json``, its configuration file (``ltbench/configs/``), its
traffic mix (``ltbench/traffic/<traffic>.json``), its limits
(``ltbench/limits/<workload>.json``) and the metrics it reports; and the
inputs of a run, handed to the program through its public constructors
and to the plain reference alike.

A configuration file holds LTRANS.data keys (``ltrans``), the grid and
the case (the flow and the fields the records carry), the habitat
polygons and the route its external steps must take.  The grid is the
open box of ``ltbench/inputs.py`` (uniform axes, all water, one depth,
solid-body rotation), or with ``"kind": "estuary"`` the land-masked
estuary of ``ltbench/estuary.py`` (curvilinear or straight, bathymetry,
an open mouth, a tidal channel flow).  A traffic file holds the release
(``numpar`` particles uniform in x, y and z ranges, or with ``"kind":
"water"`` uniform over an estuary's water cells at fractions of the
local water column; their age), the episode length in external steps,
overrides of the case (``case``) and the size of the sample of
particles the reference follows.  A later cell is a new entry in
``BENCHMARK.json`` and new files here: no code changes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import estuary, inputs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    """A metric is reported in the cells its ``workloads`` names, or in
    every cell when it names none."""
    return workload in metric.get("workloads", [workload])


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    run_seconds: int

    @property
    def ltrans(self) -> dict:
        return self.config["ltrans"]

    @property
    def case(self) -> dict:
        return {**self.config["case"], **self.traffic.get("case", {})}

    @property
    def episode(self) -> int:
        return int(self.traffic["episode_ext_steps"])

    @property
    def numpar(self) -> int:
        return int(self.traffic["numpar"])


def find_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` under ``root``, with
    its files; raises KeyError for a name the benchmark lacks."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    w = next((c for c in bench["workloads"] if c["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(root, "ltbench", "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(root, "ltbench", "limits",
                                      workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
        run_seconds=int(bench["run_seconds"]))


@dataclass
class Inputs:
    """The raw inputs of a run, made from the cell and the seed."""
    grid: inputs.GridArrays
    records: inputs.Records
    release: inputs.Release
    habitat: list
    holes: list
    seed: int


def estuary_of(cell: Cell) -> Optional[estuary.Estuary]:
    """The cell's estuary where its grid is of the kind ``estuary``, else
    None (the uniform open box of ``inputs.grid_arrays``)."""
    g = cell.config["grid"]
    return (estuary.make(g, cell.ltrans) if g.get("kind") == "estuary"
            else None)


def grid_arrays(cell: Cell) -> inputs.GridArrays:
    """The raw arrays of the cell's grid, of either kind."""
    est = estuary_of(cell)
    return (est.arrays if est is not None
            else inputs.grid_arrays(cell.config["grid"], cell.ltrans))


def make_inputs(cell: Cell, seed: int, device) -> Inputs:
    """The grid, the ring of ``episode + 2`` records, the release and the
    polygons of one run of ``cell`` with ``seed``: of the configuration's
    grid kind (``estuary``, or the open box without a ``kind``) and the
    traffic's release kind (``water`` on an estuary, or the box without
    a ``kind``)."""
    lt = cell.ltrans
    args = (cell.case, cell.episode + 2, float(lt["dt"]),
            getattr(torch, lt.get("dtype_field", "float32")), device)
    est = estuary_of(cell)
    if est is None:
        ga = inputs.grid_arrays(cell.config["grid"], lt)
        rec = inputs.make_records(ga, *args)
    else:
        ga = est.arrays
        rec = estuary.make_records(est, *args)
    if cell.traffic["release"].get("kind") == "water":
        if est is None:
            raise ValueError(f"{cell.name}: a water release needs an "
                             "estuary grid")
        rel = estuary.release(cell.traffic, est, cell.case, seed, device)
    else:
        rel = inputs.release(cell.traffic, seed, device)
    habitat, holes = inputs.polygons(cell.config.get("polygons"))
    return Inputs(grid=ga, records=rec, release=rel, habitat=habitat,
                  holes=holes, seed=int(seed))


def candidate_edges(inp: Inputs) -> float:
    """Mean count, over the released particles, of the edges of the
    habitat and hole polygons whose bounding box holds the particle: the
    edges the settlement ray cast tests."""
    x = inp.release.x.cpu().numpy()
    y = inp.release.y.cpu().numpy()
    edges = np.zeros_like(x)
    for _, v in inp.habitat + inp.holes:
        inside = ((x >= v[:, 0].min()) & (x <= v[:, 0].max())
                  & (y >= v[:, 1].min()) & (y <= v[:, 1].max()))
        edges += inside * len(v)
    return float(edges.mean()) if len(x) else 0.0


# --- the program ----------------------------------------------------------

@dataclass
class Program:
    ctx: object
    cfg: object
    p0: object
    fields: object          # the program's FieldSet class
    records: inputs.Records

    def window(self, e0: int, n_ext: int):
        """The program's FieldSet of records [e0, e0 + n_ext + 2)."""
        return self.fields(*(c[e0:e0 + n_ext + 2]
                             for c in self.records.columns()))


def program_config(cell: Cell, seed: int, dtype_pos: Optional[str] = None):
    """The program's Config of ``cell`` (``dtype_pos`` overrides the
    configuration's: the control's lower precision)."""
    from ltjax_torch.config import Config
    lt = dict(cell.ltrans)
    if dtype_pos:
        lt["dtype_pos"] = dtype_pos
    cfg = Config(**lt, numpar=cell.numpar, seed=int(seed))
    cfg.validate()
    return cfg


def program_grid(ga: inputs.GridArrays, dtype, device):
    """The program's Grid of the grid arrays, in the positions' dtype:
    curvilinear (the inverse map) where the rho coordinates are 2-D."""
    from ltjax_torch import grid as pg
    make = pg.make_curv_grid if ga.x_rho.ndim == 2 else pg.make_grid
    return make(ga.x_rho, ga.y_rho, ga.h, ga.mask, ga.s_rho, ga.s_rho,
                ga.s_w, ga.s_w, ga.hc, ga.vtransform, dtype=dtype,
                device=device)


def program_bounds(ga: inputs.GridArrays, grid, device):
    """The program's boundaries of its grid, built as its CLI builds them
    (``run.build_context``): the rim OPEN, the segments from the grid's
    coordinates in the positions' dtype; on a curvilinear grid the psi
    mesh's quad edges and the grid's inverse map."""
    from ltjax_torch.physics import boundary as bd
    if grid.curv is not None:
        xy = grid.curv.xy_flat.cpu().numpy().reshape(grid.ny, grid.nx, 2)
        return bd.build_boundaries_curv(ga.mask, xy[..., 0], xy[..., 1],
                                        grid.curv, closed_edges=False,
                                        device=device)
    return bd.build_boundaries(ga.mask, grid.x_rho.cpu().numpy(),
                               grid.y_rho.cpu().numpy(), closed_edges=False,
                               device=device)


def build_program(cell: Cell, inp: Inputs, device,
                  dtype_pos: Optional[str] = None) -> Program:
    """The program's context, configuration and initial particles from
    the raw inputs (``dtype_pos`` overrides the configuration's: the
    control's lower precision)."""
    from ltjax_torch import state as st
    from ltjax_torch.fields import FieldSet
    from ltjax_torch.physics import settlement as stl
    from ltjax_torch.step import StepContext
    cfg = program_config(cell, inp.seed, dtype_pos)
    pos = getattr(torch, cfg.dtype_pos)
    grid = program_grid(inp.grid, pos, device)
    bounds = program_bounds(inp.grid, grid, device)
    polys = holes = None
    if cfg.settlementon and inp.habitat:
        xe, ye = bounds.x_edges.cpu().numpy(), bounds.y_edges.cpu().numpy()
        polys = stl.build_polygons(inp.habitat, xe, ye, device=device)
        holes = (stl.build_polygons(inp.holes, xe, ye, device=device)
                 if cfg.holesExist and inp.holes else None)
    ctx = StepContext(grid=grid, bounds=bounds, polys=polys, holes=holes)
    return Program(ctx=ctx, cfg=cfg, p0=particles(st, inp, pos),
                   fields=FieldSet, records=inp.records)


def particles(st, inp: Inputs, dtype, rows: Optional[torch.Tensor] = None):
    """A ``Particles`` of the module ``st`` (the program's or the
    reference's state module) from the release, every particle ACTIVE at
    its age, in ``dtype``; only ``rows`` of it when given."""
    r = inp.release
    x, y, z = r.x, r.y, r.z
    if rows is not None:
        idx = rows.to(x.device)
        x, y, z = x[idx], y[idx], z[idx]
    n, dev = x.shape[0], x.device

    def full(v, dt):
        return torch.full((n,), v, dtype=dt, device=dev)

    return st.Particles(
        x=x.to(dtype), y=y.to(dtype), z=z.to(dtype),
        dob=full(-r.age, dtype), age=full(r.age, dtype),
        status=full(st.ACTIVE, torch.int32),
        pid=(torch.arange(n, dtype=torch.int32, device=dev) if rows is None
             else rows.to(device=dev, dtype=torch.int32)),
        settle_poly=full(-1, torch.int32), hit_land=full(0, torch.int32),
        hit_bottom=full(0, torch.int32), salt=full(0.0, dtype),
        temp=full(0.0, dtype))
