"""The plain reference of a cell: ``ltbench.ref`` (a frozen plain PyTorch
copy of the LTRANS step, importing nothing of the program) built from the
same raw inputs as the program, following a sample of the particles
through one episode.  Where the rho coordinates are 2-D it builds its own
curvilinear grid (the inverse map) and boundaries (the psi mesh's quad
edges) from them."""

from __future__ import annotations

import torch

from . import cell as cl
from .ref import state as rst
from .ref.config import Config
from .ref.fields import FieldSet
from .ref.grid import make_curv_grid, make_grid
from .ref.physics import boundary as bd
from .ref.physics import settlement as stl
from .ref.step import external_steps


class Context:
    """What the reference's step reads of the run's static data."""

    def __init__(self, grid, bounds, polys=None, holes=None):
        self.grid, self.bounds, self.polys, self.holes = (grid, bounds, polys,
                                                          holes)


def run_episode(cell: cl.Cell, inp: cl.Inputs, rows: torch.Tensor,
                ext_idx0: int, device):
    """The reference's particles ``rows`` after one episode of the cell
    from the release, its external steps numbered from ``ext_idx0``
    (positions in the configuration's dtype), and whether each kept
    clear of the bottom log layer."""
    cfg = Config(**cell.ltrans, numpar=len(rows), seed=inp.seed)
    cfg.validate()
    pos = getattr(torch, cfg.dtype_pos)
    ga = inp.grid
    curv = ga.x_rho.ndim == 2
    grid = (make_curv_grid if curv else make_grid)(
        ga.x_rho, ga.y_rho, ga.h, ga.mask, ga.s_rho, ga.s_rho, ga.s_w,
        ga.s_w, ga.hc, ga.vtransform, dtype=pos, device=device)
    bounds = (bd.build_boundaries_curv(ga.mask, ga.x_rho, ga.y_rho, grid.curv,
                                       closed_edges=False, device=device)
              if curv else bd.build_boundaries(ga.mask, ga.x_rho, ga.y_rho,
                                               closed_edges=False,
                                               device=device))
    polys = holes = None
    if cfg.settlementon and inp.habitat:
        xe, ye = bounds.x_edges.cpu().numpy(), bounds.y_edges.cpu().numpy()
        polys = stl.build_polygons(inp.habitat, xe, ye, device=device)
        holes = (stl.build_polygons(inp.holes, xe, ye, device=device)
                 if cfg.holesExist and inp.holes else None)
    ctx = Context(grid, bounds, polys, holes)
    fs = FieldSet(*inp.records.columns())
    p = cl.particles(rst, inp, pos, rows)
    with torch.no_grad():
        return external_steps(ctx, cfg, p, fs, 0.0, ext_idx0, cell.episode)
