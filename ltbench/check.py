"""The comparison that decides ``correct``: the program's particles at the
end of an episode of the window against the plain reference's, on a
sample of particles drawn from the seed.

Numbers (each compared against the cell's limit, ``ltbench/limits/``,
where it names one):

* ``status_mismatch``: sampled particles whose status (active, settled,
  dead, out of the domain, error) differs from the reference's;
* ``h_gap_max_m``, ``z_gap_max_m``: the widest horizontal distance and
  the widest depth difference over the particles of equal status (a
  position that is not finite counts as infinitely far);
* ``h_gap_clear_max_m``, ``z_gap_clear_max_m``: the same over the
  particles that, in the reference, kept clear of the bottom log layer
  through the episode (``clear_rows`` of them).  Below the lowest rho
  level the velocity falls as log(height / z0), so a rounding
  difference in depth there grows into metres of horizontal distance
  within hours: a larva that visits the bed layer has no trajectory
  that two correct programs share;
* ``z_gap_clear_p99_m``: the 99th percentile of the depth differences
  over those particles.  A larva's swimming turns on a threshold of the
  salinity gradient (behaviour 4), so two correct programs now and then
  send one larva up and the other down: the widest depth difference
  swings from seed to seed by the size of a swim, its 99th percentile
  does not;
* ``h_gap_clear_p99_m``: the 99th percentile of the horizontal distances
  over those particles.  On a curved coast a particle that comes to rest
  against the land is stuck (status ERROR, frozen where it stands) at a
  step that round-off decides, so on a coastline the widest distance
  swings from seed to seed by metres to hundreds of metres, its 99th
  percentile does not;
* ``salt_gap_max``, ``temp_gap_max`` (and their ``_clear`` forms): the
  same of the sampled salinity [psu] and temperature [degC], where the
  configuration samples them;
* ``route_mismatch``: 1 where the wrappers' launch counts say the window
  did not take the configuration's route, else 0.
"""

from __future__ import annotations

import math

import torch


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a.double() - b.double()).abs()
    return torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))


def numbers(prog: dict, ref, clear: torch.Tensor, sampled: bool):
    """(numbers, same, per_row): the compared numbers, which sampled rows
    have equal status, and each gap per row (0 outside the rows it is
    taken over).  ``prog`` maps column names to the program's sampled
    rows (CPU tensors), ``ref`` is the reference's Particles and
    ``clear`` whether its particle kept clear of the bottom log layer."""
    same = prog["status"] == ref.status.cpu()
    clear = clear.cpu() & same
    h = torch.hypot(_gap(prog["x"], ref.x.cpu()), _gap(prog["y"], ref.y.cpu()))
    z = _gap(prog["z"], ref.z.cpu())
    gaps = {"h": (h, "_m"), "z": (z, "_m")}
    if sampled:
        for k in ("salt", "temp"):
            gaps[k] = (_gap(prog[k], getattr(ref, k).cpu()), "")
    per_row = {}
    for k, (g, unit) in gaps.items():
        per_row[f"{k}_gap_max{unit}"] = g
        per_row[f"{k}_gap_clear_max{unit}"] = torch.where(clear, g, 0.0)
    out = {"status_mismatch": int((~same).sum()),
           "clear_rows": int(clear.sum())}
    for k, g in (("z", z), ("h", h)):
        out[f"{k}_gap_clear_p99_m"] = (float(torch.quantile(g[clear], 0.99))
                                       if clear.any() else 0.0)
    for k, g in per_row.items():
        per_row[k] = torch.where(same, g, 0.0)
        out[k] = float(per_row[k].max()) if len(g) else 0.0
    return out, same, per_row


def spread(per_row: dict, same: torch.Tensor) -> dict:
    """Quantiles (50, 90, 99%) of each gap over the equal-status rows: a
    look at how the gaps are spread, not compared."""
    q = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64)
    return {k: [float(v) for v in torch.quantile(g[same].double(), q)]
            for k, g in per_row.items() if same.any()}


def judge(values: dict, limits: dict, same: torch.Tensor,
          per_row: dict) -> tuple:
    """(correct, failed, checks): each number that ``limits`` names
    against its limit (at most the limit passes); ``failed`` counts the
    equal-status rows that break a gap's limit and the status mismatches
    beyond theirs; ``checks`` is {name: {"value", "limit"}} in the order
    of ``limits``."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    bad = torch.zeros_like(same)
    for k, g in per_row.items():
        if k in limits:
            bad |= same & (g > limits[k])
    failed = int(bad.sum()) + max(
        0, values["status_mismatch"] - limits.get("status_mismatch", 0))
    if not correct:
        failed = max(failed, 1)      # a quantile over its limit
    return correct, failed, checks
