"""The estuary fixture (``estuary/``): the deployment the estuary grid
kind is for, BASELINE.json configs[2], as data files that a later
benchmark entry takes as they are.  ``make`` writes a benchmark root
that holds the repository's cells and the estuary's, either at the
fixture's size (the card) or at a size the CPU holds; the straight form
of the same estuary (``curvilinear`` false) comes as a second
configuration and cell."""

import json
import os
import shutil

import ltbench_tiny

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "estuary")
CELL, STRAIGHT = "estuary-1m", "estuary-straight"
# the estuary at the CPU's size: the fixture's shapes on a 12 km x 3 km
# estuary, so that its cells (255 m by 130 m) are near the fixture's (250
# m by 188 m) and a tide carries particles into the coast and, starting
# on the ebb (the tide's phase pi), out through the mouth within a 4 h
# episode; placed 180 km from the origin, so that its coordinates round
# in float32 as the fixture's upper estuary does
SMALL = {"length_m": 12000.0, "width_m": 3000.0, "meander_m": 300.0,
         "meander_wavelength_m": 6000.0, "head_width_m": 500.0,
         "width_excess_m": 2500.0, "width_decay_m": 6000.0,
         "coves": [[0.12, 2000.0, 0.0], [0.08, 700.0, 1.0]],
         "origin_m": [180000.0, 0.0]}


def add_estuary(bench):
    """The fixture's entries in a BENCHMARK.json: the curvilinear cell,
    the straight one, and both in the workloads of every per-layer metric
    that the one-card cells report."""
    bench["configs"] += [
        {"name": "ltrans-estuary", "source": "BASELINE.json configs[2]",
         "file": "ltbench/configs/ltrans-estuary.json", "reduced": [],
         "why": "land reflection, an open mouth, a curvilinear grid"},
        {"name": "ltrans-estuary-straight", "source": "BASELINE.json "
         "configs[2]", "file": "ltbench/configs/ltrans-estuary-straight.json",
         "reduced": [], "why": "the same estuary on a rectilinear grid"}]
    bench["workloads"] += [
        {"name": CELL, "config": "ltrans-estuary", "traffic": CELL,
         "chips": 1, "why": "the estuary fixture"},
        {"name": STRAIGHT, "config": "ltrans-estuary-straight",
         "traffic": CELL, "chips": 1, "why": "the estuary fixture, straight"}]
    for m in bench["per_layer"]:
        if "advect-1m" in m.get("workloads", []):
            m["workloads"] += [CELL, STRAIGHT]


def make(root, tiny: bool = True, nx=48, ny=24, us=6, n=4096, episode=4,
         sample=4096, window=None):
    """Write the benchmark root ``root`` (``ltbench_tiny.make``'s, with
    the estuary fixture added) and return it.  ``tiny``: the estuary on
    ``nx`` x ``ny`` rho points and ``us`` levels, ``n`` particles,
    ``episode`` external steps, a sample of ``sample``, released over the
    columns ``window`` (default: every interior column, so that some
    reach the mouth); else at the fixture's own size, into ``root``'s
    BENCHMARK.json where it has one (a checkout), else the
    repository's."""
    if tiny:
        root = ltbench_tiny.make(root, edit=add_estuary)
    else:
        root = str(root)
        for sub in ltbench_tiny.DATA:
            src = os.path.join(ltbench_tiny.REPO, "ltbench", sub)
            dst = os.path.join(root, "ltbench", sub)
            if not os.path.exists(dst) or not os.path.samefile(src, dst):
                shutil.copytree(src, dst, dirs_exist_ok=True)
        path = os.path.join(root, "BENCHMARK.json")
        with open(path if os.path.exists(path) else os.path.join(
                ltbench_tiny.REPO, "BENCHMARK.json")) as f:
            bench = json.load(f)
        add_estuary(bench)
        with open(path, "w") as f:
            json.dump(bench, f)
    d = os.path.join(root, "ltbench")
    shutil.copytree(FIXTURE, d, dirs_exist_ok=True)
    with open(os.path.join(d, "configs", "ltrans-estuary.json")) as f:
        conf = json.load(f)
    with open(os.path.join(d, "traffic", CELL + ".json")) as f:
        traffic = json.load(f)
    if tiny:
        conf["grid"].update(SMALL, nx=nx, ny=ny)
        conf["case"]["tide"]["phase_rad"] = 3.141592653589793
        conf["ltrans"].update(us=us, ws=us + 1)
        traffic.update(numpar=n, episode_ext_steps=episode,
                       sample=min(n, sample))
        traffic["release"]["i"] = window or [1, nx - 2]
    straight = json.loads(json.dumps(conf))
    straight["grid"]["curvilinear"] = False
    for name, body in (("configs/ltrans-estuary.json", conf),
                       ("configs/ltrans-estuary-straight.json", straight),
                       (f"traffic/{CELL}.json", traffic)):
        with open(os.path.join(d, name), "w") as f:
            json.dump(body, f)
    shutil.copy(os.path.join(d, "limits", CELL + ".json"),
                os.path.join(d, "limits", STRAIGHT + ".json"))
    return root
