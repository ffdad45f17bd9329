"""A copy of the benchmark's files at a size the CPU holds: the same
configurations, traffic mixes and limits, on a coarser grid (``nx``
points a side over the same domain, a sharded configuration's halo cut
in proportion), fewer particles, shorter episodes and a smaller sample.  It adds the cell ``oyster`` (``perstep/``): larvae
on the per-step route (K2 then K3, every larval lane), which no cell of
the benchmark takes yet, so that the harness's handling of that route
stays tested."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = ("configs", "traffic", "limits", "metrics")
PERSTEP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "perstep")


def add_perstep(bench):
    """The per-step fixture's entries in a BENCHMARK.json."""
    bench["configs"].append({"name": "ltrans-oyster", "source": "a test",
                             "file": "ltbench/configs/ltrans-oyster.json",
                             "reduced": [], "why": "the per-step route"})
    bench["workloads"].append({"name": "oyster", "config": "ltrans-oyster",
                               "traffic": "oyster", "chips": 1,
                               "why": "the per-step route"})
    for k in ("k2_roofline_pct", "k3_roofline_pct"):
        bench["per_layer"].append({
            "name": k, "unit": "%", "better": "higher",
            "source": "device_trace", "layer": "kernel " + k[:2].upper(),
            "moves": "particle_steps_per_s", "workloads": ["oyster"]})


def make(root, n=1024, nx=40, episode=4, sample=512, edit=None):
    """Write the tiny benchmark under ``root`` and return ``root``;
    ``edit(bench)`` may change the BENCHMARK.json it writes."""
    root = str(root)
    os.makedirs(os.path.join(root, "ltbench"), exist_ok=True)
    for d in DATA:
        shutil.copytree(os.path.join(REPO, "ltbench", d),
                        os.path.join(root, "ltbench", d),
                        dirs_exist_ok=True)
    shutil.copytree(PERSTEP, os.path.join(root, "ltbench"),
                    dirs_exist_ok=True)
    shutil.copy(os.path.join(REPO, "ltbench", "peaks.json"),
                os.path.join(root, "ltbench"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    add_perstep(bench)
    if edit:
        edit(bench)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    def grid(c):
        # a strip's halo, in rows, covers the same distance on the coarser
        # grid (at least the stencil row and one row of movement)
        lt = c["ltrans"]
        if "halo_rows" in lt:
            lt["halo_rows"] = max(2, round(lt["halo_rows"] * nx
                                           / c["grid"]["ny"]))
        c["grid"].update(nx=nx, ny=nx)

    for sub, change in (("configs", grid),
                        ("traffic", lambda c: c.update(
                            numpar=n, episode_ext_steps=episode,
                            sample=min(n, sample)))):
        d = os.path.join(root, "ltbench", sub)
        for name in os.listdir(d):
            with open(os.path.join(d, name)) as f:
                c = json.load(f)
            change(c)
            with open(os.path.join(d, name), "w") as f:
                json.dump(c, f)
    return root
