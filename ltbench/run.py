"""Run one cell of the benchmark of ltjax_torch once:

    python3 -m ltbench --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Set-up makes the cell's inputs on the card
from its configuration, its traffic mix and the seed, builds the
program's context through its public constructors and runs one whole
episode (every chunk shape; the kernels build on first use).  The window
then drives ``ltjax_torch.step.make_fused_external_steps`` chunk after
chunk, as ``ltjax_torch.run.run`` drives it: each chunk the next
``ext_fuse + 2`` records, the chunk's start time and external-step index,
then ``step.summary_counts`` (the CLI's host sync).  A run is a series of
episodes, each from the set-up's particles at t = 0 for the traffic's
``episode_ext_steps`` external steps; the external-step index keeps
counting, so each episode draws new random numbers.  The window closes
at the first episode end past ``--seconds``, so that it holds whole
episodes and the same mix of work in every run.

After the window: the peak of device memory, with ``--trace 1`` one more
episode under ``torch.profiler`` (the per-layer metrics, ``ltbench/
metrics/<name>.py``), then the plain reference (``ltbench.ref``) follows
a sample of the particles drawn from the seed through an episode of the
window drawn from the seed, and ``ltbench.check`` compares.  The last
line of stdout is the result; the last lines of stderr are the compared
numbers beside their limits.  A cell on more than one card runs as one
rank a card (``ltbench.sharded``): the same window, trace and check over
the program's sharded path.

A run without a CUDA device, with fewer than the cell asks for, or with
``jax``, ``jaxlib``, ``flax`` or ``ltjax`` loaded at its end, prints no
result and exits non-zero.  ``--control float32`` runs the program with
float32 positions (the configuration's float64 one step down): the
control that the limits must fail.
"""

import time

T_START = time.perf_counter()     # set-up starts with the process

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "ltjax")
COLUMNS = ("x", "y", "z", "status", "salt", "temp")


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of BANNED, compared
    whole (``ltjax_torch`` is not ``ltjax``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in BANNED)


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its CUDA libraries under ``build/ltjax_torch``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(root, "build", "ltbench", sub)


class Runner:
    """Drives a program's external steps chunk by chunk through episodes,
    as the CLI drives them; a subclass gives ``chunk`` (one call of the
    program, ending with the CLI's host sync) and ``sample`` (the
    sampled particles now)."""

    def __init__(self, cell, cfg, start, seed: int):
        from ltjax_torch import step
        self.step = step
        self.cell, self.cfg = cell, cfg
        self.fused = {}
        self.p = self.start = start      # every episode starts from it
        self.active0 = step.summary_counts(start)["active"]
        self.e_in = 0            # external step within the episode
        self.ext = 0             # external-step index, across episodes
        # one episode of the window kept for the check, drawn from the
        # seed as the episodes end (reservoir sampling: the memory held
        # does not grow with the episodes)
        self.pick = torch.Generator()
        self.pick.manual_seed(int(seed) ^ 0xE9)
        self.kept = None         # (first external-step index, sampled rows)
        self.episodes = 0        # episodes the window completed
        self.particle_steps = 0
        self.chunks = 0
        self.keep = False

    def end_episode(self):
        """Keep the episode that just ended in place of the kept one with
        the chance that reservoir sampling gives it, then go back to the
        start."""
        if self.keep:
            self.episodes += 1
            if int(torch.randint(self.episodes, (1,),
                                 generator=self.pick)) == 0:
                self.kept = (self.ext - self.cell.episode, self.sample())
        self.p, self.e_in = self.start, 0

    def episode(self) -> list:
        """One whole episode from its start: [(0, active particles),
        (chunk length, active count after it), ...]."""
        assert self.e_in == 0
        out = [(0, self.active0)]
        while True:
            e = self.e_in
            c = self.chunk()
            out.append((self.cell.episode - e if self.e_in == 0
                        else self.e_in - e, c["active"]))
            if self.e_in == 0:
                return out


class CardRunner(Runner):
    """One card: ``step.make_fused_external_steps`` over the program's
    whole record window."""

    def __init__(self, cell, prog, rows, seed: int):
        super().__init__(cell, prog.cfg, prog.p0, seed)
        self.prog = prog
        self.rows = rows.to(prog.p0.x.device)

    def chunk(self) -> dict:
        cfg, ep = self.cfg, self.cell.episode
        E = min(max(1, cfg.ext_fuse), ep - self.e_in)
        if E not in self.fused:
            self.fused[E] = self.step.make_fused_external_steps(
                self.prog.ctx, cfg, E)
        fs = self.prog.window(self.e_in, E)
        self.p = self.fused[E](self.p, fs, float(self.e_in * cfg.dt),
                               self.ext)
        counts = self.step.summary_counts(self.p)   # waits for the device
        self.e_in += E
        self.ext += E
        self.particle_steps += self.p.n * cfg.internal_steps * E
        self.chunks += 1
        if self.e_in == ep:
            self.end_episode()
        return counts

    def sample(self) -> dict:
        """The sampled particles' columns now."""
        return {k: getattr(self.p, k)[self.rows] for k in COLUMNS}


def launches():
    """The wrappers' launch counts of K1, K2 and K3."""
    from ltjax_torch.kernels import ext_step as kx, rk4_step as kr
    from ltjax_torch.kernels import step_lanes as sl
    return {"k1": kx.ext_step_fused.launches,
            "k2": kr.rk4_displacement_fused.launches,
            "k3": sl.step_lanes_fused.launches}


def expected_launches(route: str, n_ext: int, n_int: int) -> dict:
    """The launches a route makes in ``n_ext`` external steps: K1 once an
    external step, or K2 and K3 once an internal step each."""
    if route == "ext_step":
        return {"k1": n_ext, "k2": 0, "k3": 0}
    if route == "per_step":
        return {"k1": 0, "k2": n_ext * n_int, "k3": n_ext * n_int}
    return {"k1": 0, "k2": 0, "k3": 0}


def work(cell, inp, cfg_opts: dict, pos_bytes: int, chunks: list,
         n_int: int, launched: dict, ny: int = None, numpar: float = None,
         act: float = None) -> dict:
    """The frozen work count of the kernels that ran in a traced episode:
    operations over its active particle-steps (each chunk at the mean of
    its active counts before and after, or ``act`` where the caller has
    the exact count), bytes per launch times the launches.  A rank of a
    sharded cell gives its strip's rows (``ny``) and the particles it
    holds (``numpar``)."""
    from . import cell as cl, workcount as wc
    g, lt = cell.config["grid"], cell.ltrans
    us, ws = int(lt["us"]), int(lt["ws"])
    curv, passes = wc.grid_terms(cell.config)
    if act is None:
        act = sum(n * n_int * 0.5 * (a0 + a1)
                  for (_, a0), (n, a1) in zip(chunks[:-1], chunks[1:]))
    nv = sum(len(v) for _, v in inp.habitat + inp.holes)
    edges = cl.candidate_edges(inp)
    out = {}
    for k, n in launched.items():
        if not n:
            continue
        f32, f64 = wc.ops_per_step(k, cfg_opts, us, ws, pos_bytes == 8,
                                   curv, passes)
        f64 = act * f64
        if k != "k2" and cfg_opts.get("settlementon"):
            f64 += act * wc.settle_ops(edges)
        out[k] = {"f32": act * f32, "f64": f64, "active_steps": act,
                  "bytes": n * wc.launch_bytes(
                      k, cfg_opts, int(g["nx"]), int(ny or g["ny"]), us,
                      ws, numpar or cell.numpar, pos_bytes, 4, nv, curv)}
    return out


def load_reader(root: str, name: str):
    path = os.path.join(root, "ltbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"ltbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def trace_episode(run, sync, agree=None) -> dict:
    """One more episode of ``run`` (a Runner) under the profiler
    (``trace.profile``): the fullest window, its ``info`` holding the
    episode's chunks, the launches and K1's device counters."""
    from . import trace
    from .layers import KERNELS
    from ltjax_torch.kernels import ext_step as kx

    def one():
        kx.reset_launches()
        before = launches()
        act = run.episode()
        sync()
        after = launches()
        return {"chunks": act,
                "launched": {k: after[k] - before[k] for k in after},
                "staging": kx.counts() if after["k1"] > before["k1"]
                else None}

    return trace.profile(one, lambda info: {
        KERNELS[k]: n for k, n in info["launched"].items() if n}, sync,
        agree=agree)


def observe(cell, inp, root: str, best: dict, pos_bytes: int, n_int: int,
            **work_kw) -> dict:
    """What the per-layer readers read of a traced window ``best``."""
    from . import cell as cl
    from .ref.config import Config as RefConfig
    info = best["info"]
    opts = dataclasses.asdict(RefConfig(**cell.ltrans))
    return {"trace": best, "ext_steps": cell.episode, "numpar": cell.numpar,
            "launches": info["launched"], "staging": info["staging"],
            "peaks": cl.load_json(os.path.join(root, "ltbench", "peaks.json")),
            "work": work(cell, inp, opts, pos_bytes, info["chunks"], n_int,
                         info["launched"], **work_kw)}


def readings(cell, root: str, obs: dict) -> tuple:
    """(per-layer metrics, the breakdown, the trace's extra readings) of
    an observed traced window."""
    from . import layers, spans, trace
    from .layers import KERNELS
    best = obs["trace"]
    layer = {}
    for m in cell.per_layer:
        v = load_reader(root, m["name"])(obs)
        if v is not None:
            layer[m["name"]] = {"value": v, "unit": m["unit"]}
    a0, a1 = best["span"]
    roof = {k: layers.roofline(obs, k) for k in KERNELS}
    staging = obs["staging"]
    extra = {"busy_s": 1e-6 * trace.busy_us(best["device"], best["span"]),
             "window_s": 1e-6 * (a1 - a0),
             "roofline": {k: r for k, r in roof.items() if r},
             "trace_windows": best["windows"],
             "trace_complete": best["complete"],
             "trace_recorded": best["recorded"],
             "staging": staging,
             "active_steps": {
                 "counter": staging.get("active_steps") if staging else None,
                 "work_count": obs["work"].get("k1", {}).get("active_steps")},
             "idle_by_span": spans.idle_by_span(best),
             "span_match": spans.match_counts(best),
             "device_annotations": best.get("annotations", {})}
    breakdown = {"device_ops": trace.device_ops(best["device"]),
                 "idle_gaps": trace.idle_gaps(best["device"], best["host"],
                                              best["span"])}
    return layer, breakdown, extra


def traced(run, cell, inp, root: str, sync) -> tuple:
    """One more episode under the profiler: (per-layer metrics, the
    breakdown, the trace's extra readings)."""
    best = trace_episode(run, sync)
    obs = observe(cell, inp, root, best, run.start.x.element_size(),
                  run.cfg.internal_steps)
    return readings(cell, root, obs)


def window(run, closes) -> dict:
    """The measured window: ``run``'s chunks until an episode ends with
    ``closes(seconds since the start)`` true (whole episodes: a steady
    mix), the kept episode drawn as they end.  Its seconds, each chunk's,
    the particle-steps, the external steps and the wrappers' launches."""
    run.keep = True
    l0, steps0, ext0 = launches(), run.particle_steps, run.ext
    t0 = time.perf_counter()
    chunk_s = []
    while True:
        run.chunk()
        t1 = time.perf_counter()
        chunk_s.append(t1 - t0 - sum(chunk_s))
        if run.e_in == 0 and closes(t1 - t0):
            break
    run.keep = False
    l1 = launches()
    return {"window_s": t1 - t0, "chunk_s": chunk_s,
            "particle_steps": run.particle_steps - steps0,
            "ext": run.ext - ext0,
            "launches": {k: l1[k] - l0[k] for k in l1}}


def on_route(cell, route: str, win: dict, n_int: int, cuda: bool) -> tuple:
    """(whether the window took the configuration's route, the launches
    that route makes); the launch counts are checked on a card only."""
    want = expected_launches(route, win["ext"], n_int)
    return (route == cell.config["route"]
            and (not cuda or win["launches"] == want)), want


def compare(cell, inp, rows, got: dict, ext_first: int, device, sync,
            more: dict, log, **note) -> tuple:
    """The plain reference over the kept episode (from external step
    ``ext_first``) for the sampled ``rows``, against the program's
    ``got``; ``more`` the cell's other compared numbers.  Logs the
    numbers with ``note``; returns (correct, failed, checks, values)."""
    from . import check, reference
    t_ref = time.perf_counter()
    ref, clear = reference.run_episode(cell, inp, rows, ext_first, device)
    sync()
    ref_s = time.perf_counter() - t_ref
    values, same, per_row = check.numbers(
        got, ref, clear, bool(cell.ltrans.get("SaltTempOn")))
    values.update(more)
    correct, failed, checks = check.judge(values, cell.limits["limits"],
                                          same, per_row)
    log({"values": values, "quantiles": check.spread(per_row, same),
         "reference_s": ref_s, "episode_checked": ext_first,
         "sample": len(rows), **note})
    return correct, failed, checks, values


def end_to_end(cell, rate: float, peak: int, setup_s: float) -> dict:
    """The cell's end-to-end metrics of a run."""
    names = {m["name"] for m in cell.end_to_end}
    return {k: {"value": v, "unit": u} for k, v, u in (
        ("particle_steps_per_s", rate, "particle-steps/s"),
        ("peak_device_gib", peak / 2 ** 30, "GiB"),
        ("setup_s", setup_s, "s")) if k in names}


def measure(cell, seed: int, seconds: float, with_trace: bool, device,
            root: str, control: str = None, log=None) -> dict:
    """One run of ``cell``: set-up, the window, the traced episode where
    asked, the reference and the comparison.  Returns the result's
    fields (without the device's name)."""
    from . import cell as cl, inputs
    from ltjax_torch.step import mode_flags
    log = log or (lambda *a: None)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    inp = cl.make_inputs(cell, seed, device)
    prog = cl.build_program(cell, inp, device, dtype_pos=control)
    route = mode_flags(prog.ctx, prog.cfg)
    rows = inputs.sample_rows(cell.numpar, min(cell.numpar,
                                               int(cell.traffic["sample"])),
                              seed)
    run = CardRunner(cell, prog, rows, seed)
    run.episode()                                   # warm: every shape
    sync()
    setup_s = time.perf_counter() - T_START

    win = window(run, lambda s: s >= seconds)
    rate = win["particle_steps"] / win["window_s"]
    route_ok, want = on_route(cell, route, win, prog.cfg.internal_steps,
                              cuda)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log({"seed": seed, "window_s": win["window_s"], "chunks": run.chunks,
         "route": route, "launches": win["launches"], "expected": want,
         "episodes": run.episodes, "chunk_s": win["chunk_s"]})
    layer, breakdown, extra = (traced(run, cell, inp, root, sync)
                               if with_trace else ({}, None, {}))

    # --- the reference and the comparison -----------------------------
    ext_first, got = run.kept
    got = {k: v.cpu() for k, v in got.items()}
    n_episodes = run.episodes
    del run, prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, failed, checks, values = compare(
        cell, inp, rows, got, ext_first, device, sync,
        {"route_mismatch": 0 if route_ok else 1}, log, episodes=n_episodes)
    return {"correct": bool(correct), "attempted": len(rows),
            "failed": failed,
            "metrics": layer if with_trace else end_to_end(
                cell, rate, peak, setup_s),
            "peak": peak, "breakdown": breakdown, "extra": extra,
            "checks": checks, "values": values, "sampled": got}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ltbench", description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("float32",), default=None,
                    help="the program with float32 positions (the control)")
    args = ap.parse_args(argv)
    from . import cell as cl
    root = cl.ROOT
    cache_dirs(root)

    def log(obj):
        print(json.dumps(obj), file=sys.stderr, flush=True)

    c = cl.find_cell(args.workload, root)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < c.chips:
        print(f"ltbench: {args.workload} needs {c.chips} CUDA device(s), "
              f"found {found}: no result (a measurement takes no other "
              "device)", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    if c.chips > 1:
        from . import sharded
        try:
            res = sharded.measure(c, args.seed, args.seconds,
                                  bool(args.trace), "cuda", root, T_START,
                                  control=args.control, logging=True)
        except RuntimeError as e:
            print(f"ltbench: {e}", file=sys.stderr)
            return 4
        kind = res["kind"]
    else:
        device = torch.device("cuda", 0)
        res = measure(c, args.seed, args.seconds, bool(args.trace), device,
                      root, control=args.control, log=log)
        kind = torch.cuda.get_device_name(device)
    banned = sorted(set(banned_modules() + res.get("banned", [])))
    if banned:
        print("ltbench: loaded modules of JAX or the JAX package: "
              + ", ".join(banned), file=sys.stderr)
        return 3
    out = result_line(res, kind, c.chips, bool(args.trace), args.control)
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def result_line(res: dict, kind: str, count: int, with_trace: bool,
                control: str = None) -> dict:
    """The result's line of a run: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` (with ``--trace 1`` the traced
    window's busy and whole seconds, averaged over the cards), then
    ``breakdown`` and ``trace`` where traced, ``control`` where asked,
    and the compared numbers with their limits, last."""
    dev = {"platform": "gpu", "kind": kind, "count": count,
           "memory_peak_bytes": int(res["peak"]),
           "power_limit": power_limit()}
    if with_trace:
        dev["busy_s"] = res["extra"]["busy_s"]
        dev["window_s"] = res["extra"]["window_s"]
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": dev}
    if with_trace:
        out["breakdown"] = res["breakdown"]
        out["trace"] = {k: v for k, v in res["extra"].items()
                        if k not in ("busy_s", "window_s")}
    if control:
        out["control"] = control
    out["checks"] = res["checks"]
    return out


if __name__ == "__main__":
    sys.exit(main())
