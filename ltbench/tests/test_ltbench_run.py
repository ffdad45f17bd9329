"""A run of the harness on the CPU at a tiny size (the program's plain
versions stand in for its kernels): it passes on the program as it is,
and ``correct`` comes out false for the control (float32 positions) and
for each fault planted under the timed path, with the cells' own
limits.  A measurement without a card fails and prints nothing, and the
check for JAX compares top-level names whole."""

import os
import subprocess
import sys

import pytest
import torch

import ltbench_tiny
from ltbench import cell as cl, run

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1234


def measure(root, workload, **kw):
    return run.measure(cl.find_cell(workload, root), SEED, 0.0, False, CPU,
                       root, **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return ltbench_tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", ["advect-1m", "advect-sheared-1m",
                                      "oyster"])
def test_the_program_passes_and_its_control_fails(root, workload):
    res = measure(root, workload)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {"particle_steps_per_s",
                                   "peak_device_gib", "setup_s"}
    ctl = measure(root, workload, control="float32")
    assert not ctl["correct"], ctl["checks"]


DATA = ("zeta", "u", "v", "w", "aks", "salt", "temp")


def _planted(monkeypatch, fault):
    """Break the fused external steps underneath the harness: the state
    returned unchanged, half the batch left out, one answer in 64 moved
    1 m, the record window read one record late, each external step
    reading its middle record alone (no time collapse), or the vertical
    velocity left out."""
    import dataclasses
    from ltjax_torch import step
    make = step.make_fused_external_steps

    def records(fs, f):
        return dataclasses.replace(fs, **{k: f(getattr(fs, k))
                                          for k in DATA})

    def broken(ctx, cfg, n):
        fused = make(ctx, cfg, n)
        one = make(ctx, cfg, 1)

        def call(p, fs, t0, ext0):
            if fault == "unchanged":
                return p
            if fault == "one_record":
                for e in range(n):
                    w = records(fs, lambda c: c[e + 1:e + 2].expand(
                        3, *c.shape[1:]).contiguous())
                    w = dataclasses.replace(w, times=fs.times[e:e + 3])
                    p = one(p, w, t0 + e * cfg.dt, ext0 + e)
                return p
            if fault == "offset":
                fs = records(fs, lambda c: torch.cat([c[1:], c[-1:]]))
            if fault == "no_w":
                fs = records(fs, lambda c: c)
                fs.w = torch.zeros_like(fs.w)
            out = fused(p, fs, t0, ext0)
            if fault == "half":
                h = p.n // 2
                return out.replace(**{
                    k: torch.cat([getattr(out, k)[:h], getattr(p, k)[h:]])
                    for k in ("x", "y", "z", "status", "age")})
            if fault == "altered":
                x = out.x.clone()
                x[::64] += 1.0                   # an answer altered
                return out.replace(x=x)
            return out
        return call

    monkeypatch.setattr(step, "make_fused_external_steps", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "offset",
                                   "one_record", "no_w"])
@pytest.mark.parametrize("workload", ["advect-1m", "advect-sheared-1m",
                                      "oyster"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, workload,
                                            fault):
    _planted(monkeypatch, fault)
    res = measure(root, workload)
    assert not res["correct"] and res["failed"] > 0, res["checks"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "advect-1m", "--seed", "5",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_banned_modules_compare_whole_top_level_names():
    mods = ["ltjax_torch", "ltjax_torch.step", "ltjaxish", "numpy",
            "jax", "jax.numpy", "jaxlib.xla", "flax", "ltjax", "ltjax.run"]
    assert run.banned_modules(mods) == ["flax", "jax", "jax.numpy",
                                        "jaxlib.xla", "ltjax", "ltjax.run"]
    assert run.banned_modules(["ltjax_torch.kernels.ext_step"]) == []


def test_the_harness_loads_no_jax():
    code = ("import ltbench.run, ltbench.reference, ltjax_torch.step, "
            "ltjax_torch.kernels.step_lanes; "
            "print(ltbench.run.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ltbench_tiny.REPO, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_needs_more_than_the_benchmark(tmp_path):
    """In a directory with BENCHMARK.json and ltbench alone (no program),
    a run fails and prints no result."""
    import shutil
    shutil.copytree(os.path.join(ltbench_tiny.REPO, "ltbench"),
                    tmp_path / "ltbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    ltbench_tiny.make(tmp_path)
    code = ("import torch; from ltbench import cell as cl, run; "
            "print(run.measure(cl.find_cell('advect-1m'), 1, 0.0, False, "
            "torch.device('cpu'), cl.ROOT))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "ltjax_torch" in out.stderr
