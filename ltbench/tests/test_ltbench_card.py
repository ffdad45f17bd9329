"""One short run of a cell on the card through the benchmark's command:
a result line, ``correct`` true, the device named.  Run on a
machine with a CUDA device: ``python3 -m pytest ltbench/tests -m gpu``."""

import json
import subprocess
import sys

import pytest

import ltbench_tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures only there")


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "ltbench", "--workload",
                          "advect-1m", "--seed", str(2 ** 31 + 99),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True,
                         cwd=ltbench_tiny.REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"particle_steps_per_s", "peak_device_gib",
                                   "setup_s"}
