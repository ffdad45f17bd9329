"""The CLI's record prefetcher and diagnostic switches, on the CPU.

``ltjax_torch.io.prefetch.Prefetcher`` (after tests/test_io.py's tests
of ltjax's): records come in the series' order, the end of the series
comes as None, an error in the reader is raised in the consumer, and
``close()`` returns while the worker is blocked on a full queue.  The
CLI (``run.run(cfg, device="cpu")``) gives identical particles with
``prefetch`` on and off, and each chunk's log line carries ``stall_s``
(with the chunk's ``hydro_read_s`` and ``compute_s``).
``LTJAX_PROFILE_DIR`` writes a trace file of the chunks it covers, and
``LTJAX_DEBUG_NANS`` raises on a record with a NaN in it.
"""

import contextlib
import dataclasses
import glob
import io
import json
import time

import numpy as np
import pytest
import torch

from ltjax_torch import run as trun
from ltjax_torch import state as tst
from ltjax_torch import synth
from ltjax_torch.config import config_from_namelist
from ltjax_torch.io.prefetch import Prefetcher
from ltjax_torch.io.roms import RomsSeries

torch.set_num_threads(1)

N_EXT = 4


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_prefetch"))
    case = synth.make_solid_body_case(nx=15, ny=15, us=4, lx=20e3, ly=20e3,
                                      h0=30.0, omega=1e-4,
                                      dtype=torch.float64,
                                      parabolic_aks=True)
    rng = np.random.default_rng(21)
    n = 120
    nml = synth.write_run_files(
        case, d, rng.uniform(5e3, 15e3, n), rng.uniform(5e3, 15e3, n),
        rng.uniform(-25.0, -3.0, n), n_ext=N_EXT, dt=1800, idt=600,
        iprint=N_EXT * 1800, ext_fuse=1, HTurbOn=True, ConstantHTurb=1.0,
        VTurbOn=True, readAks=True, seed=5)
    return d, nml


def _run(cfg):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p = trun.run(cfg, device="cpu")
    return p, [json.loads(ln) for ln in buf.getvalue().splitlines()
               if ln.startswith("{")]


def test_prefetcher_order_and_end(run_files):
    _, nml = run_files
    cfg = config_from_namelist(nml)
    want = RomsSeries(cfg)
    times = [want.next_record()["time"] for _ in range(N_EXT + 2)]
    want.close()
    series = RomsSeries(cfg)

    def read_fn():
        try:
            return series.next_record()
        except FileNotFoundError:     # past the last file
            return None

    pf = Prefetcher(read_fn, depth=2)
    got = []
    while (rec := pf.next()) is not None:
        assert isinstance(rec["u"], np.ndarray)     # the CPU reads ahead
        got.append(rec["time"])
    assert got == times
    assert pf.stall_s >= 0.0
    pf.close()
    series.close()


def test_prefetcher_raises_in_consumer():
    calls = []

    def read_fn():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("bad record")
        return {"time": float(len(calls))}

    pf = Prefetcher(read_fn, depth=4)
    assert pf.next()["time"] == 1.0
    assert pf.next()["time"] == 2.0
    with pytest.raises(RuntimeError, match="bad record"):
        pf.next()
    pf.close()


def test_prefetcher_close_while_worker_blocked():
    """The worker fills the queue and blocks on put; close() drains it
    and the worker ends."""
    reads = []

    def read_fn():
        reads.append(1)
        return {"time": float(len(reads))}

    pf = Prefetcher(read_fn, depth=2)
    deadline = time.time() + 5.0
    while len(reads) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert len(reads) == 3            # two queued, one waiting to go in
    t0 = time.perf_counter()
    pf.close()
    assert time.perf_counter() - t0 < 2.0
    assert not pf._thread.is_alive()


def test_cli_prefetch_on_and_off_identical(run_files):
    _, nml = run_files
    cfg = config_from_namelist(nml)
    p_on, lines_on = _run(dataclasses.replace(cfg, prefetch=True))
    p_off, lines_off = _run(dataclasses.replace(cfg, prefetch=False))
    for k in tst.FIELDS:
        assert torch.equal(getattr(p_on, k), getattr(p_off, k)), k
    chunks = lines_on[1:]
    assert [c["ext"] for c in chunks] == list(range(N_EXT))
    for c in chunks:
        assert c["stall_s"] >= 0.0 and c["hydro_read_s"] >= 0.0
        assert c["compute_s"] > 0.0
    assert all(c["stall_s"] == 0.0 for c in lines_off[1:])
    assert np.abs(p_on.z.numpy()).max() > 0   # the turbulent run moved


def test_profile_dir_writes_trace(run_files, tmp_path, monkeypatch):
    _, nml = run_files
    monkeypatch.setenv("LTJAX_PROFILE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("LTJAX_PROFILE_STEPS", "1:3")
    _run(config_from_namelist(nml))
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert [f.rsplit("/", 1)[1] for f in files] == ["trace_ext1-3.json"]
    with open(files[0]) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0


def test_debug_nans_raises_on_nan_record(run_files, monkeypatch):
    _, nml = run_files
    cfg = config_from_namelist(nml)
    real = RomsSeries.next_record
    count = [0]

    def poisoned(self):
        rec = real(self)
        count[0] += 1
        if count[0] == 4:             # record 3: the second external step
            rec["u"] = np.full_like(rec["u"], np.nan)
        return rec

    monkeypatch.setattr(RomsSeries, "next_record", poisoned)
    monkeypatch.setenv("LTJAX_DEBUG_NANS", "1")
    with pytest.raises(RuntimeError,
                       match=r"LTJAX_DEBUG_NANS: \d+ released particles .* "
                             r"external step 1"):
        _run(cfg)
    count[0] = 0
    monkeypatch.delenv("LTJAX_DEBUG_NANS")
    # off, the NaNs go through unchecked
    p, _ = _run(dataclasses.replace(cfg, ErrorFlag=1))
    assert torch.isnan(p.x).any()
