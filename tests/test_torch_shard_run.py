"""Sharded runs through the port's run entry point (``ltjax_torch.run.run``
with ``mesh_particles * mesh_tiles > 1``: ``run_sharded``, gloo ranks on
the CPU) against the single-rank run on the same run files: a planar
17 x 17 solid-body series (omega 2e-4, 1 km cells), 200 particles with
horizontal turbulence, 4 external steps in chunks of 2, float64, output
every external step.

* A 2 x 2 run writes the single run's CSV, row for row (rank 0 gathers
  the snapshots in pid order), and its startup line names the backend,
  the ranks and the reader.
* Checkpoints every 2 external steps are per rank; ``--resume`` after
  deleting the last set gives the uninterrupted run's particles bit for
  bit on the same mesh, and within 1e-9 m (equal statuses) on a (1, 4)
  mesh from the 2 x 2 checkpoint (re-scattered).
* NetCDF output only: every rank writes a shard file, rank 0 merges them,
  and the merged file equals the single run's (floats within 1e-9);
  ``merge_shards`` gives ltjax's file on the same shard files.
* ``ErrorFlag = 0`` with a particle released on land: every rank stops
  with the halt's error (exit code 1 each, decided together), no hang.
* The chunk loop's edges on both placements, the single run and the 2 x 2
  mesh: a reader that ends (returns None) before ``external_steps`` gives
  one ``series_exhausted`` line at the same external step and the same
  particles; history files that end early stop both with the reader's
  IndexError after the same snapshots; ``WriteModelTiming`` reports the
  same phases (the single run's ``timing`` line, each ``rank_done``);
  the ErrorFlag halt stops the single run too.
* Refused before any rank starts: RANK without WORLD_SIZE, a WORLD_SIZE
  that is not the mesh, tiles on a curvilinear grid, NCCL on the CPU.
"""

import dataclasses
import json
import os
import shutil

import h5py
import numpy as np
import pytest
import torch

from ltjax.out.writer import merge_shards as j_merge_shards
from ltjax_torch import run, shard, synth
from ltjax_torch import state as tst
from ltjax_torch.config import config_from_namelist
from ltjax_torch.out.writer import TrajectoryWriter, merge_shards

torch.set_num_threads(1)

TOL = 1e-9          # m, float64, between meshes (tile origins differ)
MESH = dict(mesh_particles=2, mesh_tiles=2)


def _run(cfg, **kw):
    """run.run with fd 1 captured (the ranks write their lines to it):
    (particles, JSON lines)."""
    return _captured(lambda: run.run(cfg, device="cpu", **kw))


def _captured(fn):
    """fn() with fd 1 and sys.stdout captured (spawned ranks write to
    the one, this process to the other): (its result, JSON lines)."""
    import contextlib
    import sys
    import tempfile
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile("w+") as f:
        os.dup2(f.fileno(), 1)
        try:
            with contextlib.redirect_stdout(f):
                p = fn()
        finally:
            f.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        lines = [json.loads(ln) for ln in f if ln.startswith("{")]
    return p, lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-rank run and the 2 x 2 run of the same files."""
    d = str(tmp_path_factory.mktemp("torch_shard_run"))
    mask = np.ones((17, 17), np.int32)
    mask[9:11, 11:13] = 0
    case = synth.make_solid_body_case(nx=17, ny=17, us=4, lx=16e3, ly=16e3,
                                      h0=40.0, omega=2e-4, mask=mask)
    rng = np.random.default_rng(7)
    n = 200
    x0 = rng.uniform(2e3, 14e3, n)
    y0 = rng.uniform(2e3, 14e3, n)
    wet = mask[np.rint(y0 / 1e3).astype(int), np.rint(x0 / 1e3).astype(int)]
    x0, y0 = x0[wet > 0], y0[wet > 0]
    z0 = rng.uniform(-35.0, -3.0, x0.size)
    nml = synth.write_run_files(
        case, d, x0, y0, z0, n_ext=4, dt=1800, idt=450, iprint=1800,
        ext_fuse=2, HTurbOn=True, ConstantHTurb=1.0, checkpoint_every=2,
        halo_rows=shard.halo_rows_needed(2e-4 * 11.4e3, 1800.0, 1e3),
        migrate_capacity=3.0)
    base = config_from_namelist(nml)
    p1, _ = _run(dataclasses.replace(base, outpath=f"{d}/o1",
                                     checkpoint_dir=f"{d}/c1"))
    p4, lines = _run(dataclasses.replace(base, outpath=f"{d}/o4",
                                         checkpoint_dir=f"{d}/c4", **MESH))
    return d, base, p1, p4, lines


def test_sharded_cli_csv_equals_single_rank(runs):
    d, base, p1, p4, lines = runs
    start = lines[0]
    assert (start["backend"], start["ranks"], start["cards"]) == ("gloo", 4, 0)
    assert start["reader"] == "native" and start["mesh"] == [2, 2]
    chunks = [ln for ln in lines if "ext" in ln and "rank" in ln]
    assert sorted({ln["rank"] for ln in chunks}) == [0, 1, 2, 3]
    assert sum(ln["migrated"] for ln in chunks) > 0
    assert all(ln["migration_drops"] == 0 and ln["error"] == 0
               for ln in chunks)
    with open(f"{d}/o1/run1.csv") as a, open(f"{d}/o4/run1.csv") as b:
        assert a.read() == b.read()
    order = torch.argsort(p1.pid)
    for k in tst.FIELDS:
        assert torch.equal(getattr(p4, k), getattr(p1, k)[order]), k
    assert sorted(os.listdir(f"{d}/c4")) == sorted(
        f"ckpt_{e}_h{r:03d}.npz" for e in (2, 4) for r in range(4))


def _resume(d, base, src, name, **mesh):
    ck = f"{d}/{name}"
    shutil.copytree(src, ck)
    for f in os.listdir(ck):
        if f.startswith("ckpt_4"):
            os.remove(os.path.join(ck, f))
    cfg = dataclasses.replace(base, outpath=f"{d}/o_{name}",
                              checkpoint_dir=ck, **mesh)
    return _run(cfg, resume=True)[0]


def test_resume_on_same_and_changed_mesh(runs):
    d, base, p1, p4, _ = runs
    same = _resume(d, base, f"{d}/c4", "r22", **MESH)
    for k in tst.FIELDS:
        assert torch.equal(getattr(same, k), getattr(p4, k)), k
    other = _resume(d, base, f"{d}/c4", "r14", mesh_particles=1,
                    mesh_tiles=4)
    for k in ("pid", "status", "hit_land"):
        assert torch.equal(getattr(other, k), getattr(p4, k)), k
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(other, k).numpy(),
                                   getattr(p4, k).numpy(), rtol=0, atol=TOL)


def _nc(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f.keys()}


def test_netcdf_only_run_merges_shard_files(runs):
    d, base, p1, _, _ = runs
    nc = dict(writeNC=True, writeCSV=False)
    _run(dataclasses.replace(base, outpath=f"{d}/n1", checkpoint_every=0,
                             **nc))
    _run(dataclasses.replace(base, outpath=f"{d}/n4", checkpoint_every=0,
                             **nc, **MESH))
    assert sorted(os.listdir(f"{d}/n4")) == ["run1.nc"]
    one, four = _nc(f"{d}/n1/run1.nc"), _nc(f"{d}/n4/run1.nc")
    assert sorted(one) == sorted(four)
    assert one["lon"].shape == (5, p1.n)
    for k, a in one.items():
        if a.dtype.kind == "f":
            np.testing.assert_allclose(four[k], a, rtol=0, atol=TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(four[k], a, err_msg=k)


def test_merge_shards_matches_ltjax(runs, tmp_path):
    """Two ranks' shard files with EMPTY slots and a particle that moves
    from one to the other, merged by the port and by ltjax."""
    _, base, _, _, _ = runs
    cfg = dataclasses.replace(base, outpath=str(tmp_path), writeNC=True,
                              writeCSV=False, TrackCollisions=True)
    rng = np.random.default_rng(1)
    pids = [np.array([0, 3, -1, 5]), np.array([1, -1, 2, 4])]
    ws = [TrajectoryWriter(cfg, shard_tag=f"_h{r:03d}") for r in range(2)]
    for k in range(3):
        if k == 2:                          # pid 5 migrates to rank 1
            pids = [np.array([0, 3, -1, -1]), np.array([1, 5, 2, 4])]
        for w, pid in zip(ws, pids):
            n = pid.size
            p = tst.init_particles(rng.uniform(0, 1e4, n),
                                   rng.uniform(0, 1e4, n),
                                   rng.uniform(-30, -1, n))
            p = p.replace(pid=torch.as_tensor(pid, dtype=torch.int32),
                          status=torch.as_tensor(np.where(pid < 0, -1, 1),
                                                 dtype=torch.int32),
                          hit_land=torch.as_tensor(rng.integers(0, 3, n),
                                                   dtype=torch.int32))
            w.snapshot(600.0 * k, p)
    for w in ws:
        w.close()
    paths = [str(tmp_path / f"run1_h{r:03d}.nc") for r in range(2)]
    merge_shards(paths, str(tmp_path / "port.nc"))
    j_merge_shards(paths, str(tmp_path / "ltjax.nc"))
    a, b = _nc(tmp_path / "port.nc"), _nc(tmp_path / "ltjax.nc")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["pid"], [0, 1, 2, 3, 4, 5])


def test_error_flag_halt_stops_every_rank(runs):
    d, base, _, _, _ = runs
    with open(base.parfile) as f:
        rows = f.read().splitlines()
    rows[0] = "11500.0,9500.0,10.0,0.0"      # released in the land block
    parfile = f"{d}/parfile_land.csv"
    with open(parfile, "w") as f:
        f.write("\n".join(rows) + "\n")
    cfg = dataclasses.replace(base, outpath=f"{d}/e4", parfile=parfile,
                              checkpoint_every=0, ErrorFlag=0, **MESH)
    with pytest.raises(RuntimeError, match="ErrorFlag=0 halts") as e:
        _run(cfg)
    assert "ranks [0, 1, 2, 3] failed" in str(e.value)
    assert "{0: 1, 1: 1, 2: 1, 3: 1}" in str(e.value)


def test_refused_before_ranks_start(runs, monkeypatch, tmp_path):
    _, base, _, _, _ = runs
    cfg = dataclasses.replace(base, **MESH)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="BOTH RANK and WORLD_SIZE"):
        run.run(cfg, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2"):
        run.run(cfg, device="cpu")
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        run.run(cfg, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend applies to sharded"):
        run.run(dataclasses.replace(base, outpath=str(tmp_path)),
                device="cpu", backend="gloo")
    case = synth.make_curv_case(nx=9, ny=9, us=4, lx=8e3, ly=8e3, h0=30.0)
    nml = synth.write_run_files(case, str(tmp_path / "curv"),
                                np.full(4, 4e3), np.full(4, 4e3),
                                np.full(4, -5.0), n_ext=1, dt=1800, idt=450,
                                geographic=True, lonmin=-76.0, latmin=37.0,
                                mesh_particles=1, mesh_tiles=2)
    with pytest.raises(NotImplementedError, match="PARTICLE axis only"):
        run.run(config_from_namelist(nml), device="cpu")


def _end_reader_after(n_records: int):
    """RomsSeries.next_record, returning None (the end of the series, as
    the prefetcher passes it on) after ``n_records`` records of a
    series."""
    from ltjax_torch.io.roms import RomsSeries
    read = RomsSeries.next_record

    def next_record(self):
        self._n_read = getattr(self, "_n_read", 0) + 1
        return read(self) if self._n_read <= n_records else None
    return next_record


def _rank_with_short_reader(rank, world, init_method, n_records, *args):
    """``run._rank_run`` with a reader that ends after ``n_records``
    (a spawned rank: the patch lives in its own process)."""
    from ltjax_torch.io.roms import RomsSeries
    RomsSeries.next_record = _end_reader_after(n_records)
    return run._rank_run(rank, world, init_method, *args)


@pytest.mark.parametrize("case, placement", [
    ("reader_ends", "single"), ("reader_ends", "mesh"),
    ("files_end", "single"), ("files_end", "mesh"),
    ("timing", "single"), ("timing", "mesh"),
    ("halt", "single")])
def test_chunk_loop_edges_on_both_placements(runs, monkeypatch, case,
                                             placement):
    from ltjax_torch import dist
    from ltjax_torch.io.roms import RomsSeries
    d, base, p1, _, _ = runs
    name = f"{d}/edge_{case}_{placement}"
    cfg = dataclasses.replace(base, outpath=name, checkpoint_dir=name,
                              checkpoint_every=0,
                              WriteModelTiming=case == "timing",
                              **(MESH if placement == "mesh" else {}))

    def first_three_snapshots():
        # the uninterrupted run's snapshots at ext 0, 1, 2 of 0..4
        with open(f"{d}/o1/run1.csv") as f:
            full = f.read().splitlines()
        with open(f"{name}/run1.csv") as f:
            rows = f.read().splitlines()
        assert len(rows) == len(full) - 2 * p1.n
        assert rows == full[:len(rows)]

    if case == "reader_ends":
        # 4 records: the chunk at external step 2 needs a fifth
        if placement == "single":
            monkeypatch.setattr(RomsSeries, "next_record",
                                _end_reader_after(4))
            p, lines = _run(cfg)
        else:
            res, lines = _captured(lambda: dist.launch(
                _rank_with_short_reader, 4,
                (4, cfg, False, "cpu", None, "gloo")))
            p = shard.gather_particles([r["particles"] for r in res])
        assert [ln for ln in lines if ln.get("event") == "series_exhausted"
                ] == [{"event": "series_exhausted", "ext": 2}]
        assert max(ln["ext"] for ln in lines if "n_fused" in ln) == 1
        monkeypatch.undo()
        two, _ = _run(dataclasses.replace(
            base, outpath=f"{name}_2", checkpoint_every=0,
            days=2 * base.dt / 86400.0))
        a, b = torch.argsort(p.pid), torch.argsort(two.pid)
        for k in ("pid", "status", "hit_land"):
            assert torch.equal(getattr(p, k)[a], getattr(two, k)[b]), k
        for k in ("x", "y", "z"):
            np.testing.assert_allclose(getattr(p, k)[a].numpy(),
                                       getattr(two, k)[b].numpy(),
                                       rtol=0, atol=TOL, err_msg=k)
        first_three_snapshots()
    elif case == "files_end":
        # one file of 4 records: its reader raises at the fifth
        with pytest.raises((IndexError, RuntimeError)) as e:
            _run(cfg, series_paths=[f"{d}/ocean_his_0001.nc"])
        assert "IndexError" in f"{type(e.value).__name__}: {e.value}"
        first_three_snapshots()
    elif case == "timing":
        _, lines = _run(cfg)
        phases = ["compute", "hydro_init", "hydro_read", "output"]
        timing = [ln["timing"] for ln in lines if "timing" in ln]
        assert [sorted(t) for t in timing] == [phases] * (
            1 if placement == "single" else 4)
        if placement == "mesh":
            assert all(ln.get("event") == "rank_done"
                       for ln in lines if "timing" in ln)
    else:
        with open(base.parfile) as f:
            rows = f.read().splitlines()
        rows[0] = "11500.0,9500.0,10.0,0.0"  # released in the land block
        parfile = f"{d}/parfile_land_single.csv"
        with open(parfile, "w") as f:
            f.write("\n".join(rows) + "\n")
        with pytest.raises(RuntimeError, match="ErrorFlag=0 halts"):
            _run(dataclasses.replace(cfg, parfile=parfile, ErrorFlag=0))
