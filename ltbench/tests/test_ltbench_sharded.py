"""The four-rank driver (``ltbench.sharded``) on the CPU at a tiny size,
over gloo: the program's plain versions stand in for its kernels, four
processes for the four cards.  Its sampled final states equal the one-rank
harness's bit for bit (the sharded path reproduces the single one), its
rate counts ``numpar`` and not the slots, and ``correct`` comes out false
for the control and for each fault planted under the timed path
(``sharded_faults``).  Also on hand-made inputs: the shard layer's
readers, the trace's split of user annotations, the result line's keys
and the refusal without the cards."""

import dataclasses
import json
import time
from types import SimpleNamespace

import pytest
import torch

import ltbench_tiny
import sharded_faults
from ltbench import cell as cl, run, sharded, trace

CELL = "tiles-10m-4chip"
SEED = 2 ** 31 + 4321


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return ltbench_tiny.make(tmp_path_factory.mktemp("tiny"), n=4096,
                             episode=4, sample=4096)


def sharded_run(root, **kw):
    return sharded.measure(cl.find_cell(CELL, root), SEED, 0.0,
                           kw.pop("with_trace", False), "cpu", root,
                           time.perf_counter(), **kw)


def test_four_ranks_equal_one_rank_and_count_numpar(root):
    c = cl.find_cell(CELL, root)
    res = sharded_run(root)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    v = res["values"]
    assert v["migration_drops"] == 0 and v["held_gap"] == 0
    assert v["status_mismatch"] == 0 and v["route_mismatch"] == 0
    # the window is one episode: numpar particles, not the ranks' slots
    steps = c.numpar * 30 * c.episode
    assert res["particle_steps"] == steps
    spec_slots = 4 * -(-int(c.numpar * c.ltrans["migrate_capacity"]) // 4)
    assert spec_slots > c.numpar
    assert res["metrics"]["particle_steps_per_s"]["value"] == pytest.approx(
        steps / res["window_s"])
    one_cell = dataclasses.replace(c, limits={"limits": {
        k: x for k, x in c.limits["limits"].items()
        if k not in ("migration_drops", "held_gap")}})
    one = run.measure(one_cell, SEED, 0.0, False, torch.device("cpu"), root)
    assert one["correct"], one["checks"]
    for k in run.COLUMNS:
        assert torch.equal(res["sampled"][k], one["sampled"][k]), k


def test_the_control_is_not_correct(root):
    res = sharded_run(root, control="float32")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["small_mig_cap", "lose_row",
                                   "other_strip", "no_exchange", "unchanged",
                                   "half", "altered"])
def test_a_broken_sharded_path_is_not_correct(root, fault):
    res = sharded_run(root, prepare=getattr(sharded_faults, fault))
    assert not res["correct"] and res["failed"] > 0, res["checks"]
    if fault == "small_mig_cap":
        assert res["values"]["migration_drops"] > 0
    if fault == "lose_row":
        assert res["values"]["held_gap"] > 0


def test_the_traced_run_reads_every_rank(root):
    res = sharded_run(root, with_trace=True)
    assert res["correct"], res["checks"]
    ranks = res["extra"]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert sum(r["held_start"] for r in ranks) == 4096
    assert sum(r["held_end"] for r in ranks) == 4096
    assert res["metrics"]["migrated_pct"]["value"] == pytest.approx(
        100.0 * sum(r["migrated"] for r in ranks) / (4096 * 4))
    assert res["metrics"]["migrated_pct"]["value"] > 0
    assert 0 <= res["extra"]["pace_rank"] < 4
    for k in ("staging", "active_steps", "idle_by_span"):
        assert k in res["extra"]


def test_gather_sample_marks_missing_and_twice():
    rows = torch.tensor([2, 5, 7, 9])
    part = {"pid": torch.tensor([9, 2, 7], dtype=torch.int32),
            "x": torch.tensor([9.0, 2.0, 7.0], dtype=torch.float64),
            "status": torch.tensor([1, 1, 2], dtype=torch.int32)}
    for k in ("y", "z", "salt", "temp"):
        part[k] = part["x"].clone()
    other = {k: v[2:] for k, v in part.items()}          # 7 held twice
    got = sharded.gather_sample(rows, [part, other], torch.float64)
    assert got["x"][0] == 2.0 and got["x"][3] == 9.0
    assert got["status"].tolist() == [1, sharded.MISSING, sharded.TWICE, 1]


def _obs(ranks, device=()):
    return {"ranks": ranks, "numpar": 1000, "ext_steps": 4,
            "trace": {"device": list(device), "host": [],
                      "span": [0.0, 100.0]}}


def test_shard_layer_readers():
    ranks = [{"migrated": 10, "k1_ms": 1.0}, {"migrated": 30, "k1_ms": 3.0}]
    dev = [("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
            0.0, 500.0), ("void ext_step_kernel<0>()", 500.0, 900.0),
           ("ncclDevKernel_AllReduce_Sum_i64_RING_LL", 950.0, 1050.0)]
    read = {m: run.load_reader(cl.ROOT, m) for m in (
        "migrated_pct", "rank_skew_pct", "exchange_device_ms_per_ext")}
    assert read["migrated_pct"](_obs(ranks)) == pytest.approx(1.0)
    assert read["rank_skew_pct"](_obs(ranks)) == pytest.approx(50.0)
    assert read["exchange_device_ms_per_ext"](
        _obs(ranks, dev)) == pytest.approx(0.6 / 4)
    one_card = _obs(None, dev)
    for r in read.values():
        assert r(one_card) is None
    assert read["exchange_device_ms_per_ext"](_obs(ranks)) is None


def test_the_split_keeps_user_annotations_off_the_device():
    from torch.autograd import DeviceType

    def ev(name, a, b, dev, note=False):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(
            start=a, end=b), is_user_annotation=note,
            device_type=DeviceType.CUDA if dev else DeviceType.CPU)

    events = [ev(trace.SPAN, 0, 100, False, True),
              ev(trace.SPAN, 5, 95, True, True),
              ev("nccl:all_to_all", 10, 20, False, True),
              ev("nccl:all_to_all", 12, 40, True, True),
              ev("ncclDevKernel_SendRecv", 30, 40, True),
              ev("cudaLaunchKernel", 11, 12, False)]
    dev, host, span, notes = trace.split(events)
    assert span == (0.0, 100.0)
    assert dev == [("ncclDevKernel_SendRecv", 30.0, 40.0)]
    assert [h[0] for h in host] == ["nccl:all_to_all", "cudaLaunchKernel"]
    assert notes == {trace.SPAN: 90.0, "nccl:all_to_all": 28.0}


def test_result_line_keys():
    res = {"correct": True, "attempted": 4, "failed": 0, "metrics": {},
           "peak": 7, "breakdown": {"device_ops": []},
           "extra": {"busy_s": 1.0, "window_s": 2.0, "roofline": {}},
           "checks": {"h_gap_max_m": {"value": 0.0, "limit": 0.1}}}
    out = run.result_line(res, "card", 1, False)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    out = run.result_line(res, "card", 4, True, "float32")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "trace", "control", "checks"]
    assert out["device"]["count"] == 4 and out["device"]["busy_s"] == 1.0
    assert "busy_s" not in out["trace"]
    json.dumps(out)


def test_four_cards_asked_one_found(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", CELL, "--seed", "5", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "needs 4 CUDA device(s), found 1" in out.err


def _nccl_window(launch_recorded):
    host = [("ltjax_torch.chunk", 0.0, 100.0), ("ltjax_torch.sort", 1.0, 10.0),
            ("cudaLaunchKernel", 2.0, 3.0), ("nccl:all_to_all", 20.0, 30.0),
            ("cudaLaunchKernel", 40.0, 41.0)]
    if launch_recorded:
        host.append(("cuLaunchKernelEx", 21.0, 22.0))
    dev = [("void sort_kernel()", 5.0, 8.0),
           ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
            25.0, 35.0), ("void gather_kernel()", 45.0, 50.0)]
    return {"host": host, "device": dev, "span": (0.0, 100.0)}


@pytest.mark.parametrize("launch_recorded", [True, False])
def test_span_matching_with_nccl_kernels(launch_recorded):
    from ltbench import spans
    t = _nccl_window(launch_recorded)
    by = spans.device_by_span(t)
    assert [r[0] for r in by["ltjax_torch.sort"]] == ["void sort_kernel()"]
    chunk = [r[0] for r in by["ltjax_torch.chunk"]]
    assert chunk[-1] == "void gather_kernel()"
    assert len(chunk) == (2 if launch_recorded else 1)
    assert spans.layer_device_ms(t, ("sort",)) == pytest.approx(0.003)
    n = 3 if launch_recorded else 2
    assert spans.match_counts(t) == {"launches": n, "records": n,
                                     "matched": n}
