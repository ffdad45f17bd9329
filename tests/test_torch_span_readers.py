"""The benchmark's readers of the port's spans and counters
(``ltbench/spans.py``, ``ltbench/metrics/``) on a hand-made traced
window: one chunk of two external steps whose tables, sort, K1 call (with
its upload) and unsort each launched device work, then the status
counts.  Every value is computed by hand below.  Without program spans
(an older program) every new reader gives None; with records lost the
launches are matched only between K1's launches where the counts agree.
The program's spans are host records: the accepted readers of device
time read the same window with and without them."""

import copy
import os

import pytest

from ltbench import cell as cl, run as lr, spans

ROOT = cl.ROOT
K1 = "void ext_step_kernel<0, 0, 0, 0, 0, 0>(Args, Settle, Curv, Stage)"


def _window():
    host = [
        ("ltjax_torch.chunk", 0.0, 100.0),
        ("ltjax_torch.tables", 1.0, 5.0),
        ("cudaLaunchKernel", 2.0, 2.5),
        ("ltjax_torch.sort", 6.0, 20.0),
        ("aten::argsort", 6.5, 9.0),
        ("cudaMemsetAsync", 7.0, 7.5),
        ("cudaLaunchKernel", 8.0, 8.5),
        ("ltjax_torch.k1", 21.0, 60.0),
        ("ltjax_torch.k1.upload", 22.0, 50.0),
        ("cudaMemcpyAsync", 23.0, 49.0),
        ("cudaLaunchKernel", 55.0, 55.5),
        ("ltjax_torch.unsort", 61.0, 70.0),
        ("cudaLaunchKernel", 62.0, 62.5),
        ("ltjax_torch.counts", 101.0, 120.0),
        ("cudaMemcpyAsync", 105.0, 111.5),
        ("cudaStreamSynchronize", 106.0, 111.0),
    ]
    device = [
        ("void at::native::cat_kernel", 3.0, 4.0),
        ("Memset (Device)", 10.0, 11.0),
        ("void cub::DeviceRadixSortOnesweepKernel", 11.0, 14.0),
        ("Memcpy HtoD (Pageable -> Device)", 50.0, 51.0),
        (K1, 56.0, 90.0),
        ("void at::native::index_kernel", 90.0, 92.0),
        ("Memcpy DtoH (Device -> Pageable)", 110.0, 111.0),
    ]
    return {"host": host, "device": device, "span": [0.0, 130.0],
            "info": {"chunks": [[0, 1000], [2, 1000]]}}


def _obs(t=None, staging=None):
    return {"trace": t or _window(), "ext_steps": 2,
            "launches": {"k1": 1, "k2": 0, "k3": 0},
            "staging": staging if staging is not None else {
                "staged_block_steps": 10, "global_block_steps": 0,
                "staged_misses": 0, "split_block_steps": 4,
                "active_steps": 1000},
            "peaks": cl.load_json(os.path.join(ROOT, "ltbench",
                                               "peaks.json")),
            "work": {"k1": {"f32": 1e3, "f64": 1e3, "bytes": 1e3,
                            "active_steps": 1000}}}


NEW = ("sort_device_ms_per_ext", "tables_device_ms_per_ext",
       "k1_host_ms_per_launch", "program_idle_ms_per_chunk",
       "k1_ns_per_active_step", "k1_split_pct")
HAND = {
    # sort: the memset and the radix kernel, merged [10, 14] = 4 us, and
    # the unsort's kernel 2 us; over 2 external steps
    "sort_device_ms_per_ext": 6e-3 / 2,
    # tables: the cat kernel, 1 us
    "tables_device_ms_per_ext": 1e-3 / 2,
    # k1: 39 us less its upload's 28 us
    "k1_host_ms_per_launch": 11e-3,
    # idle [0, 3], [4, 10], [14, 50], [51, 56], [92, 110], [111, 130]
    # inside [0, 100] and [101, 120]: 3 + 6 + 36 + 5 + 8 + 9 + 9 us
    "program_idle_ms_per_chunk": 76e-3,
    # K1's 34 us over 1000 active particle-steps
    "k1_ns_per_active_step": 34.0,
    # 4 of the 10 staged block-steps split, none global
    "k1_split_pct": 40.0,
}


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_gives_the_hand_value(name):
    assert lr.load_reader(ROOT, name)(_obs()) == pytest.approx(HAND[name])


@pytest.mark.parametrize("name", NEW)
def test_without_program_spans_or_counter_each_reader_gives_none(name):
    t = _window()
    t["host"] = [h for h in t["host"] if not h[0].startswith("ltjax_torch")]
    staging = {"staged_block_steps": 10, "global_block_steps": 0,
               "staged_misses": 0}
    assert lr.load_reader(ROOT, name)(_obs(t, staging)) is None


def test_records_go_to_the_innermost_span_that_launched_them():
    by = spans.device_by_span(_window())
    assert {k: len(v) for k, v in by.items()} == {
        "ltjax_torch.tables": 1, "ltjax_torch.sort": 2,
        "ltjax_torch.k1.upload": 1, "ltjax_torch.k1": 1,
        "ltjax_torch.unsort": 1, "ltjax_torch.counts": 1}
    assert by["ltjax_torch.k1"][0][0] == K1


def test_idle_by_span_names_the_innermost_span_at_each_gap():
    assert spans.idle_by_span(_window()) == pytest.approx({
        "outside": 19e-6, "ltjax_torch.k1.upload": 36e-6,
        "ltjax_torch.counts": 18e-6, "ltjax_torch.sort": 6e-6,
        "ltjax_torch.k1": 5e-6, "ltjax_torch.tables": 3e-6})


def test_a_lost_record_leaves_only_its_stretch_unmatched():
    """The tables' record is lost: the stretch before K1's launch (4
    launches, 3 records) is left out, the unsort after it is matched."""
    t = _window()
    t["device"] = t["device"][1:]
    assert spans.layer_device_ms(t, ("tables",)) == 0.0
    assert spans.layer_device_ms(t, ("sort", "unsort")) == pytest.approx(
        2e-3)
    assert [r[0] for r in spans.device_by_span(t)["ltjax_torch.k1"]] == [K1]


def test_the_accepted_readers_do_not_see_the_spans():
    """The spans are host records: the accepted readers of device time
    read the same values with and without them."""
    with_spans = _obs()
    without = copy.deepcopy(with_spans)
    without["trace"]["host"] = [h for h in without["trace"]["host"]
                                if not h[0].startswith("ltjax_torch")]
    for name in ("device_idle_pct", "stepper_device_ms_per_ext",
                 "k1_roofline_pct", "k1_staged_pct", "step_mfu"):
        read = lr.load_reader(ROOT, name)
        assert read(with_spans) == read(without), name
    # the unsort, cat and radix kernels, the memset and both copies: 9 us
    assert lr.load_reader(ROOT, "stepper_device_ms_per_ext")(
        with_spans) == pytest.approx(9e-3 / 2)


def _migration_window():
    """One migrate: its split kernels, the exchange (NCCL's kernels
    launched inside the collectives' host ranges, the counts' cat and
    their copy to the host), its merge kernels; then K1 outside it."""
    host = [
        ("ltjax_torch.chunk", 0.0, 100.0),
        ("ltjax_torch.migrate", 10.0, 60.0),
        ("cudaLaunchKernel", 11.0, 11.5),
        ("cudaLaunchKernel", 12.0, 12.5),
        ("ltjax_torch.exchange", 20.0, 50.0),
        ("nccl:all_to_all", 21.0, 25.0),
        ("cudaLaunchKernel", 22.0, 22.5),
        ("cudaLaunchKernel", 30.0, 30.5),
        ("cudaMemcpyAsync", 31.0, 40.0),
        ("nccl:all_to_all", 41.0, 45.0),
        ("cudaLaunchKernel", 42.0, 42.5),
        ("cudaLaunchKernel", 52.0, 52.5),
        ("cudaLaunchKernel", 53.0, 53.5),
        ("ltjax_torch.k1", 70.0, 80.0),
        ("cudaLaunchKernel", 71.0, 71.5),
    ]
    device = [
        ("void migrate_count_kernel<double>(Cols, int)", 13.0, 15.0),
        ("void migrate_scatter_kernel<double>(Cols, Cols)", 15.0, 20.0),
        ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
         23.0, 26.0),
        ("void at::native::cat_kernel", 31.0, 32.0),
        ("Memcpy DtoH (Device -> Pageable)", 38.0, 39.0),
        ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
         43.0, 47.0),
        ("void migrate_arrivals_kernel(unsigned int const*)", 54.0, 55.0),
        ("void migrate_fill_kernel<double>(Cols, int)", 55.0, 58.0),
        (K1, 72.0, 98.0),
    ]
    return {"host": host, "device": device, "span": [0.0, 130.0]}


def test_the_migration_reader_leaves_nccl_out():
    """migrate_device_ms_per_ext: the records under the migrate span and
    its exchange child, NCCL's kernels left out: [13, 20] + [31, 32] +
    [38, 39] + [54, 58] = 13 us over 2 external steps; None without the
    span (a program without it)."""
    read = lr.load_reader(ROOT, "migrate_device_ms_per_ext")
    t = _migration_window()
    assert read({"trace": t, "ext_steps": 2}) == pytest.approx(13e-3 / 2)
    t["host"] = [h for h in t["host"]
                 if h[0] not in ("ltjax_torch.migrate",
                                 "ltjax_torch.exchange")]
    assert read({"trace": t, "ext_steps": 2}) is None
    assert read({"trace": _window(), "ext_steps": 2}) is None
