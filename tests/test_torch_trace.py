"""The port's spans (``ltjax_torch.trace``) on the CPU.

* Under ``torch.profiler`` one fused chunk records, on each route (the
  plain versions of ext_step and per_step, the packed and native
  routes' ops), one ``chunk`` span; a ``k1`` span per external step (or
  a ``k2`` and a ``k3`` per internal step); a ``sort`` per
  ``ext_sort_every`` external steps, rounded up; one ``unsort``; the
  route's ``tables`` (the window's packed records, and each internal
  step's stage and aux tables where PyTorch ops build them: the
  per-step and packed routes and K1's plain version; none on the native
  route); each inside the chunk.  ``summary_counts`` is a
  ``counts`` span.
* The spans are host records, not user annotations (which the profiler
  also draws on the device's timeline), and no name holds a kernel's
  device-function name.
* Without a profiler no span is entered; the particles are bit-identical
  with and without one.
* ``reset_counters`` zeroes the wrappers' launch counts (K1, K2, K3, the
  sort key and the migration).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ltjax_torch import state as tst
from ltjax_torch import step as tstep
from ltjax_torch import synth, trace
from ltjax_torch.config import Config
from ltjax_torch.kernels import ext_step as kx
from ltjax_torch.kernels import migrate as km
from ltjax_torch.kernels import rk4_step as kr
from ltjax_torch.kernels import sort_key as sk
from ltjax_torch.kernels import step_lanes as sl
from ltjax_torch.physics import boundary as bd

torch.set_num_threads(1)

E, N_INT, SORT_EVERY = 3, 4, 2
ROUTES = {
    "ext_step": dict(HTurbOn=True, ConstantHTurb=1.0),
    "per_step": dict(Behavior=6, sink=1e-3, mortality=True,
                     stochastic_mortality=True, deadage=5400.0),
    "packed": dict(kernel_interp=False, HTurbOn=True, ConstantHTurb=1.0),
    "native": dict(fast_interp=False),
}
KERNELS = ("ext_step_kernel", "rk4_step_kernel", "step_lanes_kernel")


def _case(route, n=200):
    c = synth.make_solid_body_case(nx=15, ny=15, us=4, lx=14e3, ly=14e3,
                                   h0=30.0, omega=2e-4, shear_a=0.02,
                                   dtype=torch.float64)
    g = c.grid
    ctx = tstep.StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.numpy(), g.x_rho.numpy(), g.y_rho.numpy()))
    cfg = Config(numpar=n, dt=1800, idt=1800 // N_INT, us=4, ws=5,
                 OpenOceanBoundary=True, ext_sort_every=SORT_EVERY, seed=3,
                 **ROUTES[route])
    assert tstep.mode_flags(ctx, cfg) == route
    fsR = synth.fieldset_window(c, -900.0, 1800.0, E + 2,
                                dtype=torch.float64)
    rng = np.random.default_rng(8)
    p0 = tst.init_particles(rng.uniform(2e3, 12e3, n),
                            rng.uniform(2e3, 12e3, n),
                            rng.uniform(-29.0, -1.0, n),
                            dob=rng.choice([0.0, 2000.0], n))
    return tstep.make_fused_external_steps(ctx, cfg, E), fsR, p0


def _chunk(route):
    fused, fsR, p0 = _case(route)
    p = fused(p0, fsR, 0.0, 1)
    tstep.summary_counts(p)
    return p


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end, e)
            for e in prof.events() if e.name.startswith("ltjax_torch.")]


def _want(route):
    steps = E * N_INT
    # K1's plain version builds each internal step's stage tables
    tables = {"ext_step": 1 + steps, "per_step": 1 + 2 * steps,
              "packed": 1 + steps, "native": 0}[route]
    want = {"chunk": 1, "sort": -(-E // SORT_EVERY), "unsort": 1,
            "counts": 1}
    if tables:
        want["tables"] = tables
    if route == "ext_step":
        want["k1"] = E
    if route == "per_step":
        want["k2"] = want["k3"] = steps
    return want


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_chunk_records_its_spans(route):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _chunk(route)
    spans = _spans(prof)
    got = {}
    for name, _, _, _ in spans:
        layer = name[len("ltjax_torch."):]
        got[layer] = got.get(layer, 0) + 1
    assert got == _want(route)
    (c0, c1), = [(s, e) for name, s, e, _ in spans
                 if name == "ltjax_torch.chunk"]
    for name, s, e, ev in spans:
        if name not in ("ltjax_torch.chunk", "ltjax_torch.counts"):
            assert c0 <= s <= e <= c1, name
        assert not ev.is_user_annotation, name
        assert not any(k in name for k in KERNELS)
    (cnt,) = [s for name, s, _, _ in spans if name == "ltjax_torch.counts"]
    assert cnt >= c1


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_profiler_leaves_the_particles_bit_identical(route):
    off = _chunk(route)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _chunk(route)
    for k in tst.FIELDS:
        assert torch.equal(getattr(on, k), getattr(off, k)), k
    assert (off.status == tst.ACTIVE).sum() > 10


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    entered = []

    def record(name):
        entered.append(name)
        return trace._OFF

    monkeypatch.setattr(trace, "_record", record)
    _chunk("per_step")
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _chunk("per_step")
    assert "ltjax_torch.chunk" in entered and "ltjax_torch.k3" in entered


def test_the_wrappers_keep_their_counters():
    """The spans wrap the kernel wrappers; ltbench and the CLI read the
    launch counts on the wrappers themselves."""
    for fn in (kx.ext_step_fused, kr.rk4_displacement_fused,
               sl.step_lanes_fused):
        assert fn.__wrapped__.__name__ == fn.__name__
        assert "launches" in vars(fn) and "variant_launches" in vars(fn)


def test_reset_counters_zeroes_every_wrapper():
    for fn in (kx.ext_step_fused, kr.rk4_displacement_fused,
               sl.step_lanes_fused):
        fn.launches = 7
        fn.variant_launches = {"x": 7}
    sk.sort_key.launches = 7
    km.migrate.launches = 7
    trace.reset_counters()
    for fn in (kx.ext_step_fused, kr.rk4_displacement_fused,
               sl.step_lanes_fused):
        assert fn.launches == 0 and fn.variant_launches == {}
    assert sk.sort_key.launches == 0 and km.migrate.launches == 0
    assert kx.counts() == dict.fromkeys(kx.COUNTERS, 0)
    assert kx.COUNTERS[-1] == "active_steps"


def test_the_tiled_steps_record_their_spans():
    """shard.make_tiled_steps (one tile) sorts and unsorts every
    external step inside its chunk."""
    from ltjax_torch import shard
    _, fsR, p0 = _case("ext_step")
    c = synth.make_solid_body_case(nx=15, ny=15, us=4, lx=14e3, ly=14e3,
                                   h0=30.0, omega=2e-4,
                                   dtype=torch.float64)
    g = c.grid
    tctx = tstep.StepContext(grid=g, bounds=bd.build_boundaries(
        g.mask_rho.numpy(), g.x_rho.numpy(), g.y_rho.numpy()))
    cfg = Config(numpar=p0.n, dt=1800, idt=450, us=4, ws=5,
                 OpenOceanBoundary=True)
    spec = shard.make_spec(cfg, g.ny, p0.n, 1, 1)
    steps = shard.make_tiled_steps(tctx, cfg, spec, 0,
                                   np.array([-np.inf, np.inf]), E)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps(p0, fsR, 0.0, 0)
    names = [e.name for e in prof.events()
             if e.name.startswith("ltjax_torch.")]
    assert {k: names.count("ltjax_torch." + k) for k in (
        "chunk", "tables", "sort", "unsort", "k1")} == {
        "chunk": 1, "tables": 1 + E * 4, "sort": E, "unsort": E, "k1": E}


def test_the_off_path_is_the_shared_no_op():
    assert trace.span("ltjax_torch.x") is trace.span("ltjax_torch.y")
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("ltjax_torch.x") is not trace._OFF
