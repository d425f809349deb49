"""The port's tracer (``lpe_tpu_torch/core/profiler.py``) on the CPU: off by
default, the span tree of a dam block and of a P3M tick under
torch.profiler, the clock it shares with the trace, and its report."""
from __future__ import annotations

import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lpe_tpu_torch.core import profiler as P
from lpe_tpu_torch.core.profiler import HOST, PROFILER, ROOT
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SYSTEMS = ["fluid", "boundary", "gravity", "rigid", "rotation", "movement",
           "sleep"]


@pytest.fixture(autouse=True)
def fresh_tracer():
    PROFILER.reset()
    yield
    PROFILER.reset()


def _dam():
    """A 400-particle dam whose 2-tick block keeps its grid resident."""
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    from lpe_tpu_torch.systems import build_run_fn
    sc = build_dam_break(400, device="cpu")
    cfg = sc.cfg.replace(fluid=dataclasses.replace(
        sc.cfg.fluid, cross_tick_residency="on"))
    return sc, build_run_fn(sc.spec, cfg, ticks=2, device="cpu")


def _kineto(prof):
    """(name, start ns, end ns) of the trace's host events."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def _children(spans, parent):
    return [s.name for s in spans if s.parent is parent]


def test_tracing_off_records_nothing_and_enters_no_range(monkeypatch):
    entered = collections.Counter()
    rf, ev = torch.profiler.record_function, torch.cuda.Event

    def counted(real, key):
        def make(*a, **kw):
            entered[key] += 1
            return real(*a, **kw)
        return make

    monkeypatch.setattr(torch.profiler, "record_function",
                        counted(rf, "record_function"))
    monkeypatch.setattr(torch.cuda, "Event", counted(ev, "event"))
    sc, run = _dam()
    run(sc.state)
    assert PROFILER.spans() == [] and not entered
    assert PROFILER.scope("fluid") is PROFILER.scope("op.migrate", HOST)
    # on, the same block enters the ranges it mirrors
    with profile(activities=[ProfilerActivity.CPU]):
        run(sc.state)
    assert entered["record_function"] > 0 and PROFILER.spans()


def test_a_dam_block_gives_the_span_tree():
    from lpe_tpu_torch.ops import sph_kernels as K
    sc, run = _dam()
    ops = (K.migrate, K.pair_sweep, K.coupling9)
    before = [op.plain_calls for op in ops]
    with profile(activities=[ProfilerActivity.CPU]):
        run(sc.state)
    spans = PROFILER.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["run"]
    assert _children(spans, roots[0]) == ["fluid.grid_build", "tick", "tick",
                                          "fluid.readback"]
    for tick in (s for s in spans if s.name == "tick"):
        assert _children(spans, tick) == SYSTEMS + ["tick.advance"]
    calls = [s for s in spans if s.name.startswith("op.")]
    steps = sc.cfg.fluid.num_sub_steps
    assert len(calls) == steps * 3 * 2
    assert len(calls) == sum(op.plain_calls for op in ops) - sum(before)
    assert {s.parent.name for s in calls} == {"fluid"}
    assert collections.Counter(s.name for s in calls) == {
        "op.migrate": 2 * steps, "op.pair_sweep": 2 * steps,
        "op.coupling9": 2 * steps}
    # kinds: a layer span has device ms (its host interval on the CPU),
    # a tick and a kernel call host time alone, the root no counter here
    for s in spans:
        assert s.t0 <= s.t1
        layer = s.name not in ("run", "tick") and not s.name.startswith("op.")
        assert (s.device_ms is not None) == layer
        assert s.mallocs is None


def test_every_host_op_of_a_block_lies_in_a_mirrored_span():
    sc, run = _dam()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(sc.state)
    layers = [(s.t0, s.t1) for s in PROFILER.spans()
              if s.device_ms is not None]
    aten = [e for e in _kineto(prof) if e[0].startswith("aten::")]
    assert len(aten) > 100
    outside = [e for e in aten
               if not any(a <= e[1] and e[2] <= b for a, b in layers)]
    assert outside == []


def test_spans_and_the_trace_share_one_clock():
    """Each mirrored range of the trace lies within its span's host
    interval, on time.time_ns()'s clock, to 50 us."""
    sc, run = _dam()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(sc.state)
    spans = [s for s in PROFILER.spans() if s.device_ms is not None]
    names = {s.name for s in spans}
    events = [e for e in _kineto(prof) if e[0] in names]
    assert len(events) == len(spans) == 2 + 2 * (len(SYSTEMS) + 1)
    tol = 50_000
    for name in names:
        mine = sorted((s.t0, s.t1) for s in spans if s.name == name)
        theirs = sorted((a, b) for n, a, b in events if n == name)
        assert len(mine) == len(theirs)
        for (t0, t1), (a, b) in zip(mine, theirs):
            assert t0 - tol <= a <= b <= t1 + tol, (name, t0, a, b, t1)


def test_p3m_parts_are_spans_and_leave_the_bits():
    import numpy as np
    from lpe_tpu_torch.core.config import (BarnesHutConfig,
                                           ScenarioSystemConfig,
                                           SharedSystemConfig)
    from lpe_tpu_torch.core.constants import REAL_G
    from lpe_tpu_torch.scene import SceneBuilder
    from lpe_tpu_torch.systems import build_run_fn
    rng = np.random.default_rng(0)
    cfg = ScenarioSystemConfig(
        shared=SharedSystemConfig(universe_size_m=1e10,
                                  gravitational_softener=1e6),
        barnes_hut=BarnesHutConfig(direct_sum_max_bodies=1, pm_grid=64,
                                   heavy_threshold=1e24))
    b = SceneBuilder("p3m")
    for i, (x, y) in enumerate(rng.uniform(2e9, 8e9, (300, 2))):
        b.add(pos=(float(x), float(y)), mass=1e26 if i == 0 else 1e20)
    sc = b.finalize(cfg, device="cpu")
    run = build_run_fn(sc.spec, sc.cfg, ticks=1, device="cpu")
    plain = run(sc.state)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run(sc.state)
    for a, c in ((plain.bodies.pos, traced.bodies.pos),
                 (plain.bodies.vel, traced.bodies.vel)):
        assert torch.equal(a, c)
    paths = {s.path() for s in PROFILER.spans()}
    for part in ("mesh", "heavy", "pp"):
        assert ("run", "tick", "barnes_hut", f"barnes_hut.{part}") in paths
    # the sum in its one order: mesh + heavy, then + PP
    step = run.systems["barnes_hut"]
    bodies = sc.state.bodies
    src, rcv = step.masks(bodies)
    heavy = src & (bodies.mass >= cfg.barnes_hut.heavy_threshold)
    assert int(heavy.sum()) == 1
    mm = torch.where(src & ~heavy, bodies.mass, torch.zeros_like(bodies.mass))
    acc = step.pm(bodies.pos, mm) + step.heavy_direct(bodies.pos, bodies.mass,
                                                      heavy)
    acc = REAL_G * (acc + step.pp(bodies.pos, mm)) * rcv[:, None].to(acc.dtype)
    dt = cfg.shared.seconds_per_tick * sc.state.base_time_accel * \
        sc.state.time_scale
    with profile(activities=[ProfilerActivity.CPU]):
        kicked = step(sc.state).bodies.vel
    assert torch.equal(kicked, bodies.vel + acc * dt)


class _Event:
    """A stand-in for torch.cuda.Event, counted in ``made``."""

    made = 0

    def __init__(self, **kw):
        type(self).made += 1

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.5


def test_cuda_events_only_for_the_operator_and_only_on_cuda(monkeypatch):
    """On CUDA a layer span records its CUDA events when the operator asks
    (``recording()``), not while a torch.profiler session alone records,
    whose trace holds the device time; a span given no device and opened
    under no span is on the CPU, even with CUDA initialised."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(P, "_segments", lambda device: 0)
    _Event.made = 0

    def block():
        with PROFILER.scope("run", ROOT, "cuda"):
            with PROFILER.scope("fluid"):
                pass
        with PROFILER.scope("render"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        block()
    fluid, render = (s for s in PROFILER.spans() if s.name != "run")
    assert _Event.made == 0 and fluid.cuda and fluid.device_ms is None
    assert not render.cuda and render.device_ms is not None
    PROFILER.reset()
    with PROFILER.recording():
        block()
    fluid, render = (s for s in PROFILER.spans() if s.name != "run")
    assert _Event.made == 2 and fluid.device_ms == 2.5
    assert not render.cuda


class _Clock:
    """time.time_ns() that returns the given milliseconds in turn."""

    def __init__(self, ms):
        self.ns = iter(int(t * 1e6) for t in ms)

    def time_ns(self):
        return next(self.ns)


def test_report_self_time_is_the_duration_less_the_children(monkeypatch):
    # reset at 0; run 0-100 ms, its ticks 10-30 and 40-50; ``a`` 12-20
    # inside the first; the report's clock 200
    monkeypatch.setattr(P, "time", _Clock([0, 0, 10, 12, 20, 30, 40, 50,
                                           100, 200]))
    PROFILER.reset()
    with PROFILER.recording():
        with PROFILER.scope("run", ROOT, "cpu"):
            with PROFILER.scope("tick", HOST):
                with PROFILER.scope("a"):
                    pass
            with PROFILER.scope("tick", HOST):
                pass
    lines = PROFILER.report().splitlines()
    assert lines[1].startswith("run: 100.0ms (50.0%) calls=1 self=70.0ms")
    assert lines[2].startswith("  tick: 30.0ms (15.0%) calls=2 self=22.0ms "
                               "min=10.00 max=20.00")
    assert lines[3] == ("    a: 8.0ms (4.0%) calls=1 self=8.0ms min=8.00 "
                        "max=8.00 device=8.0ms")
    assert P._union_ms([(0, 10_000_000), (5_000_000, 20_000_000),
                        (30_000_000, 40_000_000)]) == pytest.approx(30.0)


def test_records_fold_into_the_tree_past_the_cap(monkeypatch):
    monkeypatch.setattr(P, "CAP", 10)
    with PROFILER.recording():
        for _ in range(7):
            with PROFILER.scope("run", ROOT, "cpu"):
                for _ in range(2):
                    with PROFILER.scope("tick", HOST):
                        pass
    assert PROFILER.scope("x") is P._OFF
    assert len(PROFILER.spans()) <= 10 + 3
    report = PROFILER.report()
    assert "run: " in report and " calls=7 " in report
    assert "  tick: " in report and " calls=14 " in report
    # a root opens only where no span is open: a tick function called
    # inside a block nests its tick there
    with PROFILER.recording(), PROFILER.scope("run", ROOT, "cpu"):
        assert PROFILER.scope("run", ROOT, "cpu") is P._OFF


def test_cli_profile_prints_the_span_tree(capsys):
    from lpe_tpu_torch.app.cli import main
    main(["run", "--device", "cpu", "--scenario", "SIMPLE_FLUID", "--ticks",
          "2", "--profile"])
    out = capsys.readouterr().out
    assert out.startswith("Profiler report")
    for line in ("run: ", "  tick: ", "    fluid: ", "      op.migrate: ",
                 "    tick.advance: "):
        assert f"\n{line}" in out, out
    assert " device=" in out and not PROFILER.on
