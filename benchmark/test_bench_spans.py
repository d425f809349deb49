"""CPU tests of the metrics that read the program's spans (``spans.py``):
a traced run of a small dam and of a small P3M galaxy, each a cell of a
copy of the benchmark's files, as ``test_bench_harness.py`` builds
``dam_small.b3``.

    python -m pytest benchmark/test_bench_spans.py -q
"""
from __future__ import annotations

import collections
import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import spans
from benchmark.harness import run_cell
from benchmark.test_bench_harness import small_galaxy

HERE = Path(__file__).resolve().parent
DAM = ("fluid_host_ms", "kernel_call_host_ms", "cuda_mallocs_per_tick")
GALAXY = ("gravity_pp_ms", "gravity_mesh_ms")


def _cells(root: Path):
    """A BENCHMARK.json of two small cells, three traced blocks of 3 ticks
    and of 1 (n = 2 each side), and the five span metrics."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    for sub in ("configs", "traffic", "workloads"):
        (b / sub).mkdir(parents=True)
    dam = json.loads((HERE / "configs" / "dam_break_100k.json").read_text())
    dam["n_particles"] = 1200
    galaxy = small_galaxy(json.loads(
        (HERE / "configs" / "galaxy_1m.json").read_text()))
    (b / "configs" / "dam_small.json").write_text(json.dumps(dam))
    (b / "configs" / "galaxy_small.json").write_text(json.dumps(galaxy))
    (b / "traffic" / "blocks3.json").write_text(json.dumps(
        {"entry": "run_blocks", "ticks_per_block": 3}))
    (b / "traffic" / "blocks1.json").write_text(
        (HERE / "traffic" / "blocks1.json").read_text())
    for cell, base in (("dam_small.b3", "dam_100k.batch"),
                       ("galaxy_small.b1", "galaxy_1m.batch")):
        limits = json.loads((HERE / "workloads" / f"{base}.json")
                            .read_text())["limits"]
        (b / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"warm_blocks": 1, "check_blocks": 1, "trace_blocks": 2,
             "limits": {k: 1e9 for k in limits}}))
    cells = {"dam_small.b3": ("dam_small", "blocks3", DAM),
             "galaxy_small.b1": ("galaxy_small", "blocks1", GALAXY)}
    per_layer = []
    for m in bench["per_layer"]:
        for cell, (_, _, names) in cells.items():
            if m["name"] in names:
                per_layer.append(dict(m, workloads=[cell]))
    assert len(per_layer) == 5
    (root / "BENCHMARK.json").write_text(json.dumps(dict(
        bench, per_layer=per_layer,
        workloads=[{"name": c, "config": conf, "traffic": t, "chips": 1,
                    "why": "test"} for c, (conf, t, _) in cells.items()])))


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each cell's traced run: ``(its result line, the spans it
    recorded)``."""
    from lpe_tpu_torch.core.profiler import PROFILER
    root = tmp_path_factory.mktemp("bench")
    _cells(root)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        for cell in ("dam_small.b3", "galaxy_small.b1"):
            PROFILER.reset()
            res = run_cell(cell, 2**31 + 5, 0.1, True, device="cpu",
                           root=root)["result"]
            out[cell] = (res, PROFILER.spans())
    finally:
        torch.set_num_threads(n)
        PROFILER.reset()
    return out


def test_the_cpu_readable_span_metrics_read(traced):
    """The dam's host-time metrics read on the CPU; the galaxy's device
    time has no device operation to read there (None), but its traced
    blocks hold P3M's parts as spans under ``barnes_hut``."""
    dam, _ = traced["dam_small.b3"]
    galaxy, recorded = traced["galaxy_small.b1"]
    assert dam["correct"] and galaxy["correct"]
    got = {k: v["value"] for r in (dam, galaxy)
           for k, v in r["metrics"].items()}
    assert set(got) == {"fluid_host_ms", "kernel_call_host_ms"}
    for v in got.values():
        assert math.isfinite(v) and v > 0
    assert got["kernel_call_host_ms"] < got["fluid_host_ms"]
    assert dam["metrics"]["fluid_host_ms"]["unit"] == "ms/tick"
    paths = collections.Counter(s.path() for s in recorded)
    for part in ("mesh", "heavy", "pp"):
        assert paths[("run", "tick", "barnes_hut", f"barnes_hut.{part}")] == 5


def test_the_window_has_2n_plus_1_root_spans(traced):
    for cell, tpb in (("dam_small.b3", 3), ("galaxy_small.b1", 1)):
        _, recorded = traced[cell]
        roots = [s for s in recorded if s.parent is None]
        assert [s.name for s in roots] == ["run"] * 5
        assert sum(s.name == "tick" for s in recorded) == 5 * tpb


class _Trace:
    def __init__(self, ticks, ticks_per_block):
        self.ticks, self.ticks_per_block = ticks, ticks_per_block


def test_readers_find_nothing_without_the_right_root_spans(monkeypatch):
    """The readers read blocks 1 .. n of 2n + 1 root spans; another count,
    or a tracer without spans (a program before them), gives None; on the
    CPU the allocator counter is None."""
    from benchmark.metrics import (cuda_mallocs_per_tick, fluid_host_ms,
                                   gravity_pp_ms, kernel_call_host_ms)
    from lpe_tpu_torch.core import profiler
    from lpe_tpu_torch.core.profiler import HOST, PROFILER, ROOT

    def block():
        with PROFILER.scope("run", ROOT, "cpu"):
            with PROFILER.scope("tick", HOST):
                with PROFILER.scope("fluid"):
                    with PROFILER.scope("op.migrate", HOST):
                        pass
                with PROFILER.scope("barnes_hut"):
                    with PROFILER.scope("barnes_hut.pp"):
                        pass

    tr = _Trace(ticks=2, ticks_per_block=1)
    PROFILER.reset()
    try:
        with PROFILER.recording():
            for _ in range(5):
                block()
        got = spans.blocks(tr)
        assert got is not None and len(got) == 2 * 6
        assert [s for s in got if s.parent is None] == \
            [s for s in PROFILER.spans() if s.parent is None][1:3]
        for m in (fluid_host_ms, kernel_call_host_ms):
            assert m.read(tr) > 0
        assert cuda_mallocs_per_tick.read(tr) is None
        assert gravity_pp_ms.read(tr) is None      # no traced session
        with PROFILER.recording():
            block()
        for m in (fluid_host_ms, kernel_call_host_ms):
            assert m.read(tr) is None
        monkeypatch.setattr(profiler, "PROFILER", object())
        assert spans.blocks(_Trace(ticks=3, ticks_per_block=1)) is None
    finally:
        PROFILER.reset()


class _Event:
    """A host or device event of a torch.profiler session, as
    ``trace.reduce`` reads one."""

    def __init__(self, name, device, start, end, id=0):
        from torch.autograd.profiler_util import Interval
        self.name, self.device_type, self.id = name, device, id
        self.time_range = Interval(start, end)


class _Session:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_gravity_readers_take_device_time_from_the_trace():
    """``gravity_pp_ms`` and ``gravity_mesh_ms`` sum the device operations
    whose launch call the host made inside the span's range of the traced
    run's host+device session (the ``trace.Sessions`` that the harness
    holds while it calls the readers), not the span's interval."""
    from torch.autograd import DeviceType
    from benchmark.metrics import gravity_mesh_ms, gravity_pp_ms
    from benchmark.trace import BLOCK, WINDOW, Sessions
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    sessions = Sessions(2, cuda=True)
    sessions.full = _Session([
        _Event(WINDOW, cpu, 0, 1000), _Event(BLOCK, cpu, 0, 1000),
        _Event("barnes_hut.mesh", cpu, 100, 200),
        _Event("barnes_hut.pp", cpu, 300, 600),
        _Event("cudaLaunchKernel", cpu, 150, 155, id=1),
        _Event("cudaLaunchKernel", cpu, 400, 405, id=2),
        _Event("cudaLaunchKernel", cpu, 500, 505, id=3),
        _Event("cudaLaunchKernel", cpu, 700, 705, id=4),
        # the mesh's kernel runs late, after an idle wait of 400 us
        _Event("mesh_kernel", cuda, 560, 580, id=1),
        _Event("pp_kernel", cuda, 580, 630, id=2),
        _Event("pp_kernel", cuda, 630, 660, id=3),
        _Event("kick", cuda, 710, 800, id=4)])
    tr = _Trace(ticks=2, ticks_per_block=1)
    tr.block_inputs = sessions.block_inputs
    assert gravity_mesh_ms.read(tr) == pytest.approx(20 / 1e3 / 2)
    assert gravity_pp_ms.read(tr) == pytest.approx(80 / 1e3 / 2)
    # another run's trace, or a program without the span, reads nothing
    tr.block_inputs = []
    assert gravity_pp_ms.read(tr) is None
    tr.block_inputs = sessions.block_inputs
    sessions.full = _Session(sessions.full.events()[:2])
    assert gravity_pp_ms.read(tr) is None
