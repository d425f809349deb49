"""CPU tests of the benchmark's harness: files found by name, the result
line's keys, the imports, and the yardstick's counts.

    python -m pytest benchmark -q

Runs on the CPU at small sizes (the port's kernels take their plain
versions there); nothing here needs the card.
"""
from __future__ import annotations

import ast
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import bounds
from benchmark.harness import FORBIDDEN, forbidden_modules, run_cell

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def small_dam(conf, n=1500):
    conf = json.loads(json.dumps(conf))
    conf["n_particles"] = n
    return conf


def small_galaxy(conf, n=3000):
    """P3M at a few thousand bodies: a lower direct-sum threshold, a
    64-cell mesh, and the disk's bodies heavier by the cut in their count,
    so that the disk weighs what it does at the configuration's size."""
    conf = json.loads(json.dumps(conf))
    k = conf["particle_count"] / n
    conf["particle_count"] = n
    conf["barnes_hut"].update(direct_sum_max_bodies=1000, pm_grid=64)
    for key in ("particle_mass_mean", "particle_mass_std_dev"):
        conf["disk"][key] *= k
    return conf


def _imports(path: Path) -> set:
    """Top-level names of the modules that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    """Compared by whole top-level names: ``lpe_tpu_torch`` is allowed,
    ``lpe_tpu`` is not."""
    for path in HERE.rglob("*.py"):
        bad = _imports(path) & set(FORBIDDEN)
        assert not bad, f"{path.name} imports {bad}"
    assert forbidden_modules(["lpe_tpu_torch", "lpe_tpu_torch.ops"]) == []
    assert forbidden_modules(["lpe_tpu.ops.pallas_sph", "jax.numpy",
                              "lpe_tpu_torch"]) == ["jax", "lpe_tpu"]


def test_the_references_import_nothing_of_the_port():
    refs = sorted((HERE / "reference").glob("*.py"))
    assert len(refs) >= 2
    for path in refs:
        names = _imports(path)
        assert "lpe_tpu_torch" not in names and not names & set(FORBIDDEN), \
            f"{path.name} imports {names}"


def test_the_harness_reads_neither_bench_py_nor_bench_files():
    for path in HERE.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        assert "bench.py" not in text and "BENCH_r" not in text, path.name


def test_result_line_has_exactly_the_contract_keys():
    out = run_cell("galaxy_1m.batch", 2**31 + 77, 0.3, False, device="cpu",
                   conf_override=small_galaxy)
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert set(res["metrics"]) == {"ticks_per_s.device_bound",
                                   "block_ms_p95.device_bound", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["correct"] is True and res["attempted"] >= 1
    for c in res["check"].values():
        assert set(c) == {"value", "limit"}
    traced = run_cell("galaxy_1m.batch", 5, 0.3, True, device="cpu",
                      conf_override=small_galaxy)["result"]
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(traced["breakdown"]["idle_gaps"]) <= 10


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "dam_100k.batch", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_a_module_of_jax_loaded_after_the_window(
        monkeypatch, capsys):
    """run.py reads ``sys.modules`` after the run has read its metrics and
    run the reference, just before it would print: a module of JAX or of
    the JAX package that any of them loaded refuses the result."""
    import types

    import benchmark.harness as harness
    from benchmark import run

    def run_cell(*args, **kw):
        monkeypatch.setitem(sys.modules, "lpe_tpu",
                            types.ModuleType("lpe_tpu"))
        return {"result": {"correct": True, "check": {}}}
    monkeypatch.setattr(harness, "run_cell", run_cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    code = run.main(["--workload", "dam_100k.batch", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out.strip() == ""
    assert "lpe_tpu" in out.err


NEW_CONFIG = {"kind": "dam_break", "n_particles": 1200}
NEW_METRIC = '''"""traced_ticks (ticks): the ticks of the traced window."""


def read(tr):
    return float(tr.ticks) if tr.ticks else None
'''


def test_a_new_config_traffic_cell_and_metric_are_files_alone(tmp_path):
    """A copy of the benchmark with one configuration, one traffic mix,
    one cell and one per-layer metric added as new files (and named in
    BENCHMARK.json) runs the new cell, whose result line carries the new
    metric."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((HERE / "configs" / "dam_break_100k.json").read_text())
    conf.update(NEW_CONFIG)
    b = tmp_path / "benchmark"
    (b / "configs" / "dam_small.json").write_text(json.dumps(conf))
    (b / "traffic" / "blocks3.json").write_text(json.dumps(
        {"entry": "run_blocks", "ticks_per_block": 3, "ranges": ["fluid"]}))
    limits = json.loads((HERE / "workloads" / "dam_100k.batch.json")
                        .read_text())["limits"]
    (b / "workloads" / "dam_small.b3.json").write_text(json.dumps(
        {"warm_blocks": 1, "check_blocks": 1, "trace_blocks": 1,
         "limits": {k: 1e9 for k in limits}}))
    (b / "metrics" / "traced_ticks.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "dam_small", "source": "test",
                             "file": "benchmark/configs/dam_small.json",
                             "reduced": ["n_particles"], "why": "test"})
    bench["workloads"].append({"name": "dam_small.b3", "config": "dam_small",
                               "traffic": "blocks3", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "ticks_per_s.host_paced":
            m["workloads"].append("dam_small.b3")
    bench["per_layer"].append({"name": "traced_ticks", "unit": "ticks",
                               "better": "higher", "source": "device_trace",
                               "layer": "test",
                               "moves": "ticks_per_s.host_paced",
                               "workloads": ["dam_small.b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, torch; torch.set_num_threads(2); "
            "from benchmark.harness import run_cell; "
            "o = run_cell('dam_small.b3', 3, 0.1, True, device='cpu'); "
            "print(json.dumps(o['result']))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["metrics"] == {"traced_ticks": {"value": 3.0,
                                               "unit": "ticks"}}
    assert res["correct"] is True


def test_sph_counts_by_hand_on_a_small_grid():
    """Three particles in one cell and one in the cell to its right, on a
    0.2 m universe of 0.05 m cells (nx = 8 with the apron, 32 padded
    columns, 10 padded rows), K = 4, the walls far away."""
    conf = json.loads((HERE / "configs" / "dam_break_100k.json").read_text())
    conf["n_particles"] = 4
    pos = torch.tensor([[0.06, 0.06], [0.07, 0.06], [0.06, 0.07],
                        [0.11, 0.06]], dtype=torch.float64)
    boxes = torch.tensor([[5.0, 5.0, 6.0, 6.0]], dtype=torch.float64)
    work = bounds.sph_launch_work(conf, 0.2, pos, boxes, 4)
    row = 4 * 32 * 4                      # K * W * float32
    grid = 10 * row
    inner = 8 * row
    assert work["migrate_kernel"] == (grid + 8 * 4 * 4 + 9 * grid, 20 * 4)
    # pairs: 3 * (3 + 1) + 1 * (1 + 3), self pairs included
    assert work["sweep_kernel"] == (grid + 5 * 4 * 4 + 3 * inner, 60 * 16)
    # no cell couples: S = 8, Wp = 24, NB = 1, one big solid
    c9 = (10 * 7 * row + 3 * inner + 10 * 32 * 4 + 9 * grid
          + 10 * 3 * 8 * 32 * 4 + 10 * 1 * 3 * 1 * 4)
    assert work["coupling9_kernel"] == (c9, 0)
    # the box moved over the particles' cells: 2 cells, 4 particles couple
    near = torch.tensor([[0.05, 0.05, 0.12, 0.08]], dtype=torch.float64)
    w2 = bounds.sph_launch_work(conf, 0.2, pos, near, 4)
    assert w2["coupling9_kernel"] == (c9 + 2 * 8 * 24 * 4 + 2 * 24 * 4,
                                      4 * 1 * (25 * 4 + 60))
    assert bounds.bound_s(3.35e12, 0) == 1.0
    assert bounds.bound_s(0, 67e12) == 1.0


def test_pp_pair_count_equals_brute_force():
    conf = small_galaxy(json.loads(
        (HERE / "configs" / "galaxy_1m.json").read_text()), 3000)
    size = 6e9
    rng = np.random.default_rng(4)
    # a clustered disk so that some cells pass K
    r = rng.uniform(0.1, 1.0, 3000) ** 2 * 2.5e9
    a = rng.uniform(0, 2 * math.pi, 3000)
    pos = np.stack([3e9 + r * np.cos(a), 3e9 + r * np.sin(a)], -1)
    pos[:5] = [-1.0, 7e9]               # off the grid: never resident
    width, nc, m, K, rc = bounds.pp_grid(conf, size, 3072)
    cid = np.where((pos >= 0).all(1) & (pos < nc * width).all(1),
                   np.floor(pos[:, 1] / width) * nc
                   + np.floor(pos[:, 0] / width), -1).astype(int)
    seen = {}
    res = np.zeros(len(pos), bool)
    for i, c in enumerate(cid):          # the first K of a cell by index
        if c >= 0 and seen.get(c, 0) < K:
            res[i] = True
            seen[c] = seen.get(c, 0) + 1
    assert max(np.bincount(cid[cid >= 0])) > K     # some cell overflows
    p = pos[res]
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    brute = int((d2 < rc * rc).sum()) - len(p)
    got = bounds.pp_pairs(torch.from_numpy(pos), conf, size, 3072)
    assert got == brute and brute > 0
