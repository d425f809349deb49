"""One run of one cell: set-up, the measured window, the output check.

``run_cell`` is the whole run but the look for a card (``run.py``); the
tests drive it on the CPU with small configurations. A run:

1. reads the cell's files by name (``load_cell``): the configuration,
   the traffic, the cell's settings (``DEFAULTS`` where its file is
   silent) and the metrics that apply;
2. makes the inputs from the seed (``scenes/<kind>.py``) and the port's
   scene and entry from them; runs ``warm_blocks`` blocks, the first from
   the seed's inputs (whose output the check holds against the reference:
   the start), which build and load every kernel the window runs;
3. measures for ``seconds``: blocks back to back, each ended by a
   synchronize on the host clock; with ``trace`` the first
   ``trace_blocks`` of them under torch.profiler;
4. keeps the input and output of ``check_blocks`` blocks of the window,
   drawn from the seed by reservoir sampling, and after the window (the
   peak memory read, the port's state freed) runs the plain reference
   (``reference/<kind>.py``) on each, in float64, and compares each
   number with its limit; with ``control`` it judges the reference in
   bfloat16, put in the program's place, by the same limits.

The one traffic loop (entry ``run_blocks``) calls ``build_run_fn(spec,
cfg, ticks=ticks_per_block)`` once a block. A metric's reader is the
module of the part of its name before the first dot, so that one
quantity can be reported under a name for each group of cells
(``ticks_per_s.host_paced``, ``ticks_per_s.device_bound``).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import random
import statistics
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lpe_tpu")
NOT_A_NUMBER = 1e300       # a gap that is not finite reads as this
# a cell's settings where ``workloads/<cell>.json`` does not give them:
# blocks run in set-up, window blocks checked, blocks a traced run profiles
DEFAULTS = dict(warm_blocks=2, check_blocks=3, trace_blocks=5)
# the program's ``record_function`` ranges whose device time is kept
RANGES = ("fluid", "boundary", "gravity", "rigid", "barnes_hut", "movement")


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its files: ``config``,
    ``traffic``, ``settings`` (``workloads/<name>.json``), and the
    end-to-end and per-layer metrics that it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; the cells are "
                         f"{', '.join(cells)}")
    cell = cells[name]
    here = root / "benchmark"

    def applies(m):
        return name in m.get("workloads", [name])

    return dict(
        cell=cell,
        config=json.loads((here / "configs" / f"{cell['config']}.json")
                          .read_text()),
        traffic=json.loads((here / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        settings={**DEFAULTS, **json.loads(
            (here / "workloads" / f"{name}.json").read_text())},
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: ``lpe_tpu_torch`` is not ``lpe_tpu``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _entry(traffic, spec, cfg, device):
    """The block function of the traffic's entry."""
    if traffic["entry"] != "run_blocks":
        raise ValueError(f"unknown traffic entry {traffic['entry']!r}")
    from lpe_tpu_torch.systems import build_run_fn
    return build_run_fn(spec, cfg, ticks=traffic["ticks_per_block"],
                        device=device), list(traffic.get("ranges", RANGES))


@contextlib.contextmanager
def _nothing():
    yield


def _quantile(values, q):
    """The q-quantile (0..1) by linear interpolation between order
    statistics (numpy's default)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=1000, method="inclusive")[
        round(q * 1000) - 1]


def base_name(metric: str) -> str:
    """The quantity a metric's name reports: the part before the first
    dot, which names its reader (``metrics/<base>.py``)."""
    return metric.split(".")[0]


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, check lines): every number within its limit, and no
    number without one."""
    check = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = set(readings) == set(limits) and all(
        c["value"] <= c["limit"] for c in check.values())
    return ok, check


def run_cell(name, seed, seconds, trace, *, device="cuda", t0=None,
             root: Path = ROOT, conf_override=None, fault=None,
             control=False) -> dict:
    """One run; returns the result line's fields and the ``check`` lines.
    ``conf_override`` (tests) updates the configuration; ``fault`` (tests)
    wraps the block function of the timed path; ``control`` also judges
    the control, the reference in bfloat16 in the program's place, on the
    same checked blocks and by the same limits (``control_correct``,
    ``control``; ``calibrate.py`` and the tests)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(name, root)
    conf, traffic, settings = cell["config"], cell["traffic"], \
        cell["settings"]
    if conf_override:
        conf = conf_override(conf)
    kind = conf["kind"]
    scene = importlib.import_module(f"benchmark.scenes.{kind}")
    ref = importlib.import_module(f"benchmark.reference.{kind}")
    inputs = scene.make_inputs(conf, seed)
    spec, cfg, state = scene.to_program(conf, inputs, device)
    block, ranges = _entry(traffic, spec, cfg, device)
    if fault is not None:
        block = fault(block, spec)
    tpb = traffic["ticks_per_block"]

    # set-up: the first block from the seed's inputs, then the rest of the
    # warm-up; every shape of the window is built and loaded here
    start_in = scene.observe(spec, state)
    state = block(state)
    _sync(device)
    start_out = scene.observe(spec, state)
    for _ in range(settings["warm_blocks"] - 1):
        state = block(state)
    _sync(device)
    setup_s = time.perf_counter() - t0

    # the window; a traced run profiles its first blocks (``trace.
    # Sessions``) and measures the rest as an untraced run does
    rng = random.Random(seed)
    k = settings["check_blocks"]
    kept = []                  # (block index, input, output)
    times = []
    sessions = None
    if trace:
        from benchmark.trace import Sessions
        sessions = Sessions(settings["trace_blocks"],
                            torch.device(device).type == "cuda")
    w_start = time.perf_counter()
    i = 0
    while True:
        if i < k:
            slot = i
        else:
            j = rng.randrange(i + 1)
            slot = j if j < k else None
        traced = sessions is not None and sessions.open(i)
        obs_in = scene.observe(spec, state) \
            if slot is not None or traced else None
        with sessions.block(i, obs_in) if traced else _nothing():
            tb = time.perf_counter()
            state = block(state)
            _sync(device)
            te = time.perf_counter()
        if traced:
            sessions.close(i)
        times.append(te - tb)
        if slot is not None:
            entry = (i, obs_in, scene.observe(spec, state))
            if slot < len(kept):
                kept[slot] = entry
            else:
                kept.append(entry)
        i += 1
        if te - w_start >= seconds and (sessions is None
                                         or sessions.done(i)):
            break
    wall = te - w_start
    n_blocks = i
    peak = 0
    if torch.device(device).type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(torch.cuda.device_count()))

    metrics = {}
    tr = None
    if trace:
        from benchmark import trace as T
        tr = sessions.reduce(ticks_per_block=tpb, range_names=ranges,
                             port_kernels=T.port_kernel_names(root))
        tr.conf, tr.inputs = conf, inputs
        for m in cell["per_layer"]:
            mod = importlib.import_module(
                f"benchmark.metrics.{base_name(m['name'])}")
            v = mod.read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        sessions = None
    else:
        e2e = dict(
            ticks_per_s=n_blocks * tpb / wall,
            block_ms_p95=1e3 * _quantile(sorted(times), 0.95),
            setup_s=setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": float(e2e[base_name(m["name"])]),
                                  "unit": m["unit"]}

    # the output check, after the window; the port's state is freed first
    del state, block
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    readings, ctl = {}, {}

    def read(into, prefix, ins, outs, r):
        for key, v in ref.gaps(conf, ins, outs, r).items():
            v = v if math.isfinite(v) else NOT_A_NUMBER
            into[prefix + key] = max(into.get(prefix + key, 0.0), v)
        bad = sum(int((~torch.isfinite(v)).sum()) for v in outs.values()
                  if isinstance(v, torch.Tensor) and v.is_floating_point())
        into["nonfinite"] = into.get("nonfinite", 0) + bad

    for prefix, ins, outs in [("start_", start_in, start_out)] + [
            ("", a, b) for _, a, b in kept]:
        r = ref.advance(conf, inputs, ins, tpb)
        read(readings, prefix, ins, outs, r)
        if control:
            low = ref.advance(conf, inputs, ins, tpb, dtype=torch.bfloat16)
            read(ctl, prefix, ins, low, r)
    limits = settings["limits"]
    correct, check = judge(readings, limits)
    dev = torch.device(device)
    result = {
        "correct": bool(correct), "attempted": n_blocks,
        "failed": 0 if readings.get("nonfinite", 0) == 0 else 1,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": int(cell["cell"]["chips"]),
                   "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown
    result["check"] = check
    return dict(result=result, readings=readings, control=ctl,
                control_correct=judge(ctl, limits)[0] if control else None,
                block_times=times, checked_blocks=[i for i, _, _ in kept])
