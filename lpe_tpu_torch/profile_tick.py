"""Time and profile the port's tick on one CUDA card.

    python3 -m lpe_tpu_torch.profile_tick [SCENE ...]

SCENE is any of dam, dam_split, dam_scatter, dam_mixed_h, dam_bands2,
dam_bands4, simple_fluid, rigid, rigid_bands2, rigid_bands4, coupled,
coupled_shards4, highlight, north, north_bands4, keplerian, ocean,
galaxy_direct, galaxy_direct_shards4, galaxy, galaxy_shards4 (all by
default).

A block is 10 ticks: one ``build_run_fn(ticks=10)`` call for DAM_BREAK
100k (the grid stays resident across the block), RIGID_STACKS 10k (the
bench's rigid config), the coupled dam (100k particles + 300 pentagons),
the highlight reel (20k particles, 60 circles and polygons, 200 gas
drifters), the north star (100k particles + 10k polygons), KEPLERIAN_DISK
and PLANETARY_OCEAN (N-body gravity: the direct sum), the galaxy at 100k
bodies (``galaxy_direct``, the direct sum at scale) and at 1M (``galaxy``,
bench.py's, the P3M branch); ten ``build_tick_fn`` calls for
SIMPLE_FLUID.
DAM_BREAK 100k runs three times: in its default configuration (resident,
the stacked kernel chain), with ``pair_backend="pallas"`` (resident, the
split density, force and coupling kernels) and with ``residency="off"``,
``pair_backend="pallas"`` (the per-tick scatter step); ``dam_mixed_h`` is
the same dam with its odd-indexed particles at smoothing length 0.04
(chip_smoke.py phase 22's scene; mixed h takes the mixed-h split chain);
``dam_bands2`` and ``dam_bands4`` run the split dam in 2 and 4 row bands
(``parallel.sharded.build_sharded_run``: the multi-device fluid,
chip_smoke.py phase 23). ``rigid_bands2`` and ``rigid_bands4`` run
RIGID_STACKS 10k's grid rigid pipeline in 2 and 4 y-row bands,
``galaxy_direct_shards4`` and ``galaxy_shards4`` the two galaxies with
their gravity split by receiver blocks over 4 devices, ``north_bands4``
the north star with its fluid and its grid rigids both in 4 bands (entity
sharding, chip_smoke.py phase 24), ``coupled_shards4`` the coupled dam
with its fluid in 4 row bands and its rigid list pipeline in 4 shards
(runs of pairs and rows, chip_smoke.py phase 25). Each mesh puts a band
a card on a host with that many cards (``parallel.make_mesh``), else all
on the one card.
Device time sums over the cards.
For each it prints

- ticks/s of 3 timed runs of 5 blocks each (host clock around
  synchronized blocks, after one warm-up block);
- one block under ``torch.profiler``: device time per tick by kernel name
  (the port's kernels, then the 8 largest others, then the rest) and in
  all, that total over the timed runs' mean wall time per tick (the share
  of a tick in which the device was busy), and the kernel launches a tick;
- for RIGID_STACKS, the device time per tick of the rigid system's
  profiler ranges: the whole system, ``rigid.rows`` (guard, rebuild, the
  per-tick grids and the rows' mass selects), ``rigid.rebuild`` within it
  and the rest of it, ``rigid.narrowphase`` (the wrapper's PyTorch ops;
  the profiler does not tie a kernel launched through ctypes to a range,
  so the narrowphase kernels' time comes from their names), the rows
  without the rebuild plus the narrowphase, and the solvers (the rest),
  with the guard's rebuilds per tick; the north star's the same;
- for every scene, the device time per tick of each system's range
  (the PyTorch ops it runs, ``barnes_hut`` for gravity; the port's
  kernels fall in no range);
- for the coupled dam (also in shards) and the highlight reel (the rigid
  list pipeline), the device time per tick and the kernel launches per
  tick of its ranges: the whole system, ``rigid.broadphase``,
  ``rigid.narrowphase`` (GJK, EPA, manifolds), ``rigid.compact``
  (active-row compaction and warm start), ``rigid.velocity`` and
  ``rigid.position``.

The card's name and power limit come first, as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import collections
import dataclasses
import subprocess
import time

import torch

BLOCK = 10
DAM_N = 100_000
RIGID_N = 10_000
BLOCKS, RUNS, TOP = 5, 3, 8
PORT_KERNELS = ("migrate_kernel", "sweep_kernel",
                "coupling9_kernel", "split_density_kernel",
                "split_force_kernel", "coupling_kernel", "narrowphase_kernel",
                "narrowphase_grid_kernel")
DAM_FLUID = {   # scene name -> FluidConfig fields of that dam configuration
    "dam": {},
    "dam_split": dict(pair_backend="pallas"),
    "dam_scatter": dict(residency="off", pair_backend="pallas"),
    "dam_mixed_h": {},
}
MIXED_SMALL_H = 0.04   # dam_mixed_h: the odd-indexed particles' h
DAM_BANDS = {"dam_bands2": 2, "dam_bands4": 4}   # scene -> row bands
# entity sharding: scene -> (the single-device scene it splits, devices)
SHARDED = {"rigid_bands2": ("rigid", 2), "rigid_bands4": ("rigid", 4),
           "north_bands4": ("north", 4), "coupled_shards4": ("coupled", 4),
           "galaxy_direct_shards4": ("galaxy_direct", 4),
           "galaxy_shards4": ("galaxy", 4)}
RIGID_RANGES = ("rigid", "rigid.rows", "rigid.rebuild", "rigid.narrowphase")
LIST_RANGES = ("rigid", "rigid.broadphase", "rigid.narrowphase",
               "rigid.compact", "rigid.velocity", "rigid.position")
BENCH_SCENES = {   # scene name -> (bench_scenes builder, its arguments)
    "coupled": ("build_coupled_dam", (DAM_N, 300)),
    "highlight": ("build_highlight_reel", (20_000, 60, 200)),
    "north": ("build_north_star", (DAM_N, RIGID_N)),
    "galaxy_direct": ("build_galaxy", (DAM_N,)),
    "galaxy": ("build_galaxy", (1_000_000,)),
}
CATALOG = {"keplerian": "KEPLERIAN_DISK", "ocean": "PLANETARY_OCEAN"}
LABELS = {"dam": f"DAM_BREAK {DAM_N}",
          "dam_split": f"DAM_BREAK {DAM_N} split kernels",
          "dam_scatter": f"DAM_BREAK {DAM_N} scatter + split pair",
          "dam_mixed_h": f"DAM_BREAK {DAM_N} mixed h (odd particles "
                         f"{MIXED_SMALL_H})",
          "dam_bands2": f"DAM_BREAK {DAM_N} split, 2 row bands",
          "dam_bands4": f"DAM_BREAK {DAM_N} split, 4 row bands",
          "simple_fluid": "SIMPLE_FLUID",
          "rigid": f"RIGID_STACKS {RIGID_N}",
          "coupled": f"COUPLED_DAM {DAM_N} + 300",
          "highlight": "HIGHLIGHT 20000 + 60 + 200 gas",
          "north": f"NORTH_STAR {DAM_N} + {RIGID_N}",
          "keplerian": "KEPLERIAN_DISK", "ocean": "PLANETARY_OCEAN",
          "galaxy_direct": f"GALAXY {DAM_N} (direct sum)",
          "galaxy": "GALAXY 1000000 (P3M)"}
LABELS.update({k: f"{LABELS[base]}, {D} " + ("shards" if "shards" in k
                                             else "bands")
               for k, (base, D) in SHARDED.items()})


def _mesh(D, device):
    """D bands: a card each where the host has that many, else all on
    ``device``."""
    from .parallel import make_mesh
    return make_mesh(D) if torch.cuda.device_count() >= D else \
        make_mesh(devices=[device] * D)


def _scene(name, device):
    from .core.constants import SimulationType
    from .scenarios import create_scenario
    from .scenarios.bench_scenes import build_dam_break, build_rigid_stacks
    from .systems import build_run_fn, build_tick_fn
    if name in DAM_FLUID:
        sc = build_dam_break(DAM_N, device=device)
        if name == "dam_mixed_h":
            liq = sc.spec.liquid_slice
            h = sc.state.bodies.h.clone()
            h[liq.start + 1:liq.stop:2] = MIXED_SMALL_H
            sc = dataclasses.replace(
                sc, spec=dataclasses.replace(sc.spec, liquid_h_uniform=False),
                state=sc.state.replace(bodies=sc.state.bodies.replace(h=h)))
        cfg = sc.cfg.replace(fluid=dataclasses.replace(sc.cfg.fluid,
                                                       **DAM_FLUID[name]))
        return sc, build_run_fn(sc.spec, cfg, ticks=BLOCK, device=device)
    if name in DAM_BANDS:
        from .parallel.sharded import build_sharded_run
        sc = build_dam_break(DAM_N, device=device)
        sc.cfg = sc.cfg.replace(fluid=dataclasses.replace(
            sc.cfg.fluid, pair_backend="pallas"))
        return sc, build_sharded_run(sc, _mesh(DAM_BANDS[name], device),
                                     ticks=BLOCK)
    if name in SHARDED:
        from .parallel.sharded import build_sharded_run
        base, D = SHARDED[name]
        sc, _ = _scene(base, device)
        return sc, build_sharded_run(sc, _mesh(D, device), ticks=BLOCK)
    if name == "rigid":
        sc = build_rigid_stacks(RIGID_N, device=device)
        return sc, build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=device)
    if name in BENCH_SCENES:
        from .scenarios import bench_scenes
        fn, args = BENCH_SCENES[name]
        sc = getattr(bench_scenes, fn)(*args, device=device)
        return sc, build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=device)
    if name in CATALOG:
        sc = create_scenario(CATALOG[name], seed=0, device=device)
        return sc, build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=device)
    sc = create_scenario(SimulationType.SIMPLE_FLUID, seed=0, device=device)
    tick = build_tick_fn(sc.spec, sc.cfg, device=device)

    def block(state):
        for _ in range(BLOCK):
            state = tick(state)
        return state

    block.systems = tick.systems
    return sc, block


def _kernel_times(prof, ranges):
    """Device microseconds by kernel name (without its C++ signature and
    template arguments) over the profiled region. The spans that the
    profiler draws on the device for the tracer's ranges (a system's
    name, ``rigid.*``) are not kernels and are left out."""
    from torch.autograd import DeviceType
    out = collections.defaultdict(float)
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name in ranges or \
                getattr(e, "is_user_annotation", False):
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].removeprefix("void ")
        out[name] += e.time_range.elapsed_us()
        n += 1
    return out, n


def _range_times(prof, ranges=RIGID_RANGES):
    """Device microseconds of the kernels launched under each of the
    ``ranges`` (host-side range events only)."""
    from torch.autograd import DeviceType
    out = dict.fromkeys(ranges, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in out:
            out[e.name] += e.device_time_total
    return out


def _range_launches(prof, ranges):
    """Kernel launches made on the host inside each of the ``ranges``: the
    CUDA runtime's launch calls that start within one of its spans."""
    import bisect
    from torch.autograd import DeviceType
    spans = {r: [] for r in ranges}
    starts = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        elif e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            starts.append(e.time_range.start)
    starts.sort()
    return {r: sum(bisect.bisect_right(starts, b) - bisect.bisect_left(
        starts, a) for a, b in sp) for r, sp in spans.items()}


def profile_scene(name, device):
    from torch.profiler import ProfilerActivity, profile
    sc, block = _scene(name, device)
    state = block(sc.state)                     # warm-up block
    torch.cuda.synchronize()
    label = LABELS[name]
    meshes = [getattr(st, "mesh", None)
              for st in getattr(block, "systems", {}).values()]
    mesh = next((m for m in meshes if m is not None), None)
    if mesh is not None:
        label += f" on {len(set(mesh.devices))} card(s)"
    rigid = getattr(block, "systems", {}).get("rigid")
    if rigid is not None and hasattr(rigid, "rebuilds"):
        rigid.rebuilds = 0
    wall = 0.0
    for r in range(RUNS):
        t0 = time.perf_counter()
        for _ in range(BLOCKS):
            state = block(state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        wall += dt
        print(f"{label}: run {r}: {BLOCKS * BLOCK / dt:.2f} ticks/s over "
              f"{BLOCKS} blocks of {BLOCK} ticks", flush=True)
    wall_ms = wall * 1e3 / (RUNS * BLOCKS * BLOCK)     # per tick, unprofiled
    if rigid is not None and hasattr(rigid, "rebuilds"):
        print(f"{label}: the guard rebuilt the grid on {rigid.rebuilds} of "
              f"{RUNS * BLOCKS * BLOCK} timed ticks", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = block(state)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(state.bodies.pos).all()):
        raise SystemExit(f"{label}: non-finite positions")
    kt, n_kernels = _kernel_times(prof, set(getattr(block, "systems", ()))
                                  | set(RIGID_RANGES))
    if not kt:
        print(f"{label}: the profiler saw no device activity; wall "
              f"{wall_ms:.4f} ms per tick", flush=True)
        return
    per_tick = {k: v / 1e3 / BLOCK for k, v in kt.items()}   # ms per tick
    total = sum(per_tick.values())
    ours = [k for k in PORT_KERNELS if k in per_tick]
    others = sorted((k for k in per_tick if k not in ours),
                    key=lambda k: -per_tick[k])
    print(f"{label}: profiled block, device ms per tick by kernel:")
    for k in ours + others[:TOP]:
        print(f"  {per_tick[k]:9.4f}  {k[:110]}")
    rest = sum(per_tick[k] for k in others[TOP:])
    glue = sum(per_tick[k] for k in others)
    print(f"  {rest:9.4f}  ({len(others[TOP:])} other kernel names)")
    print(f"{label}: device {total:.4f} ms per tick (port kernels "
          f"{total - glue:.4f}, other {glue:.4f} = {100 * glue / total:.1f}%)"
          f"; wall {wall_ms:.4f} ms per tick (mean of the timed runs); "
          f"device busy {100 * total / wall_ms:.1f}% of a tick; "
          f"{n_kernels / BLOCK:.0f} kernel launches a tick", flush=True)
    systems = tuple(getattr(block, "systems", ()))
    st = _range_times(prof, systems)
    print(f"{label}: device ms per tick by system (PyTorch ops only: the "
          "port's kernels, launched through ctypes, fall in no range): "
          + ", ".join(f"{k} {v / 1e3 / BLOCK:.4f}" for k, v in st.items()),
          flush=True)
    if SHARDED.get(name, (name,))[0] in ("coupled", "highlight"):
        # the rigid list pipeline
        rt = _range_times(prof, LIST_RANGES)
        nl = _range_launches(prof, LIST_RANGES)
        print(f"{label}: rigid list pipeline, device ms [launches] per "
              "tick: " + ", ".join(
                  f"{k.removeprefix('rigid.')} {rt[k] / 1e3 / BLOCK:.4f} "
                  f"[{nl[k] / BLOCK:.0f}]" for k in LIST_RANGES)
              + f"; guard host reads {rigid.guard_reads}", flush=True)
    if SHARDED.get(name, (name,))[0] in ("rigid", "north"):
        rt = {k: v / 1e3 / BLOCK for k, v in _range_times(prof).items()}
        solver = rt["rigid"] - rt["rigid.rows"] - rt["rigid.narrowphase"]
        npk = per_tick.get("narrowphase_kernel", 0.0) + \
            per_tick.get("narrowphase_grid_kernel", 0.0)
        rows = rt["rigid.rows"] - rt["rigid.rebuild"]
        nph = rt["rigid.narrowphase"] + npk
        print(f"{label}: rigid system ranges, device ms per tick: all "
              f"{rt['rigid'] + npk:.4f}, rows {rt['rigid.rows']:.4f} "
              f"(rebuild {rt['rigid.rebuild']:.4f}, the rest {rows:.4f}), "
              f"narrowphase {nph:.4f} (kernel {npk:.4f}); rows without "
              f"the rebuild plus narrowphase {rows + nph:.4f}; solvers (the "
              f"rest) {solver:.4f}", flush=True)


def main(argv=None):
    import sys
    names = (*DAM_FLUID, *DAM_BANDS, "simple_fluid", "rigid", *BENCH_SCENES,
             *CATALOG, *SHARDED)
    want = list(sys.argv[1:] if argv is None else argv) or names
    if set(want) - set(names):
        raise SystemExit(f"profile_tick: scenes are {', '.join(names)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    for name in want:
        profile_scene(name, dev)


if __name__ == "__main__":
    main()
