"""Time and profile the port's tick on one CUDA card.

    python3 -m lpe_tpu_torch.profile_tick

A block is 10 ticks: one ``build_run_fn(ticks=10)`` call for DAM_BREAK
100k (the grid stays resident across the block) and for RIGID_STACKS 10k
(the bench's rigid config), ten ``build_tick_fn`` calls for SIMPLE_FLUID.
For each scene it prints

- ticks/s of 3 timed runs of 5 blocks each (host clock around
  synchronized blocks, after one warm-up block);
- one block under ``torch.profiler``: device time per tick by kernel name
  (the port's kernels, then the 8 largest others, then the rest) and in
  all, that total over the timed runs' mean wall time per tick (the share
  of a tick in which the device was busy), and the kernel launches a tick;
- for RIGID_STACKS, the device time per tick of the rigid system's
  profiler ranges: the whole system, ``rigid.rows`` (guard, rebuild and
  row selects), ``rigid.rebuild`` within it, ``rigid.narrowphase`` (the
  wrapper's PyTorch ops; the profiler does not tie the kernel, launched
  through ctypes, to a range, so its time comes from its name), and the
  solvers (the rest), with the guard's rebuilds per tick.

The card's name and power limit come first, as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import collections
import subprocess
import time

import torch

BLOCK = 10
DAM_N = 100_000
RIGID_N = 10_000
BLOCKS, RUNS, TOP = 5, 3, 8
PORT_KERNELS = ("migrate_kernel", "density_kernel", "force_kernel",
                "coupling9_kernel", "narrowphase_kernel")
RIGID_RANGES = ("rigid", "rigid.rows", "rigid.rebuild", "rigid.narrowphase")
LABELS = {"dam": f"DAM_BREAK {DAM_N}", "simple_fluid": "SIMPLE_FLUID",
          "rigid": f"RIGID_STACKS {RIGID_N}"}


def _scene(name, device):
    from .core.constants import SimulationType
    from .scenarios import create_scenario
    from .scenarios.bench_scenes import build_dam_break, build_rigid_stacks
    from .systems import build_run_fn, build_tick_fn
    if name in ("dam", "rigid"):
        sc = (build_dam_break(DAM_N, device=device) if name == "dam" else
              build_rigid_stacks(RIGID_N, device=device))
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
    profiler draws on the device for the ``record_function`` ranges (a
    system's name, ``rigid.*``) are not kernels and are left out."""
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


def _range_times(prof):
    """Device microseconds of the kernels launched under each of the rigid
    system's ranges (host-side range events only)."""
    from torch.autograd import DeviceType
    out = dict.fromkeys(RIGID_RANGES, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in out:
            out[e.name] += e.device_time_total
    return out


def profile_scene(name, device):
    from torch.profiler import ProfilerActivity, profile
    sc, block = _scene(name, device)
    state = block(sc.state)                     # warm-up block
    torch.cuda.synchronize()
    label = LABELS[name]
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
    if name == "rigid":
        rt = {k: v / 1e3 / BLOCK for k, v in _range_times(prof).items()}
        solver = rt["rigid"] - rt["rigid.rows"] - rt["rigid.narrowphase"]
        npk = per_tick.get("narrowphase_kernel", 0.0)
        print(f"{label}: rigid system ranges, device ms per tick: all "
              f"{rt['rigid'] + npk:.4f}, rows {rt['rigid.rows']:.4f} "
              f"(rebuild {rt['rigid.rebuild']:.4f}), narrowphase "
              f"{rt['rigid.narrowphase'] + npk:.4f} (kernel {npk:.4f}), "
              f"solvers (the rest) {solver:.4f}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    for name in ("dam", "simple_fluid", "rigid"):
        profile_scene(name, dev)


if __name__ == "__main__":
    main()
