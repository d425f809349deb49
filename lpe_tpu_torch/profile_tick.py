"""Time and profile the port's tick on one CUDA card.

    python3 -m lpe_tpu_torch.profile_tick

A block is 10 ticks: one ``build_run_fn(ticks=10)`` call for DAM_BREAK
100k (the grid stays resident across the block), ten ``build_tick_fn``
calls for SIMPLE_FLUID. For each scene it prints

- ticks/s of 3 timed runs of 5 blocks each (host clock around
  synchronized blocks, after one warm-up block);
- one block under ``torch.profiler``: device time per tick by kernel name
  (the port's three kernels, then the 8 largest others, then the rest)
  and in all, and that total over the timed runs' mean wall time
  per tick: the share of a tick in which the device was busy.

The card's name and power limit come first, as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import collections
import subprocess
import time

import torch

BLOCK = 10
DAM_N = 100_000
BLOCKS, RUNS, TOP = 5, 3, 8
PORT_KERNELS = ("migrate_kernel", "density_kernel", "force_kernel",
                "coupling9_kernel")


def _scene(name, device):
    from .core.constants import SimulationType
    from .scenarios import create_scenario
    from .scenarios.bench_scenes import build_dam_break
    from .systems import build_run_fn, build_tick_fn
    if name == "dam":
        sc = build_dam_break(DAM_N, device=device)
        return sc, build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=device)
    sc = create_scenario(SimulationType.SIMPLE_FLUID, seed=0, device=device)
    tick = build_tick_fn(sc.spec, sc.cfg, device=device)

    def block(state):
        for _ in range(BLOCK):
            state = tick(state)
        return state

    return sc, block


def _kernel_times(prof):
    """Device microseconds by kernel name (without its C++ signature) over
    the profiled region."""
    from torch.autograd import DeviceType
    out = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name.split("(")[0]] += e.time_range.elapsed_us()
    return out


def profile_scene(name, device):
    from torch.profiler import ProfilerActivity, profile
    sc, block = _scene(name, device)
    state = block(sc.state)                     # warm-up block
    torch.cuda.synchronize()
    label = f"DAM_BREAK {DAM_N}" if name == "dam" else "SIMPLE_FLUID"
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state = block(state)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(state.bodies.pos).all()):
        raise SystemExit(f"{label}: non-finite positions")
    kt = _kernel_times(prof)
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
          f"device busy {100 * total / wall_ms:.1f}% of a tick",
          flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    for name in ("dam", "simple_fluid"):
        profile_scene(name, dev)


if __name__ == "__main__":
    main()
