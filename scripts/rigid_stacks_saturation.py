"""lpe_tpu's grid-rigid capacity saturation on RIGID_STACKS 10k (the bench's
rigid config), on the CPU: the reference figures that the port's
``chip_smoke.py`` holds its own run against.

    JAX_PLATFORMS=cpu python scripts/rigid_stacks_saturation.py

Prints ``core.telemetry.capacity_report``'s grid sections at ticks 0, 10,
20, 30 and 40 (``build_run_fn(ticks=10)`` blocks), then the mean y of the
dynamic bodies at tick 0 and 40. Takes about a minute.
"""
from __future__ import annotations

import time

import jax
import numpy as np

from lpe_tpu.core.telemetry import capacity_report
from lpe_tpu.scenarios.bench_scenes import build_rigid_stacks
from lpe_tpu.state import to_numpy
from lpe_tpu.systems import build_run_fn


def _line(tick, rep):
    slots, rows = rep["rigid_grid_slots"], rep["rigid_grid_rows"]
    return (f"tick {tick}: bodies per cell max {slots['max']} of "
            f"{slots['cap']}, dropped {slots['dropped']} "
            f"(frac {slots['frac']:.4f}); candidate rows frac "
            f"{rows['frac']:.4f}, max per class {rows['max']}")


def main():
    sc = build_rigid_stacks(10000, seed=0)
    run = build_run_fn(sc.spec, sc.cfg, ticks=10, donate=False)
    S = sc.spec.n_solid
    state = sc.state
    y0 = float(np.asarray(state.bodies.pos)[4:S, 1].mean())
    print(_line(0, capacity_report(to_numpy(state), sc.spec, sc.cfg)),
          flush=True)
    t0 = time.perf_counter()
    for block in range(1, 5):
        state = run(state)
        jax.block_until_ready(state)
        print(_line(10 * block,
                    capacity_report(to_numpy(state), sc.spec, sc.cfg)),
              flush=True)
    y1 = float(np.asarray(state.bodies.pos)[4:S, 1].mean())
    print(f"mean y of the dynamic bodies {y0:.4f} -> {y1:.4f}; "
          f"{time.perf_counter() - t0:.1f} s on {jax.default_backend()}")


if __name__ == "__main__":
    main()
