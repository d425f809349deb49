#!/usr/bin/env python3
"""Drive the lpe_tpu_torch port once on an NVIDIA GPU and check it.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --compare PARENT_DIR [OTHER_DIR ...]

The second form only times the SPH kernels and the grid narrowphase of
other trees and this one, alternated on one card (see compare()); the
phases below are the first.

Phases (any failure raises and exits non-zero, printing no result):
  1. require CUDA; print the card (nvidia-smi name, power limit), torch and
     CUDA versions;
  2. build the CUDA kernels of ops/csrc/ with nvcc (timed);
  3. at the DAM_BREAK 100k shapes (the grid of the dam scene 40 ticks into
     its collapse), hold each SPH kernel against its plain PyTorch version
     and time both with CUDA events: the stacked chain (migrate, pair_sweep,
     coupling9) and the split kernels (density, force, coupling); migrate
     must equal its plain version to the bit. Each
     kernel of the chain against its twin on the card, to the bit: the
     pair sweep against density + EOS + force, coupling9 against coupling
     on the same sub-step, on the main path's own inputs (every cell copies
     through) and with the floor wall moved into the fluid (every occupied
     cell couples); then NaN planted in x, y, vx, vy and m of every empty
     slot of M9 must leave rho, fx, fy, PL and bigp bitwise unchanged (and
     reach ST only where an empty slot's own x, y, m are copied through),
     and NaN in every plane but the occupancy of the empty slots of ST,
     D8, D4 and D10 must leave migrate's M9, force's fx, fy, density's rho,
     and coupling's PL, bigp and occupied slots bitwise unchanged. At K =
     32, the kernels' largest (the same sub-step with its slots padded
     from 16), density, coupling9 and coupling on both candidate sets are
     held against their plain versions and, to the bit, their K = 16
     outputs; then coupling9 and coupling at K = 32 with live particles in
     slots 16-31 (each cell takes the slots of two neighbouring columns)
     against their plain versions and each other, to the bit.
     coupling9 and coupling are timed and bounded on both input sets; the
     kernels' line carries the main path's. Kernel times are each launch's
     alone, with L2 flushed before it (cuda_ms), as a tick finds its
     inputs; the time of back-to-back launches on inputs that may stay in
     L2 is printed beside it as "warm";
  4. run DAM_BREAK 100k through build_run_fn(ticks=10): the state must be
     finite, the three kernels of the stacked chain must have launched 10
     times a tick, the split kernels not at all, and no plain version run;
  5. run SIMPLE_FLUID through build_tick_fn for 120 ticks: the fluid falls
     and pools (y-mean from 3.0 toward ~5.5), and a second run from the
     same seed is bitwise equal;
  6. run one dam block under torch.cuda.set_sync_debug_mode("error"): a
     tick makes no host sync;
  6a. DAM_BREAK 100k with pair_backend="pallas" (the split resident
     sub-step) through build_run_fn(ticks=10): finite, migrate, density,
     force and coupling launched 10 times a tick, pair_sweep and coupling9
     not at all, no plain call; one tick from the same state agrees with
     the default stacked path (|dpos| <= 1e-4 m, rho rel <= 1e-3, lpe_tpu's
     resident-vs-scatter tolerances), and whether it does to the bit is
     printed and recorded;
  6b. DAM_BREAK 100k with residency="off", pair_backend="pallas" (the
     per-tick scatter step), 10 ticks: finite, density and force launched
     10 times a tick, no plain call, two runs bitwise equal; then one tick
     of the scatter step with the pair sweep (its default backend) must
     equal one with density + force to the bit;
  6c. SIMPLE_FLUID with pair_backend="pallas", 120 ticks: the same pooling
     (the S-slot branch of the coupling kernel);
  7. run RIGID_STACKS 10k (the bench's rigid config) through
     build_run_fn(ticks=10): finite, every body inside the tank, the bodies
     fall (mean y rises; screen-down is +y), the narrowphase kernel
     launched and its plain version never ran, and two 30-tick runs from
     seed 0 are bitwise equal; ticks/s and the guard's host reads per tick
     printed. The grid's capacities (core.telemetry) are printed at ticks 0
     and 40: this config saturates its candidate rows from tick 0 in
     lpe_tpu too (scripts/rigid_stacks_saturation.py: 73% of the AABB
     pairs beyond the class caps, 2.3% of the bodies beyond a cell's 48
     slots by tick 40), so the phase holds the bodies dropped from the
     grid under RIGID_MAX_DROP rather than at zero;
  8. at the rows of that run's state 40 ticks in (82,944 a tick), hold the
     narrowphase kernel against its plain version and time both;
  10. the coupled dam (build_coupled_dam(100000, 300), the rigid list
     pipeline with 300 dynamic pentagons) through build_run_fn, in the
     default and the split configuration: 60 ticks to settle, then 3
     blocks of 10 timed (host clock around synchronized blocks), every
     kernel counter set to 0 just before them and read just after: the
     path's kernels 10 times a tick, no other and no plain version. The
     fluid cells that couple with a dynamic rigid (not a wall) at the
     settled state are counted (0 fails), and there coupling9 and
     coupling are held against their plain versions and timed on the
     scene's own candidates, which move;
  11. the highlight reel (20k particles, 60 circles and polygons with
     sleep, 200 gas drifters): 60 ticks counted and timed the same way,
     finite;
  12. the north star (build_north_star(100000, 10000), the grid rigid
     pipeline): up to 120 ticks, fewer if the next block would pass 60 s
     (the count is printed), the stacked chain 10 times a tick and
     narrowphase_grid once a tick; coupling9 and coupling held and timed
     on its last state;
  13. one coupled-dam block under torch.cuda.set_sync_debug_mode("error"):
     the list rigid step makes no host read;
  14. two 10-tick coupled-dam blocks from one state equal to the bit in
     every state field;
  15. RANDOM_POLYGONS, FLUID_AND_POLYGONS, GALTON_BOARD and HOURGLASSES
     (create_scenario, the list pipeline), 60 ticks each, counted, timed,
     finite;
  17. KEPLERIAN_DISK (create_scenario, 1,000 bodies, the direct sum),
     120 ticks through drive: no port kernel and no plain version,
     finite, the median orbit-radius drift under 5% (lpe_tpu's gate), a
     second run from seed 0 equal to the bit; ticks/s;
  18. build_galaxy(100000), the direct sum at scale: 3 timed blocks
     (drive), no host sync in a block, two blocks from one state equal to
     the bit, one tick's velocity change against a float64 direct sum on
     1,024 seeded receivers (p95 relative error < 1e-3), the direct sum
     timed beside its bound;
  19. build_galaxy(1000000), bench.py's galaxy on the P3M branch: the host
     build time, the PP correction's K, subdivision, ncells and
     overflow_fraction, up to 3 blocks of 10 within 60 s (no port kernel,
     no plain version, finite, peak memory), no host sync in a block and
     two blocks equal to the bit, one tick against the float64 direct
     sum (p95 < 0.01, lpe_tpu's P3M gate; also over the receivers whose
     PP cell did not overflow), the mesh, PP and heavy parts timed
     beside their bounds;
  20. PLANETARY_OCEAN (create_scenario), 60 ticks through drive: the
     stacked chain 10 times a tick and nothing else, the ring survives
     around the moon (lpe_tpu's gate), one tick of build_run_fn(ticks=1)
     equals one of build_tick_fn to the bit (gravity keeps the
     cross-tick grid off), the cells where the moon couples counted and
     the couplings held against their plain versions there;
  21. the application layer (lpe_tpu_torch.app.cli.main, in this
     process, on the card): a. `list` prints the seven scenarios; b. `run
     --scenario SIMPLE_FLUID --ticks 120 --png --checkpoint`, every kernel
     counter set to 0 just before: migrate, pair_sweep and coupling9 1,200
     launches each, no other kernel and no plain version; the PNG decoded
     here with zlib is [600, 600, 3], its fluid blue covers > 2% (lpe_tpu's
     gate), and it equals to the bit the frame a fresh renderer draws from
     the checkpoint; c. `run --resume` for 60 ticks equals one straight
     180-tick run in every checkpoint field to the bit; d. `bench` prints
     its JSON line; e. 600x600 frames of SIMPLE_FLUID (tick 120, the exact
     splat), the 100k dam (tick 40, the convolution splat), the north star
     (tick 10, the windowed painter over 10,004 solids) and the highlight
     reel with debug on (tick 30: the loop painter, gas, both overlays):
     two renders equal to the bit, the CPU frame of the same state within
     the CPU tests' tolerance, ms a frame (CUDA events, median of 5), the
     PyTorch ops and host syncs a frame beside the scene's ms a tick; f.
     render_frame_with_ui's panel, and the stats block, equal the CPU's to
     the bit; then an `app` JSON line;
  22. mixed per-particle smoothing lengths (run_mixed_h): the 100k dam's
     layout and walls with its odd particles at h 0.04 (the grid keeps
     the uniform dam's shapes): a. migrate_h (to the bit), density_h and
     force_h (phase 3's tolerances) against their plain versions 40 ticks
     in, timed beside their bounds; b. 3 blocks of build_run_fn(ticks=10):
     migrate_h, density_h, force_h and coupling 10 times a tick, no other
     kernel and no plain version, finite, ticks/s; c. no host sync in a
     block, two blocks from one state equal to the bit; d. the scatter
     step, 10 ticks: density_h and force_h 10 times a tick; e. the liquid
     without walls at 20,000 particles: one tick (fluid, boundary,
     gravity) against the float64 oracle with per-particle h, on both
     residencies (rho rtol 2e-4, positions atol 5e-6); f. all h 0.05 but
     one far particle's: one tick of the h chain against the uniform split
     chain (|dpos| <= 1e-4 m; whether to the bit is printed);
  23. the multi-device fluid (lpe_tpu_torch.parallel), its row bands all
     on this card (run_bands): a. at the dam's 40-tick grid padded to
     4 x 69 rows, each of 4 bands' blocks through migrate with its row
     offset equal to the bit to migrate_plain and to the whole grid's
     rows, each band's launch timed beside the whole grid's, density and
     force on the bands' blocks equal to the whole grid's; then
     parallel.halo's density over the 4 bands equal to the whole grid's
     density kernel to the bit; b. DAM_BREAK 100k, pair_backend="pallas",
     in 2 and in 4 bands through build_sharded_run(ticks=10): 3 counted
     blocks (migrate, density, force and coupling 10 D times a tick,
     nothing else, no plain version; finite), the exchange's bytes and
     copies a tick; ticks/s of the single-device split dam and of both
     band counts timed in turn over 6 rounds of 2 blocks (the order
     reversed every other round), each round's and the median, and each
     round's single-device ticks/s over the bands'; no host sync in a
     block, two blocks equal to the bit; one tick against
     the single-device split tick (|dpos| <= 5e-4 m, |dvel| <= 5e-3 m/s,
     lpe_tpu's halo tolerances; whether to the bit is printed); c. the
     coupled dam in 4 bands from phase 10's settled split state, one
     counted block against the single-device split block (the same
     tolerances, the rigids' vel and omega too), the particles that
     changed band in it counted (0 fails); d. dryrun_multichip(4) on the
     card, its line printed;
  24. entity sharding (lpe_tpu_torch.parallel.sharded: gravity split by
     receiver blocks, the grid rigid pipeline in y-row bands), all bands
     on this card (run_entity_shards): a. at RIGID_STACKS 10k's rows 40
     ticks in, cut into 2 and into 4 y-row bands (rigid_kernels.grid_band:
     a band's rows and the row below them), narrowphase_grid on each
     band's rows equal to the bit to its plain version (candidate rows;
     whether every row, printed) and to the whole grid's kernel on those
     rows (every row), each band's launch timed beside the whole grid's
     and its bound; b. RIGID_STACKS 10k in 2 and 4 bands through
     build_sharded_run(ticks=3) from that state: a block against the
     single device's (pos 1e-5 m, vel and omega 1e-4, lpe_tpu's sharded
     tolerances; whether to the bit printed), a counted block
     (narrowphase_grid D times a tick, nothing else, no plain version; its
     host syncs counted under set_sync_debug_mode("warn"): the guard's one
     a tick and no other), the exchange's bytes and copies a tick, two
     blocks from one state equal to the bit, ticks/s beside the single
     device timed in turn; c. the galaxies of phases 18 and 19 (100k,
     the direct sum; 1M, P3M) in 2 and 4 shards through
     build_sharded_run(ticks=2): no port kernel, equal to the single
     device to the bit, kernel launches a tick (profiler) and ticks/s
     beside the single device; d. the north star (phase 12's state) with
     the split fluid in 4 row bands and its rigids in 4 y-row bands, one
     tick against the single-device split tick (phase 23's tolerances for
     the liquid, b.'s for the rigids); e. dryrun_multichip(4) on the card
     (its coupled scene, a 512-body galaxy and lpe_tpu's SHARD_GRID
     scene; its coupled scene runs its rigid list pipeline in 4 shards),
     its line printed;
  25. the rigid list pipeline over the mesh (its narrowphase by runs of
     pairs, its solvers' row math by runs of rows; run_list_shards), all
     shards on this card: a. the coupled dam (phase 10's settled split
     state) with its fluid in 4 row bands and its list pipeline in 4
     shards through build_sharded_run(ticks=3): a block against the
     single device's (the liquid at phase 23's tolerances, the rigids at
     pos 1e-5 m, vel and omega 1e-4; whether each is to the bit, and the
     warm caches, printed; the rigids and warm caches must equal, to the
     bit, the same block with the fluid in bands and the list pipeline
     whole: what the list split itself changes), a counted block (migrate, density, force and
     coupling 10 D times a tick, nothing else, no plain version) whose
     host syncs are counted under set_sync_debug_mode("warn") (none
     beyond the single device's block), the split's copies and bytes a
     tick, two blocks from one state equal to the bit, kernel launches a
     tick (profiler) beside the single device's with the
     rigid.narrowphase, .velocity and .position ranges apart, ticks/s
     beside the single device timed in turn over 3 rounds (median
     printed); b. RANDOM_POLYGONS (seed 1) in 2 and 4 shards, 10 ticks
     against the single device (the same rigid tolerances; bits printed)
     and launches a tick; c. is phase 24e's dry run, whose line carries
     the coupled scene's list split;
  16. then print the bitwise twin checks as a JSON line, the K = 64
     kernels, the launches of each new path, the couplings on moving
     rigids, the gravity parts' times and bounds, the app line, the
     mixed_h line, the bands line, the shards line (phase 25's under
     "list"), the kernels' JSON line (narrowphase_grid's with its band
     launches), then the result line.
Every kernel's line carries its bound: the larger of the bytes it must
move on these inputs (slot_bytes, coupling9_bytes, coupling_bytes: what
an empty slot or a cell that does not couple holds is counted only where
an output needs it) over 3.35 TB/s and the operations this run's data
needs over the 67 TFLOP/s fp32 rate (H100 SXM, published peaks).
This script imports no jax and nothing of the lpe_tpu package.
"""
from __future__ import annotations

import json
import math
import subprocess
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DAM_N = 100_000
RIGID_N = 10_000
COUPLED = (100_000, 300)           # build_coupled_dam: fluid, pentagons
HIGHLIGHT = (20_000, 60, 200)      # build_highlight_reel: fluid, rigids, gas
NORTH = (100_000, 10_000)          # build_north_star: fluid, polygons
SETTLE = 60           # ticks before the coupled dam is timed (bench.py:324)
NORTH_SETTLE = 120    # the north star's, cut to fit NORTH_BUDGET_S
NORTH_BUDGET_S = 60.0
LIST_SCENES = ("RANDOM_POLYGONS", "FLUID_AND_POLYGONS", "GALTON_BOARD",
               "HOURGLASSES")
LIST_TICKS = 60
BLOCK = 10
WARM_BLOCKS = 4      # dam blocks run before the kernel check (phase 3)
SUBSTEPS = 10        # FluidConfig.num_sub_steps of the fluid scenes
KEPLER_TICKS = 120    # tests/test_integration.py:47-55's horizon
GALAXY_DIRECT_N = 100_000          # build_galaxy: the direct sum at scale
GALAXY_N = 1_000_000               # bench.py's galaxy: the P3M branch
GALAXY_BUDGET_S = 60.0
REF_RECEIVERS = 1024  # receivers held against the float64 direct sum
OCEAN_TICKS = 60      # tests/test_integration.py:107-117's horizon
KERNEL_INFO = {   # name -> (CUDA source, the Pallas kernel it replaces)
    "migrate": ("lpe_tpu_torch/ops/csrc/migrate.cu",
                "lpe_tpu/ops/pallas_sph.py:1128"),
    "pair_sweep": ("lpe_tpu_torch/ops/csrc/pair_sweep.cu",
                   "lpe_tpu/ops/pallas_sph.py:804"),
    "coupling9": ("lpe_tpu_torch/ops/csrc/coupling9.cu",
                  "lpe_tpu/ops/pallas_sph.py:664"),
    "narrowphase": ("lpe_tpu_torch/ops/csrc/narrowphase.cu",
                    "lpe_tpu/ops/pallas_rigid.py:47"),
    "narrowphase_grid": ("lpe_tpu_torch/ops/csrc/narrowphase_grid.cu",
                         "lpe_tpu/ops/pallas_rigid.py:47"),
    "coupling": ("lpe_tpu_torch/ops/csrc/coupling.cu",
                 "lpe_tpu/ops/pallas_sph.py:554"),
    "density": ("lpe_tpu_torch/ops/csrc/density.cu",
                "lpe_tpu/ops/pallas_sph.py:78"),
    "force": ("lpe_tpu_torch/ops/csrc/force.cu",
              "lpe_tpu/ops/pallas_sph.py:122"),
    # the mixed-h variants (template instances of the same sources) of the
    # kernels whose Pallas versions lpe_tpu does not run for mixed h (it
    # takes its XLA pair passes, lpe_tpu/systems/fluid/sph.py:264)
    "migrate_h": ("lpe_tpu_torch/ops/csrc/migrate.cu",
                  "lpe_tpu/ops/pallas_sph.py:1128"),
    "density_h": ("lpe_tpu_torch/ops/csrc/density.cu",
                  "lpe_tpu/ops/pallas_sph.py:78"),
    "force_h": ("lpe_tpu_torch/ops/csrc/force.cu",
                "lpe_tpu/ops/pallas_sph.py:122"),
}
# H100 SXM published peaks (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_FLUSH_BYTES = 256 << 20     # written between timed calls: 5x the L2
# the card spins this many cycles (~0.5 ms) after the flush, before a timed
# call starts, so that the host has queued the call's kernels by then
HOST_SLACK_CYCLES = 1_000_000
# bodies beyond a cell's slots at tick 40 (lpe_tpu on the CPU: 0.0232)
RIGID_MAX_DROP = 0.05
# operation counts of the work, per unit of this run's data (estimates from
# the kernels' arithmetic): a fluid particle's kick, drift and re-bin; a
# particle pair of the 3x3 neighbourhood in the density pass and the force
# pass; a particle-candidate pair of the coupling (per vertex and fixed)
MIGRATE_OPS = 20
DENSITY_OPS, FORCE_OPS = 12, 48
PAIR_OPS = DENSITY_OPS + FORCE_OPS
# mixed h adds each pair's h-bar, its square and the kernels' normalisations
# at h-bar (poly6: a max, three products and a divide; spiky and viscosity:
# a max, five products and two divides), and force_h's near mark tests
# every candidate against its own h-bar
DENSITY_H_OPS, FORCE_H_OPS = DENSITY_OPS + 8, FORCE_OPS + 13
CPL_OPS_PER_VERT, CPL_OPS = 25, 60
# gravity: a source-receiver pair of the direct sums (dx, dy, d2, rsqrt,
# the weight, two products summed) and of the PP pass (the same plus the
# smoothstep rolloff and the cutoff test); a body's CIC deposit and gather
GRAV_PAIR_OPS, PP_PAIR_OPS, CIC_OPS = 15, 30, 40


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


_flush = []


def cuda_ms(fn, reps: int = 20, cold: bool = True) -> float:
    """Mean ms of ``fn`` on the card by CUDA events, after 3 warm-up calls.
    ``cold``: each call timed alone, after writing L2_FLUSH_BYTES so that
    the L2 cache holds none of its inputs, as in a tick, where the kernels
    before it have moved more than L2 holds, and after HOST_SLACK_CYCLES,
    so that the time is the card's alone, not the host's wrapper code;
    else ``reps`` calls back to back, whose inputs may stay in L2 (50 MB on
    the H100) and whose time follows the host where its wrapper code takes
    longer than the kernel."""
    import torch
    for _ in range(3):
        fn()
    if not cold:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps
    if not _flush:
        _flush.append(torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                  device="cuda"))
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for t0, t1 in ev:
        _flush[0].zero_()
        torch.cuda._sleep(HOST_SLACK_CYCLES)
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in ev) / reps


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def same_bits(a, b) -> bool:
    """Bitwise equality of two float32 tensors (+0 and -0 differ)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def same_bits_or_nan(a, b) -> bool:
    """NaN in the same places, bitwise equal elsewhere."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and \
        same_bits(torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def tensor_bits_equal(a, b) -> bool:
    """Float32 tensors: same_bits_or_nan; any other: torch.equal."""
    import torch
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return same_bits_or_nan(a, b)
    return a.dtype == b.dtype and torch.equal(a, b)


def state_fields(a, b, part=""):
    """(name, field of a, field of b) for the tensor fields of two states
    (``part`` "bodies": of their bodies)."""
    import dataclasses
    import torch
    if part:
        a, b = getattr(a, part), getattr(b, part)
    return [(f"{part}.{f.name}".lstrip("."), getattr(a, f.name),
             getattr(b, f.name)) for f in dataclasses.fields(a)
            if isinstance(getattr(a, f.name), torch.Tensor)]


# planes of a live slot that each staged kernel reads besides its
# occupancy (slot_bytes)
LIVE_PLANES = {"pair_sweep": 5,    # x, y, vx, vy, m of M9
               "migrate": 8,       # x, y, vx, vy, ax, ay, m, id of ST
               "density": 3,       # x, y, m of D4
               "force": 7,         # x, y, vx, vy, m, rho, p of D8
               "migrate_h": 9,     # migrate's and h of ST10
               "density_h": 4,     # x, y, m, h of D5
               "force_h": 8}       # force's and h of D9


def slot_bytes(name, occ, outs) -> int:
    """Bytes kernel ``name`` (a key of LIVE_PLANES) must move on these
    inputs: its input's occupancy plane ``occ`` once, its LIVE_PLANES other
    planes of the live slots only (what an empty slot holds reaches no
    output: the NaN plants of check_kernels), every output once (migrate's
    is the dense M9, most of its bytes)."""
    live = int((occ > 0).sum())
    return nbytes(occ) + LIVE_PLANES[name] * live * occ.element_size() + \
        nbytes(*outs)


def coupling9_bytes(cpl, fld, big, M9, outs) -> int:
    """Bytes coupling9 must move on these inputs: the M9 planes it reads
    (x, y, m, occ, id, hx, hy: not vx, vy), the sweep's rho, fx, fy, cpl,
    the candidate rows of the cells that couple (cpl > 0) and the big-solid
    table only if any cell couples; every output once."""
    rows, _, K, W = M9.shape
    plane = K * W * M9.element_size()
    coupled = int((cpl > 0).sum())
    per_cell = fld.shape[1] * fld.shape[2] * fld.element_size()
    return (rows * 7 * plane + 3 * (rows - 2) * plane + nbytes(cpl)
            + coupled * per_cell + (nbytes(big) if coupled else 0)
            + nbytes(*outs))


def coupling_bytes(cpl, fld, big, D10, outs) -> int:
    """Bytes coupling must move on these inputs: the D10 planes that a
    copied-through slot needs (x, y, vx1, vy1, ax, ay) over the interior
    rows, the occupancy of the cells that couple (cpl > 0) and rho, p, m
    of their live slots, cpl, those cells' candidate rows and the big-solid
    table only if any cell couples; every output once."""
    from lpe_tpu_torch.ops.sph_kernels import D10_OCC
    rows, _, K, W = D10.shape
    cell_bytes = K * D10.element_size()
    coupled = int((cpl > 0).sum())
    live = int(((D10[:, D10_OCC] > 0) & (cpl > 0)[:, None, :]).sum())
    per_cell = fld.shape[1] * fld.shape[2] * fld.element_size()
    return (6 * (rows - 2) * W * cell_bytes + coupled * cell_bytes
            + 3 * live * D10.element_size() + nbytes(cpl)
            + coupled * per_cell + (nbytes(big) if coupled else 0)
            + nbytes(*outs))


def bound(n_bytes, ops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``n_bytes`` or to do ``ops`` fp32 operations, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def moved_wall(SK, M9, fld, big, V):
    """The candidate tables (fld, big) with the dam's floor wall (big solid
    3) moved to the fluid's mean height and widened over its columns, as a
    big solid and in slot 0 of every cell."""
    occ = M9[:, SK.M9_OCC] > 0
    xs, ys = M9[:, SK.M9_X][occ], M9[:, SK.M9_Y][occ]
    wall = big[3].clone()
    shift = float(ys.mean()) - float(wall[SK.RW_PY])
    for i in (SK.RW_PY, SK.RW_MINY, SK.RW_MAXY):
        wall[i] += shift
    wall[SK.RW_V0 + 1:SK.RW_V0 + 2 * V:2] += shift       # vertex ys
    wall[SK.RW_MINX] = float(xs.min()) - 0.1
    wall[SK.RW_MAXX] = float(xs.max()) + 0.1
    big2 = big.clone()
    big2[3] = wall
    fld2 = fld.clone()
    fld2[:, 0] = wall[:, None]
    return fld2, big2


def neighbour_pairs(occ):
    """Occupied (particle, neighbour slot) pairs over the 3x3 cells of each
    particle: occ [rows, K, cols] of 0/1."""
    import torch
    n = occ.sum(1).double()                        # particles per cell
    p = torch.nn.functional.pad(n, (1, 1, 1, 1))
    nb = sum(p[1 + dy:p.shape[0] - 1 + dy, 1 + dx:p.shape[1] - 1 + dx]
             for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return float((n * nb).sum())


def dam_sub_step(dev):
    """DAM_BREAK 100k WARM_BLOCKS blocks in: (scene, fluid system, state,
    the grid stack ST that a sub-step starts from)."""
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    from lpe_tpu_torch.systems import build_run_fn
    from lpe_tpu_torch.systems.fluid import make_fluid

    sc = build_dam_break(DAM_N, device=dev)
    fl = make_fluid(sc.spec, sc.cfg, device=dev)
    run = build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=dev)
    state = sc.state
    for _ in range(WARM_BLOCKS):
        state = run(state)
    return sc, fl, state, fl.grid_stack(fl.grid_build(state))


def sub_step_inputs(SK, fl, state, ST, wall=True):
    """Every SPH kernel's inputs on one sub-step from ``ST``, each fed by
    the kernel before it: M9 (migrate), the sweep's rho, fx, fy, the split
    kernels' planes D4 (density), D8 (force) and D10 (coupling: second kick
    and EOS applied), and two candidate sets: the main path's own (the
    boundary margin keeps the dam's fluid off its walls, so its cells copy
    through) and, with ``wall``, with the floor wall moved into the fluid
    (moved_wall), so that the candidate math runs on every occupied
    cell."""
    import torch
    ck = fl.couple_consts
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    M9 = SK.migrate(ST, **fl.migrate_consts)
    sw = SK.pair_sweep(M9, **fl.sweep_consts)
    x1, y1, vx0, vy0, m, occ, hx, hy, _ = M9.unbind(1)
    rp, ax1, ay1 = (pad(v) for v in sw)
    cpl, fld, big = fl.coupling_inputs(state, M9)
    cands = {"main": (cpl, fld, big)}
    if wall:
        live = (occ.sum(1) > 0).to(torch.int32).contiguous()
        cands["wall"] = (live, *moved_wall(SK, M9, fld, big, ck["V"]))
    return dict(
        M9=M9, sw=sw, D4=torch.stack([x1, y1, m, occ], 1),
        D8=torch.stack([x1, y1, vx0, vy0, m, rp, fl.eos(rp), occ], 1),
        D10=torch.stack([x1, y1, hx + ck["half_dt"] * ax1,
                         hy + ck["half_dt"] * ay1, rp, fl.eos(rp), m, occ,
                         ax1, ay1], 1),
        cands=cands)


def couple_views(name, out):
    """A coupling kernel's outputs as (state planes, accelerations, PL,
    bigp): coupling9's come stacked in ST, coupling's as planes."""
    import torch
    from lpe_tpu_torch.ops import sph_kernels as SK
    acc = [SK.ST_AX, SK.ST_AY]
    rest = [f for f in range(9) if f not in acc]
    if name == "coupling9":
        return out[0][:, rest], out[0][:, acc], out[1], out[2]
    return torch.stack(out[:4]), torch.stack(out[4:6]), out[6], out[7]


# every coupling check of this run: its plain version's run-to-run spread,
# its partials' error against the plain version and the limit it was held to
COUPLE_ORACLE = []


def couple_check(name, label, op, a, ck, slots):
    """A coupling kernel's outputs on arguments ``a``, whose cells hold up
    to ``slots`` live particles, against its plain version's: (outputs,
    max abs error, nonzero partials)."""
    out = op(*a, cn=ck)
    st_k, a_k, pl_k, big_k = couple_views(name, out)
    st_p, a_p, pl_p, big_p = couple_views(name, op.plain(*a, cn=ck))
    # the plain version a second time: its run-to-run spread (its partials
    # are ordered scatter-adds, so none is expected)
    spread = max(max_err(u, v) for u, v in zip(
        (st_p, a_p, pl_p, big_p), couple_views(name, op.plain(*a, cn=ck)))
        if u.numel())
    st_err = max_err(st_k, st_p)
    a_err = max_err(a_k, a_p)
    a_scale = float(a_p.abs().max())
    # partials: per (row, slot, column) and per (row, block) sums,
    # elementwise, to 1e-5 plus 5e-7 of the largest for each 16 live slots
    # a cell may hold (float32 ulps of a block's sum over up to 32 x slots
    # particles, which the plain version adds in slot-major order, the
    # kernel column by column: 3.9e-7 of the largest on the dam's moved
    # wall at 16 slots, on an H100; the plain version's ordered sums repeat
    # to the bit, so no run-to-run spread is allowed for)
    pl_err = max_err(pl_k, pl_p)
    big_err = max_err(big_k, big_p) if big_p.numel() else 0.0   # no big
    part_scale = max(float(pl_p.abs().max()),
                     float(big_p.abs().max()) if big_p.numel() else 0.0)
    contact = int((big_p.abs() > 0).sum() + (pl_p.abs() > 0).sum())
    limit = 1e-5 + 5e-7 * slots / 16 * part_scale
    COUPLE_ORACLE.append(dict(check=f"{name} ({label})", spread=spread,
                              partials_err=max(big_err, pl_err),
                              limit=limit))
    print(f"{name} ({label}): cells coupled {int((a[0] > 0).sum())}, "
          f"nonzero partials {contact}, state err {st_err:.3e}, accel "
          f"err {a_err:.3e} of {a_scale:.4g}, partials err "
          f"{max(big_err, pl_err):.3e} of {part_scale:.4g} (limit "
          f"{limit:.3e}); plain version run to run {spread:.3e}", flush=True)
    if st_err > 1e-5 or a_err > max(1e-5, 1e-6 * a_scale) or \
            max(big_err, pl_err) > limit:
        fail(f"{name} ({label}) differs from its plain version")
    return out, max(st_err, big_err, pl_err), contact


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at dam-100k shapes."""
    import torch
    from lpe_tpu_torch.ops import sph_kernels as SK

    sc, fl, state, ST = dam_sub_step(dev)
    print(f"dam {DAM_N}: grid {tuple(ST.shape)} [rows, planes, K, cols], "
          f"nbig={len(sc.spec.solid_big_idx)}", flush=True)
    rows, _, K, W = ST.shape
    if K != 16 or rows != 275 or len(sc.spec.solid_big_idx) != 4:
        fail(f"unexpected dam-100k shapes rows={rows} K={K}")
    mk, sk, ck = fl.migrate_consts, fl.sweep_consts, fl.couple_consts
    inp = sub_step_inputs(SK, fl, state, ST)
    M9, sw, D4, D8, D10 = (inp[k] for k in ("M9", "sw", "D4", "D8", "D10"))
    cands = inp["cands"]
    M9p = SK.migrate_plain(ST, **mk)
    occ = M9p[:, SK.M9_OCC] > 0
    errs = {"migrate": max_err(M9, M9p)}
    drops = int((ST[:, SK.ST_OCC] > 0).sum() - occ.sum())
    print(f"migrate: bitwise equal to its plain version {same_bits(M9, M9p)}"
          f"; {int(occ.sum())} particles kept, {drops} dropped", flush=True)
    if not same_bits(M9, M9p):
        fail(f"migrate differs from its plain version (max abs err "
             f"{errs['migrate']})")

    swp = SK.pair_sweep_plain(M9, **sk)
    o = occ[1:-1]
    rho_rel = float(((sw[0] - swp[0]).abs() / swp[0].abs().clamp(min=1e-30))
                    [o].max())
    fscale = float(torch.stack(swp[1:]).abs().max())
    ferr = max(max_err(sw[1], swp[1]), max_err(sw[2], swp[2]))
    errs["pair_sweep"] = max(max_err(sw[0], swp[0]), ferr)

    def force_misses(out, ref=swp[1:]):
        """Force elements (fx, fy) off ``ref``'s (the plain pair sweep's,
        unless given) by more than 1e-5 of themselves plus 1e-6 of the
        force scale (the stiff EOS turns ULP-level rho reassociation into
        force noise)."""
        return sum(int(((a - b).abs() > 1e-5 * b.abs() + 1e-6 * fscale)
                       .sum()) for a, b in zip(out, ref))

    if rho_rel > 1e-5 or force_misses(sw[1:]):
        fail(f"pair_sweep: rho rel err {rho_rel}, {force_misses(sw[1:])} "
             f"force elements over the limit (max abs err {ferr}, scale "
             f"{fscale})")
    # a planted fault the force check must catch: min_rho raised to the
    # 1st percentile of the occupied slots' density drops the pairs of the
    # free surface's thinnest particles, whose forces are weak
    rho_q = float(torch.quantile(swp[0][o].double(), 0.01))
    bad = SK.pair_sweep_plain(M9, **dict(sk, min_rho=rho_q))
    bad_err = max(max_err(bad[1], swp[1]), max_err(bad[2], swp[2]))
    print(f"pair_sweep: rho rel err {rho_rel:.3e}; forces: scale {fscale:.6g}"
          f", max abs err {ferr:.3e}, limit per element 1e-5*|f| + "
          f"{1e-6 * fscale:.3e}; planted fault (min_rho {rho_q:.6g}): max "
          f"abs err {bad_err:.3e}, {force_misses(bad[1:])} elements over the "
          f"limit", flush=True)
    if force_misses(bad[1:]) == 0:
        fail("pair_sweep: the force check missed a planted fault")

    # density + EOS + force on the same planes (force's rho and pressure
    # from the sweep's rho): against their plain versions, and against the
    # pair sweep (one function, two routes)
    dk, fk = fl.density_consts, fl.force_consts
    rho = SK.density(D4, **dk)
    frc = SK.force(D8, **fk)
    rho_p = SK.density_plain(D4, **dk)
    frc_p = SK.force_plain(D8, **fk)

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30))[o].max())

    errs["density"] = max_err(rho, rho_p)
    errs["force"] = max(max_err(frc[0], frc_p[0]), max_err(frc[1], frc_p[1]))
    bad_f = SK.force_plain(D8, **dict(fk, min_rho=rho_q))
    print(f"density: rho rel err {rel(rho, rho_p):.3e} of its plain version;"
          f" force: max abs err {errs['force']:.3e} of its plain version "
          f"(scale {fscale:.6g}); planted fault: "
          f"{force_misses(bad_f, frc_p)} elements over the limit",
          flush=True)
    if rel(rho, rho_p) > 1e-5:
        fail("density differs from its plain version")
    if force_misses(frc, frc_p) or force_misses(frc):
        fail("force differs from its plain version")
    if force_misses(bad_f, frc_p) == 0:
        fail("force: the check missed a planted fault")
    # the pair sweep against its twin: density + EOS + force sum the same
    # pairs in the same order through csrc/sph_pair.cuh, so the two routes
    # must agree to the bit
    twins = {"pair_sweep": all(same_bits(a, b)
                               for a, b in zip(sw, (rho, *frc)))}
    print(f"pair_sweep vs density + EOS + force: bitwise equal "
          f"{twins['pair_sweep']}", flush=True)
    if not twins["pair_sweep"]:
        fail("pair_sweep differs from density + EOS + force")

    # the couplings on both candidate sets: coupling9 takes M9 and the
    # sweep's results, coupling the same sub-step as planes (D10)
    m, pid, occf = M9[:, SK.M9_M], M9[:, SK.M9_ID], M9[:, SK.M9_OCC]

    def check_couple(name, label, op, a, slots=K):
        return couple_check(name, label, op, a, ck, slots)

    outs = {}
    for name, op, tail in (("coupling9", SK.coupling9, (M9, *sw)),
                           ("coupling", SK.coupling, (D10,))):
        errs[name] = 0.0
        contact = 0
        for cname, cand in cands.items():
            outs[name, cname], err, contact = check_couple(
                name, cname, op, (*cand, *tail))
            errs[name] = max(errs[name], err)
        if contact == 0:
            fail(f"{name}: the moved wall coupled with no particle")

    # coupling9 against its twin, the split coupling on the same sub-step:
    # one candidate order and one reduction order, so the same bits
    for cname in cands:
        st9, pl9, bp9 = outs["coupling9", cname]
        oc = outs["coupling", cname]
        st_c = torch.stack([*oc[:6], m, pid, occf], 1)
        st_c[0] = st_c[-1] = 0.0
        twins[f"coupling9_{cname}"] = same_bits(st9, st_c) and \
            same_bits(pl9, oc[6]) and same_bits(bp9, oc[7])
    print(f"coupling9 vs coupling: ST, PL and bigp bitwise equal: main "
          f"inputs {twins['coupling9_main']}, moved wall "
          f"{twins['coupling9_wall']}", flush=True)
    if not (twins["coupling9_main"] and twins["coupling9_wall"]):
        fail("coupling9 differs from coupling on the same sub-step")

    # planted: NaN in x, y, vx, vy and m of every empty slot of M9 must not
    # reach rho, fx, fy, PL or bigp, and ST only where the slot's own x, y
    # and m are copied through; NaN in every plane but the occupancy of
    # ST's and D8's empty slots must leave migrate's M9 and force's fx, fy
    nan = float("nan")

    def plant(stack, occ_plane, planes=None):
        out = stack.clone()
        empty = out[:, occ_plane] <= 0
        for f in planes or range(stack.shape[1]):
            if f != occ_plane:
                out[:, f][empty] = nan
        return out

    M9n = plant(M9, SK.M9_OCC,
                (SK.M9_X, SK.M9_Y, SK.M9_VX, SK.M9_VY, SK.M9_M))
    empty = M9n[:, SK.M9_OCC] <= 0
    swn = SK.pair_sweep(M9n, **sk)
    nan_ok = all(same_bits(a, b) for a, b in zip(swn, sw))
    for cname, cand in cands.items():
        st_n, pl_n, bp_n = SK.coupling9(*cand, M9n, *swn, cn=ck)
        st9, pl9, bp9 = outs["coupling9", cname]
        st_e = st9.clone()
        for f in (SK.ST_X, SK.ST_Y, SK.ST_M):
            st_e[1:-1, f][empty[1:-1]] = nan
        nan_ok = nan_ok and same_bits_or_nan(st_n, st_e) and \
            same_bits(pl_n, pl9) and same_bits(bp_n, bp9)
    nan_ok = nan_ok and same_bits(SK.migrate(plant(ST, SK.ST_OCC), **mk),
                                  M9)
    nan_ok = nan_ok and all(same_bits(a, b) for a, b in zip(
        SK.force(plant(D8, SK.D8_OCC), **fk), frc))
    twins["nan_in_empty_slots"] = nan_ok
    print(f"planted NaN in the empty slots of ST, M9 and D8: migrate, "
          f"pair_sweep, coupling9 and force outputs unchanged {nan_ok}",
          flush=True)
    if not nan_ok:
        fail("NaN in empty slots reached migrate, the pair sweep, coupling9 "
             "or force")
    # NaN in every plane but the occupancy of the empty slots of D4 must
    # leave density's rho bitwise unchanged; of D10, coupling's PL and bigp
    # and every occupied slot's outputs (an empty slot's own planes are
    # copied through, as NaN)
    twins["nan_in_empty_slots_D4"] = same_bits(SK.density(plant(D4, 3),
                                                          **dk), rho)
    empty10 = (D10[:, SK.D10_OCC] <= 0)[1:-1]
    D10n = plant(D10, SK.D10_OCC)
    nan_ok = True
    for cname, cand in cands.items():
        got, ref = SK.coupling(*cand, D10n, cn=ck), outs["coupling", cname]
        for u, v in zip(got[:6], ref[:6]):
            want = v.clone()
            want[1:-1][empty10] = nan
            nan_ok = nan_ok and same_bits_or_nan(u, want)
        nan_ok = nan_ok and same_bits(got[6], ref[6]) and \
            same_bits(got[7], ref[7])
    twins["nan_in_empty_slots_D10"] = nan_ok
    print(f"planted NaN in the empty slots of D4 and D10: density's rho "
          f"unchanged {twins['nan_in_empty_slots_D4']}; coupling's PL, bigp"
          f" and occupied slots unchanged {nan_ok}", flush=True)
    if not (nan_ok and twins["nan_in_empty_slots_D4"]):
        fail("NaN in empty slots reached density or coupling")

    # K = 32, the kernels' largest: the same sub-step with its slots padded
    # from 16 to 32. density, coupling9 and coupling (both candidate sets)
    # against their plain versions, and to the bit their K = 16 outputs in
    # slots 0-15, PL and bigp (empty slots add +0)
    pad32 = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 32 - K))
    rho32 = SK.density(pad32(D4), **dk)
    rho32_p = SK.density_plain(pad32(D4), **dk)
    errs["density"] = max(errs["density"], max_err(rho32, rho32_p))
    if rel(rho32[:, :K], rho32_p[:, :K]) > 1e-5:
        fail("density at K = 32 differs from its plain version")
    k32_ok = same_bits(rho32[:, :K], rho) and \
        float(rho32[:, K:].abs().max()) == 0.0
    slots = {"coupling9": lambda out: [out[0][:, :, :K]],
             "coupling": lambda out: [u[:, :K] for u in out[:6]]}
    for name, op, tail in (("coupling9", SK.coupling9,
                            (pad32(M9), *map(pad32, sw))),
                           ("coupling", SK.coupling, (pad32(D10),))):
        for cname, cand in cands.items():
            out32, err, _ = check_couple(name, f"{cname}, K = 32", op,
                                         (*cand, *tail))
            errs[name] = max(errs[name], err)
            ref = outs[name, cname]
            k32_ok = k32_ok and all(same_bits(u, v) for u, v in zip(
                slots[name](out32), slots[name](ref))) and \
                all(same_bits(u, v) for u, v in zip(out32[-2:], ref[-2:]))
    twins["k32_equals_k16"] = k32_ok
    print(f"density, coupling9 and coupling at K = 32 (slots padded): slots "
          f"0-15, PL and bigp bitwise equal to K = 16 {k32_ok}", flush=True)
    if not k32_ok:
        fail("density, coupling9 or coupling at K = 32 differs from K = 16")

    # K = 32 with live particles in slots 16-31: each cell takes the slots
    # of two neighbouring columns (cols 288 -> 144), so in every block of a
    # cell that holds particles warps 16-31 list some too. coupling9 and
    # coupling on both candidate sets against their plain versions, and
    # against each other to the bit
    def fold(t):
        """[..., 16, W] -> [..., 32, W / 2]: cell c takes the slots of
        columns 2c (slots 0-15) and 2c + 1 (slots 16-31)."""
        *lead, k, w = t.shape
        return t.reshape(*lead, k, w // 2, 2).movedim(-1, -3) \
            .reshape(*lead, 2 * k, w // 2).contiguous()

    if W % 2:
        fail(f"cannot fold {W} columns in pairs")
    M9f, swf, D10f = fold(M9), [fold(v) for v in sw], fold(D10)
    folded = {n: (c.reshape(rows, W // 2, 2).amax(-1).contiguous(),
                  f[..., 0::2].contiguous(), b)
              for n, (c, f, b) in cands.items()}
    upper = (D10f[:, SK.D10_OCC, K:] > 0) & (folded["wall"][0] > 0)[:, None]
    fold_ok, outf = True, {}
    for cname, cand in folded.items():
        o9, err9, _ = check_couple("coupling9", f"{cname}, K = 32 folded",
                                   SK.coupling9, (*cand, M9f, *swf), 2 * K)
        oc, errc, _ = check_couple("coupling", f"{cname}, K = 32 folded",
                                   SK.coupling, (*cand, D10f), 2 * K)
        errs["coupling9"] = max(errs["coupling9"], err9)
        errs["coupling"] = max(errs["coupling"], errc)
        st_c = torch.stack([*oc[:6], M9f[:, SK.M9_M], M9f[:, SK.M9_ID],
                            M9f[:, SK.M9_OCC]], 1)
        st_c[0] = st_c[-1] = 0.0
        fold_ok = fold_ok and same_bits(o9[0], st_c) and \
            same_bits(o9[1], oc[6]) and same_bits(o9[2], oc[7])
        outf[cname] = oc
    xw, yw = outf["wall"][:2]
    moved = ((xw != D10f[:, SK.D10_X]) | (yw != D10f[:, SK.D10_Y]))[:, K:] \
        & upper
    twins["k32_full_slots"] = fold_ok
    print(f"coupling9 and coupling at K = 32 (column pairs folded): "
          f"{int(upper.sum())} coupled particles in slots 16-31, "
          f"{int(moved.sum())} of them moved by the wall; coupling9 equals "
          f"coupling to the bit {fold_ok}", flush=True)
    if not fold_ok or int(moved.sum()) == 0:
        fail("the couplings at K = 32 with live slots 16-31 disagree or "
             "coupled no particle there")

    def cpl_ops(c, live=occ):
        """Operations of the candidate math on the particles of ``live``
        [rows, K, cols] that couple (cpl ``c`` > 0)."""
        live_c = live & (c > 0)[:, None, :]
        return float(live_c.sum()) * (1 + len(sc.spec.solid_big_idx)) \
            * (CPL_OPS_PER_VERT * ck["V"] + CPL_OPS)

    # K = 64, the reference's cap and the kernels' largest: the same
    # sub-step with its slots padded from 16 to 64. Each of the six kernels
    # to the bit its K = 16 outputs in slots 0-15 (migrate: each target
    # cell's first 16 candidates, to the bit its plain version too; slots
    # 16-63 take those that K = 16 drops), 0 in slots 16-63 of the pair
    # kernels' outputs, the couplings' PL and bigp (empty slots add +0);
    # the couplings against their plain versions
    pad64 = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 64 - K))
    ST64 = pad64(ST)
    M964 = SK.migrate(ST64, **mk)
    k64_ok = same_bits(M964, SK.migrate_plain(ST64, **mk)) and \
        same_bits(M964[:, :, :K], M9)
    outs64 = (*SK.pair_sweep(pad64(M9), **sk), SK.density(pad64(D4), **dk),
              *SK.force(pad64(D8), **fk))
    for u, v in zip(outs64, (*sw, rho, *frc)):
        k64_ok = k64_ok and same_bits(u[:, :K], v) and \
            float(u[:, K:].abs().max()) == 0.0
    for name, op, tail in (("coupling9", SK.coupling9,
                            (pad64(M9), *map(pad64, sw))),
                           ("coupling", SK.coupling, (pad64(D10),))):
        for cname, cand in cands.items():
            out64, err, _ = check_couple(name, f"{cname}, K = 64", op,
                                         (*cand, *tail))
            errs[name] = max(errs[name], err)
            ref = outs[name, cname]
            k64_ok = k64_ok and all(same_bits(u, v) for u, v in zip(
                slots[name](out64), slots[name](ref))) and \
                all(same_bits(u, v) for u, v in zip(out64[-2:], ref[-2:]))
    twins["k64_equals_k16"] = k64_ok
    print(f"all six kernels at K = 64 (slots padded): slots 0-15, PL and "
          f"bigp bitwise equal to K = 16, slots 16-63 of the pair kernels "
          f"zero {k64_ok}", flush=True)
    if not k64_ok:
        fail("a kernel at K = 64 differs from K = 16")

    # K = 64 with live particles in slots 32-63: each cell takes the slots
    # of four neighbouring columns (cols 288 -> 72), so its cells hold up to
    # 64 particles and a coupling thread may list one in each of its two
    # slots. Each kernel against its plain version: migrate to the bit, the
    # pair kernels at the tolerances above (rho rel 1e-5; forces 1e-5 of
    # themselves plus 1e-6 of their scale), the couplings with the
    # partials' term for 64 live slots a cell; and the twins to the bit:
    # the sweep against density + EOS + force, coupling9 against coupling
    def fold4(t):
        """[..., 16, W] -> [..., 64, W / 4]: cell c takes the slots of
        columns 4c .. 4c + 3 in that order."""
        *lead, k, w = t.shape
        return t.reshape(*lead, k, w // 4, 4).movedim(-1, -3) \
            .reshape(*lead, 4 * k, w // 4).contiguous()

    if W % 4:
        fail(f"cannot fold {W} columns in quads")
    W4 = W // 4
    pad_rows = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    ST4, M94, sw4, D104 = fold4(ST), fold4(M9), [fold4(v) for v in sw], \
        fold4(D10)
    mk4 = dict(mk, nx=W4 - 2)
    x4, y4, vx4, vy4, m4, oc4 = M94.unbind(1)[:6]
    D44 = torch.stack([x4, y4, m4, oc4], 1)
    rho4 = SK.density(D44, **dk)
    rp4 = pad_rows(rho4)
    D84 = torch.stack([x4, y4, vx4, vy4, m4, rp4, fl.eos(rp4), oc4], 1)
    got4 = {"migrate": SK.migrate(ST4, **mk4),
            "pair_sweep": SK.pair_sweep(M94, **sk), "density": rho4,
            "force": SK.force(D84, **fk)}
    ref4 = {"migrate": SK.migrate_plain(ST4, **mk4),
            "pair_sweep": SK.pair_sweep_plain(M94, **sk),
            "density": SK.density_plain(D44, **dk),
            "force": SK.force_plain(D84, **fk)}
    o4 = (oc4 > 0)[1:-1]
    fscale4 = float(torch.stack(ref4["pair_sweep"][1:]).abs().max())

    def rel4(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30))[o4].max())

    def misses4(out, ref):
        return sum(int(((a - b).abs() > 1e-5 * b.abs() + 1e-6 * fscale4)
                       .sum()) for a, b in zip(out, ref))

    pair4 = {"migrate": same_bits(got4["migrate"], ref4["migrate"]),
             "pair_sweep": rel4(got4["pair_sweep"][0],
                                ref4["pair_sweep"][0]) <= 1e-5 and
             misses4(got4["pair_sweep"][1:], ref4["pair_sweep"][1:]) == 0,
             "density": rel4(rho4, ref4["density"]) <= 1e-5,
             "force": misses4(got4["force"], ref4["force"]) == 0}
    tup = lambda x: (x,) if torch.is_tensor(x) else tuple(x)
    for name in pair4:
        errs[name] = max(errs[name], *(max_err(u, v) for u, v in zip(
            tup(got4[name]), tup(ref4[name]))))
    fold4_ok = all(same_bits(a, b) for a, b in zip(
        got4["pair_sweep"], (rho4, *got4["force"])))
    n4 = int((oc4 > 0).sum())
    folded4 = {n: (c.reshape(rows, W4, 4).amax(-1).contiguous(),
                   f[..., 0::4].contiguous(), b)
               for n, (c, f, b) in cands.items()}
    upper4 = (D104[:, SK.D10_OCC, 2 * K:] > 0) & \
        (folded4["wall"][0] > 0)[:, None]
    outc4 = {}
    for cname, cand in folded4.items():
        o9, err9, _ = check_couple("coupling9", f"{cname}, K = 64 folded",
                                   SK.coupling9, (*cand, M94, *sw4), 4 * K)
        oc, errc, _ = check_couple("coupling", f"{cname}, K = 64 folded",
                                   SK.coupling, (*cand, D104), 4 * K)
        errs["coupling9"] = max(errs["coupling9"], err9)
        errs["coupling"] = max(errs["coupling"], errc)
        st_c = torch.stack([*oc[:6], M94[:, SK.M9_M], M94[:, SK.M9_ID],
                            M94[:, SK.M9_OCC]], 1)
        st_c[0] = st_c[-1] = 0.0
        fold4_ok = fold4_ok and same_bits(o9[0], st_c) and \
            same_bits(o9[1], oc[6]) and same_bits(o9[2], oc[7])
        outc4[cname] = oc
    xw, yw = outc4["wall"][:2]
    moved4 = ((xw != D104[:, SK.D10_X]) | (yw != D104[:, SK.D10_Y])) \
        [:, 2 * K:] & upper4
    twins["k64_full_slots"] = fold4_ok
    print(f"all six kernels at K = 64 (column quads folded): {n4} "
          f"particles, up to {int((oc4 > 0).sum(1).max())} in a cell; "
          f"against their plain versions {pair4} (migrate to the bit); "
          f"pair sweep = density + EOS + force and coupling9 = coupling to "
          f"the bit {fold4_ok}; {int(upper4.sum())} coupled particles in "
          f"slots 32-63, {int(moved4.sum())} of them moved by the wall",
          flush=True)
    if not all(pair4.values()) or not fold4_ok or int(moved4.sum()) == 0:
        fail("the kernels at K = 64 with live slots 32-63 disagree with "
             "their plain versions or twins, or coupled no particle there")

    # the six kernels' times at K = 64 on the folded inputs
    main94 = (*folded4["main"], M94, *sw4)
    main104 = (*folded4["main"], D104)
    calls64 = {
        "migrate": (lambda: SK.migrate(ST4, **mk4),
                    lambda: SK.migrate_plain(ST4, **mk4)),
        "pair_sweep": (lambda: SK.pair_sweep(M94, **sk),
                       lambda: SK.pair_sweep_plain(M94, **sk)),
        "coupling9": (lambda: SK.coupling9(*main94, cn=ck),
                      lambda: SK.coupling9_plain(*main94, cn=ck)),
        "density": (lambda: SK.density(D44, **dk),
                    lambda: SK.density_plain(D44, **dk)),
        "force": (lambda: SK.force(D84, **fk),
                  lambda: SK.force_plain(D84, **fk)),
        "coupling": (lambda: SK.coupling(*main104, cn=ck),
                     lambda: SK.coupling_plain(*main104, cn=ck)),
    }
    occ4m = M94[:, SK.M9_OCC] > 0
    pairs4 = neighbour_pairs(occ4m.to(torch.int32))
    bounds64 = {
        "migrate": bound(slot_bytes("migrate", ST4[:, SK.ST_OCC],
                                    (got4["migrate"],)),
                         MIGRATE_OPS * float((ST4[:, SK.ST_OCC] > 0).sum())),
        "pair_sweep": bound(slot_bytes("pair_sweep", M94[:, SK.M9_OCC],
                                       got4["pair_sweep"]),
                            PAIR_OPS * pairs4),
        "coupling9": bound(coupling9_bytes(*main94[:4],
                                           calls64["coupling9"][0]()),
                           cpl_ops(main94[0], occ4m)),
        "density": bound(slot_bytes("density", D44[:, 3], (rho4,)),
                         DENSITY_OPS * pairs4),
        "force": bound(slot_bytes("force", D84[:, SK.D8_OCC],
                                  got4["force"]), FORCE_OPS * pairs4),
        "coupling": bound(coupling_bytes(*main104,
                                         calls64["coupling"][0]()),
                          cpl_ops(main104[0], occ4m)),
    }
    k64 = {}
    for name, (kern, plain) in calls64.items():
        k64[name] = dict(ms=cuda_ms(kern), warm_ms=cuda_ms(kern, cold=False),
                         plain_ms=cuda_ms(plain, 5),
                         bound_ms=bounds64[name][0],
                         bound_by=bounds64[name][1])
        print(f"kernel {name} at K = 64 (folded, main path candidates): "
              f"kernel {k64[name]['ms']:.4f} ms "
              f"({k64[name]['warm_ms']:.4f} warm)  plain "
              f"{k64[name]['plain_ms']:.4f} ms  bound "
              f"{k64[name]['bound_ms']:.4f} ms ({k64[name]['bound_by']})",
              flush=True)

    main9 = (*cands["main"], M9, *sw)
    wall9 = (*cands["wall"], M9, *sw)
    main10 = (*cands["main"], D10)
    wall10 = (*cands["wall"], D10)
    calls = {   # name -> (kernel, plain version) on the same inputs
        "migrate": (lambda: SK.migrate(ST, **mk),
                    lambda: SK.migrate_plain(ST, **mk)),
        "pair_sweep": (lambda: SK.pair_sweep(M9, **sk),
                       lambda: SK.pair_sweep_plain(M9, **sk)),
        "coupling9": (lambda: SK.coupling9(*main9, cn=ck),
                      lambda: SK.coupling9_plain(*main9, cn=ck)),
        "density": (lambda: SK.density(D4, **dk),
                    lambda: SK.density_plain(D4, **dk)),
        "force": (lambda: SK.force(D8, **fk),
                  lambda: SK.force_plain(D8, **fk)),
        "coupling": (lambda: SK.coupling(*main10, cn=ck),
                     lambda: SK.coupling_plain(*main10, cn=ck)),
        "coupling9_wall": (lambda: SK.coupling9(*wall9, cn=ck),
                           lambda: SK.coupling9_plain(*wall9, cn=ck)),
        "coupling_wall": (lambda: SK.coupling(*wall10, cn=ck),
                          lambda: SK.coupling_plain(*wall10, cn=ck)),
    }
    times = {name: (cuda_ms(k), cuda_ms(p, 5)) for name, (k, p) in
             calls.items()}
    warm = {name: cuda_ms(k, cold=False) for name, (k, _) in calls.items()}
    n_occ = float(occ.sum())
    pairs = neighbour_pairs(occ.to(torch.int32))

    cpl, live = cands["main"][0], cands["wall"][0]
    bounds = {
        "migrate": bound(slot_bytes("migrate", ST[:, SK.ST_OCC], (M9,)),
                         MIGRATE_OPS * n_occ),
        "pair_sweep": bound(slot_bytes("pair_sweep", M9[:, SK.M9_OCC], sw),
                            PAIR_OPS * pairs),
        "coupling9": bound(coupling9_bytes(*main9[:4],
                                           outs["coupling9", "main"]),
                           cpl_ops(cpl)),
        "density": bound(slot_bytes("density", D4[:, 3], (rho,)),   # occ
                         DENSITY_OPS * pairs),
        "force": bound(slot_bytes("force", D8[:, SK.D8_OCC], frc),
                       FORCE_OPS * pairs),
        "coupling": bound(coupling_bytes(*main10, outs["coupling", "main"]),
                          cpl_ops(cpl)),
        "coupling9_wall": bound(coupling9_bytes(*wall9[:4],
                                                outs["coupling9", "wall"]),
                                cpl_ops(live)),
        "coupling_wall": bound(coupling_bytes(*wall10,
                                              outs["coupling", "wall"]),
                               cpl_ops(live)),
    }
    for name in bounds:
        base = name.removesuffix("_wall")
        what = "" if not base.startswith("coupling") else \
            " (moved wall: every occupied cell couples)" if base != name \
            else " (main path inputs: every cell copies through)"
        print(f"kernel {base}: max_abs_err {errs[base]:.3e}  "
              f"kernel {times[name][0]:.4f} ms ({warm[name]:.4f} warm)  "
              f"plain {times[name][1]:.4f} ms  bound {bounds[name][0]:.4f} ms"
              f" ({bounds[name][1]}){what}", flush=True)
    return errs, times, bounds, twins, k64


COMPARE_REPS = 50        # launches a kernel is timed over in kernel_times


def kernel_times(root: Path) -> dict:
    """Time the SPH kernels of the lpe_tpu_torch package under ``root`` on
    the inputs of check_kernels (coupling9 and coupling on both candidate
    sets), and the grid narrowphase on RIGID_STACKS 10k's rows 10 ticks
    in: ms a launch with L2 flushed before each (``ms``) and back to back
    (``warm``), COMPARE_REPS launches each, and a hash of each kernel's
    output bytes (``bits``)."""
    import hashlib
    sys.path.insert(0, str(root))
    import torch
    from lpe_tpu_torch.ops import _build
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.ops import sph_kernels as SK

    _build.library()
    dev = torch.device("cuda", 0)
    _, fl, state, ST = dam_sub_step(dev)
    inp = sub_step_inputs(SK, fl, state, ST)
    M9, sw, ck = inp["M9"], inp["sw"], fl.couple_consts
    calls = {"migrate": lambda: SK.migrate(ST, **fl.migrate_consts),
             "pair_sweep": lambda: SK.pair_sweep(M9, **fl.sweep_consts),
             "density": lambda: SK.density(inp["D4"], **fl.density_consts),
             "force": lambda: SK.force(inp["D8"], **fl.force_consts)}
    for name, c in inp["cands"].items():
        calls[f"coupling9_{name}"] = lambda c=c: SK.coupling9(*c, M9, *sw,
                                                              cn=ck)
        calls[f"coupling_{name}"] = lambda c=c: SK.coupling(*c, inp["D10"],
                                                            cn=ck)
    _, rrun, rstate = rigid_run(dev, BLOCK)
    nargs, kw, _ = rrun.systems["rigid"].narrowphase_args(rstate)
    calls["narrowphase_grid"] = lambda: RK.narrowphase_grid(*nargs, **kw)
    ms = {name: cuda_ms(fn, COMPARE_REPS) for name, fn in calls.items()}
    warm = {name: cuda_ms(fn, COMPARE_REPS, cold=False)
            for name, fn in calls.items()}
    bits = {}
    for name, fn in calls.items():
        out = fn()
        h = hashlib.sha256()
        for t in out if isinstance(out, (tuple, list)) else (out,):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        bits[name] = h.hexdigest()[:16]
    return {"root": str(root), "card": torch.cuda.get_device_name(0),
            "ms": ms, "warm": warm, "bits": bits}


def compare(trees: list) -> None:
    """Time the SPH kernels and the grid narrowphase of other trees (each
    another checkout: ``git archive`` of the parent commit, or a copy of
    this one with a kernel's constant changed, in a directory that
    .gitignore lists) and of this checkout, alternated on one card: one
    process a run, in the order trees, this, this, trees reversed
    (parent, this, this, parent for one tree), each building its tree's
    kernels and running kernel_times.
    Prints each run's line, each tree's mean, and whether each kernel's
    outputs had the same bits in all runs."""
    runs = []
    for root in [*trees, ROOT, ROOT, *reversed(trees)]:
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--kernel-times", str(root)],
                           capture_output=True, text=True, cwd=str(root),
                           timeout=900)
        if r.returncode != 0:
            fail(f"kernel times of {root}: exit {r.returncode}\n"
                 f"{r.stderr[-4000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({k: line[k] for k in ("root", "card", "ms",
                                                "warm")}), flush=True)
        runs.append(line)
    for root in (*trees, ROOT):
        label = "this tree" if root == ROOT else "other tree"
        got = [x for x in runs if x["root"] == str(root)]
        for key, how in (("ms", "L2 flushed"), ("warm", "warm")):
            mean = {k: sum(g[key][k] for g in got) / len(got)
                    for k in got[0][key]}
            print(f"{label} ({root}): mean ms, {how}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in mean.items()), flush=True)
    same = {k: len({x["bits"][k] for x in runs}) == 1
            for k in runs[0]["bits"]}
    print(f"the same output bits in all {len(runs)} runs: " + ", ".join(
        f"{k} {v}" for k, v in same.items()), flush=True)


def fluid_cfg(cfg, **kw):
    """``cfg`` with fields of its FluidConfig replaced."""
    import dataclasses
    return cfg.replace(fluid=dataclasses.replace(cfg.fluid, **kw))


def run_dam(dev, card, want, blocks=3, **fluid_kw):
    """DAM_BREAK 100k through build_run_fn with ``fluid_kw`` set in its
    FluidConfig: launches counted over ``blocks`` blocks after a warm-up
    block and held to ``want`` (launches per sub-step by kernel name;
    every other kernel must not launch, and no plain version may run)."""
    import torch
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    from lpe_tpu_torch.systems import build_run_fn

    label = f"dam {DAM_N} {fluid_kw or 'default'}"
    sc = build_dam_break(DAM_N, device=dev)
    cfg = fluid_cfg(sc.cfg, **fluid_kw)
    run = build_run_fn(sc.spec, cfg, ticks=BLOCK, device=dev)
    state = run(sc.state)                       # warm-up block
    torch.cuda.synchronize()
    SK.reset_counters()
    t0 = time.perf_counter()
    for _ in range(blocks):
        state = run(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {op.name: op.launches for op in SK.OPS}
    plain = {op.name: op.plain_calls for op in SK.OPS}
    per_step = blocks * BLOCK * SUBSTEPS
    expect = {name: want.get(name, 0) * per_step for name in launches}
    if launches != expect or max(plain.values()) != 0:
        fail(f"{label}: launches {launches}, expected {expect}; plain calls "
             f"{plain}")
    liq = sc.spec.liquid_slice
    if not bool(torch.isfinite(state.bodies.pos).all()) or \
            not bool(torch.isfinite(state.bodies.vel).all()):
        fail(f"{label}: non-finite state")
    if int(state.tick) != BLOCK * (blocks + 1):
        fail(f"{label}: tick counter {int(state.tick)}")
    tps = blocks * BLOCK / dt
    ymean = float(state.bodies.pos[liq, 1].mean())
    print(f"{label}: {tps:.2f} ticks/s over {blocks} blocks of {BLOCK} "
          f"(host clock, synchronized) on {card}; launches {launches}; "
          f"fluid y-mean {ymean:.4f}", flush=True)
    return launches, run, state, sc


def check_split_tick(dev, sc, state):
    """One tick of the split resident path against one of the default
    stacked path, from the same state: lpe_tpu's resident-vs-scatter
    tolerances (tests/test_sph.py: pos 1e-4 m, rho rel 1e-3)."""
    from lpe_tpu_torch.systems import build_run_fn
    liq = sc.spec.liquid_slice
    ends = [build_run_fn(sc.spec, fluid_cfg(sc.cfg, pair_backend=pb),
                         ticks=1, device=dev)(state).bodies
            for pb in ("pallas", "auto")]
    dpos = max_err(ends[0].pos[liq], ends[1].pos[liq])
    rho_rel = float(((ends[0].density[liq] - ends[1].density[liq]).abs()
                     / ends[1].density[liq].abs().clamp(min=1e-30)).max())
    bitwise = all(same_bits(getattr(ends[0], f)[liq], getattr(ends[1], f)[liq])
                  for f in ("pos", "vel", "density", "pressure"))
    print(f"dam {DAM_N}: one tick, split resident vs stacked: max |dpos| "
          f"{dpos:.3e} m, rho rel {rho_rel:.3e}; bitwise equal {bitwise}",
          flush=True)
    if dpos > 1e-4 or rho_rel > 1e-3:
        fail("the split resident tick differs from the stacked tick")
    return bitwise


def run_dam_k64(dev, sc, state):
    """Phase 6d: DAM_BREAK 100k built on the card at fluid.grid.max_per_cell
    = 64, the reference's cap, on the stacked and the split path: one tick
    (SUBSTEPS sub-steps) from ``state``, each kernel of the path launched
    once a sub-step at K = 64 and no plain version, the state finite. Beside
    it one tick at K = 16 from the same state: where no cell overflows 16
    slots during the tick the two agree to the bit. Returns whether they
    did, by path."""
    import dataclasses
    import torch
    from lpe_tpu_torch.core.telemetry import capacity_report
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.systems import build_run_fn

    liq = sc.spec.liquid_slice
    grid64 = dataclasses.replace(sc.cfg.fluid.grid, max_per_cell=64)
    fullest = capacity_report(state, sc.spec, sc.cfg)["fluid_cell_slots"]
    same = {}
    for label, kw, want in (
            ("stacked", {}, ("migrate", "pair_sweep", "coupling9")),
            ("split", dict(pair_backend="pallas"),
             ("migrate", "density", "force", "coupling"))):
        ends = {}
        for k, grid_kw in ((64, dict(grid=grid64)), (16, {})):
            run = build_run_fn(sc.spec, fluid_cfg(sc.cfg, **kw, **grid_kw),
                               ticks=1, device=dev)
            SK.reset_counters()
            ends[k] = run(state).bodies
            torch.cuda.synchronize()
            launches = {op.name: op.launches for op in SK.OPS if op.launches}
            slots = run.systems["fluid"].grid_build(state)["occ"].shape[1]
            if launches != dict.fromkeys(want, SUBSTEPS) or slots != k or \
                    any(op.plain_calls for op in SK.OPS):
                fail(f"dam K = {k} {label}: launches {launches}, {slots} "
                     f"slots a cell")
        a, b = ends[64], ends[16]
        if not bool(torch.isfinite(a.pos).all()) or \
                not bool(torch.isfinite(a.vel).all()):
            fail(f"dam K = 64 {label}: non-finite state")
        same[label] = all(same_bits(getattr(a, f)[liq], getattr(b, f)[liq])
                          for f in ("pos", "vel", "density", "pressure"))
        print(f"dam {DAM_N} built at max_per_cell 64 ({label}): one tick, "
              f"launches {dict.fromkeys(want, SUBSTEPS)} at K = 64; against "
              f"the same tick at K = 16 (the fullest cell holds "
              f"{fullest['max']} particles before it): max |dpos| "
              f"{max_err(a.pos[liq], b.pos[liq]):.3e} m, bitwise equal "
              f"{same[label]}", flush=True)
    return same


def run_dam_scatter(dev, card):
    """Phase 6b: the per-tick scatter step with the split pair kernels, 10
    ticks twice from the initial state: launches, bitwise repeatability.
    Then the pair sweep's second caller: one scatter tick from the state
    those runs reach with the sweep (the default pair backend: a fresh grid
    with zero hx, hy and id planes every sub-step) must equal one with
    density + EOS + force to the bit. Returns whether it did."""
    import torch
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    from lpe_tpu_torch.systems import build_run_fn

    sc = build_dam_break(DAM_N, device=dev)
    cfg = fluid_cfg(sc.cfg, residency="off", pair_backend="pallas")
    run = build_run_fn(sc.spec, cfg, ticks=BLOCK, device=dev)
    if hasattr(run.systems["fluid"], "grid_build"):
        fail("dam scatter: the fluid step is a resident one")
    finals = []
    for rep in range(2):
        torch.cuda.synchronize()
        SK.reset_counters()
        t0 = time.perf_counter()
        state = run(sc.state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        finals.append(state.bodies)
        launches = {op.name: op.launches for op in SK.OPS}
        plain = {op.name: op.plain_calls for op in SK.OPS}
        expect = dict.fromkeys(launches, 0)
        expect["density"] = expect["force"] = BLOCK * SUBSTEPS
        if launches != expect or max(plain.values()) != 0:
            fail(f"dam scatter: launches {launches}, expected {expect}; "
                 f"plain calls {plain}")
        if not bool(torch.isfinite(state.bodies.pos).all()) or \
                int(state.tick) != BLOCK:
            fail("dam scatter: non-finite positions or a wrong tick counter")
        print(f"dam {DAM_N} scatter + split pair kernels, run {rep}: "
              f"{BLOCK / dt:.2f} ticks/s over {BLOCK} ticks (host clock, "
              f"synchronized{', first run' if rep == 0 else ''}) on {card}; "
              f"launches {launches}", flush=True)
    for name in ("pos", "vel", "density", "pressure"):
        if not torch.equal(getattr(finals[0], name),
                           getattr(finals[1], name)):
            fail(f"dam scatter: two runs from one state differ in {name}")
    print("dam scatter: two 10-tick runs are bitwise equal", flush=True)

    liq = sc.spec.liquid_slice
    ends = {}
    for pb in ("auto", "pallas"):
        one = build_run_fn(sc.spec, fluid_cfg(sc.cfg, residency="off",
                                              pair_backend=pb),
                           ticks=1, device=dev)
        SK.reset_counters()
        ends[pb] = one(state).bodies
        torch.cuda.synchronize()
        launches = {op.name: op.launches for op in SK.OPS if op.launches}
        want = {"pair_sweep": SUBSTEPS} if pb == "auto" else \
            {"density": SUBSTEPS, "force": SUBSTEPS}
        if launches != want or any(op.plain_calls for op in SK.OPS):
            fail(f"dam scatter {pb}: launches {launches}, expected {want}")
    bitwise = all(same_bits(getattr(ends["auto"], f)[liq],
                            getattr(ends["pallas"], f)[liq])
                  for f in ("pos", "vel", "density", "pressure"))
    dpos = max_err(ends["auto"].pos[liq], ends["pallas"].pos[liq])
    print(f"dam {DAM_N} scatter: one tick with the pair sweep vs density + "
          f"force: max |dpos| {dpos:.3e} m; bitwise equal {bitwise}",
          flush=True)
    if not bitwise:
        fail("the scatter step's pair sweep differs from density + EOS + "
             "force")
    return bitwise


def run_simple_fluid(dev, card, reps=2, **fluid_kw):
    """Phases 5 and 6c: SIMPLE_FLUID through build_tick_fn, 120 ticks,
    ``reps`` times from seed 0 (two runs must be bitwise equal)."""
    import torch
    from lpe_tpu_torch.core.constants import SimulationType
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems import build_tick_fn

    finals = []
    label = f"simple_fluid {fluid_kw or 'default'}"
    for rep in range(reps):
        sc = create_scenario(SimulationType.SIMPLE_FLUID, seed=0, device=dev)
        tick = build_tick_fn(sc.spec, fluid_cfg(sc.cfg, **fluid_kw),
                             device=dev)
        SK.reset_counters()
        liq = sc.spec.liquid_slice
        s = sc.state
        y0 = float(s.bodies.pos[liq, 1].mean())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(120):
            s = tick(s)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        y1 = float(s.bodies.pos[liq, 1].mean())
        finals.append(s)
        launches = {op.name: op.launches for op in SK.OPS if op.launches}
        print(f"{label} run {rep}: y-mean {y0:.4f} -> {y1:.4f} after "
              f"120 ticks, {120 / dt:.2f} ticks/s (host clock, "
              f"synchronized, per-tick calls) on {card}; launches "
              f"{launches}", flush=True)
        if not bool(torch.isfinite(s.bodies.pos).all()):
            fail(f"{label}: non-finite positions")
        if not (abs(y0 - 3.0) < 0.05 and 4.5 < y1 < 5.95):
            fail(f"{label}: y-mean {y0} -> {y1}, expected 3.0 -> ~5.5")
        split = fluid_kw.get("pair_backend") == "pallas"
        want = ("migrate", "density", "force", "coupling") if split else \
            ("migrate", "pair_sweep", "coupling9")
        if set(launches) != set(want) or \
                set(launches.values()) != {120 * SUBSTEPS} or \
                any(op.plain_calls for op in SK.OPS):
            fail(f"{label}: launches {launches}")
    if reps < 2:
        return
    a, b = finals
    for name in ("pos", "vel", "density", "pressure"):
        if not torch.equal(getattr(a.bodies, name), getattr(b.bodies, name)):
            fail(f"simple_fluid: two runs from one seed differ in {name}")
    print("simple_fluid: two runs from seed 0 are bitwise equal", flush=True)


def rigid_run(dev, ticks, backend="auto"):
    """RIGID_STACKS 10k from seed 0 through build_run_fn(ticks=10), with
    the rigid narrowphase_backend ``backend``."""
    import dataclasses
    from lpe_tpu_torch.scenarios.bench_scenes import build_rigid_stacks
    from lpe_tpu_torch.systems import build_run_fn
    sc = build_rigid_stacks(RIGID_N, seed=0, device=dev)
    cfg = sc.cfg.replace(rigid=dataclasses.replace(
        sc.cfg.rigid, narrowphase_backend=backend))
    run = build_run_fn(sc.spec, cfg, ticks=BLOCK, device=dev)
    state = sc.state
    for _ in range(ticks // BLOCK):
        state = run(state)
    return sc, run, state


def run_rigid(dev, card):
    """Phase 7: RIGID_STACKS 10k, counted launches, saturation, ticks/s and
    the guard's host reads, and bitwise repeatability."""
    import torch
    from lpe_tpu_torch.core.telemetry import capacity_report
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.systems.rigid.grid_pipeline import grid_dims

    sc, run, state = rigid_run(dev, 0)
    rep0 = capacity_report(state, sc.spec, sc.cfg)
    state = run(state)                           # warm-up block
    S = sc.spec.n_solid
    gd = grid_dims(sc.spec, sc.cfg)
    rows = gd["NC"] * gd["R"]
    print(f"rigid {RIGID_N}: {S} solids, grid {gd['nbx']}x{gd['nbx']} cells "
          f"of {gd['KB']} slots, class caps {gd['caps']}, {rows} "
          f"narrowphase rows a tick", flush=True)
    step = run.systems["rigid"]
    blocks = 3
    torch.cuda.synchronize()
    RK.reset_counters()
    step.guard_reads = step.rebuilds = 0
    t0 = time.perf_counter()
    for _ in range(blocks):
        state = run(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = RK.narrowphase_grid.launches
    plain = sum(op.plain_calls for op in RK.OPS)
    ticks = blocks * BLOCK
    if launches != ticks or plain != 0 or RK.narrowphase.launches != 0:
        fail(f"rigid: narrowphase_grid launches {launches}, row-form "
             f"narrowphase launches {RK.narrowphase.launches}, plain calls "
             f"{plain} in {ticks} ticks")
    pos = state.bodies.pos[:S]
    dyn = ~state.bodies.boundary[:S]
    size = sc.cfg.shared.universe_size_m
    if not bool(torch.isfinite(pos).all()):
        fail("rigid: non-finite positions")
    if not bool(((pos[dyn] >= 0.0) & (pos[dyn] <= size)).all()):
        fail("rigid: a body left the tank")
    y0 = float(sc.state.bodies.pos[:S][dyn, 1].mean())
    y1 = float(pos[dyn, 1].mean())
    if not y1 > y0:
        fail(f"rigid: mean y {y0} -> {y1} did not rise")
    rep = capacity_report(state, sc.spec, sc.cfg)
    for tick, r in ((0, rep0), (int(state.tick), rep)):
        print(f"rigid {RIGID_N} capacities at tick {tick}: bodies per cell "
              f"max {r['rigid_grid_slots']['max']} of {gd['KB']}, dropped "
              f"frac {r['rigid_grid_slots']['frac']:.4f}; candidate rows "
              f"frac {r['rigid_grid_rows']['frac']:.4f}, max per class "
              f"{r['rigid_grid_rows']['max']}", flush=True)
    if rep["rigid_grid_slots"]["frac"] > RIGID_MAX_DROP:
        fail(f"rigid: {rep['rigid_grid_slots']} bodies dropped from the grid")
    tps = ticks / dt
    print(f"rigid {RIGID_N}: {tps:.2f} ticks/s over {blocks} blocks of "
          f"{BLOCK} (host clock, synchronized) on {card}; narrowphase_grid "
          f"launches {launches}, plain calls {plain}; guard host reads "
          f"{step.guard_reads / ticks:.2f} a tick, rebuilds {step.rebuilds} "
          f"of {ticks} ticks; mean y {y0:.4f} -> {y1:.4f}", flush=True)

    finals = [rigid_run(dev, 30)[2] for _ in range(2)]
    for name in ("pos", "vel", "angle", "omega"):
        if not torch.equal(getattr(finals[0].bodies, name),
                           getattr(finals[1].bodies, name)):
            fail(f"rigid: two 30-tick runs from one seed differ in {name}")
    print("rigid: two 30-tick runs from seed 0 are bitwise equal", flush=True)
    # the same block with narrowphase_backend="xla": the plain gathers and
    # geometry in place of the grid kernel, the same state to the bit
    RK.reset_counters()
    xla = rigid_run(dev, 30, backend="xla")[2]
    if any(op.launches for op in RK.OPS):
        fail("rigid xla: a narrowphase kernel launched")
    differ = [name for part in ("", "bodies")
              for name, a, b in state_fields(finals[0], xla, part)
              if not tensor_bits_equal(a, b)]
    print(f"rigid: 30 ticks with the grid narrowphase kernel vs "
          f"narrowphase_backend='xla': every state field bitwise equal "
          f"{not differ}", flush=True)
    if differ:
        fail(f"rigid: the grid kernel's 30 ticks differ from xla's in "
             f"{differ}")
    return launches, run, state, not differ, sc


def check_narrowphase(state, run):
    """Phase 8: at the rigid-10k rows of ``state``, the row-form
    narrowphase kernel against its plain version, with the tolerances of
    the JAX package's Pallas-vs-XLA test (tests/test_pallas_rigid.py:52-65),
    and the grid kernel (the tick's) against its plain version to the bit
    on every candidate row; both timed. Returns (max abs err, times, bound)
    of each, by name."""
    import torch
    from lpe_tpu_torch.ops import rigid_kernels as RK
    nargs, kw, valid = run.systems["rigid"].narrowphase_args(state)
    a, b = RK.grid_rows(*nargs, **kw)
    args = (*a, *b)
    got = RK.narrowphase(*args)
    ref = RK.narrowphase_plain(*args)
    if not torch.equal(got[0], ref[0]) or not torch.equal(got[5], ref[5]):
        fail("narrowphase: hit or contact masks differ from the plain "
             "version")
    pen_k, pen_p = got[2], ref[2]
    fin = torch.isfinite(pen_p)
    if not torch.equal(fin, torch.isfinite(pen_k)):
        fail("narrowphase: the rows of infinite depth differ")
    cv = ref[5]
    err = {"nrm": max_err(got[1], ref[1]),
           "pen": max_err(pen_k[fin], pen_p[fin]),
           "pts": max_err(got[3][cv], ref[3][cv]),
           "pens": max_err(got[4][cv], ref[4][cv])}
    n_rows, n_hit = ref[0].numel(), int(ref[0].sum())
    print(f"narrowphase: {n_rows} rows, {n_hit} hits, {int(cv.sum())} "
          f"contacts; max abs err {err}", flush=True)
    if max(err["nrm"], err["pen"]) > 1e-5 or \
            max(err["pts"], err["pens"]) > 1e-4:
        fail("narrowphase differs from its plain version")
    out = {}
    times = (cuda_ms(lambda: RK.narrowphase(*args)),
             cuda_ms(lambda: RK.narrowphase_plain(*args), 5))
    warm = cuda_ms(lambda: RK.narrowphase(*args), cold=False)
    # operations this data needs per row, by the rings' vertex counts n =
    # na + nb: n^2 projections of 3 each, ~24 per vertex for the world ring,
    # centroid and face normals, ~40 for the clip
    n = (args[3] + args[7]).double().clamp(min=0)
    ops = float((3 * n * n + 24 * n + 40).sum())
    out["narrowphase"] = (max(err.values()), times,
                          bound(nbytes(*args, *got), ops))
    print(f"kernel narrowphase: max_abs_err {max(err.values()):.3e}  kernel "
          f"{times[0]:.4f} ms ({warm:.4f} warm)  plain {times[1]:.4f} ms  "
          f"bound {out['narrowphase'][2][0]:.4f} ms "
          f"({out['narrowphase'][2][1]})", flush=True)

    # the grid kernel: every output of every candidate row to the bit (and
    # of every row, printed), then its time against the plain version's
    got = RK.narrowphase_grid(*nargs, **kw)
    ref = RK.narrowphase_grid_plain(*nargs, **kw)
    v = valid.reshape(-1)
    names = ("hit", "nrm", "pen", "pts", "pens", "cval", "pos_a", "pos_b")
    on_valid = [nm for nm, g, r in zip(names, got, ref)
                if not tensor_bits_equal(g[v], r[v])]
    on_all = all(tensor_bits_equal(g, r) for g, r in zip(got, ref))

    def row_err(g, r):
        """Max abs error over the candidate rows where r is finite."""
        ok = v & torch.isfinite(r).reshape(len(v), -1).all(-1)
        return max_err(g[ok], r[ok]) if bool(ok.any()) else 0.0

    gerr = max(row_err(g, r) for g, r in zip(got, ref)
               if g.is_floating_point())
    print(f"narrowphase_grid: {int(v.sum())} candidate rows of {len(v)}: "
          f"outputs differing from the plain version {on_valid or 'none'}; "
          f"all rows bitwise equal {on_all}", flush=True)
    if on_valid:
        fail(f"narrowphase_grid differs from its plain version in "
             f"{on_valid}")
    grid = lambda: RK.narrowphase_grid(*nargs, **kw)
    gtimes = (cuda_ms(grid), cuda_ms(
        lambda: RK.narrowphase_grid_plain(*nargs, **kw), 5))
    gwarm = cuda_ms(grid, cold=False)
    # operations: each body's ring once (~24 a vertex), then per row the
    # n^2 projections of 3 each and ~40 for the clip
    nb = (a[3] + b[3]).double().clamp(min=0)
    bodies = float(nargs[3].double().sum() + nargs[7].double().sum())
    gops = 24 * bodies + float((3 * nb * nb + 40).sum())
    out["narrowphase_grid"] = (gerr, gtimes,
                               bound(nbytes(*nargs, *got), gops))
    print(f"kernel narrowphase_grid: max_abs_err {gerr:.3e}  kernel "
          f"{gtimes[0]:.4f} ms ({gwarm:.4f} warm)  plain {gtimes[1]:.4f} ms"
          f"  bound {out['narrowphase_grid'][2][0]:.4f} ms "
          f"({out['narrowphase_grid'][2][1]})", flush=True)
    return out


def couple_ops(cpl, fld, big, occ, V):
    """Operations of the candidate math on these inputs: each live
    particle of a cell that couples (cpl > 0) against its cell's live
    candidates (fld) and the live big solids (big)."""
    from lpe_tpu_torch.ops import sph_kernels as SK
    per_cell = (fld[:, :, SK.RW_M, :] > 0).sum(1) + \
        int((big[:, SK.RW_M] > 0).sum())                  # [rows, cols]
    live = (occ & (cpl > 0)[:, None, :]).sum(1)
    return float((live * per_cell).sum()) * (CPL_OPS_PER_VERT * V + CPL_OPS)


def path_kernels(run, cfg):
    """The SPH kernels a block of ``run`` (built with ``cfg``) launches each
    sub-step: the stacked chain for a resident fluid, the split kernels
    with pair_backend "pallas" (the coupling kernel only with rigid rows);
    the pair sweep, or density and force, for the scatter step; none
    without a fluid."""
    fl = run.systems.get("fluid")
    if fl is None:
        return ()
    split = cfg.fluid.pair_backend == "pallas"
    if not hasattr(fl, "grid_build"):
        return ("density", "force") if split else ("pair_sweep",)
    cpl = (("coupling",) if split else ("coupling9",)) \
        if hasattr(fl, "coupling_inputs") else ()
    return ("migrate",) + (("density", "force") if split else
                           ("pair_sweep",)) + cpl


def drive(dev, card, sc, label, cfg=None, settle=0, blocks=3):
    """``sc`` through build_run_fn(ticks=BLOCK): ``settle`` ticks, then
    ``blocks`` blocks timed on the host clock around synchronized blocks.
    Every kernel counter is set to 0 just before the timed blocks and
    read just after: the kernels of the path (path_kernels, and
    narrowphase_grid once a tick on the grid rigid pipeline) must have
    launched, no other kernel and no plain version; the bodies must stay
    finite. Returns (run, the settled state, the final state, launches,
    ticks/s)."""
    import torch
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.systems import build_run_fn
    cfg = cfg or sc.cfg
    run = build_run_fn(sc.spec, cfg, ticks=BLOCK, device=dev)
    state = sc.state
    for _ in range(settle // BLOCK):
        state = run(state)
    torch.cuda.synchronize()
    settled = state
    ops = (*SK.OPS, *RK.OPS)
    SK.reset_counters()
    RK.reset_counters()
    t0 = time.perf_counter()
    for _ in range(blocks):
        state = run(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ticks = blocks * BLOCK
    launches = {op.name: op.launches for op in ops if op.launches}
    want = dict.fromkeys(path_kernels(run, cfg), ticks * SUBSTEPS)
    if hasattr(run.systems.get("rigid"), "narrowphase_args"):
        want["narrowphase_grid"] = ticks
    if launches != want or any(op.plain_calls for op in ops):
        fail(f"{label}: launches {launches}, expected {want}; plain calls "
             f"{ {op.name: op.plain_calls for op in ops if op.plain_calls} }")
    for f in ("pos", "vel", "angle", "omega"):
        if not bool(torch.isfinite(getattr(state.bodies, f)).all()):
            fail(f"{label}: non-finite {f}")
    tps = ticks / dt
    print(f"{label}: {tps:.2f} ticks/s over {blocks} blocks of {BLOCK} "
          f"(host clock, synchronized) on {card}, after {settle} ticks; "
          f"launches {launches}", flush=True)
    return run, settled, state, launches, tps


def check_coupled_kernels(run, state, label, need_force=True):
    """coupling9 and coupling on the sub-step from ``state`` with the
    scene's own candidates (moving rigids couple), against their plain
    versions at the smoke's tolerances (couple_check), timed flushed
    (cuda_ms) and bounded; with ``need_force``, a rigid must take a
    nonzero force partial. Returns {name: (max abs err, (ms, plain ms),
    (bound ms, bound by))}."""
    from lpe_tpu_torch.ops import sph_kernels as SK
    fl = run.systems["fluid"]
    ST = fl.grid_stack(fl.grid_build(state))
    inp = sub_step_inputs(SK, fl, state, ST, wall=False)
    cand = inp["cands"]["main"]
    ck = fl.couple_consts
    M9 = inp["M9"]
    occ = M9[:, SK.M9_OCC] > 0
    out = {}
    for name, op, tail, nbytes_of in (
            ("coupling9", SK.coupling9, (M9, *inp["sw"]),
             lambda o: coupling9_bytes(*cand, M9, o)),
            ("coupling", SK.coupling, (inp["D10"],),
             lambda o: coupling_bytes(*cand, inp["D10"], o))):
        args = (*cand, *tail)
        res, err, contact = couple_check(name, label, op, args, ck,
                                         ST.shape[2])
        if need_force and contact == 0:
            fail(f"{name} ({label}): no particle coupled")
        times = (cuda_ms(lambda: op(*args, cn=ck)),
                 cuda_ms(lambda: op.plain(*args, cn=ck), 5))
        bnd = bound(nbytes_of(res), couple_ops(*cand, occ, ck["V"]))
        out[name] = (err, times, bnd)
        print(f"kernel {name} ({label}): max_abs_err {err:.3e}  kernel "
              f"{times[0]:.4f} ms  plain {times[1]:.4f} ms  bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return out


def run_coupled(dev, card):
    """Phases 10, 13 and 14: the coupled dam (100k particles + 300
    pentagons) in the default and the split configuration: 60 ticks to
    settle, then counted, timed blocks (drive); the fluid cells that couple
    with a dynamic rigid at the settled state (none: fail); the coupling
    kernels held and timed there. Then, in the default configuration, one
    block under set_sync_debug_mode("error") and two blocks from one state
    equal to the bit in every state field. Returns (launches by path,
    kernel results by name, the split configuration's (spec, cfg, settled
    state) for phase 23)."""
    from lpe_tpu_torch.scenarios.bench_scenes import build_coupled_dam
    sc = build_coupled_dam(*COUPLED, device=dev)
    print(f"coupled dam {COUPLED}: {sc.spec.n_solid} solids "
          f"({len(sc.spec.solid_big_idx)} big), {sc.spec.n_liquid} liquid",
          flush=True)
    paths, kern = {}, {}
    for label, kw in (("default", {}), ("split", dict(pair_backend="pallas"))):
        name = f"coupled dam {label}"
        run, settled, state, paths[f"coupled_{label}"], _ = drive(
            dev, card, sc, name, fluid_cfg(sc.cfg, **kw), settle=SETTLE)
        cells, dyn = run.systems["fluid"].coupled_cells(settled)
        print(f"{name}: after {SETTLE} ticks {cells} fluid cells couple, "
              f"{dyn} of them with a dynamic rigid (not a wall); rigid list "
              f"pipeline host reads {run.systems['rigid'].guard_reads}",
              flush=True)
        if dyn == 0:
            fail(f"{name}: no fluid cell couples with a dynamic rigid")
        if run.systems["rigid"].guard_reads:
            fail(f"{name}: the rigid step read back from the card")
        if label == "default":
            kern = check_coupled_kernels(run, settled, "coupled dam")
            drun, dstate = run, settled
        else:
            split = (sc.spec, fluid_cfg(sc.cfg, **kw), settled)
    no_sync_and_bitwise(drun, dstate, "coupled dam")
    return paths, kern, split


def run_north(dev, card):
    """Phase 12: the north star (100k particles + 10k polygons, the grid
    rigid pipeline) through build_run_fn: up to NORTH_SETTLE ticks, fewer
    when the next block would pass NORTH_BUDGET_S; counters set to 0
    before and read after: the stacked chain 10 times a tick, the grid
    narrowphase once a tick; coupling9 held and timed on the last state's
    sub-step. Returns (launches, kernel results)."""
    import torch
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.scenarios.bench_scenes import build_north_star
    from lpe_tpu_torch.systems import build_run_fn
    sc = build_north_star(*NORTH, device=dev)
    run = build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=dev)
    step = run.systems["rigid"]
    if not hasattr(step, "narrowphase_args"):
        fail("north star: not on the grid rigid pipeline")
    ops = (*SK.OPS, *RK.OPS)
    SK.reset_counters()
    RK.reset_counters()
    state, ticks, t0 = sc.state, 0, time.perf_counter()
    while ticks < NORTH_SETTLE:
        tb = time.perf_counter()
        state = run(state)
        torch.cuda.synchronize()
        ticks += BLOCK
        now = time.perf_counter()
        if now - t0 + (now - tb) > NORTH_BUDGET_S:
            break
    dt = time.perf_counter() - t0
    launches = {op.name: op.launches for op in ops if op.launches}
    want = dict.fromkeys(("migrate", "pair_sweep", "coupling9"),
                         ticks * SUBSTEPS)
    want["narrowphase_grid"] = ticks
    if launches != want or any(op.plain_calls for op in ops):
        fail(f"north star: launches {launches}, expected {want}; plain "
             f"calls { {op.name: op.plain_calls for op in ops} }")
    for f in ("pos", "vel", "angle", "omega"):
        if not bool(torch.isfinite(getattr(state.bodies, f)).all()):
            fail(f"north star: non-finite {f}")
    cells, dyn = run.systems["fluid"].coupled_cells(state)
    print(f"north star {NORTH}: {ticks} ticks of {NORTH_SETTLE} (budget "
          f"{NORTH_BUDGET_S:.0f} s) at {ticks / dt:.2f} ticks/s (host "
          f"clock, synchronized blocks, the first block's build included) "
          f"on {card}; launches {launches}; guard host reads "
          f"{step.guard_reads / ticks:.2f} a tick; {cells} fluid cells "
          f"couple, {dyn} with a dynamic rigid", flush=True)
    return launches, check_coupled_kernels(run, state, "north star"), \
        (sc.spec, sc.cfg, state)


def run_scenes(dev, card):
    """Phases 11 and 15: the highlight reel (circles and polygons, sleep,
    gas) and the four catalog scenes of the list pipeline, 60 ticks each
    through drive. Returns launches by scene."""
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.scenarios.bench_scenes import build_highlight_reel
    paths = {}
    sc = build_highlight_reel(*HIGHLIGHT, device=dev)
    paths["highlight"] = drive(dev, card, sc, f"highlight reel {HIGHLIGHT}",
                               blocks=LIST_TICKS // BLOCK)[3]
    for name in LIST_SCENES:
        sc = create_scenario(name, seed=0, device=dev)
        paths[name] = drive(dev, card, sc, name,
                            blocks=LIST_TICKS // BLOCK)[3]
    return paths


def exact_dv(state, step, cfg, idx):
    """The velocity change of one gravity tick on receivers ``idx`` by a
    float64 direct sum over all of the step's sources (step.masks), on the
    card, 64 receivers at a time."""
    import torch
    from lpe_tpu_torch.core.constants import REAL_G
    b = state.bodies
    src, rcv = step.masks(b)
    pos = b.pos.double()
    ms = torch.where(src, b.mass.double(), 0.0)
    soft2 = cfg.shared.gravitational_softener ** 2
    out = []
    for a in range(0, len(idx), 64):
        i = idx[a:a + 64]
        d = pos[None, :, :] - pos[i, None, :]              # [64, N, 2]
        d2 = (d * d).sum(-1) + soft2
        d2[torch.arange(len(i), device=pos.device), i] = float("inf")
        w = ms[None, :] / (d2 * d2.sqrt())
        out.append((w[..., None] * d).sum(1))
    dt = cfg.shared.seconds_per_tick * float(state.base_time_accel) * \
        float(state.time_scale)
    return REAL_G * torch.cat(out) * dt * rcv[idx, None].double()


def gravity_error(state, step, cfg, label):
    """One gravity tick from ``state`` with its velocities zeroed (so the
    new velocity is the tick's change, rounded once) against exact_dv on
    REF_RECEIVERS receivers drawn from a seeded generator. Returns (the
    receivers, their relative errors, float64)."""
    import numpy as np
    import torch
    b = state.bodies
    rcv = step.masks(b)[1].cpu().numpy()
    idx = np.random.default_rng(0).choice(np.flatnonzero(rcv),
                                          REF_RECEIVERS, replace=False)
    idx = torch.from_numpy(idx).to(b.pos.device)
    s0 = state.replace(bodies=b.replace(vel=torch.zeros_like(b.vel)))
    dv = step(s0).bodies.vel[idx].double()
    ex = exact_dv(state, step, cfg, idx)
    err = ((dv - ex).norm(dim=1) / ex.norm(dim=1).clamp(min=1e-300))
    print(f"{label}: one tick's velocity change on {REF_RECEIVERS} "
          f"sampled receivers against a float64 direct sum: relative "
          f"error median {float(err.median()):.3e}, p95 "
          f"{float(err.quantile(0.95)):.3e}, max {float(err.max()):.3e}",
          flush=True)
    return idx, err


def no_sync_and_bitwise(run, state, label):
    """One block of ``run`` under set_sync_debug_mode("error") (no host
    sync), then two blocks from one state equal to the bit in every
    state field."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    run(state)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    a, b = run(state), run(state)
    differ = [n for part in ("", "bodies")
              for n, u, v in state_fields(a, b, part)
              if not tensor_bits_equal(u, v)]
    print(f"{label}: a block under set_sync_debug_mode('error') makes no "
          f"host sync; two blocks from one state bitwise equal in every "
          f"state field {not differ}", flush=True)
    if differ:
        fail(f"{label}: two blocks from one state differ in {differ}")


def run_keplerian(dev, card):
    """Phase 17: KEPLERIAN_DISK (1,000 bodies, the direct sum, the CLI's
    default scene) through drive for KEPLER_TICKS ticks: no port kernel
    and no plain version, finite; the median orbit-radius drift around the
    central body under 5% (lpe_tpu's gate); a second run from seed 0
    equal to the bit. Returns the launches."""
    import torch
    from lpe_tpu_torch.scenarios import create_scenario
    sc = create_scenario("KEPLERIAN_DISK", seed=0, device=dev)
    run, _, state, launches, _ = drive(dev, card, sc, "KEPLERIAN_DISK",
                                       blocks=KEPLER_TICKS // BLOCK)
    if run.systems["barnes_hut"].use_pm:
        fail("KEPLERIAN_DISK: not on the direct sum")
    p0, p1 = sc.state.bodies.pos.double(), state.bodies.pos.double()
    r0 = (p0[1:1000] - p0[0]).norm(dim=1)
    r1 = (p1[1:1000] - p1[0]).norm(dim=1)
    drift = float(((r1 - r0).abs() / r0).median())
    again = create_scenario("KEPLERIAN_DISK", seed=0, device=dev).state
    for _ in range(KEPLER_TICKS // BLOCK):
        again = run(again)
    differ = [n for part in ("", "bodies")
              for n, u, v in state_fields(state, again, part)
              if not tensor_bits_equal(u, v)]
    torch.cuda.synchronize()
    print(f"KEPLERIAN_DISK: median orbit-radius drift after {KEPLER_TICKS} "
          f"ticks {drift:.4e} (gate 5e-2); two runs from seed 0 bitwise "
          f"equal {not differ}", flush=True)
    if not drift < 0.05:
        fail(f"KEPLERIAN_DISK: median orbit-radius drift {drift}")
    if differ:
        fail(f"KEPLERIAN_DISK: two runs from seed 0 differ in {differ}")
    return launches


def run_galaxy_direct(dev, card):
    """Phase 18: build_galaxy(GALAXY_DIRECT_N), the direct sum at scale:
    3 timed blocks (drive), no host sync in a block and two blocks from
    one state bitwise equal; one tick against the float64 direct sum
    (p95 relative error < 1e-3); the direct sum timed (CUDA events) beside
    its bound. Returns (launches, (ms, bound ms, bound by))."""
    from lpe_tpu_torch.scenarios.bench_scenes import build_galaxy
    from lpe_tpu_torch.systems.barnes_hut import _direct_sum_accel
    label = f"galaxy {GALAXY_DIRECT_N}"
    t0 = time.perf_counter()
    sc = build_galaxy(GALAXY_DIRECT_N, device=dev)
    print(f"{label}: built on the host in {time.perf_counter() - t0:.2f} s",
          flush=True)
    run, _, state, launches, _ = drive(dev, card, sc, label)
    step = run.systems["barnes_hut"]
    if step.use_pm:
        fail(f"{label}: not on the direct sum")
    no_sync_and_bitwise(run, state, label)
    _, err = gravity_error(state, step, sc.cfg, label)
    if not float(err.quantile(0.95)) < 1e-3:
        fail(f"{label}: p95 relative error {float(err.quantile(0.95))}")
    b = state.bodies
    src, rcv = step.masks(b)
    soft2 = sc.cfg.shared.gravitational_softener ** 2
    args = (b.pos, b.mass, src, rcv, soft2, step.chunk)
    ms = cuda_ms(lambda: _direct_sum_accel(*args), reps=3)
    n = b.pos.shape[0]
    bnd = bound(nbytes(b.pos, b.mass, src, rcv, b.pos), GRAV_PAIR_OPS * n * n)
    print(f"{label}: direct sum {ms:.4f} ms a tick (CUDA events, {n} "
          f"bodies, row blocks of {step.chunk}) on {card}; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}), {ms / bnd[0]:.1f}x", flush=True)
    return launches, (ms, *bnd), (sc.spec, sc.cfg, state)


def run_galaxy(dev, card):
    """Phase 19: build_galaxy(GALAXY_N), bench.py's galaxy on the P3M
    branch: the host build time; the PP correction's K, subdivision,
    ncells and overflow_fraction at tick 0; up to 3 timed blocks within
    GALAXY_BUDGET_S, no port kernel and no plain version, finite, their
    peak memory; no host sync in a block and two blocks bitwise equal;
    one tick against the float64 direct sum (p95 relative error < 0.01,
    lpe_tpu's P3M gate), over all sampled receivers and over those whose
    PP cell did not overflow; the mesh, the PP correction and the heavy
    direct sum timed apart (CUDA events) beside their bounds. Returns
    (launches, {part: (ms, bound ms, bound by)})."""
    import torch
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.scenarios.bench_scenes import build_galaxy
    from lpe_tpu_torch.systems import build_run_fn
    label = f"galaxy {GALAXY_N}"
    t0 = time.perf_counter()
    sc = build_galaxy(GALAXY_N, device=dev)
    print(f"{label}: built on the host in {time.perf_counter() - t0:.2f} s",
          flush=True)
    run = build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=dev)
    step = run.systems["barnes_hut"]
    pp = step.pp
    if not step.use_pm or pp is None:
        fail(f"{label}: not on the P3M branch")
    print(f"{label}: P3M, pm_grid {sc.cfg.barnes_hut.pm_grid}; PP K {pp.K}, "
          f"subdivision {pp.subdivision}, ncells {pp.ncells}, "
          f"overflow_fraction at tick 0 "
          f"{pp.overflow_fraction(sc.state.bodies.pos):.6f}", flush=True)
    ops = (*SK.OPS, *RK.OPS)
    SK.reset_counters()
    RK.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, ticks, t0 = sc.state, 0, time.perf_counter()
    while ticks < 3 * BLOCK:
        tb = time.perf_counter()
        state = run(state)
        torch.cuda.synchronize()
        ticks += BLOCK
        now = time.perf_counter()
        if now - t0 + (now - tb) > GALAXY_BUDGET_S:
            break
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {op.name: op.launches for op in ops if op.launches}
    if launches or any(op.plain_calls for op in ops):
        fail(f"{label}: launches {launches}, plain calls "
             f"{ {op.name: op.plain_calls for op in ops} }")
    for f in ("pos", "vel"):
        if not bool(torch.isfinite(getattr(state.bodies, f)).all()):
            fail(f"{label}: non-finite {f}")
    print(f"{label}: {ticks} ticks at {ticks / dt:.3f} ticks/s (host clock, "
          f"synchronized blocks of {BLOCK}) on {card}; peak memory "
          f"{peak} bytes ({peak / 2**30:.2f} GiB)", flush=True)
    no_sync_and_bitwise(run, state, label)
    idx, err = gravity_error(state, step, sc.cfg, label)
    b = state.bodies
    cid = pp.cells_of(b.pos)
    cnt = torch.zeros(pp.ncells + 1, dtype=torch.int64, device=b.pos.device)
    cnt = cnt.scatter_add(0, cid, torch.ones_like(cid))
    kept = (cid[idx] < pp.ncells) & (cnt[cid[idx]] <= pp.K)
    ek = err[kept]
    print(f"{label}: over the {int(kept.sum())} sampled receivers whose PP "
          f"cell did not overflow: median {float(ek.median()):.3e}, p95 "
          f"{float(ek.quantile(0.95)):.3e}, max {float(ek.max()):.3e}; "
          f"overflow_fraction now {pp.overflow_fraction(b.pos):.6f}",
          flush=True)
    if not float(err.quantile(0.95)) < 0.01:
        fail(f"{label}: p95 relative error {float(err.quantile(0.95))}")
    # the three parts on this state, as the step calls them
    src, _ = step.masks(b)
    heavy = src & (b.mass >= sc.cfg.barnes_hut.heavy_threshold)
    mm = torch.where(src & ~heavy, b.mass, 0.0)
    n = b.pos.shape[0]
    occ = torch.clamp(cnt[:pp.ncells], max=pp.K).double()
    nc, m = int(round(pp.ncells ** 0.5)), pp.subdivision
    occ2 = torch.nn.functional.pad(occ.reshape(1, 1, nc, nc), (m,) * 4)
    near = torch.nn.functional.avg_pool2d(occ2, 2 * m + 1, stride=1) * \
        (2 * m + 1) ** 2                   # live slots a cell's bodies scan
    pairs = float((occ * near.reshape(-1)).sum())
    P = 2 * sc.cfg.barnes_hut.pm_grid
    fft_ops = 3 * 2.5 * P * P * math.log2(P * P)
    parts = {}
    for name, fn, ins, n_ops in (
            ("mesh", lambda: step.pm(b.pos, mm), (b.pos, mm),
             fft_ops + CIC_OPS * n),
            ("pp", lambda: pp(b.pos, mm), (b.pos, mm),
             PP_PAIR_OPS * pairs),
            ("heavy", lambda: step.heavy_direct(b.pos, b.mass, heavy),
             (b.pos, b.mass, heavy),
             GRAV_PAIR_OPS * n * sc.cfg.barnes_hut.heavy_cap)):
        ms = cuda_ms(fn, reps=3)
        n_bytes = nbytes(*ins, b.pos)        # the inputs, the [N, 2] result
        bnd = bound(n_bytes, n_ops)
        parts[name] = (ms, *bnd)
        print(f"{label}: {name} {ms:.4f} ms (CUDA events) on {card}; byte "
              f"bound {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), {ms / bnd[0]:.1f}x", flush=True)
    print(f"{label}: PP pairs this state needs {pairs:.6g} (live slots of "
          f"each resident body's {(2 * m + 1) ** 2} cells)", flush=True)
    return launches, parts, (sc.spec, sc.cfg, state)


def run_ocean(dev, card):
    """Phase 20: PLANETARY_OCEAN through create_scenario and drive for
    OCEAN_TICKS ticks: the stacked chain 10 times a tick, no other kernel,
    no plain version; the ring survives around the moon (lpe_tpu's gate:
    (r < 2.5e5).mean() > 0.95, median r > 4e4); one tick of
    build_run_fn(ticks=1) equals one of build_tick_fn to the bit (no
    cross-tick grid under gravity); the fluid cells that couple with the
    moon (a particle there takes a force from it) counted and, where any
    do, the couplings held against their plain versions there
    (check_coupled_kernels; the ocean's pressure is clamped at 0 below
    its rest density, so the moon may move particles and take no force
    back: nonzero force partials are not required). Returns (launches,
    kernel results or None)."""
    import torch
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems import build_run_fn, build_tick_fn
    sc = create_scenario("PLANETARY_OCEAN", seed=0, device=dev)
    label = "PLANETARY_OCEAN"
    run, _, state, launches, _ = drive(dev, card, sc, label,
                                       blocks=OCEAN_TICKS // BLOCK)
    liq = sc.spec.liquid_slice
    r = (state.bodies.pos[liq] - state.bodies.pos[1]).norm(dim=1)
    inside, med = float((r < 2.5e5).float().mean()), float(r.median())
    print(f"{label}: after {OCEAN_TICKS} ticks {inside:.4f} of the ocean "
          f"within 2.5e5 m of the moon (gate > 0.95), median radius "
          f"{med:.1f} m (gate > 4e4)", flush=True)
    if not (inside > 0.95 and med > 4e4):
        fail(f"{label}: the ring did not survive")
    one = build_run_fn(sc.spec, sc.cfg, ticks=1, device=dev)(state)
    tick = build_tick_fn(sc.spec, sc.cfg, device=dev)(state)
    differ = [n for part in ("", "bodies")
              for n, u, v in state_fields(one, tick, part)
              if not tensor_bits_equal(u, v)]
    print(f"{label}: one tick of build_run_fn(ticks=1) equals one of "
          f"build_tick_fn to the bit {not differ}", flush=True)
    if differ:
        fail(f"{label}: build_run_fn and build_tick_fn differ in {differ}")
    # the cells where the moon (body 1) couples on the first sub-step from
    # this state: coupling9 changes a live particle there (its position,
    # velocity or acceleration differ from a copy-through, cpl = 0), and a
    # candidate slot of the cell holds the moon
    fl = run.systems["fluid"]
    inp = sub_step_inputs(SK, fl, state, fl.grid_stack(fl.grid_build(state)),
                          wall=False)
    cpl, fld, big = inp["cands"]["main"]
    ST1, ST0 = (SK.coupling9(c, fld, big, inp["M9"], *inp["sw"],
                             cn=fl.couple_consts)[0]
                for c in (cpl, torch.zeros_like(cpl)))
    occ = inp["M9"][:, SK.M9_OCC] > 0
    acted = ((ST1 != ST0).any(1) & occ).any(1)          # [rows, cols]
    moon = (fld[:, :, SK.RW_M, :] == state.bodies.mass[1]).any(1)
    n_moon = int((acted & moon).sum())
    gap = float(r.min()) - float(state.bodies.radius[1])
    print(f"{label}: after {OCEAN_TICKS} ticks {int((cpl > 0).sum())} fluid "
          f"cells lie in a rigid's coupling window, {n_moon} of them couple "
          f"with the moon (coupling9 changes a particle there); the nearest "
          f"particle {gap:.1f} m off the moon's surface", flush=True)
    torch.cuda.synchronize()
    if n_moon == 0:
        print(f"{label}: no fluid cell couples with the moon (no particle "
              "within its contact margin), so the coupling kernels are not "
              "held on this state", flush=True)
        return launches, None
    return launches, check_coupled_kernels(run, state, "planetary ocean",
                                           need_force=False)


# phase 21: the application layer
APP_TICKS = 120       # `cli run`'s ticks, as phase 5's
APP_RESUME = 60       # resumed from them, against one straight run
APP_BENCH = 240       # `cli bench`'s ticks (lpe_tpu's CLI default)
FRAME_RUNS = 5        # frames timed by CUDA events; the median is kept
FRAME_EDGE_PIXELS = 1e-3   # CPU vs card frames: pixels off by > 1 level


def cli(argv) -> str:
    """``lpe_tpu_torch.app.cli.main(argv)`` in this process; fails unless
    it returns 0. Returns what it printed to stdout."""
    import contextlib
    import io
    from lpe_tpu_torch.app.cli import main as cli_main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    if rc != 0:
        fail(f"cli {argv}: exit code {rc}")
    return out.getvalue()


def png_pixels(path):
    """An 8-bit RGB PNG whose rows all take filter 0, as
    lpe_tpu_torch.io.media.save_png writes them, decoded with zlib alone:
    uint8 [H, W, 3]. Checks each chunk's CRC."""
    import struct
    import zlib
    import numpy as np
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            fail(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    W, H, depth, ctype = ihdr[:4]
    if (depth, ctype) != (8, 2):
        fail(f"{path}: bit depth {depth}, color type {ctype}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8) \
        .reshape(H, 1 + 3 * W)
    if raw[:, 0].any():
        fail(f"{path}: a row with a filter other than 0")
    return raw[:, 1:].reshape(H, W, 3)


def frame_check(dev, label, sc, state, tick_ms, debug=False):
    """Phase 21e for one state: a 600x600 frame rendered twice on the card
    (equal to the bit), against the port's CPU frame of the same state
    (pixels off by more than one level under FRAME_EDGE_PIXELS, the CPU
    tests' tolerance), the card's ms a frame (CUDA events, median of
    FRAME_RUNS), the PyTorch ops a frame and the host syncs a frame (sync
    debug mode "warn": reported, not held)."""
    import statistics
    import warnings
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from lpe_tpu_torch.convert import state_from_numpy, state_to_numpy
    from lpe_tpu_torch.render import make_renderer

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace != "profiler":
                Ops.n += 1
            return func(*args, **(kwargs or {}))

    frame = make_renderer(sc.spec, sc.cfg, debug=debug)
    a, b = frame(state), frame(state)
    if not torch.equal(a, b):
        fail(f"{label}: two frames of one state differ")
    host = frame(state_from_numpy(state_to_numpy(state), "cpu"))
    d = (a.cpu().int() - host.int()).abs().amax(-1)
    off = float((d > 1).float().mean())
    if a.shape != (600, 600, 3) or off > FRAME_EDGE_PIXELS:
        fail(f"{label}: {a.shape}, {off:.2e} of the pixels differ from "
             f"the CPU frame by more than one level")
    times = []
    for _ in range(FRAME_RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        frame(state)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    Ops.n = 0
    with Ops():
        frame(state)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        frame(state)
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    why = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in caught
                  if "synchroniz" in str(w.message)})
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    ms = statistics.median(times)
    out = dict(ms=ms, ops=Ops.n, tick_ms=tick_ms, cpu_pixels_off=off,
               equal_to_cpu=bool(torch.equal(a.cpu(), host)),
               host_syncs=syncs)
    where = f" (at {', '.join(why)})" if why else ""
    print(f"{label}: frame {ms:.4f} ms (median of {FRAME_RUNS}, CUDA "
          f"events; runs {', '.join(f'{t:.4f}' for t in times)}), "
          f"{Ops.n} PyTorch ops, {syncs} host syncs{where} a frame; a tick "
          f"{tick_ms:.4f} ms; two frames bitwise equal; CPU frame: "
          f"{off:.2e} of the pixels off by > 1 level (equal to the bit: "
          f"{out['equal_to_cpu']})", flush=True)
    return out


def run_app(dev, card):
    """Phase 21: the application layer (lpe_tpu_torch.app.cli, the
    renderer, the HUD, checkpoints) on the card. Returns the app line."""
    import numpy as np
    import torch
    from lpe_tpu_torch.app.sim_manager import SimManager
    from lpe_tpu_torch.core.constants import SCENARIO_NAMES, SimulationType
    from lpe_tpu_torch.io.checkpoint import load_state
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.render import make_renderer
    from lpe_tpu_torch.render.hud import BTN_RESET, PANEL_W
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.scenarios.bench_scenes import (build_dam_break,
                                                      build_highlight_reel,
                                                      build_north_star)
    app = {}
    work = ROOT / "build" / "chip_smoke_app"
    work.mkdir(parents=True, exist_ok=True)
    png, c1, c2, c3 = (str(work / n) for n in
                       ("f.png", "c1.npz", "c2.npz", "c3.npz"))
    fluid = ["run", "--scenario", "SIMPLE_FLUID"]

    # a. list
    names = cli(["list"]).split()
    if names != list(SCENARIO_NAMES.values()):
        fail(f"cli list: {names}")
    app["list"] = names

    # b. run on SIMPLE_FLUID: the stacked chain, and nothing else
    ops = (*SK.OPS, *RK.OPS)
    SK.reset_counters()
    RK.reset_counters()
    t0 = time.perf_counter()
    cli(fluid + ["--ticks", str(APP_TICKS), "--png", png, "--checkpoint",
                 c1])
    run_s = time.perf_counter() - t0
    launches = {op.name: op.launches for op in ops if op.launches}
    want = dict.fromkeys(("migrate", "pair_sweep", "coupling9"),
                         APP_TICKS * SUBSTEPS)
    if launches != want or any(op.plain_calls for op in ops):
        fail(f"cli run: launches {launches}, expected {want}; plain calls "
             f"{ {op.name: op.plain_calls for op in ops if op.plain_calls} }")
    img = png_pixels(png)
    blue = float(((img[:, :, 2] > 200) & (img[:, :, 0] < 100)).mean())
    sc = create_scenario(SimulationType.SIMPLE_FLUID, seed=0, device=dev)
    s120 = load_state(c1, device=dev)
    fresh = make_renderer(sc.spec, sc.cfg)(s120).cpu().numpy()
    if img.shape != (600, 600, 3) or not blue > 0.02 or \
            not np.array_equal(img, fresh):
        fail(f"cli run: PNG {img.shape}, blue {blue:.4f}, equal to a fresh "
             f"renderer's frame of the checkpoint: "
             f"{np.array_equal(img, fresh)}")
    app["run"] = dict(ticks=APP_TICKS, seconds=run_s, launches=launches,
                      blue=blue, png_is_the_checkpoints_frame=True)
    print(f"cli run SIMPLE_FLUID {APP_TICKS} ticks --png --checkpoint: "
          f"{run_s:.2f} s with the PNG on {card}; launches {launches}, no "
          f"plain call; PNG {img.shape} decoded with zlib, blue {blue:.4f}, "
          f"equal to a fresh renderer's frame of the checkpoint", flush=True)

    # c. resume: 120 + 60 ticks against 180 straight, every field
    cli(fluid + ["--resume", c1, "--ticks", str(APP_RESUME), "--checkpoint",
                 c2])
    cli(fluid + ["--ticks", str(APP_TICKS + APP_RESUME), "--checkpoint", c3])
    with np.load(c2) as za, np.load(c3) as zb:
        differ = sorted(set(za.files) ^ set(zb.files)) + [
            k for k in za.files if k in zb.files and not (
                za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape
                and np.array_equal(za[k], zb[k], equal_nan=True))]
        tick = int(za["tick"])
    if differ or tick != APP_TICKS + APP_RESUME:
        fail(f"cli run --resume: tick {tick}; fields that differ from one "
             f"straight run: {differ}")
    app["resume_bitwise"] = True
    print(f"cli run --resume (tick {APP_TICKS}) --ticks {APP_RESUME}: every "
          f"field equals one straight {tick}-tick run to the bit", flush=True)

    # d. bench
    line = cli(["bench", "--scenario", "SIMPLE_FLUID", "--ticks",
                str(APP_BENCH)]).strip().splitlines()[-1]
    app["bench"] = json.loads(line)
    print(f"cli bench: {line} on {card}", flush=True)

    # e. 600x600 frames of four states
    frames = {}
    tick_ms = 1e3 / app["bench"]["ticks_per_sec"]
    frames["simple_fluid"] = frame_check(dev, "frame simple_fluid (tick "
                                         f"{APP_TICKS}, exact splat)", sc,
                                         s120, tick_ms)
    for key, label, build, blocks, debug in (
            ("dam", f"frame dam {DAM_N} (tick 40, convolution splat)",
             lambda: build_dam_break(DAM_N, device=dev), 4, False),
            ("north", f"frame north star {NORTH} (tick 10, windowed "
             f"painter)", lambda: build_north_star(*NORTH, device=dev), 1,
             False),
            ("highlight", f"frame highlight reel {HIGHLIGHT} (tick 30, "
             f"debug: loop painter, gas, overlays)",
             lambda: build_highlight_reel(*HIGHLIGHT, device=dev), 3, True)):
        scene = build()
        _, _, state, _, tps = drive(dev, card, scene, f"{label}: its ticks",
                                    blocks=blocks)
        frames[key] = frame_check(dev, label, scene, state, 1e3 / tps, debug)
    app["frames"] = frames

    # f. the HUD: the window's panel, and the stats block on one image
    mgrs = [SimManager(SimulationType.SIMPLE_FLUID, debug=True, device=d)
            for d in (dev, "cpu")]
    for m in mgrs:
        m.state = load_state(c1, device=m.device)
        m.stats.frames_per_sec = 59.94
        m.stats.ticks_per_sec = app["bench"]["ticks_per_sec"]
        m.set_time_scale(0.5)
    card_ui, cpu_ui = (m.render_frame_with_ui(600, 600, highlight=BTN_RESET)
                       for m in mgrs)
    base = torch.from_numpy(img.copy())
    stats_card = mgrs[0]._stats_overlay(base.to(dev), 59.94, 118.25, 0.5)
    stats_cpu = mgrs[1]._stats_overlay(base, 59.94, 118.25, 0.5)
    hud_same = card_ui.shape == (600, 600 + PANEL_W, 3) and \
        np.array_equal(card_ui[:, 600:], cpu_ui[:, 600:]) and \
        torch.equal(stats_card.cpu(), stats_cpu)
    if not hud_same:
        fail("render_frame_with_ui: the card's panel or stats block differs "
             "from the CPU's")
    app["hud_bitwise"] = True
    app["window_bitwise"] = bool(np.array_equal(card_ui, cpu_ui))
    print(f"render_frame_with_ui {card_ui.shape}: the panel and the stats "
          f"block equal the CPU's to the bit (the whole window: "
          f"{app['window_bitwise']})", flush=True)
    return app


# phase 22: mixed per-particle smoothing lengths
MIXED_SMALL_H = 0.04  # tests/test_sph.py _mixed_h_scene's smaller h
MIXED_ORACLE_N = 20_000


def mixed_h_dam(n, dev, walls=True, far=None):
    """build_dam_break(n)'s layout (and, with ``walls``, its tank walls)
    through SceneBuilder, its odd-indexed liquid particles at smoothing
    length MIXED_SMALL_H and the rest at the config's 0.05; with ``far``
    (an h), every particle at the config's h and one more particle, at h
    ``far``, alone in the air on the tank's right (the uniform limit)."""
    import numpy as np
    from lpe_tpu_torch.core import constants as C
    from lpe_tpu_torch.core.config import (BroadphaseConfig,
                                           RigidBodyConfig,
                                           ScenarioSystemConfig,
                                           SharedSystemConfig)
    from lpe_tpu_torch.scenarios.simple_fluid import add_tank_walls
    from lpe_tpu_torch.scene import SceneBuilder

    scale = math.sqrt(n / 20000.0)
    size = 6.0 * scale
    cfg = ScenarioSystemConfig(shared=SharedSystemConfig(
        universe_size_m=size, meters_per_pixel=size / C.SCREEN_LENGTH,
        seconds_per_tick=1.0 / C.STEPS_PER_SECOND, time_acceleration=1.0,
        grid_size=50, cell_size_pixels=C.SCREEN_LENGTH / 50),
        rigid=RigidBodyConfig(broadphase=BroadphaseConfig(max_pairs=8)))
    rng = np.random.default_rng(0)
    b = SceneBuilder(f"MIXED_H_DAM_{n}")
    if walls:
        add_tank_walls(b, size, 0.05 * scale, 1e30, 0.0, 0.0)
    x_min, x_max = 0.16 * scale, size * 0.35
    y_min, y_max = size * 0.2, size - 0.16 * scale
    spacing = math.sqrt((x_max - x_min) * (y_max - y_min) / n)
    mass = 0.005 * (spacing / 0.0742) ** 2
    n_cols = int((x_max - x_min) / spacing)
    for k in range(n):
        row, col = divmod(k, n_cols)
        x = x_min + (col + 0.5) * spacing + rng.uniform(-0.05, 0.05) * spacing
        y = y_max - (row + 0.5) * spacing + rng.uniform(-0.05, 0.05) * spacing
        h = MIXED_SMALL_H if far is None and k % 2 else 0.0
        b.add(pos=(x, y), mass=mass, phase=int(C.Phase.LIQUID),
              shape_kind=int(C.ShapeKind.CIRCLE), radius=0.02,
              static_friction=0.0, dynamic_friction=0.0,
              color=(20, 20 + k % 50, 200 + k % 55), smoothing_length=h)
    if far is not None:
        b.add(pos=(0.9 * size, 0.3 * size), mass=mass,
              phase=int(C.Phase.LIQUID), shape_kind=int(C.ShapeKind.CIRCLE),
              radius=0.02, smoothing_length=far)
    return b.finalize(cfg, device=dev)


MIXED_KERNELS = ("migrate_h", "density_h", "force_h", "coupling")


def run_mixed_h(dev, card):
    """Phase 22: a mixed-h dam (mixed_h_dam(DAM_N)) on the card. (b) after
    a warm-up block, 3 timed blocks of build_run_fn(ticks=10): migrate_h,
    density_h, force_h and coupling 10 times a tick, no other kernel and no
    plain version, finite; (a) at the state 40 ticks in, each h kernel
    against its plain version (migrate_h to the bit; density_h and force_h
    at phase 3's tolerances) and timed beside its bound; (c) no host sync
    in a block, two blocks from one state equal to the bit; (d) the scatter
    step (residency "off") for 10 ticks: density_h and force_h 10 times a
    tick; (e) the liquid without walls at MIXED_ORACLE_N particles: one
    tick against the float64 oracle with per-particle h (rho rtol 2e-4,
    positions atol 5e-6, tests/test_sph.py's); (f) the uniform limit: all
    h 0.05 and one far particle's 0.04, one tick of the h chain against the
    uniform split chain (|dpos| <= 1e-4 m, phase 6a's tolerance). Returns
    (the mixed_h line, {kernel: (max abs err, (ms, plain ms), bound)},
    launches by kernel)."""
    import numpy as np
    import torch
    from lpe_tpu_torch.oracle.sph_numpy import SphOracle
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.systems import build_run_fn, build_tick_fn

    line = {}
    sc = mixed_h_dam(DAM_N, dev)
    liq = sc.spec.liquid_slice
    hs = sc.state.bodies.h[liq]
    if sc.spec.liquid_h_uniform or float(hs.min()) != np.float32(
            MIXED_SMALL_H) or float(hs.max()) != np.float32(0.05):
        fail(f"mixed-h dam: h from {float(hs.min())} to {float(hs.max())}")
    # (b) the full run, counted over 3 blocks after a warm-up block
    run = build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=dev)
    state = run(sc.state)
    torch.cuda.synchronize()
    ops = (*SK.OPS, *RK.OPS)
    SK.reset_counters()
    RK.reset_counters()
    t0 = time.perf_counter()
    for _ in range(3):
        state = run(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {op.name: op.launches for op in ops if op.launches}
    want = dict.fromkeys(MIXED_KERNELS, 3 * BLOCK * SUBSTEPS)
    if launches != want or any(op.plain_calls for op in ops):
        fail(f"mixed-h dam: launches {launches}, expected {want}; plain "
             f"calls { {op.name: op.plain_calls for op in ops} }")
    for f in ("pos", "vel", "density"):
        if not bool(torch.isfinite(getattr(state.bodies, f)).all()):
            fail(f"mixed-h dam: non-finite {f}")
    line["ticks_per_s"] = 3 * BLOCK / dt
    line["launches"] = launches
    print(f"mixed-h dam {DAM_N} (odd particles h {MIXED_SMALL_H}, the rest "
          f"0.05): {line['ticks_per_s']:.2f} ticks/s over 3 blocks of "
          f"{BLOCK} (host clock, synchronized) on {card}; launches "
          f"{launches}", flush=True)

    # (a) the h kernels at the state 40 ticks in
    fl = run.systems["fluid"]
    D = fl.grid_build(state)
    ST10 = torch.cat([fl.grid_stack(D), D["h"][:, None]], 1).contiguous()
    rows, _, K, W = ST10.shape
    line["grid"] = dict(rows=rows, K=K, cols=W)
    print(f"mixed-h dam: grid {tuple(ST10.shape)} [rows, planes, K, cols] "
          f"(the uniform dam's: 275 rows, K = 16, 288 columns)", flush=True)
    if (rows, K, W) != (275, 16, 288):
        fail(f"mixed-h dam: grid rows={rows} K={K} cols={W}")
    mk, fk = fl.migrate_consts, fl.force_h_consts
    M10 = SK.migrate_h(ST10, **mk)
    M10p = SK.migrate_h_plain(ST10, **mk)
    if not same_bits(M10, M10p):
        fail(f"migrate_h differs from its plain version (max abs err "
             f"{max_err(M10, M10p)})")
    x1, y1, vx, vy, m, occ, _, _, _, hp = M10.unbind(1)
    D5 = torch.stack([x1, y1, m, occ, hp], 1)
    rho = SK.density_h(D5)
    rho_p = SK.density_h_plain(D5)
    o = (occ > 0)[1:-1]
    rho_rel = float(((rho - rho_p).abs() / rho_p.abs().clamp(min=1e-30))
                    [o].max())
    rp = torch.nn.functional.pad(rho_p, (0, 0, 0, 0, 1, 1))
    D9 = torch.stack([x1, y1, vx, vy, m, rp, fl.eos(rp), occ, hp], 1)
    frc = SK.force_h(D9, **fk)
    frc_p = SK.force_h_plain(D9, **fk)
    fscale = float(torch.stack(frc_p).abs().max())
    misses = sum(int(((a - b).abs() > 1e-5 * b.abs() + 1e-6 * fscale).sum())
                 for a, b in zip(frc, frc_p))
    errs = {"migrate_h": 0.0, "density_h": max_err(rho, rho_p),
            "force_h": max(max_err(a, b) for a, b in zip(frc, frc_p))}
    print(f"migrate_h: bitwise equal to its plain version; density_h: rho "
          f"rel err {rho_rel:.3e}; force_h: max abs err "
          f"{errs['force_h']:.3e} (scale {fscale:.6g}), {misses} elements "
          f"over 1e-5*|f| + {1e-6 * fscale:.3e}", flush=True)
    if rho_rel > 1e-5 or misses:
        fail("density_h or force_h differs from its plain version")
    calls = {"migrate_h": (lambda: SK.migrate_h(ST10, **mk),
                           lambda: SK.migrate_h_plain(ST10, **mk)),
             "density_h": (lambda: SK.density_h(D5),
                           lambda: SK.density_h_plain(D5)),
             "force_h": (lambda: SK.force_h(D9, **fk),
                         lambda: SK.force_h_plain(D9, **fk))}
    pairs = neighbour_pairs((occ > 0).to(torch.int32))
    n_occ = float((ST10[:, SK.ST_OCC] > 0).sum())
    bounds = {
        "migrate_h": bound(slot_bytes("migrate_h", ST10[:, SK.ST_OCC],
                                      (M10,)), MIGRATE_OPS * n_occ),
        "density_h": bound(slot_bytes("density_h", D5[:, 3], (rho,)),
                           DENSITY_H_OPS * pairs),
        "force_h": bound(slot_bytes("force_h", D9[:, SK.D8_OCC], frc),
                         FORCE_H_OPS * pairs)}
    kern = {}
    for name, (k, p) in calls.items():
        t = (cuda_ms(k), cuda_ms(p, 5))
        warm = cuda_ms(k, cold=False)
        kern[name] = (errs[name], t, bounds[name])
        line[name] = dict(ms=t[0], warm_ms=warm, plain_ms=t[1],
                          bound_ms=bounds[name][0],
                          bound_by=bounds[name][1], max_abs_err=errs[name])
        print(f"kernel {name}: max_abs_err {errs[name]:.3e}  kernel "
              f"{t[0]:.4f} ms ({warm:.4f} warm)  plain {t[1]:.4f} ms  bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]})", flush=True)

    # (c) no host sync in a block; two blocks from one state, same bits
    no_sync_and_bitwise(run, state, "mixed-h dam")

    # (d) the scatter step
    srun = build_run_fn(sc.spec, fluid_cfg(sc.cfg, residency="off"),
                        ticks=BLOCK, device=dev)
    if hasattr(srun.systems["fluid"], "grid_build"):
        fail("mixed-h dam scatter: the fluid step is a resident one")
    SK.reset_counters()
    s2 = srun(state)
    torch.cuda.synchronize()
    sl = {op.name: op.launches for op in SK.OPS if op.launches}
    if sl != dict.fromkeys(("density_h", "force_h"), BLOCK * SUBSTEPS) or \
            any(op.plain_calls for op in SK.OPS) or \
            not bool(torch.isfinite(s2.bodies.pos).all()):
        fail(f"mixed-h dam scatter: launches {sl}, or non-finite")
    line["scatter_launches"] = sl
    print(f"mixed-h dam scatter: {BLOCK} ticks, launches {sl}, finite",
          flush=True)

    # (e) one tick against the float64 oracle
    so = mixed_h_dam(MIXED_ORACLE_N, dev, walls=False)
    lo_ = so.spec.liquid_slice
    b0 = so.state.bodies
    fc = so.cfg.fluid
    orc = SphOracle(h=fc.grid.smoothing_length, rest_density=fc.rest_density,
                    stiffness=fc.stiffness, viscosity=fc.viscosity,
                    universe=so.cfg.shared.universe_size_m,
                    margin=so.cfg.boundary.margin_pixels
                    * so.cfg.shared.meters_per_pixel)
    orc.hs = b0.h[lo_].double().cpu().numpy()
    t0 = time.perf_counter()
    p1, _, rho1, _ = orc.tick(*(v[lo_].double().cpu().numpy()
                                for v in (b0.pos, b0.vel, b0.mass)))
    t_orc = time.perf_counter() - t0
    line["oracle"] = dict(n=MIXED_ORACLE_N, oracle_s=t_orc)
    for res in ("on", "off"):
        # the fluid, then the boundary and gravity, as the oracle's tick
        tick = build_tick_fn(so.spec, fluid_cfg(so.cfg, residency=res),
                             device=dev)
        bt = tick(so.state).bodies
        rg = bt.density[lo_].double().cpu().numpy()
        pg = bt.pos[lo_].double().cpu().numpy()
        rr = float((np.abs(rg - rho1) / np.abs(rho1)).max())
        dp = float(np.abs(pg - p1).max())
        line["oracle"][res] = dict(rho_rel=rr, dpos=dp)
        print(f"mixed-h liquid {MIXED_ORACLE_N} (no walls), residency "
              f"{res}: one tick against the float64 oracle (hs set; "
              f"{t_orc:.1f} s on the host): rho rel {rr:.3e} (limit 2e-4), "
              f"max |dpos| {dp:.3e} m (limit 5e-6)", flush=True)
        if rr > 2e-4 or dp > 5e-6:
            fail(f"mixed-h liquid, residency {res}: off the float64 oracle")

    # (f) the uniform limit
    ends = {}
    for far in (0.05, MIXED_SMALL_H):
        su = mixed_h_dam(DAM_N, dev, far=far)
        if su.spec.liquid_h_uniform != (far == 0.05):
            fail("uniform-limit scenes: wrong h")
        SK.reset_counters()
        ends[far] = build_run_fn(su.spec, fluid_cfg(su.cfg,
                                                    pair_backend="pallas"),
                                 ticks=1, device=dev)(su.state).bodies
        torch.cuda.synchronize()
        ul = {op.name: op.launches for op in SK.OPS if op.launches}
        want = ("migrate_h", "density_h", "force_h") if far != 0.05 else \
            ("migrate", "density", "force")
        if ul != dict.fromkeys(want + ("coupling",), SUBSTEPS):
            fail(f"uniform limit, far h {far}: launches {ul}")
    lq = su.spec.liquid_slice
    a, b = ends[MIXED_SMALL_H], ends[0.05]
    dpos = max_err(a.pos[lq], b.pos[lq])
    bitwise = all(same_bits(getattr(a, f)[lq], getattr(b, f)[lq])
                  for f in ("pos", "vel", "density", "pressure"))
    line["uniform_limit"] = dict(dpos=dpos, bitwise=bitwise)
    print(f"uniform limit: all h 0.05, one far particle's {MIXED_SMALL_H}: "
          f"one tick of the h chain vs the uniform split chain, max |dpos| "
          f"{dpos:.3e} m (limit 1e-4); bitwise equal {bitwise}", flush=True)
    if dpos > 1e-4:
        fail("the mixed-h chain's uniform limit differs from the uniform "
             "split chain")
    return line, kern, launches


# phase 23: the multi-device fluid, its row bands on one card
BAND_COUNTS = (2, 4)
BAND_MIGRATE_D = 4


def band_migrate(dev, card):
    """Phase 23a: at the dam's 40-tick grid (phase 3's ST), padded with
    empty rows to a multiple of BAND_MIGRATE_D as the band path pads it,
    each band's block (its rows and the neighbours' edge rows as apron
    rows) through migrate with its row offset and the grid's ny: equal to
    the bit to migrate_plain on the block and to the whole grid's migrate
    in the band's rows (the padding rows take nothing). Each band's launch
    timed beside the whole grid's. Density and force on the bands' blocks
    of the migrated grid equal the whole grid's to the bit. Then
    parallel.halo's density over the bands against the whole grid's
    density kernel, to the bit."""
    import torch
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.parallel import make_mesh
    from lpe_tpu_torch.parallel.halo import make_halo_density
    _, fl, state, ST = dam_sub_step(dev)
    D = BAND_MIGRATE_D
    rows, _, K, W = ST.shape
    ny = rows - 2
    band = -(-ny // D)
    STp = torch.nn.functional.pad(ST, (0, 0, 0, 0, 0, 0, 0, band * D - ny)) \
        .contiguous()
    mig = fl.migrate_consts
    whole = SK.migrate(ST, **mig)
    wholep = torch.nn.functional.pad(whole, (0, 0, 0, 0, 0, 0, 0,
                                             band * D - ny))
    band_ms, crossed = [], 0
    for i in range(D):
        blk = STp[i * band:i * band + band + 2].contiguous()
        kw = dict(mig, row_off=i * band, ny=ny)
        got = SK.migrate(blk, **kw)
        if not same_bits(got, SK.migrate.plain(blk, **kw)):
            fail(f"band migrate: band {i} differs from migrate_plain")
        if not same_bits(got[1:-1],
                         wholep[i * band + 1:i * band + band + 1]):
            fail(f"band migrate: band {i} differs from the whole grid's")
        own = blk[1:-1, SK.ST_ID][blk[1:-1, SK.ST_OCC] > 0]
        ids = got[1:-1, SK.M9_ID][got[1:-1, SK.M9_OCC] > 0]
        crossed += int((~torch.isin(ids, own)).sum())
        band_ms.append(cuda_ms(lambda: SK.migrate(blk, **kw)))
    whole_ms = cuda_ms(lambda: SK.migrate(ST, **mig))
    # density and force on the bands' blocks of the migrated grid, their
    # apron rows the neighbours' edge rows (the force pass's rho too, as
    # the third exchange gives them) = the whole grid's, to the bit
    x1, y1, vx, vy, m, occ = wholep.unbind(1)[:6]
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    rho = SK.density(torch.stack([x1, y1, m, occ], 1), **fl.density_consts)
    rho_p = pad(rho)
    D8 = torch.stack([x1, y1, vx, vy, m, rho_p, fl.eos(rho_p), occ], 1)
    fxy = SK.force(D8, **fl.force_consts)
    for i in range(D):
        blk = D8[i * band:i * band + band + 2]
        inner = slice(i * band, i * band + band)
        rho_b = SK.density(blk[:, [0, 1, 4, 7]].contiguous(),
                           **fl.density_consts)
        if not same_bits(rho_b, rho[inner]):
            fail(f"band density: band {i} differs from the whole grid's")
        for u, v in zip(SK.force(blk.contiguous(), **fl.force_consts),
                        fxy):
            if not same_bits(u, v[inner]):
                fail(f"band force: band {i} differs from the whole grid's")
    # density over the bands (parallel.halo) = the whole grid's kernel
    halo = make_halo_density(band * D, W - 2, K, fl.density_consts["h"],
                             make_mesh(devices=[dev] * D))
    split = [[v[1 + i * band:1 + (i + 1) * band] for i in range(D)]
             for v in (x1, y1, m, occ)]
    halo_rho = torch.cat(halo(*split))
    rho[:, :, 0] = 0.0
    rho[:, :, -1] = 0.0
    if not same_bits(halo_rho, rho):
        fail("parallel.halo density differs from the whole grid's kernel")
    out = dict(bands=D, rows=rows, padded_rows=band * D + 2, K=K, cols=W,
               whole_ms=whole_ms, band_ms=band_ms, band_ms_sum=sum(band_ms),
               crossed_in=crossed, bitwise=True, halo_density_bitwise=True)
    print(f"band migrate at the dam's 40-tick grid ({rows} rows, padded to "
          f"{band * D + 2}, K = {K}, {W} columns) in {D} bands: each band "
          f"equal to the bit to migrate_plain and to the whole grid's rows "
          f"(density and force on the bands' blocks too); "
          f"{crossed} particles taken in from a neighbour's rows; whole grid "
          f"{whole_ms:.4f} ms, bands " + ", ".join(f"{t:.4f}" for t in
                                                  band_ms) +
          f" ms (sum {sum(band_ms):.4f}); halo density over {D} bands equal "
          f"to the whole grid's density kernel to the bit; on {card}",
          flush=True)
    return out


def timed_blocks(run, state, blocks=3, block=BLOCK):
    """``blocks`` blocks of ``run`` (``block`` ticks each) from ``state``
    on the host clock around synchronized blocks, every kernel counter set
    to 0 just before and read just after: (state, ticks/s, launches by
    name, plain calls by name)."""
    import torch
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.ops import sph_kernels as SK
    ops = (*SK.OPS, *RK.OPS)
    torch.cuda.synchronize()
    SK.reset_counters()
    RK.reset_counters()
    t0 = time.perf_counter()
    for _ in range(blocks):
        state = run(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (state, blocks * block / dt,
            {op.name: op.launches for op in ops if op.launches},
            {op.name: op.plain_calls for op in ops if op.plain_calls})


def band_gaps(a, b, spec):
    """max |dpos| and |dvel| over the active bodies of two states, the
    rigids' max |dvel| and |domega|, and whether the liquid is equal to
    the bit."""
    act = a.bodies.active
    nr = spec.liquid_start
    liq = spec.liquid_slice
    return dict(
        dpos=max_err(a.bodies.pos[act], b.bodies.pos[act]),
        dvel=max_err(a.bodies.vel[act], b.bodies.vel[act]),
        rigid_dvel=max_err(a.bodies.vel[:nr], b.bodies.vel[:nr]) if nr else 0,
        rigid_domega=max_err(a.bodies.omega[:nr], b.bodies.omega[:nr])
        if nr else 0,
        liquid_bitwise=all(same_bits(getattr(a.bodies, f)[liq],
                                     getattr(b.bodies, f)[liq])
                           for f in ("pos", "vel", "density", "pressure")))


def hold_bands(label, g):
    """lpe_tpu's halo tolerances (tests/test_halo.py:96-100) on band_gaps."""
    if not (g["dpos"] <= 5e-4 and g["dvel"] <= 5e-3
            and g["rigid_dvel"] <= 5e-3 and g["rigid_domega"] <= 5e-3):
        fail(f"{label}: the band path differs from the single device: {g}")


def want_band_launches(D, ticks):
    return {k: ticks * SUBSTEPS * D
            for k in ("migrate", "density", "force", "coupling")}


def band_dam(dev, card, D):
    """Phase 23b: DAM_BREAK 100k with pair_backend="pallas" in D row bands
    on ``dev`` through build_sharded_run(ticks=10): a warm-up block, then 3
    counted blocks (migrate, density, force and coupling 10 D times a tick,
    nothing else, no plain version; finite); the exchange's bytes and
    copies a tick; no host sync in a block, two blocks from one state equal
    to the bit; one tick against the single-device split tick. Returns
    (the line's dict, (the block, its state)) for band_tps."""
    import torch
    from lpe_tpu_torch.parallel import make_mesh
    from lpe_tpu_torch.parallel.sharded import (build_sharded_run,
                                                 build_sharded_tick)
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    from lpe_tpu_torch.systems import build_tick_fn
    label = f"dam {DAM_N} split in {D} bands"
    sc = build_dam_break(DAM_N, device=dev)
    sc.cfg = fluid_cfg(sc.cfg, pair_backend="pallas")
    mesh = make_mesh(devices=[dev] * D)
    run = build_sharded_run(sc, mesh, ticks=BLOCK)
    fl = run.systems["fluid"]
    if getattr(fl, "mesh", None) is not mesh:
        fail(f"{label}: build_sharded_run did not take the band path")
    state = run(sc.state)                       # warm-up block
    fl.halo_stats.update(bytes=0, copies=0)
    blocks = 3
    state, _, launches, plain = timed_blocks(run, state, blocks)
    ticks = blocks * BLOCK
    if launches != want_band_launches(D, ticks) or plain:
        fail(f"{label}: launches {launches}, expected "
             f"{want_band_launches(D, ticks)}; plain calls {plain}")
    if not bool(torch.isfinite(state.bodies.pos).all()) or \
            not bool(torch.isfinite(state.bodies.vel).all()):
        fail(f"{label}: non-finite state")
    xbytes = fl.halo_stats["bytes"] / ticks
    xcopies = fl.halo_stats["copies"] / ticks
    no_sync_and_bitwise(run, state, label)
    g = band_gaps(build_sharded_tick(sc, mesh)(state),
                  build_tick_fn(sc.spec, sc.cfg, device=dev)(state), sc.spec)
    hold_bands(label, g)
    print(f"{label}: on {card}; launches {launches} over {blocks} blocks of "
          f"{BLOCK}; exchange {xbytes:.0f} bytes and {xcopies:.0f} copies a "
          f"tick; one tick against the single-device split tick: max |dpos| "
          f"{g['dpos']:.3e} m, |dvel| {g['dvel']:.3e} m/s, liquid bitwise "
          f"{g['liquid_bitwise']}", flush=True)
    return dict(launches=launches, exchange_bytes_per_tick=xbytes,
                exchange_copies_per_tick=xcopies, one_tick=g), (run, state)


def band_tps(card, runs, rounds=6, blocks=2, what=f"dam {DAM_N} split",
             block=BLOCK):
    """Phase 23b's times (and 24b's): ``runs`` (label -> (block, state))
    timed in turn, ``blocks`` synchronized blocks of ``block`` ticks each
    on the host clock, over ``rounds`` rounds with the order reversed
    every other round, so that a drift of the card or the host falls on
    every label alike. Returns label -> the rounds' ticks/s, their median,
    and (for the bands) each round's single-device ticks/s over the
    label's."""
    order = list(runs)
    tps = {k: [] for k in order}
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            run, state = runs[k]
            state, t, _, _ = timed_blocks(run, state, blocks, block)
            runs[k] = (run, state)
            tps[k].append(t)
    single = tps[order[0]]
    out = {}
    for k in order:
        line = dict(rounds=tps[k], median=statistics.median(tps[k]))
        if k != order[0]:
            line["slowdown"] = [a / b for a, b in zip(single, tps[k])]
        out[k] = line
        extra = "" if k == order[0] else (
            "; single device over it " + ", ".join(
                f"{x:.3f}" for x in line["slowdown"]))
        print(f"{what}, {k}: ticks/s over {rounds} rounds of "
              f"{blocks} blocks of {block}, timed in turn (host clock, "
              f"synchronized) on {card}: " +
              ", ".join(f"{x:.2f}" for x in tps[k]) +
              f" (median {line['median']:.2f}){extra}", flush=True)
    return out


def band_coupled(dev, card, coupled):
    """Phase 23c: the coupled dam (phase 10's settled split state) in
    BAND_MIGRATE_D bands: one 10-tick block against the single-device
    split block, counted; the liquid particles that changed band in it."""
    import torch
    from lpe_tpu_torch.parallel import make_mesh
    from lpe_tpu_torch.parallel.sharded import build_sharded_run
    from lpe_tpu_torch.scene import Scene
    from lpe_tpu_torch.systems import build_run_fn
    D = BAND_MIGRATE_D
    spec, cfg, settled = coupled
    label = f"coupled dam {COUPLED} split in {D} bands"
    mesh = make_mesh(devices=[dev] * D)
    run = build_sharded_run(Scene(state=settled, spec=spec, cfg=cfg), mesh,
                            ticks=BLOCK)
    fl = run.systems["fluid"]
    got, tps, launches, plain = timed_blocks(run, settled, 1)
    if launches != want_band_launches(D, BLOCK) or plain:
        fail(f"{label}: launches {launches}, expected "
             f"{want_band_launches(D, BLOCK)}; plain calls {plain}")
    for f in ("pos", "vel", "angle", "omega"):
        if not bool(torch.isfinite(getattr(got.bodies, f)).all()):
            fail(f"{label}: non-finite {f}")
    want = build_run_fn(spec, cfg, ticks=BLOCK, device=dev)(settled)
    g = band_gaps(got, want, spec)
    liq = spec.liquid_slice
    crossings = int((fl.band_of(settled.bodies.pos[liq, 1])
                     != fl.band_of(got.bodies.pos[liq, 1])).sum())
    print(f"{label}: one block of {BLOCK} ticks ({tps:.2f} ticks/s) on "
          f"{card}; launches {launches}; against the single-device split "
          f"block: max |dpos| {g['dpos']:.3e} m, |dvel| {g['dvel']:.3e} m/s,"
          f" rigids |dvel| {g['rigid_dvel']:.3e}, |domega| "
          f"{g['rigid_domega']:.3e}, liquid bitwise {g['liquid_bitwise']}; "
          f"{crossings} particles changed band", flush=True)
    hold_bands(label, g)
    if crossings == 0:
        fail(f"{label}: no particle crossed a band")
    return dict(ticks_per_s=tps, launches=launches, block=g,
                crossings=crossings)


def run_bands(dev, card, coupled):
    """Phase 23: the multi-device fluid's row bands on one card (a.-d.)."""
    from lpe_tpu_torch.parallel.dryrun import dryrun_multichip
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    from lpe_tpu_torch.systems import build_run_fn
    t0 = time.perf_counter()
    out = dict(card=card, migrate=band_migrate(dev, card))
    sc = build_dam_break(DAM_N, device=dev)
    cfg = fluid_cfg(sc.cfg, pair_backend="pallas")
    run = build_run_fn(sc.spec, cfg, ticks=BLOCK, device=dev)
    runs = {"single device": (run, run(sc.state))}
    for D in BAND_COUNTS:
        out[f"dam_d{D}"], runs[f"{D} bands"] = band_dam(dev, card, D)
    out["dam_ticks_per_s"] = band_tps(card, runs)
    out[f"coupled_d{BAND_MIGRATE_D}"] = band_coupled(dev, card, coupled)
    out["dryrun"] = dryrun_multichip(4, device=dev)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 24: entity sharding (gravity by receiver blocks, the grid rigid
# pipeline in y-row bands), the bands all on this card
SHARD_COUNTS = (2, 4)
RIGID_BAND_BLOCK = 3     # ticks a rigid band block (a 10k tick: host-bound)
GRAVITY_BAND_BLOCK = 2   # ticks a galaxy block
BAND_ROUNDS = 2          # rounds of rigid_band_tps
# the grid rigid pipeline in bands against one device: lpe_tpu's sharded
# tolerances (tests/test_parallel.py:108-112, vel as omega)
RIGID_BAND_TOL = dict(pos=1e-5, vel=1e-4, omega=1e-4)
NP_NAMES = ("hit", "nrm", "pen", "pts", "pens", "cval", "pos_a", "pos_b")


def grid_np_bound(RK, nargs, kw, outs):
    """(bound ms, bound by) of narrowphase_grid on ``nargs``: its inputs
    and outputs once over 3.35 TB/s, or its operations (phase 8's count:
    each staged body's ring ~24 a vertex, then per row the n^2 projections
    of 3 each and ~40 for the clip) over 67 TFLOP/s."""
    a, b = RK.grid_rows(*nargs, **kw)
    n = (a[3] + b[3]).double().clamp(min=0)
    bodies = float(nargs[3].double().sum() + nargs[7].double().sum())
    return bound(nbytes(*nargs, *outs),
                 24 * bodies + float((3 * n * n + 40).sum()))


def band_narrowphase(card, rrun, rstate):
    """Phase 24a: at RIGID_STACKS 10k's rows 40 ticks in (phase 7's
    state), the rows cut into D y-row bands (rigid_kernels.grid_band: a
    band's grids hold its rows and the row below them), D = 2 and 4:
    narrowphase_grid on each band's rows equals its plain version (every
    candidate row; whether every row is printed) and the whole grid's
    kernel on those rows (every row), to the bit; each band's launch timed
    (cuda_ms, L2 flushed) beside the whole grid's and beside its bound."""
    from lpe_tpu_torch.ops import rigid_kernels as RK
    nargs, kw, valid = rrun.systems["rigid"].narrowphase_args(rstate)
    nbx, R = kw["nbx"], valid.shape[1]
    whole = RK.narrowphase_grid(*nargs, **kw)
    whole_ms = cuda_ms(lambda: RK.narrowphase_grid(*nargs, **kw))
    whole_bnd = grid_np_bound(RK, nargs, kw, whole)
    out = dict(whole_ms=whole_ms, whole_bound_ms=whole_bnd[0],
               whole_bound_by=whole_bnd[1])
    for D in SHARD_COUNTS:
        rows = nbx // D
        res = []
        for i in range(D):
            band = RK.grid_band(nargs, nbx=nbx, r0=i * rows, rows=rows)
            got = RK.narrowphase_grid(*band, **kw)
            ref = RK.narrowphase_grid_plain(*band, **kw)
            cut = slice(i * rows * nbx * R, (i + 1) * rows * nbx * R)
            v = valid[i * rows * nbx:(i + 1) * rows * nbx].reshape(-1)
            off_whole = [nm for nm, g, w in zip(NP_NAMES, got, whole)
                         if not tensor_bits_equal(g, w[cut])]
            off_plain = [nm for nm, g, r in zip(NP_NAMES, got, ref)
                         if not tensor_bits_equal(g[v], r[v])]
            if off_whole or off_plain:
                fail(f"band narrowphase: band {i} of {D} differs from the "
                     f"whole grid's rows in {off_whole or 'nothing'}, from "
                     f"its plain version in {off_plain or 'nothing'}")
            every = all(tensor_bits_equal(g, r) for g, r in zip(got, ref))
            ms = cuda_ms(lambda band=band: RK.narrowphase_grid(*band, **kw))
            bnd = grid_np_bound(RK, band, kw, got)
            res.append(dict(ms=ms, bound_ms=bnd[0], bound_by=bnd[1],
                            candidate_rows=int(v.sum()),
                            every_row_equals_plain=every))
        out[f"d{D}"] = res
        print(f"band narrowphase at RIGID_STACKS {RIGID_N}'s rows in {D} "
              f"y-row bands of {rows} cell rows (+1 halo row): each band "
              f"equal to the bit to the whole grid's kernel on its rows and "
              f"to its plain version on its candidate rows (every row "
              f"{[r['every_row_equals_plain'] for r in res]}); ms a band "
              + ", ".join(f"{r['ms']:.4f}" for r in res) +
              f" (sum {sum(r['ms'] for r in res):.4f}), bound "
              + ", ".join(f"{r['bound_ms']:.4f}" for r in res) +
              f" ms ({res[0]['bound_by']}); whole grid {whole_ms:.4f} ms, "
              f"bound {whole_bnd[0]:.4f} ms; on {card}", flush=True)
    return out


def sync_count(fn):
    """(fn(), the host syncs it made by source line "file:line"):
    set_sync_debug_mode("warn") warns at each synchronizing CUDA call,
    from the Python line that made it."""
    import collections
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def guard_line() -> str:
    """"file:line" of the grid rigid pipeline's guard read."""
    from lpe_tpu_torch.systems.rigid import grid_pipeline
    src = Path(grid_pipeline.__file__)
    n = next(i for i, line in enumerate(src.read_text().splitlines(), 1)
             if "bool(need)" in line)
    return f"{src.name}:{n}"


def state_gaps(a, b, rows):
    """max |d| of pos, vel, angle, omega over the bodies ``rows`` of two
    states, and whether they are equal to the bit."""
    gaps = {f: max_err(getattr(a.bodies, f)[rows], getattr(b.bodies, f)[rows])
            for f in ("pos", "vel", "angle", "omega")}
    gaps["bitwise"] = all(same_bits(getattr(a.bodies, f)[rows],
                                    getattr(b.bodies, f)[rows])
                          for f in ("pos", "vel", "angle", "omega"))
    return gaps


def hold_rigid_bands(label, g):
    if not all(g[f] <= tol for f, tol in RIGID_BAND_TOL.items()):
        fail(f"{label}: differs from the single device beyond "
             f"{RIGID_BAND_TOL}: {g}")


def rigid_bands(card, rsc, rstate):
    """Phase 24b: RIGID_STACKS 10k from phase 7's state (40 ticks in) in
    2 and 4 y-row bands through build_sharded_run(ticks=RIGID_BAND_BLOCK),
    beside the single device: a first block against the single device's
    (bits printed, RIGID_BAND_TOL held); one counted block
    (narrowphase_grid D times a tick, nothing else, no plain version) whose
    host syncs are counted (the guard's one a tick, nothing else); the
    exchange's bytes and copies a tick; two blocks from one state equal to
    the bit; ticks/s of the single device and both band counts timed in
    turn (band_tps's rounds); kernel launches a tick of each (profiler)."""
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.parallel import make_mesh
    from lpe_tpu_torch.parallel.sharded import build_sharded_run
    from lpe_tpu_torch.scene import Scene
    from lpe_tpu_torch.systems import build_run_fn
    dev = rstate.bodies.pos.device
    S = rsc.spec.n_solid
    scene = Scene(state=rstate, spec=rsc.spec, cfg=rsc.cfg)
    single = build_run_fn(rsc.spec, rsc.cfg, ticks=RIGID_BAND_BLOCK,
                          device=dev)
    want = single(rstate)
    _, single_syncs = sync_count(lambda: single(rstate))
    guard = guard_line()
    out = dict(single_syncs=dict(single_syncs))
    runs = {"single device": (single, want)}
    # one-tick runs for the profiler's launch counts (a block of the
    # bands would hand it ~10^5 launches a tick to unpack)
    tick1 = {"single device": build_run_fn(rsc.spec, rsc.cfg, ticks=1,
                                           device=dev)}
    for D in SHARD_COUNTS:
        label = f"rigid {RIGID_N} in {D} y-row bands"
        mesh = make_mesh(devices=[dev] * D)
        run = build_sharded_run(scene, mesh, ticks=RIGID_BAND_BLOCK)
        tick1[f"{D} bands"] = build_sharded_run(scene, mesh, ticks=1)
        step = run.systems["rigid"]
        if step.bands != D:
            fail(f"{label}: build_sharded_run did not take the band path")
        got = run(rstate)
        g = state_gaps(got, want, slice(0, S))
        hold_rigid_bands(label, g)
        step.halo_stats.update(bytes=0, copies=0, split_bytes=0)
        step.guard_reads = 0
        RK.reset_counters()
        SK.reset_counters()
        state, syncs = sync_count(lambda: run(got))
        launches = {op.name: op.launches for op in (*SK.OPS, *RK.OPS)
                    if op.launches}
        plain = {op.name: op.plain_calls for op in (*SK.OPS, *RK.OPS)
                 if op.plain_calls}
        ticks = RIGID_BAND_BLOCK
        if launches != {"narrowphase_grid": D * ticks} or plain:
            fail(f"{label}: launches {launches}, plain calls {plain}")
        if syncs != {guard: ticks} or step.guard_reads != ticks:
            fail(f"{label}: host syncs {dict(syncs)} and {step.guard_reads} "
                 f"guard reads in a block of {ticks} ticks (the guard's "
                 f"{guard} once a tick expected, nothing else)")
        hs = {k: v / ticks for k, v in step.halo_stats.items()}
        a, b = run(state), run(state)
        differ = [n for part in ("", "bodies")
                  for n, u, w in state_fields(a, b, part)
                  if not tensor_bits_equal(u, w)]
        if differ:
            fail(f"{label}: two blocks from one state differ in {differ}")
        out[f"d{D}"] = dict(launches_per_tick={
            k: v / ticks for k, v in launches.items()},
            host_syncs_per_tick=syncs[guard] / ticks,
            exchange_bytes_per_tick=hs["bytes"],
            exchange_copies_per_tick=hs["copies"],
            split_bytes_per_tick=hs["split_bytes"], one_block=g)
        print(f"{label}: on {card}; narrowphase_grid {D * ticks} launches "
              f"in {ticks} ticks, no plain call; host syncs {dict(syncs)} "
              f"(the guard's, one a tick; the single device's block "
              f"{dict(single_syncs)});"
              f" exchange {hs['bytes']:.0f} bytes and {hs['copies']:.0f} "
              f"copies a tick, {hs['split_bytes']:.0f} bytes to the bands "
              f"and back; two blocks from one state bitwise equal; one "
              f"block of {ticks} against the single device: max |dpos| "
              f"{g['pos']:.3e} m, |dvel| {g['vel']:.3e} m/s, |domega| "
              f"{g['omega']:.3e} rad/s, bitwise {g['bitwise']}", flush=True)
        runs[f"{D} bands"] = (run, state)
    out["ticks_per_s"] = band_tps(card, runs, rounds=BAND_ROUNDS, blocks=1,
                                  what=f"rigid {RIGID_N}",
                                  block=RIGID_BAND_BLOCK)
    out["launches_per_tick"] = {
        k: profiled_launches(lambda: tick1[k](st))
        for k, (_, st) in runs.items()}
    print(f"rigid {RIGID_N}: kernel launches a tick (profiler, one tick "
          f"each) " + ", ".join(f"{k} {v:.0f}" for k, v in
                                out["launches_per_tick"].items()) +
          f" on {card}", flush=True)
    return out


def profiled_launches(fn):
    """Kernel launches on the card while ``fn`` runs (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lpe_tpu_torch.profile_tick import _kernel_times
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _kernel_times(prof, set())[1]


def galaxy_shards(card, label, settled):
    """Phase 24c: a galaxy (its settled state from phase 18 or 19) in 2
    and 4 shards through build_sharded_run(ticks=GRAVITY_BAND_BLOCK): no
    port kernel and no plain version, the block equal to the single
    device's to the bit in every state field, kernel launches a tick
    (profiler), ticks/s beside the single device (each timed once, in
    turn)."""
    import torch
    from lpe_tpu_torch.parallel import make_mesh
    from lpe_tpu_torch.parallel.sharded import build_sharded_run
    from lpe_tpu_torch.scene import Scene
    from lpe_tpu_torch.systems import build_run_fn
    spec, cfg, state = settled
    dev = state.bodies.pos.device
    scene = Scene(state=state, spec=spec, cfg=cfg)
    ticks = GRAVITY_BAND_BLOCK
    single = build_run_fn(spec, cfg, ticks=ticks, device=dev)
    want = single(state)
    out = {}
    runs = {"single device": (single, state)}
    for D in SHARD_COUNTS:
        run = build_sharded_run(scene, make_mesh(devices=[dev] * D),
                                ticks=ticks)
        step = run.systems["barnes_hut"]
        if step.devices is None or len(step.devices) != D:
            fail(f"{label} in {D} shards: gravity is not split")
        got, _, launches, plain = timed_blocks(run, state, 1, ticks)
        if launches or plain:
            fail(f"{label} in {D} shards: launches {launches}, plain {plain}")
        differ = [n for part in ("", "bodies")
                  for n, u, w in state_fields(got, want, part)
                  if not tensor_bits_equal(u, w)]
        if differ:
            fail(f"{label} in {D} shards differs from the single device in "
                 f"{differ}")
        out[f"d{D}"] = dict(bitwise=True)
        runs[f"{D} shards"] = (run, state)
    tps = {}
    for k, (run, st) in runs.items():
        _, t, _, _ = timed_blocks(run, st, 1, ticks)
        tps[k] = t
        n = profiled_launches(lambda: run(st)) / ticks
        out[k.replace(" ", "_")] = dict(ticks_per_s=t, launches_per_tick=n)
    print(f"{label} in " + " and ".join(str(D) for D in SHARD_COUNTS) +
          f" shards (receiver blocks over the mesh, one card): a block of "
          f"{ticks} equal to the single device's to the bit in every state "
          f"field; ticks/s and kernel launches a tick " + "; ".join(
              f"{k} {v['ticks_per_s']:.3f}, {v['launches_per_tick']:.0f}"
              for k, v in out.items() if "ticks_per_s" in v) +
          f" (host clock, synchronized, one block each in turn) on {card}",
          flush=True)
    return out


def north_bands(card, settled):
    """Phase 24d: the north star (phase 12's settled state) with the split
    fluid (pair_backend="pallas") in 4 row bands and its grid rigids in 4
    y-row bands: one tick against the single-device split tick, the
    liquid at phase 23's tolerances (hold_bands), the rigids at
    RIGID_BAND_TOL."""
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.parallel import make_mesh
    from lpe_tpu_torch.parallel.sharded import build_sharded_tick
    from lpe_tpu_torch.scene import Scene
    from lpe_tpu_torch.systems import build_tick_fn
    spec, cfg, state = settled
    dev = state.bodies.pos.device
    D = SHARD_COUNTS[-1]
    label = f"north star {NORTH} split, fluid and rigids in {D} bands"
    cfg = fluid_cfg(cfg, pair_backend="pallas")
    tick = build_sharded_tick(Scene(state=state, spec=spec, cfg=cfg),
                              make_mesh(devices=[dev] * D))
    if getattr(tick.systems["fluid"], "mesh", None) is None or \
            tick.systems["rigid"].bands != D:
        fail(f"{label}: not both in bands")
    want = build_tick_fn(spec, cfg, device=dev)(state)
    RK.reset_counters()
    got = tick(state)
    if RK.narrowphase_grid.launches != D or RK.narrowphase_grid.plain_calls:
        fail(f"{label}: narrowphase_grid launches "
             f"{RK.narrowphase_grid.launches}, plain calls "
             f"{RK.narrowphase_grid.plain_calls}")
    g = band_gaps(got, want, spec)
    hold_bands(label, g)
    rg = state_gaps(got, want, slice(0, spec.n_solid))
    hold_rigid_bands(label, rg)
    print(f"{label}: one tick against the single-device split tick on "
          f"{card}: max |dpos| {g['dpos']:.3e} m, |dvel| {g['dvel']:.3e} "
          f"m/s, liquid bitwise {g['liquid_bitwise']}; rigids |dpos| "
          f"{rg['pos']:.3e} m, |dvel| {rg['vel']:.3e} m/s, |domega| "
          f"{rg['omega']:.3e} rad/s, bitwise {rg['bitwise']}", flush=True)
    return dict(liquid=g, rigids=rg)


def run_entity_shards(dev, card, rigid, galaxies, north):
    """Phase 24: entity sharding on one card (a.-e.)."""
    from lpe_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    rsc, rrun, rstate = rigid
    out = dict(card=card, narrowphase=band_narrowphase(card, rrun, rstate),
               rigid=rigid_bands(card, rsc, rstate))
    for name, settled in galaxies.items():
        out[name] = galaxy_shards(card, name, settled)
    out["north"] = north_bands(card, north)
    out["dryrun"] = dryrun_multichip(SHARD_COUNTS[-1], device=dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"entity sharding: phase 24 in {out['seconds']:.2f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 25: the rigid list pipeline over the mesh (its narrowphase by runs
# of pairs, its solvers' rows by runs of rows), every shard on this card
LIST_SHARDS = 4           # the coupled dam's bands and list shards
LIST_BLOCK = 3            # ticks a coupled dam block
LIST_ROUNDS = 3           # rounds of its ticks/s, timed in turn
LIST_POLY_TICKS = 10      # RANDOM_POLYGONS' ticks against the single device
LIST_CACHES = ("warm_normal", "warm_tangent", "warm_ia", "warm_ib",
               "warm_pt", "warm_n")


def list_launches(tick, state):
    """One tick of ``tick`` from ``state`` under torch.profiler: (kernel
    launches on the card, launches in each rigid list range)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lpe_tpu_torch.profile_tick import (LIST_RANGES, _kernel_times,
                                            _range_launches)
    tick(state)                                 # nothing first-call left
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tick(state)
        torch.cuda.synchronize()
    return (_kernel_times(prof, set(LIST_RANGES))[1],
            _range_launches(prof, LIST_RANGES))


def caches_bitwise(a, b):
    return all(tensor_bits_equal(getattr(a, f), getattr(b, f))
               for f in LIST_CACHES)


def list_coupled(card, coupled):
    """Phase 25a: the coupled dam (phase 10's settled split state) with its
    fluid in LIST_SHARDS row bands and its list pipeline in LIST_SHARDS
    shards through build_sharded_run(ticks=LIST_BLOCK): a block against the
    single device's (the liquid at phase 23's tolerances, the rigids at
    RIGID_BAND_TOL; bits printed), and its rigids and warm caches
    against the block with the fluid in bands and the list pipeline whole,
    to the bit (what the list split itself changes: none); one counted block (migrate, density,
    force and coupling 10 D times a tick, nothing else, no plain version)
    whose host syncs are counted (none beyond the single device's block);
    the split's copies and bytes a tick; two blocks from one state equal
    to the bit; kernel launches a tick (profiler) beside the single
    device's, the rigid.narrowphase, .velocity and .position ranges
    apart; ticks/s beside the single device timed in turn."""
    import torch
    from lpe_tpu_torch.parallel import make_mesh
    from lpe_tpu_torch.parallel.sharded import (build_sharded_run,
                                                 build_sharded_tick)
    from lpe_tpu_torch.scene import Scene
    from lpe_tpu_torch.systems import build_run_fn, build_tick_fn
    spec, cfg, settled = coupled
    dev = settled.bodies.pos.device
    D = LIST_SHARDS
    ticks = LIST_BLOCK
    label = (f"coupled dam {COUPLED} split, fluid in {D} bands, list "
             f"pipeline in {D} shards")
    scene = Scene(state=settled, spec=spec, cfg=cfg)
    mesh = make_mesh(devices=[dev] * D)
    single = build_run_fn(spec, cfg, ticks=ticks, device=dev)
    run = build_sharded_run(scene, mesh, ticks=ticks)
    step = run.systems["rigid"]
    if getattr(run.systems["fluid"], "mesh", None) is not mesh or \
            step.shards != D:
        fail(f"{label}: fluid bands {run.systems['fluid'].mesh}, list "
             f"shards {step.shards}")
    want = single(settled)
    got = run(settled)
    g = band_gaps(got, want, spec)
    hold_bands(label, g)
    rg = state_gaps(got, want, slice(0, spec.n_solid))
    hold_rigid_bands(label, rg)
    rg["caches_bitwise"] = caches_bitwise(got, want)
    # the same block with the fluid in bands and the list pipeline whole:
    # what the list split itself changes
    alone = build_run_fn(spec, cfg, ticks=ticks, device=dev,
                         fluid_mesh=mesh)(settled)
    rg["bitwise_to_fluid_bands_alone"] = state_gaps(
        got, alone, slice(0, spec.n_solid))["bitwise"] and \
        caches_bitwise(got, alone)
    if not rg["bitwise_to_fluid_bands_alone"]:
        fail(f"{label}: the rigids or warm caches differ from the block with "
             f"the fluid in bands and the list pipeline whole: the list "
             f"split changed bits")
    from lpe_tpu_torch.ops import rigid_kernels as RK
    from lpe_tpu_torch.ops import sph_kernels as SK
    _, single_syncs = sync_count(lambda: single(settled))
    step.shard_stats.update(copies=0, bytes=0)
    SK.reset_counters()
    RK.reset_counters()
    got, syncs = sync_count(lambda: run(settled))
    ops = (*SK.OPS, *RK.OPS)
    launches = {op.name: op.launches for op in ops if op.launches}
    plain = {op.name: op.plain_calls for op in ops if op.plain_calls}
    if launches != want_band_launches(D, ticks) or plain:
        fail(f"{label}: launches {launches}, expected "
             f"{want_band_launches(D, ticks)}; plain calls {plain}")
    extra = syncs - single_syncs
    if extra:
        fail(f"{label}: host syncs {dict(syncs)} beyond the single "
             f"device's {dict(single_syncs)}")
    stats = {k: v / ticks for k, v in step.shard_stats.items()}
    a, b = run(settled), run(settled)
    differ = [n for part in ("", "bodies")
              for n, u, w in state_fields(a, b, part)
              if not tensor_bits_equal(u, w)]
    if differ:
        fail(f"{label}: two blocks from one state differ in {differ}")
    n1, r1 = list_launches(build_tick_fn(spec, cfg, device=dev), settled)
    nD, rD = list_launches(build_sharded_tick(scene, mesh), settled)
    print(f"{label}: on {card}; one block of {ticks} against the single "
          f"device's: liquid max |dpos| {g['dpos']:.3e} m, |dvel| "
          f"{g['dvel']:.3e} m/s, bitwise {g['liquid_bitwise']}; rigids "
          f"|dpos| {rg['pos']:.3e} m, |dvel| {rg['vel']:.3e} m/s, |domega| "
          f"{rg['omega']:.3e} rad/s, bitwise {rg['bitwise']}, warm caches "
          f"bitwise {rg['caches_bitwise']}; against the fluid in bands with "
          f"the list pipeline whole: rigids and caches bitwise "
          f"{rg['bitwise_to_fluid_bands_alone']}; kernel launches "
          f"{launches}, no plain call; host syncs {dict(syncs)} (the "
          f"single device's {dict(single_syncs)}); the list split's "
          f"{stats['copies']:.0f} copies and {stats['bytes']:.0f} bytes a "
          f"tick; two blocks from "
          f"one state bitwise equal; launches a tick (profiler) {nD} "
          f"beside {n1}: " + ", ".join(
              f"{k.removeprefix('rigid.')} {rD[k]} beside {r1[k]}"
              for k in ("rigid.narrowphase", "rigid.velocity",
                        "rigid.position")), flush=True)
    tps = band_tps(card, {"single device": (single, settled),
                          f"{D} bands and shards": (run, settled)},
                   rounds=LIST_ROUNDS, blocks=1,
                   what=f"coupled dam {COUPLED} split", block=ticks)
    return dict(shards=step.shards, liquid=g, rigids=rg, launches=launches,
                host_syncs=dict(syncs), single_host_syncs=dict(single_syncs),
                copies_per_tick=stats["copies"], bytes_per_tick=stats["bytes"],
                launches_per_tick=dict(single=n1, split=nD),
                range_launches_per_tick=dict(single=r1, split=rD),
                ticks_per_s=tps)


def list_polygons(card, dev):
    """Phase 25b: RANDOM_POLYGONS (seed 1) in 2 and 4 shards, LIST_POLY_TICKS
    ticks against the single device (RIGID_BAND_TOL; bits printed), and
    kernel launches a tick (profiler) beside the single device's."""
    from lpe_tpu_torch.parallel import make_mesh
    from lpe_tpu_torch.parallel.sharded import (build_sharded_run,
                                                 build_sharded_tick)
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems import build_run_fn, build_tick_fn
    sc = create_scenario("RANDOM_POLYGONS", seed=1, device=dev)
    ticks = LIST_POLY_TICKS
    want = build_run_fn(sc.spec, sc.cfg, ticks=ticks, device=dev)(sc.state)
    n1, _ = list_launches(build_tick_fn(sc.spec, sc.cfg, device=dev),
                          sc.state)
    out = dict(single_launches_per_tick=n1)
    for D in SHARD_COUNTS:
        label = f"RANDOM_POLYGONS in {D} shards"
        mesh = make_mesh(devices=[dev] * D)
        run = build_sharded_run(sc, mesh, ticks=ticks)
        if run.systems["rigid"].shards != D:
            fail(f"{label}: {run.systems['rigid'].shards} shards")
        got = run(sc.state)
        g = state_gaps(got, want, slice(0, sc.spec.n_solid))
        hold_rigid_bands(label, g)
        g["caches_bitwise"] = caches_bitwise(got, want)
        nD, _ = list_launches(build_sharded_tick(sc, mesh), sc.state)
        print(f"{label}: {ticks} ticks against the single device on "
              f"{card}: max |dpos| {g['pos']:.3e} m, |dvel| {g['vel']:.3e} "
              f"m/s, |domega| {g['omega']:.3e} rad/s, bitwise "
              f"{g['bitwise']}, warm caches bitwise {g['caches_bitwise']}; "
              f"launches a tick (profiler) {nD} beside {n1}", flush=True)
        out[f"d{D}"] = dict(g, launches_per_tick=nD)
    return out


def run_list_shards(dev, card, coupled):
    """Phase 25: the rigid list pipeline over the mesh on one card (a., b.;
    c. is phase 24e's dry run, whose line carries the list split)."""
    t0 = time.perf_counter()
    out = dict(card=card, coupled=list_coupled(card, coupled),
               polygons=list_polygons(card, dev))
    out["seconds"] = time.perf_counter() - t0
    print(f"list pipeline over the mesh: phase 25 in {out['seconds']:.2f} "
          f"s", flush=True)
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=Path, nargs="+", metavar="DIR",
                    help="time the SPH kernels and the grid narrowphase "
                         "of the trees DIR (e.g. the parent commit) and of "
                         "this checkout alternately, and do nothing else")
    ap.add_argument("--kernel-times", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    for root in (ROOT, *(a.compare or ()), a.kernel_times):
        if root is not None and \
                not (root / "lpe_tpu_torch" / "ops" / "csrc").is_dir():
            fail(f"not a checkout: no lpe_tpu_torch package in {root}")
    if a.kernel_times is not None:
        print(json.dumps(kernel_times(a.kernel_times.resolve())), flush=True)
        return 0
    if a.compare is not None:
        print(card_line(), flush=True)
        compare([d.resolve() for d in a.compare])
        return 0
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. build
    from lpe_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s -> "
          f"{path.relative_to(ROOT)}", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  nvcc:", line.strip(), flush=True)

    # 3.-6.
    errs, times, bounds, twins, k64 = check_kernels(dev)
    stacked = dict(migrate=1, pair_sweep=1, coupling9=1)
    launches, run, state, _ = run_dam(dev, card, stacked)
    run_simple_fluid(dev, card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    state = run(state)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(state.bodies.pos).all()):
        fail("sync-free block: non-finite positions")
    print("dam block under set_sync_debug_mode('error'): no host sync",
          flush=True)

    # 6a.-6c. the split kernels' paths: each kernel's launches are those
    # of the path that runs it (kernels 1-3: the default dam run above)
    split = dict(migrate=1, density=1, force=1, coupling=1)
    ls, _, sstate, ssc = run_dam(dev, card, split, pair_backend="pallas")
    launches.update({k: ls[k] for k in ("density", "force", "coupling")})
    twins["split_tick"] = check_split_tick(dev, ssc, sstate)
    twins["scatter_tick"] = run_dam_scatter(dev, card)
    run_simple_fluid(dev, card, reps=1, pair_backend="pallas")
    # 6d. the dam built at K = 64 (the reference's cap)
    for label, same in run_dam_k64(dev, ssc, sstate).items():
        twins[f"k64_tick_{label}_equals_k16"] = same

    # 7.-8. the rigid tick runs the grid kernel; the row form, which it
    # replaces there, is no longer on a path
    (launches["narrowphase_grid"], rrun, rstate, twins["rigid_xla_tick"],
     rsc) = run_rigid(dev, card)
    launches["narrowphase"] = 0
    for name, (e, t, bnd) in check_narrowphase(rstate, rrun).items():
        errs[name], times[name], bounds[name] = e, t, bnd

    # 10.-15. the scenes of the rigid list pipeline, and the north star
    paths, coupled, coupled_split = run_coupled(dev, card)
    paths.update(run_scenes(dev, card))
    paths["north"], north, north_settled = run_north(dev, card)

    # 17.-20. N-body gravity and the scenes it opens
    paths["keplerian"] = run_keplerian(dev, card)
    paths["galaxy_direct"], direct, gal_direct = run_galaxy_direct(dev,
                                                                    card)
    paths["galaxy"], gparts, gal_1m = run_galaxy(dev, card)
    paths["planetary_ocean"], ocean = run_ocean(dev, card)

    # 21. the application layer: the CLI, the renderer, the HUD
    app = run_app(dev, card)

    # 22. mixed per-particle smoothing lengths: the h chain on the card
    mixed, hkern, hl = run_mixed_h(dev, card)
    for name, (e, t, bnd) in hkern.items():
        errs[name], times[name], bounds[name] = e, t, bnd
        launches[name] = hl[name]

    # 23. the multi-device fluid: its row bands on one card
    bands = run_bands(dev, card, coupled_split)
    for key in (*(f"dam_d{D}" for D in BAND_COUNTS),
                f"coupled_d{BAND_MIGRATE_D}"):
        paths[f"bands_{key}"] = bands[key]["launches"]

    # 24. entity sharding: gravity by receiver blocks and the grid rigid
    # pipeline in y-row bands, all on this card
    shards = run_entity_shards(
        dev, card, (rsc, rrun, rstate),
        {"galaxy_direct_100k": gal_direct, "galaxy_1m": gal_1m},
        north_settled)
    band_np = {f"d{D}": shards["rigid"][f"d{D}"]["launches_per_tick"]
               ["narrowphase_grid"] * RIGID_BAND_BLOCK for D in SHARD_COUNTS}
    paths["shards_rigid"] = band_np

    # 25. the rigid list pipeline over the mesh: the coupled dam's fluid in
    # row bands and its list pipeline in shards, RANDOM_POLYGONS in shards,
    # all on this card
    shards["list"] = run_list_shards(dev, card, coupled_split)

    # 16. results (after 17-24): no single PyTorch call computes any of
    # these kernels
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=times[name][0], plain_ms=times[name][1],
                    bound_ms=bounds[name][0], bound_by=bounds[name][1],
                    library_ms=None)
               for name, (src, rep) in KERNEL_INFO.items()]
    for k in kernels:     # phase 24b's band blocks, one of RIGID_BAND_BLOCK
        if k["name"] == "narrowphase_grid":
            k["band_launches"] = band_np
    print(json.dumps({"bitwise_twins": twins}), flush=True)
    print(json.dumps({"kernels_at_k64_folded": k64}), flush=True)
    print(json.dumps({"path_launches": paths}), flush=True)
    print(json.dumps({"couplings_on_moving_rigids": {
        scene: {name: dict(max_abs_err=e, ms=t[0], plain_ms=t[1],
                           bound_ms=b[0], bound_by=b[1])
                for name, (e, t, b) in res.items()}
        for scene, res in (("coupled_dam", coupled), ("north_star", north),
                           ("planetary_ocean", ocean)) if res}}), flush=True)
    print(json.dumps({"gravity_parts": {
        name: dict(ms=t, bound_ms=b, bound_by=by) for name, (t, b, by) in
        (("direct_sum_100k", direct), *((f"{k}_1m", v)
                                        for k, v in gparts.items()))}}),
        flush=True)
    print(json.dumps({"app": app}), flush=True)
    print(json.dumps({"mixed_h": mixed}), flush=True)
    print(json.dumps({"bands": bands}), flush=True)
    print(json.dumps({"shards": shards}), flush=True)
    print(json.dumps({"coupling_oracle": {
        "spread_max": max(c["spread"] for c in COUPLE_ORACLE),
        "worst_err_over_limit": max(c["partials_err"] / c["limit"]
                                    for c in COUPLE_ORACLE),
        "checks": COUPLE_ORACLE}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
