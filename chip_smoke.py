#!/usr/bin/env python3
"""Drive the lpe_tpu_torch port once on an NVIDIA GPU and check it.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --compare PARENT_DIR [OTHER_DIR ...]

The second form only times the SPH kernels of other trees and this one,
alternated on one card (see compare()); the phases below are the first.

Phases (any failure raises and exits non-zero, printing no result):
  1. require CUDA; print the card (nvidia-smi name, power limit), torch and
     CUDA versions;
  2. build the seven CUDA kernels of ops/csrc/ with nvcc (timed);
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
  16. print the bitwise twin checks as a JSON line, the K = 64 kernels,
     the launches of each new path, the couplings on moving rigids, the
     kernels' JSON line, then the result line.
Every kernel's line carries its bound: the larger of the bytes it must
move on these inputs (slot_bytes, coupling9_bytes, coupling_bytes: what
an empty slot or a cell that does not couple holds is counted only where
an output needs it) over 3.35 TB/s and the operations this run's data
needs over the 67 TFLOP/s fp32 rate (H100 SXM, published peaks).
This script imports no jax and nothing of the lpe_tpu package.
"""
from __future__ import annotations

import json
import subprocess
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
CPL_OPS_PER_VERT, CPL_OPS = 25, 60


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
               "force": 7}         # x, y, vx, vy, m, rho, p of D8


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


def sub_step_inputs(SK, fl, state, ST):
    """Every SPH kernel's inputs on one sub-step from ``ST``, each fed by
    the kernel before it: M9 (migrate), the sweep's rho, fx, fy, the split
    kernels' planes D4 (density), D8 (force) and D10 (coupling: second kick
    and EOS applied), and two candidate sets: the main path's own (the
    boundary margin keeps the dam's fluid off its walls, so its cells copy
    through) and with the floor wall moved into the fluid (moved_wall), so
    that the candidate math runs on every occupied cell."""
    import torch
    ck = fl.couple_consts
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    M9 = SK.migrate(ST, **fl.migrate_consts)
    sw = SK.pair_sweep(M9, **fl.sweep_consts)
    x1, y1, vx0, vy0, m, occ, hx, hy, _ = M9.unbind(1)
    rp, ax1, ay1 = (pad(v) for v in sw)
    cpl, fld, big = fl.coupling_inputs(state, M9)
    live = (occ.sum(1) > 0).to(torch.int32).contiguous()
    return dict(
        M9=M9, sw=sw, D4=torch.stack([x1, y1, m, occ], 1),
        D8=torch.stack([x1, y1, vx0, vy0, m, rp, fl.eos(rp), occ], 1),
        D10=torch.stack([x1, y1, hx + ck["half_dt"] * ax1,
                         hy + ck["half_dt"] * ay1, rp, fl.eos(rp), m, occ,
                         ax1, ay1], 1),
        cands={"main": (cpl, fld, big),
               "wall": (live, *moved_wall(SK, M9, fld, big, ck["V"]))})


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


def couple_check(name, label, op, a, ck, slots):
    """A coupling kernel's outputs on arguments ``a``, whose cells hold up
    to ``slots`` live particles, against its plain version's: (outputs,
    max abs error, nonzero partials)."""
    out = op(*a, cn=ck)
    st_k, a_k, pl_k, big_k = couple_views(name, out)
    st_p, a_p, pl_p, big_p = couple_views(name, op.plain(*a, cn=ck))
    st_err = max_err(st_k, st_p)
    a_err = max_err(a_k, a_p)
    a_scale = float(a_p.abs().max())
    # partials: per (row, slot, column) and per (row, block) sums,
    # elementwise, to 1e-5 plus 1e-6 of the largest for each 16 live slots
    # a cell may hold (float32 ulps of a block's sum over up to 32 x slots
    # particles, which the plain version adds with index_add_ in an order
    # that varies by run on the card)
    pl_err = max_err(pl_k, pl_p)
    big_err = max_err(big_k, big_p)
    part_scale = max(float(pl_p.abs().max()),
                     float(big_p.abs().max()) if big_p.numel() else 0.0)
    contact = int((big_p.abs() > 0).sum() + (pl_p.abs() > 0).sum())
    print(f"{name} ({label}): cells coupled {int((a[0] > 0).sum())}, "
          f"nonzero partials {contact}, state err {st_err:.3e}, accel "
          f"err {a_err:.3e} of {a_scale:.4g}, partials err "
          f"{max(big_err, pl_err):.3e} of {part_scale:.4g}", flush=True)
    if st_err > 1e-5 or a_err > max(1e-5, 1e-6 * a_scale) or \
            max(big_err, pl_err) > 1e-5 + 1e-6 * slots / 16 * part_scale:
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
    sets): ms a launch with L2 flushed before each (``ms``) and back to back
    (``warm``), COMPARE_REPS launches each, and a hash of each kernel's
    output bytes (``bits``)."""
    import hashlib
    sys.path.insert(0, str(root))
    import torch
    from lpe_tpu_torch.ops import _build
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
    """Time the SPH kernels of other trees (each another checkout: ``git
    archive`` of the parent commit, or a copy of this one with a kernel's
    constant changed, in a directory that .gitignore lists) and of this
    checkout, alternated on one card: one process a run, in the order
    trees, this, this, trees reversed (parent, this, this, parent for one
    tree), each building its tree's kernels and running kernel_times.
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
    return launches, run, state, not differ


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


def check_coupled_kernels(run, state, label):
    """coupling9 and coupling on the sub-step from ``state`` with the
    scene's own candidates (moving rigids couple), against their plain
    versions at the smoke's tolerances (couple_check), timed flushed
    (cuda_ms) and bounded. Returns {name: (max abs err, (ms, plain ms),
    (bound ms, bound by))}."""
    from lpe_tpu_torch.ops import sph_kernels as SK
    fl = run.systems["fluid"]
    ST = fl.grid_stack(fl.grid_build(state))
    inp = sub_step_inputs(SK, fl, state, ST)
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
        if contact == 0:
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
    kernel results by name)."""
    import torch
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
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    drun(dstate)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("coupled dam block under set_sync_debug_mode('error'): no host "
          "sync", flush=True)
    a, b = drun(dstate), drun(dstate)
    differ = [n for part in ("", "bodies")
              for n, u, v in state_fields(a, b, part)
              if not tensor_bits_equal(u, v)]
    print(f"coupled dam: two 10-tick blocks from one state bitwise equal in "
          f"every state field {not differ}", flush=True)
    if differ:
        fail(f"coupled dam: two blocks from one state differ in {differ}")
    return paths, kern


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
    return launches, check_coupled_kernels(run, state, "north star")


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


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=Path, nargs="+", metavar="DIR",
                    help="time the SPH kernels of the trees DIR (e.g. the "
                         "parent commit) and of this checkout alternately, "
                         "and do nothing else")
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
    launches["narrowphase_grid"], rrun, rstate, twins["rigid_xla_tick"] = \
        run_rigid(dev, card)
    launches["narrowphase"] = 0
    for name, (e, t, bnd) in check_narrowphase(rstate, rrun).items():
        errs[name], times[name], bounds[name] = e, t, bnd

    # 10.-15. the scenes of the rigid list pipeline, and the north star
    paths, coupled = run_coupled(dev, card)
    paths.update(run_scenes(dev, card))
    paths["north"], north = run_north(dev, card)

    # 16. results: no single PyTorch call computes any of these kernels
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=times[name][0], plain_ms=times[name][1],
                    bound_ms=bounds[name][0], bound_by=bounds[name][1],
                    library_ms=None)
               for name, (src, rep) in KERNEL_INFO.items()]
    print(json.dumps({"bitwise_twins": twins}), flush=True)
    print(json.dumps({"kernels_at_k64_folded": k64}), flush=True)
    print(json.dumps({"path_launches": paths}), flush=True)
    print(json.dumps({"couplings_on_moving_rigids": {
        scene: {name: dict(max_abs_err=e, ms=t[0], plain_ms=t[1],
                           bound_ms=b[0], bound_by=b[1])
                for name, (e, t, b) in res.items()}
        for scene, res in (("coupled_dam", coupled),
                           ("north_star", north))}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
