#!/usr/bin/env python3
"""Drive the lpe_tpu_torch port once on an NVIDIA GPU and check it.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):
  1. require CUDA; print the card (nvidia-smi name, power limit), torch and
     CUDA versions;
  2. build the seven CUDA kernels of ops/csrc/ with nvcc (timed);
  3. at the DAM_BREAK 100k shapes (the grid of the dam scene 40 ticks into
     its collapse), hold each SPH kernel against its plain PyTorch version
     and time both with CUDA events: the stacked chain (migrate, pair_sweep,
     coupling9) and the split kernels (density, force, coupling), the split
     pair also against the pair sweep (the same function by another route);
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
     resident-vs-scatter tolerances);
  6b. DAM_BREAK 100k with residency="off", pair_backend="pallas" (the
     per-tick scatter step), 10 ticks: finite, density and force launched
     10 times a tick, no plain call, two runs bitwise equal;
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
  9. print the kernels' JSON line, then the result line.
Every kernel's line carries its bound: the larger of the bytes it must
move over 3.35 TB/s and the operations this run's data needs over the
67 TFLOP/s fp32 rate (H100 SXM, published peaks).
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


def cuda_ms(fn, reps: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, ops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``n_bytes`` or to do ``ops`` fp32 operations, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def neighbour_pairs(occ):
    """Occupied (particle, neighbour slot) pairs over the 3x3 cells of each
    particle: occ [rows, K, cols] of 0/1."""
    import torch
    n = occ.sum(1).double()                        # particles per cell
    p = torch.nn.functional.pad(n, (1, 1, 1, 1))
    nb = sum(p[1 + dy:p.shape[0] - 1 + dy, 1 + dx:p.shape[1] - 1 + dx]
             for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return float((n * nb).sum())


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at dam-100k shapes."""
    import torch
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    from lpe_tpu_torch.systems import build_run_fn
    from lpe_tpu_torch.systems.fluid import make_fluid

    sc = build_dam_break(DAM_N, device=dev)
    fl = make_fluid(sc.spec, sc.cfg, device=dev)
    run = build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=dev)
    state = sc.state
    for _ in range(WARM_BLOCKS):
        state = run(state)
    ST = fl.grid_stack(fl.grid_build(state))
    print(f"dam {DAM_N}: grid {tuple(ST.shape)} [rows, planes, K, cols], "
          f"nbig={len(sc.spec.solid_big_idx)}", flush=True)
    rows, _, K, W = ST.shape
    if K != 16 or rows != 275 or len(sc.spec.solid_big_idx) != 4:
        fail(f"unexpected dam-100k shapes rows={rows} K={K}")
    mk, sk, ck = fl.migrate_consts, fl.sweep_consts, fl.couple_consts
    M9 = SK.migrate(ST, **mk)
    M9p = SK.migrate_plain(ST, **mk)
    occ = M9p[:, SK.M9_OCC] > 0
    if not torch.equal(M9[:, SK.M9_OCC], M9p[:, SK.M9_OCC]) or \
            not torch.equal(M9[:, SK.M9_ID], M9p[:, SK.M9_ID]):
        fail("migrate: occupancy or ids differ from the plain version")
    errs = {"migrate": max_err(M9, M9p)}
    if errs["migrate"] > 1e-6:
        fail(f"migrate: max abs err {errs['migrate']}")

    sw = SK.pair_sweep(M9, **sk)
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

    # density + EOS + force on the same planes: against their plain
    # versions, and against the pair sweep (one function, two routes)
    pad = lambda v: torch.nn.functional.pad(v, (0, 0, 0, 0, 1, 1))
    x1, y1, vx0, vy0, m, occf, hx, hy, _ = M9.unbind(1)
    dk, fk = fl.density_consts, fl.force_consts
    D4 = torch.stack([x1, y1, m, occf], 1)
    rho = SK.density(D4, **dk)
    rho_pad = pad(rho)
    pres = fl.eos(rho_pad)
    D8 = torch.stack([x1, y1, vx0, vy0, m, rho_pad, pres, occf], 1)
    frc = SK.force(D8, **fk)
    rho_p = SK.density_plain(D4, **dk)
    frc_p = SK.force_plain(D8, **fk)

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30))[o].max())

    errs["density"] = max_err(rho, rho_p)
    errs["force"] = max(max_err(frc[0], frc_p[0]), max_err(frc[1], frc_p[1]))
    sweep_gap = max(max_err(frc[0], sw[1]), max_err(frc[1], sw[2]))
    bad_f = SK.force_plain(D8, **dict(fk, min_rho=rho_q))
    print(f"density: rho rel err {rel(rho, rho_p):.3e} of its plain version, "
          f"{rel(rho, sw[0]):.3e} of the pair sweep's; force: max abs err "
          f"{errs['force']:.3e} of its plain version, {sweep_gap:.3e} of the "
          f"pair sweep's (scale {fscale:.6g}); planted fault: "
          f"{force_misses(bad_f, frc_p)} elements over the limit",
          flush=True)
    if rel(rho, rho_p) > 1e-5 or rel(rho, sw[0]) > 1e-5:
        fail("density differs from its plain version or the pair sweep")
    if force_misses(frc, frc_p) or force_misses(frc, sw[1:]) or \
            force_misses(frc):
        fail("force differs from its plain version or the pair sweep")
    if force_misses(bad_f, frc_p) == 0:
        fail("force: the check missed a planted fault")

    # the couplings twice at these shapes: on the main path's own inputs
    # (the boundary margin keeps the dam's fluid off its walls, so those
    # cells copy through), and with the dam's floor wall moved into the
    # fluid column, both as a big solid and in slot 0 of every cell, so
    # that the kernels' candidate math runs on every occupied cell.
    # coupling9 takes M9 and the sweep's results; coupling takes the same
    # sub-step as planes (second kick and EOS done here)
    cpl, fld, big = fl.coupling_inputs(state, M9)
    live = (M9[:, SK.M9_OCC].sum(1) > 0).to(torch.int32)
    xs = M9[:, SK.M9_X][M9[:, SK.M9_OCC] > 0]
    ys = M9[:, SK.M9_Y][M9[:, SK.M9_OCC] > 0]
    wall = big[3].clone()                       # the floor wall's row
    shift = float(ys.mean()) - float(wall[SK.RW_PY])
    for i in (SK.RW_PY, SK.RW_MINY, SK.RW_MAXY):
        wall[i] += shift
    wall[SK.RW_V0 + 1:SK.RW_V0 + 2 * ck["V"]:2] += shift   # vertex ys
    wall[SK.RW_MINX] = float(xs.min()) - 0.1
    wall[SK.RW_MAXX] = float(xs.max()) + 0.1
    big2 = big.clone()
    big2[3] = wall
    fld2 = fld.clone()
    fld2[:, 0] = wall[:, None]
    ax1, ay1 = pad(sw[1]), pad(sw[2])
    D10 = torch.stack([x1, y1, hx + ck["half_dt"] * ax1,
                       hy + ck["half_dt"] * ay1, pad(sw[0]),
                       fl.eos(pad(sw[0])), m, occf, ax1, ay1], 1)
    cands = ((cpl, fld, big), (live.contiguous(), fld2, big2))
    args2 = (*cands[1], M9, *sw)
    args2s = (*cands[1], D10)
    acc = [SK.ST_AX, SK.ST_AY]
    rest = [f for f in range(9) if f not in acc]
    views = {   # an op's outputs as (state planes, accelerations, PL, bigp)
        "coupling9": lambda out: (out[0][:, rest], out[0][:, acc], out[1],
                                  out[2]),
        "coupling": lambda out: (torch.stack(out[:4]), torch.stack(out[4:6]),
                                 out[6], out[7]),
    }
    for name, op, tail in (("coupling9", SK.coupling9, (M9, *sw)),
                           ("coupling", SK.coupling, (D10,))):
        errs[name] = 0.0
        contact = 0
        for cand in cands:
            a = (*cand, *tail)
            st_k, a_k, pl_k, big_k = views[name](op(*a, cn=ck))
            st_p, a_p, pl_p, big_p = views[name](op.plain(*a, cn=ck))
            st_err = max_err(st_k, st_p)
            a_err = max_err(a_k, a_p)
            a_scale = float(a_p.abs().max())
            # partials: per (row, slot, column) and per (row, block) sums,
            # elementwise, to 1e-5 plus 1e-6 of the largest (float32 ulps
            # of a block's sum over up to 32 x K particles)
            pl_err = max_err(pl_k, pl_p)
            big_err = max_err(big_k, big_p)
            part_scale = max(float(pl_p.abs().max()),
                             float(big_p.abs().max()) if big_p.numel()
                             else 0.0)
            errs[name] = max(errs[name], st_err, big_err, pl_err)
            contact = int((big_p.abs() > 0).sum() + (pl_p.abs() > 0).sum())
            print(f"{name}: cells coupled {int((a[0] > 0).sum())}, nonzero "
                  f"partials {contact}, state err {st_err:.3e}, accel err "
                  f"{a_err:.3e} of {a_scale:.4g}, partials err "
                  f"{max(big_err, pl_err):.3e} of {part_scale:.4g}",
                  flush=True)
            if st_err > 1e-5 or a_err > max(1e-5, 1e-6 * a_scale) or \
                    max(big_err, pl_err) > 1e-5 + 1e-6 * part_scale:
                fail(f"{name} differs from its plain version")
        if contact == 0:
            fail(f"{name}: the moved wall coupled with no particle")

    times = {
        "migrate": (cuda_ms(lambda: SK.migrate(ST, **mk)),
                    cuda_ms(lambda: SK.migrate_plain(ST, **mk))),
        "pair_sweep": (cuda_ms(lambda: SK.pair_sweep(M9, **sk)),
                       cuda_ms(lambda: SK.pair_sweep_plain(M9, **sk), 5)),
        "coupling9": (cuda_ms(lambda: SK.coupling9(*args2, cn=ck)),
                      cuda_ms(lambda: SK.coupling9_plain(*args2, cn=ck),
                              5)),
        "density": (cuda_ms(lambda: SK.density(D4, **dk)),
                    cuda_ms(lambda: SK.density_plain(D4, **dk), 5)),
        "force": (cuda_ms(lambda: SK.force(D8, **fk)),
                  cuda_ms(lambda: SK.force_plain(D8, **fk), 5)),
        "coupling": (cuda_ms(lambda: SK.coupling(*args2s, cn=ck)),
                     cuda_ms(lambda: SK.coupling_plain(*args2s, cn=ck), 5)),
    }
    n_occ = float(occ.sum())
    live2 = (M9[:, SK.M9_OCC] > 0) & (args2[0] > 0)[:, None, :]
    outk = SK.coupling9(*args2, cn=ck)
    outs = SK.coupling(*args2s, cn=ck)
    pairs = neighbour_pairs(occ.to(torch.int32))
    cpl_ops = float(live2.sum()) * (1 + len(sc.spec.solid_big_idx)) \
        * (CPL_OPS_PER_VERT * ck["V"] + CPL_OPS)
    bounds = {
        "migrate": bound(nbytes(ST, M9), MIGRATE_OPS * n_occ),
        "pair_sweep": bound(nbytes(M9, *sw), PAIR_OPS * pairs),
        "coupling9": bound(nbytes(*args2, *outk), cpl_ops),
        "density": bound(nbytes(D4, rho), DENSITY_OPS * pairs),
        "force": bound(nbytes(D8, *frc), FORCE_OPS * pairs),
        "coupling": bound(nbytes(*args2s, *outs), cpl_ops),
    }
    for name in bounds:
        print(f"kernel {name}: max_abs_err {errs[name]:.3e}  "
              f"kernel {times[name][0]:.4f} ms  plain {times[name][1]:.4f} ms"
              f"  bound {bounds[name][0]:.4f} ms ({bounds[name][1]})",
              flush=True)
    return errs, times, bounds


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
    print(f"dam {DAM_N}: one tick, split resident vs stacked: max |dpos| "
          f"{dpos:.3e} m, rho rel {rho_rel:.3e}", flush=True)
    if dpos > 1e-4 or rho_rel > 1e-3:
        fail("the split resident tick differs from the stacked tick")


def run_dam_scatter(dev, card):
    """Phase 6b: the per-tick scatter step with the split pair kernels, 10
    ticks twice from the initial state: launches, bitwise repeatability."""
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


def rigid_run(dev, ticks):
    """RIGID_STACKS 10k from seed 0 through build_run_fn(ticks=10)."""
    from lpe_tpu_torch.scenarios.bench_scenes import build_rigid_stacks
    from lpe_tpu_torch.systems import build_run_fn
    sc = build_rigid_stacks(RIGID_N, seed=0, device=dev)
    run = build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=dev)
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
    launches = RK.narrowphase.launches
    plain = RK.narrowphase.plain_calls
    ticks = blocks * BLOCK
    if launches != ticks or plain != 0:
        fail(f"rigid: narrowphase launches {launches}, plain calls {plain} "
             f"in {ticks} ticks")
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
          f"{BLOCK} (host clock, synchronized) on {card}; narrowphase "
          f"launches {launches}, plain calls {plain}; guard host reads "
          f"{step.guard_reads / ticks:.2f} a tick, rebuilds {step.rebuilds} "
          f"of {ticks} ticks; mean y {y0:.4f} -> {y1:.4f}", flush=True)

    finals = [rigid_run(dev, 30)[2] for _ in range(2)]
    for name in ("pos", "vel", "angle", "omega"):
        if not torch.equal(getattr(finals[0].bodies, name),
                           getattr(finals[1].bodies, name)):
            fail(f"rigid: two 30-tick runs from one seed differ in {name}")
    print("rigid: two 30-tick runs from seed 0 are bitwise equal", flush=True)
    return launches, run, state


def check_narrowphase(state, run):
    """Phase 8: the narrowphase kernel against its plain version at the
    rigid-10k rows of ``state``, with the tolerances of the JAX package's
    Pallas-vs-XLA test (tests/test_pallas_rigid.py:52-65)."""
    import torch
    from lpe_tpu_torch.ops import rigid_kernels as RK
    args = run.systems["rigid"].narrowphase_inputs(state)
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
    times = (cuda_ms(lambda: RK.narrowphase(*args)),
             cuda_ms(lambda: RK.narrowphase_plain(*args), 5))
    # operations this data needs per row, by the rings' vertex counts n =
    # na + nb: n^2 projections of 3 each, ~24 per vertex for the world ring,
    # centroid and face normals, ~40 for the clip
    n = (args[3] + args[7]).double().clamp(min=0)
    ops = float((3 * n * n + 24 * n + 40).sum())
    bnd = bound(nbytes(*args, *got), ops)
    print(f"kernel narrowphase: max_abs_err {max(err.values()):.3e}  kernel "
          f"{times[0]:.4f} ms  plain {times[1]:.4f} ms  bound {bnd[0]:.4f} ms "
          f"({bnd[1]})", flush=True)
    return max(err.values()), times, bnd


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "lpe_tpu_torch" / "ops" / "csrc").is_dir():
        fail(f"run from a checkout: no lpe_tpu_torch package beside {ROOT}")
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
    errs, times, bounds = check_kernels(dev)
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
    check_split_tick(dev, ssc, sstate)
    run_dam_scatter(dev, card)
    run_simple_fluid(dev, card, reps=1, pair_backend="pallas")

    # 7.-8.
    launches["narrowphase"], rrun, rstate = run_rigid(dev, card)
    errs["narrowphase"], times["narrowphase"], bounds["narrowphase"] = \
        check_narrowphase(rstate, rrun)

    # 9. results: no single PyTorch call computes any of these kernels
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=times[name][0], plain_ms=times[name][1],
                    bound_ms=bounds[name][0], bound_by=bounds[name][1],
                    library_ms=None)
               for name, (src, rep) in KERNEL_INFO.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
