#!/usr/bin/env python3
"""Drive the lpe_tpu_torch port once on an NVIDIA GPU and check it.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):
  1. require CUDA; print the card (nvidia-smi name, power limit), torch and
     CUDA versions;
  2. build the three CUDA kernels of ops/csrc/ with nvcc (timed);
  3. at the DAM_BREAK 100k shapes (the grid of the dam scene 40 ticks into
     its collapse), hold each kernel against its plain PyTorch version and
     time both with CUDA events;
  4. run DAM_BREAK 100k through build_run_fn(ticks=10): the state must be
     finite and every kernel must have launched (and no plain version run);
  5. run SIMPLE_FLUID through build_tick_fn for 120 ticks: the fluid falls
     and pools (y-mean from 3.0 toward ~5.5), and a second run from the
     same seed is bitwise equal;
  6. run one dam block under torch.cuda.set_sync_debug_mode("error"): a
     tick makes no host sync;
  7. print the kernels' JSON line, then the result line.
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
BLOCK = 10
WARM_BLOCKS = 4      # dam blocks run before the kernel check (phase 3)
KERNEL_INFO = {   # name -> (CUDA source, the Pallas kernel it replaces)
    "migrate": ("lpe_tpu_torch/ops/csrc/migrate.cu",
                "lpe_tpu/ops/pallas_sph.py:1128"),
    "pair_sweep": ("lpe_tpu_torch/ops/csrc/pair_sweep.cu",
                   "lpe_tpu/ops/pallas_sph.py:804"),
    "coupling9": ("lpe_tpu_torch/ops/csrc/coupling9.cu",
                  "lpe_tpu/ops/pallas_sph.py:664"),
}


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

    def force_misses(out):
        """Force elements off the plain version's by more than 1e-5 of
        themselves plus 1e-6 of the force scale (the stiff EOS turns
        ULP-level rho reassociation into force noise)."""
        return sum(int(((a - b).abs() > 1e-5 * b.abs() + 1e-6 * fscale)
                       .sum()) for a, b in zip(out[1:], swp[1:]))

    if rho_rel > 1e-5 or force_misses(sw):
        fail(f"pair_sweep: rho rel err {rho_rel}, {force_misses(sw)} force "
             f"elements over the limit (max abs err {ferr}, scale {fscale})")
    # a planted fault the force check must catch: min_rho raised to the
    # 1st percentile of the occupied slots' density drops the pairs of the
    # free surface's thinnest particles, whose forces are weak
    rho_q = float(torch.quantile(swp[0][o].double(), 0.01))
    bad = SK.pair_sweep_plain(M9, **dict(sk, min_rho=rho_q))
    bad_err = max(max_err(bad[1], swp[1]), max_err(bad[2], swp[2]))
    print(f"pair_sweep: rho rel err {rho_rel:.3e}; forces: scale {fscale:.6g}"
          f", max abs err {ferr:.3e}, limit per element 1e-5*|f| + "
          f"{1e-6 * fscale:.3e}; planted fault (min_rho {rho_q:.6g}): max "
          f"abs err {bad_err:.3e}, {force_misses(bad)} elements over the "
          f"limit", flush=True)
    if force_misses(bad) == 0:
        fail("pair_sweep: the force check missed a planted fault")

    # coupling9 twice at these shapes: on the main path's own inputs (the
    # boundary margin keeps the dam's fluid off its walls, so those cells
    # copy through), and with the dam's floor wall moved into the fluid
    # column, both as a big solid and in slot 0 of every cell, so that the
    # kernel's candidate math runs on every occupied cell
    cpl, fld, big = fl.coupling_inputs(state, M9)
    args = (cpl, fld, big, M9, *sw)
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
    args2 = (live.contiguous(), fld2, big2, M9, *sw)
    errs["coupling9"] = 0.0
    contact = 0
    for a in (args, args2):
        outk = SK.coupling9(*a, cn=ck)
        outp = SK.coupling9_plain(*a, cn=ck)
        acc = [SK.ST_AX, SK.ST_AY]
        rest = [f for f in range(9) if f not in acc]
        st_err = max_err(outk[0][:, rest], outp[0][:, rest])
        a_err = max_err(outk[0][:, acc], outp[0][:, acc])
        a_scale = float(outp[0][:, acc].abs().max())
        # partials: per (row, slot, column) and per (row, block) sums,
        # elementwise, to 1e-5 plus 1e-6 of the largest (float32 ulps of
        # a block's sum over up to 32 x K particles)
        pl_err = max_err(outk[1], outp[1])
        big_err = max_err(outk[2], outp[2])
        part_scale = max(float(outp[1].abs().max()),
                         float(outp[2].abs().max()) if outp[2].numel()
                         else 0.0)
        errs["coupling9"] = max(errs["coupling9"], st_err, big_err, pl_err)
        contact = int((outp[2].abs() > 0).sum() + (outp[1].abs() > 0).sum())
        print(f"coupling9: cells coupled {int((a[0] > 0).sum())}, nonzero "
              f"partials {contact}, state err {st_err:.3e}, accel err "
              f"{a_err:.3e} of {a_scale:.4g}, partials err "
              f"{max(big_err, pl_err):.3e} of {part_scale:.4g}", flush=True)
        if st_err > 1e-5 or a_err > max(1e-5, 1e-6 * a_scale) or \
                max(big_err, pl_err) > 1e-5 + 1e-6 * part_scale:
            fail("coupling9 differs from its plain version")
    if contact == 0:
        fail("coupling9: the moved wall coupled with no particle")

    times = {
        "migrate": (cuda_ms(lambda: SK.migrate(ST, **mk)),
                    cuda_ms(lambda: SK.migrate_plain(ST, **mk))),
        "pair_sweep": (cuda_ms(lambda: SK.pair_sweep(M9, **sk)),
                       cuda_ms(lambda: SK.pair_sweep_plain(M9, **sk), 5)),
        "coupling9": (cuda_ms(lambda: SK.coupling9(*args2, cn=ck)),
                      cuda_ms(lambda: SK.coupling9_plain(*args2, cn=ck),
                              5)),
    }
    for name in KERNEL_INFO:
        print(f"kernel {name}: max_abs_err {errs[name]:.3e}  "
              f"kernel {times[name][0]:.4f} ms  plain {times[name][1]:.4f} ms",
              flush=True)
    return errs, times


def run_dam(dev, card):
    """Phase 4: DAM_BREAK 100k through build_run_fn, counted launches."""
    import torch
    from lpe_tpu_torch.ops import sph_kernels as SK
    from lpe_tpu_torch.scenarios.bench_scenes import build_dam_break
    from lpe_tpu_torch.systems import build_run_fn

    sc = build_dam_break(DAM_N, device=dev)
    run = build_run_fn(sc.spec, sc.cfg, ticks=BLOCK, device=dev)
    state = run(sc.state)                       # warm-up block
    torch.cuda.synchronize()
    blocks = 3
    SK.reset_counters()
    t0 = time.perf_counter()
    for _ in range(blocks):
        state = run(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {op.name: op.launches for op in SK.OPS}
    plain = {op.name: op.plain_calls for op in SK.OPS}
    if min(launches.values()) == 0 or max(plain.values()) != 0:
        fail(f"dam: launches {launches}, plain calls {plain}")
    liq = sc.spec.liquid_slice
    if not bool(torch.isfinite(state.bodies.pos).all()):
        fail("dam: non-finite positions")
    if int(state.tick) != BLOCK * (blocks + 1):
        fail(f"dam: tick counter {int(state.tick)}")
    tps = blocks * BLOCK / dt
    ymean = float(state.bodies.pos[liq, 1].mean())
    print(f"dam {DAM_N}: {tps:.2f} ticks/s over {blocks} blocks of {BLOCK} "
          f"(host clock, synchronized) on {card}; launches {launches}; "
          f"fluid y-mean {ymean:.4f}", flush=True)
    return launches, run, state


def run_simple_fluid(dev, card):
    """Phase 5: SIMPLE_FLUID through build_tick_fn, 120 ticks, twice."""
    import torch
    from lpe_tpu_torch.core.constants import SimulationType
    from lpe_tpu_torch.scenarios import create_scenario
    from lpe_tpu_torch.systems import build_tick_fn

    finals = []
    for rep in range(2):
        sc = create_scenario(SimulationType.SIMPLE_FLUID, seed=0, device=dev)
        tick = build_tick_fn(sc.spec, sc.cfg, device=dev)
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
        print(f"simple_fluid run {rep}: y-mean {y0:.4f} -> {y1:.4f} after "
              f"120 ticks, {120 / dt:.2f} ticks/s (host clock, "
              f"synchronized, per-tick calls) on {card}", flush=True)
        if not bool(torch.isfinite(s.bodies.pos).all()):
            fail("simple_fluid: non-finite positions")
        if not (abs(y0 - 3.0) < 0.05 and 4.5 < y1 < 5.95):
            fail(f"simple_fluid: y-mean {y0} -> {y1}, expected 3.0 -> ~5.5")
    a, b = finals
    for name in ("pos", "vel", "density", "pressure"):
        if not torch.equal(getattr(a.bodies, name), getattr(b.bodies, name)):
            fail(f"simple_fluid: two runs from one seed differ in {name}")
    print("simple_fluid: two runs from seed 0 are bitwise equal", flush=True)


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
    errs, times = check_kernels(dev)
    launches, run, state = run_dam(dev, card)
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

    # 7. results
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=times[name][0], plain_ms=times[name][1])
               for name, (src, rep) in KERNEL_INFO.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
