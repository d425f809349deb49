"""Times P3M's PP kernel (lpe_tpu_torch/ops/csrc/pp_pass.cu) at the 1M-body
galaxy over its strip widths (cells a block, ``PP_STRIP_CELLS``) and block
sizes (``PP_THREADS``), and the whole pass (layout and kernel) and its
plain version at the defaults (device time under torch.profiler). Needs a
CUDA card:

    python3 scripts/pp_pass_sweep.py [--bodies 1000000] [--ticks 0]

``--ticks`` runs that many galaxy ticks first, so the disk has moved. Prints
the card, nvcc's register report of the kernel, and one JSON line of ms
(CUDA events, back to back, after warm-up) by (T, threads)."""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def events_ms(fn, reps):
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


def device_ms(fn, reps=5):
    """Device time of ``fn`` (the sum of its operations' durations under
    torch.profiler), a call; the host's launch time does not count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / 1e3 / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bodies", type=int, default=1_000_000)
    ap.add_argument("--ticks", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    from lpe_tpu_torch.ops import _build
    from lpe_tpu_torch.ops import pm_gravity as PM
    from lpe_tpu_torch.scenarios.bench_scenes import build_galaxy
    from lpe_tpu_torch.systems import build_run_fn
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    section = _build.build_log.split("== pp_pass.cu")[-1].split("== ")[0]
    for line in section.splitlines():
        if "registers" in line or "Compiling entry" in line or \
                "spill" in line:
            print("  nvcc:", line.strip(), flush=True)
    dev = torch.device("cuda", 0)
    sc = build_galaxy(a.bodies, device=dev)
    run = build_run_fn(sc.spec, sc.cfg, ticks=1, device=dev)
    step = run.systems["barnes_hut"]
    state = sc.state
    for _ in range(a.ticks):
        state = run(state)
    b = state.bodies
    src, _ = step.masks(b)
    heavy = src & (b.mass >= sc.cfg.barnes_hut.heavy_threshold)
    mm = torch.where(src & ~heavy, b.mass, torch.zeros_like(b.mass))
    pp = step.pp
    g = pp.grid
    print(f"galaxy {a.bodies} after {a.ticks} ticks: K {g.K}, m {g.m}, "
          f"nc {g.nc}, overflow_fraction {pp.overflow_fraction(b.pos):.6f}",
          flush=True)
    rows, body, cstart = pp.layout(b.pos, mm)
    out = torch.zeros((b.pos.shape[0], 2), device=dev)
    ref = pp(b.pos, mm)
    times = {}
    for T in (1, 2, 4, 8, 16, 32):
        strips = g.nc * -(-g.nc // T)
        for threads in (64, 128, 256, 512):
            P = PM.pp_params(g, T, 0, strips, threads)

            def kernel():
                _build.call("lpe_pp_pass", rows, body, cstart, out, P)
            ms = events_ms(kernel, a.reps)
            same = bool(torch.equal(out.view(torch.int32),
                                    ref.view(torch.int32)))
            times[f"T{T}_t{threads}"] = ms
            print(f"T {T:2d} threads {threads:3d}: {ms:.4f} ms "
                  f"(bits of the default {same})", flush=True)
    whole = device_ms(lambda: pp(b.pos, mm))
    layout = device_ms(lambda: pp.layout(b.pos, mm))
    plain = events_ms(lambda: PM.pp_pass.plain(b.pos, mm, g), 3)
    want = PM.pp_pass.plain(b.pos, mm, g)
    gap = float((ref - want).abs().max() / want.abs().max())
    print(json.dumps({"pp_pass_sweep": dict(
        card=card.strip(), bodies=a.bodies, ticks=a.ticks, K=g.K, m=g.m,
        default=dict(T=PM.PP_STRIP_CELLS, threads=PM.PP_THREADS),
        kernel_ms=times, pass_ms=whole, layout_ms=layout, plain_ms=plain,
        kernel_vs_plain=gap)}), flush=True)


if __name__ == "__main__":
    main()
