"""CLI entry point: run scenarios headless, export PNG/GIF, benchmark.

The counterpart of ``lpe_tpu/app/cli.py``, with the same subcommands and
flags, run as ``python -m lpe_tpu_torch.app.cli``. ``--device`` (``run``,
``view``, ``bench``; default ``cuda``) picks the device, as
``JAX_PLATFORMS`` does for lpe_tpu; on a machine with no card the default
fails rather than falling back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="lpe_tpu_torch",
        description="little physics engine on PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a scenario headless")
    runp.add_argument("--scenario", default="KEPLERIAN_DISK",
                      help="one of: " + ",".join(
                          n for n in _scenario_names()))
    runp.add_argument("--ticks", type=int, default=600)
    runp.add_argument("--seed", type=int, default=0)
    runp.add_argument("--time-scale", type=float, default=1.0)
    runp.add_argument("--color-scheme",
                      choices=["default", "sleep", "temperature"],
                      default="default")
    runp.add_argument("--debug", action="store_true",
                      help="velocity/angular debug overlays")
    runp.add_argument("--gif", help="write animation GIF to this path "
                                    "(needs PIL)")
    runp.add_argument("--png", help="write final frame PNG to this path")
    runp.add_argument("--frame-every", type=int, default=4,
                      help="ticks between captured frames")
    runp.add_argument("--size", type=int, default=600, help="frame size px")
    runp.add_argument("--checkpoint", help="write final state npz here")
    runp.add_argument("--resume", help="load initial state npz from here")
    runp.add_argument("--profile", action="store_true")
    runp.add_argument("--realtime", action="store_true")

    sub.add_parser("list", help="list scenarios")

    viewp = sub.add_parser("view", help="interactive viewer (needs display)")
    viewp.add_argument("--scenario", default="KEPLERIAN_DISK")
    viewp.add_argument("--seed", type=int, default=0)
    viewp.add_argument("--size", type=int, default=600)

    bp = sub.add_parser("bench", help="steps/sec for a scenario")
    bp.add_argument("--scenario", default="SIMPLE_FLUID")
    bp.add_argument("--ticks", type=int, default=240)
    bp.add_argument("--seed", type=int, default=0)

    for sp in (runp, viewp, bp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")

    args = p.parse_args(argv)

    if args.cmd == "list":
        for name in _scenario_names():
            print(name)
        return 0

    from ..core.constants import SimulationType
    from ..render.frame import SCHEME_DEFAULT, SCHEME_SLEEP
    from .sim_manager import SimManager

    st = SimulationType[args.scenario]

    if args.cmd == "view":
        from .viewer import view
        return view(st, seed=args.seed, size=args.size, device=args.device)

    if args.cmd == "bench":
        mgr = SimManager(st, seed=args.seed, device=args.device)
        mgr.tick()      # first tick: on a fresh checkout it builds the kernels
        mgr.sync()
        t0 = time.perf_counter()
        mgr.tick(args.ticks)
        mgr.sync()
        dt = time.perf_counter() - t0
        print(json.dumps({"scenario": args.scenario, "ticks": args.ticks,
                          "seconds": dt, "ticks_per_sec": args.ticks / dt}))
        return 0

    from ..render.frame import SCHEME_TEMPERATURE
    scheme = {"default": SCHEME_DEFAULT, "sleep": SCHEME_SLEEP,
              "temperature": SCHEME_TEMPERATURE}[args.color_scheme]
    mgr = SimManager(st, seed=args.seed, color_scheme=scheme,
                     debug=args.debug, device=args.device)
    if args.resume:
        from ..io.checkpoint import load_state
        mgr.state = load_state(args.resume, device=args.device)
    if args.time_scale != 1.0:
        mgr.set_time_scale(args.time_scale)

    frames = []
    sink = None
    if args.gif:
        def sink(frame, i):
            frames.append(frame)
    stats = mgr.run(args.ticks, frame_sink=sink,
                    frame_every=args.frame_every, realtime=args.realtime,
                    print_profile=args.profile)
    print(f"ran {stats.ticks} ticks "
          f"({stats.ticks_per_sec:.1f} ticks/s in last window)",
          file=sys.stderr)

    if args.gif:
        from ..io.media import save_gif
        save_gif(args.gif, frames, fps=max(1, 120 // args.frame_every))
        print(f"wrote {args.gif} ({len(frames)} frames)", file=sys.stderr)
    if args.png:
        from ..io.media import save_png
        save_png(args.png, mgr.render_frame(args.size, args.size))
        print(f"wrote {args.png}", file=sys.stderr)
    if args.checkpoint:
        from ..io.checkpoint import save_state
        save_state(args.checkpoint, mgr.state)
        print(f"wrote {args.checkpoint}", file=sys.stderr)
    return 0


def _scenario_names():
    from ..core.constants import SCENARIO_NAMES
    return list(SCENARIO_NAMES.values())


if __name__ == "__main__":
    sys.exit(main())
