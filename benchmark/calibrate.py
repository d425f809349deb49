"""Readings that the output check's limits are set from, for one cell.

    python -m benchmark.calibrate --workload <cell> --seconds <s> \\
        --seeds <n> [--first-seed <n>]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the check), and on the same checked
blocks the control, the plain reference computed in bfloat16 put in the
program's place and judged by the cell's limits. Prints one JSON line a
seed (the program's readings and verdict, the control's, the blocks
checked) and then, per number, the largest reading of the program (the
lower reading) and the smallest of the control (the upper reading).
Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.harness import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2_200_000_001)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    lower, upper = {}, {}
    for s in range(args.first_seed, args.first_seed + args.seeds):
        t = time.perf_counter()
        out = run_cell(args.workload, s, args.seconds, False, control=True)
        for k, v in out["readings"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in out["control"].items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps(dict(seed=s, program=out["readings"],
                              correct=out["result"]["correct"],
                              control=out["control"],
                              control_correct=out["control_correct"],
                              blocks=out["checked_blocks"],
                              attempted=out["result"]["attempted"],
                              seconds=time.perf_counter() - t)), flush=True)
    print(json.dumps(dict(workload=args.workload, lower=lower,
                          upper=upper)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
