"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program (``lpe_tpu_torch``).
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled part of the window.
The last lines on standard error, and the line's last key ``check``,
give each number of the output check beside its limit. Exits 2 without
a result where the card or the cards the cell asks for are missing, and
1 where a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    import torch
    from benchmark.harness import forbidden_modules, load_cell, run_cell
    chips = int(load_cell(args.workload, ROOT)["cell"]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t0=T0, root=ROOT)["result"]
    # read after everything the run loads: the window, the metrics'
    # readers and the reference
    leaked = forbidden_modules(sys.modules)
    if leaked:
        print("benchmark: loaded in the measured process: "
              + ", ".join(leaked), file=sys.stderr)
        return 1
    print(json.dumps(res), flush=True)
    for key, c in res["check"].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"check correct: {res['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
