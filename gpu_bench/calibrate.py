#!/usr/bin/env python3
"""Readings for the cells' limits and frozen work, many runs in one process.

    python3 gpu_bench/calibrate.py --cells <cell>[,<cell>...] --seeds N
        [--seconds S] [--trace] [--control] [--first-seed K]

Each run is ``run.run_cell`` as the benchmark makes it (set-up, the measured
window, the check), on the card, with the seeds K, K + 1,000,003, ...;
``--control`` runs the configuration's control (``harness/check.py``).  One line of
JSON a run, on standard output: the numbers compared, the step counters the
frozen work is taken from, the windows and the end-to-end values.  The
benchmark's own runs never run this; its limits and frozen work were set
from its readings (PERF.md).
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for path in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)

import run  # noqa: E402
from harness import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2_147_480_011)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cells = [spec.resolve(n) for n in args.cells.split(",") if n]
    for cell in cells:
        for i in range(args.seeds):
            seed = args.first_seed + i * 1_000_003
            t = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            result, info = run.run_cell(cell, seed, args.seconds, args.trace,
                                        control=args.control, t_start=t)
            print(json.dumps({"wall_s": time.perf_counter() - t, "info": info,
                              "result": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
