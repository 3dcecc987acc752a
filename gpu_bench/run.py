#!/usr/bin/env python3
"""tiger_tpu_torch's benchmark: one run of one cell on the card.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration and a traffic mix; their files,
the cell's frozen work and check limits, and the per-layer metrics' readers
are found by name (``harness/spec.py``).  The run:

1. set-up: imports the program and starts CUDA, builds (or finds) the
   kernel library, draws the parameters on the card from the seed, and runs
   window 0 from the cold state, which warms the cell's shapes up and is the
   check's first window;
2. the measured window: windows 1, 2, ... of one closed-loop stream
   (``harness/stream.py``), each started from the state the last carried,
   for ``--seconds``, each ending in a synchronize; with ``--trace 1`` under
   ``torch.profiler``;
3. reads the peak device memory, frees the program's state, and checks the
   program's outputs against the plain reference (``harness/check.py``);
4. prints the result as the last line of standard output, and each number
   compared beside its limit as the last lines of standard error.

With ``--trace 0`` the result's metrics are the cell's end-to-end ones:
``link_days_per_s`` (links times simulated days of the windows completed in
the measured window, over the time from its start to the end of its last
window) and ``setup_s`` (the process's time before the measured window).
With ``--trace 1`` they are the cell's per-layer metrics, read from the
trace (``harness/trace.py``, ``metrics/<name>.py``).

It exits non-zero and prints no result without a CUDA card (or with fewer
cards than the cell asks for), without the program in the checkout, or if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for path in (str(ROOT), str(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)

#: Top-level module names that may not be loaded in the process that
#: prints the result: JAX, its libraries and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "tiger_tpu")
PROGRAM = "tiger_tpu_torch"


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def trace_record(prof, cell) -> dict:
    """The traced window reduced (``harness.trace``) with what the readers need."""
    from harness import inputs, spec, trace, work

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        reduced = trace.read_chrome_trace(path)
    tr = cell.traffic
    queries = round(tr["window_minutes"] / tr["query_minutes"])
    precision = cell.config["precision"]
    cell_work = cell.data.get("work")
    return {
        "trace": reduced,
        "n_windows": len(reduced["windows"]),
        "precision": precision,
        "peaks": spec.load_json(BENCH_DIR / "peaks.json"),
        "work": None if cell_work is None else work.window_work(
            cell_work, cell.model.RHS_OPS, int(tr["links"]), queries,
            sum(inputs.forcing_layout(tr)[1]),
            8 if precision == "f64" else 4),
    }


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, solve=None, log=sys.stderr, t_start: float = T_START) -> tuple:
    """One run of ``cell`` (a ``harness.spec.Cell``): (the result's dict,
    what the run printed about itself on ``log``).

    ``device`` is "cuda" in every run of the benchmark; the CPU tests run
    the rest of a run on "cpu" with the program's plain versions.
    ``control`` runs the configuration's control instead of the program's
    answers: the program's own path one precision down (``control.program``)
    or the reference in bfloat16 put in the program's place
    (``control.reference``, ``harness/check.py``).  ``solve`` replaces the
    program's entry, for the tests of the check.
    """
    import torch

    from harness import check, spec
    from harness.stream import COUNTERS, Stream

    cuda = torch.device(device).type == "cuda"
    split = {}
    t = time.perf_counter()
    if cuda:
        torch.zeros(1, device=device)
        split["import_and_cuda_s"] = time.perf_counter() - t_start
        from tiger_tpu_torch.kernels import _build

        t = time.perf_counter()
        _build.load()
        split["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    program_control = control and "program" in cell.config["control"]
    stream = Stream(cell, seed, device, control=program_control, solve=solve)
    if cuda:
        torch.cuda.synchronize()
    split["draw_s"] = time.perf_counter() - t
    t = time.perf_counter()
    stream.window(0)
    stream.fix_sample(seed)
    before = stream.counters.clone()
    if cuda:
        torch.cuda.synchronize()
    split["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    span = torch.profiler.record_function if trace else contextlib.nullcontext
    prof = contextlib.nullcontext()
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    times = []
    with prof:
        start = time.perf_counter()
        deadline = start + seconds
        k = 1
        while True:
            t0 = time.perf_counter()
            with span("bench.window"):
                stream.window(k, span)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            k += 1
            if t1 >= deadline:
                break
    elapsed = t1 - start
    n_timed = k - 1
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    timed = dict(zip(COUNTERS, (stream.counters - before).tolist()))
    record = trace_record(prof, cell) if trace else None

    tr = cell.traffic
    links = int(tr["links"])
    days = tr["window_minutes"] / 1440.0
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"link_days_per_s": links * days * n_timed / elapsed, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}

    stream.release()
    t = time.perf_counter()
    solver = cell.config["solver"]
    numbers = check.compare(stream, float(solver["rtol"]), float(solver["atol"]),
                            control=control and not program_control)
    correct, table = check.judge(numbers, cell.data.get("limits", {}))
    info = {"cell": cell.name, "seed": seed, "windows": n_timed, "elapsed_s": elapsed,
            "window_ms_median": 1e3 * sorted(times)[len(times) // 2],
            "window_ms_max": 1e3 * max(times), "setup_split": split, "counters": stream.counts,
            "counters_timed": timed,
            "numbers": numbers, "check_s": time.perf_counter() - t, "control": control}
    print("run: " + json.dumps(info), file=log, flush=True)

    result = {"correct": correct, "attempted": links * n_timed, "failed": timed["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        from harness import trace as trace_mod

        result["device"]["busy_s"] = trace_mod.busy_seconds(record["trace"])
        result["device"]["window_s"] = trace_mod.window_seconds(record["trace"])
        result["breakdown"] = trace_mod.breakdown(record["trace"])
    result["checks"] = table
    return result, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / PROGRAM).is_dir():
        print(f"run: the program ({PROGRAM}/) is not in {ROOT}", file=sys.stderr)
        return 2
    from harness import spec

    cell = spec.resolve(args.workload)
    chips = cell.chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print(f"run: card {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    found = forbidden_modules()
    if found:
        print(f"run: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for key, entry in result["checks"].items():
        print(f"check {key} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
