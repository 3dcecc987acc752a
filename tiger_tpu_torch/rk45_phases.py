"""Where B1's time goes on the card: who waits for whom.

    python -m tiger_tpu_torch.rk45_phases [--systems 131072] [--days 2] [--reps 3]
        [--skip-plain] [--variants]

Builds the kernels a second time with ``-DTT_RK45_PHASES``, which adds
per-warp probes to ``csrc/rk45.cu`` (``%globaltimer`` at start and end,
``%smid``, trips through the attempt loop, trips in which a lane filled dense
rows, attempts, cycles in the run section and in all).  At the main path's
shapes (Model 204, 0.1% stiff, hourly queries, rtol 1e-5 / atol 1e-8) it
prints

- B1's time in the package build, and its results against ``rk45_plain``
  bit for bit (``--skip-plain`` leaves that out);
- B1 on the 32 systems with the most attempts, alone: the lone warp's
  microseconds a trip;
- B1 under the probes: time, lane efficiency (attempts over 32 x trips), the
  share of trips that pay for a dense fill, the share of a block's cycles its
  warps spend inside the run section, and how evenly the blocks end;
- the SASS instructions of the kernel and of its largest loops
  (``cuobjdump -sass``, where the toolkit has it);
- with ``--variants``, B1's time and ptxas line under other block sizes,
  slice lengths and pool sizes.

Every result of a probed or variant build is held against the package
build's bit for bit.  The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import shutil
import statistics
import subprocess

import torch

from tiger_tpu_torch import Model204, SolverConfig
from tiger_tpu_torch.kernels import _build
from tiger_tpu_torch.kernels import rk45 as k_rk45
from tiger_tpu_torch.kernels.rk45 import PROBE_FLAGS, lane_efficiency, read_probes
from tiger_tpu_torch.profile_solve import timed
from tiger_tpu_torch.scenario import scenario
from tiger_tpu_torch.solver.controller import initial_step

TAIL_SYSTEMS = 32


def variants() -> dict:
    """Flag sets to try, by name; each differs from the package's in one thing."""
    base = _build.NVCC_FLAGS
    return {
        "256 threads": base + ("-DTT_RK45_THREADS=256",),
        "384 threads": base + ("-DTT_RK45_THREADS=384",),
        "slice of 16": base + ("-DTT_RK45_SLICE=16",),
        "slice of 32": base + ("-DTT_RK45_SLICE=32",),
        "slice of 128": base + ("-DTT_RK45_SLICE=128",),
        "pool of 2048 slots": base + ("-DTT_RK45_POOL=2048",),
    }


def ptxas_line(log: str, kernel: str) -> str:
    """ptxas's resource line of ``kernel`` from a build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            return " ".join(x.strip().removeprefix("ptxas info    : ") for x in lines[i + 1:i + 4])
    return "(cached build: no ptxas log)"


def sass_loops(lib_path) -> dict:
    """{kernel: (instructions, [largest backward-branch spans])} from cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError) as err:
        print(f"sass: cuobjdump did not run ({err})", flush=True)
        return {}
    out, name, addrs, loops = {}, None, [], []

    def close():
        if name is not None:
            out[name] = (len(addrs), sorted(loops, reverse=True)[:4])

    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, addrs, loops = m.group(1), [], []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            addrs.append(addr)
            target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", m.group(2))
            if target and int(target.group(1), 16) <= addr:
                loops.append((addr - int(target.group(1), 16)) // 16 + 1)
    close()
    return out


def quantiles(xs) -> str:
    xs = sorted(xs)
    return f"min {xs[0]:.3f}, median {statistics.median(xs):.3f}, max {xs[-1]:.3f}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--systems", type=int, default=131_072)
    ap.add_argument("--days", type=float, default=2.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--skip-plain", action="store_true", help="do not run rk45_plain")
    ap.add_argument("--variants", action="store_true", help="time the other builds of B1 too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rk45_phases: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    # Every build at once: nvcc takes seconds for each, one core for each.
    flag_sets = {"package": _build.NVCC_FLAGS, "probed": PROBE_FLAGS}
    if args.variants:
        flag_sets.update(variants())
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        built = dict(zip(flag_sets, pool.map(_build.build, flag_sets.values())))
    for name, (path, seconds, log) in built.items():
        print(f"build {name}: {seconds:.1f} s; rk45_kernel: {ptxas_line(log, 'rk45_kernel')}",
              flush=True)

    dev = torch.device("cuda", 0)
    model = Model204()
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    tf = args.days * 1440.0
    y0, params, forc = scenario(args.systems, args.days, 0.001, device=dev)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=torch.float32, device=dev)
    h0 = initial_step(model, y0, 0.0, params, forc, cfg)
    full = (y0, h0, params, forc)

    def b1(inputs):
        sy0, sh0, sp, sf = inputs
        return k_rk45.rk45(model, sy0, sh0, 0.0, tf, qt, sp, sf, cfg)

    def held(label, res, ref):
        diff = k_rk45.rk45_mismatch(res, ref)
        print(f"{label}: entries that differ {diff}", flush=True)
        if any(diff.values()):
            raise RuntimeError(f"rk45_phases: {label} differs: {diff}")

    summary = {"card": smi, "systems": args.systems, "days": args.days}

    # The package build, and rk45_plain.
    b1(full)
    ref, pkg_ms = timed(lambda: b1(full), args.reps)
    geo = k_rk45.rk45_geometry(args.systems)
    attempts = int(ref.stats.n_attempts.sum())
    worst = int(ref.stats.n_attempts.max())
    print(f"B1 package build: {pkg_ms:.3f} ms, {attempts} attempts, worst system {worst}, "
          f"{int(ref.stiff.sum())} stiff, geometry {geo} | {smi}", flush=True)
    summary.update(b1_ms=pkg_ms, attempts=attempts, worst_attempts=worst, geometry=geo)
    if not args.skip_plain:
        plain, plain_ms = timed(lambda: k_rk45.rk45_plain(model, y0, h0, 0.0, tf, qt, params, forc, cfg), 1)
        held(f"B1 against rk45_plain ({plain_ms:.0f} ms)", ref, plain)

    top = torch.topk(ref.stats.n_attempts, min(TAIL_SYSTEMS, args.systems)).indices
    tail = (y0[top].contiguous(), h0[top].contiguous(),
            {k: v[top].contiguous() for k, v in params.items()}, forc.take_systems(top))
    tail_worst = int(ref.stats.n_attempts[top].max())
    _, tail_ms = timed(lambda: b1(tail), args.reps)
    print(f"B1 package build on its {top.numel()} slowest systems: {tail_ms:.3f} ms, "
          f"{1e3 * tail_ms / tail_worst:.3f} us a trip of the lone warp | {smi}", flush=True)
    summary.update(tail_ms=tail_ms)

    with _build.flags_in_use(PROBE_FLAGS):
        # ---- B1 under the probes ----
        b1(full)
        res, probed_ms = timed(lambda: b1(full), 1)
        held("the probed build against the package build", res, ref)
        per_block = geo["threads"] // 32
        rec = read_probes(geo["blocks"] * per_block)
        blocks = [rec[i:i + per_block] for i in range(0, len(rec), per_block)]
        t_zero = min(w[0] for w in rec)
        ends = [max(w[1] for w in b) - t_zero for b in blocks]
        trips, fills = sum(w[3] for w in rec), sum(w[4] for w in rec)
        att = sum(w[5] for w in rec)
        busy = sum(w[7] for w in rec) / sum(w[8] for w in rec)
        first_warps = sum(b[0][7] for b in blocks) / sum(b[0][8] for b in blocks)
        sms = {w[2] for w in rec}
        print(f"B1 (probed): {probed_ms:.3f} ms by events ({pkg_ms:.3f} without "
              f"probes); blocks end at (ms): {quantiles([e / 1e6 for e in ends])}; {trips} warp "
              f"trips for {att} attempts: lane efficiency {lane_efficiency(rec):.4f}; {fills} trips "
              f"({100 * fills / trips:.2f}%) pay for a dense fill; the warps spend "
              f"{100 * busy:.1f}% of their cycles in the run section (warp 0 of each block: "
              f"{100 * first_warps:.1f}%), the rest in the sort, admission and barriers; "
              f"{pkg_ms * 1e3 * len(sms) * per_block / trips:.3f} us of a resident warp's time "
              f"a trip | {smi}", flush=True)
        summary["probed"] = {"probed_ms": probed_ms, "trips": trips, "fill_trips": fills,
                             "lane_efficiency": lane_efficiency(rec), "run_share": busy,
                             "run_share_warp0": first_warps,
                             "block_end_ms": [min(ends) / 1e6, max(ends) / 1e6]}

    # ---- SASS ----
    sass = {}
    for kernel, (n_instr, loops) in sass_loops(built["package"][0]).items():
        if "rk45" in kernel:
            sass[kernel] = {"instructions": n_instr, "largest_loops": loops}
            print(f"sass {kernel}: {n_instr} instructions; largest loops "
                  f"(instructions from a backward branch to its target): {loops}", flush=True)
    summary["sass"] = sass

    # ---- the other builds ----
    if args.variants:
        summary["variants"] = {}
        for name in [*variants(), "package"]:
            with _build.flags_in_use(flag_sets[name]):
                b1(full)
                res, ms = timed(lambda: b1(full), args.reps)
                _, t_ms = timed(lambda: b1(tail), args.reps)
                v_geo = k_rk45.rk45_geometry(args.systems)
            held(f"variant {name}", res, ref)
            print(f"variant {name}: B1 {ms:.3f} ms, slowest {top.numel()} systems {t_ms:.3f} ms, "
                  f"{v_geo['threads']} threads, {v_geo['shared_bytes']} bytes shared; "
                  f"{ptxas_line(built[name][2], 'rk45_kernel')} | {smi}", flush=True)
            summary["variants"][name] = {"ms": ms, "tail_ms": t_ms,
                                         "ptxas": ptxas_line(built[name][2], "rk45_kernel")}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
