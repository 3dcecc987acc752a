"""Where the two-phase solve's time goes on one CUDA card, and what the
kernels' ``-fmad=false`` build costs.

    python -m tiger_tpu_torch.profile_solve [--systems 131072] [--days 2]
        [--reps 5] [--trace DIR]

1. builds the kernels twice: with the package's flags (``_build.NVCC_FLAGS``,
   no FMA contraction) and with nvcc's default contraction
   (``_build.FMAD_FLAGS``);
2. profiles one solve of the main path (Model 204, 0.1% stiff systems,
   hourly queries, rtol 1e-5 / atol 1e-8) after a warm-up, with
   ``torch.profiler``: each kernel's device time and share, the device's
   busy share of the wall, and the peak device memory;
3. times B1 (every system), B2 (the stiff subset over the full span) and
   the whole solve under both builds, in the order package, contracted,
   contracted, package, by CUDA events (median of ``--reps``);
4. holds the contracted build's results against the package build's (which
   equals the plain versions bit for bit): entries outside rtol 1e-3 /
   atol 1e-6, stiff flags, attempt counts.

One line per measurement; the last line is a JSON summary.  ``--trace``
writes the profiler's Chrome trace into DIR.

    python -m tiger_tpu_torch.profile_solve --f64-pow [--systems 131072] [--days 2]

measures instead what the double instances' call to ``pow_contracted``
(csrc/contracted.cu) costs: B1 and B2 in float64 at the reference's rtol
1e-6 / atol 1e-9 (B2 on the systems B1 flags), with the package's build and
with ``-DTT_POW_INLINE`` (libdevice's pow inlined under ``-fmad=false``,
which rounds an ulp away from torch's pow now and then), in the order
package, inline, inline, package; each build's registers and spills of the
double kernels, and how many systems' results differ between the two.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from tiger_tpu_torch import Model204, SolverConfig, solve
from tiger_tpu_torch.kernels import _build
from tiger_tpu_torch.kernels import radau as k_radau
from tiger_tpu_torch.kernels import rk45 as k_rk45
from tiger_tpu_torch.profiling import union_length
from tiger_tpu_torch.scenario import scenario
from tiger_tpu_torch.solver.controller import initial_step

RTOL, ATOL = 1e-3, 1e-6
BUILDS = {"package": _build.NVCC_FLAGS, "contracted": _build.FMAD_FLAGS}
POW_BUILDS = {"package": _build.NVCC_FLAGS, "pow_inline": _build.NVCC_FLAGS + ("-DTT_POW_INLINE",)}


def timed(fn, reps):
    """(last result, median ms) of fn() on the current stream, by CUDA events."""
    times, out = [], None
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return out, sorted(times)[len(times) // 2]


def n_outside(a, b) -> int:
    return int(((a - b).abs() > ATOL + RTOL * b.abs()).sum())


def profile(run) -> dict:
    """Device time per kernel over one run() under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    groups = {"rk45_kernel (B1)": 0.0, "radau_kernel (B2)": 0.0, "other device work": 0.0}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (ev.time_range.start, ev.time_range.end)
        spans.append(span)
        key = ("rk45_kernel (B1)" if "rk45_kernel" in ev.name
               else "radau_kernel (B2)" if "radau_kernel" in ev.name else "other device work")
        groups[key] += span[1] - span[0]
    return {"prof": prof, "wall_us": wall_us, "device_us": groups,
            "busy_us": union_length(spans), "peak_bytes": torch.cuda.max_memory_allocated()}


def pow_call_cost(args, smi: str) -> None:
    """--f64-pow: the double instances with pow called and pow inlined."""
    for name, flags in POW_BUILDS.items():
        _, seconds, log = _build.build(flags)
        lines = log.splitlines()
        regs = [f"{lines[i].split()[-3]} | {lines[i + 1].strip()} | {lines[i + 2].strip()}"
                for i, ln in enumerate(lines[:-2]) if "Compiling entry" in ln and "IdLi0" in ln]
        print(f"build {name}: {seconds:.1f} s; double kernels {regs}", flush=True)
    dev, f64 = torch.device("cuda", 0), torch.float64
    model, cfg, tf = Model204(), SolverConfig(), args.days * 1440.0
    y0, params, forc = scenario(args.systems, args.days, 0.001, device=dev, dtype=f64)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=f64, device=dev)
    h0 = initial_step(model, y0, 0.0, params, forc, cfg)
    rows = torch.nonzero(k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg).stiff).squeeze(1)
    sub = (y0[rows].contiguous(), h0[rows].contiguous())
    sp = {k: v[rows].contiguous() for k, v in params.items()}
    sf = forc.take_systems(rows)
    times, results = {name: [] for name in POW_BUILDS}, {}
    for name in ("package", "pow_inline", "pow_inline", "package"):
        with _build.flags_in_use(POW_BUILDS[name]):
            rk, b1 = timed(lambda: k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg),
                           args.reps)
            rd, b2 = timed(lambda: k_radau.radau(model, *sub, 0.0, tf, qt, sp, sf, cfg), args.reps)
        times[name].append({"b1_ms": b1, "b2_ms": b2})
        results[name] = (rk, rd)
        print(f"float64 times {name}: B1 {b1:.3f} ms ({args.systems} systems), B2 {b2:.3f} ms "
              f"({rows.numel()} systems, {args.days:g} days) | {smi}", flush=True)
    (rk_p, rd_p), (rk_i, rd_i) = results["package"], results["pow_inline"]
    differ = {"b1_systems": int((torch.nan_to_num(rk_p.y_final) != torch.nan_to_num(rk_i.y_final))
                                .any(dim=1).sum()),
              "b1_equal_attempts": int((rk_p.stats.n_attempts == rk_i.stats.n_attempts).sum()),
              "b2_systems": int((torch.nan_to_num(rd_p.y_final) != torch.nan_to_num(rd_i.y_final))
                                .any(dim=1).sum()),
              "b2_equal_attempts": int((rd_p.stats.n_attempts == rd_i.stats.n_attempts).sum())}
    print(f"pow inline vs package: {differ}", flush=True)
    print(json.dumps({"card": smi, "systems": args.systems, "days": args.days,
                      "n_stiff_rows": rows.numel(), "times": times, "pow_inline_vs_package": differ}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--systems", type=int, default=131_072)
    ap.add_argument("--days", type=float, default=2.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default=None, help="directory for the Chrome trace")
    ap.add_argument("--f64-pow", action="store_true",
                    help="time the double instances with pow called and inlined instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve: needs a CUDA card")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    if args.f64_pow:
        pow_call_cost(args, smi)
        return
    for name, flags in BUILDS.items():
        path, seconds, log = _build.build(flags)
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {name}: {seconds:.1f} s, {path.name}; {' | '.join(regs)}", flush=True)

    dev = torch.device("cuda", 0)
    model = Model204()
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    tf = args.days * 1440.0
    y0, params, forc = scenario(args.systems, args.days, 0.001, device=dev)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=torch.float32, device=dev)
    h0 = initial_step(model, y0, 0.0, params, forc, cfg)

    def run_solve():
        return solve(model, y0, 0.0, tf, qt, params, forc, cfg)

    # 2. profile the package build
    run_solve()
    p = profile(run_solve)
    dev_total = sum(p["device_us"].values())
    for key, us in p["device_us"].items():
        print(f"profile: {key} {us / 1e3:.3f} ms device, {100 * us / max(dev_total, 1e-9):.1f}% "
              "of device time", flush=True)
    print(f"profile: device busy {p['busy_us'] / 1e3:.3f} ms of a {p['wall_us'] / 1e3:.3f} ms "
          f"profiled wall ({100 * p['busy_us'] / p['wall_us']:.1f}%); peak device memory "
          f"{p['peak_bytes'] / 1e6:.1f} MB | {smi}", flush=True)
    if not dev_total:
        print("profile: the profiler recorded no device time; see the CUDA-event times below")
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        p["prof"].export_chrome_trace(os.path.join(args.trace, "solve_trace.json"))

    # 3. times under both builds, package / contracted / contracted / package
    rk = k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg)
    rows = torch.nonzero(rk.stiff).squeeze(1)
    sub = (y0[rows].contiguous(), h0[rows].contiguous())
    sp = {k: v[rows].contiguous() for k, v in params.items()}
    sf = forc.take_systems(rows)
    times = {name: [] for name in BUILDS}
    results = {}
    for name in ("package", "contracted", "contracted", "package"):
        with _build.flags_in_use(BUILDS[name]):
            rk, b1 = timed(lambda: k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg),
                           args.reps)
            rd, b2 = timed(lambda: k_radau.radau(model, *sub, 0.0, tf, qt, sp, sf, cfg), args.reps)
            res, whole = timed(run_solve, args.reps)
        times[name].append({"b1_ms": b1, "b2_ms": b2, "solve_ms": whole})
        results[name] = (rk, rd, res)
        print(f"times {name}: B1 {b1:.3f} ms ({args.systems} systems), B2 {b2:.3f} ms "
              f"({rows.numel()} systems, {args.days:g} days), solve {whole:.3f} ms, n_stiff "
              f"{res.n_stiff}, n_failed {int(res.failed.sum())} | {smi}", flush=True)

    # 4. the contracted build against the package build
    (rk_p, rd_p, _), (rk_c, rd_c, _) = results["package"], results["contracted"]
    both = ~rk_p.stiff & ~rk_c.stiff
    att_p, att_c = int(rk_p.stats.n_attempts.sum()), int(rk_c.stats.n_attempts.sum())
    agree = {
        "b1_outside": n_outside(rk_c.y_final[both], rk_p.y_final[both])
        + n_outside(rk_c.dense[both], rk_p.dense[both]),
        "b1_dense_entries": int(rk_p.dense[both].numel()),
        "b1_stiff_differ": int((rk_c.stiff != rk_p.stiff).sum()),
        "b1_equal_attempts": int((rk_c.stats.n_attempts == rk_p.stats.n_attempts).sum()),
        "b1_attempts": [att_p, att_c],
        "b2_outside": n_outside(rd_c.y_final, rd_p.y_final) + n_outside(rd_c.dense, rd_p.dense),
        "b2_failed": [int(rd_p.failed.sum()), int(rd_c.failed.sum())],
        "b2_equal_attempts": int((rd_c.stats.n_attempts == rd_p.stats.n_attempts).sum()),
    }
    print(f"contracted vs package: {agree}", flush=True)
    print(json.dumps({
        "card": smi, "systems": args.systems, "days": args.days, "n_stiff_rows": rows.numel(),
        "device_ms": {k: v / 1e3 for k, v in p["device_us"].items()},
        "busy_share": p["busy_us"] / p["wall_us"], "peak_mb": p["peak_bytes"] / 1e6,
        "times": times, "contracted_vs_package": agree,
    }))


if __name__ == "__main__":
    main()
