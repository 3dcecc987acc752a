"""Where one B2 attempt's time goes on the card, phase by phase.

    python -m tiger_tpu_torch.radau_phases [--systems 131072] [--days 2] [--reps 5]

Builds the kernels a second time with ``-DTT_RADAU_PHASES``, which compiles
``clock64()`` probes into ``csrc/radau.cu``: lane 0 of each system's warp
sums the cycles of each phase of its attempt loop.  Runs B1 over the main
path's systems (Model 204, 0.1% stiff, hourly queries, rtol 1e-5 / atol
1e-8), then B2 on the systems B1 flagged, over the full span, and prints

- each phase's cycles per attempt (per Newton sweep for the sweep's three
  phases) and its share of the attempt loop;
- the slowest system's cycles per attempt, and the clock they imply;
- B2's time with and without the probes (CUDA events, median of
  ``--reps``): what the probes cost.

The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from tiger_tpu_torch import Model204, SolverConfig
from tiger_tpu_torch.kernels import _build
from tiger_tpu_torch.kernels import radau as k_radau
from tiger_tpu_torch.kernels import rk45 as k_rk45
from tiger_tpu_torch.profile_solve import timed
from tiger_tpu_torch.scenario import scenario
from tiger_tpu_torch.solver.controller import initial_step

PROBE_FLAGS = _build.NVCC_FLAGS + ("-DTT_RADAU_PHASES",)
# radau.cu's TT_PHASE(k) probes, in order.
PHASES = (
    "step start: h_eff, step cap, gather",
    "f and the five Jacobian right-hand sides",
    "Jacobian entries and both LUs",
    "sweep: the three stage right-hand sides",
    "sweep: w and both solves",
    "sweep: slope updates and the warp maxima",
    "step update, error, dense output, controller",
)
SWEEP_PHASES = (3, 4, 5)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--systems", type=int, default=131_072)
    ap.add_argument("--days", type=float, default=2.0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("radau_phases: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    dev = torch.device("cuda", 0)
    model = Model204()
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    tf = args.days * 1440.0
    y0, params, forc = scenario(args.systems, args.days, 0.001, device=dev)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=torch.float32, device=dev)
    h0 = initial_step(model, y0, 0.0, params, forc, cfg)
    rows = torch.nonzero(k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg).stiff).squeeze(1)
    sub = (y0[rows].contiguous(), h0[rows].contiguous())
    sp = {k: v[rows].contiguous() for k, v in params.items()}
    sf = forc.take_systems(rows)

    def run():
        return k_radau.radau(model, *sub, 0.0, tf, qt, sp, sf, cfg)

    _, plain_ms = timed(run, args.reps)
    cycles = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    with _build.flags_in_use(PROBE_FLAGS):
        lib = _build.load()
        lib.tt_radau_phase_cycles.argtypes = [ctypes.c_void_p]
        lib.tt_radau_phase_cycles.restype = ctypes.c_int

        def read():
            torch.cuda.synchronize()
            rc = lib.tt_radau_phase_cycles(cycles)
            if rc:
                raise RuntimeError(f"tt_radau_phase_cycles: CUDA error {rc}")
            return list(cycles)

        run()
        read()  # clears the warm-up's counts
        res = run()
        cyc = read()
        _, probe_ms = timed(run, args.reps)

    attempts, sweeps = int(res.stats.n_attempts.sum()), int(res.stats.n_newton.sum())
    worst = int(res.stats.n_attempts.max())
    loop = sum(cyc[: len(PHASES)])
    phases = []
    for k, name in enumerate(PHASES):
        per_sweep = cyc[k] / sweeps if k in SWEEP_PHASES else None
        phases.append({"phase": name, "cycles_per_attempt": cyc[k] / attempts,
                       "cycles_per_sweep": per_sweep, "share": cyc[k] / loop})
        sweep_txt = f" ({per_sweep:.1f} per sweep)" if per_sweep is not None else ""
        print(f"phase {k} {name}: {cyc[k] / attempts:.1f} cycles per attempt{sweep_txt}, "
              f"{100 * cyc[k] / loop:.1f}%", flush=True)
    ghz = cyc[-1] / (probe_ms * 1e-3) / 1e9
    print(f"slowest system: {cyc[-1]} cycles, {cyc[-1] / worst:.1f} per attempt of the worst system "
          f"({worst} attempts), {ghz:.3f} GHz over B2's probed time; {attempts} attempts, "
          f"{sweeps / attempts:.4f} sweeps per attempt, {rows.numel()} systems", flush=True)
    print(f"B2 {plain_ms:.3f} ms without probes, {probe_ms:.3f} ms with | {smi}", flush=True)
    print(json.dumps({"card": smi, "systems": args.systems, "days": args.days,
                      "stiff_systems": rows.numel(), "attempts": attempts, "sweeps": sweeps,
                      "worst_attempts": worst, "phases": phases, "slowest_cycles": cyc[-1],
                      "b2_ms": plain_ms, "b2_probed_ms": probe_ms}))


if __name__ == "__main__":
    main()
