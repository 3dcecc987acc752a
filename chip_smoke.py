#!/usr/bin/env python3
"""Smoke run of tiger_tpu_torch on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each (any failed check raises, so the exit code is not 0):
  1. device: nvidia-smi's name and power limit; refuses to run without CUDA;
  2. build: both CUDA kernels from tiger_tpu_torch/kernels/csrc with nvcc,
     and beside it the build with B1's probes (-DTT_RK45_PHASES) and phase
     12a's libm_check.cu in a library of its own;
  3. B1 (rk45.cu) against rk45_plain on the card: 4,096 systems, 2 days;
  4. B2 (radau.cu) against radau_plain on the systems phase 3 flagged;
  5. solve() on those 4,096 systems against phases 3-4's plain results, then
     the main path: solve() at 131,072 systems, 2 days, 49 hourly queries,
     rtol 1e-5 / atol 1e-8, 0.1% stiff systems -- one warm-up and 3 timed
     runs, with the launch counters set to 0 just before;
  6. each kernel against its plain version at the main-path shapes: B1 over
     the 131,072 systems, B2 over the systems B1 flagged, the full span (B2's
     radau_plain over the full 2 days runs at the end, side by side with the
     shared span's plain checks); the times, and phases 3-4's checks on the
     results.  Then B1
     alone on the 32 systems that took it the most attempts (its tail), B1's
     lane efficiency counted by the probed build (attempts over 32 x warp
     trips through the attempt loop), and each kernel's bound: the least time
     the card could take for this run's operations and bytes.
  7. the CLI at full width: a basin of 131,072 links written as the files
     users give it (parameter CSV, lookup CSV, hourly and daily forcing grids
     of 256 x 512 cells, a binary-tree river network), run through
     tiger_tpu_torch.run.run with routed discharge, once to warm up and once
     timed, with the launch counters set to 0 just before; its per-phase
     times, the dense output read back from disk against a direct solve() on
     the loaders' tensors (bit for bit), the routed discharge against the
     direct one (bit for bit: routing sums in a fixed order), and one more run
     with output.format csv;
  8. the windowed CLI at full width: the same basin over 4 days in 1-day
     windows with checkpoints every day.  (a) one warm-up and one timed run,
     with the launch counters set to 0 just before the timed one: its wall,
     phases, each window's wall, the overlap of the forcing loads and of the
     output writes with the windows' device work, and the host's peak
     memory; then the run again under profiling.trace for the device's busy
     share.  (b) the same 4 windows by hand (netcdf_window_loader, solve(),
     the carried state, routed_discharge): the run's dense, final, state and
     discharge files equal them bit for bit.  (c) the run again, its third
     window's solve raising, then resumed from the t = 2880 checkpoint into
     the same files: equal to (a)'s bit for bit.  (d) an i16 run with
     declared ranges: within 0.75 of a code step of (a)'s values.  For
     information: (a) against an unchunked run, and the routing against the
     index_add version it replaced, timed at 131,072 links x 97 queries.
  9. the solver options (each kernel's option instances; options_phase).
     (a) every instance against its plain version: B1's six (the I and PI
     controllers, each plain, with FSAL and compensated) on 1,024 systems
     over 6 hours, FSAL also against the default instance; B2's six (the
     three error modes, each with and without the predictor) on the
     systems the default B1 flagged there (4), over the first 5 minutes
     only, since the plain Radau pays ~45 ms of launches an attempt;
     'reference' ends every stiff system at max_steps (its estimate caps h
     near the tolerance), so it runs with max_steps 150 at rtol 1e-3.  (b)
     the slice's path at full width, with the launch counters set to 0
     just before: solve() at 131,072 systems with compensated float32
     (precision f32c) at the reference's rtol 1e-6 / atol 1e-9, and with
     the PI controller at the main path's rtol 1e-5 / atol 1e-8, each one
     warm-up and 3 timed runs; one solve() with each other instance (B1's
     fail no system; B2's option instances report the stiff systems their
     float32 estimates fail over the 2 days, as data, before and after the
     float64 retry); each instance's own time at the main path's shapes;
     B1 compensated at rtol 1e-6 against rk45_plain over the 131,072
     systems and 2 days, with phases 3-4's exact check (B2 against
     radau_plain on the systems it flagged runs at the end, over the
     leading span of plain_span_checks);
     and (accuracy) compensated and plain float32 at rtol 1e-6 against
     rk45_plain in float64 on the first 4,096 systems over the first day
     (ACCURACY_SPAN), beside a second
     float64 run from an h0 2^-20 apart, with the tail's systems listed
     (their attempts and the steps that ended in a forcing boundary's snap
     window): compensated the closer in the median system.  (c) the CLI at
     131,072 links with solver.precision f32c: its dense file equals a
     direct solve() bit for bit, its routed discharge the direct one.
 10. float64 (float64_phase): each kernel's double instance of the default
     option set, at the reference's tolerances (SolverConfig() defaults,
     rtol 1e-6 / atol 1e-9).  With the launch counters set to 0 just
     before: (c) the slice's path at full width, solve() in float64 at
     131,072 systems, 2 days, 49 hourly queries, one warm-up and 3 timed
     runs; (d) the CLI at 131,072 links with a config that sets neither
     solver.precision nor the tolerances, so it runs f64 at the defaults:
     its dense, final, state and discharge files equal a direct solve() and
     routed_discharge() bit for bit; (e) the same basin in 2 one-day windows
     with a daily checkpoint: its files equal the windows run by hand bit
     for bit.  Then (a) B1's double instance against rk45_plain in float64
     over the 131,072 systems and 2 days, and B2's time on every system (a)
     flagged (its check against radau_plain, (b), runs at the end).
     (f) the other option sets' double instances (doubles_phase): solve()
     in float64 at full width with each, the counters set to 0 just before
     (B1's fail no system; B2's report theirs as data); each one's time at
     the main path's shapes; each against its float64 plain version with
     phases 3-4's exact check at phase 9a's shapes and rules.  (g) the CLI
     at 131,072 links with solver.controller pi and no solver.precision
     (f64): its files equal the direct path bit for bit.
 11. the float64 retry of the systems B2 fails (retry_phase): for each B2
     option set whose float32 Radau fails systems in 9b, solve() at
     131,072 systems, 2 days, 49 queries, float32 at rtol 1e-5 / atol 1e-8,
     the counters set to 0 just before and read just after: its stiff and
     failed counts before and after the retry, the rows the double B1
     resolved and those the double B2 took, its wall with and without the
     retry (WALL_PAIRS timed runs of each, taken in turn).  Check 1: the
     result equals the chain run by hand through the kernels (B1 and B2
     float, B1 double on B2's failures, B2 double on those still stiff) bit
     for bit.  Check 3: a system left failed is one B2's double instance
     fails.  Check 2 runs at the end with the plain Radau checks of 9b,
     10b and 12d (plain_span_checks): the retried rows of radau5 and
     of radau5 with the predictor (CHECK_2_SETS) against the same chain
     through rk45_plain and radau_plain in float64, B2 embedded3 at rtol
     1e-6 and embedded3/f64 against radau_plain, all over one leading span: the longest (2 days down to
     45 minutes) whose worst systems' attempts, at PLAIN_RADAU_MS an
     attempt, keep the whole script inside F64_BUDGET_S.
 12. Model 200 (model_phase with M200; 12a libm_phase first): Hamon PET and
     the ET ramp in both kernels, on scenario()'s basin with the latitude
     over 25-50 degrees, doy0 182, float32 at rtol 1e-5 / atol 1e-8.  (a)
     each libm call of its rhs (exp, sin, cos, tan, atan, asin, acos; float
     and double) on 16M inputs and the edge values, as the instances call
     it (libm_check.cu), against torch's CUDA function element by element:
     0 may differ.  (c) the slice's path at full width, with the counters
     set to 0 just before: solve() in float32, then float64 at
     SolverConfig()'s defaults, one warm-up and 3 timed runs each (stiff
     count as data, 0 failed), and one solve() with each other option set's
     B1 instance.  (f) the CLI at 131,072 links with model.uid 200 from
     2000-07-01 (doy0 183): its files equal a direct solve() bit for bit;
     then 2 one-day windows (t_shift 1440 in the second) equal the windows
     by hand.  (b) B1 m200/default against rk45_plain at full width, again
     with t_shift 1440 on the first 4,096 systems over 12 hours, and
     m200/default/f64 at rtol 1e-6 / atol 1e-9 on 4,096 systems over 12
     hours, each with phases 3-4's exact check.  (d) B2 m200/embedded3 on
     all 131,072 systems from bench.py --solver radau's h0 (1e-3), one
     warm-up and 3 timed, 0 failed; its check against radau_plain on its 32
     systems with the most attempts and 96 others joins plain_span_checks
     as "12".  (e) every other Model 200 instance against its plain
     version exactly: B1 on 256 systems over 1 hour (FSAL against the
     default as data), B2 on (d)'s 4 costliest systems over 5 minutes, each
     B2 instance once with the counters set to 0 just before.
 13. DummyModel (model_phase with DUMMY), the reference's 5-state linear
     test system, through the same functions: full width is 131,072
     systems from seeded states (uniform 0.5-2.0) over t in [0, 5] with
     1,000 queries, no parameters, no forcings.  (c) solve() in float32 and
     float64 as 12c (no system stiff, so no B2 launch), each other B1
     instance's solve() and every B1 instance's time.  (f) the CLI with
     model.uid 1 at 131,072 links over 2 days, whole and in 2 one-day
     windows, against a direct solve() and the windows by hand, bit for
     bit.  (b) B1 dummy/default against rk45_plain at full width; t_shift
     1440 on 4,096 systems changes nothing in the kernel or in rk45_plain;
     dummy/default/f64 at rtol 1e-6 / atol 1e-9 against rk45_plain at full
     width.  (d) B2 dummy/embedded3 and dummy/embedded3/f64 on all 131,072
     systems from initial_step's h0, timed; each against radau_plain on its
     32 costliest systems and 96 others over the whole 5 minutes, with the
     shared span's checks ("13", "13 f64").  (e) all 24 instances against
     their plain versions at the reference's golden shapes (4 systems of
     ones, t in [0, 5], the 10,000-query grid without the t0 fill; float32
     at rtol 1e-5, float64 at rtol 1e-6 / atol 1e-9), each again with
     t_shift 1440 (unchanged), FSAL equal to its twin, each B2 instance once
     with the counters set to 0 just before; and dummy/default/f64 at the
     golden final state within 5e-6.
 14. several processes (dist_phase): (a) solve(..., devices=[cuda:0,
     cuda:0]) on phase 5's inputs, its halves on two streams, equal to phase
     5's one-device solve bit for bit; (b) two rank processes of the CLI on
     the one card under gloo (routed_exchange ring, allgather, 1-day windows
     with daily checkpoints, ring again): their files, concatenated, equal a
     one-process run bit for bit, allgather's discharge too, ring's within
     routing.ring_error_bound, the second ring run the first bit for bit;
     (c) one nccl process at world size 1: its files equal the one-process
     run's.  Launches counted over its runs ("dist_launches").
 15. the TPU kernels' last options (last_options_phase), at the main path's
     shapes: (a) solve() with dense_lockstep, forcing_dtype bf16 and
     radau_factor_reuse, one warm-up and 3 timed, the counters set to 0
     just before and read just after, each option launched ("option
     launches"), 0 failed; (b) B1 with lockstep in float and double and (c)
     with bf16 forcing for Model 204 and Model 200, each against rk45_plain
     bit for bit, the forcing's bytes in float32 and bfloat16; (d) B2 with
     factor reuse, embedded3 and radau5 in float and double, on phase 6's
     stiff systems, timed beside the same call without reuse, n_fct/n_att,
     each held to radau_plain at the end over the shared span ("15d ...");
     (e) B2 m200/embedded3 with reuse on all 131,072 systems, timed once,
     n_fct/n_att; (f) the CLI with solver.forcing_precision bf16: its dense
     and final files equal a direct solve() bit for bit.  B1 default's and
     B2 embedded3's times (phase 6) printed beside PR 12's.
The CLI phases (7, 9c, 10d, 10g, 12f, 13f, 14, 15f) read one written basin
(basin_doc).  The plain versions of 9a, 10f, 12e, 13e and 15b-c (and 13e's
B2 at 131,072 systems), and the plain Radau checks of 6 (the full 2 days),
9b, 10b, 11, 12d, 13d and 15d, which run last, go to SIDE_BY_SIDE processes started
at the beginning (PlainPool), each after the kernels it is held to have
run and been timed.  The line before the kernels' JSON record gives the
script's fixed part: its seconds less those of the plain checks at the end.
Each kernel must equal its plain version exactly: max_abs_err 0, NaN in the
same places, every flag and every counter of every system equal.  The line
before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time
from collections.abc import Callable

import torch

MAIN_SYSTEMS = 131_072
N_EQ_ALL = 5  # every model's states
DAYS = 2.0
STIFF_FRAC = 0.001
CHECK_SYSTEMS = 4096
# solve() against the plain versions' merged results (phase 5).  The kernels
# themselves are held to their plain versions exactly.
RTOL, ATOL = 1e-3, 1e-6
TAIL_SYSTEMS = 32  # one warp of B1's slowest systems

# The bound of each kernel: its operations over the H100 SXM's float32 peak
# outside the tensor cores (the double instances: over its float64 peak
# outside the tensor cores, 34 TFLOP/s, NVIDIA's data sheet), or its bytes
# (each input read once, each output written once) over the HBM3 rate,
# whichever takes longer.
F32_PEAK, F64_PEAK, HBM_RATE = 67e12, 34e12, 3.35e12
# Floating-point operations, counted from the kernels' code: each +, -, *, /,
# min, max, abs, compare-and-select and libm call is one (a division or a libm
# call costs the card many instructions, so the bound is generous).
RHS_OPS = 31  # common.cuh Model204::rhs
STEP_OPS = 25  # h_eff, the ZOH step cap and the gather, 2 forcings
# B2 (radau.cu): per attempt, the six right-hand sides of f and the Jacobian,
# the perturbations (20), the entries of both matrices (110), the real LU (75),
# the complex LU (330), tol_y (15), the step update and embedded3 error (130),
# the controller and Kahan t (19); per Newton sweep, the stage states (99),
# three right-hand sides, the residuals (15), w (75), the real solve (45), the
# complex solve (190), the slope updates and their norms (195), the exit test
# (5); per dense query, the coefficients (90, at most once a query) and the
# polynomial (43).
B2_ATTEMPT_OPS = 6 * RHS_OPS + 20 + 110 + 75 + 330 + 15 + 130 + 19 + STEP_OPS
B2_SWEEP_OPS = 3 * RHS_OPS + 99 + 15 + 75 + 45 + 190 + 195 + 5
B2_QUERY_OPS = 90 + 43

_T0 = time.perf_counter()


def say(msg: str) -> None:
    print(msg, flush=True)


def phase(msg: str) -> None:
    say(f"{msg} [{time.perf_counter() - _T0:.1f} s]")


def check(ok: bool, msg: str) -> None:
    """Fail the run (a raise, so it holds under ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def n_outside(a: torch.Tensor, b: torch.Tensor) -> int:
    return int(((a - b).abs() > ATOL + RTOL * b.abs()).sum())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def bound(ops: float, nbytes: float, peak: float = F32_PEAK) -> tuple[float, str]:
    """(bound_ms, bound_by) of work that does ``ops`` operations at
    ``peak`` and moves ``nbytes`` bytes."""
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def io_bytes(s_count: int, n_rows: int, n_q: int, out_words: int, real: int = 4) -> int:
    """Bytes of one launch over ``s_count`` systems: y0, h0, params and the
    queries in, ``real`` bytes a value, and the ``n_rows`` float32 forcing
    rows; y_final and dense out, ``real`` bytes a value, and ``out_words``
    4-byte flag and counter words a system."""
    return (real * (s_count * (5 + 1 + 15) + n_q + s_count * (5 + 5 * n_q))
            + 4 * s_count * (n_rows + out_words))


def b1_ops(attempts: int, queries: int, options: int = 0, rhs_ops: int = RHS_OPS) -> int:
    """B1's operations (rk45.cu): per attempt, seven right-hand sides, the
    stage, update and error sums (11 per nonzero tableau entry), the error norm
    (40), the slope-jump test (15), the controller, stiffness tests and Kahan t
    (57); per dense query, the quartic coefficients (10 per nonzero entry of
    DP_P, at most once a query) and the polynomial (58).  The option
    instances: FSAL takes k1 from its carry (one right-hand side less); the
    compensated commit adds y + dy and a TwoSum per component (25); PI adds
    facold^beta, its product and facold's update (3).  ``rhs_ops``: the
    model's right-hand side (Model 200: RHS_OPS_M200)."""
    from tiger_tpu_torch.kernels.rk45 import COMPENSATED, FSAL, PI
    from tiger_tpu_torch.solver import tableau

    def nnz(x) -> int:
        return int((x != 0).sum())

    per_attempt = (7 * rhs_ops + 11 * (nnz(tableau.DP_A) + nnz(tableau.DP_B) + nnz(tableau.DP_E))
                   + 40 + 15 + 57 + STEP_OPS)
    per_attempt += (-rhs_ops if options & FSAL else 0) + (25 if options & COMPENSATED else 0)
    per_attempt += 3 if options & PI else 0
    return attempts * per_attempt + queries * (10 * nnz(tableau.DP_P) + 58)


# B2's option instances (radau.cu): radau5's error is the defect (30), one
# real solve (45), the product by h and the norm (20) where embedded3's sum
# and norm are (45), and its safety one division more; the predictor's start
# is the theta powers and weights (60) and 15 slopes of 3 x 7 (315).
B2_RADAU5_OPS = 30 + 45 + 20 - 45 + 2
B2_PREDICTOR_OPS = 60 + 315


def b2_ops(attempts: int, sweeps: int, queries: int, cfg=None, rhs_ops: int = RHS_OPS) -> int:
    """B2's operations (radau.cu): B2_ATTEMPT_OPS an attempt (six
    right-hand sides) and B2_SWEEP_OPS a Newton sweep (three), each with the
    model's right-hand side (``rhs_ops``; Model 200: RHS_OPS_M200);
    B2_QUERY_OPS a system's dense query; and the option instances' own
    per attempt (``cfg``'s error mode and predictor)."""
    extra = 0 if cfg is None else ((B2_RADAU5_OPS if cfg.radau_error_mode == "radau5" else 0)
                                   + (B2_PREDICTOR_OPS if cfg.radau_predictor else 0))
    return (attempts * (B2_ATTEMPT_OPS + 6 * (rhs_ops - RHS_OPS) + extra)
            + sweeps * (B2_SWEEP_OPS + 3 * (rhs_ops - RHS_OPS)) + queries * B2_QUERY_OPS)


def timed(fn, reps: int = 1):
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


def check_rk45(label, ker, ref, hu_rows) -> float:
    """Phases 3 and 6: B1 equals rk45_plain bit for bit; returns max_abs_err."""
    from tiger_tpu_torch.kernels.rk45 import rk45_mismatch

    diff = rk45_mismatch(ker, ref)
    err = max(max_abs(torch.nan_to_num(ker.y_final), torch.nan_to_num(ref.y_final)),
              max_abs(torch.nan_to_num(ker.dense), torch.nan_to_num(ref.dense)))
    att_k, att_p = int(ker.stats.n_attempts.sum()), int(ref.stats.n_attempts.sum())
    phase(f"{label}: max_abs_err={err:.3e}, entries that differ (a NaN equals a NaN) {diff}, "
          f"attempts {att_k} vs {att_p}, stiff {int(ker.stiff.sum())}, failed {int(ker.failed.sum())}")
    check(err == 0.0 and not any(diff.values()), f"{label}: B1 differs from rk45_plain: {diff}")
    check(bool(ker.stiff[hu_rows].all()), f"{label}: a Hu=1e-6 row was not flagged")
    return err


def radau_diff(ker, ref) -> dict:
    """What check_radau holds of B2's result ``ker`` and radau_plain's
    ``ref``, as numbers (a plain_worker computes it where the two results
    are too large to pass between processes)."""
    return dict(
        max_abs_err=max(max_abs(torch.nan_to_num(ker.y_final), torch.nan_to_num(ref.y_final)),
                        max_abs(ker.dense, ref.dense)),
        n_sys=ker.failed.numel(), same=[int((a == b).sum()) for a, b in zip(ker.stats, ref.stats)],
        failed=(int(ker.failed.sum()), int(ref.failed.sum())),
        same_failed=bool(torch.equal(ker.failed, ref.failed)),
        same_nan=bool(torch.equal(torch.isnan(ker.y_final), torch.isnan(ref.y_final))),
        attempts=(int(ker.stats.n_attempts.sum()), int(ref.stats.n_attempts.sum())),
        sweeps=int(ker.stats.n_newton.sum()),
        worst=(int(ker.stats.n_attempts.max()), int(ref.stats.n_attempts.max())))


def check_radau(label, ker, ref, may_fail: bool = False, diff: dict | None = None) -> float:
    """Phases 4, 6 and 9: B2 equals radau_plain bit for bit; returns
    max_abs_err.  Unless ``may_fail``, no system may fail.  ``diff``:
    radau_diff of the two, computed elsewhere (``ker`` and ``ref`` unread)."""
    d = radau_diff(ker, ref) if diff is None else diff
    err, n_sys, same = d["max_abs_err"], d["n_sys"], d["same"]
    phase(f"{label}: max_abs_err={err:.3e}, failed {d['failed'][0]}/{d['failed'][1]}, "
          f"systems with equal (accepted, rejected, attempts, sweeps, factorizations) {same} of "
          f"{n_sys}, attempts {d['attempts'][0]} vs {d['attempts'][1]}, sweeps {d['sweeps']}, worst "
          f"system {d['worst'][0]} vs {d['worst'][1]}")
    check(may_fail or not any(d["failed"]), f"{label}: a Radau solve failed")
    check(d["same_failed"], f"{label}: B2 fails other systems than radau_plain")
    check(d["same_nan"], f"{label}: B2's NaN differ from radau_plain's")
    check(err == 0.0, f"{label}: B2 differs from radau_plain by {err:.3e}")
    check(all(n == n_sys for n in same), f"{label}: B2's counters differ from radau_plain's")
    return err


#: The 2-day, 131,072-link basin the CLI phases (7, 9c, 10d, 10g, 12f, 13f,
#: 14) share: written once (basin_doc), removed at the end of main.
_BASIN: dict = {}


def basin_doc(out: str) -> dict:
    """A copy of the config document of write_basin's basin at the main
    path's shape (MAIN_SYSTEMS links, DAYS, STIFF_FRAC), written into a
    folder of its own on first use, with its outputs in ``out``.  Every CLI
    phase reads the same files; each writes into its own folder."""
    import copy
    import os
    import tempfile

    from tiger_tpu_torch.scenario import write_basin

    if "doc" not in _BASIN:
        folder = tempfile.mkdtemp(prefix="tiger_basin_")
        start = time.perf_counter()
        _BASIN.update(folder=folder, doc=write_basin(os.path.join(folder, "basin"), MAIN_SYSTEMS,
                                                      DAYS, STIFF_FRAC),
                      write_s=time.perf_counter() - start)
    doc = copy.deepcopy(_BASIN["doc"])
    doc["output"]["path"] = out
    return doc


def cli_phase(smi: str) -> dict:
    """Phase 7: the CLI run at full width; returns each kernel's launches."""
    import os
    import tempfile

    import numpy as np

    from tiger_tpu_torch import native, routing
    from tiger_tpu_torch.checkpoint import save_state
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.io import write_dense_netcdf, write_final_netcdf
    from tiger_tpu_torch.io.netcdf import output_format, read_netcdf
    from tiger_tpu_torch.params import load_spatial_params
    from tiger_tpu_torch.kernels import launch_totals, reset_launch_counts
    from tiger_tpu_torch.profiling import Metrics
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import STIFF_HU, solve_written_basin

    with tempfile.TemporaryDirectory(prefix="tiger_cli_") as tmp:
        doc = basin_doc(os.path.join(tmp, "out"))
        write_s = _BASIN["write_s"]
        cfg = config_from_dict(doc)
        fmt = output_format()
        why = ("h5py is installed" if fmt == "NETCDF4"
               else "h5py is not installed here, so scipy writes classic NetCDF")
        torch.cuda.synchronize()
        reset_launch_counts()
        run(cfg, metrics=Metrics())  # warm-up
        metrics = Metrics()
        start = time.perf_counter()
        out = run(cfg, metrics=metrics)
        wall = time.perf_counter() - start
        launches = launch_totals()
        phases = {k: round(v, 6) for k, v in metrics.phases.items()}
        phase(f"phase 7 CLI ({MAIN_SYSTEMS} links, {DAYS:g} days, {fmt} outputs: {why}): "
              f"wall {wall:.6f} s, phases_s {phases}, solve share of the wall "
              f"{metrics.phases['solve'] / wall:.4f}, n_stiff {out['n_stiff']}, n_failed "
              f"{out['n_failed']}, launches {launches}; basin written in {write_s:.3f} s | {smi}")
        check(launches["rk45"] > 0 and launches["radau"] > 0, f"phase 7: a kernel was not launched: {launches}")
        check(out["n_failed"] == 0, f"phase 7: {out['n_failed']} links failed")

        # The direct path: the loaders' tensors into solve(), no run() glue.
        res, params, sp = solve_written_basin(cfg, "cuda")
        stiff_rows = torch.as_tensor(sp["Hu"] == STIFF_HU, device=res.stiff.device)
        check(bool(res.stiff[stiff_rows].all()), "phase 7: a Hu=1e-6 link was not flagged stiff")
        check(res.n_stiff == out["n_stiff"], f"phase 7: {res.n_stiff} stiff directly, {out['n_stiff']} in the run")
        files = {name: read_netcdf(os.path.join(cfg.output.path, f"{name}_basin_rank_0.nc"),
                                   (var, "system"))[0]
                 for name, var in (("final", "outputs"), ("dense", "outputs"),
                                   ("discharge", "discharge"), ("state", "outputs"))}
        dense, y_final = res.dense.cpu().numpy(), res.y_final.cpu().numpy()
        n_q = int(round(DAYS * 24)) + 1
        check(files["dense"]["outputs"].shape == (MAIN_SYSTEMS, n_q, 5),
              f"phase 7: dense shape {files['dense']['outputs'].shape}")
        check(np.array_equal(files["dense"]["outputs"], dense), "phase 7: dense file differs from solve()")
        check(np.array_equal(files["final"]["outputs"], y_final), "phase 7: final file differs from solve()")
        check(np.array_equal(files["state"]["outputs"], y_final.astype(np.float64)),
              "phase 7: state file differs from solve()")
        check(np.array_equal(files["final"]["system"], sp["stream"]), "phase 7: link ids differ")
        topo = routing.build_topology(sp["stream"], sp["next_stream"])
        direct = routing.routed_discharge(res.dense, params, topo).cpu().numpy().astype(np.float64)
        q = files["discharge"]["discharge"]
        check(bool(np.isfinite(q).all() and (q >= 0).all()), "phase 7: discharge not finite or negative")
        check(np.array_equal(q, direct), "phase 7: discharge file differs from routed_discharge()")

        # Where load_params and write_output go: each part again, alone.
        parts = {}

        def part(name, fn):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            parts[name] = round(time.perf_counter() - start, 6)
            return out

        part("params_csv", lambda: load_spatial_params(cfg.params_file))
        scratch = os.path.join(tmp, "parts")
        os.makedirs(scratch)
        ids = sp["stream"]
        part("final_file", lambda: write_final_netcdf(os.path.join(scratch, "f.nc"), y_final, ids))
        part("dense_file", lambda: write_dense_netcdf(os.path.join(scratch, "d.nc"), res.dense,
                                                      np.arange(n_q) * 60.0, ids))
        part("discharge_compute", lambda: routing.routed_discharge(
            res.dense, params, routing.build_topology(sp["stream"], sp["next_stream"])))
        part("state_file", lambda: save_state(os.path.join(scratch, "s.nc"), res.y_final, ids, 0.0))
        phase(f"phase 7 parts: {parts}, native CSV parser {'loaded' if native._LIB else 'not loaded'}")

        # One more run with the legacy CSV outputs.
        doc["output"].update(format="csv", path=os.path.join(tmp, "csv"))
        csv_metrics = Metrics()
        csv_out = run(config_from_dict(doc), metrics=csv_metrics)
        final_csv = np.loadtxt(csv_out["final_path"], delimiter=",", skiprows=1, ndmin=2)
        with open(csv_out["dense_path"]) as f:
            widths = [line.count(",") + 1 for line in f]
        check(widths == [1 + 5 * MAIN_SYSTEMS] * (1 + n_q),
              f"phase 7: dense CSV is not a header and {n_q} rows of 1 + 5 S columns")
        # 6 significant digits: within half a unit of the sixth, 5e-6 relative.
        check(bool(np.allclose(final_csv, y_final, rtol=1e-5, atol=0.0)), "phase 7: final CSV differs")
        phase(f"phase 7 checks: dense, final, state and discharge files equal solve() and "
              f"routed_discharge() bit for bit; csv run phases_s "
              f"{ {k: round(v, 6) for k, v in csv_metrics.phases.items()} }, dense CSV "
              f"{os.path.getsize(csv_out['dense_path'])} bytes | {smi}")
    return launches


WINDOWED_DAYS = 4.0
I16_RANGES = {0: [0.0, 0.1], 1: [0.0, 4.0], 2: [0.0, 0.1], 3: [0.0, 6.0], 4: [0.0, 1.0]}


def _index_add_log(q: torch.Tensor, ptr_tables: torch.Tensor) -> torch.Tensor:
    """The routing accumulation that routing.accumulate_downstream_log
    replaced: one index_add (float atomics on the card) per doubling round.
    Kept here to time against it."""
    x = q
    for row in ptr_tables:
        valid = row >= 0
        tgt = torch.where(valid, row, torch.zeros_like(row))
        x = x.index_add(0, tgt, torch.where(valid[:, None], x, torch.zeros_like(x)))
    return x


def _rss_sampler():
    """stop() -> (before, peak): this process's resident memory in kB
    (VmRSS, and RssAnon where the kernel reports it), sampled every 2 ms
    on a thread."""
    import threading

    done = threading.Event()

    def read():
        with open("/proc/self/status") as f:
            fields = dict(line.split(":", 1) for line in f if ":" in line)
        return {k: int(fields[k].split()[0]) for k in ("VmRSS", "RssAnon") if k in fields}

    peak = read()

    def loop():
        while not done.is_set():
            for k, v in read().items():
                peak[k] = max(peak[k], v)
            done.wait(0.002)

    thread = threading.Thread(target=loop, daemon=True)
    before = read()
    thread.start()

    def stop():
        done.set()
        thread.join()
        return before, peak

    return stop


def windowed_phase(smi: str) -> dict:
    """Phase 8: the windowed CLI run at full width; returns each kernel's
    launches in the timed run."""
    import copy
    import os
    import tempfile

    import numpy as np
    from torch.profiler import record_function

    from tiger_tpu_torch import chunked, routing
    from tiger_tpu_torch.checkpoint import cold_state
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.forcing import ForcingSpec
    from tiger_tpu_torch.io.netcdf import output_format, read_netcdf
    from tiger_tpu_torch.kernels import launch_totals, reset_launch_counts
    from tiger_tpu_torch.models import Model204
    from tiger_tpu_torch.models.model204 import Y0_COMMON
    from tiger_tpu_torch.params import load_spatial_params, model_params
    from tiger_tpu_torch.profiling import Metrics, overlap_share, trace, trace_busy, union_length
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import STIFF_HU, write_basin
    from tiger_tpu_torch.solver import solve

    n_win, n_q = int(WINDOWED_DAYS), int(WINDOWED_DAYS * 24) + 1
    outputs = (("final", "outputs"), ("dense", "outputs"), ("discharge", "discharge"),
               ("state", "outputs"))
    with tempfile.TemporaryDirectory(prefix="tiger_win_") as tmp:
        start = time.perf_counter()
        doc = write_basin(os.path.join(tmp, "basin"), MAIN_SYSTEMS, WINDOWED_DAYS, STIFF_FRAC)
        write_s = time.perf_counter() - start
        doc["output"].update(checkpoint_interval="1d", precision="f32")

        def cfg_at(name, initial=None, chunk_days=1.0, **output):
            d = copy.deepcopy(doc)
            d["time"]["chunk_days"] = chunk_days
            d["output"].update(path=os.path.join(tmp, name), **output)
            if initial:
                d["initial"] = initial
            return config_from_dict(d)

        def files(name):
            return {key: read_netcdf(os.path.join(tmp, name, f"{key}_basin_rank_0.nc"),
                                     (var,))[0][var] for key, var in outputs}

        # (a) the windowed run, warmed up, then timed.
        run(cfg_at("warm"), metrics=Metrics())
        torch.cuda.synchronize()
        metrics = Metrics()
        reset_launch_counts()
        stop = _rss_sampler()
        start = time.perf_counter()
        out = run(cfg_at("a"), metrics=metrics)
        wall = time.perf_counter() - start
        rss_before, rss_peak = stop()
        launches = launch_totals()
        windows = [round(b - a, 6) for k, _, a, b in sorted(metrics.spans, key=lambda x: x[1])
                   if k == "window"]
        device = metrics.span_list("device")
        device_s = [round(b - a, 6) for k, _, a, b in sorted(metrics.spans, key=lambda x: x[1])
                    if k == "device"]
        busy_s = {k: round(union_length(metrics.span_list(k)), 6)
                   for k in ("load", "solve", "sink", "write", "flush")}
        load_ov = overlap_share(metrics.span_list("load"), device)
        write_ov = overlap_share(metrics.span_list("sink", "write"), device)
        phases = {k: round(v, 6) for k, v in metrics.phases.items()}
        block = MAIN_SYSTEMS * 24 * (5 * 4 + 8)  # a window's dense f32 + discharge f64 rows
        whole = MAIN_SYSTEMS * n_q * (5 * 4 + 8)
        phase(f"phase 8a windowed CLI ({MAIN_SYSTEMS} links, {WINDOWED_DAYS:g} days in 1-day "
              f"windows, checkpoints every day, {output_format()} outputs): wall {wall:.6f} s, "
              f"phases_s {phases}, window walls {windows}, window device spans {device_s}, "
              f"seconds spent by kind (union of spans) {busy_s}, "
              f"forcing loads inside device spans {load_ov:.4f}, output writes inside device "
              f"spans {write_ov:.4f}, n_windows {out['n_windows']}, n_stiff {out['n_stiff']}, "
              f"n_failed {out['n_failed']}, launches {launches}; host memory (MiB) before "
              f"{ {k: round(v / 1024, 1) for k, v in rss_before.items()} }, peak "
              f"{ {k: round(v / 1024, 1) for k, v in rss_peak.items()} }, against a window's dense and discharge blocks "
              f"{block / 2**20:.1f} MiB and the whole variables {whole / 2**20:.1f} MiB; basin "
              f"written in {write_s:.3f} s | {smi}")
        check(out["n_failed"] == 0, f"phase 8a: {out['n_failed']} links failed")
        check(out["n_windows"] == n_win, f"phase 8a: {out['n_windows']} windows")
        check(launches["rk45"] == n_win and launches["radau"] > 0,
              f"phase 8a: launches {launches}, want B1 in each of {n_win} windows and B2")

        tdir = os.path.join(tmp, "trace")
        with trace(tdir):
            with record_function("windowed_run"):
                run(cfg_at("traced"), metrics=Metrics())
            torch.cuda.synchronize()
        busy, span = trace_busy(os.path.join(tdir, "trace.json"), "windowed_run")
        phase(f"phase 8a traced run: device busy {busy:.6f} s of {span:.6f} s "
              f"({busy / span:.4f}) | {smi}")

        # (b) the same windows by hand.
        cfg = cfg_at("a")
        sp = load_spatial_params(cfg.params_file)
        params = {k: torch.as_tensor(v, device="cuda").to(torch.float32)
                  for k, v in model_params(sp).items()}
        hu_rows = torch.as_tensor(sp["Hu"] == STIFF_HU, device="cuda")
        specs = [ForcingSpec(os.path.join(cfg.forcings.path, f["file"]), f["var"],
                             float(f["dt_hours"])) for f in cfg.forcings.files]
        loader = chunked.netcdf_window_loader(specs, sp["stream"], cfg.forcings.lookup, "cuda")
        topo = routing.build_topology(sp["stream"], sp["next_stream"])
        y = torch.as_tensor(cold_state(Y0_COMMON, MAIN_SYSTEMS), device="cuda").to(torch.float32)
        dense, discharge, per_window = [], [], []
        for w in range(n_win):
            w0 = 1440.0 * w
            qt = torch.as_tensor(np.arange(0 if w == 0 else 1, 25) * 60.0, device="cuda")
            before = launch_totals()
            res = solve(Model204(), y, 0.0, 1440.0, qt.to(torch.float32), params, loader(w0, w0 + 1440.0),
                        cfg.solver_config(), t_shift=w0)
            y = torch.where(torch.isnan(res.y_final), y, res.y_final)
            dense.append(res.dense.cpu().numpy())
            discharge.append(routing.routed_discharge(res.dense, params, topo).cpu().numpy())
            per_window.append(dict(n_stiff=res.n_stiff, hu_flagged=int(res.stiff[hu_rows].sum()),
                                   failed=int(res.failed.sum()),
                                   b1=launch_totals()["rk45"] - before["rk45"],
                                   b2=launch_totals()["radau"] - before["radau"]))
        got = files("a")
        want = {"dense": np.concatenate(dense, axis=1), "final": y.cpu().numpy(),
                "state": y.cpu().numpy().astype(np.float64),
                "discharge": np.concatenate(discharge, axis=1).astype(np.float64)}
        same = {k: bool(got[k].shape == want[k].shape and np.array_equal(got[k], want[k]))
                for k in want}
        phase(f"phase 8b the windows by hand: per window {per_window}; files equal bit for bit "
              f"{same} | {smi}")
        check(all(same.values()), f"phase 8b: the run's files differ from the windows by hand: {same}")
        check(all(p["failed"] == 0 and p["b1"] == 1 for p in per_window),
              f"phase 8b: a window failed a link or did not launch B1: {per_window}")
        # The Hu = 1e-6 links are stiff while their static store drains from
        # the cold state's 3 m: in the first window.
        check(per_window[0]["hu_flagged"] == int(hu_rows.sum()) and per_window[0]["b2"] == 1,
              f"phase 8b: window 0 flagged {per_window[0]['hu_flagged']} of "
              f"{int(hu_rows.sum())} Hu=1e-6 links")
        check(all((p["b2"] == 1) == (p["n_stiff"] > 0) for p in per_window),
              f"phase 8b: B2 launches do not follow the stiff counts: {per_window}")
        check(sum(p["n_stiff"] for p in per_window) == out["n_stiff"],
              f"phase 8b: stiff counts {per_window} against the run's {out['n_stiff']}")

        # (c) crash in the third window, resume from the t = 2880 checkpoint.
        real_solve, calls = chunked.solve, {"n": 0}

        def dying_solve(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("simulated crash")
            return real_solve(*a, **kw)

        chunked.solve = dying_solve
        try:
            run(cfg_at("c"), metrics=Metrics())
            check(False, "phase 8c: the run did not crash")
        except RuntimeError as err:
            check("simulated crash" in str(err), f"phase 8c: {err}")
        finally:
            chunked.solve = real_solve
        state = os.path.join(tmp, "c", "state_basin_rank_0.nc")
        t_ckpt = read_netcdf(state, ())[1]["sim_time_minutes"]
        resumed = run(cfg_at("c", {"mode": "hot", "file": state, "resume": True}),
                      metrics=Metrics())
        again = files("c")
        same_c = {k: bool(np.array_equal(again[k], got[k])) for k in got}
        phase(f"phase 8c crash in window 3, resumed from t = {t_ckpt:g} ({resumed['n_windows']} "
              f"windows): files equal (a)'s bit for bit {same_c} | {smi}")
        check(float(t_ckpt) == 2880.0, f"phase 8c: checkpoint at t = {t_ckpt}")
        check(all(same_c.values()), f"phase 8c: the resumed files differ from (a)'s: {same_c}")

        # (d) int16 with declared ranges.
        run(cfg_at("d", precision="i16", i16_ranges=I16_RANGES), metrics=Metrics())
        path_d = os.path.join(tmp, "d", "dense_basin_rank_0.nc")
        names = [f"outputs_{v}" for v in I16_RANGES]
        codes, _ = read_netcdf(path_d, names)
        worst = 0.0
        for v, (lo, hi) in I16_RANGES.items():
            scale, offset = (hi - lo) / 65532.0, (hi + lo) / 2.0
            dec = codes[f"outputs_{v}"] * scale + offset
            worst = max(worst, float(np.abs(dec - np.clip(got["dense"][:, :, v], lo, hi)).max()
                                / scale))
        bytes_a = os.path.getsize(os.path.join(tmp, "a", "dense_basin_rank_0.nc"))
        phase(f"phase 8d i16: largest error {worst:.4f} code steps (bound 0.75); dense file "
              f"{os.path.getsize(path_d)} bytes against (a)'s {bytes_a} | {smi}")
        check(worst <= 0.75, f"phase 8d: decoded i16 {worst:.4f} steps from (a)'s values")

        # For information: (a) against one unchunked solve of the 4 days.
        run(cfg_at("whole", chunk_days=0.0, checkpoint_interval=None), metrics=Metrics())
        whole_dense = files("whole")["dense"]
        scale = np.abs(whole_dense).max(axis=(0, 1))  # each state's largest magnitude
        diff = np.abs(got["dense"] - whole_dense) / scale
        edge = np.zeros(n_q, bool)
        edge[24:n_q - 1:24] = True  # the rows at the inner window ends
        rel_inner, rel_edge = float(diff[:, ~edge].max()), float(diff[:, edge].max())

        # The routing against the index_add version, at 131,072 x 97.
        q = routing.link_runoff_204(torch.as_tensor(got["dense"], device="cuda"),
                                    {k: v[:, None] for k, v in params.items()})
        tables = torch.as_tensor(topo.ptr_tables, dtype=torch.int64, device="cuda")
        new, new_ms = timed(lambda: routing.accumulate_downstream_log(q, topo), reps=5)
        new2 = routing.accumulate_downstream_log(q, topo)
        old, old_ms = timed(lambda: _index_add_log(q, tables), reps=5)
        old_rel = float(((old - new).abs() / new.abs().clamp_min(1e-30)).max())
        phase(f"phase 8 for information: windowed against unchunked dense, largest difference "
              f"over the state's largest magnitude {rel_inner:.4e} away from the inner window "
              f"ends, {rel_edge:.4e} at them; routing at {MAIN_SYSTEMS} x {n_q}: fixed "
              f"order {new_ms:.4f} ms, index_add {old_ms:.4f} ms (median of 5), two runs equal "
              f"{bool(torch.equal(new, new2))}, index_add {old_rel:.3e} relative from it | {smi}")
        check(bool(torch.equal(new, new2)), "phase 8: routing differs between two runs")
    return launches


# Phase 9: each kernel's option instances, by the names the wrappers count
# them under (kernels.rk45.INSTANCES, kernels.radau.instance_name).
B1_OPTIONS = {
    "default": {},
    "pi": dict(controller="pi"),
    "fsal": dict(fsal=True),
    "fsal+pi": dict(fsal=True, controller="pi"),
    "compensated": dict(compensated=True),
    "compensated+pi": dict(compensated=True, controller="pi"),
}
B2_OPTIONS = {
    "embedded3": {},
    "embedded3+predictor": dict(radau_predictor=True),
    "reference": dict(radau_error_mode="reference"),
    "reference+predictor": dict(radau_error_mode="reference", radau_predictor=True),
    "radau5": dict(radau_error_mode="radau5"),
    "radau5+predictor": dict(radau_error_mode="radau5", radau_predictor=True),
}
# Instances that fail stiff systems in 9a's span: 'reference' caps h near
# the tolerance until max_steps (in the JAX package too).
B2_MAY_FAIL = ("reference", "reference+predictor")
# 9a's and 10f's checks; cut from 1 day, 10 minutes and 300 steps so that
# phase 12 and phase 6's 2-day plain Radau fit the time limit (PERF.md §4).
OPTION_SYSTEMS, OPTION_DAYS, OPTION_STIFF = 1024, 0.25, 1 / 256
RADAU_CHECK_SPAN = 5.0  # minutes: the plain Radau pays ~45 ms of launches an attempt
REFERENCE_CHECK = dict(rtol=1e-3, atol=1e-6, max_steps=150)
TIGHT = dict(rtol=1e-6, atol=1e-9)  # the reference's tolerances (SolverConfig defaults)
ACCURACY_SYSTEMS = 4096
ACCURACY_SPAN = 1440.0  # minutes; the 2 days until phase 12 needed the time (PERF.md §4)
SLIVER_MIN = 1e-3  # minutes: 4 ulps of float32 time at 2,880 min


@dataclasses.dataclass(frozen=True)
class ModelCase:
    """A model the kernels carry, as the per-instance checks and timings
    (phases 9, 10f, 12 and 13: b1_checks, b2_checks, b1_times, b2_times)
    and the model phases (model_phase) take it.

    ``tag`` and ``label`` name its phase and the model in the lines;
    ``prefix`` is its instances' prefix in the launch counters
    (kernels._common.KERNEL_MODELS), ``rhs_ops`` the operations of its rhs
    (for the bounds; ``rhs_name`` names the constant), ``reads_t`` whether its rhs reads the time (so FSAL's
    k1, taken at t + h, may round apart from the default's at the Kahan t,
    and a shift must move its results, or must not).  The rest serves
    model_phase: ``inputs(s_count, dtype)`` gives (model, y0, params,
    forcings) of the main path's systems, ``queries(span, dtype)`` its
    queries over the first ``span`` of ``tf`` minutes (``span_text`` in the
    lines, ``note`` after the solve lines' tolerances); ``cli`` the CLI config's changes (``cli_text``); ``shift`` and
    ``f64_check`` the (systems, minutes) of phase b's shifted and float64
    checks of B1's default instances; ``b2_dtypes``, ``b2_h0`` (None:
    initial_step's) and ``b2_spans`` phase d's B2 on every system and the
    spans its plain check may take; ``check(dtype, kernel, attempts)``
    phase e's inputs for every instance against its plain version: (model,
    y0, params, forcings, span, queries, base config, what the lines say of
    them), ``attempts`` being B2's per system in phase d (the first dtype's);
    ``skip`` the instances
    phase e leaves to phases b and d; ``golden`` the final state B1's
    default float64 instance must reach in phase e (rtol 5e-6); ``wide``:
    phase e holds every instance to its plain version at the main path's
    shapes too (a model whose main path is minutes, not days)."""

    tag: str
    label: str
    prefix: str
    rhs_ops: int
    rhs_name: str
    reads_t: bool
    inputs: Callable = None
    tf: float = DAYS * 1440.0
    queries: Callable = None
    span_text: str = f"{DAYS:g} days"
    note: str = ""
    cli: dict = None
    cli_text: str = ""
    shift: tuple = (0, 0.0)
    f64_check: tuple = (0, 0.0)
    b2_dtypes: tuple = (torch.float32,)
    b2_h0: float | None = None
    b2_spans: tuple = ()
    check: Callable = None
    skip: tuple = ()
    golden: tuple | None = None
    wide: bool = False

    def name(self, opt: str, dtype) -> str:
        """The instance of option set ``opt`` (B1_OPTIONS, B2_OPTIONS) in ``dtype``."""
        return self.prefix + opt + ("/f64" if dtype == torch.float64 else "")


def b1_checks(case: ModelCase, dtype, cfg_of, inputs: tuple, tag: str, where: str, records: dict,
              names=tuple(B1_OPTIONS), skip=(), shift: float = 0.0, pooled: bool = True) -> dict:
    """Each B1 instance of the option sets ``names`` in ``dtype`` against
    rk45_plain bit for bit on ``inputs`` = (model, y0, params, forcings,
    span, queries, hu_rows), from the initial steps of ``cfg_of('default')``;
    the instances named in ``skip`` run (their results are FSAL's twins)
    but are held elsewhere.  FSAL's results against its twin's: a gate
    where the rhs does not read t, data where it does.  With ``shift``, each instance
    again with that t_shift: equal to the unshifted run (a model that does
    not read t).  ``pooled``: every kernel runs first, then the plain
    versions side by side on the pool (side_by_side); else each plain
    version right after its kernel (dense blocks too large to hold them
    all).  Fills ``records`` by instance name; returns the default and pi
    instances' results by option set."""
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.solver.controller import initial_step

    model, y0, params, forc, span, qt, hu_rows = inputs
    h0 = initial_step(model, y0, 0.0, params, forc, cfg_of("default"))
    real, peak = (8, F64_PEAK) if dtype == torch.float64 else (4, F32_PEAK)
    n_rows = 0 if forc is None else forc.data.shape[0]
    def plain_args(opt):
        return (model, y0, h0, 0.0, span, qt, params, forc, cfg_of(opt))

    def held_to_plain(opt, ker, c_ms, ref, p_ms):
        inst, cfg = case.name(opt, dtype), cfg_of(opt)
        err = check_rk45(f"phase {tag} B1 {inst} vs rk45_plain{where}", ker, ref, hu_rows)
        att = int(ker.stats.n_attempts.sum())
        bnd = bound(b1_ops(att, int((~ker.stiff).sum()) * int((qt > 0.0).sum()),
                           k_rk45.rk45_options(cfg), case.rhs_ops),
                    io_bytes(y0.shape[0], n_rows, qt.numel(), 5, real), peak)
        rec = records.setdefault(inst, {})
        rec.update(check_ms=c_ms, check_plain_ms=p_ms, max_abs_err=err, check_bound_ms=bnd[0],
                   check_systems=y0.shape[0], check_span_min=span, check_attempts=att,
                   library_ms=None, plain_side_by_side=SIDE_BY_SIDE if pooled else 1)
        rec.setdefault("plain_ms", p_ms)  # unless a check at the main path's shapes took it

    results, held = {}, {}
    for opt in names:
        inst, cfg = case.name(opt, dtype), cfg_of(opt)
        ker, c_ms = timed(lambda: k_rk45.rk45(model, y0, h0, 0.0, span, qt, params, forc, cfg), reps=3)
        if opt in ("default", "pi"):  # FSAL's twins; the others' dense blocks would only hold memory
            results[opt] = ker
        if inst in skip:
            continue
        if pooled:
            held[opt] = (ker, c_ms)
        else:
            held_to_plain(opt, ker, c_ms, *timed(lambda: k_rk45.rk45_plain(*plain_args(opt))))
        if shift:
            moved = k_rk45.rk45_mismatch(
                k_rk45.rk45(model, y0, h0, 0.0, span, qt, params, forc, cfg, shift), ker)
            check(not any(moved.values()), f"phase {tag}: t_shift {shift:g} moved B1 {inst}: {moved}")
            records.setdefault(inst, {})["shift_unchanged"] = shift
        if cfg.fsal:
            # FSAL's k1 is k7, evaluated at t + h; the default's k1 at the
            # Kahan-compensated t1 (rk45_pallas.py l.726-777 alike).  Where
            # the rhs does not read t the two instances are equal; where it
            # does the two times may round apart: printed as data (equal in
            # every run so far, PERF.md).
            twin = "pi" if cfg.controller == "pi" else "default"
            if twin not in results:
                results[twin] = k_rk45.rk45(model, y0, h0, 0.0, span, qt, params, forc, cfg_of(twin))
            diff = k_rk45.rk45_mismatch(ker, results[twin])
            records.setdefault(inst, {})["differs_from_" + twin] = diff
            phase(f"phase {tag} B1 {inst} vs the {twin} instance"
                  f"{' (for information)' if case.reads_t else ''}: entries that differ {diff}")
            check(case.reads_t or not any(diff.values()),
                  f"phase {tag}: FSAL {inst} differs from the {twin} instance: {diff}")
    plain = side_by_side({opt: ("tiger_tpu_torch.kernels.rk45:rk45_plain", plain_args(opt), None)
                          for opt in held})
    for opt, (ker, c_ms) in held.items():
        held_to_plain(opt, ker, c_ms, *plain[opt])
    return results


def b2_checks(case: ModelCase, dtype, cfg_of, inputs: tuple, tag: str, where: str, records: dict,
              names=tuple(B2_OPTIONS), skip=(), counted: bool = False, shift: float = 0.0,
              main: bool = False, may_fail=B2_MAY_FAIL) -> None:
    """Each B2 instance of the option sets ``names`` (but the instances
    named in ``skip``) in ``dtype`` against radau_plain bit for bit on
    ``inputs`` = (model, y0, params, forcings, span, queries), each from its
    own initial steps;
    'reference' at REFERENCE_CHECK, which may fail systems (the sets in
    ``may_fail`` may).  ``counted``:
    one launch with the counters set to 0 just before, which must count
    once.  ``shift``: again with that t_shift, equal to the unshifted run.
    ``main``: these are the instance's only times, so they also fill its
    main-path keys where no other phase did.  Every kernel runs first, then
    the plain versions side by side on the pool (side_by_side).  Fills
    ``records``."""
    from tiger_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.solver.controller import initial_step

    model, y0, params, forc, span, qt = inputs
    real, peak = (8, F64_PEAK) if dtype == torch.float64 else (4, F32_PEAK)
    n_rows = 0 if forc is None else forc.data.shape[0]
    n_sys = y0.shape[0]
    held = {}
    for opt in names:
        inst = case.name(opt, dtype)
        if inst in skip:
            continue
        cfg = cfg_of(opt, **(REFERENCE_CHECK if opt.startswith("reference") else {}))
        h0 = initial_step(model, y0, 0.0, params, forc, cfg)
        n_launch = None
        if counted:
            reset_launch_counts()
            k_radau.radau(model, y0, h0, 0.0, span, qt, params, forc, cfg)
            n_launch = launch_counts()["radau"][inst]
            check(n_launch == 1, f"phase {tag}: B2 {inst} was not launched")
        ker, c_ms = timed(lambda: k_radau.radau(model, y0, h0, 0.0, span, qt, params, forc, cfg), reps=3)
        if shift:
            moved = k_radau.radau(model, y0, h0, 0.0, span, qt, params, forc, cfg, shift)
            same = (_bit_equal(moved.y_final, ker.y_final) and _bit_equal(moved.dense, ker.dense)
                    and all(bool(torch.equal(a, b)) for a, b in zip(moved.stats, ker.stats)))
            check(same, f"phase {tag}: t_shift {shift:g} moved B2 {inst}")
            records.setdefault(inst, {})["shift_unchanged"] = shift
        held[opt] = (cfg, h0, ker, c_ms, n_launch)
    plain = side_by_side({opt: ("tiger_tpu_torch.kernels.radau:radau_plain",
                                (model, y0, h0, 0.0, span, qt, params, forc, cfg), None)
                          for opt, (cfg, h0, *_) in held.items()})
    for opt, (cfg, h0, ker, c_ms, n_launch) in held.items():
        inst, rec = case.name(opt, dtype), records.setdefault(case.name(opt, dtype), {})
        ref, p_ms = plain[opt]
        err = check_radau(f"phase {tag} B2 {inst} vs radau_plain{where}", ker, ref,
                          may_fail=opt in may_fail)
        att, swp = int(ker.stats.n_attempts.sum()), int(ker.stats.n_newton.sum())
        bnd = bound(b2_ops(att, swp, n_sys * int((qt > 0.0).sum()), cfg, case.rhs_ops),
                    io_bytes(n_sys, n_rows, qt.numel(), 6, real), peak)
        rec.update(max_abs_err=err, check_plain_ms=p_ms, check_ms=c_ms, check_systems=n_sys,
                   check_span_min=span, check_attempts=att, check_bound_ms=bnd[0], library_ms=None,
                   plain_side_by_side=SIDE_BY_SIDE)
        rec.setdefault("plain_ms", p_ms)  # unless a check at the main path's shapes took it
        if main:
            for key, value in dict(ms=c_ms, launches=n_launch, bound_ms=bnd[0], bound_by=bnd[1],
                                   systems=n_sys,
                                   attempts=att, failed=int(ker.failed.sum()),
                                   worst_system_attempts=int(ker.stats.n_attempts.max())).items():
                rec.setdefault(key, value)


def b1_times(case: ModelCase, dtype, cfg_of, inputs: tuple, records: dict,
             names=tuple(B1_OPTIONS)) -> dict:
    """Each B1 instance's time at the main path's shapes, ``inputs`` =
    (model, y0, params, forcings, tf, queries), from its own initial
    steps, with its bound and launch geometry (launches made to measure,
    after the main path's counts were read).  Fills ``records``; returns
    each instance's stiff flags by option set."""
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.solver.controller import initial_step

    model, y0, params, forc, tf, qt = inputs
    real, peak = (8, F64_PEAK) if dtype == torch.float64 else (4, F32_PEAK)
    n_rows = 0 if forc is None else forc.data.shape[0]
    n_sys, n_q_after = y0.shape[0], int((qt > 0.0).sum())
    results = {}
    for opt in names:
        inst, cfg = case.name(opt, dtype), cfg_of(opt)
        h0 = initial_step(model, y0, 0.0, params, forc, cfg)
        ker, ms = timed(lambda: k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg), reps=3)
        options = k_rk45.rk45_options(cfg)
        att = int(ker.stats.n_attempts.sum())
        bnd = bound(b1_ops(att, int((~ker.stiff).sum()) * n_q_after, options, case.rhs_ops),
                    io_bytes(n_sys, n_rows, qt.numel(), 5, real), peak)
        geo = k_rk45.rk45_geometry(n_sys, options, dtype, model)
        records.setdefault(inst, {}).update(
            ms=ms, bound_ms=bnd[0], bound_by=bnd[1], attempts=att,
            worst_system_attempts=int(ker.stats.n_attempts.max()), pool_bytes=geo["shared_bytes"],
            threads=geo["threads"], geometry=geo, library_ms=None)
        results[opt] = ker.stiff
    return results


def b2_times(case: ModelCase, dtype, cfg_of, inputs: tuple, records: dict,
             names=tuple(B2_OPTIONS)) -> None:
    """Each B2 instance's time on ``inputs`` = (model, y0, params,
    forcings, tf, queries, h0): the systems B1 flagged, from phase 1's
    initial steps, with its bound.  Fills ``records``."""
    from tiger_tpu_torch.kernels import radau as k_radau

    model, y0, params, forc, tf, qt, h0 = inputs
    real, peak = (8, F64_PEAK) if dtype == torch.float64 else (4, F32_PEAK)
    n_rows = 0 if forc is None else forc.data.shape[0]
    n_sys = y0.shape[0]
    n_q_after = int((qt > 0.0).sum())
    for opt in names:
        cfg = cfg_of(opt)
        ker, ms = timed(lambda: k_radau.radau(model, y0, h0, 0.0, tf, qt, params, forc, cfg), reps=3)
        att, swp = int(ker.stats.n_attempts.sum()), int(ker.stats.n_newton.sum())
        worst = max(int(ker.stats.n_attempts.max()), 1)
        bnd = bound(b2_ops(att, swp, n_sys * n_q_after, cfg, case.rhs_ops),
                    io_bytes(n_sys, n_rows, qt.numel(), 6, real), peak)
        records.setdefault(case.name(opt, dtype), {}).update(
            ms=ms, bound_ms=bnd[0], bound_by=bnd[1], attempts=att, worst_system_attempts=worst,
            us_per_attempt=1e3 * ms / worst, sweeps_per_attempt=swp / max(att, 1),
            failed=int(ker.failed.sum()), systems=n_sys, library_ms=None)


#: Model 204 as the option and double phases' checks and timings take it.
M204 = ModelCase(tag="", label="Model 204", prefix="", rhs_ops=RHS_OPS, rhs_name="RHS_OPS",
                 reads_t=False)


def snapped_landings(steps: tuple, meta) -> dict:
    """{system: [(dt, k, sliver), ...]}: the advances of a run (``rk45_plain``'s
    ``steps``, stacked: t, h, advance, t_new [iterations, S]) that ended
    inside a ZOH snap window, more than SLIVER_MIN
    minutes before the boundary k * dt.  From there the gather reads sample
    k (floor(t / dt + ZOH_SNAP)), so the sliver up to the boundary is
    integrated with the next sample's forcing: a run that lands there and
    one that lands on the boundary differ by about the sliver times the
    jump in the slope."""
    from tiger_tpu_torch.forcing import ZOH_SNAP

    _, _, moved, ends = steps
    ends = ends.double()
    out = {}
    for n_t, dt in sorted(set(zip(meta.n_steps, meta.dt_min))):
        x = ends / dt
        k = torch.floor(x + ZOH_SNAP)
        sliver = k * dt - ends
        hit = moved & (k != torch.floor(x)) & (k < n_t) & (sliver > SLIVER_MIN)
        for i, s in torch.nonzero(hit).tolist():
            out.setdefault(s, []).append((dt, int(k[i, s]), round(float(sliver[i, s]), 5)))
    return {s: sorted(v, key=lambda e: e[0] * e[1]) for s, v in out.items()}


def rk45_plain_steps(*args):
    """rk45_plain with its steps recorded: (result, its steps stacked: t,
    h, advance, t_new [iterations, S])."""
    from tiger_tpu_torch.kernels.rk45 import rk45_plain

    steps = []
    res = rk45_plain(*args, steps=steps)
    return res, tuple(torch.stack(x) for x in zip(*steps))


def accuracy(model, y0, params, forc, tf, qt, h0, f32c, hu_rows, also: dict) -> tuple:
    """Phase 9b's accuracy check on y0's systems; returns each run's
    error quantiles, and the results of the pool's jobs ``also``, which
    run side by side with its four plain runs.

    Compensated and plain float32 at the reference's tolerances against
    rk45_plain in float64 on the first systems: each system's largest
    relative error of y_final (states above 1e-3).  Beside them a second
    float64 run whose h0 differs by 2^-20: how far two float64 runs lie
    apart where their steps part.  rk45_plain records each run's steps
    (its float32 runs equal the kernel's bit for bit: checked), so the
    tail's systems are listed with their attempts and the advances that
    ended inside a forcing boundary's snap window.
    """
    from tiger_tpu_torch.forcing import ForcingSet
    from tiger_tpu_torch.kernels import rk45 as k_rk45

    dev = y0.device
    sub = torch.arange(y0.shape[0], device=dev)
    ay0, ap = y0.contiguous(), {k: v[sub].contiguous() for k, v in params.items()}
    af, ah0 = forc.take_systems(sub), h0[sub].contiguous()
    ap64, af64 = {k: v.double() for k, v in ap.items()}, ForcingSet(af.data.double(), af.meta)
    f32 = {"compensated": f32c, "plain": dataclasses.replace(f32c, compensated=False)}
    runs = {label: k_rk45.rk45(model, ay0, ah0, 0.0, tf, qt, ap, af, cfg) for label, cfg in f32.items()}
    jobs = {"float64": ("chip_smoke:rk45_plain_steps", (model, ay0.double(), ah0.double(), 0.0, tf,
                                                       qt.double(), ap64, af64, f32c), None),
            "float64 h0 x (1 + 2^-20)": ("tiger_tpu_torch.kernels.rk45:rk45_plain", (
                model, ay0.double(), ah0.double() * (1.0 + 2.0 ** -20), 0.0, tf, qt.double(), ap64,
                af64, f32c), None),
            **{label: ("chip_smoke:rk45_plain_steps", (model, ay0, ah0, 0.0, tf, qt, ap, af, cfg), None)
               for label, cfg in f32.items()}}
    got = side_by_side({**also, **jobs})  # the longest first
    (r64, steps64), plain64_ms = got["float64"]
    plain64_s = plain64_ms * 1e-3
    stacked = {"float64": steps64}
    runs["float64 h0 x (1 + 2^-20)"] = got["float64 h0 x (1 + 2^-20)"][0]
    for label in f32:
        ref, stacked[label] = got[label][0]
        check_rk45(f"phase 9b accuracy, {label} f32: B1 vs rk45_plain ({ay0.shape[0]} systems)",
                   runs[label], ref, hu_rows[sub])
    landed = {k: snapped_landings(v, af.meta) for k, v in stacked.items()}
    per, rel = {}, {}
    for label, r in runs.items():
        b = r64.y_final
        e = torch.where(b.abs() > 1e-3, (r.y_final.double() - b).abs() / b.abs(), torch.zeros_like(b))
        per[label] = torch.where(r.stiff | r64.stiff, float("nan"), e.amax(dim=1))
        ok = per[label][~torch.isnan(per[label])]
        q = torch.quantile(ok, torch.tensor([0.5, 0.9, 0.99], dtype=ok.dtype, device=dev))
        rel[label] = dict(zip(("median", "p90", "p99"), q.tolist()), max=float(ok.max()))
    attempts = {"float64": r64.stats.n_attempts, **{k: runs[k].stats.n_attempts for k in landed if k in runs}}
    def hourly(r, i):  # system i's largest relative error of each dense row
        b = r64.dense[i]
        return torch.where(b.abs() > 1e-3, (r.dense[i].double() - b).abs() / b.abs(),
                           torch.zeros_like(b)).amax(dim=1)

    def advances(run, i, lo, hi):  # (t, h) of run's last 4 advances that start in [lo, hi)
        t, h, adv, _ = (x[:, i] for x in stacked[run])
        keep = adv & (t >= lo) & (t < hi)
        return [(round(a, 5), round(b, 4)) for a, b in zip(t[keep].tolist(), h[keep].tolist())][-4:]

    tail = []
    for i in torch.topk(torch.nan_to_num(per["compensated"]), 5).indices.tolist():
        err = hourly(runs["compensated"], i)
        w = int(err.argmax())
        lo, hi = float(qt[max(w - 1, 0)]), float(qt[w])
        tail.append(dict(
            system=i, **{k: f"{float(v[i]):.3e}" for k, v in per.items()},
            attempts={k: int(v[i]) for k, v in attempts.items()},
            snapped={k: v.get(i, []) for k, v in landed.items()},
            worst_row=dict(t=hi, compensated=f"{float(err[w]):.3e}",
                           plain=f"{float(hourly(runs['plain'], i)[w]):.3e}"),
            advances_before_it={k: advances(k, i, lo, hi) for k in stacked}))
    phase(f"phase 9b accuracy at rtol 1e-6 / atol 1e-9 ({ay0.shape[0]} systems, {tf / 1440.0:g} days; "
          f"rk45_plain float64 on the card {plain64_s:.1f} s, side by side): each system's largest relative error "
          f"of y_final (states above 1e-3) against float64: {rel}; systems with a snapped advance "
          f"(more than {SLIVER_MIN:g} min before the boundary) {({k: len(v) for k, v in landed.items()})}; "
          f"compensated's 5 largest (error, attempts, snapped advances as (dt, k, sliver min), the "
          f"dense row where compensated lies furthest from float64 and each run's last 4 advances "
          f"(t, h) in the hour before it): {tail}")
    check(rel["compensated"]["median"] < rel["plain"]["median"],
          f"phase 9b: compensated f32 is not closer to float64 in the median system: {rel}")
    return rel, {k: got[k] for k in also}


def options_phase(smi: str) -> dict:
    """Phase 9: the solver options; returns each kernel's instance records."""
    import os
    import tempfile

    import numpy as np

    from tiger_tpu_torch import Model204, SolverConfig, routing, solve
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.kernels import launch_counts, launch_totals, reset_launch_counts
    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.profiling import Metrics
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import STIFF_HU, scenario, solve_written_basin
    from tiger_tpu_torch.solver.controller import initial_step

    phase_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    model = Model204()
    base = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    b1 = {name: {} for name in B1_OPTIONS}
    b2 = {name: {} for name in B2_OPTIONS}

    def b1_cfg(name, **extra):
        return dataclasses.replace(base, **B1_OPTIONS[name], **extra)

    def b2_cfg(name, **extra):
        return dataclasses.replace(base, **B2_OPTIONS[name], **extra)

    # (a) every instance against its plain version.
    tf = OPTION_DAYS * 1440.0
    y0, params, forc = scenario(OPTION_SYSTEMS, OPTION_DAYS, OPTION_STIFF, device=dev)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=torch.float32, device=dev)
    hu_rows = params["Hu"] < STIFF_HU * 10
    results = b1_checks(M204, torch.float32, b1_cfg, (model, y0, params, forc, tf, qt, hu_rows), "9a",
                        f" ({OPTION_SYSTEMS} systems, {OPTION_DAYS:g} day)", b1)
    rows = torch.nonzero(results["default"].stiff).squeeze(1)
    check(rows.numel() > 0, "phase 9a flagged no system")
    sy0, sp = y0[rows].contiguous(), {k: v[rows].contiguous() for k, v in params.items()}
    sf = forc.take_systems(rows)
    qt_r = torch.arange(0.0, RADAU_CHECK_SPAN + 1e-9, 5.0, dtype=torch.float32, device=dev)
    b2_checks(M204, torch.float32, b2_cfg, (model, sy0, sp, sf, RADAU_CHECK_SPAN, qt_r), "9a",
              f" ({rows.numel()} systems, first {RADAU_CHECK_SPAN:g} min)", b2)
    del results

    # (b) the slice's path at full width, and (c) the CLI with f32c; the
    # launch counters are set to 0 just before and read just after.
    tf = DAYS * 1440.0
    y0, params, forc = scenario(MAIN_SYSTEMS, DAYS, STIFF_FRAC, device=dev)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=torch.float32, device=dev)
    hu_rows = params["Hu"] < STIFF_HU * 10
    f32c = b1_cfg("compensated", **TIGHT)
    torch.cuda.synchronize()
    reset_launch_counts()

    def main_runs(cfg, label):
        res = solve(model, y0, 0.0, tf, qt, params, forc, cfg)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for i in range(1, 4):
            start = time.perf_counter()
            res = solve(model, y0 + i * 1e-7, 0.0, tf, qt, params, forc, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
        rk_att = int(res.rk_stats.n_attempts.sum())
        rd_att = 0 if res.radau_stats is None else int(res.radau_stats.n_attempts.sum())
        n_failed = int(res.failed.sum())
        phase(f"phase 9b {label} ({MAIN_SYSTEMS} systems, {DAYS:g} days, {qt.numel()} queries, "
              f"rtol {cfg.rtol:g} / atol {cfg.atol:g}): wall median {sorted(walls)[1]:.6f} s "
              f"(min {min(walls):.6f}, max {max(walls):.6f}), rk attempts {rk_att}, rejected "
              f"{int(res.rk_stats.n_rejected.sum())}, radau attempts {rd_att}, n_stiff "
              f"{res.n_stiff}, n_failed {n_failed} | {smi}")
        check(n_failed == 0, f"phase 9b {label}: {n_failed} systems failed")
        check(bool(res.stiff[hu_rows].all()), f"phase 9b {label}: a Hu=1e-6 row was not flagged stiff")
        check(bool(torch.isfinite(res.y_final).all()), f"phase 9b {label}: non-finite y_final")
        return res, walls

    res_c, walls_c = main_runs(f32c, "solve() compensated f32 (f32c)")
    res_p, walls_p = main_runs(b1_cfg("pi"), "solve() PI controller")
    res_i = solve(model, y0, 0.0, tf, qt, params, forc, base)
    torch.cuda.synchronize()
    rej_i, rej_p = int(res_i.rk_stats.n_rejected.sum()), int(res_p.rk_stats.n_rejected.sum())
    phase(f"phase 9b rejected attempts: PI {rej_p} against the I controller's {rej_i}; "
          f"attempts {int(res_p.rk_stats.n_attempts.sum())} against {int(res_i.rk_stats.n_attempts.sum())}")
    others = {}
    for name in ("fsal", "fsal+pi", "compensated+pi"):
        r = solve(model, y0, 0.0, tf, qt, params, forc, b1_cfg(name))
        others[f"B1 {name}"] = (r.n_stiff, int(r.failed.sum()))
    for name in B2_OPTIONS:
        if name != "embedded3":
            cfg = b2_cfg(name)
            r = solve(model, y0, 0.0, tf, qt, params, forc, cfg)
            # The float32 rung alone: B2 on the rows solve() flagged, from
            # the same initial steps (solve() then retries its failures).
            rows = torch.nonzero(r.stiff).squeeze(1)
            h0 = initial_step(model, y0, 0.0, params, forc, cfg)
            rd = k_radau.radau(model, y0[rows], h0[rows], 0.0, tf, qt,
                               {k: v[rows] for k, v in params.items()}, forc.take_systems(rows), cfg)
            others[f"B2 {name}"] = (r.n_stiff, int(rd.failed.sum()), int(r.failed.sum()))
            b2[name].update(main_path_failed_f32=others[f"B2 {name}"][1],
                            main_path_failed=others[f"B2 {name}"][2])
    torch.cuda.synchronize()
    phase(f"phase 9b one solve() with each other instance, (n_stiff, n_failed) for B1's, "
          f"(n_stiff, n_failed by the float32 Radau, n_failed after the float64 retry) for B2's: "
          f"{others}")
    # B2's option instances may fail stiff systems over the 2 days: they
    # are the Radau error estimates and Newton starts as the JAX package
    # runs them in float32 (9a holds each to its plain version); B1's may not.
    check(all(v[1] == 0 for key, v in others.items() if key.startswith("B1")),
          f"phase 9b: a B1 instance failed systems: {others}")

    with tempfile.TemporaryDirectory(prefix="tiger_f32c_") as tmp:
        doc = basin_doc(os.path.join(tmp, "out"))
        doc["solver"].update(precision="f32c", tolerances=dict(TIGHT))
        cfg = config_from_dict(doc)
        check(cfg.solver_config().compensated and cfg.solver_config().rtol == TIGHT["rtol"],
              "phase 9c: the config is not f32c at rtol 1e-6")
        run(cfg, metrics=Metrics())  # warm-up
        metrics = Metrics()
        start = time.perf_counter()
        out = run(cfg, metrics=metrics)
        wall = time.perf_counter() - start
        launches, total = launch_counts(), launch_totals()
        res, cli_params, sp = solve_written_basin(cfg, "cuda")
        dense = read_netcdf(os.path.join(cfg.output.path, "dense_basin_rank_0.nc"),
                            ("outputs",))[0]["outputs"]
        q = read_netcdf(os.path.join(cfg.output.path, "discharge_basin_rank_0.nc"),
                        ("discharge",))[0]["discharge"]
        topo = routing.build_topology(sp["stream"], sp["next_stream"])
        direct = routing.routed_discharge(res.dense, cli_params, topo).cpu().numpy()
        same_dense = bool(np.array_equal(dense, res.dense.cpu().numpy()))
        same_q = bool(np.array_equal(q, direct.astype(np.float64)))
        phase(f"phase 9c CLI f32c ({MAIN_SYSTEMS} links, {DAYS:g} days, rtol 1e-6 / atol 1e-9): "
              f"wall {wall:.6f} s, phases_s { {k: round(v, 6) for k, v in metrics.phases.items()} }, "
              f"n_stiff {out['n_stiff']}, n_failed {out['n_failed']}; dense file equals solve() "
              f"{same_dense}, discharge equals routed_discharge() {same_q} | {smi}")
        check(out["n_failed"] == 0, f"phase 9c: {out['n_failed']} links failed")
        check(same_dense and same_q, "phase 9c: the f32c run's files differ from the direct path")
    phase(f"phase 9b-c launches by instance (the main path's): {launches}, in all {total}")
    # Model 204's float instances (phases 10 and 12 the rest, phase 15 those
    # with the TPU kernels' last options)
    for kernel, counts in launches.items():
        check(all(n > 0 for name, n in counts.items()
                  if "/" not in name and "+reuse" not in name and "+runtime" not in name),
              f"phase 9: a {kernel} instance was not launched: {counts}")
    for name in B1_OPTIONS:
        b1[name]["launches"] = launches["rk45"][name]
    for name in B2_OPTIONS:
        b2[name]["launches"] = launches["radau"][name]

    # Each instance's time at the main path's shapes (launches made to
    # measure, after the counts were read).
    h0 = initial_step(model, y0, 0.0, params, forc, base)
    rows = torch.nonzero(b1_times(M204, torch.float32, b1_cfg, (model, y0, params, forc, tf, qt),
                                  b1)["default"]).squeeze(1)
    # The slice's own instance and tolerances: B1 compensated at rtol 1e-6 /
    # atol 1e-9 on the 131,072 systems, and B2 on the systems it flagged,
    # each against its plain version with phases 3-4's exact check.
    h0_t = initial_step(model, y0, 0.0, params, forc, f32c)
    ker_c, ms_c = timed(lambda: k_rk45.rk45(model, y0, h0_t, 0.0, tf, qt, params, forc, f32c), reps=3)
    # Its plain version runs with the accuracy check's, side by side.
    rows_c = torch.nonzero(ker_c.stiff).squeeze(1)
    cy0, cp = y0[rows_c].contiguous(), {k: v[rows_c].contiguous() for k, v in params.items()}
    cf, ch0 = forc.take_systems(rows_c), h0_t[rows_c].contiguous()
    rker_c, ms_c2 = timed(lambda: k_radau.radau(model, cy0, ch0, 0.0, tf, qt, cp, cf, f32c), reps=3)
    # Its check against radau_plain runs at the end (plain_span_checks).
    b2["embedded3"].update(f32c_ms=ms_c2)
    check_c = radau_span_check(
        f"phase 9b B2 embedded3 vs radau_plain at rtol 1e-6 / atol 1e-9 ({rows_c.numel()} systems",
        int(rker_c.stats.n_attempts.max()), model, cy0, ch0, cp, cf, qt, f32c, b2["embedded3"],
        prefix="f32c_")
    sy0, sp = y0[rows].contiguous(), {k: v[rows].contiguous() for k, v in params.items()}
    sf, sh0 = forc.take_systems(rows), h0[rows].contiguous()
    b2_times(M204, torch.float32, b2_cfg, (model, sy0, sp, sf, tf, qt, sh0), b2)
    phase(f"phase 9b instance times at the main path's shapes ({MAIN_SYSTEMS} systems for B1, "
          f"its {rows.numel()} stiff ones for B2, {DAYS:g} days, rtol 1e-5 / atol 1e-8; f32c_* at "
          f"rtol 1e-6 / atol 1e-9, B2 on its {rows_c.numel()} stiff systems): B1 {b1} | B2 {b2} | {smi}")

    _, also = accuracy(model, y0[:ACCURACY_SYSTEMS], params, forc, ACCURACY_SPAN,
                       qt[qt <= ACCURACY_SPAN + 1e-9], h0_t, f32c, hu_rows,
                       {"f32c": ("tiger_tpu_torch.kernels.rk45:rk45_plain",
                                 (model, y0, h0_t, 0.0, tf, qt, params, forc, f32c), None)})
    ref_c, plain_c = also["f32c"]
    b1["compensated"].update(f32c_ms=ms_c, f32c_plain_ms=plain_c, f32c_plain_side_by_side=SIDE_BY_SIDE,
                             f32c_max_abs_err=check_rk45(
        f"phase 9b B1 compensated vs rk45_plain at rtol 1e-6 / atol 1e-9 ({MAIN_SYSTEMS} systems, "
        f"{DAYS:g} days)", ker_c, ref_c, hu_rows))
    del ker_c, ref_c
    phase(f"phase 9 took {time.perf_counter() - phase_start:.1f} s")
    return {"rk45": b1, "radau": b2, "walls": {"f32c": walls_c, "pi": walls_p}}, check_c


# The whole script's aim, in seconds from its start: the plain Radau checks
# of phases 9b, 10b, 11 and 12d run over the longest of F64_SPANS
# (minutes) that keeps it inside (plain_span_checks).
F64_BUDGET_S = 1050.0
F64_SPANS = (2880.0, 1440.0, 720.0, 360.0, 180.0, 90.0, 45.0)
F64_MARGIN = 1.15  # on the predicted seconds of a plain Radau span
# ms an attempt of the worst system that radau_plain takes, for the span's
# prediction: 31.5-37.5 ms measured over the 2 days, 17-44 ms over the first
# 45 min to 6 hours (PERF.md §6).
PLAIN_RADAU_MS = 40.0
# The pool's processes (PlainPool): how many run at once, how much longer a
# plain Radau attempt takes there than alone (measured 1.15-1.23 with 4, 1.6-
# 1.7 with 7; PERF.md §6), and the seconds plain_span_checks allows for
# handing its jobs over (the processes reached the card at the start).
SIDE_BY_SIDE, SIDE_BY_SIDE_SLOWER, PROCESS_START_S = 4, 1.25, 3.0


@dataclasses.dataclass
class SpanCheck:
    """One of plain_span_checks' checks.  ``run(span)`` gives (result, ms)
    over the first ``span`` minutes through the kernels, ``plain(span)``
    the job of its plain versions over the same span ("module:function",
    args[, the kernel whose radau_diff against it the process returns];
    side_by_side runs it); ``compare(span, ker, ref)`` holds the two
    results and gives their max_abs_err; the numbers go into ``record``,
    each name after ``prefix``; ``worst`` is the worst system's attempts by
    span (each of ``spans``: F64_SPANS for a check of the shared span, or
    the whole span of a check that always runs all of it)."""

    run: Callable
    plain: Callable
    compare: Callable
    record: dict
    worst: dict
    prefix: str = ""
    spans: tuple = F64_SPANS  # the spans it may take: the shared ones, or one of its own


def radau_span_check(label: str, total: int, model, y0, h0, params, forc, qt, cfg, record: dict,
                     spans: tuple = F64_SPANS, prefix: str = "", may_fail: bool = False,
                     diff_in_worker: bool = False) -> SpanCheck:
    """The SpanCheck of B2 against radau_plain on these systems; ``total``
    is the worst system's attempts over the full span (None: over the
    longest of ``spans``), ``label`` the
    lines' start.  Runs the kernel over each of ``spans`` for the worst
    system's attempts.  ``may_fail`` as check_radau's.  ``diff_in_worker``:
    the plain version's process also runs B2 and returns only their
    radau_diff (for results of gigabytes, such as a dense block at full
    width)."""
    from tiger_tpu_torch.kernels import radau as k_radau

    def run(span):
        sq = qt[qt <= span + 1e-9]
        return timed(lambda: k_radau.radau(model, y0, h0, 0.0, span, sq, params, forc, cfg))

    def plain(span):
        return ("tiger_tpu_torch.kernels.radau:radau_plain",
                (model, y0, h0, 0.0, span, qt[qt <= span + 1e-9], params, forc, cfg),
                "tiger_tpu_torch.kernels.radau:radau" if diff_in_worker else None)

    def compare(span, ker, ref) -> float:
        return check_radau(f"{label}, first {span:g} min, worst system "
                           f"{int(ker.stats.n_attempts.max())} of its {total} attempts)", ker, ref,
                           may_fail, ref if diff_in_worker else None)

    worst = {x: int(run(x)[0].stats.n_attempts.max()) for x in spans}
    total = worst[max(spans)] if total is None else total
    return SpanCheck(run=run, plain=plain, compare=compare, record=record, prefix=prefix, spans=spans,
                     worst=worst)


def _read_files(folder: str, names, ranks: int = 1) -> dict:
    """{name: values} of a run's files; with ``ranks``, each rank's files
    concatenated in rank order."""
    import os

    import numpy as np

    from tiger_tpu_torch.io.netcdf import read_netcdf

    return {key: np.concatenate([read_netcdf(os.path.join(folder, f"{key}_basin_rank_{r}.nc"),
                                             (var,))[0][var] for r in range(ranks)])
            for key, var in names}


def float64_phase(smi: str) -> tuple:
    """Phase 10: the default set's double instances; returns their instance
    records and what 10b's plain Radau check needs (plain_span_checks)."""
    import copy
    import os
    import tempfile

    import numpy as np

    from tiger_tpu_torch import Model204, SolverConfig, chunked, routing, solve
    from tiger_tpu_torch.checkpoint import cold_state
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.forcing import ForcingSpec
    from tiger_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.models.model204 import Y0_COMMON
    from tiger_tpu_torch.params import load_spatial_params, model_params
    from tiger_tpu_torch.profiling import Metrics
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import STIFF_HU, scenario, solve_written_basin
    from tiger_tpu_torch.solver.controller import initial_step

    phase_start = time.perf_counter()
    f64 = torch.float64
    dev = torch.device("cuda", 0)
    model, cfg = Model204(), SolverConfig()  # the reference's rtol 1e-6 / atol 1e-9
    check(cfg.rtol == 1e-6 and cfg.atol == 1e-9, "phase 10: SolverConfig() is not at 1e-6 / 1e-9")
    tf = DAYS * 1440.0
    y0, params, forc = scenario(MAIN_SYSTEMS, DAYS, STIFF_FRAC, device=dev, dtype=f64)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=f64, device=dev)
    hu_rows = params["Hu"] < STIFF_HU * 10
    b1, b2 = {}, {}
    outputs = (("final", "outputs"), ("dense", "outputs"), ("discharge", "discharge"),
               ("state", "outputs"))

    # (c) the slice's path at full width; the counters are set to 0 just
    # before (c) and read just after (e).
    torch.cuda.synchronize()
    reset_launch_counts()
    res = solve(model, y0, 0.0, tf, qt, params, forc, cfg)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for i in range(1, 4):
        start = time.perf_counter()
        res = solve(model, y0 + i * 1e-7, 0.0, tf, qt, params, forc, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    wall = sorted(walls)[1]
    rk_att = int(res.rk_stats.n_attempts.sum())
    rd_att = 0 if res.radau_stats is None else int(res.radau_stats.n_attempts.sum())
    n_failed = int(res.failed.sum())
    phase(f"phase 10c solve() float64 ({MAIN_SYSTEMS} systems, {DAYS:g} days, {qt.numel()} "
          f"queries, rtol 1e-6 / atol 1e-9): {(rk_att + rd_att) / wall:.6e} system-steps/s, wall "
          f"median {wall:.6f} s (min {min(walls):.6f}, max {max(walls):.6f}), n_stiff "
          f"{res.n_stiff}, rk attempts {rk_att}, radau attempts {rd_att}, n_failed {n_failed}, "
          f"launches {launch_counts()} | {smi}")
    check(res.y_final.dtype == f64 and res.dense.dtype == f64, "phase 10c: the result is not float64")
    check(n_failed == 0, f"phase 10c: {n_failed} systems failed")
    check(bool(res.stiff[hu_rows].all()), "phase 10c: a Hu=1e-6 row was not flagged stiff")
    check(bool(torch.isfinite(res.y_final).all()), "phase 10c: non-finite y_final")

    with tempfile.TemporaryDirectory(prefix="tiger_f64_") as tmp:
        # (d) the CLI: a config that sets neither solver.precision nor the
        # tolerances runs f64 at rtol 1e-6 / atol 1e-9.
        doc = basin_doc(os.path.join(tmp, "cli"))
        doc["solver"] = {"method": "RK45"}
        cli_cfg = config_from_dict(doc)
        check(cli_cfg.solver.precision == "f64" and cli_cfg.solver_config() == cfg,
              "phase 10d: the config without solver.precision is not f64 at the defaults")
        run(cli_cfg, metrics=Metrics())  # warm-up
        metrics = Metrics()
        start = time.perf_counter()
        out = run(cli_cfg, metrics=metrics)
        cli_wall = time.perf_counter() - start
        direct, cli_params, sp = solve_written_basin(cli_cfg, "cuda")
        topo = routing.build_topology(sp["stream"], sp["next_stream"])
        y_direct = direct.y_final.cpu().numpy()
        want = {"dense": direct.dense.cpu().numpy(), "final": y_direct, "state": y_direct,
                "discharge": routing.routed_discharge(direct.dense, cli_params, topo).cpu().numpy()}
        got = _read_files(cli_cfg.output.path, outputs)
        same_d = {k: bool(got[k].dtype == np.float64 and np.array_equal(got[k], want[k])) for k in want}
        phase(f"phase 10d CLI without solver.precision ({MAIN_SYSTEMS} links, {DAYS:g} days, f64 "
              f"at rtol 1e-6 / atol 1e-9): wall {cli_wall:.6f} s, phases_s "
              f"{ {k: round(v, 6) for k, v in metrics.phases.items()} }, n_stiff {out['n_stiff']}, "
              f"n_failed {out['n_failed']}; float64 files equal solve() and routed_discharge() "
              f"bit for bit {same_d} | {smi}")
        check(out["n_failed"] == 0, f"phase 10d: {out['n_failed']} links failed")
        check(all(same_d.values()), f"phase 10d: the run's files differ from the direct path: {same_d}")

        # (e) the same basin in 2 one-day windows with a daily checkpoint,
        # and the windows by hand.
        win = copy.deepcopy(doc)
        win["time"]["chunk_days"] = 1.0
        win["output"].update(path=os.path.join(tmp, "win"), checkpoint_interval="1d")
        win_cfg = config_from_dict(win)
        start = time.perf_counter()
        win_out = run(win_cfg, metrics=Metrics())
        win_wall = time.perf_counter() - start
        p64 = {k: torch.as_tensor(v, device="cuda").to(f64) for k, v in model_params(sp).items()}
        specs = [ForcingSpec(os.path.join(win_cfg.forcings.path, f["file"]), f["var"],
                             float(f["dt_hours"])) for f in win_cfg.forcings.files]
        loader = chunked.netcdf_window_loader(specs, sp["stream"], win_cfg.forcings.lookup, "cuda")
        y = torch.as_tensor(cold_state(Y0_COMMON, MAIN_SYSTEMS), device="cuda").to(f64)
        dense, discharge = [], []
        for w in range(int(DAYS)):
            w0 = 1440.0 * w
            wq = torch.as_tensor(np.arange(0 if w == 0 else 1, 25) * 60.0, device="cuda").to(f64)
            r = solve(model, y, 0.0, 1440.0, wq, p64, loader(w0, w0 + 1440.0), cfg, t_shift=w0)
            y = torch.where(torch.isnan(r.y_final), y, r.y_final)
            dense.append(r.dense.cpu().numpy())
            discharge.append(routing.routed_discharge(r.dense, p64, topo).cpu().numpy())
        want = {"dense": np.concatenate(dense, axis=1), "final": y.cpu().numpy(),
                "state": y.cpu().numpy(), "discharge": np.concatenate(discharge, axis=1)}
        got = _read_files(win_cfg.output.path, outputs)
        same_e = {k: bool(got[k].dtype == np.float64 and got[k].shape == want[k].shape
                          and np.array_equal(got[k], want[k])) for k in want}
        phase(f"phase 10e windowed f64 ({MAIN_SYSTEMS} links, {int(DAYS)} one-day windows, a "
              f"daily checkpoint): wall {win_wall:.6f} s, n_windows {win_out['n_windows']}, n_stiff "
              f"{win_out['n_stiff']}, n_failed {win_out['n_failed']}; float64 files equal the "
              f"windows by hand bit for bit {same_e} | {smi}")
        check(win_out["n_failed"] == 0 and win_out["n_windows"] == int(DAYS),
              f"phase 10e: {win_out['n_failed']} failed, {win_out['n_windows']} windows")
        check(all(same_e.values()), f"phase 10e: the windowed files differ from the windows by hand: {same_e}")

    launches = launch_counts()
    b1["launches"], b2["launches"] = launches["rk45"]["default/f64"], launches["radau"]["embedded3/f64"]
    phase(f"phase 10c-e launches by instance: {launches}")
    check(b1["launches"] > 0 and b2["launches"] > 0,
          f"phase 10: a double instance was not launched: {launches}")

    # (a) B1's double instance against rk45_plain in float64 at full width
    # (launches made to check and to time, after the counts were read).
    h0 = initial_step(model, y0, 0.0, params, forc, cfg)
    ker, ms = timed(lambda: k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg), reps=3)
    ref, plain_ms = timed(lambda: k_rk45.rk45_plain(model, y0, h0, 0.0, tf, qt, params, forc, cfg))
    err = check_rk45(f"phase 10a B1 default/f64 vs rk45_plain float64 ({MAIN_SYSTEMS} systems, "
                     f"{DAYS:g} days, rtol 1e-6 / atol 1e-9)", ker, ref, hu_rows)
    n_rows, n_q, n_q_after = forc.data.shape[0], qt.numel(), int((qt > 0.0).sum())
    att = int(ker.stats.n_attempts.sum())
    bnd = bound(b1_ops(att, int((~ker.stiff).sum()) * n_q_after),
                io_bytes(MAIN_SYSTEMS, n_rows, n_q, 5, real=8), F64_PEAK)
    geo = k_rk45.rk45_geometry(MAIN_SYSTEMS, 0, f64)
    b1.update(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bnd[0], bound_by=bnd[1],
              attempts=att, worst_system_attempts=int(ker.stats.n_attempts.max()),
              pool_bytes=geo["shared_bytes"], threads=geo["threads"], library_ms=None)

    # (b) B2's double instance on every system (a) flagged: its time over
    # the 2 days and its worst system's attempts over each leading span;
    # the plain Radau runs at the end (plain_span_checks).
    rows = torch.nonzero(ker.stiff).squeeze(1)
    sy0, sp_ = y0[rows].contiguous(), {k: v[rows].contiguous() for k, v in params.items()}
    sf, sh0 = forc.take_systems(rows), h0[rows].contiguous()
    rker, r_ms = timed(lambda: k_radau.radau(model, sy0, sh0, 0.0, tf, qt, sp_, sf, cfg), reps=3)
    r_att, r_swp = int(rker.stats.n_attempts.sum()), int(rker.stats.n_newton.sum())
    r_bnd = bound(b2_ops(r_att, r_swp, rows.numel() * n_q_after),
                  io_bytes(rows.numel(), n_rows, n_q, 6, real=8), F64_PEAK)
    r_worst = int(rker.stats.n_attempts.max())
    check_b = radau_span_check(
        f"phase 10b B2 embedded3/f64 vs radau_plain float64 ({rows.numel()} systems", r_worst, model,
        sy0, sh0, sp_, sf, qt, cfg, b2)
    worst = check_b.worst
    b2.update(ms=r_ms, bound_ms=r_bnd[0], bound_by=r_bnd[1], attempts=r_att,
              worst_system_attempts=r_worst, sweeps_per_attempt=r_swp / r_att, systems=rows.numel(),
              worst_by_span=worst, us_per_attempt=1e3 * r_ms / r_worst, library_ms=None)
    phase(f"phase 10 kernel times (float64, rtol 1e-6 / atol 1e-9): B1 default/f64 {ms:.3f} ms vs "
          f"rk45_plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {F64_PEAK / 1e12:g} "
          f"TFLOP/s), {att} attempts, worst system {b1['worst_system_attempts']}, geometry {geo}; "
          f"B2 embedded3/f64 {r_ms:.3f} ms on {rows.numel()} systems over {DAYS:g} days, bound "
          f"{r_bnd[0]:.4f} ms ({r_bnd[1]}), {r_att} attempts, worst system {r_worst} "
          f"({1e3 * r_ms / r_worst:.3f} us an attempt), {r_swp / r_att:.4f} sweeps an attempt, "
          f"worst system's attempts by leading span (min) {worst} | {smi}")
    phase(f"phase 10 took {time.perf_counter() - phase_start:.1f} s (the plain Radau check at the end)")
    return {"rk45": b1, "radau": b2}, check_b


def doubles_phase(smi: str) -> dict:
    """Phase 10f: the double instances of the other option sets; returns
    their records by instance name.

    (main path) solve() in float64 at full width with each option set
    (phase 9's tolerances), the launch counters set to 0 just before and
    read just after; each instance's time at the main path's shapes; then
    each against its float64 plain version bit for bit at phase 9a's
    shapes and rules (B1 1,024 systems over 6 hours, FSAL also against its
    twin; B2 on the systems the default B1 flags there over the first 5
    minutes, 'reference' at max_steps 150 and rtol 1e-3)."""
    from tiger_tpu_torch import Model204, SolverConfig, solve
    from tiger_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.scenario import STIFF_HU, scenario
    from tiger_tpu_torch.solver.controller import initial_step

    phase_start = time.perf_counter()
    f64, dev, model = torch.float64, torch.device("cuda", 0), Model204()
    base = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    b1_names = [n for n in B1_OPTIONS if n != "default"]
    b2_names = [n for n in B2_OPTIONS if n != "embedded3"]
    recs = {f"{n}/f64": {"library_ms": None} for n in b1_names + b2_names}

    def cfg_of(name, **extra):
        return dataclasses.replace(base, **{**B1_OPTIONS, **B2_OPTIONS}[name], **extra)

    # The main path, at full width.
    tf = DAYS * 1440.0
    y0, params, forc = scenario(MAIN_SYSTEMS, DAYS, STIFF_FRAC, device=dev, dtype=f64)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=f64, device=dev)
    hu_rows = params["Hu"] < STIFF_HU * 10
    torch.cuda.synchronize()
    reset_launch_counts()
    runs = {}
    for name in b1_names + b2_names:
        r = solve(model, y0, 0.0, tf, qt, params, forc, cfg_of(name))
        runs[name] = (r.n_stiff, int(r.failed.sum()))
        recs[f"{name}/f64"]["main_path_failed"] = runs[name][1]
        if name in b1_names:
            check(runs[name][1] == 0 and bool(torch.isfinite(r.y_final).all()),
                  f"phase 10f: solve() float64 {name} failed {runs[name][1]} systems")
        check(bool(r.stiff[hu_rows].all()), f"phase 10f {name}: a Hu=1e-6 row was not flagged stiff")
    torch.cuda.synchronize()
    launches = launch_counts()
    counts = {**launches["rk45"], **launches["radau"]}
    for inst in recs:
        recs[inst]["launches"] = counts[inst]
    phase(f"phase 10f solve() float64 with each other option set ({MAIN_SYSTEMS} systems, {DAYS:g} "
          f"days, rtol 1e-5 / atol 1e-8; B2's report as data), (n_stiff, n_failed): {runs}; "
          f"launches {launches} | {smi}")
    check(all(recs[i]["launches"] > 0 for i in recs), f"phase 10f: a double instance was not launched: {counts}")

    # Each instance's time at the main path's shapes (launches made to measure).
    h0 = initial_step(model, y0, 0.0, params, forc, base)
    b1_times(M204, f64, cfg_of, (model, y0, params, forc, tf, qt), recs, b1_names)
    rows = torch.nonzero(k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, base).stiff).squeeze(1)
    sy0, sp = y0[rows].contiguous(), {k: v[rows].contiguous() for k, v in params.items()}
    sf, sh0 = forc.take_systems(rows), h0[rows].contiguous()
    b2_times(M204, f64, cfg_of, (model, sy0, sp, sf, tf, qt, sh0), recs, b2_names)
    del y0, params, forc, qt, h0, sy0, sp, sf, sh0

    # Each against its float64 plain version at phase 9a's shapes.
    tf = OPTION_DAYS * 1440.0
    y0, params, forc = scenario(OPTION_SYSTEMS, OPTION_DAYS, OPTION_STIFF, device=dev, dtype=f64)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=f64, device=dev)
    hu_rows = params["Hu"] < STIFF_HU * 10
    results = b1_checks(M204, f64, cfg_of, (model, y0, params, forc, tf, qt, hu_rows), "10f",
                        f" float64 ({OPTION_SYSTEMS} systems, {OPTION_DAYS:g} day)", recs,
                        names=("default", *b1_names), skip=("default/f64",))
    rows = torch.nonzero(results["default"].stiff).squeeze(1)
    check(rows.numel() > 0, "phase 10f flagged no system")
    sy0, sp = y0[rows].contiguous(), {k: v[rows].contiguous() for k, v in params.items()}
    sf = forc.take_systems(rows)
    qt_r = torch.arange(0.0, RADAU_CHECK_SPAN + 1e-9, 5.0, dtype=f64, device=dev)
    b2_checks(M204, f64, cfg_of, (model, sy0, sp, sf, RADAU_CHECK_SPAN, qt_r), "10f",
              f" float64 ({rows.numel()} systems, first {RADAU_CHECK_SPAN:g} min)", recs, names=b2_names)
    phase(f"phase 10f the double instances (main path: {MAIN_SYSTEMS} systems for B1, the default "
          f"B1's stiff ones for B2, {DAYS:g} days, rtol 1e-5 / atol 1e-8: ms, bound_ms; against the "
          f"plain versions: B1 {OPTION_SYSTEMS} systems over {OPTION_DAYS:g} day, B2 {rows.numel()} "
          f"systems over {RADAU_CHECK_SPAN:g} min: check_ms, plain_ms, check_bound_ms): {recs} | {smi}")
    phase(f"phase 10f took {time.perf_counter() - phase_start:.1f} s")
    return recs


def cli_pi_phase(smi: str) -> dict:
    """Phase 10g: the CLI at full width with solver.controller pi and no
    solver.precision (so f64); returns its launches by instance."""
    import os
    import tempfile

    import numpy as np

    from tiger_tpu_torch import routing
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tiger_tpu_torch.profiling import Metrics
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import solve_written_basin

    outputs = (("final", "outputs"), ("dense", "outputs"), ("discharge", "discharge"),
               ("state", "outputs"))
    with tempfile.TemporaryDirectory(prefix="tiger_f64_pi_") as tmp:
        doc = basin_doc(os.path.join(tmp, "out"))
        doc["solver"] = {"method": "RK45", "controller": "pi"}
        cfg = config_from_dict(doc)
        check(cfg.solver.precision == "f64" and cfg.solver_config().controller == "pi",
              "phase 10g: the config is not f64 with the PI controller")
        torch.cuda.synchronize()
        reset_launch_counts()
        run(cfg, metrics=Metrics())  # warm-up
        metrics = Metrics()
        start = time.perf_counter()
        out = run(cfg, metrics=metrics)
        wall = time.perf_counter() - start
        launches = launch_counts()
        direct, cli_params, sp = solve_written_basin(cfg, "cuda")
        topo = routing.build_topology(sp["stream"], sp["next_stream"])
        y_direct = direct.y_final.cpu().numpy()
        want = {"dense": direct.dense.cpu().numpy(), "final": y_direct, "state": y_direct,
                "discharge": routing.routed_discharge(direct.dense, cli_params, topo).cpu().numpy()}
        got = _read_files(cfg.output.path, outputs)
        same = {k: bool(got[k].dtype == np.float64 and np.array_equal(got[k], want[k])) for k in want}
    phase(f"phase 10g CLI with solver.controller pi and no solver.precision ({MAIN_SYSTEMS} links, "
          f"{DAYS:g} days, f64 at rtol 1e-6 / atol 1e-9): wall {wall:.6f} s, phases_s "
          f"{ {k: round(v, 6) for k, v in metrics.phases.items()} }, n_stiff {out['n_stiff']}, "
          f"n_failed {out['n_failed']}, launches {launches}; float64 files equal solve() and "
          f"routed_discharge() bit for bit {same} | {smi}")
    check(out["n_failed"] == 0, f"phase 10g: {out['n_failed']} links failed")
    check(launches["rk45"]["pi/f64"] > 0 and launches["radau"]["embedded3/f64"] > 0,
          f"phase 10g: the PI double instance was not launched: {launches}")
    check(all(same.values()), f"phase 10g: the run's files differ from the direct path: {same}")
    return launches


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN equal to a NaN in the same place."""
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def retry_chain(rk45_fn, radau_fn, model, y0, h0, params, forc, tf, qt64, cfg, lost):
    """solve()'s float64 retry of the rows ``lost`` written out by hand:
    ``rk45_fn`` on them widened to float64, then ``radau_fn`` on the rows
    it flags stiff; as retry_failed_f64's Retry."""
    from tiger_tpu_torch.solver.api import Retry

    y, h = y0[lost].double(), h0[lost].double()
    p, f = {k: v[lost].double() for k, v in params.items()}, forc.take_systems(lost)
    rk = rk45_fn(model, y, h, 0.0, tf, qt64, p, f, cfg)
    done, st = torch.nonzero(~rk.stiff).squeeze(1), torch.nonzero(rk.stiff).squeeze(1)
    if not st.numel():
        return Retry(lost[done], rk.y_final[done], rk.dense[done], rk.failed[done], None, None)
    rd = radau_fn(model, y[st], h[st], 0.0, tf, qt64, {k: v[st] for k, v in p.items()},
                  f.take_systems(st), cfg)
    return Retry(torch.cat([lost[done], lost[st]]), torch.cat([rk.y_final[done], rd.y_final]),
                 torch.cat([rk.dense[done], rd.dense]), torch.cat([rk.failed[done], rd.failed]),
                 lost[st], rd.stats)


def retry_span_check(name: str, model, cfg, lost, y0, h0, params, forc, qt64, record) -> SpanCheck:
    """Phase 11's check 2 for the B2 option set ``name``: solve()'s retry of
    the rows ``lost`` (retry_failed_f64, through the kernels) against the
    same chain through rk45_plain and radau_plain in float64."""
    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.solver import api

    def run(span):
        sq = qt64[qt64 <= span + 1e-9]
        return timed(lambda: api.retry_failed_f64(model, y0, h0, 0.0, span, sq, params, forc, cfg,
                                                  0.0, lost))

    def plain(span):
        return ("chip_smoke:retry_chain", (k_rk45.rk45_plain, k_radau.radau_plain, model, y0, h0,
                                           params, forc, span, qt64[qt64 <= span + 1e-9], cfg, lost),
                None)

    def compare(span, ker, ref) -> float:
        label = f"phase 11 check 2: the retry of {name} vs the plain chain float64, first {span:g} min"
        check(ker.radau_rows is not None and ref.radau_rows is not None, f"{label}: no row reached B2")
        same = {"rows": bool(torch.equal(ker.rows, ref.rows)),
                "radau_rows": bool(torch.equal(ker.radau_rows, ref.radau_rows)),
                "y_final": _bit_equal(ker.y_final, ref.y_final), "dense": _bit_equal(ker.dense, ref.dense),
                "failed": bool(torch.equal(ker.failed, ref.failed)),
                "radau_stats": all(bool(torch.equal(a, b)) for a, b in zip(ker.radau_stats, ref.radau_stats))}
        err = max(max_abs(torch.nan_to_num(ker.y_final), torch.nan_to_num(ref.y_final)),
                  max_abs(torch.nan_to_num(ker.dense), torch.nan_to_num(ref.dense)))
        phase(f"{label}: {ker.rows.numel()} rows, {ker.radau_rows.numel()} through B2, failed "
              f"{int(ker.failed.sum())}, worst system {int(ker.radau_stats.n_attempts.max())} attempts, "
              f"max_abs_err {err:.3e}, equal {same}")
        check(all(same.values()) and err == 0.0, f"{label}: differs: {same}")
        return err

    def worst(span) -> int:
        out = run(span)[0]
        return 0 if out.radau_stats is None else int(out.radau_stats.n_attempts.max())

    return SpanCheck(run=run, plain=plain, compare=compare, record=record,
                     worst={x: worst(x) for x in F64_SPANS})


# Phase 11's check 2 holds these B2 option sets' retries to the plain
# versions: the two whose float32 Radau fails systems that the retry
# then solves (56 and 131 of the 131 stiff ones, PERF.md §6).
CHECK_2_SETS = ("radau5", "radau5+predictor")
WALL_PAIRS = 7  # phase 11's timed solve()s with and without the retry, taken in turn


def retry_phase(smi: str, failing: list) -> tuple:
    """Phase 11: solve()'s float64 retry of the systems B2 fails, at full
    width, for each B2 option set in ``failing``; returns its records and
    check 2's SpanChecks by option set (run at the end, plain_span_checks)."""
    from tiger_tpu_torch import Model204, SolverConfig, solve
    from tiger_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.scenario import scenario
    from tiger_tpu_torch.solver import api
    from tiger_tpu_torch.solver.controller import initial_step

    phase_start = time.perf_counter()
    dev, model, f64 = torch.device("cuda", 0), Model204(), torch.float64
    base = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    tf = DAYS * 1440.0
    y0, params, forc = scenario(MAIN_SYSTEMS, DAYS, STIFF_FRAC, device=dev)
    qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=torch.float32, device=dev)
    qt64 = qt.double()
    records, checks_2 = {}, {}

    def walls(cfg) -> tuple:
        """WALL_PAIRS timed solve()s with the retry and as many without
        (retries_in_f64 patched to say no), taken in turn."""
        real, out = api.retries_in_f64, ([], [])
        try:
            for i in range(1, 2 * WALL_PAIRS + 1):
                api.retries_in_f64 = real if i % 2 else (lambda y: False)
                torch.cuda.synchronize()
                start = time.perf_counter()
                solve(model, y0 + i * 1e-7, 0.0, tf, qt, params, forc, cfg)
                torch.cuda.synchronize()
                out[i % 2 == 0].append(time.perf_counter() - start)
            return out
        finally:
            api.retries_in_f64 = real

    for name in failing:
        cfg = dataclasses.replace(base, **B2_OPTIONS[name])
        torch.cuda.synchronize()
        reset_launch_counts()
        res = solve(model, y0, 0.0, tf, qt, params, forc, cfg)
        torch.cuda.synchronize()
        launches = {k: {i: n for i, n in c.items() if n} for k, c in launch_counts().items()}

        # Check 1: the chain by hand through the kernels.
        h0 = initial_step(model, y0, 0.0, params, forc, cfg)
        rk = k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg)
        rows = torch.nonzero(rk.stiff).squeeze(1)
        rd = k_radau.radau(model, y0[rows], h0[rows], 0.0, tf, qt,
                           {k: v[rows] for k, v in params.items()}, forc.take_systems(rows), cfg)
        lost = rows[rd.failed]
        rt = retry_chain(k_rk45.rk45, k_radau.radau, model, y0, h0, params, forc, tf, qt64, cfg, lost)
        n_still = 0 if rt.radau_rows is None else rt.radau_rows.numel()
        n_done = rt.rows.numel() - n_still
        want_y, want_d, want_f = rk.y_final.clone(), rk.dense.clone(), rk.failed.clone()
        ok = ~rd.failed
        want_y[rows[ok]], want_d[rows[ok]] = rd.y_final[ok], rd.dense[ok]
        want_f[rows] = rd.failed
        want_y[rt.rows], want_d[rt.rows], want_f[rt.rows] = rt.y_final.float(), rt.dense.float(), rt.failed
        same = {"y_final": _bit_equal(res.y_final, want_y), "dense": _bit_equal(res.dense, want_d),
                "failed": bool(torch.equal(res.failed, want_f)),
                "stiff": bool(torch.equal(res.stiff, rk.stiff))}
        # Check 3: a system the retry leaves failed is one B2's double
        # instance fails on its own.
        left = set(torch.nonzero(res.failed).squeeze(1).tolist())
        b2_lost = set(rt.rows[n_done:][rt.failed[n_done:]].tolist())

        solve(model, y0, 0.0, tf, qt, params, forc, cfg)  # warm-up of the walls
        w_retry, w_plain = walls(cfg)
        rec = dict(n_stiff=res.n_stiff, failed_f32=lost.numel(), resolved_by_b1_f64=n_done,
                   taken_by_b2_f64=n_still, n_failed=len(left), failed_by_b2_f64=len(b2_lost),
                   launches=launches, wall_runs=WALL_PAIRS, wall_s=statistics.median(w_retry),
                   wall_min_max_s=(min(w_retry), max(w_retry)),
                   wall_without_retry_s=statistics.median(w_plain),
                   wall_without_retry_min_max_s=(min(w_plain), max(w_plain)),
                   walls_separate=min(w_retry) > max(w_plain))
        records[name] = rec
        phase(f"phase 11 solve() float32 {name} with the float64 retry ({MAIN_SYSTEMS} systems, "
              f"{DAYS:g} days, {qt.numel()} queries, rtol 1e-5 / atol 1e-8): {rec}; equal bit for "
              f"bit to the chain by hand through the kernels {same} | {smi}")
        check(all(same.values()), f"phase 11 {name}: solve() differs from the chain by hand: {same}")
        check(left == b2_lost, f"phase 11 {name}: failed after the retry {sorted(left)} but B2's "
                               f"double instance fails {sorted(b2_lost)}")
        check(lost.numel() > 0, f"phase 11 {name}: the float32 Radau failed no system")
        check(launches["rk45"].get("default/f64", 0) == 1
              and launches["radau"].get(k_radau.instance_name(cfg, f64), 0) == (1 if n_still else 0),
              f"phase 11 {name}: launches {launches}")
        if name in CHECK_2_SETS:
            checks_2[name] = retry_span_check(name, model, cfg, lost, y0, h0, params, forc, qt64, rec)
    del y0, params, forc
    phase(f"phase 11 took {time.perf_counter() - phase_start:.1f} s (check 2's plain runs at the end)")
    return records, checks_2


# Phases 12 and 13: the models beyond Model 204 (model_phase).
SHIFT = 1440.0  # the t_shift of phase b's shifted check and of phase e's (a day)
B2_TOP, B2_OTHERS = 32, 96  # phase d: the systems its plain check runs
# Phase 12: Model 200 (Hamon PET and the ET ramp) in both kernels.
M200_DOY0 = 182.0  # early July: the ET term is active
M200_LAT = (25.0, 50.0)  # degrees, one a system from a seeded rng
# 12b: t_shift on the first systems over the first minutes, and the float64
# check's systems and minutes (rk45_plain pays its launches an iteration, so
# the span sets its time); cut from 2 days, and 12e's from 3 hours and 20
# minutes, to give phase 6's plain Radau its 2 days back (PERF.md §4).
M200_SHIFT_CHECK = (4096, 720.0)
M200_F64_CHECK = (4096, 720.0)
M200_B1_CHECK = (256, 60.0)  # 12e: B1's other instances, systems and minutes
M200_B2_CHECK = (4, 5.0)  # 12e: B2's other instances
M200_B2_H0 = 1e-3  # 12d: bench.py --solver radau's h0
# Model200::rhs against Model204::rhs: its ET term (the day of year 2, Hamon
# 44 with its six libm calls, the ramp 10) for the stub's 3.
RHS_OPS_M200 = RHS_OPS - 3 + 2 + 44 + 10
LIBM_N = 1 << 24  # 12a: inputs a function
# 12a: half of each function's inputs are uniform over +-this (the domain
# its calls in Model200::rhs reach: exp's argument within +-1 for the
# basin's temperatures, tan's 0.0086 (doy - 186) within +-1.6, atan's
# 0.967 tan(.) unbounded, |cos| and |sin| arguments within pi, asin's within
# 0.4, acos's beyond 1 at the poles), a quarter over ten times as wide, a
# quarter random bit patterns; and the edge values.
LIBM_DOMAINS = {"exp": 5.0, "sin": 3.2, "cos": 3.2, "tan": 1.6, "atan": 60.0, "asin": 1.0,
                "acos": 1.5}


def m200_inputs(s_count: int, dtype=torch.float32):
    """Model 200 on scenario()'s basin: (model, y0, params, forcings), the
    latitude one a system, uniform over M200_LAT from a seeded rng."""
    import numpy as np

    from tiger_tpu_torch.models import Model200
    from tiger_tpu_torch.scenario import scenario

    dev = torch.device("cuda", 0)
    y0, params, forc = scenario(s_count, DAYS, STIFF_FRAC, device=dev, dtype=dtype)
    lat = np.random.default_rng(200).uniform(*M200_LAT, s_count)
    params["lat"] = torch.as_tensor(lat, device=dev).to(dtype)
    return Model200(doy0=M200_DOY0), y0, params, forc


def libm_inputs(name: str, dtype, gen: torch.Generator) -> torch.Tensor:
    """LIBM_N inputs of function ``name`` (LIBM_DOMAINS) and its edge values:
    0, -0, +-1 and 8 ulps on either side of each, +-inf, NaN."""
    dev = torch.device("cuda", 0)
    half, q = LIBM_DOMAINS[name], LIBM_N // 4

    def uniform(n, width):
        return (torch.rand(n, generator=gen, dtype=dtype, device=dev) * 2.0 - 1.0) * width

    if dtype == torch.float64:
        bits = torch.randint(-2**63, 2**63 - 1, (q,), generator=gen, dtype=torch.int64, device=dev)
    else:
        bits = torch.randint(-2**31, 2**31 - 1, (q,), generator=gen, dtype=torch.int64,
                             device=dev).to(torch.int32)
    edges = [0.0, -0.0, float("inf"), float("-inf"), float("nan")]
    one = torch.ones((), dtype=dtype)
    for sign in (1.0, -1.0):
        x = sign * one
        for toward in (2.0, 0.0):
            y = x
            for _ in range(8):
                y = torch.nextafter(y, sign * toward * one)
                edges.append(float(y))
        edges.append(float(x))
    return torch.cat([uniform(2 * q, half), uniform(q, 10.0 * half), bits.view(dtype),
                      torch.tensor(edges, dtype=dtype, device=dev)])


def libm_phase(smi: str) -> dict:
    """Phase 12a: each of Model 200's libm calls, float and double, as the
    instances call it, against torch's CUDA function on the same tensor,
    element by element."""
    from tiger_tpu_torch.kernels import libm

    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for dtype in (torch.float32, torch.float64):
        for name in libm.FUNCTIONS:
            x = libm_inputs(name, dtype, gen)
            key = name + ("/f64" if dtype == torch.float64 else "")
            out[key] = libm.mismatch(libm.libm_eval(name, x), getattr(torch, name)(x))
    torch.cuda.synchronize()
    phase(f"phase 12a libm against torch's CUDA functions, elements that differ bit for bit "
          f"({x.numel()} inputs each: LIBM_N and the edge values): {out} | {smi}")
    check(not any(out.values()), f"phase 12a: a libm call of the Model 200 instances differs from torch's: {out}")
    return out


def model_phase(case: ModelCase, smi: str) -> tuple:
    """Phases 12 and 13: a model beyond Model 204 in both kernels, every
    instance, float and double.  Returns the kernels' instance records, the
    solve() walls, and the plain Radau checks of (d) (plain_span_checks).

    (c) the slice's path at full width: solve() in float32 at rtol 1e-5 /
    atol 1e-8, then float64 at SolverConfig()'s defaults, each with the
    counters set to 0 just before and read just after, one warm-up and 3
    timed runs (stiff count as data, 0 failed), one solve() with each other
    option set's B1 instance, and every B1 instance's own time.  (f) the
    CLI at full width with the model's config, its files equal a direct
    solve() bit for bit; then 2 one-day windows (t_shift 1440 in the
    second) equal to the windows by hand.  (b) B1's default instance
    against rk45_plain at full width, again with t_shift 1440 on the first
    systems (a model that reads t must move, one that does not must not,
    in the kernel and in rk45_plain), and the default float64 instance at
    rtol 1e-6 / atol 1e-9.  (d) B2's default instance on every system, one
    warm-up and 3 timed, 0 failed; its check against radau_plain on the 32
    systems with the most attempts and 96 others joins plain_span_checks.
    (e) every instance against its plain version at the model's check
    shapes, each B2 instance once with the counters set to 0 just before;
    FSAL against the default as data (a gate where the rhs does not read t),
    a model that does not read t again with t_shift 1440 (unchanged), and
    the golden final state where the model has one; where ``case.wide``,
    every instance again at the main path's shapes (B2's in
    plain_span_checks)."""
    import copy
    import os
    import tempfile

    import numpy as np

    from tiger_tpu_torch import SolverConfig, chunked, routing, solve
    from tiger_tpu_torch.checkpoint import cold_state
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.forcing import ForcingSpec
    from tiger_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.models import get_model
    from tiger_tpu_torch.params import model_params
    from tiger_tpu_torch.profiling import Metrics
    from tiger_tpu_torch.run import COLD_STATE_DEFAULTS, run
    from tiger_tpu_torch.scenario import solve_written_basin
    from tiger_tpu_torch.solver.controller import initial_step

    T, P = case.tag, case.prefix
    phase_start = time.perf_counter()
    f64 = torch.float64
    base = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    b1, b2 = {}, {}
    tf = case.tf

    def subset(rows, y0, params, forc):
        return (y0[rows].contiguous(),
                None if params is None else {k: v[rows].contiguous() for k, v in params.items()},
                None if forc is None else forc.take_systems(rows))

    # (c) the slice's path at full width: solve() in float32, then in
    # float64 at SolverConfig()'s defaults, each with the counters set to 0
    # just before and read just after.
    walls = {}
    for label, dtype, cfg in (("f32", torch.float32, base), ("f64", f64, SolverConfig())):
        model, y0, params, forc = case.inputs(MAIN_SYSTEMS, dtype)
        qt = case.queries(tf, dtype)
        torch.cuda.synchronize()
        reset_launch_counts()
        res = solve(model, y0, 0.0, tf, qt, params, forc, cfg)  # warm-up
        torch.cuda.synchronize()
        times = []
        for i in range(1, 4):
            start = time.perf_counter()
            res = solve(model, y0 + i * 1e-7, 0.0, tf, qt, params, forc, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        launches = launch_counts()
        wall = sorted(times)[1]
        rk_att = int(res.rk_stats.n_attempts.sum())
        rd_att = 0 if res.radau_stats is None else int(res.radau_stats.n_attempts.sum())
        n_failed = int(res.failed.sum())
        walls[label] = dict(wall_s=wall, walls_s=times, system_steps_per_s=(rk_att + rd_att) / wall,
                            n_stiff=res.n_stiff, n_failed=n_failed, rk_attempts=rk_att,
                            radau_attempts=rd_att)
        phase(f"phase {T}c solve() {case.label} {label} ({MAIN_SYSTEMS} systems, {case.span_text}, "
              f"{qt.numel()} queries, rtol {cfg.rtol:g} / atol {cfg.atol:g}{case.note}): "
              f"{(rk_att + rd_att) / wall:.6e} system-steps/s, wall median {wall:.6f} s (min "
              f"{min(times):.6f}, max {max(times):.6f}), n_stiff {res.n_stiff}, rk attempts "
              f"{rk_att}, radau attempts {rd_att}, n_failed {n_failed}, launches "
              f"{ {k: {i: n for i, n in v.items() if n} for k, v in launches.items()} } | {smi}")
        name = case.name("default", dtype)
        check(launches["rk45"][name] > 0, f"phase {T}c {label}: B1 {name} was not launched: {launches}")
        check(sum(launches["rk45"].values()) == launches["rk45"][name],
              f"phase {T}c {label}: an instance of another model or set ran: {launches}")
        check(n_failed == 0, f"phase {T}c {label}: {n_failed} systems failed")
        check(bool(torch.isfinite(res.y_final).all()), f"phase {T}c {label}: non-finite y_final")
        check(tuple(res.dense.shape) == (MAIN_SYSTEMS, qt.numel(), 5),
              f"phase {T}c {label}: dense shape {tuple(res.dense.shape)}")
        b1.setdefault(name, {})["launches"] = launches["rk45"][name]
        stiff_rows = torch.nonzero(res.stiff).squeeze(1)
        if dtype == f64:  # float32's flags no system, so its B2 runs in (d)
            b2.setdefault(P + "embedded3/f64", {})["launches"] = launches["radau"][P + "embedded3/f64"]
        # Each other option set's B1 instance: one solve() at full width with
        # the counters set to 0 just before; and every instance's own time.
        for opt, changes in B1_OPTIONS.items():
            if opt == "default":
                continue
            name = case.name(opt, dtype)
            reset_launch_counts()
            o_res = solve(model, y0, 0.0, tf, qt, params, forc, dataclasses.replace(cfg, **changes))
            o_launches = launch_counts()["rk45"]
            o_failed = int(o_res.failed.sum())
            check(o_launches[name] > 0 and o_failed == 0,
                  f"phase {T}c {name}: launches {o_launches}, {o_failed} failed")
            b1.setdefault(name, {}).update(launches=o_launches[name], n_stiff=o_res.n_stiff,
                                           n_failed=o_failed)
        del res, o_res
        b1_times(case, dtype, lambda opt: dataclasses.replace(cfg, **B1_OPTIONS[opt]),
                 (model, y0, params, forc, tf, qt), b1)
        if dtype == f64 and stiff_rows.numel():
            # B2's double instance on the systems the solve flagged, its time.
            h0 = initial_step(model, y0, 0.0, params, forc, cfg)
            b2_times(case, dtype, lambda opt: cfg, (model, *subset(stiff_rows, y0, params, forc), tf,
                                                   qt, h0[stiff_rows].contiguous()), b2,
                     names=("embedded3",))
        phase(f"phase {T}c each B1 instance's time ({label}, {MAIN_SYSTEMS} systems), n_stiff and "
              f"attempts of its solve(): { {k: (v.get('ms'), v.get('n_stiff'), v.get('attempts')) for k, v in b1.items() if 'ms' in v and k.endswith('/f64') == (dtype == f64)} }"
              f"{'; B2 ' + P + 'embedded3/f64 on the stiff systems ' + str(b2.get(P + 'embedded3/f64')) if dtype == f64 else ''} | {smi}")
        del model, y0, params, forc, qt

    # (f) the CLI at full width, then 2 one-day windows: t_shift = 1440
    # reaches both kernels through run().  Their own launch counts.
    outputs = (("final", "outputs"), ("dense", "outputs"), ("discharge", "discharge"),
               ("state", "outputs"))
    with tempfile.TemporaryDirectory(prefix=f"tiger_{T}_") as tmp:
        doc = basin_doc(os.path.join(tmp, "cli"))
        doc.update(copy.deepcopy(case.cli))
        cli_cfg = config_from_dict(doc)
        uid = cli_cfg.model.uid
        reset_launch_counts()
        start = time.perf_counter()
        out = run(cli_cfg, metrics=Metrics())
        cli_wall = time.perf_counter() - start
        cli_launches = launch_counts()
        direct, cli_params, sp = solve_written_basin(cli_cfg, "cuda")
        check(direct.y_final.dtype == torch.float32, f"phase {T}f: the config is not float32")
        topo = routing.build_topology(sp["stream"], sp["next_stream"])
        y_direct = direct.y_final.cpu().numpy()
        want = {"dense": direct.dense.cpu().numpy(), "final": y_direct, "state": y_direct,
                "discharge": routing.routed_discharge(direct.dense, cli_params, topo).cpu().numpy()}
        got = _read_files(cli_cfg.output.path, outputs)
        same_f = {k: bool(np.array_equal(got[k], want[k])) for k in want}
        phase(f"phase {T}f CLI model.uid {uid} ({MAIN_SYSTEMS} links, {DAYS:g} days{case.cli_text}, "
              f"f32): wall {cli_wall:.6f} s (no warm-up), n_stiff "
              f"{out['n_stiff']}, n_failed {out['n_failed']}, launches "
              f"{ {k: {i: n for i, n in v.items() if n} for k, v in cli_launches.items()} }; files "
              f"equal solve() and routed_discharge() bit for bit {same_f} | {smi}")
        check(out["n_failed"] == 0, f"phase {T}f: {out['n_failed']} links failed")
        check(cli_launches["rk45"][P + "default"] > 0, f"phase {T}f: B1 {P}default did not run: {cli_launches}")
        check(all(same_f.values()), f"phase {T}f: the run's files differ from the direct path: {same_f}")

        win = copy.deepcopy(doc)
        win["time"]["chunk_days"] = 1.0
        win["output"].update(path=os.path.join(tmp, "win"), checkpoint_interval="1d")
        win_cfg = config_from_dict(win)
        reset_launch_counts()
        start = time.perf_counter()
        win_out = run(win_cfg, metrics=Metrics())
        win_wall = time.perf_counter() - start
        win_launches = launch_counts()
        model = get_model(uid, doy0=float(win_cfg.time.start.timetuple().tm_yday))
        p32 = {k: torch.as_tensor(v, device="cuda").to(torch.float32) for k, v in model_params(sp).items()}
        specs = [ForcingSpec(os.path.join(win_cfg.forcings.path, f["file"]), f["var"],
                             float(f["dt_hours"])) for f in win_cfg.forcings.files]
        loader = chunked.netcdf_window_loader(specs, sp["stream"], win_cfg.forcings.lookup, "cuda")
        cold = COLD_STATE_DEFAULTS.get(uid, (0.0,) * model.N_EQ)  # run()'s cold start
        y = torch.as_tensor(cold_state(cold, MAIN_SYSTEMS), device="cuda").to(torch.float32)
        dense, discharge, shifts = [], [], []
        for w in range(int(DAYS)):
            w0 = 1440.0 * w
            wq = torch.as_tensor(np.arange(0 if w == 0 else 1, 25) * 60.0, device="cuda").to(torch.float32)
            r = solve(model, y, 0.0, 1440.0, wq, p32, loader(w0, w0 + 1440.0),
                      win_cfg.solver_config(), t_shift=w0)
            y = torch.where(torch.isnan(r.y_final), y, r.y_final)
            dense.append(r.dense.cpu().numpy())
            discharge.append(routing.routed_discharge(r.dense, p32, topo).cpu().numpy())
            shifts.append(w0)
        want = {"dense": np.concatenate(dense, axis=1), "final": y.cpu().numpy(),
                "state": y.cpu().numpy(), "discharge": np.concatenate(discharge, axis=1)}
        got = _read_files(win_cfg.output.path, outputs)
        same_w = {k: bool(got[k].shape == want[k].shape and np.array_equal(got[k], want[k]))
                  for k in want}
        phase(f"phase {T}f windowed model.uid {uid} ({MAIN_SYSTEMS} links, {int(DAYS)} one-day "
              f"windows, t_shift {shifts}, a daily checkpoint): wall {win_wall:.6f} s, n_windows "
              f"{win_out['n_windows']}, n_failed {win_out['n_failed']}, launches "
              f"{ {k: {i: n for i, n in v.items() if n} for k, v in win_launches.items()} }; files "
              f"equal the windows by hand bit for bit {same_w} | {smi}")
        check(win_out["n_failed"] == 0 and win_out["n_windows"] == int(DAYS),
              f"phase {T}f: {win_out['n_failed']} failed, {win_out['n_windows']} windows")
        check(all(same_w.values()), f"phase {T}f: the windowed files differ from the windows by hand: {same_w}")
        del direct, dense, discharge, want, got
    b1[P + "default"]["cli_launches"] = cli_launches["rk45"][P + "default"]
    b1[P + "default"]["windowed_launches"] = win_launches["rk45"][P + "default"]

    # (b) B1's default instance against rk45_plain at full width, then with
    # t_shift = 1440 on the first systems, then the default float64 instance
    # at rtol 1e-6 / atol 1e-9 (launches made to check and to time): every
    # kernel first, then the plain versions side by side on the pool.
    model, y0, params, forc = case.inputs(MAIN_SYSTEMS, torch.float32)
    qt = case.queries(tf, torch.float32)
    h0 = initial_step(model, y0, 0.0, params, forc, base)
    none = torch.zeros(MAIN_SYSTEMS, dtype=torch.bool, device="cuda")
    ker, ms = timed(lambda: k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, base), reps=3)
    n_shift, span_shift = case.shift
    rows = torch.arange(n_shift, device="cuda")
    sy0, sp_, sf = subset(rows, y0, params, forc)
    sq = case.queries(span_shift, torch.float32)
    sh0 = initial_step(model, sy0, 0.0, sp_, sf, base, SHIFT)
    ker_s, ms_s = timed(lambda: k_rk45.rk45(model, sy0, sh0, 0.0, span_shift, sq, sp_, sf, base, SHIFT))
    unshifted = k_rk45.rk45(model, sy0, sh0, 0.0, span_shift, sq, sp_, sf, base)
    n64, span64 = case.f64_check
    model64, y64, p64, forc64 = case.inputs(n64, f64)
    cfg64 = SolverConfig()
    qt64 = case.queries(span64, f64)
    h64 = initial_step(model64, y64, 0.0, p64, forc64, cfg64)
    ker64, ms64 = timed(lambda: k_rk45.rk45(model64, y64, h64, 0.0, span64, qt64, p64, forc64, cfg64),
                        reps=3)
    plain_fn = "tiger_tpu_torch.kernels.rk45:rk45_plain"
    jobs = {"full": (plain_fn, (model, y0, h0, 0.0, tf, qt, params, forc, base), None),
            "shift": (plain_fn, (model, sy0, sh0, 0.0, span_shift, sq, sp_, sf, base, SHIFT), None),
            "f64": (plain_fn, (model64, y64, h64, 0.0, span64, qt64, p64, forc64, cfg64), None)}
    if not case.reads_t:
        jobs["unshifted"] = (plain_fn, (model, sy0, sh0, 0.0, span_shift, sq, sp_, sf, base), None)
    # A full-width dense block of GBs (DummyModel's 1,000 queries) stays in
    # this process.
    inline = MAIN_SYSTEMS * qt.numel() * N_EQ_ALL * 4 > 512e6
    plain = side_by_side(jobs, inline)
    ref, plain_ms = plain.pop("full")
    err = check_rk45(f"phase {T}b B1 {P}default vs rk45_plain ({MAIN_SYSTEMS} systems, "
                     f"{case.span_text})", ker, ref, none)
    n_rows = 0 if forc is None else forc.data.shape[0]
    n_q, n_q_after = qt.numel(), int((qt > 0.0).sum())
    att, worst = int(ker.stats.n_attempts.sum()), int(ker.stats.n_attempts.max())
    bnd = bound(b1_ops(att, int((~ker.stiff).sum()) * n_q_after, rhs_ops=case.rhs_ops),
                io_bytes(MAIN_SYSTEMS, n_rows, n_q, 5))
    geo = k_rk45.rk45_geometry(MAIN_SYSTEMS, 0, torch.float32, model)
    b1[P + "default"].update(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bnd[0],
                             solve=walls["f32"], bound_by=bnd[1], attempts=att,
                             worst_system_attempts=worst, geometry=geo, library_ms=None,
                             plain_side_by_side=1 if inline else SIDE_BY_SIDE)
    del ker, ref
    ref_s, plain_s = plain.pop("shift")
    err_s = check_rk45(f"phase {T}b B1 {P}default with t_shift {SHIFT:g} vs rk45_plain "
                       f"({n_shift} systems, first {span_shift:g} min)", ker_s, ref_s, none[:n_shift])
    moved = int((ker_s.y_final != unshifted.y_final).any(dim=1).sum())
    if case.reads_t:
        check(moved > 0, f"phase {T}b: t_shift changed no system's result")
    else:
        plain_unshifted = plain.pop("unshifted")[0]
        same = {"kernel": not any(k_rk45.rk45_mismatch(ker_s, unshifted).values()),
                "plain": not any(k_rk45.rk45_mismatch(ref_s, plain_unshifted).values())}
        check(all(same.values()), f"phase {T}b: t_shift {SHIFT:g} moved {case.label}'s results: {same}")
    b1[P + "default"].update(shift_check=dict(systems=n_shift, t_shift=SHIFT, span_min=span_shift,
                                              ms=ms_s, plain_ms=plain_s, max_abs_err=err_s,
                                              systems_moved_by_the_shift=moved))
    phase(f"phase {T}b B1 {P}default: {ms:.3f} ms vs rk45_plain {plain_ms:.3f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}, {case.rhs_name} {case.rhs_ops}), {att} attempts, worst "
          f"system {worst}, geometry {geo}; with t_shift {SHIFT:g} on {n_shift} "
          f"systems over {span_shift:g} min {ms_s:.3f} ms vs {plain_s:.3f} ms, {moved} systems "
          f"moved by the shift | {smi}")
    del ker_s, ref_s, unshifted, y0, params, forc

    ker, (ref, plain64) = ker64, plain.pop("f64")
    err64 = check_rk45(f"phase {T}b B1 {P}default/f64 vs rk45_plain float64 ({n64} "
                       f"systems, first {span64:g} min, rtol 1e-6 / atol 1e-9)", ker, ref, none[:n64])
    att64 = int(ker.stats.n_attempts.sum())
    bnd64 = bound(b1_ops(att64, int((~ker.stiff).sum()) * int((qt64 > 0.0).sum()), rhs_ops=case.rhs_ops),
                  io_bytes(n64, n_rows, qt64.numel(), 5, real=8), F64_PEAK)
    b1[P + "default/f64"].update(check_ms=ms64, plain_ms=plain64, max_abs_err=err64,
                                 check_bound_ms=bnd64[0], check_bound_by=bnd64[1],
                                 check_attempts=att64, check_systems=n64, check_span_min=span64,
                                 solve=walls["f64"],
                                 check_worst_system_attempts=int(ker.stats.n_attempts.max()))
    del y64, p64, forc64, ker, ker64, ref

    # (d) B2 on every system, from the model's h0.
    span_checks, attempts = {}, None
    for dtype in case.b2_dtypes:
        sfx = "/f64" if dtype == f64 else ""
        inst, key = P + "embedded3" + sfx, T + (" f64" if sfx else "")
        cfg = base if dtype == torch.float32 else SolverConfig()
        model, y0, params, forc = case.inputs(MAIN_SYSTEMS, dtype)
        qt = case.queries(tf, dtype)
        h0r = (initial_step(model, y0, 0.0, params, forc, cfg) if case.b2_h0 is None
               else torch.full((MAIN_SYSTEMS,), case.b2_h0, dtype=dtype, device="cuda"))
        reset_launch_counts()
        k_radau.radau(model, y0, h0r, 0.0, tf, qt, params, forc, cfg)  # warm-up
        rker, r_ms = timed(lambda: k_radau.radau(model, y0, h0r, 0.0, tf, qt, params, forc, cfg), reps=3)
        rec = b2.setdefault(inst, {})
        rec["launches"] = launch_counts()["radau"][inst]
        r_att, r_swp = int(rker.stats.n_attempts.sum()), int(rker.stats.n_newton.sum())
        r_worst, r_failed = int(rker.stats.n_attempts.max()), int(rker.failed.sum())
        real, peak = (8, F64_PEAK) if dtype == f64 else (4, F32_PEAK)
        r_bnd = bound(b2_ops(r_att, r_swp, MAIN_SYSTEMS * int((qt > 0.0).sum()), rhs_ops=case.rhs_ops),
                      io_bytes(MAIN_SYSTEMS, 0 if forc is None else forc.data.shape[0], qt.numel(), 6,
                               real), peak)
        h0_text = "initial_step's" if case.b2_h0 is None else f"{case.b2_h0:g}"
        phase(f"phase {T}d B2 {inst} on every system ({MAIN_SYSTEMS}, {case.span_text}, h0 "
              f"{h0_text}): {r_ms:.3f} ms (median of 3 after a warm-up), bound {r_bnd[0]:.4f} ms "
              f"({r_bnd[1]}), {r_att} attempts, worst system {r_worst} ({1e3 * r_ms / r_worst:.3f} us "
              f"an attempt), {r_swp / r_att:.4f} sweeps an attempt, failed {r_failed} | {smi}")
        check(r_failed == 0, f"phase {T}d: {r_failed} systems failed")
        check(bool(torch.isfinite(rker.y_final).all()), f"phase {T}d: non-finite y_final")
        top_d = torch.topk(rker.stats.n_attempts, B2_TOP).indices
        attempts = rker.stats.n_attempts if attempts is None else attempts
        rest = torch.ones(MAIN_SYSTEMS, dtype=torch.bool, device="cuda")
        rest[top_d] = False
        others = torch.nonzero(rest).squeeze(1)
        others = others[torch.linspace(0, others.numel() - 1, B2_OTHERS, device="cuda").long()]
        rows = torch.sort(torch.cat([top_d, others])).values
        cy0, cp, cf = subset(rows, y0, params, forc)
        ch0 = h0r[rows].contiguous()

        span_checks[key] = radau_span_check(
            f"phase {T}d B2 {inst} vs radau_plain ({rows.numel()} systems", r_worst, model, cy0, ch0,
            cp, cf, qt, cfg, rec, spans=case.b2_spans)
        worst_by_span = span_checks[key].worst
        rec.update(ms=r_ms, bound_ms=r_bnd[0], bound_by=r_bnd[1], attempts=r_att,
                   worst_system_attempts=r_worst, sweeps_per_attempt=r_swp / r_att,
                   systems=MAIN_SYSTEMS, failed=r_failed, library_ms=None,
                   us_per_attempt=1e3 * r_ms / r_worst, check_systems=rows.numel(),
                   worst_by_span=worst_by_span)
        del rker, y0, params, forc

    # (e) every instance against its plain version at the model's check shapes.
    for dtype in (torch.float32, f64):
        model, y0, params, forc, span, qt_e, cfg_e, where = case.check(dtype, "rk45", attempts)
        shift = 0.0 if case.reads_t else SHIFT
        results = b1_checks(case, dtype, lambda opt: dataclasses.replace(cfg_e, **B1_OPTIONS[opt]),
                            (model, y0, params, forc, span, qt_e, none[:y0.shape[0]]), f"{T}e", where,
                            b1, skip=case.skip, shift=shift)
        if case.golden is not None and dtype == f64:
            y = results["default"].y_final
            gold = torch.tensor(case.golden, dtype=f64, device="cuda").expand_as(y)
            rel = float(((y - gold).abs() / gold.abs()).max())
            b1[P + "default/f64"]["golden_max_rel_err"] = rel
            phase(f"phase {T}e B1 {P}default/f64 against the golden final state {list(case.golden)}: "
                  f"largest relative difference {rel:.3e} over {y.shape[0]} systems (bound 5e-6); its "
                  f"{qt_e.numel()}-row dense grid equals rk45_plain's bit for bit (above)")
            check(rel <= 5e-6, f"phase {T}e: B1 {P}default/f64 misses the golden final state by {rel:.3e}")
        model, y0, params, forc, span, qt_e, cfg_e, where = case.check(dtype, "radau", attempts)
        b2_checks(case, dtype, lambda opt, **kw: dataclasses.replace(cfg_e, **B2_OPTIONS[opt], **kw),
                  (model, y0, params, forc, span, qt_e), f"{T}e", where, b2,
                  skip=case.skip, counted=True, shift=shift, main=True)
        if not case.wide:
            continue
        # At the main path's shapes too, from each instance's own initial
        # steps: B1 here (but the default, held in (b)), B2 in
        # plain_span_checks, where each process compares its own pair
        # (a dense block is 2.6 GB in float32).  Recorded under
        # "full_width_check" / "full_width_*".
        cfg_w = base if dtype == torch.float32 else SolverConfig()
        model, y0, params, forc = case.inputs(MAIN_SYSTEMS, dtype)
        qt = case.queries(tf, dtype)
        where = f" ({MAIN_SYSTEMS} systems, {case.span_text}, {qt.numel()} queries)"
        wide = {}
        b1_checks(case, dtype, lambda opt: dataclasses.replace(cfg_w, **B1_OPTIONS[opt]),
                  (model, y0, params, forc, tf, qt, none), f"{T}e", where, wide,
                  skip=(case.name("default", dtype),), pooled=False)
        for inst, rec in wide.items():
            b1[inst]["full_width_check"] = rec
        for opt in B2_OPTIONS:
            inst = case.name(opt, dtype)
            cfg = dataclasses.replace(cfg_w, **B2_OPTIONS[opt],
                                      **(REFERENCE_CHECK if opt.startswith("reference") else {}))
            h0 = initial_step(model, y0, 0.0, params, forc, cfg)
            span_checks[f"{T}e {inst}"] = radau_span_check(
                f"phase {T}e B2 {inst} vs radau_plain{where[:-1]}", None, model, y0, h0, params, forc,
                qt, cfg, b2.setdefault(inst, {}), spans=(tf,), prefix="full_width_",
                may_fail=opt in B2_MAY_FAIL, diff_in_worker=True)
        del model, y0, params, forc, qt
    phase(f"phase {T} took {time.perf_counter() - phase_start:.1f} s ({T}d's plain Radau check at "
          f"the end)")
    return {"rk45": b1, "radau": b2, "solve": walls}, span_checks


def hourly(span: float, dtype=torch.float32) -> torch.Tensor:
    """Hourly queries over [0, span] minutes, on the card."""
    return torch.arange(0.0, span + 1e-9, 60.0, dtype=dtype, device="cuda")


def m200_check(dtype, kernel: str, attempts) -> tuple:
    """Phase 12e's inputs (ModelCase.check): B1 on M200_B1_CHECK's first
    systems over its first minutes, hourly queries; B2 on the
    M200_B2_CHECK[0] systems 12d's B2 took the most ``attempts`` on, over
    its first minutes, queries every 5; both at rtol 1e-5 / atol 1e-8."""
    from tiger_tpu_torch import SolverConfig

    base = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    if kernel == "rk45":
        n, span = M200_B1_CHECK
        return (*m200_inputs(n, dtype), span, hourly(span, dtype), base, f" ({n} systems, {span:g} min)")
    n, span = M200_B2_CHECK
    model, y0, params, forc = m200_inputs(MAIN_SYSTEMS, dtype)
    rows = torch.topk(attempts, n).indices
    return (model, y0[rows].contiguous(), {k: v[rows].contiguous() for k, v in params.items()},
            forc.take_systems(rows), span,
            torch.arange(0.0, span + 1e-9, 5.0, dtype=dtype, device="cuda"), base,
            f" ({n} systems, first {span:g} min)")


M200 = ModelCase(
    tag="12", label="Model 200", prefix="m200/", rhs_ops=RHS_OPS_M200, rhs_name="RHS_OPS_M200",
    reads_t=True, inputs=m200_inputs, queries=hourly, note=f", doy0 {M200_DOY0:g}",
    cli={"model": {"uid": 200, "name": "Model200"},
         "time": {"start": "2000-07-01T00:00:00", "end": "2000-07-03T00:00:00"}},
    cli_text=" from 2000-07-01, doy0 183", shift=M200_SHIFT_CHECK, f64_check=M200_F64_CHECK,
    b2_h0=M200_B2_H0, b2_spans=F64_SPANS, check=m200_check,
    skip=("m200/default", "m200/default/f64", "m200/embedded3"))

# Phase 13: DummyModel, the reference's 5-state linear test system, whose
# final state at t = 5 and 10,000-query dense grid are the reference's only
# published artifacts (BASELINE.md).  Full width: 131,072 systems from
# seeded states over the same 5 minutes, DUMMY_QUERIES queries.
RHS_OPS_DUMMY = 17  # common.cuh ModelDummy::rhs: 7 products, 10 sums
DUMMY_SPAN, DUMMY_QUERIES = 5.0, 1000
GOLDEN = (1.91791, 1.90017, 2.39397, 1.71872, 3.06922)  # the reference's final.csv
GOLDEN_QUERIES = 10_000  # t_q = (q + 1) 5 / 10001, fill_t0_queries off


def dummy_inputs(s_count: int, dtype=torch.float32) -> tuple:
    """DummyModel's main-path systems: y0 uniform over 0.5-2.0 from a
    seeded numpy generator; no parameters and no forcings."""
    import numpy as np

    from tiger_tpu_torch import DummyModel

    y0 = np.random.default_rng(1).uniform(0.5, 2.0, (s_count, 5))
    return DummyModel(), torch.as_tensor(y0, device="cuda").to(dtype), None, None


def dummy_queries(span: float, dtype=torch.float32) -> torch.Tensor:
    """The first ``span`` minutes of DUMMY_QUERIES queries (q + 1) 5 / 1000."""
    qt = torch.arange(1, DUMMY_QUERIES + 1, dtype=torch.float64) * (DUMMY_SPAN / DUMMY_QUERIES)
    return qt[qt <= span + 1e-9].to(device="cuda", dtype=dtype)


def dummy_check(dtype, kernel: str, attempts) -> tuple:
    """Phase 13e's inputs (ModelCase.check), the reference's golden shapes
    for both kernels: 4 systems of ones over t in [0, 5], the
    GOLDEN_QUERIES-query grid without the t0 fill; float32 at rtol 1e-5 /
    atol 1e-8, float64 at SolverConfig()'s rtol 1e-6 / atol 1e-9 (the
    reference's)."""
    import numpy as np

    from tiger_tpu_torch import DummyModel, SolverConfig

    cfg = (SolverConfig(fill_t0_queries=False) if dtype == torch.float64 else
           SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000, fill_t0_queries=False))
    qt = torch.as_tensor(np.arange(1, GOLDEN_QUERIES + 1) * DUMMY_SPAN / (GOLDEN_QUERIES + 1),
                         device="cuda").to(dtype)
    return (DummyModel(), torch.ones((4, 5), dtype=dtype, device="cuda"), None, None, DUMMY_SPAN, qt,
            cfg, f" (4 systems of ones, {DUMMY_SPAN:g} min, the {GOLDEN_QUERIES}-query grid)")


DUMMY = ModelCase(
    tag="13", label="DummyModel", prefix="dummy/", rhs_ops=RHS_OPS_DUMMY, rhs_name="RHS_OPS_DUMMY",
    reads_t=False, inputs=dummy_inputs, tf=DUMMY_SPAN, queries=dummy_queries,
    span_text=f"{DUMMY_SPAN:g} min", note=", y0 uniform over 0.5-2.0",
    cli={"model": {"uid": 1, "name": "DummyModel"}}, shift=(4096, DUMMY_SPAN),
    f64_check=(MAIN_SYSTEMS, DUMMY_SPAN), b2_dtypes=(torch.float32, torch.float64),
    b2_spans=(DUMMY_SPAN,), check=dummy_check, golden=GOLDEN, wide=True)


DIST_RANKS = 2  # phase 14b's processes, both on the one card (gloo)
DIST_TIMEOUT_S = 300.0  # phase 14's processes together


def dist_worker(coordinator: str, world: str, rank: str, backend: str, job_path: str,
                out_path: str) -> None:
    """A process of phase 14: joins the process group once
    (dist.init_process), then runs run() on each config document of
    ``job_path`` (JSON: [[name, document], ...]) in turn, the launch counters
    set to 0 just before each, and saves each run's wall, routed exchange
    seconds, stiff and failed counts and launches to ``out_path``."""
    import torch.distributed as dist

    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.dist import init_process
    from tiger_tpu_torch.kernels import launch_totals, reset_launch_counts
    from tiger_tpu_torch.profiling import Metrics
    from tiger_tpu_torch.run import run

    with open(job_path) as f:
        job = json.load(f)
    init_process(coordinator, int(world), int(rank), backend)
    out = []
    try:
        with torch.inference_mode():
            for name, doc in job:
                torch.cuda.synchronize()
                reset_launch_counts()
                start = time.perf_counter()
                summary = run(config_from_dict(doc), metrics=Metrics())
                torch.cuda.synchronize()
                out.append(dict(name=name, wall=time.perf_counter() - start,
                                exchange_s=summary.get("routed_exchange_s"),
                                n_stiff=summary["n_stiff"], n_failed=summary["n_failed"],
                                launches=launch_totals()))
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def dist_phase(smi: str, model, cfg, inputs: tuple, res5) -> dict:
    """Phase 14: several processes on the one card; returns each kernel's
    launches over its runs.

    (a) solve(..., devices=[cuda:0, cuda:0]) on phase 5's last timed inputs
    (131,072 systems, 2 days): the two halves solve on two streams, in two
    threads; the merge equals phase 5's one-device result bit for bit
    (y_final, dense, stiff, failed and every counter).  (b) two rank
    processes on the card under gloo, each joining its group once and
    running the shared basin unchunked with routed_exchange ring, again with
    allgather, in 1-day windows with daily checkpoints (ring), and the
    unchunked ring once more: the rank files, concatenated, equal a
    one-process run() of the same config bit for bit (final, dense, state);
    allgather's discharge equals the one-process discharge bit for bit,
    ring's lies within routing.ring_error_bound (the summation depths of
    both orders times float32's 2^-24, at most 1e-5 relative); the second
    ring run equals the first bit for bit.  (c) beside them, one process
    with nccl at world size 1: its files equal the one-process run's bit for
    bit.  Two CUDA contexts time-slice one card, so (b)'s walls are data,
    not speed.  Any failure ends the other processes."""
    import os
    import socket
    import sys
    import tempfile

    import numpy as np

    from tiger_tpu_torch import routing, solve
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.kernels import launch_totals, reset_launch_counts
    from tiger_tpu_torch.params import load_spatial_params, split_even
    from tiger_tpu_torch.profiling import Metrics
    from tiger_tpu_torch.run import run

    phase_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    y0, params, forc, qt = inputs
    tf = DAYS * 1440.0
    torch.cuda.synchronize()
    reset_launch_counts()
    start = time.perf_counter()
    two = solve(model, y0, 0.0, tf, qt, params, forc, cfg, devices=[dev, dev])
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - start
    launches = launch_totals()
    same_a = {"y_final": _bit_equal(two.y_final, res5.y_final),
              "dense": _bit_equal(two.dense, res5.dense),
              "stiff": bool(torch.equal(two.stiff, res5.stiff)),
              "failed": bool(torch.equal(two.failed, res5.failed)),
              "counters": all(bool(torch.equal(a, b)) for a, b in zip(
                  (*two.rk_stats, *two.radau_stats), (*res5.rk_stats, *res5.radau_stats)))}
    phase(f"phase 14a solve() over devices [cuda:0, cuda:0] ({MAIN_SYSTEMS} systems, {DAYS:g} "
          f"days, halves {[sl.stop - sl.start for sl in split_even(MAIN_SYSTEMS, 2)]}): wall "
          f"{wall_a:.6f} s, n_stiff {two.n_stiff}, launches {launches}; equal to phase 5's "
          f"one-device solve bit for bit {same_a} | {smi}")
    check(all(same_a.values()), f"phase 14a: the split solve differs from the one-device one: {same_a}")
    check(launches["rk45"] == 2 and launches["radau"] == 2,
          f"phase 14a: each half did not launch B1 and B2 once: {launches}")
    del two

    outputs = (("final", "outputs"), ("dense", "outputs"), ("state", "outputs"),
               ("discharge", "discharge"))
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="tiger_dist_") as tmp:
        def doc(name, **output):
            d = basin_doc(os.path.join(tmp, name))
            d["output"].update(output)
            if name.endswith("windows"):
                d["time"]["chunk_days"] = 1.0
                d["output"]["checkpoint_interval"] = "1d"
            return d

        # The one-process runs, before the card is shared.
        for name in ("one", "one_windows"):
            run(config_from_dict(doc(name)), metrics=Metrics())
        jobs = {"gloo": [("ring", doc("ring")), ("allgather", doc("allgather", routed_exchange="allgather")),
                         ("windows", doc("windows")), ("ring again", doc("ring_again"))],
                "nccl": [("nccl", doc("nccl"))]}
        for backend, job in jobs.items():
            with open(os.path.join(tmp, f"{backend}.json"), "w") as f:
                json.dump(job, f)

        def port():
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                return str(sock.getsockname()[1])

        ranks = [("gloo", str(DIST_RANKS), str(r)) for r in range(DIST_RANKS)] + [("nccl", "1", "0")]
        coord = {"gloo": f"127.0.0.1:{port()}", "nccl": f"127.0.0.1:{port()}"}
        procs = []
        start = time.perf_counter()
        try:
            for backend, world, rank in ranks:
                stem = os.path.join(tmp, f"{backend}_{rank}")
                with open(stem + ".log", "w") as log:
                    procs.append((subprocess.Popen(
                        [sys.executable, "-c",
                         "import sys, chip_smoke; chip_smoke.dist_worker(*sys.argv[1:])",
                         coord[backend], world, rank, backend, os.path.join(tmp, f"{backend}.json"),
                         stem + ".out"], cwd=here, stdout=log, stderr=subprocess.STDOUT), stem))
            for proc, stem in procs:
                left = DIST_TIMEOUT_S - (time.perf_counter() - start)
                try:
                    rc = proc.wait(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    rc = None
                with open(stem + ".log") as log:
                    check(rc == 0, f"phase 14: the process {os.path.basename(stem)} "
                                   f"{'timed out' if rc is None else f'failed ({rc})'}:\n"
                                   f"{log.read()[-4000:]}")
        finally:
            for proc, _ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall_b = time.perf_counter() - start
        runs = {}
        for backend, world, rank in ranks:
            with open(os.path.join(tmp, f"{backend}_{rank}.out")) as f:
                for r in json.load(f):
                    runs.setdefault(r["name"], []).append(r)
        for rs in runs.values():
            for r in rs:
                check(r["n_failed"] == 0, f"phase 14: a run failed links: {r}")
                for kernel, n in r["launches"].items():
                    launches[kernel] += n

        ref = {tag: _read_files(os.path.join(tmp, name), outputs)
               for tag, name in (("whole", "one"), ("windows", "one_windows"))}
        got = {name: _read_files(os.path.join(tmp, name.replace(" ", "_")), outputs,
                                 ranks=DIST_RANKS) for name, _ in jobs["gloo"]}
        got["nccl"] = _read_files(os.path.join(tmp, "nccl"), outputs)
        sp = load_spatial_params(config_from_dict(doc("one")).params_file)
        topo = routing.build_topology(sp["stream"], sp["next_stream"])
        plan = routing.plan_sharded_topology(topo, DIST_RANKS, split_even(MAIN_SYSTEMS, DIST_RANKS))
        rtol = routing.ring_error_bound(topo, plan, 2.0 ** -24)
        check(rtol <= 1e-5, f"phase 14b: the ring's bound {rtol:.3e} is above 1e-5")
        equal, ring_err = {}, {}
        for name, files in got.items():
            want = ref["windows" if name == "windows" else "whole"]
            for key, _ in outputs:
                if key == "discharge" and name in ("ring", "windows", "ring again"):
                    a, b = files[key], want[key]
                    ring_err[name] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
                    equal[f"{name} {key} within bound"] = bool(
                        a.shape == b.shape and (np.abs(a - b) <= rtol * np.abs(b)).all())
                else:
                    equal[f"{name} {key}"] = bool(files[key].shape == want[key].shape
                                                  and np.array_equal(files[key], want[key]))
        equal.update({f"ring again {key} equals ring": bool(np.array_equal(
            got["ring again"][key], got["ring"][key])) for key, _ in outputs})
        n_q = int(round(DAYS * 24)) + 1
        bytes_ring = routing.ring_bytes_per_exchange(plan, n_q, 4)
        bytes_gather = routing.allgather_bytes_per_exchange(MAIN_SYSTEMS, n_q, 1, DIST_RANKS, 4)
        per_rank = {name: [dict(wall=round(r["wall"], 6), exchange_s=None if r["exchange_s"] is None
                                else round(r["exchange_s"], 6), n_stiff=r["n_stiff"])
                           for r in rs] for name, rs in runs.items()}
        phase(f"phase 14b {DIST_RANKS} rank processes on one card (gloo) and 14c one nccl process "
              f"at world size 1 ({MAIN_SYSTEMS} links, {DAYS:g} days; the processes' wall "
              f"{wall_b:.1f} s, their start included): each rank's wall and routed exchange "
              f"seconds by run {per_rank} (walls are data: two contexts time-slice the card); "
              f"bytes an exchange at {n_q} queries: ring {bytes_ring} (rounds' outbox slots "
              f"{plan.round_slots}), allgather of the runoff {bytes_gather} (of the dense block, "
              f"as the JAX package gathers: {5 * bytes_gather}); ring discharge's largest "
              f"relative difference from the one-process run's {ring_err} within the bound "
              f"{rtol:.3e}; equal {equal} | {smi}")
        check(all(equal.values()), f"phase 14b-c: files differ: {equal}")
    check(launches["rk45"] > 0 and launches["radau"] > 0, f"phase 14: a kernel was not launched: {launches}")
    phase(f"phase 14 took {time.perf_counter() - phase_start:.1f} s, launches {launches}")
    return launches


# Phase 15: the TPU kernels' last options (B1's lockstep query crossing and
# bf16 forcing, B2's per-system factor reuse).
REUSE_MODES = ("embedded3", "radau5")  # 15d: B2's error modes held with reuse
REUSE_CHECK = (4, 5.0)  # 15g: systems and minutes of every reuse instance's check
RUNTIME_CHECK = (256, 60.0, 20.0)  # 15h: systems, minutes and query spacing (Model 204, 200)


@dataclasses.dataclass(frozen=True)
class OptionCase(ModelCase):
    """A ModelCase whose instances are those of a PR 13 option bit, named
    with ``suffix``: B2's '+reuse', B1's '+runtime' (lockstep, bf16)."""

    suffix: str = ""

    @classmethod
    def of(cls, case: ModelCase, suffix: str) -> "OptionCase":
        return cls(**{f.name: getattr(case, f.name) for f in dataclasses.fields(case)},
                   suffix=suffix)

    def name(self, opt: str, dtype) -> str:
        return self.prefix + opt + self.suffix + ("/f64" if dtype == torch.float64 else "")
PR12_MS = {"rk45": 9.310, "radau": 16.148}  # PERF.md §6: B1 default, B2 embedded3
# What a reused attempt of B2 skips (radau.cu): the five perturbed
# right-hand sides, their perturbations, the matrices' entries, both LUs.
B2_REUSED_SKIPS = 20 + 110 + 75 + 330


def b2_reuse_ops(ker, queries: int, cfg, rhs_ops: int = RHS_OPS) -> int:
    """b2_ops of B2's result ``ker`` less what its reused attempts skipped
    (attempts less factorizations)."""
    att, swp, fct = (int(x.sum()) for x in (ker.stats.n_attempts, ker.stats.n_newton,
                                               ker.stats.n_fact))
    return b2_ops(att, swp, queries, cfg, rhs_ops) - (att - fct) * (5 * rhs_ops + B2_REUSED_SKIPS)


def last_options_phase(smi: str, model, cfg, inputs: tuple, stiff: tuple, times: dict) -> tuple:
    """Phase 15: the TPU kernels' last options at the main path's shapes.
    (a) solve() with the lockstep query crossing, bf16 forcing and factor
    reuse (the launch counters set to 0 just before, read just after; each
    option must have been launched); (b) B1 with lockstep, float and
    double, and (c) with bf16 forcing, Model 204 and Model 200, each bit
    for bit against rk45_plain (on the pool); (d) B2 with factor reuse,
    embedded3 and radau5, float and double, on the main path's stiff
    systems, held to radau_plain at the end (plain_span_checks); (e) B2
    m200/embedded3 with reuse on every system, timed once; (g) every B2
    instance with reuse and (h) every B1 kRuntime instance against its
    plain version at small shapes; (f) the CLI with
    solver.forcing_precision bf16, its files equal to a direct solve().
    ``inputs`` = (y0, params, forcings, queries, h0) of the main path,
    ``stiff`` = (rows, y0, params, forcings, h0) of phase 6's stiff
    systems, ``times`` phase 6's and 12d's kernel times.  Returns ({"rk45":
    records, "radau": records, "solve": ..., "cli": ...}, the span checks
    by name)."""
    import os
    import tempfile

    import numpy as np

    from tiger_tpu_torch import solve
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.kernels import (launch_counts, launch_totals, option_launch_counts,
                                         reset_launch_counts)
    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.profiling import Metrics
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import STIFF_HU, solve_written_basin
    from tiger_tpu_torch.solver.controller import initial_step

    phase_start = time.perf_counter()
    y0, params, forc, qt, h0 = inputs
    tf, f64 = DAYS * 1440.0, torch.float64
    hu_rows = params["Hu"] < STIFF_HU * 10
    n_rows, n_q, n_q_after = forc.data.shape[0], qt.numel(), int((qt > 0.0).sum())
    lock = dataclasses.replace(cfg, dense_lockstep=True)
    bf16 = dataclasses.replace(cfg, forcing_dtype="bf16")
    every = dataclasses.replace(cfg, dense_lockstep=True, forcing_dtype="bf16",
                                radau_factor_reuse=True)
    b1, b2 = {}, {}

    # (a) the main path with every option.
    torch.cuda.synchronize()
    reset_launch_counts()
    res = solve(model, y0, 0.0, tf, qt, params, forc, every)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for i in range(1, 4):
        start = time.perf_counter()
        res = solve(model, y0 + i * 1e-7, 0.0, tf, qt, params, forc, every)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    launches, options = launch_totals(), option_launch_counts()
    reuse_launches = launch_counts()["radau"]["embedded3+reuse"]
    options["embedded3+reuse"] = reuse_launches
    wall, n_failed = sorted(walls)[1], int(res.failed.sum())
    rk_att = int(res.rk_stats.n_attempts.sum())
    rd = res.radau_stats
    rd_att, rd_fct = (0, 0) if rd is None else (int(rd.n_attempts.sum()), int(rd.n_fact.sum()))
    solve_rec = dict(wall_s=wall, walls_s=walls, system_steps_per_s=(rk_att + rd_att) / wall,
                     n_stiff=res.n_stiff, n_failed=n_failed, rk_attempts=rk_att,
                     radau_attempts=rd_att, radau_factorizations=rd_fct, launches=launches,
                     option_launches=options)
    phase(f"phase 15a solve() with dense_lockstep, forcing_dtype bf16 and radau_factor_reuse "
          f"({MAIN_SYSTEMS} systems, {DAYS:g} days, {n_q} queries): wall median {wall:.6f} s (min "
          f"{min(walls):.6f}, max {max(walls):.6f}), {(rk_att + rd_att) / wall:.6e} system-steps/s, "
          f"n_stiff {res.n_stiff}, n_failed {n_failed}, rk attempts {rk_att}, radau attempts "
          f"{rd_att}, factorizations {rd_fct}, launches {launches}, by option {options} | {smi}")
    check(options["lockstep"] > 0 and options["bf16"] > 0 and reuse_launches > 0,
          f"phase 15a: an option was not launched: {options}")
    check(n_failed == 0, f"phase 15a: {n_failed} systems failed")
    check(bool(res.stiff[hu_rows].all()), "phase 15a: a Hu=1e-6 row was not flagged stiff")
    check(bool(torch.isfinite(res.y_final).all()), "phase 15a: non-finite y_final")
    check(tuple(res.dense.shape) == (MAIN_SYSTEMS, n_q, 5), f"phase 15a: dense {tuple(res.dense.shape)}")
    del res

    # (b) lockstep, float and double, and (c) bf16, Model 204 and Model 200:
    # every kernel first, timed, then the plain versions side by side.
    y64, p64, qt64 = y0.double(), {k: v.double() for k, v in params.items()}, qt.double()
    h64 = initial_step(model, y64, 0.0, p64, forc, lock)
    m200, my0, mp, mforc = m200_inputs(MAIN_SYSTEMS)
    mh0 = initial_step(m200, my0, 0.0, mp, mforc, bf16)
    runs = {"lockstep": (model, y0, h0, qt, params, forc, lock, RHS_OPS),
            "lockstep/f64": (model, y64, h64, qt64, p64, forc, lock, RHS_OPS),
            "bf16": (model, y0, h0, qt, params, forc, bf16, RHS_OPS),
            "m200/bf16": (m200, my0, mh0, qt, mp, mforc, bf16, RHS_OPS_M200)}
    kers = {}
    for name, (mdl, a_y0, a_h0, a_qt, a_p, a_f, a_cfg, _) in runs.items():
        kers[name] = timed(lambda: k_rk45.rk45(mdl, a_y0, a_h0, 0.0, tf, a_qt, a_p, a_f, a_cfg),
                           reps=3)
    copy_ms = timed(lambda: forc.data.to(torch.bfloat16), reps=3)[1]
    plain = side_by_side({name: ("tiger_tpu_torch.kernels.rk45:rk45_plain",
                                 (r[0], r[1], r[2], 0.0, tf, r[3], r[4], r[5], r[6]), None)
                          for name, r in runs.items()})
    for name, (mdl, a_y0, a_h0, a_qt, a_p, a_f, a_cfg, rhs_ops) in runs.items():
        (ker, ms), (ref, p_ms) = kers.pop(name), plain.pop(name)
        double = a_y0.dtype == f64
        rows = hu_rows if mdl is model else torch.zeros_like(hu_rows)
        err = check_rk45(f"phase 15{'c' if 'bf16' in name else 'b'} B1 {name} vs rk45_plain "
                         f"({MAIN_SYSTEMS} systems, {DAYS:g} days)", ker, ref, rows)
        att = int(ker.stats.n_attempts.sum())
        nbytes = io_bytes(MAIN_SYSTEMS, n_rows, n_q, 5, 8 if double else 4)
        if a_cfg.forcing_dtype == "bf16":
            nbytes -= 2 * MAIN_SYSTEMS * n_rows  # the kernel reads 2 bytes a forcing value
        bnd = bound(b1_ops(att, int((~ker.stiff).sum()) * n_q_after,
                           k_rk45.rk45_options(a_cfg), rhs_ops), nbytes,
                    F64_PEAK if double else F32_PEAK)
        b1[name] = dict(ms=ms, plain_ms=p_ms, plain_side_by_side=SIDE_BY_SIDE, max_abs_err=err,
                        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None, launches=3,
                        attempts=att, worst_system_attempts=int(ker.stats.n_attempts.max()),
                        systems=MAIN_SYSTEMS, span_min=tf)
    del kers, plain
    forcing_bytes = {"float32": forc.data.numel() * 4, "bfloat16": forc.data.numel() * 2,
                     "m200_float32": mforc.data.numel() * 4, "m200_bfloat16": mforc.data.numel() * 2}
    b1["bf16"].update(forcing_bytes=forcing_bytes, bf16_copy_ms=copy_ms)
    phase(f"phase 15b-c B1 at the main path's shapes, each equal to rk45_plain bit for bit: "
          f"lockstep {b1['lockstep']['ms']:.3f} ms ({b1['lockstep']['attempts']} attempts), "
          f"lockstep/f64 {b1['lockstep/f64']['ms']:.3f} ms, bf16 {b1['bf16']['ms']:.3f} ms, "
          f"m200/bf16 {b1['m200/bf16']['ms']:.3f} ms; B1 default {times['rk45']:.3f} ms (phase 6; "
          f"PR 12: {PR12_MS['rk45']:.3f}); forcing bytes {forcing_bytes}, the bf16 copy "
          f"{copy_ms:.3f} ms; records {b1} | {smi}")

    # (d) B2 with reuse on the stiff systems, held at the end.
    s_rows, sy0, sp, sf, sh0 = stiff
    n_sys, checks = s_rows.numel(), {}
    for dtype in (torch.float32, f64):
        sfx = "/f64" if dtype == f64 else ""
        ay0, ah0, aqt = sy0.to(dtype), sh0.to(dtype), qt.to(dtype)
        ap = {k: v.to(dtype) for k, v in sp.items()}
        for mode in REUSE_MODES:
            name = mode + "+reuse" + sfx
            rcfg = dataclasses.replace(cfg, radau_factor_reuse=True, radau_error_mode=mode)
            ker, ms = timed(lambda: k_radau.radau(model, ay0, ah0, 0.0, tf, aqt, ap, sf, rcfg), reps=3)
            fresh_ms = timed(lambda: k_radau.radau(model, ay0, ah0, 0.0, tf, aqt, ap, sf,
                                                   dataclasses.replace(rcfg, radau_factor_reuse=False)),
                             reps=3)[1]
            att, fct = int(ker.stats.n_attempts.sum()), int(ker.stats.n_fact.sum())
            bnd = bound(b2_reuse_ops(ker, n_sys * n_q_after, rcfg),
                        io_bytes(n_sys, n_rows, n_q, 6, 8 if sfx else 4), F64_PEAK if sfx else F32_PEAK)
            b2[name] = dict(ms=ms, without_reuse_ms=fresh_ms, bound_ms=bnd[0], bound_by=bnd[1],
                            library_ms=None, launches=3, systems=n_sys, attempts=att,
                            factorizations=fct, factorizations_per_attempt=fct / max(att, 1),
                            failed=int(ker.failed.sum()),
                            worst_system_attempts=int(ker.stats.n_attempts.max()))
            checks[f"15d {name}"] = radau_span_check(
                f"phase 15d B2 {name} vs radau_plain ({n_sys} systems", b2[name]["worst_system_attempts"],
                model, ay0, ah0, ap, sf, aqt, rcfg, b2[name], prefix="main_",
                may_fail=mode == "radau5")
    phase(f"phase 15d B2 with factor reuse on the main path's {n_sys} stiff systems ({DAYS:g} days; "
          f"radau_plain at the end): "
          + ", ".join(f"{k} {v['ms']:.3f} ms (without reuse {v['without_reuse_ms']:.3f} ms), "
                      f"n_fct/n_att {v['factorizations']}/{v['attempts']} = "
                      f"{v['factorizations_per_attempt']:.4f}, failed {v['failed']}"
                      for k, v in b2.items())
          + f"; B2 embedded3 {times['radau']:.3f} ms (phase 6; PR 12: {PR12_MS['radau']:.3f}) | {smi}")

    # (e) Model 200's B2 with reuse on every system, from 12d's h0.
    h0r = torch.full((MAIN_SYSTEMS,), M200_B2_H0, device=y0.device)
    rcfg = dataclasses.replace(cfg, radau_factor_reuse=True)
    ker, ms = timed(lambda: k_radau.radau(m200, my0, h0r, 0.0, tf, qt, mp, mforc, rcfg))
    att, fct = int(ker.stats.n_attempts.sum()), int(ker.stats.n_fact.sum())
    bnd = bound(b2_reuse_ops(ker, MAIN_SYSTEMS * n_q_after, rcfg, RHS_OPS_M200),
                io_bytes(MAIN_SYSTEMS, mforc.data.shape[0], n_q, 6))
    b2["m200/embedded3+reuse"] = dict(
        ms=ms, without_reuse_ms=times.get("m200_radau"), bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=None, launches=1, systems=MAIN_SYSTEMS, attempts=att, factorizations=fct,
        factorizations_per_attempt=fct / max(att, 1), failed=int(ker.failed.sum()),
        worst_system_attempts=int(ker.stats.n_attempts.max()))
    phase(f"phase 15e B2 m200/embedded3 with reuse on every system ({MAIN_SYSTEMS}, {DAYS:g} days, "
          f"h0 {M200_B2_H0:g}): {ms:.3f} ms once (12d without reuse: {times.get('m200_radau')} ms), "
          f"n_fct/n_att {fct}/{att} = {fct / max(att, 1):.4f}, failed {int(ker.failed.sum())}, worst "
          f"system {int(ker.stats.n_attempts.max())} attempts, bound {bnd[0]:.4f} ms ({bnd[1]}) | {smi}")
    top = torch.topk(ker.stats.n_attempts, REUSE_CHECK[0]).indices
    del ker

    # (g) every instance with reuse (each model, option set and scalar)
    # against radau_plain at small shapes, each launch counted once.
    def reuse_cfg(opt, **extra):
        return dataclasses.replace(cfg, radau_factor_reuse=True, **B2_OPTIONS[opt], **extra)

    qt_r = torch.arange(0.0, REUSE_CHECK[1] + 1e-9, 5.0, device=y0.device)
    first = torch.arange(min(REUSE_CHECK[0], n_sys), device=y0.device)
    cases = ((M204, (model, sy0[first], {k: v[first] for k, v in sp.items()},
                     sf.take_systems(first), qt_r)),
             (M200, (m200, my0[top], {k: v[top] for k, v in mp.items()}, mforc.take_systems(top),
                     qt_r)),
             (DUMMY, (*dummy_inputs(REUSE_CHECK[0])[:3], None, dummy_queries(REUSE_CHECK[1]))))
    for case, (mdl, c_y0, c_p, c_f, c_qt) in cases:
        reuse_case = OptionCase.of(case, "+reuse")
        for dtype in (torch.float32, f64):
            d_p = None if c_p is None else {k: v.to(dtype) for k, v in c_p.items()}
            b2_checks(reuse_case, dtype, reuse_cfg,
                      (mdl, c_y0.to(dtype), d_p, c_f, REUSE_CHECK[1], c_qt.to(dtype)), "15g",
                      f" ({REUSE_CHECK[0]} systems, first {REUSE_CHECK[1]:g} min)", b2, counted=True,
                      may_fail=B2_MAY_FAIL + ("radau5", "radau5+predictor"))
    phase(f"phase 15g every B2 instance with factor reuse ({len(cases) * 2 * len(B2_OPTIONS)}) "
          f"against radau_plain bit for bit | {smi}")

    # (h) every kRuntime instance of B1 (each model, option set and scalar)
    # with lockstep and bf16 forcing against rk45_plain at small shapes,
    # queries between the steps; FSAL against its twin as in phase 9a.
    def runtime_cfg(opt, **extra):
        return dataclasses.replace(cfg, dense_lockstep=True, forcing_dtype="bf16",
                                   **B1_OPTIONS[opt], **extra)

    n_rt, span_rt, every_rt = RUNTIME_CHECK
    qt_rt = torch.arange(0.0, span_rt + 1e-9, every_rt, device=y0.device)
    head = torch.arange(n_rt, device=y0.device)
    cases = ((M204, (model, y0[head], {k: v[head] for k, v in params.items()},
                     forc.take_systems(head), span_rt, qt_rt)),
             (M200, (m200, my0[head], {k: v[head] for k, v in mp.items()},
                     mforc.take_systems(head), span_rt, qt_rt)),
             (DUMMY, (*dummy_inputs(n_rt)[:3], None, REUSE_CHECK[1], dummy_queries(REUSE_CHECK[1]))))
    for case, (mdl, c_y0, c_p, c_f, c_span, c_qt) in cases:
        rt_case = OptionCase.of(case, "+runtime")
        for dtype in (torch.float32, f64):
            d_p = None if c_p is None else {k: v.to(dtype) for k, v in c_p.items()}
            none = torch.zeros(n_rt, dtype=torch.bool, device=y0.device)
            b1_checks(rt_case, dtype, runtime_cfg,
                      (mdl, c_y0.to(dtype), d_p, c_f, c_span, c_qt.to(dtype), none), "15h",
                      f" ({n_rt} systems, first {c_span:g} min)", b1)
    del m200, my0, mp, mforc
    phase(f"phase 15h every B1 instance with lockstep and bf16 ({len(cases) * 2 * len(B1_OPTIONS)}) "
          f"against rk45_plain bit for bit | {smi}")

    # (f) the CLI with solver.forcing_precision bf16.
    with tempfile.TemporaryDirectory(prefix="tiger_bf16_") as tmp:
        doc = basin_doc(os.path.join(tmp, "out"))
        doc["solver"]["forcing_precision"] = "bf16"
        cli_cfg = config_from_dict(doc)
        check(cli_cfg.solver_config().forcing_dtype == "bf16", "phase 15f: the config is not bf16")
        torch.cuda.synchronize()
        reset_launch_counts()
        start = time.perf_counter()
        out = run(cli_cfg, metrics=Metrics())
        cli_wall = time.perf_counter() - start
        cli_launches, cli_options = launch_totals(), option_launch_counts()
        direct = solve_written_basin(cli_cfg, y0.device)[0]
        got = _read_files(cli_cfg.output.path, (("final", "outputs"), ("dense", "outputs")))
        same = {"dense": bool(np.array_equal(got["dense"], direct.dense.cpu().numpy())),
                "final": bool(np.array_equal(got["final"], direct.y_final.cpu().numpy()))}
    cli_rec = dict(wall_s=cli_wall, n_stiff=out["n_stiff"], n_failed=out["n_failed"],
                   launches=cli_launches, option_launches=cli_options, equal_to_solve=same)
    phase(f"phase 15f CLI with solver.forcing_precision bf16 ({MAIN_SYSTEMS} links, {DAYS:g} days, "
          f"f32): wall {cli_wall:.6f} s (first run), n_stiff {out['n_stiff']}, n_failed "
          f"{out['n_failed']}, launches {cli_launches}, by option {cli_options}; dense and final "
          f"files equal solve() bit for bit {same} | {smi}")
    check(cli_options["bf16"] > 0, f"phase 15f: B1 read no bf16 forcing: {cli_options}")
    check(out["n_failed"] == 0, f"phase 15f: {out['n_failed']} links failed")
    check(all(same.values()), f"phase 15f: the run's files differ from solve(): {same}")
    phase(f"phase 15 took {time.perf_counter() - phase_start:.1f} s")
    return {"rk45": b1, "radau": b2, "solve": solve_rec, "cli": cli_rec}, checks


def plain_worker(job_path: str, out_path: str) -> None:
    """A job of the pool (PlainPool): runs the plain version that ``job_path``
    names (torch.save of {"fn": "module:function", "args": (...), "against":
    None or "module:function"}, its tensors on the card) and saves {"out":
    its result, "ms": its time by CUDA events} to ``out_path``; with
    ``against``, "out" is radau_diff of that kernel's result on the same
    args against the plain version's."""
    import importlib

    def load(path):
        module, name = path.split(":")
        return getattr(importlib.import_module(module), name)

    with torch.inference_mode():
        job = torch.load(job_path, weights_only=False)
        out, ms = timed(lambda: load(job["fn"])(*job["args"]))
        if job["against"]:
            out = radau_diff(load(job["against"])(*job["args"]), out)
    torch.save({"out": out, "ms": ms}, out_path)
    del job, out
    torch.cuda.empty_cache()  # a pool's process keeps no GBs of one job for the next


class PlainPool:
    """SIDE_BY_SIDE worker processes that run plain versions side by side
    (plain_worker), started once, at the script's start, while the kernels
    build, so that no check pays a process's ~10 s to reach the card.  The
    plain versions are host-bound (thousands of small launches, each paid
    in Python), so they run side by side only in processes: worker threads
    of one process wait on each other for the GIL (PERF.md §6).  The main
    process launches nothing while the pool runs (``run`` waits), so the
    kernels' times are taken on an idle card."""

    def __init__(self, workers: int):
        import os
        import sys
        import tempfile

        self.tmp = tempfile.mkdtemp(prefix="tiger_plain_")
        here = os.path.dirname(os.path.abspath(__file__))
        self.procs = []
        for i in range(workers):
            with open(os.path.join(self.tmp, f"worker{i}.log"), "w") as log:
                self.procs.append((subprocess.Popen(
                    [sys.executable, "-c", "import chip_smoke; chip_smoke.pool_worker()"], cwd=here,
                    stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT, text=True),
                    log.name))
        self.jobs = 0

    def run(self, jobs: dict) -> dict:
        """Runs each job of ``jobs`` (name: ("module:function", args,
        against), the args' tensors on the card; plain_worker) in the
        order given, the next on the first process free; returns {name:
        (result, ms)}, the results on the card.  A job that fails fails the
        run, with its traceback."""
        import os

        pending, running, results = list(jobs.items()), {}, {}
        while pending or running:
            for proc, _ in self.procs:
                if pending and proc not in running:
                    name, (fn, args, against) = pending.pop(0)
                    stem = os.path.join(self.tmp, str(self.jobs))
                    self.jobs += 1
                    torch.save({"fn": fn, "args": args, "against": against}, stem + ".job")
                    proc.stdin.write(stem + "\n")
                    proc.stdin.flush()
                    running[proc] = (name, stem)
            time.sleep(0.02)
            for proc, log in self.procs:
                if proc not in running:
                    continue
                name, stem = running[proc]
                if os.path.exists(stem + ".done"):
                    with open(stem + ".done") as f:
                        answer = f.read()
                    check(answer == "ok", f"the plain check {name} failed in its process:\n{answer}")
                    got = torch.load(stem + ".out", weights_only=False)
                    for ext in (".job", ".out", ".done"):
                        os.remove(stem + ext)
                    results[name] = (got["out"], got["ms"])
                    del running[proc]
                elif proc.poll() is not None:
                    with open(log) as f:
                        check(False, f"the pool's process running {name} ended ({proc.returncode}):"
                                     f"\n{f.read()[-4000:]}")
        return results

    def close(self) -> None:
        import shutil

        for proc, _ in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def pool_worker() -> None:
    """A PlainPool process: reaches the card, then runs plain_worker on each
    stem read from stdin (its .job into its .out) and writes "ok", or the
    error's traceback, into its .done."""
    import os
    import sys
    import traceback

    torch.ones(1, device="cuda")
    for line in sys.stdin:
        stem = line.strip()
        try:
            plain_worker(stem + ".job", stem + ".out")
            answer = "ok"
        except Exception:  # reported to the main process, which fails the run
            answer = traceback.format_exc()
        with open(stem + ".tmp", "w") as f:
            f.write(answer)
        os.replace(stem + ".tmp", stem + ".done")


#: The pool of main's run (PlainPool); None outside it.
POOL: PlainPool | None = None


def side_by_side(jobs: dict, inline: bool = False) -> dict:
    """Runs ``jobs`` on the pool: {name: (result, ms)} (PlainPool.run);
    ``inline``: one after another in this process instead (results of GBs,
    which would cross to the pool and back through files)."""
    if not inline:
        return POOL.run(jobs)
    import importlib

    def load(path):
        module, name = path.split(":")
        return getattr(importlib.import_module(module), name)

    return {name: timed(lambda: load(fn)(*args)) for name, (fn, args, _) in jobs.items()}


def plain_span_checks(smi: str, checks: dict) -> float:
    """The plain Radau checks that would take minutes, side by side
    (side_by_side: the pool's SIDE_BY_SIDE processes): phase 6's over
    its full 2 days, 13d's and 13e's over their whole 5 minutes, and the
    others over one leading span, the longest of F64_SPANS whose predicted
    time keeps the script inside F64_BUDGET_S (or, where none does, the
    longest that adds nothing to the others).  ``checks`` holds SpanChecks
    by name: phase 6's (B2 against radau_plain on the main path's stiff
    systems), phase 9b's (B2 embedded3 at rtol 1e-6 on the systems
    compensated B1 flags), 10b's (B2 embedded3/f64 on the systems 10a
    flags), each kernel against radau_plain, phase 11's check 2 for each
    option set of CHECK_2_SETS, 12d's (B2 m200/embedded3 on 128 of its
    systems), 13d's (B2 dummy/embedded3 and dummy/embedded3/f64 on 128 of
    theirs), and 13e's (every B2 Dummy instance on all 131,072 systems,
    compared in its process).  The prediction takes PLAIN_RADAU_MS an attempt of
    each check's worst system, SIDE_BY_SIDE_SLOWER times as long side by
    side as alone, and PROCESS_START_S to hand the jobs over: the longest
    check or the sum over SIDE_BY_SIDE, whichever is longer.  Each check
    records the plain ms an attempt it measured, side by side.  Returns the
    wall of the checks."""
    left_s = F64_BUDGET_S - (time.perf_counter() - _T0)

    def at(c, span):  # the span a check takes when the shared span is ``span``
        return span if c.spans == F64_SPANS else c.spans[0]

    def alone(c, span):  # its predicted seconds alone
        return c.worst[at(c, span)] * PLAIN_RADAU_MS * 1e-3

    def predict(span):
        each = [alone(c, span) for c in checks.values()]
        return PROCESS_START_S + SIDE_BY_SIDE_SLOWER * max(max(each), sum(each) / SIDE_BY_SIDE)

    # The longest span that fits; else the longest that costs nothing over
    # the checks that do not take the shared span (phase 6's 2 days, 13d's).
    fixed = predict(F64_SPANS[-1])
    span = next((x for x in F64_SPANS if predict(x) * F64_MARGIN <= left_s), None)
    span = span or next((x for x in F64_SPANS if predict(x) <= fixed))
    phase(f"phase 6/9b/10b/11/12/13/15 span: worst system's attempts by leading span (min) "
          f"{ {k: c.worst for k, c in checks.items()} }, {left_s:.1f} s left of F64_BUDGET_S "
          f"{F64_BUDGET_S:g}: the shared span is the first {span:g} min, {len(checks)} checks in "
          f"processes, {SIDE_BY_SIDE} at a time (predicted {predict(span):.1f} s at PLAIN_RADAU_MS "
          f"{PLAIN_RADAU_MS:g}, SIDE_BY_SIDE_SLOWER {SIDE_BY_SIDE_SLOWER:g}, PROCESS_START_S "
          f"{PROCESS_START_S:g})")
    start = time.perf_counter()
    torch.cuda.empty_cache()  # the processes' room on the card
    # Longest first, so that the last to start are the shortest.
    order = sorted(checks, key=lambda k: -alone(checks[k], span))
    plain = side_by_side({k: checks[k].plain(at(checks[k], span)) for k in order})
    wall = time.perf_counter() - start
    plain_s = 0.0
    for key, c in checks.items():
        (ref, plain_ms), (ker, ms) = plain[key], c.run(at(c, span))
        plain_s += plain_ms * 1e-3
        err = c.compare(at(c, span), ker, ref)
        worst = max(c.worst[at(c, span)], 1)
        c.record.update({c.prefix + k: v for k, v in dict(
            check_span_min=at(c, span), check_span_ms=ms, plain_ms=plain_ms, max_abs_err=err,
            plain_ms_per_attempt=plain_ms / worst, plain_side_by_side=SIDE_BY_SIDE).items()})
        phase(f"phase {key} over the first {at(c, span):g} of {max(c.spans):g} min: kernels {ms:.3f} "
              f"ms vs plain {plain_ms:.3f} ms ({plain_ms / worst:.2f} ms an attempt of the worst "
              f"system, side by side), max_abs_err {err:.3e} | {smi}")
    phase(f"phase 6/9b/10b/11/12/13/15 plain checks side by side: wall {wall:.1f} s (the processes' "
          f"start included) for {plain_s:.1f} s of plain runs, shared span {span:g} min | {smi}")
    return wall


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    global POOL
    POOL = PlainPool(SIDE_BY_SIDE)  # its processes reach the card while the kernels build

    from concurrent.futures import ThreadPoolExecutor

    from tiger_tpu_torch import Model204, SolverConfig, solve
    from tiger_tpu_torch.kernels import _build, launch_totals, reset_launch_counts
    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.scenario import STIFF_HU, scenario
    from tiger_tpu_torch.solver.controller import initial_step

    dev = torch.device("cuda", 0)
    model = Model204()
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    tf = DAYS * 1440.0

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(smi)
    phase(f"phase 1 device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # 2. build
    with ThreadPoolExecutor(max_workers=2) as pool:  # every nvcc at once, side by side
        probed_build = pool.submit(_build.build, k_rk45.PROBE_FLAGS)
        libm_build = pool.submit(_build.build_libm_check)
        lib_path, build_s, log = _build.build()
        probed_s, libm_s = probed_build.result()[1], libm_build.result()[1]
    _build.load()
    phase(f"phase 2 build: {build_s:.1f} s nvcc ({'fresh' if build_s else 'cached'}), {lib_path.name}; "
          f"the probed build {probed_s:.1f} s and phase 12a's libm_check.cu {libm_s:.1f} s beside it")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"  ptxas: {line.strip()}")

    def inputs(s_count):
        y0, params, forc = scenario(s_count, DAYS, STIFF_FRAC, device=dev)
        qt = torch.arange(0.0, tf + 1e-9, 60.0, dtype=torch.float32, device=dev)
        h0 = initial_step(model, y0, 0.0, params, forc, cfg)
        return y0, params, forc, qt, h0

    def subset(rows, y0, params, forc, h0):
        return (y0[rows].contiguous(), {k: v[rows].contiguous() for k, v in params.items()},
                forc.take_systems(rows), h0[rows].contiguous())

    # 3. B1 against rk45_plain
    y0, params, forc, qt, h0 = inputs(CHECK_SYSTEMS)
    hu_rows = params["Hu"] < STIFF_HU * 10
    ker = k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, tf, qt, params, forc, cfg)
    torch.cuda.synchronize()
    check_rk45(f"phase 3 B1 vs rk45_plain ({CHECK_SYSTEMS} systems, {DAYS:g} days)",
               ker, ref, hu_rows)

    # 4. B2 against radau_plain on the systems B1 flagged
    rows = torch.nonzero(ker.stiff).squeeze(1)
    check(rows.numel() > 0, "phase 3 flagged no system")
    sy0, sp, sf, sh0 = subset(rows, y0, params, forc, h0)
    rker = k_radau.radau(model, sy0, sh0, 0.0, tf, qt, sp, sf, cfg)
    rref = k_radau.radau_plain(model, sy0, sh0, 0.0, tf, qt, sp, sf, cfg)
    torch.cuda.synchronize()
    check_radau(f"phase 4 B2 vs radau_plain ({rows.numel()} flagged systems, {DAYS:g} days)",
                rker, rref)

    # 5. solve() on the same systems against the plain versions' results,
    # merged as the two-phase solve merges them ...
    res = solve(model, y0, 0.0, tf, qt, params, forc, cfg)
    want_y, want_d = ref.y_final.clone(), ref.dense.clone()
    want_y[rows], want_d[rows] = rref.y_final, rref.dense
    same = ker.stiff == ref.stiff
    n_far = n_outside(res.y_final[same], want_y[same]) + n_outside(res.dense[same], want_d[same])
    phase(f"phase 5 solve() vs plain versions ({CHECK_SYSTEMS} systems): n_stiff {res.n_stiff}, "
          f"n_failed {int(res.failed.sum())}, entries outside rtol {RTOL:g}/atol {ATOL:g}: {n_far}")
    check(res.n_stiff == rows.numel() and not bool(res.failed.any()),
          f"solve() flagged {res.n_stiff} systems, failed {int(res.failed.sum())}")
    check(n_far == 0, "solve() disagrees with the plain versions")

    # ... then the main path.
    y0, params, forc, qt, h0 = inputs(MAIN_SYSTEMS)
    hu_rows = params["Hu"] < STIFF_HU * 10
    torch.cuda.synchronize()
    reset_launch_counts()
    res = solve(model, y0, 0.0, tf, qt, params, forc, cfg)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for i in range(1, 4):
        start = time.perf_counter()
        res = solve(model, y0 + i * 1e-7, 0.0, tf, qt, params, forc, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    launches = launch_totals()
    rk_att = int(res.rk_stats.n_attempts.sum())
    rd_att = 0 if res.radau_stats is None else int(res.radau_stats.n_attempts.sum())
    wall = sorted(walls)[1]
    n_failed = int(res.failed.sum())
    phase(f"phase 5 main path ({MAIN_SYSTEMS} systems, {DAYS:g} days, {qt.numel()} queries): "
          f"{(rk_att + rd_att) / wall:.6e} system-steps/s, wall median {wall:.6f} s "
          f"(min {min(walls):.6f}, max {max(walls):.6f}), n_stiff {res.n_stiff}, "
          f"rk attempts {rk_att}, radau attempts {rd_att}, n_failed {n_failed}, "
          f"launches {launches} | {smi}")
    check(launches["rk45"] > 0 and launches["radau"] > 0, f"a kernel was not launched: {launches}")
    check(n_failed == 0, f"{n_failed} systems failed")
    check(bool(res.stiff[hu_rows].all()), "a Hu=1e-6 row was not flagged stiff")
    check(bool(torch.isfinite(res.y_final).all()), "non-finite y_final")
    check(tuple(res.dense.shape) == (MAIN_SYSTEMS, qt.numel(), 5), f"dense shape {tuple(res.dense.shape)}")

    # 6. kernel against plain at the main-path shapes: times and checks
    ker, ms_b1 = timed(lambda: k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg), reps=3)
    ref, plain_b1 = timed(lambda: k_rk45.rk45_plain(model, y0, h0, 0.0, tf, qt, params, forc, cfg))
    err_b1 = check_rk45(f"phase 6 B1 vs rk45_plain ({MAIN_SYSTEMS} systems, {DAYS:g} days)",
                        ker, ref, hu_rows)
    rows = torch.nonzero(ker.stiff).squeeze(1)  # the warm-up solve's stiff subset
    sy0, sp, sf, sh0 = subset(rows, y0, params, forc, h0)
    rker, ms_b2 = timed(lambda: k_radau.radau(model, sy0, sh0, 0.0, tf, qt, sp, sf, cfg), reps=3)
    # Its check against radau_plain over the full 2 days runs at the end,
    # side by side with the shared span's (plain_span_checks).
    b2_rec = {}
    check_6 = radau_span_check(f"phase 6 B2 vs radau_plain ({rows.numel()} systems",
                               int(rker.stats.n_attempts.max()), model, sy0, sh0, sp, sf, qt, cfg,
                               b2_rec, spans=(tf,))
    # B1's tail: the systems that took it the most attempts, alone.
    top = torch.topk(ker.stats.n_attempts, TAIL_SYSTEMS).indices
    ty0, tp, tforc, th0 = subset(top, y0, params, forc, h0)
    _, tail_b1 = timed(lambda: k_rk45.rk45(model, ty0, th0, 0.0, tf, qt, tp, tforc, cfg), reps=3)
    # B1's lane efficiency, counted by the probed build on the same inputs
    # (a launch made to measure: taken after the main path's counts were read).
    geo = k_rk45.rk45_geometry(MAIN_SYSTEMS)
    with _build.flags_in_use(k_rk45.PROBE_FLAGS):
        probed = k_rk45.rk45(model, y0, h0, 0.0, tf, qt, params, forc, cfg)
        records = k_rk45.read_probes(geo["blocks"] * geo["threads"] // 32)
    check(not any(k_rk45.rk45_mismatch(probed, ker).values()), "the probed build of B1 differs")
    lane_eff = k_rk45.lane_efficiency(records)

    # Bounds, from this run's counters.
    n_rows, n_q, n_q_after = forc.data.shape[0], qt.numel(), int((qt > 0.0).sum())
    att_b1, worst_b1 = int(ker.stats.n_attempts.sum()), int(ker.stats.n_attempts.max())
    att_b2, worst_b2 = int(rker.stats.n_attempts.sum()), int(rker.stats.n_attempts.max())
    swp_b2 = int(rker.stats.n_newton.sum())
    bound_b1 = bound(b1_ops(att_b1, int((~ker.stiff).sum()) * n_q_after),
                     io_bytes(MAIN_SYSTEMS, n_rows, n_q, 5))
    bound_b2 = bound(b2_ops(att_b2, swp_b2, rows.numel() * n_q_after),
                     io_bytes(rows.numel(), n_rows, n_q, 6))
    phase(f"phase 6 times: B1 {ms_b1:.3f} ms vs rk45_plain {plain_b1:.3f} ms, bound "
          f"{bound_b1[0]:.4f} ms ({bound_b1[1]}), worst system {worst_b1} attempts "
          f"({MAIN_SYSTEMS} systems, {DAYS:g} days), lane efficiency {lane_eff:.4f}, geometry {geo}; "
          f"B1 on its {TAIL_SYSTEMS} slowest systems {tail_b1:.3f} ms; B2 {ms_b2:.3f} ms (radau_plain at the end), bound "
          f"{bound_b2[0]:.4f} ms ({bound_b2[1]}), worst system {worst_b2} attempts, "
          f"{1e3 * ms_b2 / worst_b2:.3f} us per attempt of the worst system, "
          f"{swp_b2 / att_b2:.4f} sweeps per attempt ({rows.numel()} systems, {DAYS:g} days) | {smi}")

    # 7. the CLI at full width (its own launch counts)
    cli_launches = cli_phase(smi)

    # 8. the windowed CLI at full width (its own launch counts)
    windowed_launches = windowed_phase(smi)

    # 9. the solver options (their own launch counts)
    instances, check_c = options_phase(smi)

    # 10. float64 (its own launch counts): the default set's double
    # instances, then (f) the other sets', and (g) the CLI with PI in f64
    doubles, check_b = float64_phase(smi)
    instances["rk45"]["default/f64"] = doubles["rk45"]
    instances["radau"]["embedded3/f64"] = doubles["radau"]
    for inst, rec in doubles_phase(smi).items():
        instances["rk45" if inst.split("/")[0] in B1_OPTIONS else "radau"][inst] = rec
    cli_pi_launches = cli_pi_phase(smi)

    # 11. the float64 retry of B2's failures (its own launch counts), then
    # the plain Radau checks of phases 10b and 11 over one leading span
    failing = [n for n, r in instances["radau"].items() if r.get("main_path_failed_f32")]
    retry, checks_2 = retry_phase(smi, failing)
    check(set(checks_2) == set(CHECK_2_SETS),
          f"phase 11: of {CHECK_2_SETS} only {sorted(checks_2)} failed systems in float32 ({failing})")

    # 12. Model 200 in both kernels (its own launch counts): 12a its libm
    # calls, then the model phases; 13. DummyModel through the same model
    # phases.  Then the plain Radau checks of phases 9b, 10b, 11, 12d and
    # 13d, side by side over one leading span.
    libm = libm_phase(smi)
    m200, checks_12 = model_phase(M200, smi)
    dummy, checks_13 = model_phase(DUMMY, smi)
    for kernel in ("rk45", "radau"):
        instances[kernel].update(m200[kernel])
        instances[kernel].update(dummy[kernel])

    # 14. several processes: solve() over two devices, two rank processes
    # of the CLI on the card (gloo), one nccl process (its own launch counts)
    dist_launches = dist_phase(smi, model, cfg, (y0 + 3 * 1e-7, params, forc, qt), res)

    # 15. the TPU kernels' last options: B1's lockstep query crossing and
    # bf16 forcing, B2's factor reuse (their own launch counts)
    last, checks_15 = last_options_phase(
        smi, model, cfg, (y0, params, forc, qt, h0), (rows, sy0, sp, sf, sh0),
        {"rk45": ms_b1, "radau": ms_b2, "m200_radau": instances["radau"]["m200/embedded3"].get("ms")})
    for kernel in ("rk45", "radau"):
        instances[kernel].update(last[kernel])

    end_wall = plain_span_checks(smi, {"6": check_6, "9b": check_c, "10b": check_b,
                                       **{f"11 {name}": c for name, c in checks_2.items()},
                                       **checks_12, **checks_13, **checks_15})
    total = time.perf_counter() - _T0
    phase(f"fixed part {total - end_wall:.1f} s: the script's {total:.1f} s less the end's side-by-side "
          f"wall {end_wall:.1f} s; phase 6's rk45_plain took {plain_b1 * 1e-3:.1f} s (how fast this host "
          f"is) | {smi}")

    say(json.dumps({"kernels": [
        {"name": "rk45", "route": "cuda", "source": "tiger_tpu_torch/kernels/csrc/rk45.cu",
         "replaces": "tiger_tpu/kernels/rk45_pallas.py:1051", "launches": launches["rk45"],
         "max_abs_err": err_b1, "ms": ms_b1, "plain_ms": plain_b1, "bound_ms": bound_b1[0],
         "bound_by": bound_b1[1], "library_ms": None, "worst_system_attempts": worst_b1,
         "tail_systems": TAIL_SYSTEMS, "tail_ms": tail_b1, "lane_efficiency": lane_eff,
         "geometry": geo, "cli_launches": cli_launches["rk45"],
         "windowed_launches": windowed_launches["rk45"], "cli_pi_launches": cli_pi_launches["rk45"],
         "dist_launches": dist_launches["rk45"], "instances": instances["rk45"],
         "option_launches": last["solve"]["option_launches"]},
        {"name": "radau", "route": "cuda", "source": "tiger_tpu_torch/kernels/csrc/radau.cu",
         "replaces": "tiger_tpu/kernels/radau_pallas.py:987", "launches": launches["radau"],
         "max_abs_err": b2_rec["max_abs_err"], "ms": ms_b2, "plain_ms": b2_rec["plain_ms"],
         "plain_measured_side_by_side": SIDE_BY_SIDE, "bound_ms": bound_b2[0],
         "bound_by": bound_b2[1], "library_ms": None, "worst_system_attempts": worst_b2,
         "sweeps_per_attempt": swp_b2 / att_b2, "cli_launches": cli_launches["radau"],
         "windowed_launches": windowed_launches["radau"], "dist_launches": dist_launches["radau"],
         "instances": instances["radau"],
         "retry": retry, "model200_solve": m200["solve"], "model200_libm": libm,
         "dummy_solve": dummy["solve"],
         "every_option_solve": last["solve"], "bf16_cli": last["cli"]},
    ]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        # No autograd anywhere: inference mode spares every op its
        # bookkeeping (the plain versions are thousands of small ops).
        with torch.inference_mode():
            main()
    finally:
        if POOL is not None:
            POOL.close()
        if "folder" in _BASIN:
            import shutil

            shutil.rmtree(_BASIN["folder"], ignore_errors=True)
