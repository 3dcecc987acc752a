#!/usr/bin/env python3
"""Smoke run of tiger_tpu_torch on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each (any failed check raises, so the exit code is not 0):
  1. device: nvidia-smi's name and power limit; refuses to run without CUDA;
  2. build: both CUDA kernels from tiger_tpu_torch/kernels/csrc with nvcc,
     and beside it the build with B1's probes (-DTT_RK45_PHASES);
  3. B1 (rk45.cu) against rk45_plain on the card: 4,096 systems, 2 days;
  4. B2 (radau.cu) against radau_plain on the systems phase 3 flagged;
  5. solve() on those 4,096 systems against phases 3-4's plain results, then
     the main path: solve() at 131,072 systems, 2 days, 49 hourly queries,
     rtol 1e-5 / atol 1e-8, 0.1% stiff systems -- one warm-up and 3 timed
     runs, with the launch counters set to 0 just before;
  6. each kernel against its plain version at the main-path shapes: B1 over
     the 131,072 systems, B2 over the systems B1 flagged, the full span; the
     times side by side, and phases 3-4's checks on the results.  Then B1
     alone on the 32 systems that took it the most attempts (its tail), B1's
     lane efficiency counted by the probed build (attempts over 32 x warp
     trips through the attempt loop), and each kernel's bound: the least time
     the card could take for this run's operations and bytes.
Each kernel must equal its plain version exactly: max_abs_err 0, NaN in the
same places, every flag and every counter of every system equal.  The line
before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

MAIN_SYSTEMS = 131_072
DAYS = 2.0
STIFF_FRAC = 0.001
CHECK_SYSTEMS = 4096
# solve() against the plain versions' merged results (phase 5).  The kernels
# themselves are held to their plain versions exactly.
RTOL, ATOL = 1e-3, 1e-6
TAIL_SYSTEMS = 32  # one warp of B1's slowest systems

# The bound of each kernel: its operations over the H100 SXM's float32 peak
# outside the tensor cores, or its bytes (each input read once, each output
# written once) over the HBM3 rate, whichever takes longer.
F32_PEAK, HBM_RATE = 67e12, 3.35e12
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


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of work that does ``ops`` operations and moves
    ``nbytes`` bytes."""
    ops_ms, bytes_ms = ops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def io_bytes(s_count: int, n_rows: int, n_q: int, out_words: int) -> int:
    """Bytes of one launch over ``s_count`` systems: y0, h0, params, the
    ``n_rows`` forcing rows and the queries in; y_final, dense and
    ``out_words`` flag and counter words a system out (all 4 bytes a word)."""
    return 4 * (s_count * (5 + 1 + 15 + n_rows) + n_q + s_count * (5 + 5 * n_q + out_words))


def b1_ops(attempts: int, queries: int) -> int:
    """B1's operations (rk45.cu): per attempt, seven right-hand sides, the
    stage, update and error sums (11 per nonzero tableau entry), the error norm
    (40), the slope-jump test (15), the controller, stiffness tests and Kahan t
    (57); per dense query, the quartic coefficients (10 per nonzero entry of
    DP_P, at most once a query) and the polynomial (58)."""
    from tiger_tpu_torch.solver import tableau

    def nnz(x) -> int:
        return int((x != 0).sum())

    per_attempt = (7 * RHS_OPS + 11 * (nnz(tableau.DP_A) + nnz(tableau.DP_B) + nnz(tableau.DP_E))
                   + 40 + 15 + 57 + STEP_OPS)
    return attempts * per_attempt + queries * (10 * nnz(tableau.DP_P) + 58)


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


def check_radau(label, ker, ref) -> float:
    """Phases 4 and 6: B2 equals radau_plain bit for bit; returns max_abs_err."""
    err = max(max_abs(ker.y_final, ref.y_final), max_abs(ker.dense, ref.dense))
    n_sys = ker.failed.numel()
    same = [int((a == b).sum()) for a, b in zip(ker.stats, ref.stats)]
    att_k, att_p = int(ker.stats.n_attempts.sum()), int(ref.stats.n_attempts.sum())
    phase(f"{label}: max_abs_err={err:.3e}, failed {int(ker.failed.sum())}/{int(ref.failed.sum())}, "
          f"systems with equal (accepted, rejected, attempts, sweeps, factorizations) {same} of "
          f"{n_sys}, attempts {att_k} vs {att_p}, sweeps {int(ker.stats.n_newton.sum())}, worst "
          f"system {int(ker.stats.n_attempts.max())} vs {int(ref.stats.n_attempts.max())}")
    check(not bool(ker.failed.any() or ref.failed.any()), f"{label}: a Radau solve failed")
    check(err == 0.0, f"{label}: B2 differs from radau_plain by {err:.3e}")
    check(all(n == n_sys for n in same), f"{label}: B2's counters differ from radau_plain's")
    return err


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")

    from concurrent.futures import ThreadPoolExecutor

    from tiger_tpu_torch import Model204, SolverConfig, solve
    from tiger_tpu_torch.kernels import _build
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
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc each, side by side
        probed_build = pool.submit(_build.build, k_rk45.PROBE_FLAGS)
        lib_path, build_s, log = _build.build()
        probed_s = probed_build.result()[1]
    _build.load()
    phase(f"phase 2 build: {build_s:.1f} s nvcc ({'fresh' if build_s else 'cached'}), {lib_path.name}; "
          f"the probed build {probed_s:.1f} s beside it")
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
    k_rk45.rk45_launches = 0
    k_radau.radau_launches = 0
    res = solve(model, y0, 0.0, tf, qt, params, forc, cfg)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for i in range(1, 4):
        start = time.perf_counter()
        res = solve(model, y0 + i * 1e-7, 0.0, tf, qt, params, forc, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    launches = {"rk45": k_rk45.rk45_launches, "radau": k_radau.radau_launches}
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
    rref, plain_b2 = timed(lambda: k_radau.radau_plain(model, sy0, sh0, 0.0, tf, qt, sp, sf, cfg))
    err_b2 = check_radau(f"phase 6 B2 vs radau_plain ({rows.numel()} systems, {DAYS:g} days)",
                         rker, rref)
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
    bound_b2 = bound(att_b2 * B2_ATTEMPT_OPS + swp_b2 * B2_SWEEP_OPS
                     + rows.numel() * n_q_after * B2_QUERY_OPS,
                     io_bytes(rows.numel(), n_rows, n_q, 6))
    phase(f"phase 6 times: B1 {ms_b1:.3f} ms vs rk45_plain {plain_b1:.3f} ms, bound "
          f"{bound_b1[0]:.4f} ms ({bound_b1[1]}), worst system {worst_b1} attempts "
          f"({MAIN_SYSTEMS} systems, {DAYS:g} days), lane efficiency {lane_eff:.4f}, geometry {geo}; "
          f"B1 on its {TAIL_SYSTEMS} slowest systems {tail_b1:.3f} ms; B2 {ms_b2:.3f} ms vs radau_plain {plain_b2:.3f} ms, bound "
          f"{bound_b2[0]:.4f} ms ({bound_b2[1]}), worst system {worst_b2} attempts, "
          f"{1e3 * ms_b2 / worst_b2:.3f} us per attempt of the worst system, "
          f"{swp_b2 / att_b2:.4f} sweeps per attempt ({rows.numel()} systems, {DAYS:g} days) | {smi}")

    say(json.dumps({"kernels": [
        {"name": "rk45", "route": "cuda", "source": "tiger_tpu_torch/kernels/csrc/rk45.cu",
         "replaces": "tiger_tpu/kernels/rk45_pallas.py:1051", "launches": launches["rk45"],
         "max_abs_err": err_b1, "ms": ms_b1, "plain_ms": plain_b1, "bound_ms": bound_b1[0],
         "bound_by": bound_b1[1], "library_ms": None, "worst_system_attempts": worst_b1,
         "tail_systems": TAIL_SYSTEMS, "tail_ms": tail_b1, "lane_efficiency": lane_eff,
         "geometry": geo},
        {"name": "radau", "route": "cuda", "source": "tiger_tpu_torch/kernels/csrc/radau.cu",
         "replaces": "tiger_tpu/kernels/radau_pallas.py:987", "launches": launches["radau"],
         "max_abs_err": err_b2, "ms": ms_b2, "plain_ms": plain_b2, "bound_ms": bound_b2[0],
         "bound_by": bound_b2[1], "library_ms": None, "worst_system_attempts": worst_b2,
         "sweeps_per_attempt": swp_b2 / att_b2},
    ]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
