"""The check: a run of the program passes, the control and planted faults fail.

Each run is the rest of a benchmark run (``run.run_cell``) on the CPU at a
size a test can hold (``_tiny.tiny_cell``: a few dozen links in the cell's
own windows), held to the limits of each cell of ``BENCHMARK.json``; a fault
replaces the program's entry by one that breaks its answer.  The program
runs as it stands.  (~25 s on 4 workers)
"""

import dataclasses
import math

import _bench_path  # noqa: F401
import numpy as np
import pytest
import torch
from _tiny import tiny_cell

import run
from harness import check, reference, spec
from harness.stream import CheckPlan

SEED = 3_141_592_653


def correct(cell, **kw):
    result, info = run.run_cell(cell, SEED, 0.5, False, device="cpu", **kw)
    return result["correct"], info["numbers"]


CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    ok, numbers = correct(tiny_cell(cell))
    assert ok, numbers


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    ok, numbers = correct(tiny_cell(cell, links=64, random_rows=24), control=True)
    assert not ok, numbers


def test_bf16_control_reads_far_above_the_float32_program():
    """The float32 configuration's control (the reference kept in bfloat16),
    which the float32 cells waiting in PERF.md use, against the float32
    program on the same tiny cell."""
    cell = tiny_cell(links=64, random_rows=24)
    cell.config = spec.load_json(spec.BENCH_DIR / "configs" / "m204_fast_f32.json")
    _, program = correct(cell)
    _, control = correct(cell, control=True)
    for store in ("grav", "aquifer", "surface"):
        assert program[f"plain_{store}_err"] < 20 < 100 < control[f"plain_{store}_err"]


def program_solve(*args, **kw):
    import tiger_tpu_torch

    return tiger_tpu_torch.solve(*args, **kw)


def unchanged(model, y0, t0, tf, qt, *args, **kw):
    res = program_solve(model, y0, t0, tf, qt, *args, **kw)
    return res._replace(y_final=y0.clone(), dense=y0[:, None, :].expand(-1, qt.numel(), -1).clone())


def half_left_out(model, y0, t0, tf, qt, *args, **kw):
    res = program_solve(model, y0, t0, tf, qt, *args, **kw)
    half = y0.shape[0] // 2
    res.y_final[half:] = y0[half:]
    res.dense[half:] = y0[half:, None, :]
    return res


def answer_altered(*args, **kw):
    """The last query's answers handed out in reverse order of the systems."""
    res = program_solve(*args, **kw)
    res.dense[:, -1] = res.dense[:, -1].flip(0)
    return res


def stiff_answers_dropped(*args, **kw):
    res = program_solve(*args, **kw)
    res.y_final[res.stiff] = float("nan")
    res.dense[res.stiff] = float("nan")
    return res


def hot_b2_answers_dropped(model, y0, t0, tf, qt, params, forcing, config, t_shift=0.0, **kw):
    """From window 1 on, B1 hands rows to B2 (a stiffness test that trips at
    once) and B2's answers are dropped; window 0 is the program's own."""
    if not t_shift:
        return program_solve(model, y0, t0, tf, qt, params, forcing, config, t_shift=t_shift, **kw)
    eager = dataclasses.replace(config, stiff_hlamb=1e-6, stiff_streak=1, stiff_test_every=1)
    res = program_solve(model, y0, t0, tf, qt, params, forcing, eager, t_shift=t_shift, **kw)
    assert bool(res.stiff.any())
    res.y_final[res.stiff] = float("nan")
    res.dense[res.stiff] = float("nan")
    return res


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered,
                                   stiff_answers_dropped, hot_b2_answers_dropped])
def test_fault_is_not_correct(cell, fault):
    ok, numbers = correct(tiny_cell(cell), solve=fault)
    assert not ok, numbers


def test_gaps_in_tolerance_units():
    ref = np.array([1.0, 0.0, 2.0])
    prog = np.array([1.00001, 1e-8, np.nan])
    g = check.gaps(prog, ref, rtol=1e-5, atol=1e-8)
    assert g[0] == pytest.approx(1e-5 / (1e-8 + 1e-5)) and g[1] == pytest.approx(1.0)
    assert math.isinf(g[2])
    assert check.judge({"a": 1.0, "failed": 0}, {"a": 2.0, "failed": 0})[0]
    assert not check.judge({"a": 3.0, "failed": 0}, {"a": 2.0, "failed": 0})[0]
    assert not check.judge({"failed": 0}, {"a": 2.0, "failed": 0})[0]
    assert not check.judge({"a": 1.0}, {})[0]


def test_checked_windows_are_a_seeded_reservoir():
    def kept(seed, n):
        plan = CheckPlan({"first_windows": 3, "sampled_windows": 2}, seed)
        live = set()
        for k in range(n):
            keep, dropped = plan.admit(k)
            live.discard(dropped)
            if keep:
                live.add(k)
        return sorted(live)

    a = kept(7, 40)
    assert a[:3] == [0, 1, 2] and len(a) == 5 and all(3 <= k < 40 for k in a[3:])
    assert kept(7, 40) == a
    assert kept(7, 2) == [0, 1]
    picks = [k for s in range(400) for k in kept(s, 23)[3:]]
    counts = np.bincount(picks, minlength=23)[3:]
    assert counts.min() > 15 and counts.max() < 65  # 40 a window expected


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 3.14159, -2.5e-7], np.float32)
    want = torch.tensor(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(reference.bf16(x), want)


def test_reference_is_far_below_the_tolerances():
    model = spec.load_module(spec.BENCH_DIR / "models" / "model204.py", "m204_ref_t")
    rng = np.random.default_rng(0)
    n = 8
    base = spec.load_json(spec.BENCH_DIR / "traffic" / "win2d_131k_stiff.json")["params"]["base"]
    params = {k: base[k] * rng.uniform(0.8, 1.2, n) for k in model.PARAM_FIELDS}
    params["Hu"][0] = 1e-6
    rain = rng.uniform(0, 0.0015, (6, n))
    temp = np.concatenate([rng.uniform(2, 10, (1, 1)), rng.uniform(-2, 10, (1, n - 1))], axis=1)
    y0 = np.tile(np.asarray(model.Y_COLD), (n, 1))
    q = np.arange(0.0, 361.0, 60.0)
    args = (model, y0, params, [rain, temp], [60.0, 1440.0], 360.0, q)
    dense, final, _ = reference.integrate(*args)
    tight, tight_final, _ = reference.integrate(*args, rtol=1e-12, atol=1e-16)
    assert check.gaps(dense, tight, 1e-6, 1e-9).max() < 0.05
    assert np.array_equal(dense[:, -1], final) and np.array_equal(dense[:, 0], y0)
    # The planted row's static store drains to its equilibrium, Hu (sqrt(5) - 1) / 2.
    assert final[0, 1] == pytest.approx(1e-6 * (math.sqrt(5) - 1) / 2, rel=0.05)
