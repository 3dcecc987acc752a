"""B1's plain version (the port's CPU path) against the JAX package's RK45.

Inputs: the synthetic Model-204 basin of ``__graft_entry__._scenario`` at 64
systems over 6 hours with two genuinely stiff rows (0 and 63), made once in
numpy and carried across with ``tiger_tpu_torch.convert``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _scenario
from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
from tiger_tpu.models import DummyModel as JDummyModel
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.solver.config import SolverConfig as JSolverConfig
from tiger_tpu.solver.rk45 import rk45_solve as j_rk45_solve
from tiger_tpu_torch import DummyModel, Model204, SolverConfig, convert
from tiger_tpu_torch.forcing import ZOH_SNAP
from tiger_tpu_torch.kernels.rk45 import rk45_mismatch, rk45_plain
from tiger_tpu_torch.solver import rk45_solve

S, DAYS, STIFF_FRAC = 64, 0.25, 2 / 64
TF = DAYS * 1440.0
CFG = dict(rtol=1e-5, atol=1e-8, max_steps=100_000)
STIFF_ROWS = [0, 63]


def _inputs(np_dtype):
    """(JAX inputs, port inputs on the CPU) of the same numpy arrays."""
    y0, p, f = _scenario(S, np_dtype, days=DAYS, stiff_frac=STIFF_FRAC)
    qt = np.arange(0.0, TF + 1e-9, 60.0, dtype=np_dtype)
    ours = convert.solver_inputs(
        np.asarray(y0), {k: np.asarray(v) for k, v in p.items()},
        np.asarray(f.data), f.meta, qt, device="cpu",
        dtype={np.float32: torch.float32, np.float64: torch.float64}[np_dtype],
    )
    return (y0, p, f, jnp.asarray(qt)), ours


def _run_port(ours):
    y0, p, f, qt = ours
    return rk45_solve(Model204(), y0, 0.0, TF, qt, p, f, config=SolverConfig(**CFG))


@pytest.fixture(scope="module")
def f64_pair():
    (y0, p, f, qt), ours = _inputs(np.float64)
    ref = j_rk45_solve(JModel204(), y0, 0.0, TF, qt, p, f, config=JSolverConfig(**CFG))
    return ref, _run_port(ours)


@pytest.fixture(scope="module")
def f32_pair():
    (y0, p, f, qt), ours = _inputs(np.float32)
    ref = rk45_solve_pallas(
        JModel204(), y0, 0.0, TF, qt, p, f, config=JSolverConfig(**CFG), interpret=True
    )
    return ref, _run_port(ours)


def test_f32_matches_float64_solution(f32_pair, f64_pair):
    """The port's float32 run lies within the solver's own error of the
    float64 solution (measured: 6.6e-5 relative at worst)."""
    _, ours = f32_pair
    ref64, _ = f64_pair
    ok = ~np.asarray(ref64.stiff)
    np.testing.assert_allclose(
        ours.dense.numpy()[ok], np.asarray(ref64.dense)[ok], rtol=1e-4, atol=1e-7
    )


def test_f64_same_step_sequence_as_vmap_rk45(f64_pair):
    ref, ours = f64_pair
    assert ours.y_final.dtype == torch.float64
    # The same per-system algorithm in the same arithmetic: every system
    # takes the same number of attempts, accepts and rejections.
    for name in ("n_attempts", "n_accepted", "n_rejected"):
        np.testing.assert_array_equal(
            getattr(ours.stats, name).numpy(), np.asarray(getattr(ref.stats, name)), name
        )
    np.testing.assert_array_equal(ours.stiff.numpy(), np.asarray(ref.stiff))
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    assert np.nonzero(ours.stiff.numpy())[0].tolist() == STIFF_ROWS
    # XLA may sum h0's five squares in another order: one ulp.
    np.testing.assert_allclose(ours.h0.numpy(), np.asarray(ref.h0), rtol=5e-16, atol=0)


def test_f64_trajectories_match_vmap_rk45(f64_pair):
    ref, ours = f64_pair
    # Same step sequence, so only float64 rounding separates the two: the
    # vmap path sums the stages as y + h*(b.k), the port (like the Pallas
    # kernel) as y + sum (h*b_s)*k_s.  rtol 1e-9; atol 1e-10 (1% of the
    # solver's atol) for states the ET drain shrinks ~100-fold within the
    # first hour, which keep the absolute rounding of their 3 m start
    # (measured: 3e-11 on h_static = 0.023).
    np.testing.assert_allclose(
        ours.y_final.numpy(), np.asarray(ref.y_final), rtol=1e-9, atol=1e-10
    )
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=1e-9, atol=1e-10)


def test_f32_matches_pallas_kernel(f32_pair):
    ref, ours = f32_pair
    assert ours.y_final.dtype == torch.float32 and ours.dense.shape == ref.dense.shape
    np.testing.assert_array_equal(ours.stiff.numpy(), np.asarray(ref.stiff))
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    # float32: torch's and XLA's exp2/log2 and fusions round differently, so
    # most systems take a step or two more or fewer and the two runs differ
    # by the solver's own error, not by rounding.  The Pallas kernel's float32
    # run is itself up to 3.2e-4 relative from the float64 solution here (the
    # port's: 6.6e-5, see above), so the two are held to 5e-4 relative.
    ok = ~ours.stiff.numpy()
    np.testing.assert_allclose(
        ours.y_final.numpy()[ok], np.asarray(ref.y_final)[ok], rtol=5e-4, atol=1e-7
    )
    np.testing.assert_allclose(
        ours.dense.numpy()[ok], np.asarray(ref.dense)[ok], rtol=5e-4, atol=1e-7
    )
    att, ref_att = ours.stats.n_attempts.numpy(), np.asarray(ref.stats.n_attempts)
    assert abs(int(att.sum()) - int(ref_att.sum())) <= 0.02 * ref_att.sum()


def test_dummy_model_golden_final_state():
    """The reference's golden end state of the 5-state linear test system."""
    qt = (np.arange(1, 10001) * 5.0) / 10001.0
    cfg = dict(fill_t0_queries=False)
    ref = j_rk45_solve(
        JDummyModel(), jnp.ones((4, 5)), 0.0, 5.0, jnp.asarray(qt), config=JSolverConfig(**cfg)
    )
    ours = rk45_solve(
        DummyModel(), torch.ones((4, 5), dtype=torch.float64), 0.0, 5.0,
        torch.tensor(qt, dtype=torch.float64), config=SolverConfig(**cfg),
    )
    golden = [1.91791, 1.90017, 2.39397, 1.71872, 3.06922]
    np.testing.assert_allclose(ours.y_final[0].numpy(), golden, rtol=5e-6)
    np.testing.assert_array_equal(
        ours.stats.n_attempts.numpy(), np.asarray(ref.stats.n_attempts)
    )
    np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final), rtol=1e-12)
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=1e-12, atol=1e-14)


def test_duplicate_queries_get_the_same_row():
    (_, _, _, _), (y0, p, f, qt) = _inputs(np.float64)
    dup = torch.repeat_interleave(qt, 2)
    one = rk45_solve(Model204(), y0[:4], 0.0, TF, qt, {k: v[:4] for k, v in p.items()},
                     f.take_systems(torch.arange(4)), config=SolverConfig(**CFG))
    two = rk45_solve(Model204(), y0[:4], 0.0, TF, dup, {k: v[:4] for k, v in p.items()},
                     f.take_systems(torch.arange(4)), config=SolverConfig(**CFG))
    assert torch.equal(two.dense[:, ::2], one.dense) and torch.equal(two.dense[:, 1::2], one.dense)
    with pytest.raises(ValueError, match="sorted"):
        rk45_solve(Model204(), y0, 0.0, TF, qt.flip(0), p, f, config=SolverConfig(**CFG))


OPTION_CASES = {
    "reference_parity": dict(
        h0_mode="global-zero-y0", fill_t0_queries=False, nan_shrink=1.0, max_rejects=5,
        stiff_detect=False, forcing_step_align=False,
    ),
    "tight_stiff_detect": dict(stiff_test_every=8, stiff_streak=3, stiff_forgive=2,
                               stiff_floor_streak=8, slope_jump_thresh=1e-3),
    "scalar_h0": dict(initial_step=0.5, min_scale=0.5, max_scale=4.0, safety=0.8),
    "step_capped": dict(max_steps=40),  # most systems stop short: failed/stiff, NaN y_final
    "compensated": dict(compensated=True),
    "pi_controller": dict(controller="pi"),
    "compensated_pi": dict(compensated=True, controller="pi"),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_f64_options_match_vmap_rk45(case):
    """Every supported SolverConfig option steers the plain version as it
    steers the reference: 16 systems over 2 hours, float64.  (The vmap path
    has no FSAL; test_f32_options_match_pallas_kernel holds it against the
    Pallas kernel.)"""
    cfg = dict(CFG, **OPTION_CASES[case])
    y0, p, f = _scenario(16, np.float64, days=2 / 24, stiff_frac=1 / 16)
    qt = np.arange(0.0, 120.0 + 1e-9, 15.0)
    ref = j_rk45_solve(JModel204(safe_pow=False), y0, 0.0, 120.0, jnp.asarray(qt), p, f,
                       config=JSolverConfig(**cfg))
    ty0, tp, tf_, tq = convert.solver_inputs(
        np.asarray(y0), {k: np.asarray(v) for k, v in p.items()}, np.asarray(f.data), f.meta,
        qt, device="cpu", dtype=torch.float64,
    )
    ours = rk45_solve(Model204(safe_pow=False), ty0, 0.0, 120.0, tq, tp, tf_,
                      config=SolverConfig(**cfg))
    np.testing.assert_array_equal(ours.stats.n_attempts.numpy(), np.asarray(ref.stats.n_attempts))
    np.testing.assert_array_equal(ours.stiff.numpy(), np.asarray(ref.stiff))
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    # As test_f64_trajectories_match_vmap_rk45.  Without step alignment a
    # step may start within rounding of an hour boundary and read either
    # hour's rain, which moves the snow store by ~1e-6 relative.
    rtol = 1e-9 if cfg.get("forcing_step_align", True) else 1e-5
    # The Kahan commit rounds its last bit otherwise than the vmap path's
    # y + h (b . k), and the static store's 100-fold drain in the first 15
    # minutes carries that into the dense rows: 1.25e-10 absolute on
    # h_static = 0.017 (measured), so 2% of the solver's atol there.
    atol_dense = 2e-10 if cfg.get("compensated") else 1e-10
    np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final), rtol=rtol, atol=1e-10)
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=rtol, atol=atol_dense)


def _to_f64(y0, p, f):
    """float64 copies of a JAX scenario for both packages: (JAX inputs,
    the port's inputs on the CPU) from the same numpy arrays."""
    y0_np = np.asarray(y0, np.float64)
    p_np = {k: np.asarray(v, np.float64) for k, v in p.items()}
    ours = convert.solver_inputs(y0_np, p_np, np.asarray(f.data), f.meta, None,
                                 device="cpu", dtype=torch.float64)
    return (jnp.asarray(y0_np), {k: jnp.asarray(v) for k, v in p_np.items()}, f), ours[:3]


def test_slope_cut_grinders_flag_as_in_vmap_rk45():
    """The grinder batch of tests/test_stiff_detect.py (numpy seed 0: Hu = 1e-6,
    warm forcing, h0 = 1e-6) drives B1's detector branch: slope cuts trip
    it without waiting for the cadence.  In float64 the plain version takes
    the reference's control flow exactly: equal stiff flags and equal
    accepted, rejected and attempted counts on every system, every system
    flagged, none after 500 attempts or more (the reference's own bound)."""
    from tests.test_stiff_detect import _grinder_batch

    (y0, p, f), (ty0, tp, tforc) = _to_f64(*_grinder_batch())
    cfg = dict(rtol=1e-5, atol=1e-8, max_steps=30_000, stiff_detect=True)
    ref = j_rk45_solve(JModel204(), y0, 0.0, 480.0, None, p, f,
                       h0=jnp.full((y0.shape[0],), 1e-6), config=JSolverConfig(**cfg))
    ours = rk45_solve(Model204(), ty0, 0.0, 480.0, None, tp, tforc,
                      h0=torch.full((ty0.shape[0],), 1e-6, dtype=torch.float64),
                      config=SolverConfig(**cfg))
    np.testing.assert_array_equal(ours.stiff.numpy(), np.asarray(ref.stiff))
    for name in ("n_attempts", "n_accepted", "n_rejected"):
        np.testing.assert_array_equal(
            getattr(ours.stats, name).numpy(), np.asarray(getattr(ref.stats, name)), name
        )
    assert bool(ours.stiff.all())
    assert int(ours.stats.n_attempts.max()) < 500


def test_aligned_steps_land_on_forcing_boundaries():
    """tests/test_step_align.py's RK45 case through the port: with every
    step capped at the next forcing sample, the frozen forcing is exact over
    the step, so in float64 the run at rtol 1e-5 / atol 1e-8 lies within 1
    tolerance unit (atol + rtol |y|) of the run at rtol 1e-9 / atol 1e-12,
    the reference's own bound; and it equals the reference's final state to
    the rtol 1e-9 / atol 1e-10 of test_f64_trajectories_match_vmap_rk45."""
    (y0, p, f), (ty0, tp, tforc) = _to_f64(*_scenario(2, np.float32, days=0.25, stiff_frac=0.0))
    cfg = dict(rtol=1e-5, atol=1e-8, max_steps=50_000)
    loose = rk45_solve(Model204(), ty0, 0.0, 360.0, None, tp, tforc, config=SolverConfig(**cfg))
    tight = rk45_solve(Model204(), ty0, 0.0, 360.0, None, tp, tforc,
                       config=SolverConfig(**dict(cfg, rtol=1e-9, atol=1e-12)))
    assert not bool(loose.stiff.any()) and not bool(tight.stiff.any())
    units = (loose.y_final - tight.y_final).abs() / (1e-8 + 1e-5 * tight.y_final.abs())
    assert float(units.max()) < 1.0, f"aligned RK45 float64 error {float(units.max())} tol units"
    ref = j_rk45_solve(JModel204(), y0, 0.0, 360.0, None, p, f, config=JSolverConfig(**cfg))
    np.testing.assert_array_equal(ours_att := loose.stats.n_attempts.numpy(),
                                  np.asarray(ref.stats.n_attempts))
    assert int(ours_att.min()) > 0
    np.testing.assert_allclose(loose.y_final.numpy(), np.asarray(ref.y_final), rtol=1e-9, atol=1e-10)


# The kernel's options in float32 against the Pallas kernel, which has all
# of them (the vmap path has no FSAL).
F32_OPTIONS = {
    "fsal": dict(fsal=True),
    "compensated": dict(compensated=True),
    "pi_controller": dict(controller="pi"),
    "fsal_pi": dict(fsal=True, controller="pi"),
    "compensated_pi": dict(compensated=True, controller="pi"),
}


def _rows_after_a_snapped_step(steps, n_q, dt=60.0):
    """[S, Q] bool: the hourly query rows at whose boundary a run (rk45_plain's
    ``steps``) ended a step inside the ZOH snap window, so the row is filled
    from a step that read the next hour's forcing a sliver early."""
    t_new = torch.stack([s[3] for s in steps]).double()
    moved = torch.stack([s[2] for s in steps])
    x = t_new / dt
    k = torch.floor(x + ZOH_SNAP)
    rows = np.zeros((t_new.shape[1], n_q), dtype=bool)
    for i, s in torch.nonzero(moved & (k != torch.floor(x))).tolist():
        if int(k[i, s]) < n_q:
            rows[s, int(k[i, s])] = True
    return rows


@pytest.mark.parametrize("case", sorted(F32_OPTIONS))
def test_f32_options_match_pallas_kernel(case):
    """As test_f32_matches_pallas_kernel, with each option: the same flags,
    5e-4 relative, attempts within 2%.

    The queries are hourly, on the rain's sample boundaries.  A float32 run
    whose step ends inside the snap window just before a boundary reads the
    next hour from there, and its row at that hour lies up to ~1e-3 from a
    run that landed on the boundary.  Each float32 run does so on a few
    rows of its own: so a row may lie off the Pallas kernel only where the
    Pallas kernel and the JAX vmap path disagree by more than 5e-4 (measured:
    1 row with compensated, 2 with compensated+pi) or where the port's own
    run ended a step in the window (measured: 2 rows with compensated+pi),
    and at most 3 rows."""
    (y0, p, f, qt), ours = _inputs(np.float32)
    cfg = dict(CFG, **F32_OPTIONS[case])
    ref = rk45_solve_pallas(
        JModel204(), y0, 0.0, TF, qt, p, f, config=JSolverConfig(**cfg), interpret=True
    )
    # The vmap path has no FSAL, which changes no result (the test below).
    vmap = j_rk45_solve(JModel204(), y0, 0.0, TF, qt, p, f, config=JSolverConfig(**dict(cfg, fsal=False)))
    ty0, tp, tforc, tq = ours
    mine = rk45_solve(Model204(), ty0, 0.0, TF, tq, tp, tforc, config=SolverConfig(**cfg))
    steps = []
    again = rk45_plain(Model204(), ty0, mine.h0, 0.0, TF, tq, tp, tforc, SolverConfig(**cfg), steps=steps)
    assert not any(rk45_mismatch(again, mine).values())
    np.testing.assert_array_equal(mine.stiff.numpy(), np.asarray(ref.stiff))
    np.testing.assert_array_equal(mine.failed.numpy(), np.asarray(ref.failed))

    def off(a, b):  # [S, Q] rows outside 5e-4 relative / 1e-7 absolute
        return (np.abs(a - b) > 1e-7 + 5e-4 * np.abs(b)).any(axis=-1)

    ok = ~mine.stiff.numpy()
    pallas, dense = np.asarray(ref.dense), mine.dense.numpy()
    excused = off(pallas, np.asarray(vmap.dense)) | _rows_after_a_snapped_step(steps, tq.shape[0])
    bad = off(dense, pallas) & ok[:, None]
    assert not (bad & ~excused).any(), np.argwhere(bad & ~excused)
    assert bad.sum() <= 3, np.argwhere(bad)
    # y_final is the last query row's time (TF is a multiple of an hour).
    final_bad = off(mine.y_final.numpy()[:, None], np.asarray(ref.y_final)[:, None])[:, 0] & ok
    assert not (final_bad & ~excused[:, -1]).any(), np.nonzero(final_bad)
    att, ref_att = mine.stats.n_attempts.numpy(), np.asarray(ref.stats.n_attempts)
    assert abs(int(att.sum()) - int(ref_att.sum())) <= 0.02 * ref_att.sum()


@pytest.mark.parametrize("controller", ["i", "pi"])
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_fsal_equals_the_default_bit_for_bit(np_dtype, controller):
    """FSAL only saves the first stage: k7 of an advance is f(t + h, y_out)
    in the same association as the next k1, and a step that crosses a
    forcing sample evaluates k1 anew (rk45_pallas.py l.446-453).  Every
    value, flag and counter equals the default's; the scenario's stiff rows
    and the hourly rain boundaries are both on the path."""
    _, (y0, p, f, qt) = _inputs(np_dtype)
    base = dict(CFG, controller=controller)
    plain = rk45_solve(Model204(), y0, 0.0, TF, qt, p, f, config=SolverConfig(**base))
    fsal = rk45_solve(Model204(), y0, 0.0, TF, qt, p, f, config=SolverConfig(fsal=True, **base))
    assert bool(plain.stiff.any())
    assert not any(rk45_mismatch(fsal, plain).values()), rk45_mismatch(fsal, plain)


TIGHT = dict(rtol=1e-6, atol=1e-9, max_steps=400_000, min_step_fraction=1e-9)


def test_f32_compensated_holds_tight_tolerances():
    """tests/test_compensated.py's case through the port: the 5-state linear
    test system over 2,000 minutes at the reference's rtol 1e-6 / atol 1e-9.
    Compensated float32 lies at most half as far from float64 as plain
    float32 (the JAX package measures 1.0e-6 against 4.5e-6) and within
    2e-6 relative."""
    y0 = np.random.default_rng(5).uniform(0.5, 2.0, (6, 5))
    y64 = rk45_solve(DummyModel(), torch.tensor(y0), 0.0, 2000.0,
                     config=SolverConfig(**TIGHT)).y_final.numpy()
    rel = {}
    for comp in (False, True):
        r = rk45_solve(DummyModel(), torch.tensor(y0, dtype=torch.float32), 0.0, 2000.0,
                       config=SolverConfig(compensated=comp, **TIGHT))
        assert not bool(r.stiff.any())
        rel[comp] = float((np.abs(r.y_final.numpy() - y64) / np.maximum(np.abs(y64), 1e-12)).max())
    assert rel[True] < 2e-6, rel
    assert rel[True] <= 0.5 * rel[False], rel


def test_f32_compensated_error_tail_matches_the_jax_package():
    """Model 204 at rtol 1e-6 / atol 1e-9: 1,024 systems over 2 days, each
    system's largest relative error of y_final (states above 1e-3) against
    the same package's float64 run.  The Kahan commit takes the median
    system's error down (the port 1.6e-7 against 1.9e-6 plain, measured;
    the JAX vmap path, which commits y + h (b . k) in one rounding, 5.5e-7
    against 1.05e-6), but not the tail: the largest errors, 3.3e-5 to 3.9e-5
    for both precisions in both packages, are steps that end elsewhere than
    float64's near a forcing boundary or a kink of the model, where each
    run's truncation error differs.  The port's tail is the JAX package's:
    p99 and largest within a factor 2 of it, run for run."""
    tf = 2880.0
    stats = {}
    for pkg in ("jax", "port"):
        y_final, stiff = {}, {}
        for np_dtype, comp in ((np.float64, False), (np.float32, False), (np.float32, True)):
            cfg = dict(rtol=1e-6, atol=1e-9, max_steps=100_000, compensated=comp)
            y0, p, f = _scenario(1024, np_dtype, days=2.0, stiff_frac=1 / 1024)
            if pkg == "jax":
                r = j_rk45_solve(JModel204(), y0, 0.0, tf, None, p, f, config=JSolverConfig(**cfg))
                y, s = np.asarray(r.y_final), np.asarray(r.stiff)
            else:
                ty0, tp, tforc, _ = convert.solver_inputs(
                    np.asarray(y0), {k: np.asarray(v) for k, v in p.items()},
                    np.asarray(f.data), f.meta, None, device="cpu",
                    dtype={np.float32: torch.float32, np.float64: torch.float64}[np_dtype])
                r = rk45_solve(Model204(), ty0, 0.0, tf, None, tp, tforc, config=SolverConfig(**cfg))
                y, s = r.y_final.numpy(), r.stiff.numpy()
            y_final[np_dtype, comp], stiff[np_dtype, comp] = y.astype(np.float64), s
        ref, ref_stiff = y_final[np.float64, False], stiff[np.float64, False]
        for comp in (False, True):
            ok = ~(stiff[np.float32, comp] | ref_stiff)
            rel = np.where(np.abs(ref) > 1e-3, np.abs(y_final[np.float32, comp] - ref) / np.abs(ref), 0.0)
            per = rel.max(axis=1)[ok]
            stats[pkg, comp] = dict(median=np.median(per), p99=np.quantile(per, 0.99), max=per.max())
    for pkg in ("jax", "port"):
        assert stats[pkg, True]["median"] < stats[pkg, False]["median"], stats
    assert stats["port", True]["median"] < 0.2 * stats["port", False]["median"], stats
    for comp in (False, True):
        for key in ("p99", "max"):
            ratio = stats["port", comp][key] / stats["jax", comp][key]
            assert 0.5 < ratio < 2.0, (comp, key, stats)
