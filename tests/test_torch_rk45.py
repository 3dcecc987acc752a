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
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_f64_options_match_vmap_rk45(case):
    """Every supported SolverConfig option steers the plain version as it
    steers the reference: 16 systems over 2 hours, float64."""
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
    np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final), rtol=rtol, atol=1e-10)
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=rtol, atol=1e-10)


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
