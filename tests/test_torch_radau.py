"""B2's plain version (the port's CPU path) against the Pallas Radau kernel.

The stiff rows (0 and 63) of the 64-system, 6-hour synthetic basin
(``__graft_entry__._scenario``), re-integrated from t0 at the same initial
steps, as the two-phase solve does.  The JAX side runs its Pallas kernel in
interpret mode.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _scenario
from tiger_tpu.forcing import ForcingSet as JForcingSet
from tiger_tpu.kernels import radau_pallas
from tiger_tpu.kernels.radau_pallas import radau_solve_pallas
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.solver.config import SolverConfig as JSolverConfig
from tiger_tpu.solver.controller import initial_step as j_initial_step
from tiger_tpu.solver.radau import radau_solve as j_radau_solve
from tiger_tpu.models import DummyModel as JDummyModel
from tiger_tpu_torch import DummyModel, Model204, SolverConfig, convert
from tiger_tpu_torch.kernels.radau import radau_plain
from tiger_tpu_torch.solver import radau_solve
from tiger_tpu_torch.solver.radau import RadauStats

S, DAYS, STIFF_FRAC = 64, 0.25, 2 / 64
TF = DAYS * 1440.0
CFG = dict(rtol=1e-5, atol=1e-8, max_steps=100_000)
ROWS = np.array([0, 63])


class _Float64Jnp(types.ModuleType):
    """jax.numpy with ``float32`` read as ``float64``.  The Pallas Radau
    module builds its inputs, outputs and constants from ``jnp.float32``;
    under this stand-in its kernel body runs in float64 (interpret mode)."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _pallas_radau_f64(monkeypatch, model, y0, h0, p, f, qt, tf, cfg):
    """The Pallas Radau kernel in float64 over the float64 inputs: its
    pipeline (what ``radau_solve_pallas`` calls after casting to float32)
    with ``radau_pallas.jnp`` patched to ``_Float64Jnp``."""
    monkeypatch.setattr(radau_pallas, "jnp", _Float64Jnp("jax.numpy"))
    return radau_pallas._pipeline(model, y0, h0, p, f.data, qt, 0.0, tf, f.meta,
                                  JSolverConfig(**cfg), tuple(sorted(p)), True, jnp.asarray(0.0))


def _subset(np_dtype):
    """(JAX inputs, port inputs) of the stiff rows, h0 included."""
    y0, p, f = _scenario(S, np_dtype, days=DAYS, stiff_frac=STIFF_FRAC)
    h0 = j_initial_step(JModel204(), y0, 0.0, p, f, JSolverConfig(**CFG))
    y0, h0 = np.asarray(y0)[ROWS], np.asarray(h0)[ROWS]
    p = {k: np.asarray(v)[ROWS] for k, v in p.items()}
    data = np.asarray(f.data)[:, ROWS]
    qt = np.arange(0.0, TF + 1e-9, 60.0, dtype=np_dtype)
    jax_in = (jnp.asarray(y0), {k: jnp.asarray(v) for k, v in p.items()},
              JForcingSet(jnp.asarray(data), f.meta), jnp.asarray(qt), jnp.asarray(h0))
    dtype = {np.float32: torch.float32, np.float64: torch.float64}[np_dtype]
    ours = convert.solver_inputs(y0, p, data, f.meta, qt, device="cpu", dtype=dtype)
    return jax_in, ours + (convert.tensor(h0, device="cpu", dtype=dtype),)


@pytest.fixture(scope="module")
def f32_pair():
    (y0, p, f, qt, h0), (ty0, tp, tf_, tq, th0) = _subset(np.float32)
    ref = radau_solve_pallas(
        JModel204(), y0, 0.0, TF, qt, p, f, h0=h0, config=JSolverConfig(**CFG), interpret=True
    )
    ours = radau_solve(Model204(), ty0, 0.0, TF, tq, tp, tf_, h0=th0, config=SolverConfig(**CFG))
    return ref, ours


def test_f32_matches_pallas_radau(f32_pair):
    ref, ours = f32_pair
    assert ours.y_final.dtype == torch.float32
    assert ours.dense.shape == ref.dense.shape
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    assert not ours.failed.any()
    # float32, the same algorithm: only torch's and XLA's rounding differ
    # (exp2/log2 in the Manning term, fusions), which moves a Newton exit or
    # an accept by a step now and then; the states agree far inside the
    # solver's rtol 1e-5 of the ~3 m stores.
    np.testing.assert_allclose(
        ours.y_final.numpy(), np.asarray(ref.y_final), rtol=1e-4, atol=1e-7
    )
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=1e-4, atol=1e-7)
    att, ref_att = ours.stats.n_attempts.numpy(), np.asarray(ref.stats.n_attempts)
    assert np.all(np.abs(att - ref_att) <= 0.02 * ref_att)
    swp, ref_swp = ours.stats.n_newton.numpy(), np.asarray(ref.stats.n_newton)
    assert np.all(np.abs(swp - ref_swp) <= 0.02 * ref_swp)


def test_stats_are_consistent(f32_pair):
    _, ours = f32_pair
    st = ours.stats
    assert torch.equal(st.n_accepted + st.n_rejected, st.n_attempts)
    assert torch.equal(st.n_fact, st.n_attempts)  # one Jacobian + LU per attempt
    assert bool((st.n_newton >= st.n_attempts).all())
    assert bool((st.n_newton <= SolverConfig().newton_max_iter * st.n_attempts).all())


def test_float64_plain_is_the_same_solution(f32_pair):
    """radau_plain runs in y0's dtype: in float64 it lands on the float32
    solution within the solver's tolerance."""
    _, r32 = f32_pair
    (_, _, _, _, _), (y0, p, f, qt, h0) = _subset(np.float64)
    r64 = radau_plain(Model204(), y0, h0, 0.0, TF, qt, p, f, SolverConfig(**CFG))
    assert r64.y_final.dtype == torch.float64 and not r64.failed.any()
    np.testing.assert_allclose(
        r32.dense.numpy(), r64.dense.numpy(), rtol=1e-3, atol=1e-6
    )


@pytest.mark.parametrize(
    "options",
    [
        dict(newton_reject_unconverged=False, radau_h_freeze_hi=1.2, newton_max_iter=4),
        dict(forcing_step_align=False, fill_t0_queries=False, nan_shrink=1.0,
             radau_max_rejects=20, newton_tol=1e-6),
        dict(radau_predictor=True),
        dict(radau_error_mode="radau5"),
        dict(radau_error_mode="radau5", radau_predictor=True),
    ],
    ids=["newton_options", "reference_switches", "predictor", "radau5", "radau5_predictor"],
)
def test_f64_options_match_vmap_radau(options, monkeypatch):
    """Every supported Radau option steers the plain version as it steers
    the JAX package: the stiff rows over the first hour, float64.

    Against the Pallas kernel run in float64 (``_pallas_radau_f64``), whose
    simplified Newton (one Jacobian an attempt) the port shares: the same
    failed rows and every counter equal, trajectories within 1e-9.  Against
    the vmap path: the same failed rows and trajectories within 1e-9, and
    the same attempts except with radau5.  radau5's controller reads the
    attempt's sweep count, and the vmap path's full Newton (each stage's
    Jacobian, every sweep) takes other counts (measured 443 against 461
    sweeps), so its attempts differ (156 against 159)."""
    (y0, p, f, qt, h0), (ty0, tp, tf_, tq, th0) = _subset(np.float64)
    cfg = dict(CFG, **options)
    ref = j_radau_solve(JModel204(safe_pow=False), y0, 0.0, 60.0, qt[:2], p, f, h0=h0,
                        config=JSolverConfig(**cfg))
    kernel = _pallas_radau_f64(monkeypatch, JModel204(safe_pow=False), y0, h0, p, f, qt[:2], 60.0, cfg)
    ours = radau_solve(Model204(safe_pow=False), ty0, 0.0, 60.0, tq[:2], tp, tf_, h0=th0,
                       config=SolverConfig(**cfg))
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(kernel.failed))
    for name, got, want in zip(RadauStats._fields, ours.stats, kernel.stats):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    if cfg.get("radau_error_mode") != "radau5":
        for name in ("n_attempts", "n_accepted", "n_rejected"):
            np.testing.assert_array_equal(getattr(ours.stats, name).numpy(),
                                          np.asarray(getattr(ref.stats, name)), name)
    for other in (ref, kernel):
        np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(other.y_final), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(ours.dense.numpy(), np.asarray(other.dense), rtol=1e-9, atol=1e-12)


F32_OPTIONS = {
    "predictor": dict(radau_predictor=True),
    "radau5": dict(radau_error_mode="radau5"),
    "radau5_predictor": dict(radau_error_mode="radau5", radau_predictor=True),
}


@pytest.mark.parametrize("case", sorted(F32_OPTIONS))
def test_f32_options_match_pallas_radau(case):
    """Each option in float32, on the stiff rows over the first hour (the
    span of test_f64_options_match_vmap_radau).  radau5 is held to the
    Pallas kernel as test_f32_matches_pallas_radau holds the default.

    The predictor starts Newton from the last attempt's polynomial, and the
    two packages' float32 roundings move its sweep counts and then the step
    sequence (measured 630/585 against 661/684 attempts; 268/356 against
    462/333 with radau5).  Its float32 runs also scatter the static store,
    whose capacity Hu is 1e-6 m on these rows, around its value: 5.7e-7
    and 9.0e-7 (port, Pallas) where float64 at rtol 1e-9 gives 6.2e-7,
    and with radau5 -2.1e-6 and -9.6e-8.  So each package's run is held to
    that float64 solution, both within 5e-6 m (5 Hu) and 2e-3 relative.
    The float64 test above holds the predictor's arithmetic against the
    vmap path step for step."""
    (y0, p, f, qt, h0), (ty0, tp, tf_, tq, th0) = _subset(np.float32)
    cfg = dict(CFG, **F32_OPTIONS[case])
    ref = radau_solve_pallas(JModel204(), y0, 0.0, 60.0, qt[:2], p, f, h0=h0,
                             config=JSolverConfig(**cfg), interpret=True)
    ours = radau_solve(Model204(), ty0, 0.0, 60.0, tq[:2], tp, tf_, h0=th0,
                       config=SolverConfig(**cfg))
    assert not ours.failed.any() and not np.asarray(ref.failed).any()
    if not cfg.get("radau_predictor"):
        np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=1e-4, atol=1e-7)
        att, ref_att = ours.stats.n_attempts.numpy(), np.asarray(ref.stats.n_attempts)
        assert np.all(np.abs(att - ref_att) <= 0.02 * ref_att)
        swp, ref_swp = ours.stats.n_newton.numpy(), np.asarray(ref.stats.n_newton)
        assert np.all(np.abs(swp - ref_swp) <= 0.02 * ref_swp)
        return
    (_, _, _, _, _), (y64, p64, f64, q64, h64) = _subset(np.float64)
    tight = radau_plain(Model204(), y64, h64, 0.0, 60.0, q64[:2], p64, f64,
                        SolverConfig(**dict(cfg, rtol=1e-9, atol=1e-12)))
    assert not tight.failed.any()
    for got in (ours.dense.numpy(), np.asarray(ref.dense)):
        np.testing.assert_allclose(got, tight.dense.numpy(), rtol=2e-3, atol=5e-6)


def test_f32_radau5_predictor_fails_the_stiff_rows_as_the_pallas_kernel_does(monkeypatch):
    """Over the full 6 hours radau5 with the predictor fails both stiff rows
    in float32, in the Pallas kernel as in the port: neither reports a
    solution it did not reach.  The runs fail otherwise: the Pallas kernel's
    crawls to max_steps with every other attempt rejected (2,547 of 5,000),
    the port's meets radau_max_rejects rejections in a row first (at 984
    and 1,354 attempts).  The two float32 runs part within the first half
    minute, where a Newton sweep's rounding makes one attempt take one
    sweep more (1,052 against 1,053 sweeps in 201 attempts) and radau5's
    safety, which reads the sweep count, moves h.  In float64 neither fails
    a row, and the port takes the Pallas kernel's every attempt, rejection
    and sweep."""
    (y0, p, f, qt, h0), (ty0, tp, tf_, tq, th0) = _subset(np.float32)
    cfg = dict(CFG, radau_error_mode="radau5", radau_predictor=True, max_steps=5_000)
    ref = radau_solve_pallas(JModel204(), y0, 0.0, TF, qt, p, f, h0=h0,
                             config=JSolverConfig(**cfg), interpret=True)
    ours = radau_solve(Model204(), ty0, 0.0, TF, tq, tp, tf_, h0=th0, config=SolverConfig(**cfg))
    assert ours.failed.all() and np.asarray(ref.failed).all()
    assert torch.isnan(ours.y_final).all() and np.isnan(np.asarray(ref.y_final)).all()
    assert (np.asarray(ref.stats.n_attempts) == cfg["max_steps"]).all()
    assert (ours.stats.n_attempts < cfg["max_steps"]).all()
    (y0, p, f, qt, h0), (ty0, tp, tf_, tq, th0) = _subset(np.float64)
    kernel = _pallas_radau_f64(monkeypatch, JModel204(), y0, h0, p, f, qt, TF, cfg)
    ours = radau_solve(Model204(), ty0, 0.0, TF, tq, tp, tf_, h0=th0, config=SolverConfig(**cfg))
    assert not ours.failed.any() and not np.asarray(kernel.failed).any()
    for name, got, want in zip(RadauStats._fields, ours.stats, kernel.stats):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)


@pytest.mark.parametrize("case", ["radau5", "predictor"])
def test_f32_options_fail_the_rows_the_pallas_kernel_fails(case):
    """radau5, and embedded3 with the predictor, over the full 6 hours in
    float32: the same failed rows as the Pallas kernel (neither fails
    these two; on the main path's 131 rows over 2 days some fail, PERF.md),
    finite where not failed, attempts within 10% (the float32 runs part as
    in the test above: measured 355/416 against 353/403 with radau5,
    1,628/1,905 against 1,615/1,770 with the predictor)."""
    (y0, p, f, qt, h0), (ty0, tp, tf_, tq, th0) = _subset(np.float32)
    cfg = dict(CFG, max_steps=5_000, **F32_OPTIONS[case])
    ref = radau_solve_pallas(JModel204(), y0, 0.0, TF, qt, p, f, h0=h0,
                             config=JSolverConfig(**cfg), interpret=True)
    ours = radau_solve(Model204(), ty0, 0.0, TF, tq, tp, tf_, h0=th0, config=SolverConfig(**cfg))
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    assert torch.isfinite(ours.y_final[~ours.failed]).all()
    att, ref_att = ours.stats.n_attempts.numpy(), np.asarray(ref.stats.n_attempts)
    assert np.all(np.abs(att - ref_att) <= 0.1 * ref_att), (att, ref_att)


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_reference_error_mode_matches_jax(np_dtype):
    """radau_error_mode='reference' (the reference's RADAU_E, exponent 1/5):
    its weights do not sum to 0, so the estimate does not vanish with h and
    caps h near the tolerance (tests/test_radau.py); on the stiff rows both
    packages end every system at max_steps within the first 10 minutes.  So
    it runs on the 5-state linear test system over 0.2 minutes, float64
    against the vmap path (the same steps, 1e-9), float32 against the Pallas
    kernel (5e-4 relative)."""
    cfg = dict(rtol=1e-4, atol=1e-6, radau_error_mode="reference")
    y0 = np.random.default_rng(3).uniform(0.5, 2.0, (3, 5)).astype(np_dtype)
    qt = np.linspace(0.0, 0.2, 5).astype(np_dtype)
    h0 = np.full(3, 1e-3, np_dtype)
    if np_dtype == np.float64:
        ref = j_radau_solve(JDummyModel(), jnp.asarray(y0), 0.0, 0.2, jnp.asarray(qt),
                            h0=jnp.asarray(h0), config=JSolverConfig(**cfg))
    else:
        ref = radau_solve_pallas(JDummyModel(), jnp.asarray(y0), 0.0, 0.2, jnp.asarray(qt),
                                 h0=jnp.asarray(h0), config=JSolverConfig(**cfg), interpret=True)
    ours = radau_solve(DummyModel(), torch.from_numpy(y0), 0.0, 0.2, torch.from_numpy(qt),
                       h0=torch.from_numpy(h0), config=SolverConfig(**cfg))
    assert not ours.failed.any() and not np.asarray(ref.failed).any()
    att = ours.stats.n_attempts.numpy()
    if np_dtype == np.float64:
        np.testing.assert_array_equal(att, np.asarray(ref.stats.n_attempts))
        rtol = 1e-9
    else:
        assert np.all(np.abs(att - np.asarray(ref.stats.n_attempts)) <= 0.02 * att)
        rtol = 5e-4
    # Many more steps than the default error estimate takes.
    plain = radau_solve(DummyModel(), torch.from_numpy(y0), 0.0, 0.2, torch.from_numpy(qt),
                        h0=torch.from_numpy(h0),
                        config=SolverConfig(**dict(cfg, radau_error_mode="embedded3")))
    assert int(att.min()) > 4 * int(plain.stats.n_attempts.max())
    np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final), rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=rtol, atol=1e-12)
