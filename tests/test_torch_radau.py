"""B2's plain version (the port's CPU path) against the Pallas Radau kernel.

The stiff rows (0 and 63) of the 64-system, 6-hour synthetic basin
(``__graft_entry__._scenario``), re-integrated from t0 at the same initial
steps, as the two-phase solve does.  The JAX side runs its Pallas kernel in
interpret mode.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _scenario
from tiger_tpu.forcing import ForcingSet as JForcingSet
from tiger_tpu.kernels.radau_pallas import radau_solve_pallas
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.solver.config import SolverConfig as JSolverConfig
from tiger_tpu.solver.controller import initial_step as j_initial_step
from tiger_tpu.solver.radau import radau_solve as j_radau_solve
from tiger_tpu_torch import Model204, SolverConfig, convert
from tiger_tpu_torch.kernels.radau import radau_plain
from tiger_tpu_torch.solver import radau_solve

S, DAYS, STIFF_FRAC = 64, 0.25, 2 / 64
TF = DAYS * 1440.0
CFG = dict(rtol=1e-5, atol=1e-8, max_steps=100_000)
ROWS = np.array([0, 63])


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
    ],
    ids=["newton_options", "reference_switches"],
)
def test_f64_options_match_vmap_radau(options):
    """Every supported Radau option steers the plain version as it steers
    the JAX package's vmap Radau (the Pallas kernel's algorithm: one
    Jacobian per attempt, the same attempt counts): the stiff rows over the
    first hour, float64."""
    (y0, p, f, qt, h0), (ty0, tp, tf_, tq, th0) = _subset(np.float64)
    cfg = dict(CFG, **options)
    ref = j_radau_solve(JModel204(safe_pow=False), y0, 0.0, 60.0, qt[:2], p, f, h0=h0,
                        config=JSolverConfig(**cfg))
    ours = radau_solve(Model204(safe_pow=False), ty0, 0.0, 60.0, tq[:2], tp, tf_, h0=th0,
                       config=SolverConfig(**cfg))
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    # (The vmap path counts Newton sweeps by its own rule; the sweep count
    # is held against the Pallas kernel above.)
    for name in ("n_attempts", "n_accepted", "n_rejected"):
        np.testing.assert_array_equal(
            getattr(ours.stats, name).numpy(), np.asarray(getattr(ref.stats, name)), name
        )
    np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=1e-9, atol=1e-12)
