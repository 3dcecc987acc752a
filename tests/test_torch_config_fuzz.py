"""Config-interaction fuzz of the port: tests/test_config_fuzz.py's draws,
with the port's plain versions (its CPU path, and the card kernels'
bit-for-bit reference) in place of the JAX package's fused kernels.

Each seeded sample draws a legal SolverConfig as that file draws it (the
lockstep query crossing and Radau factor reuse among the options),
integrates the same small batch, made in numpy, through the port and
through the JAX package, and requires the same flags and tolerance-level
agreement.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _scenario
from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.solver import SolverConfig as JSolverConfig
from tiger_tpu.solver.radau import radau_solve as j_radau_solve
from tiger_tpu_torch import Model204, SolverConfig, convert
from tiger_tpu_torch.solver import radau_solve, rk45_solve


def _draw_rk45(rng) -> dict:
    """test_config_fuzz.py's draw, seed for seed."""
    controller = str(rng.choice(["i", "pi"]))
    compensated = bool(rng.integers(0, 2))
    fsal = bool(rng.integers(0, 2)) and not compensated  # mutually exclusive
    return dict(
        rtol=float(rng.choice([1e-4, 1e-5])),
        atol=float(rng.choice([1e-7, 1e-8])),
        max_steps=50_000,
        controller=controller,
        compensated=compensated,
        fsal=fsal,
        dense_lockstep=bool(rng.integers(0, 2)),
        forcing_step_align=bool(rng.integers(0, 2)),
        stiff_detect=bool(rng.integers(0, 2)),
        nan_shrink=float(rng.choice([0.2, 0.5])),
        max_scale=float(rng.choice([5.0, 10.0])),
    )


@pytest.mark.parametrize("seed", range(6))
def test_rk45_plain_matches_pallas_kernel_under_random_config(seed):
    """float32, 8 systems over a day, against the Pallas kernel in interpret
    mode (which has every drawn option), at test_config_fuzz.py's
    tolerances: 5e-4 / 5e-6 on y_final and 5e-3 / 5e-5 on dense with step
    alignment; without it both integrate a frozen forcing across sample
    boundaries and the crossing error depends on the step sequence, so
    6e-2 / 1e-3 and 8e-2 / 2e-3."""
    cfg = _draw_rk45(np.random.default_rng(100 + seed))
    s, tf = 8, 1440.0
    y0, params, forc = _scenario(s, jnp.float32, days=1.0, stiff_frac=0.0)
    qt = np.arange(0.0, tf + 1e-9, 360.0, dtype=np.float32)
    ref = rk45_solve_pallas(JModel204(), y0, 0.0, tf, jnp.asarray(qt), params, forc,
                            h0=jnp.full((s,), 1e-3, jnp.float32),
                            config=JSolverConfig(**cfg), interpret=True)
    ty0, tp, tforc, tq = convert.solver_inputs(
        np.asarray(y0), {k: np.asarray(v) for k, v in params.items()}, np.asarray(forc.data),
        forc.meta, qt, device="cpu", dtype=torch.float32)
    ours = rk45_solve(Model204(), ty0, 0.0, tf, tq, tp, tforc,
                      h0=torch.full((s,), 1e-3), config=SolverConfig(**cfg))
    assert not ours.failed.any() and not np.asarray(ref.failed).any(), cfg
    np.testing.assert_array_equal(ours.stiff.numpy(), np.asarray(ref.stiff), err_msg=str(cfg))
    rt_f, at_f = (5e-4, 5e-6) if cfg["forcing_step_align"] else (6e-2, 1e-3)
    rt_d, at_d = (5e-3, 5e-5) if cfg["forcing_step_align"] else (8e-2, 2e-3)
    np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final),
                               rtol=rt_f, atol=at_f, err_msg=str(cfg))
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense),
                               rtol=rt_d, atol=at_d, err_msg=str(cfg))


@dataclasses.dataclass(frozen=True)
class JDecay2:
    """tests/test_config_fuzz.py's stiff decay: y0 relaxes onto cos(t) at
    rate lam, y1 decays at 1/2."""

    N_EQ: int = 2
    UID: int = 96

    def rhs_tuple(self, t, y, p, f=None):
        return (p["lam"] * (y[0] - jnp.cos(t)), -0.5 * y[1])

    def rhs(self, t, y, p, f=None):
        return jnp.stack(self.rhs_tuple(t, y, p, f))


@dataclasses.dataclass(frozen=True)
class Decay2:
    """The torch twin of JDecay2."""

    N_EQ: int = 2
    UID: int = 96

    def rhs_tuple(self, t, y, p, f=None):
        return (p["lam"] * (y[0] - torch.cos(t)), -0.5 * y[1])


@pytest.mark.parametrize("seed", range(4))
def test_radau_plain_matches_vmap_under_random_config(seed):
    """Error mode x step freeze x factor reuse x predictor, float32, 8
    systems over 5 time units, against the JAX package's vmap Radau (which
    refactors every attempt, so it runs without reuse, as
    test_config_fuzz.py runs it) at that file's tolerances (5e-3 / 1e-4 on
    y_final, 1e-2 / 1e-4 on dense): the vmap path runs a full Newton with
    each stage's Jacobian, the port the kernels' simplified one, so the two
    agree at the solver's tolerance."""
    rng = np.random.default_rng(200 + seed)
    cfg = dict(
        rtol=1e-4, atol=1e-6, max_steps=20_000,
        radau_error_mode=str(rng.choice(["embedded3", "radau5"])),
        radau_h_freeze_hi=float(rng.choice([1.0, 1.2])),
        radau_factor_reuse=bool(rng.integers(0, 2)),
        radau_predictor=bool(rng.integers(0, 2)),
    )
    s = 8
    lam = np.full((s,), float(rng.choice([-50.0, -1e3])), np.float32)
    y0 = np.tile(np.asarray([2.0, 1.0], np.float32), (s, 1))
    h0 = np.full((s,), 1e-3, np.float32)
    qt = np.asarray([2.0, 5.0], np.float32)
    ref = j_radau_solve(JDecay2(), jnp.asarray(y0), 0.0, 5.0, jnp.asarray(qt),
                        {"lam": jnp.asarray(lam)}, h0=jnp.asarray(h0),
                        config=JSolverConfig(**{**cfg, "radau_factor_reuse": False}))
    ours = radau_solve(Decay2(), torch.from_numpy(y0), 0.0, 5.0, torch.from_numpy(qt),
                       {"lam": torch.from_numpy(lam)}, h0=torch.from_numpy(h0),
                       config=SolverConfig(**cfg))
    assert not ours.failed.any() and not np.asarray(ref.failed).any(), cfg
    np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final),
                               rtol=5e-3, atol=1e-4, err_msg=str(cfg))
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense),
                               rtol=1e-2, atol=1e-4, err_msg=str(cfg))
