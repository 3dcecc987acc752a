"""The port's two-phase ``solve()`` against the JAX package's.

The JAX side runs ``backend='pallas'`` with TT_FORCE_DEVICE_RUNG=1, so its
stiff rows go through the Pallas Radau kernel (interpret mode) exactly as on
a TPU; the port runs the plain versions of B1 and B2 on the CPU.  Both get
the synthetic basin of ``__graft_entry__._scenario`` at 64 systems over 6
hours, with stiff rows 0 and 63.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _scenario
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.solver.api import solve as j_solve
from tiger_tpu.solver.config import SolverConfig as JSolverConfig
from tiger_tpu_torch import DummyModel, Model204, SolverConfig, solve
from tiger_tpu_torch.scenario import scenario

S, DAYS, STIFF_FRAC = 64, 0.25, 2 / 64
TF = DAYS * 1440.0
CFG = dict(rtol=1e-5, atol=1e-8, max_steps=100_000)
STIFF_ROWS = [0, 63]


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("TT_FORCE_DEVICE_RUNG", "1")
    try:
        y0, p, f = _scenario(S, jnp.float32, days=DAYS, stiff_frac=STIFF_FRAC)
        qt = np.arange(0.0, TF + 1e-9, 60.0, dtype=np.float32)
        ref = j_solve(JModel204(), y0, 0.0, TF, jnp.asarray(qt), p, f,
                      config=JSolverConfig(**CFG), backend="pallas")
    finally:
        mp.undo()
    ty0, tp, tf_ = scenario(S, DAYS, STIFF_FRAC, device="cpu", dtype=torch.float32)
    # The port's scenario is the JAX one, bit for bit.
    assert np.array_equal(ty0.numpy(), np.asarray(y0))
    assert all(np.array_equal(tp[k].numpy(), np.asarray(p[k])) for k in p)
    assert np.array_equal(tf_.data.numpy(), np.asarray(f.data))
    ours = solve(Model204(), ty0, 0.0, TF, torch.from_numpy(qt), tp, tf_, SolverConfig(**CFG))
    return ref, ours


def test_same_stiff_rows_and_no_failures(pair):
    ref, ours = pair
    assert ours.n_stiff == ref.n_stiff == len(STIFF_ROWS)
    assert np.nonzero(ours.stiff.numpy())[0].tolist() == STIFF_ROWS
    np.testing.assert_array_equal(ours.stiff.numpy(), np.asarray(ref.stiff))
    assert not ours.failed.any() and not np.asarray(ref.failed).any()
    assert torch.isfinite(ours.y_final).all()
    assert ours.dense.shape == (S, 7, 5) and ours.dense.dtype == torch.float32


def test_results_match(pair):
    ref, ours = pair
    y, d = ours.y_final.numpy(), ours.dense.numpy()
    ry, rd = np.asarray(ref.y_final), np.asarray(ref.dense)
    rk = np.setdiff1d(np.arange(S), STIFF_ROWS)
    # RK45 rows: float32 step sequences that rounding separates, held as in
    # test_torch_rk45 (the Pallas kernel's own float32 error is 3.2e-4).
    np.testing.assert_allclose(y[rk], ry[rk], rtol=5e-4, atol=1e-7)
    np.testing.assert_allclose(d[rk], rd[rk], rtol=5e-4, atol=1e-7)
    # Radau rows: as in test_torch_radau.
    np.testing.assert_allclose(y[STIFF_ROWS], ry[STIFF_ROWS], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(d[STIFF_ROWS], rd[STIFF_ROWS], rtol=1e-4, atol=1e-7)


def test_stats_scattered_per_system(pair):
    ref, ours = pair
    rs, jrs = ours.radau_stats, ref.radau_stats
    assert rs.n_attempts.shape == (S,)
    rk = np.setdiff1d(np.arange(S), STIFF_ROWS)
    for name in rs._fields:
        assert not getattr(rs, name).numpy()[rk].any(), name
    att, ref_att = rs.n_attempts.numpy(), np.asarray(jrs.n_attempts)
    assert np.all(np.abs(att - ref_att) <= 0.02 * ref_att)
    rk_att, ref_rk = int(ours.rk_stats.n_attempts.sum()), int(np.asarray(ref.rk_stats.n_attempts).sum())
    assert abs(rk_att - ref_rk) <= 0.02 * ref_rk


@dataclasses.dataclass(frozen=True)
class StiffMix(DummyModel):
    """Per-system linear decay y' = lam*y: lam << 0 is stiff for RK45."""

    def rhs_tuple(self, t, y, params, forcings=None):
        return tuple(params["lam"] * yi for yi in y)


def _mix():
    lam = torch.full((12,), -0.1, dtype=torch.float64)
    lam[[3, 7]] = -1e6
    return torch.ones((12, 5), dtype=torch.float64), {"lam": lam}


def test_radau_resolves_flagged_rows_float64():
    y0, params = _mix()
    res = solve(StiffMix(), y0, 0.0, 50.0, torch.tensor([25.0, 50.0], dtype=torch.float64),
                params, config=SolverConfig(rtol=1e-5, atol=1e-8))
    assert res.n_stiff == 2 and res.stiff.nonzero().ravel().tolist() == [3, 7]
    assert not res.failed.any()
    np.testing.assert_allclose(res.y_final[[3, 7]].numpy(), 0.0, atol=1e-6)
    keep = torch.ones(12, dtype=torch.bool)
    keep[[3, 7]] = False
    np.testing.assert_allclose(res.y_final[keep].numpy(), np.exp(-5.0), rtol=1e-4)


def test_radau_failure_is_reported_failed():
    """No float64 retry in the port: a system Radau fails must come out
    failed, though RK45 left a criteria-stiff system with failed=False."""
    y0, params = _mix()
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, newton_max_iter=1, radau_max_rejects=1)
    res = solve(StiffMix(), y0, 0.0, 50.0, None, params, config=cfg)
    assert res.n_stiff == 2
    assert res.failed.nonzero().ravel().tolist() == [3, 7]
    assert res.radau_stats.n_attempts[[3, 7]].min() >= 2
    assert torch.isfinite(res.y_final[~res.failed]).all()
