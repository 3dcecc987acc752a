"""The float64 retry of the systems the Radau phase fails (``solver.api``).

On the card a float32 ``solve()`` integrates the systems B2 failed again in
float64: B1's double instance of the caller's config, then B2's on the rows
B1 still flags stiff, as the JAX package's accelerator path does after its
float32 device rung (``tiger_tpu/solver/api.py`` l.526-712).  Here the same
code runs on CPU tensors through the kernels' plain versions: directly
(``retry_failed_f64``), and through ``solve()`` with its predicate
``retries_in_f64`` patched to say yes, since on the CPU neither package
retries.
"""

import dataclasses
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _scenario
from tiger_tpu.forcing import ForcingSet as JForcingSet
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.solver.config import SolverConfig as JSolverConfig
from tiger_tpu.solver.controller import initial_step as j_initial_step
from tiger_tpu.solver.radau import radau_solve as j_radau_solve
from tiger_tpu.solver.rk45 import rk45_solve as j_rk45_solve
from tiger_tpu.solver.segmented import segmented_solve as j_segmented_solve
from tiger_tpu_torch import DummyModel, Model204, SolverConfig, convert, solve
from tiger_tpu_torch.kernels.radau import radau_plain
from tiger_tpu_torch.kernels.rk45 import rk45_plain
from tiger_tpu_torch.solver import api
from tiger_tpu_torch.solver.radau import RadauStats

# The stiff rows of the 64-system, 6-hour basin, as in test_torch_radau.py:
# radau5 with the predictor fails both in float32 (in the Pallas kernel too).
S, DAYS, STIFF_FRAC = 64, 0.25, 2 / 64
TF = DAYS * 1440.0
ROWS = [0, 63]
RADAU5_PRED = dict(rtol=1e-5, atol=1e-8, max_steps=5_000, radau_error_mode="radau5",
                   radau_predictor=True)


def _basin():
    """The basin's float32 inputs for both packages, with phase 1's h0."""
    y0, p, f = _scenario(S, np.float32, days=DAYS, stiff_frac=STIFF_FRAC)
    h0 = np.asarray(j_initial_step(JModel204(), y0, 0.0, p, f, JSolverConfig(**RADAU5_PRED)))
    qt = np.arange(0.0, TF + 1e-9, 60.0, dtype=np.float32)
    p = {k: np.array(v) for k, v in p.items()}
    ours = convert.solver_inputs(np.asarray(y0), p, np.asarray(f.data), f.meta, qt, device="cpu",
                                 dtype=torch.float32)
    return (np.asarray(y0), p, np.asarray(f.data), f.meta, qt, h0), ours + (torch.tensor(h0),)


def _jax_chain(y0, p, data, meta, qt, h0, rows):
    """The JAX package's float64 retry of ``rows`` (api.py l.618-690), without
    queries (y_final, counters) and with them (segmented: dense rows)."""
    cfg = JSolverConfig(**RADAU5_PRED)
    sub = lambda a: jnp.asarray(np.asarray(a, np.float64)[rows])
    y, h = sub(y0), sub(h0)
    pp = {k: sub(v) for k, v in p.items()}
    forc = JForcingSet(jnp.asarray(data[:, rows]), meta)
    rk = j_rk45_solve(JModel204(), y, 0.0, TF, None, pp, forc, h0=h, config=cfg)
    rd = j_radau_solve(JModel204(), y, 0.0, TF, None, pp, forc, h0=h, config=cfg)
    seg = j_segmented_solve(JModel204(), "radau", y, 0.0, TF, np.asarray(qt, np.float64), pp, forc,
                            h0=h, config=cfg)
    return rk, rd, seg


def test_retry_solves_the_rows_float32_radau5_predictor_fails():
    """The fault the retry closes: over 6 hours in float32, radau5 with the
    predictor fails both stiff rows (test_torch_radau.py).  The port's
    retry of those rows, from phase 1's h0 with the same config, ends both
    with failed=False, as the JAX package's float64 chain does: both flag
    the rows stiff again in step 1, and step 2's y_final agrees within
    1e-9 relative (measured: 6.2e-12, in the surface store).  The JAX
    float64 Radau is the vmap path, which counts otherwise than the Pallas
    kernel the port follows (its sweeps, no factorizations), so only the
    attempts are held, within 10% (measured 261/272 against 251/271).  The
    dense rows are the port's interpolant against the JAX package's
    segmented landing on each query, within 0.1 x (rtol |y| + atol)
    (measured: at most 3.9e-5 of rtol |y| + atol)."""
    (y0, p, data, meta, qt, h0), (ty0, tp, tforc, tq, th0) = _basin()
    rows = torch.tensor(ROWS)
    cfg = SolverConfig(**RADAU5_PRED)
    f32 = radau_plain(Model204(), ty0[rows], th0[rows], 0.0, TF, tq, {k: v[rows] for k, v in tp.items()},
                      tforc.take_systems(rows), cfg)
    assert f32.failed.all()
    retry = api.retry_failed_f64(Model204(), ty0, th0, 0.0, TF, tq.double(), tp, tforc, cfg, 0.0, rows)
    rk, rd, seg = _jax_chain(y0, p, data, meta, qt, h0, ROWS)
    assert np.asarray(rk.stiff).all()  # step 1 resolves neither row, in either package
    assert retry.rows.tolist() == retry.radau_rows.tolist() == ROWS
    assert not retry.failed.any() and not np.asarray(rd.failed).any()
    assert retry.y_final.dtype == retry.dense.dtype == torch.float64
    np.testing.assert_allclose(retry.y_final.numpy(), np.asarray(rd.y_final), rtol=1e-9, atol=0.0)
    att, ref_att = retry.radau_stats.n_attempts.numpy(), np.asarray(rd.stats.n_attempts)
    assert np.all(np.abs(att - ref_att) <= 0.1 * ref_att), (att, ref_att)
    want = np.asarray(seg.dense)
    bound = 0.1 * (RADAU5_PRED["rtol"] * np.abs(want) + RADAU5_PRED["atol"])
    assert np.all(np.abs(retry.dense.numpy() - want) <= bound)


@dataclasses.dataclass(frozen=True)
class Float32Fault(DummyModel):
    """y' = lam * y per system, where a row with ``bad32`` evaluates NaN in
    float32 after the first minute: a stand-in for a system that float32
    fails and float64 solves (from an initial step that float32 estimated
    as usual)."""

    def rhs_tuple(self, t, y, params, forcings=None):
        lam = params["lam"]
        if y[0].dtype == torch.float32:
            lam = torch.where((params["bad32"] > 0) & (torch.as_tensor(t) > 1.0), torch.nan, lam)
        return tuple(lam * yi for yi in y)


# Rows of the mix: 0 and 4 plain decay; 1 stiff, solved by the float32
# Radau (no retry); 2 float32's fault on a mild row, which step 1 resolves;
# 3 float32's fault on a stiff row, which goes on to step 2 and is solved
# there; 5 a NaN state, which stays failed.
LAM = [-0.1, -1e6, -0.1, -1e6, -0.1, -0.1]
BAD32 = [0, 0, 1, 1, 0, 0]
MIX_TF = 50.0


def _mix():
    params = {"lam": torch.tensor(LAM), "bad32": torch.tensor(BAD32, dtype=torch.float32)}
    y0 = torch.ones((len(LAM), 5))
    y0[5, 2] = torch.nan
    return y0, params


def _chain_by_hand(y0, params, qt, cfg):
    """The retry's chain through the plain versions: B1 and B2 in float32,
    then B1 in float64 on B2's failures and B2 in float64 on those B1
    flags again; returns (phase 1, the float32 B2, step 1, step 2) with
    their rows."""
    model = Float32Fault()
    from tiger_tpu_torch.solver.controller import initial_step

    h0 = initial_step(model, y0, 0.0, params, None, cfg)
    rk = rk45_plain(model, y0, h0, 0.0, MIX_TF, qt, params, None, cfg)
    rows = torch.nonzero(rk.stiff).squeeze(1)
    take = lambda r, dtype: (y0[r].to(dtype), h0[r].to(dtype), {k: v[r].to(dtype) for k, v in params.items()})
    y, h, p = take(rows, torch.float32)
    rd = radau_plain(model, y, h, 0.0, MIX_TF, qt, p, None, cfg)
    lost = rows[rd.failed]
    qt64 = None if qt is None else qt.double()
    y, h, p = take(lost, torch.float64)
    rk2 = rk45_plain(model, y, h, 0.0, MIX_TF, qt64, p, None, cfg)
    still = lost[rk2.stiff]
    y, h, p = take(still, torch.float64)
    rd2 = radau_plain(model, y, h, 0.0, MIX_TF, qt64, p, None, cfg)
    return (rk, rows), (rd, rows), (rk2, lost), (rd2, still)


@pytest.mark.parametrize("queries", [True, False], ids=["queries", "no_queries"])
def test_solve_retries_the_rows_radau_fails(monkeypatch, queries):
    """solve() with the retry's predicate forced on CPU tensors: each row
    B2 failed in float32 takes the float64 chain's result, cast to float32,
    bit for bit against the chain run by hand through the plain versions: a
    row that step 1 resolves (2), one that step 2 solves (3), one that stays
    failed (5).  The rows B2 solved keep its results; stiff and rk_stats
    stay phase 1's; radau_stats take step 2's counters without query times
    and keep the float32 Radau's with them."""
    monkeypatch.setattr(api, "retries_in_f64", lambda y0: True)
    y0, params = _mix()
    qt = torch.tensor([10.0, 25.0, 50.0]) if queries else None
    cfg = SolverConfig(rtol=1e-5, atol=1e-8)
    res = solve(Float32Fault(), y0, 0.0, MIX_TF, qt, params, config=cfg)
    (rk, rows), (rd, _), (rk2, lost), (rd2, still) = _chain_by_hand(y0, params, qt, cfg)
    assert rows.tolist() == [1, 2, 3, 5] and lost.tolist() == [2, 3, 5] and still.tolist() == [3, 5]
    assert res.failed.tolist() == [False] * 5 + [True]
    assert rd2.failed.tolist() == [False, True]

    want_y, want_d = rk.y_final.clone(), rk.dense.clone()
    want_y[1], want_d[1] = rd.y_final[0], rd.dense[0]
    want_y[2], want_d[2] = rk2.y_final[0].float(), rk2.dense[0].float()
    want_y[still], want_d[still] = rd2.y_final.float(), rd2.dense.float()
    for got, want in ((res.y_final, want_y), (res.dense, want_d)):
        assert got.dtype == torch.float32
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.isfinite(res.y_final[:5]).all()
    assert torch.equal(res.stiff, rk.stiff)
    for got, want in zip(res.rk_stats, rk.stats):
        assert torch.equal(got, want)
    radau_from = {1: rd, 2: rd, 3: rd2 if not queries else rd, 5: rd2 if not queries else rd}
    for row, src in radau_from.items():
        at = (still if src is rd2 else rows).tolist().index(row)
        for name, got, want in zip(RadauStats._fields, res.radau_stats, src.stats):
            assert int(got[row]) == int(want[at]), (row, name)
    for name, got in zip(RadauStats._fields, res.radau_stats):
        assert int(got[0]) == int(got[4]) == 0, name


def test_solve_on_the_cpu_makes_no_retry(monkeypatch):
    """Unpatched, a float32 solve() on the CPU retries nothing, as the JAX
    package does not there: the rows B2 fails stay failed."""
    def no_retry(*args, **kwargs):
        raise AssertionError("retry_failed_f64 called on the CPU")

    monkeypatch.setattr(api, "retry_failed_f64", no_retry)
    y0, params = _mix()
    res = solve(Float32Fault(), y0, 0.0, MIX_TF, None, params, config=SolverConfig(rtol=1e-5, atol=1e-8))
    assert res.n_stiff == 4 and res.failed.tolist() == [False, False, True, True, False, True]


@pytest.mark.parametrize("device,dtype,retries", [
    ("cuda", torch.float32, True), ("cuda", torch.float64, False),
    ("cpu", torch.float32, False), ("cpu", torch.float64, False)])
def test_retry_runs_for_float32_on_the_card_only(device, dtype, retries):
    """The retry's predicate reads y0's device and dtype only (no card is
    needed to ask it)."""
    y0 = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert api.retries_in_f64(y0) is retries


def test_radau_plain_stays_within_the_stiff_attempts_budget():
    """tests/test_radau_regression.py::test_stiff_lane_attempts_budget for
    the port's Radau: on the fully stiff 2-day basin (8 systems, float32,
    rtol 1e-5 / atol 1e-8) no system fails, none takes more than 5,000
    attempts, and the Newton sweeps stay at or under 6.0 an attempt."""
    y0, p, f = _scenario(8, np.float32, days=2.0, stiff_frac=1.0)
    ty0, tp, tf_, _ = convert.solver_inputs(np.asarray(y0), {k: np.asarray(v) for k, v in p.items()},
                                             np.asarray(f.data), f.meta, None, device="cpu",
                                             dtype=torch.float32)
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    from tiger_tpu_torch.solver.controller import initial_step

    h0 = initial_step(Model204(), ty0, 0.0, tp, tf_, cfg)
    res = radau_plain(Model204(), ty0, h0, 0.0, 2880.0, None, tp, tf_, cfg)
    assert not res.failed.any()
    att = res.stats.n_attempts
    assert int(att.max()) <= 5_000
    assert int(res.stats.n_newton.sum()) / max(int(att.sum()), 1) <= 6.0
