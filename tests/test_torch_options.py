"""The TPU kernels' last options in the port, against the JAX package.

B1's lockstep query crossing (``SolverConfig.dense_lockstep``) and bf16
forcing (``forcing_dtype='bf16'``): ``rk45_plain`` against the Pallas RK45
kernel in interpret mode.  B2's factor reuse (``radau_factor_reuse``):
``radau_plain`` against the Pallas Radau kernel in interpret mode, where
the TPU kernel's tile vote equals each system's (identical systems), and
on its own where the port's vote is each system's (a mixed batch against
each system solved alone).  Then ``solve()`` and ``run()`` with them.
Inputs are made with numpy from seeds; float32 against XLA at the parity
bounds of ``tests/test_config_fuzz.py`` (torch's and XLA's float32 libm
differ, so step sequences may part), the port against itself bit for bit.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _scenario
from tests.test_torch_config_fuzz import Decay2, JDecay2
from tiger_tpu.kernels.radau_pallas import radau_solve_pallas
from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
from tiger_tpu.models import DummyModel as JDummyModel
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.solver.config import SolverConfig as JSolverConfig
from tiger_tpu_torch import DummyModel, Model204, SolverConfig, convert, solve
from tiger_tpu_torch.forcing import ForcingSet
from tiger_tpu_torch.kernels.radau import radau_plain
from tiger_tpu_torch.kernels.rk45 import rk45_mismatch, rk45_plain
from tiger_tpu_torch.solver import radau_solve, rk45_solve
from tiger_tpu_torch.solver.controller import initial_step

CFG = dict(rtol=1e-5, atol=1e-8, max_steps=50_000)
# tests/test_config_fuzz.py's bounds, float32 port against float32 XLA.
Y_TOL, DENSE_TOL = dict(rtol=5e-4, atol=5e-6), dict(rtol=5e-3, atol=5e-5)
# tests/test_pallas_kernel.py::test_kernel_bf16_forcing_close_to_f32: bf16
# forcing is a ~0.4% input perturbation, tracked through Model 204's kinks.
BF16_TOL = dict(rtol=4e-2, atol=1e-4)


def _basin(s: int, days: float, stiff_frac: float, qt: np.ndarray):
    """(JAX inputs, port inputs) of ``_scenario``'s float32 basin."""
    y0, p, f = _scenario(s, jnp.float32, days=days, stiff_frac=stiff_frac)
    ours = convert.solver_inputs(
        np.asarray(y0), {k: np.asarray(v) for k, v in p.items()}, np.asarray(f.data), f.meta,
        qt, device="cpu", dtype=torch.float32)
    return (y0, p, f, jnp.asarray(qt)), ours


def _close(ours: torch.Tensor, ref, tol: dict, rows=slice(None)) -> None:
    np.testing.assert_allclose(ours.numpy()[rows], np.asarray(ref)[rows], **tol)


# --- (a) lockstep ------------------------------------------------------------


@pytest.mark.parametrize("spacing", [45.0, 20.0])
def test_lockstep_matches_the_pallas_kernel(spacing):
    """Queries every ``spacing`` minutes, off the hourly forcing boundaries,
    so the cap bites between them: 8 systems (one stiff) over a day, the
    same stiff and failed flags, and the non-stiff rows within the fuzz
    bounds of the Pallas kernel with the same option."""
    s, tf = 8, 1440.0
    qt = np.arange(0.0, tf + 1e-9, spacing, dtype=np.float32)
    (y0, p, f, jqt), (ty0, tp, tforc, tq) = _basin(s, 1.0, 1 / s, qt)
    cfg = dict(CFG, dense_lockstep=True)
    ref = rk45_solve_pallas(JModel204(), y0, 0.0, tf, jqt, p, f,
                            h0=jnp.full((s,), 1e-3, jnp.float32),
                            config=JSolverConfig(**cfg), interpret=True)
    ours = rk45_solve(Model204(), ty0, 0.0, tf, tq, tp, tforc, h0=torch.full((s,), 1e-3),
                      config=SolverConfig(**cfg))
    base = rk45_solve(Model204(), ty0, 0.0, tf, tq, tp, tforc, h0=torch.full((s,), 1e-3),
                      config=SolverConfig(**CFG))
    np.testing.assert_array_equal(ours.stiff.numpy(), np.asarray(ref.stiff))
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    assert int(ours.stiff.sum()) == 1 and not ours.failed.any()
    calm = ~ours.stiff.numpy()
    _close(ours.y_final, ref.y_final, Y_TOL, calm)
    _close(ours.dense, ref.dense, DENSE_TOL, calm)
    # The cap bit: more attempts than without it, as in the JAX kernel.
    att = ours.stats.n_attempts[calm]
    assert int(att.sum()) > int(base.stats.n_attempts[calm].sum())
    assert int(np.asarray(ref.stats.n_attempts)[calm].sum()) > int(base.stats.n_attempts[calm].sum())


def test_lockstep_caps_dummy_steps_at_a_dense_grid():
    """DummyModel over [0, 5] with 200 queries, denser than its own steps:
    the cap floors every step at the query spacing, so the attempts exceed
    the default run's, and the run stays within the fuzz bounds of the
    Pallas kernel's lockstep run."""
    s = 8
    y0 = np.random.default_rng(7).uniform(0.5, 2.0, (s, 5)).astype(np.float32)
    qt = (np.arange(1, 201) * 5.0 / 201).astype(np.float32)
    cfg = dict(CFG, dense_lockstep=True, fill_t0_queries=False)
    ref = rk45_solve_pallas(JDummyModel(), jnp.asarray(y0), 0.0, 5.0, jnp.asarray(qt),
                            h0=jnp.full((s,), 0.05, jnp.float32),
                            config=JSolverConfig(**cfg), interpret=True)
    args = (DummyModel(), torch.from_numpy(y0), 0.0, 5.0, torch.from_numpy(qt))
    ours = rk45_solve(*args, h0=torch.full((s,), 0.05), config=SolverConfig(**cfg))
    base = rk45_solve(*args, h0=torch.full((s,), 0.05),
                      config=SolverConfig(**dict(cfg, dense_lockstep=False)))
    assert not ours.stiff.any() and not np.asarray(ref.stiff).any()
    _close(ours.y_final, ref.y_final, Y_TOL)
    _close(ours.dense, ref.dense, DENSE_TOL)
    assert int(ours.stats.n_attempts.min()) >= 200
    assert int(ours.stats.n_attempts.sum()) > int(base.stats.n_attempts.sum())


# --- (b) bf16 forcing --------------------------------------------------------


def test_bf16_rounding_matches_jax():
    """2^20 seeded float32 bit patterns (every finite class: subnormals, a
    tie in every seventh, values that round to inf) and a few specials,
    rounded to bfloat16 by the port (torch) and by the JAX package
    (``astype(jnp.bfloat16)``): the same 16 bits each."""
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2**32, 2**20, dtype=np.uint64).astype(np.uint32)
    exp_all_ones = ((bits >> 23) & 0xFF) == 0xFF
    bits = np.where(exp_all_ones, bits & np.uint32(~(1 << 30) & 0xFFFFFFFF), bits).astype(np.uint32)
    bits[::7] = (bits[::7] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    x = np.concatenate([bits.view(np.float32),
                        np.array([np.inf, -np.inf, 0.0, -0.0, np.finfo(np.float32).max], np.float32)])
    ours = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(ours, ref)


def _bf16_basin(s: int = 16):
    """tests/test_pallas_kernel.py's bf16 case: Model 204 with seeded params,
    hourly rain and daily temperature, 6-hourly queries over a day."""
    from tests.test_model204 import NB_PARAMS
    from tiger_tpu.forcing import ForcingSet as JForcingSet

    rng = np.random.default_rng(5)
    p = {k: (np.full(s, v) * rng.uniform(0.9, 1.1, s)).astype(np.float32)
         for k, v in NB_PARAMS.items()}
    pr = np.tile(rng.uniform(0, 0.0015, (1, s)), (24, 1)).astype(np.float32)
    t2m = rng.uniform(2, 10, (1, s)).astype(np.float32)
    y0 = np.tile(np.asarray([0.01, 3.0, 0.0, 5.0, 0.2], np.float32), (s, 1))
    qt = np.arange(0.0, 1441.0, 360.0, dtype=np.float32)
    jf = JForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    ours = convert.solver_inputs(y0, p, np.asarray(jf.data), jf.meta, qt, device="cpu",
                                 dtype=torch.float32)
    return (jnp.asarray(y0), {k: jnp.asarray(v) for k, v in p.items()}, jf, jnp.asarray(qt)), ours


def test_rk45_bf16_reads_the_rounded_forcing():
    """With bf16, rk45_plain equals rk45_plain on forcing rounded to
    bfloat16 beforehand (and widened back), bit for bit, from the same h0;
    and differs from the float32 run (the rounding reached the rhs)."""
    _, (y0, p, f, qt) = _bf16_basin()
    model, h0 = Model204(), torch.full((y0.shape[0],), 1e-3)
    cfg = SolverConfig(**CFG)
    bf16 = rk45_plain(model, y0, h0, 0.0, 1440.0, qt, p, f,
                      dataclasses.replace(cfg, forcing_dtype="bf16"))
    pre = ForcingSet(f.data.to(torch.bfloat16).float(), f.meta)
    rounded = rk45_plain(model, y0, h0, 0.0, 1440.0, qt, p, pre, cfg)
    diff = rk45_mismatch(bf16, rounded)
    assert not any(diff.values()), diff
    plain32 = rk45_plain(model, y0, h0, 0.0, 1440.0, qt, p, f, cfg)
    assert rk45_mismatch(bf16, plain32)["y_final"] > 0
    # float64 reads the float32 data whatever forcing_dtype says.
    d64 = {k: v.double() for k, v in p.items()}
    a = rk45_plain(model, y0.double(), h0.double(), 0.0, 1440.0, qt.double(), d64, f,
                   dataclasses.replace(cfg, forcing_dtype="bf16"))
    b = rk45_plain(model, y0.double(), h0.double(), 0.0, 1440.0, qt.double(), d64, f, cfg)
    assert not any(rk45_mismatch(a, b).values())


def test_rk45_bf16_matches_the_pallas_kernel():
    """The port's bf16 run within tests/test_pallas_kernel.py's bf16 bound
    of the Pallas kernel's bf16 run, and of its own float32 run."""
    (jy0, jp, jf, jqt), (y0, p, f, qt) = _bf16_basin()
    s = y0.shape[0]
    cfg16 = dict(CFG, forcing_dtype="bf16")
    ref = rk45_solve_pallas(JModel204(), jy0, 0.0, 1440.0, jqt, jp, jf,
                            h0=jnp.full((s,), 1e-3, jnp.float32),
                            config=JSolverConfig(**cfg16), interpret=True)
    ours = rk45_solve(Model204(), y0, 0.0, 1440.0, qt, p, f, h0=torch.full((s,), 1e-3),
                      config=SolverConfig(**cfg16))
    f32 = rk45_solve(Model204(), y0, 0.0, 1440.0, qt, p, f, h0=torch.full((s,), 1e-3),
                     config=SolverConfig(**CFG))
    assert not ours.stiff.any() and not np.asarray(ref.stiff).any()
    _close(ours.y_final, ref.y_final, BF16_TOL)
    _close(ours.dense, ref.dense, BF16_TOL)
    _close(ours.y_final, f32.y_final.numpy(), BF16_TOL)


# --- (c, d) factor reuse -----------------------------------------------------

RADAU_CFG = dict(rtol=1e-4, atol=1e-6, max_steps=20_000, radau_factor_reuse=True)


@pytest.mark.parametrize("mode", ["embedded3", "radau5"])
def test_factor_reuse_matches_the_pallas_kernel(mode):
    """tests/test_radau_pallas.py's reuse case: 16 identical stiff decays
    (lam -80), float32 over 5 time units, where the TPU kernel's tile vote
    is each lane's.  radau_plain with reuse within that test's bound
    (5e-3 / 1e-5) of the Pallas kernel with reuse and of its own run
    without; the factorizations fewer than the attempts, and none missing."""
    s = 16
    cfg = dict(RADAU_CFG, radau_error_mode=mode)
    y0 = np.tile(np.asarray([2.0, 1.0], np.float32), (s, 1))
    lam, h0 = np.full((s,), -80.0, np.float32), np.full((s,), 0.01, np.float32)
    qt = np.asarray([1.0, 2.5, 5.0], np.float32)
    ref = radau_solve_pallas(JDecay2(), jnp.asarray(y0), 0.0, 5.0, jnp.asarray(qt),
                             {"lam": jnp.asarray(lam)}, h0=jnp.asarray(h0),
                             config=JSolverConfig(**cfg), interpret=True)
    args = (Decay2(), torch.from_numpy(y0), 0.0, 5.0, torch.from_numpy(qt),
            {"lam": torch.from_numpy(lam)})
    ours = radau_solve(*args, h0=torch.from_numpy(h0), config=SolverConfig(**cfg))
    base = radau_solve(*args, h0=torch.from_numpy(h0),
                       config=SolverConfig(**dict(cfg, radau_factor_reuse=False)))
    assert not ours.failed.any() and not np.asarray(ref.failed).any()
    tol = dict(rtol=5e-3, atol=1e-5)
    _close(ours.y_final, ref.y_final, tol)
    _close(ours.dense, ref.dense, tol)
    _close(ours.y_final, base.y_final.numpy(), tol)
    att, fct = int(ours.stats.n_attempts.sum()), int(ours.stats.n_fact.sum())
    assert 0 < fct < att, (fct, att)
    j_att, j_fct = int(np.asarray(ref.stats.n_attempts).sum()), int(np.asarray(ref.stats.n_fact).sum())
    assert 0 < j_fct < j_att, (j_fct, j_att)
    assert torch.equal(base.stats.n_fact, base.stats.n_attempts)
    # Identical systems: identical counters, in the port as in the tile.
    assert all(bool((x == x[0]).all()) for x in ours.stats)


@dataclasses.dataclass(frozen=True)
class DecayPoly:
    """Decay2 with y0 relaxing onto 1 / (1 + t): stiff for large |lam|, and
    only rational operations, which round alike at every place of a CPU
    batch (torch's CPU cos may not)."""

    N_EQ: int = 2

    def rhs_tuple(self, t, y, p, f=None):
        return (p["lam"] * (y[0] - 1.0 / (1.0 + t)), -0.5 * y[1])


@pytest.mark.parametrize("mode", ["embedded3", "radau5"])
def test_factor_reuse_gates_each_system(mode):
    """The port's refresh vote is each system's: a float64 batch mixing
    lam -80 and -1e3 gives every system the result it gets solved alone,
    bit for bit (states, dense rows, all five counters), though the two
    kinds refactor at their own rates (a tile's vote would make the mild
    ones refactor with the stiff ones)."""
    lam = torch.tensor([-80.0, -1e3, -1e3, -80.0], dtype=torch.float64)
    s = lam.shape[0]
    y0 = torch.tensor([[2.0, 1.0]], dtype=torch.float64).repeat(s, 1)
    h0 = torch.full((s,), 0.01, dtype=torch.float64)
    qt = torch.tensor([1.0, 2.5, 5.0], dtype=torch.float64)
    cfg = SolverConfig(**dict(RADAU_CFG, rtol=1e-6, atol=1e-9, radau_error_mode=mode))
    batch = radau_plain(DecayPoly(), y0, h0, 0.0, 5.0, qt, {"lam": lam}, None, cfg)
    assert not batch.failed.any()
    for i in range(s):
        one = slice(i, i + 1)
        alone = radau_plain(DecayPoly(), y0[one], h0[one], 0.0, 5.0, qt, {"lam": lam[one]}, None, cfg)
        assert torch.equal(batch.y_final[one], alone.y_final), i
        assert torch.equal(batch.dense[one], alone.dense), i
        for name, x, y in zip(alone.stats._fields, batch.stats, alone.stats):
            assert torch.equal(x[one], y), (i, name)
    fct, att = batch.stats.n_fact, batch.stats.n_attempts
    assert bool((fct < att).all()) and bool((fct > 0).all())
    mild, stiff = lam == -80.0, lam == -1e3
    assert set(fct[mild].tolist()).isdisjoint(fct[stiff].tolist())


# --- (e) solve() and run() ---------------------------------------------------


def test_solve_with_every_option_equals_its_plain_chain():
    """solve() with lockstep, bf16 forcing and factor reuse on the CPU
    equals its chain of plain versions bit for bit (the initial steps on
    the float32 data, rk45_plain, radau_plain on the rows it flags, the
    merge), and lies within the bf16 bound of the float32 solve without
    them: 8 systems (one stiff) over 6 hours, queries every 45 minutes."""
    s, tf = 8, 360.0
    qt = np.arange(0.0, tf + 1e-9, 45.0, dtype=np.float32)
    _, (y0, p, f, tq) = _basin(s, 0.25, 1 / s, qt)
    model = Model204()
    base = SolverConfig(**dict(CFG, max_steps=100_000))
    cfg = dataclasses.replace(base, dense_lockstep=True, forcing_dtype="bf16",
                              radau_factor_reuse=True)
    res = solve(model, y0, 0.0, tf, tq, p, f, cfg)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    assert torch.equal(h0, initial_step(model, y0, 0.0, p, f, base))  # float32 data
    rk = rk45_plain(model, y0, h0, 0.0, tf, tq, p, f, cfg)
    rows = torch.nonzero(rk.stiff).squeeze(1)
    assert res.n_stiff == rows.numel() == 1 and not res.failed.any()
    rd = radau_plain(model, y0[rows], h0[rows], 0.0, tf, tq, {k: v[rows] for k, v in p.items()},
                     f.take_systems(rows), cfg)
    assert 0 < int(rd.stats.n_fact.sum()) < int(rd.stats.n_attempts.sum())
    want_y, want_d = rk.y_final.clone(), rk.dense.clone()
    want_y[rows], want_d[rows] = rd.y_final, rd.dense
    assert torch.equal(res.y_final, want_y) and torch.equal(res.dense, want_d)
    f32 = solve(model, y0, 0.0, tf, tq, p, f, base)
    _close(res.y_final, f32.y_final.numpy(), BF16_TOL)
    _close(res.dense, f32.dense.numpy(), BF16_TOL)


@pytest.mark.parametrize("chunk_days", [0.0, 1.0], ids=["whole", "windowed"])
def test_run_with_bf16_forcing(tmp_path, monkeypatch, chunk_days):
    """run(cfg) with solver.forcing_precision bf16, whole (24 links, two
    stiff, over 6 hours) and in 1-day windows (12 links, none stiff, over 2
    days; a window is a whole number of the daily temperature's samples):
    every solve it makes gets forcing_dtype 'bf16'; whole, its files equal
    the direct solve of the same config (scenario.solve_written_basin) bit
    for bit; both lie within the bf16 bound of the float32 run."""
    from tiger_tpu_torch.scenario import write_basin
    import os

    from tiger_tpu_torch import chunked
    from tiger_tpu_torch import solver
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import solve_written_basin

    seen = []
    for module in (solver, chunked):  # run() imports solver.solve when it runs
        def spy(*a, _real=module.solve, **kw):
            seen.append((kw["config"] if "config" in kw else a[7]).forcing_dtype)
            return _real(*a, **kw)

        monkeypatch.setattr(module, "solve", spy)
    outs = {}
    for precision in ("bf16", "f32"):
        doc = write_basin(str(tmp_path / "basin"), 12 if chunk_days else 24,
                          days=2.0 if chunk_days else 0.25,
                          stiff_frac=0.0 if chunk_days else 0.05, n_lon=8)
        doc["output"]["path"] = str(tmp_path / precision)
        doc["time"]["chunk_days"] = chunk_days
        doc["solver"]["forcing_precision"] = precision
        cfg = config_from_dict(doc)
        seen.clear()
        out = run(cfg, device="cpu")
        assert seen and set(seen) == {precision}, seen
        assert out["n_failed"] == 0 and (out["n_stiff"] > 0) == (not chunk_days)
        outs[precision] = {v: read_netcdf(os.path.join(cfg.output.path, f"{v}_basin_rank_0.nc"),
                                          ("outputs",))[0]["outputs"] for v in ("dense", "final")}
        if precision == "bf16" and not chunk_days:
            res = solve_written_basin(cfg, "cpu")[0]
            assert np.array_equal(outs["bf16"]["dense"], res.dense.numpy())
            assert np.array_equal(outs["bf16"]["final"], res.y_final.numpy())
    for v in ("dense", "final"):
        np.testing.assert_allclose(outs["bf16"][v], outs["f32"][v], **BF16_TOL)
        assert not np.array_equal(outs["bf16"][v], outs["f32"][v])
