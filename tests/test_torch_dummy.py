"""DummyModel (the reference's 5-state linear test system) in the port
against the JAX package, on the CPU.

The port's plain versions of both kernels (``rk45_plain``, ``radau_plain``:
what a CPU tensor runs, and what the CUDA instances ``dummy/*`` equal bit
for bit on the card) against the JAX package's vmap solvers and its Pallas
kernels in interpret mode: in float64 (the JAX side under x64, the Pallas
modules' ``jnp.float32`` read as float64) the same attempts and the
trajectories within 1e-12 relative; in float32 Model 204's rule (5e-4
relative, 1e-7 absolute, attempts within 2%).  Then the reference's
10,000-query golden grid through ``solve()``, the kernels' input check for
a model without parameters, and ``run()`` with ``model.uid: 1``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli import make_scenario
from test_torch_chunked import StiffMix, TimeProbe
from test_torch_cli import OUTPUTS, _assert_close, _configs, _read
from test_torch_radau import _Float64Jnp
from tiger_tpu import solve as j_solve
from tiger_tpu.kernels import radau_pallas, rk45_pallas
from tiger_tpu.models import DummyModel as JDummyModel
from tiger_tpu.run import run as j_run
from tiger_tpu.solver import SolverConfig as JSolverConfig
from tiger_tpu.solver import rk45_solve as j_rk45_solve
from tiger_tpu.solver.controller import initial_step as j_initial_step
from tiger_tpu.solver.radau import radau_solve as j_radau_solve
from tiger_tpu_torch import DummyModel, SolverConfig, solve
from tiger_tpu_torch.kernels._common import kernel_inputs, kernel_model
from tiger_tpu_torch.kernels.radau import radau_plain
from tiger_tpu_torch.kernels.rk45 import rk45_plain
from tiger_tpu_torch.run import run

S, TF = 24, 5.0
#: The reference's tolerances in float64; the main path's in float32.
CFG = {np.float64: dict(rtol=1e-6, atol=1e-9), np.float32: dict(rtol=1e-5, atol=1e-8)}
GOLDEN = [1.91791, 1.90017, 2.39397, 1.71872, 3.06922]
CASES = [pytest.param(np.float64, "vmap", id="f64-vmap"),
         pytest.param(np.float64, "pallas", id="f64-pallas"),
         pytest.param(np.float32, "vmap", id="f32-vmap"),
         pytest.param(np.float32, "pallas", id="f32-pallas")]


def _inputs(np_dtype, tf=TF):
    """y0 [S, 5] uniform over 0.5-2.0 from a seed, 11 queries over [0, tf]
    and the initial steps (the JAX package's, handed to both sides)."""
    y0 = np.random.default_rng(11).uniform(0.5, 2.0, (S, 5)).astype(np_dtype)
    qt = np.linspace(0.0, tf, 11).astype(np_dtype)
    jcfg = JSolverConfig(**CFG[np_dtype])
    h0 = np.asarray(j_initial_step(JDummyModel(), jnp.asarray(y0), 0.0, None, None, jcfg))
    return y0, qt, h0, jcfg, SolverConfig(**CFG[np_dtype])


def _hold(ours, ref, np_dtype, fields=None):
    """float64: the same attempts (the counters ``fields``, all by
    default), y and dense within 1e-12; float32: 5e-4 relative / 1e-7
    absolute, attempts within 2%."""
    stats = ref.stats
    if np_dtype == np.float64:
        for name in fields or ours.stats._fields:
            np.testing.assert_array_equal(getattr(ours.stats, name).numpy(),
                                          np.asarray(getattr(stats, name)), name)
        rtol, atol = 1e-12, 1e-14
    else:
        att, ref_att = ours.stats.n_attempts.numpy(), np.asarray(stats.n_attempts)
        assert abs(int(att.sum()) - int(ref_att.sum())) <= 0.02 * ref_att.sum()
        rtol, atol = 5e-4, 1e-7
    assert ours.y_final.dtype == torch.from_numpy(np.zeros(1, np_dtype)).dtype
    np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=rtol, atol=atol)


@pytest.mark.parametrize("np_dtype,jax_path", CASES)
def test_rk45_plain_matches_jax(monkeypatch, np_dtype, jax_path):
    """B1's plain version against the JAX vmap RK45 and the Pallas B1
    (interpret mode), from the same initial steps: no system stiff."""
    y0, qt, h0, jcfg, cfg = _inputs(np_dtype)
    args = (JDummyModel(), jnp.asarray(y0), 0.0, TF, jnp.asarray(qt))
    if jax_path == "vmap":
        ref = j_rk45_solve(*args, h0=jnp.asarray(h0), config=jcfg)
    else:
        if np_dtype == np.float64:
            monkeypatch.setattr(rk45_pallas, "jnp", _Float64Jnp("jax.numpy"))
        ref = rk45_pallas.rk45_solve_pallas(*args, h0=jnp.asarray(h0), config=jcfg, interpret=True)
        assert np.asarray(ref.dense).dtype == np_dtype
    ours = rk45_plain(DummyModel(), torch.tensor(y0), torch.tensor(h0), 0.0, TF,
                      torch.tensor(qt), None, None, cfg)
    assert not ours.stiff.any() and not np.asarray(ref.stiff).any()
    assert not ours.failed.any()
    _hold(ours, ref, np_dtype)


@pytest.mark.parametrize("np_dtype,jax_path", CASES)
def test_radau_plain_matches_jax(monkeypatch, np_dtype, jax_path):
    """B2's plain version against the JAX vmap Radau and the Pallas B2
    (interpret mode), from the same initial steps, over the golden span:
    no system fails.  The vmap path's full Newton (each stage's Jacobian,
    every sweep) takes one sweep more or fewer on 2 of the 24 systems here
    (4,160 against the port's 4,158 in all), so against it the float64
    rule holds the accepted, rejected and attempted counts; against the
    Pallas B2, whose simplified Newton the port shares, every counter."""
    y0, qt, h0, jcfg, cfg = _inputs(np_dtype)
    args = (JDummyModel(), jnp.asarray(y0), 0.0, TF, jnp.asarray(qt))
    if jax_path == "vmap":
        ref = j_radau_solve(*args, h0=jnp.asarray(h0), config=jcfg)
    else:
        if np_dtype == np.float64:
            monkeypatch.setattr(radau_pallas, "jnp", _Float64Jnp("jax.numpy"))
        ref = radau_pallas.radau_solve_pallas(*args, h0=jnp.asarray(h0), config=jcfg,
                                              interpret=True)
        assert np.asarray(ref.dense).dtype == np_dtype
    ours = radau_plain(DummyModel(), torch.tensor(y0), torch.tensor(h0), 0.0, TF,
                       torch.tensor(qt), None, None, cfg)
    assert not ours.failed.any() and not np.asarray(ref.failed).any()
    vmap_counts = ("n_accepted", "n_rejected", "n_attempts")
    _hold(ours, ref, np_dtype, vmap_counts if jax_path == "vmap" else None)


def test_golden_grid_through_solve_matches_jax():
    """The reference's artifacts: 4 systems of ones over t in [0, 5] at
    rtol 1e-6 / atol 1e-9 and the 10,000-query grid t_q = (q+1) 5/10001
    (fill_t0_queries off), through both packages' solve(): the golden final
    state within 5e-6, and the port's dense rows within 1e-12 of the JAX
    package's (the rtol 1e-10 asked of the grid holds with room)."""
    qt = (np.arange(1, 10001) * 5.0) / 10001.0
    ref = j_solve(JDummyModel(), jnp.ones((4, 5)), 0.0, 5.0, jnp.asarray(qt),
                  config=JSolverConfig(fill_t0_queries=False))
    ours = solve(DummyModel(), torch.ones((4, 5), dtype=torch.float64), 0.0, 5.0,
                 torch.tensor(qt, dtype=torch.float64), config=SolverConfig(fill_t0_queries=False))
    assert ours.n_stiff == 0 and not ours.failed.any()
    assert ours.dense.shape == (4, 10_000, 5)
    np.testing.assert_allclose(ours.y_final.numpy(), np.tile(GOLDEN, (4, 1)), rtol=5e-6)
    np.testing.assert_allclose(ours.y_final.numpy(), np.asarray(ref.y_final), rtol=1e-12)
    np.testing.assert_allclose(ours.dense.numpy(), np.asarray(ref.dense), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("params", ["none", "csv_fields"])
def test_kernel_inputs_take_dummy_without_params(params):
    """The kernels carry DummyModel as model 2, with no parameter block: its
    input check takes params None or any dict (run() passes the CSV's
    fields whatever the model) and returns no block; it takes a finite shift
    and refuses a NaN one.  Subclasses of DummyModel that change the rhs
    (StiffMix) and models without a device twin (TimeProbe) stay refused."""
    y0 = torch.ones((6, 5), dtype=torch.float64)
    h0 = torch.full((6,), 0.01, dtype=torch.float64)
    p = None if params == "none" else {"Hu": torch.ones(6), "lam": torch.ones(3)}
    assert kernel_model("rk45", DummyModel()) == (2, "dummy/", False)
    for shift in (0.0, 1440.0):
        y_soa, block = kernel_inputs("rk45", DummyModel(), y0, h0, p, None, None, t_shift=shift)
        assert y_soa.shape == (5, 6) and block is None
    with pytest.raises(ValueError, match="finite"):
        kernel_inputs("radau", DummyModel(), y0, h0, p, None, None, t_shift=float("nan"))
    for other in (StiffMix(), TimeProbe()):
        with pytest.raises(NotImplementedError, match="Model 204, Model 200 and DummyModel only"):
            kernel_inputs("rk45", other, y0, h0, p, None, None)


@pytest.mark.parametrize("windowed", [False, True], ids=["unchunked", "windowed"])
def test_run_model_uid_1_matches_jax(tmp_path, windowed):
    """run() with model.uid 1 on tests/test_cli.py's 6-link basin against
    the JAX package's run, whole and in 1-day windows with a daily
    checkpoint: the same summary counts and every output file within the
    f64 bounds of tests/test_torch_cli.py."""
    changes = dict(model__uid=1, model__name="DummyModel")
    if windowed:
        changes.update(time__chunk_days=1.0, output__checkpoint_interval="1d")
    jcfg, cfg = _configs(make_scenario(tmp_path), tmp_path, **changes)
    ref, ours = j_run(jcfg, use_mesh=False), run(cfg, device="cpu")
    for key in ("num_systems", "n_stiff", "n_failed"):
        assert ours[key] == ref[key], key
    assert ours["n_failed"] == 0
    for name, var in OUTPUTS:
        a, ids_a, _ = _read(tmp_path / "torch" / f"{name}_basin_rank_0.nc", var)
        b, ids_b, _ = _read(tmp_path / "jax" / f"{name}_basin_rank_0.nc", var)
        assert np.array_equal(ids_a, ids_b), name
        _assert_close(a, b, "f64")
