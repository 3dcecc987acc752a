"""Model 200 (Hamon PET and the ET ramp) in the port against the JAX package, on the CPU.

The physics (``models/et.py``, ``models/soiltemp.py``, ``Model200``), the
two-phase ``solve()``, the plain B1 against the Pallas B1 in interpret mode,
the plain B2 against the Pallas B2 run in float64, B2's attempts budget,
windowed runs and the CLI, each on numpy-seeded inputs given to both
packages (the JAX side with exact trig, ``approx_trig=False``).

Tolerances, per element, |ours - ref| <= RTOL * |ref| + ATOL:
  - One evaluation (the PET, the ramp, the rhs), and float64 solves short
    enough that both packages still take the same steps (the Radau
    kernel's first 30 minutes, B1's first hour, solve()'s and a window's
    first 30 minutes): float64 RTOL 1e-9 (ATOL 1e-12, 1e-20 on the PET in
    m/min, for values near zero); float32 RTOL 5e-4 and ATOL 5e-4 of each
    state's largest magnitude, the port's float32 bounds
    (``test_torch_cli.py``'s).  The time shift is held at the first bound:
    each such test starts near an equinox (EQUINOX), where the day length
    moves fastest, and checks that the same run with the shift dropped or
    doubled falls outside it.  The whole-solve bound below is not one a
    day's shift exceeds.
  - Whole solves (``solve()``, windows, the CLI): float64 RTOL 1e-6 and
    float32 the bound above, each with ATOL SLIVER_M more.  torch's libm
    and XLA's own CPU functions differ in the last bit (over the rhs's
    domain: 14% of exp's results, 25% of asin's, 0.3-13% of the others';
    Model 204 calls none of them), so the two packages' accept decisions
    part after some hundred attempts, and their step sequences with them.
    Where one of them then lands inside a forcing sample's snap window
    (forcing.ZOH_SNAP: 0.03 min of an hourly sample) it integrates that
    sliver with the next sample's rain: up to 0.0015 m/min x 0.03 min =
    4.5e-5 m a boundary.  So the float64 attempts are not held equal here.
"""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli import OUTPUTS, _configs, _read
from test_cli import make_scenario
from test_torch_radau import _Float64Jnp
from tiger_tpu import chunked as jchunked
from tiger_tpu.forcing import ForcingSet as JForcingSet
from tiger_tpu.kernels import radau_pallas, rk45_pallas
from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
from tiger_tpu.models import Model200 as JModel200
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.models.et import et_actual as j_et_actual
from tiger_tpu.models.et import hamon_pet as j_hamon_pet
from tiger_tpu.models.soiltemp import soiltemp as j_soiltemp
from tiger_tpu.run import run as j_run
from tiger_tpu.solver.api import solve as j_solve
from tiger_tpu.solver.config import SolverConfig as JSolverConfig
from tiger_tpu.solver.controller import initial_step as j_initial_step
from tiger_tpu_torch import Model200, Model204, SolverConfig, chunked, convert, get_model, solve
from tiger_tpu_torch.forcing import ForcingSet
from tiger_tpu_torch.kernels.radau import radau_plain
from tiger_tpu_torch.kernels.rk45 import rk45_plain
from tiger_tpu_torch.models.et import et_actual, hamon_pet
from tiger_tpu_torch.models.model204 import Y0_COMMON
from tiger_tpu_torch.models.soiltemp import soiltemp
from tiger_tpu_torch.params import load_spatial_params, model_params
from tiger_tpu_torch.run import run
from tiger_tpu_torch.scenario import scenario, scenario_arrays
from tiger_tpu_torch.solver.controller import initial_step

DOY0 = 182.0  # early July: the ET term is active
EQUINOX = 80.0  # the day length moves fastest: where a wrong time shift shows most
F64 = dict(rtol=1e-6, atol=1e-9)
F32 = dict(rtol=1e-5, atol=1e-8, max_steps=100_000)
DTYPES = {np.float64: torch.float64, np.float32: torch.float32}
SLIVER_M = 5e-5  # one hourly sample's rain over its snap window (module docstring)


def _close(ours, ref, np_dtype, atol64=1e-12):
    """The module docstring's bound of ``np_dtype``."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    if np_dtype == np.float64:
        np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=atol64)
    else:
        atol = 5e-4 * np.abs(ref).max(axis=tuple(range(ref.ndim - 1))) if ref.ndim > 1 else 5e-4 * np.abs(ref).max()
        np.testing.assert_array_less(np.abs(ours - ref), 5e-4 * np.abs(ref) + atol + 1e-30)


def _outside_f64(ours, ref) -> bool:
    """Whether ``ours`` lies outside ``_close``'s float64 bound of ``ref``
    somewhere: a run with the time shift dropped or doubled must."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    return bool((np.abs(ours - ref) > 1e-9 * np.abs(ref) + 1e-12).any())


def _close_solve(ours, ref, np_dtype, sliver=SLIVER_M):
    """The module docstring's bound of a whole solve in ``np_dtype``
    (``sliver``: SLIVER_M in the units of the values)."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    if np_dtype == np.float64:
        bound = 1e-6 * np.abs(ref) + sliver
    else:
        bound = 5e-4 * np.abs(ref) + 5e-4 * np.abs(ref).max(axis=tuple(range(ref.ndim - 1))) + sliver
    np.testing.assert_array_less(np.abs(ours - ref), bound)


def _basin(s_count, days, np_dtype):
    """(y0, params, JAX ForcingSet) of scenario()'s basin, no stiff rows, the
    latitude one a system over 25-50 degrees."""
    p, series, dt_min = scenario_arrays(s_count, days)
    p["lat"] = np.random.default_rng(200).uniform(25.0, 50.0, s_count)
    p = {k: np.asarray(v, np_dtype) for k, v in p.items()}
    y0 = np.tile(np.asarray(Y0_COMMON, np_dtype), (s_count, 1))
    return y0, p, JForcingSet.from_series(series, dt_min)


def _both(s_count, days, np_dtype, qt=None):
    """(JAX inputs, port inputs) of ``_basin``: (y0, params, forcings, qt)."""
    y0, p, jf = _basin(s_count, days, np_dtype)
    jax_in = (jnp.asarray(y0), {k: jnp.asarray(v) for k, v in p.items()}, jf,
              None if qt is None else jnp.asarray(qt))
    ours = convert.solver_inputs(y0, p, np.asarray(jf.data), jf.meta, qt, device="cpu",
                                 dtype=DTYPES[np_dtype])
    return jax_in, ours


# --- the physics -------------------------------------------------------------


def _pet_inputs(np_dtype):
    """Temperatures over -10..35 degC with 0 itself, latitudes over the
    basins' 25-50 degrees and the polar caps (up to 89.5 north and south,
    where the daylight's acos argument leaves [-1, 1]), every day of the
    year."""
    rng = np.random.default_rng(10)
    n = 4096
    temp = rng.uniform(-10.0, 35.0, n)
    temp[::97] = 0.0
    lat = np.concatenate([rng.uniform(25.0, 50.0, n // 2), rng.uniform(66.0, 89.5, n // 4),
                          -rng.uniform(66.0, 89.5, n // 4)])
    doy = rng.uniform(1.0, 366.0, n)
    return [np.asarray(x, np_dtype) for x in (temp, lat, doy)]


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_hamon_pet_matches_jax(np_dtype):
    temp, lat, doy = _pet_inputs(np_dtype)
    ref = np.asarray(j_hamon_pet(jnp.asarray(temp), jnp.asarray(lat), jnp.asarray(doy),
                                 approx_trig=False))
    ours = hamon_pet(*(torch.from_numpy(x) for x in (temp, lat, doy))).numpy()
    _close(ours, ref, np_dtype, atol64=1e-20)
    # Both branches of the polar rule were taken, and T <= 0 gives no PET.
    polar = np.abs(lat) > 66.0
    wt = 216.7 * 6.108 * np.exp(17.26939 * temp / (temp + 237.3)) / (temp + 273.3)
    day = 1.6169e-6 * 4.0 * wt * 60.0 / 1000.0  # daylight 2 (x 12 h)
    is_day = polar & (temp > 0) & np.isclose(ours, day, rtol=1e-5)
    is_night = polar & (temp > 0) & (ours == 0.0)
    assert is_day.sum() > 100 and is_night.sum() > 100
    assert not ours[temp <= 0.0].any() and (ours[temp > 0.0] >= 0.0).all()


def test_convert_carries_the_jax_models_across():
    """convert.model: the JAX package's Model 200 and Model 204 become the
    port's, fields by name; approx_trig, which the port does not carry, is
    refused."""
    assert convert.model(JModel200(doy0=183.0, safe_pow=False)) == Model200(doy0=183.0, safe_pow=False)
    assert convert.model(JModel204(safe_pow=False)) == Model204(safe_pow=False)
    with pytest.raises(ValueError, match="approx_trig"):
        convert.model(JModel200(approx_trig=True))


def test_et_actual_matches_jax():
    rng = np.random.default_rng(11)
    e_max, s = rng.uniform(0.0, 1e-5, 1000), rng.uniform(-0.2, 1.3, 1000)
    sw, ss = rng.uniform(0.1, 0.3, 1000), rng.uniform(0.6, 0.9, 1000)
    ref = np.asarray(j_et_actual(*(jnp.asarray(x) for x in (e_max, s, sw, ss))))
    ours = et_actual(*(torch.from_numpy(x) for x in (e_max, s, sw, ss))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-15, atol=0)
    assert (ours[s > ss] == e_max[s > ss]).all() and not ours[s <= sw].any()


def test_soiltemp_matches_jax():
    rng = np.random.default_rng(12)
    t_air, t_z, d_snow = rng.uniform(-20, 30, 100), rng.uniform(-5, 25, 100), rng.uniform(0, 2, 100)
    ref = np.asarray(j_soiltemp(*(jnp.asarray(x) for x in (t_air, t_z, d_snow))))
    ours = soiltemp(*(torch.from_numpy(x) for x in (t_air, t_z, d_snow))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("doy0", [1.0, DOY0, 300.0])
@pytest.mark.parametrize("np_dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_rhs_matches_jax(np_dtype, doy0):
    """Model200.rhs_tuple over derived_params at random states (a negative
    surface store among them), times over 3 days and forcings."""
    rng = np.random.default_rng(13)
    s_count = 512
    _, p, _ = _basin(s_count, 1.0, np_dtype)
    y = rng.uniform(0.0, 2.0, (5, s_count)).astype(np_dtype)
    y[2] -= 0.25
    y[1] *= p["Hu"] * 1.5  # the static store below and above sw, ss
    t = rng.uniform(0.0, 4320.0, s_count).astype(np_dtype)
    forc = [rng.uniform(0.0, 1e-3, s_count).astype(np.float32),
            rng.uniform(-5.0, 30.0, s_count).astype(np.float32)]
    jm, tm = JModel200(doy0=doy0), Model200(doy0=doy0)
    jp = jm.derived_params({k: jnp.asarray(v) for k, v in p.items()})
    tp = tm.derived_params({k: torch.from_numpy(v) for k, v in p.items()})
    for key in ("_sin_lat", "_cos_lat"):
        _close(tp[key].numpy(), np.asarray(jp[key]), np_dtype)
    ref = np.stack([np.asarray(v) for v in jm.rhs_tuple(jnp.asarray(t), [jnp.asarray(v) for v in y],
                                                        jp, [jnp.asarray(f) for f in forc])])
    ours = torch.stack(tm.rhs_tuple(torch.from_numpy(t), [torch.from_numpy(v) for v in y], tp,
                                    [torch.from_numpy(f) for f in forc])).numpy()
    # Per state: a bound of the state's largest rate (the rates cancel to
    # near zero in places).
    scale = np.abs(ref).max(axis=1, keepdims=True)
    rtol = 1e-9 if np_dtype == np.float64 else 5e-4
    assert ours.dtype == ref.dtype
    np.testing.assert_array_less(np.abs(ours - ref), rtol * (np.abs(ref) + scale) + 1e-300)


# --- the solvers -------------------------------------------------------------

#: case: (dtype, t_shift, doy0, minutes, query interval).
SOLVE_CASES = {"f64": (np.float64, 0.0, DOY0, 720.0, 60.0),
               "f32": (np.float32, 0.0, DOY0, 720.0, 60.0),
               "f64_shift": (np.float64, 1440.0, EQUINOX, 30.0, 10.0)}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_solve_matches_jax(case):
    """Both packages' two-phase solve() of Model 200: over 12 hours from
    early July, no system stiff, as in the JAX package's benchmark, within
    a whole solve's bound; and shifted a day from near the equinox over the
    first 30 minutes, within 1e-9, where the port's run with the shift
    dropped or doubled is not."""
    np_dtype, shift, doy0, tf, dq = SOLVE_CASES[case]
    qt = np.arange(0.0, tf + 1e-9, dq, dtype=np_dtype)
    (jy, jp, jf, jq), (ty, tp, tf_, tq) = _both(16, 1.0, np_dtype, qt)
    cfg = F64 if np_dtype == np.float64 else F32
    jm = JModel200(doy0=doy0)
    ref = j_solve(jm, jy, 0.0, tf, jq, jp, jf, config=JSolverConfig(**cfg), t_shift=shift)
    ours = solve(convert.model(jm), ty, 0.0, tf, tq, tp, tf_, SolverConfig(**cfg), t_shift=shift)
    assert ours.n_stiff == int(np.asarray(ref.stiff).sum()) == 0
    assert not ours.failed.any()
    if not shift:
        _close_solve(ours.y_final.numpy(), ref.y_final, np_dtype)
        _close_solve(ours.dense.numpy(), ref.dense, np_dtype)
        return
    _close(ours.y_final.numpy(), ref.y_final, np_dtype)
    _close(ours.dense.numpy(), ref.dense, np_dtype)
    for wrong in (0.0, 2.0 * shift):
        other = solve(Model200(doy0=doy0), ty, 0.0, tf, tq, tp, tf_, SolverConfig(**cfg), t_shift=wrong)
        assert _outside_f64(other.dense.numpy(), ref.dense), wrong


def test_rk45_plain_matches_the_pallas_kernel():
    """rk45_plain against the JAX package's B1 (rk45_solve_pallas) in the
    Pallas interpreter, float32, over 3 hours with a one-day shift: the
    float32 bound, the same stiff flags."""
    tf, shift = 180.0, 1440.0
    qt = np.arange(0.0, tf + 1e-9, 60.0, dtype=np.float32)
    (jy, jp, jf, jq), (ty, tp, tf_, tq) = _both(8, 1.0, np.float32, qt)
    jcfg, cfg = JSolverConfig(**F32), SolverConfig(**F32)
    jm = JModel200(doy0=DOY0)
    tm = convert.model(jm)
    h0 = j_initial_step(jm, jy, 0.0, jp, jf, jcfg)
    ref = rk45_solve_pallas(jm, jy, 0.0, tf, jq, jp, jf, h0=h0, config=jcfg, interpret=True,
                            t_shift=shift)
    ours = rk45_plain(tm, ty, torch.from_numpy(np.array(h0)), 0.0, tf, tq, tp, tf_, cfg, shift)
    np.testing.assert_array_equal(ours.stiff.numpy(), np.asarray(ref.stiff))
    assert not ours.stiff.any()
    _close(ours.y_final.numpy(), ref.y_final, np.float32)
    _close(ours.dense.numpy(), ref.dense, np.float32)


def test_rk45_plain_matches_the_pallas_kernel_f64(monkeypatch):
    """rk45_plain against the JAX package's B1 (rk45_solve_pallas, interpret
    mode) run in float64 (its module's jnp patched, as the Radau test below
    does), 8 systems from near the equinox over the first hour shifted a
    day: the same step counts and flags, the trajectories within 1e-9; the
    port's run with the shift dropped or doubled lies outside that bound."""
    tf, shift = 60.0, 1440.0
    qt = np.arange(0.0, tf + 1e-9, 30.0)
    (jy, jp, jf, jq), (ty, tp, tf_, tq) = _both(8, 1.0, np.float64, qt)
    jcfg, cfg = JSolverConfig(**F64), SolverConfig(**F64)
    jm = JModel200(doy0=EQUINOX)
    tm = convert.model(jm)
    h0 = j_initial_step(jm, jy, 0.0, jp, jf, jcfg)
    monkeypatch.setattr(rk45_pallas, "jnp", _Float64Jnp("jax.numpy"))
    ref = rk45_pallas.rk45_solve_pallas(jm, jy, 0.0, tf, jq, jp, jf, h0=h0, config=jcfg,
                                        interpret=True, t_shift=shift)
    assert np.asarray(ref.dense).dtype == np.float64
    th0 = torch.from_numpy(np.array(h0))
    ours = rk45_plain(tm, ty, th0, 0.0, tf, tq, tp, tf_, cfg, shift)
    np.testing.assert_array_equal(ours.stiff.numpy(), np.asarray(ref.stiff))
    for got, want in zip(ours.stats, ref.stats):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(ours.y_final.numpy(), ref.y_final, np.float64)
    _close(ours.dense.numpy(), ref.dense, np.float64)
    for wrong in (0.0, 2.0 * shift):
        other = rk45_plain(tm, ty, th0, 0.0, tf, tq, tp, tf_, cfg, wrong)
        assert _outside_f64(other.dense.numpy(), ref.dense), wrong


def test_radau_plain_matches_the_pallas_kernel_f64(monkeypatch):
    """radau_plain with Model 200 against the JAX package's B2 pipeline
    (radau_solve_pallas's, interpret mode) run in float64 on 4 systems over
    30 minutes shifted a day: the same failed rows and counters, the
    trajectories within 1e-9."""
    tf, shift = 30.0, 1440.0
    qt = np.arange(0.0, tf + 1e-9, 10.0)
    (jy, jp, jf, jq), (ty, tp, tf_, tq) = _both(4, 1.0, np.float64, qt)
    jm, tm = JModel200(doy0=DOY0), Model200(doy0=DOY0)
    h0 = np.full(4, 1e-3)
    monkeypatch.setattr(radau_pallas, "jnp", _Float64Jnp("jax.numpy"))
    ref = radau_pallas._pipeline(jm, jy, jnp.asarray(h0), jp, jf.data, jq, 0.0, tf, jf.meta,
                                 JSolverConfig(**F32), tuple(sorted(jp)), True, jnp.asarray(shift))
    ours = radau_plain(tm, ty, torch.from_numpy(h0), 0.0, tf, tq, tp, tf_, SolverConfig(**F32), shift)
    np.testing.assert_array_equal(ours.failed.numpy(), np.asarray(ref.failed))
    assert not ours.failed.any()
    for got, want in zip(ours.stats, ref.stats):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(ours.y_final.numpy(), ref.y_final, np.float64)
    _close(ours.dense.numpy(), ref.dense, np.float64)


#: The JAX package's Model 200 Radau budget over its 2 days
#: (test_radau_regression.py), scaled to BUDGET_SPAN: attempts a system.
BUDGET_SPAN = 360.0
BUDGET_ATTEMPTS = 14_000 * BUDGET_SPAN / 2880.0


def test_radau_plain_stays_within_the_model200_attempts_budget():
    """tests/test_radau_regression.py::test_model200_radau_attempts_budget
    for the port's Radau: Model 200 (doy0 1, as there) on the basin without
    stiff rows, 8 systems, float32 at rtol 1e-5 / atol 1e-8: no system
    fails, none takes more than the budget's 14,000 attempts scaled to the
    first 6 hours (the plain Radau takes ~2 minutes on the CPU for the 2
    days; 1,028 measured), and the Newton sweeps stay at or under 7 an
    attempt."""
    y0, p, f = scenario(8, 2.0, device="cpu", dtype=torch.float32)
    cfg = SolverConfig(**F32)
    h0 = initial_step(Model200(), y0, 0.0, p, f, cfg)
    res = radau_plain(Model200(), y0, h0, 0.0, BUDGET_SPAN, None, p, f, cfg)
    assert not res.failed.any()
    att = res.stats.n_attempts
    assert int(att.max()) <= BUDGET_ATTEMPTS
    assert int(res.stats.n_newton.sum()) / max(int(att.sum()), 1) <= 7.0


def test_solve_chunked_matches_jax_f64():
    """Both packages' solve_chunked of Model 200 in float64, 2 days in
    1-day windows (the second window's rhs sees t + 1440): a whole solve's
    float64 bound."""
    (jy, jp, jf, _), (ty, tp, tf_, _) = _both(4, 2.0, np.float64)
    data, meta = np.asarray(jf.data), jf.meta
    pr, t2m = data[:meta.n_steps[0]], data[meta.offsets[1]:]

    def window(make):
        return lambda a, b: make([pr[int(a // 60): int(np.ceil(b / 60))],
                                  t2m[int(a // 1440): int(np.ceil(b / 1440))]], [60.0, 1440.0])

    ours = chunked.solve_chunked(Model200(doy0=DOY0), ty, 0.0, 2880.0, 1440.0,
                                 window(lambda s, d: ForcingSet.from_series(s, d, device="cpu")),
                                 query_interval=360.0, params=tp, config=SolverConfig(**F64))
    ref = jchunked.solve_chunked(JModel200(doy0=DOY0), jy, 0.0, 2880.0, 1440.0,
                                 window(JForcingSet.from_series), query_interval=360.0, params=jp,
                                 config=JSolverConfig(**F64), backend="xla")
    assert ours.n_stiff == ref.n_stiff == 0
    _close_solve(ours.y_final.numpy(), ref.y_final, np.float64)
    _close_solve(ours.dense.numpy(), ref.dense, np.float64)


def test_solve_chunked_shift_matches_jax_f64(monkeypatch):
    """Both packages' solve_chunked of Model 200 in float64 over a window
    that starts 30 days in (its solve gets t_shift 43200), from near the
    equinox, its first 30 minutes: within 1e-9; the port's window with
    solve()'s shift dropped or doubled lies outside that bound."""
    t0, tf = 43200.0, 43230.0
    (jy, jp, jf, _), (ty, tp, tf_, _) = _both(4, 31.0, np.float64)
    data, meta = np.asarray(jf.data), jf.meta
    pr, t2m = data[:meta.n_steps[0]], data[meta.offsets[1]:]

    def window(make):
        return lambda a, b: make([pr[int(a // 60): int(np.ceil(b / 60))],
                                  t2m[int(a // 1440): int(np.ceil(b / 1440))]], [60.0, 1440.0])

    def ours():
        return chunked.solve_chunked(Model200(doy0=EQUINOX), ty, t0, tf, 1440.0,
                                     window(lambda s, d: ForcingSet.from_series(s, d, device="cpu")),
                                     query_interval=10.0, params=tp, config=SolverConfig(**F64))

    ref = jchunked.solve_chunked(JModel200(doy0=EQUINOX), jy, t0, tf, 1440.0,
                                 window(JForcingSet.from_series), query_interval=10.0, params=jp,
                                 config=JSolverConfig(**F64), backend="xla")
    got = ours()
    assert got.n_stiff == ref.n_stiff == 0
    _close(got.y_final.numpy(), ref.y_final, np.float64)
    _close(got.dense.numpy(), ref.dense, np.float64)
    solve_fn = chunked.solve
    for factor in (0.0, 2.0):
        monkeypatch.setattr(chunked, "solve", lambda *a, t_shift=0.0, **k: solve_fn(
            *a, t_shift=factor * t_shift, **k))
        assert _outside_f64(ours().dense.numpy(), ref.dense), factor


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_cli_matches_jax(tmp_path, precision):
    """Both packages' runs of tests/test_cli.py's basin with model.uid 200
    from 2000-07-01 (doy0 183): the same summary counts, and every file
    within a whole solve's bound of the precision (the discharge's sliver
    times the largest link area: it sums each link's outflow times its
    area)."""
    changes = dict(model__uid=200, time__start=dt.datetime(2000, 7, 1),
                   time__end=dt.datetime(2000, 7, 3), solver__precision=precision)
    if precision == "f32":
        changes.update(solver__rtol=1e-5, solver__atol=1e-8)
    jcfg, cfg = _configs(make_scenario(tmp_path), tmp_path, **changes)
    assert get_model(cfg.model.uid, doy0=float(cfg.time.start.timetuple().tm_yday)) == Model200(doy0=183.0)
    ref, ours = j_run(jcfg, use_mesh=False), run(cfg, device="cpu")
    for key in ("num_systems", "n_stiff", "n_failed"):
        assert ours[key] == ref[key], key
    assert ours["n_failed"] == 0
    area = model_params(load_spatial_params(cfg.params_file))["A_h"].max()
    for name, var in OUTPUTS:
        a, ids_a, _ = _read(tmp_path / "torch" / f"{name}_basin_rank_0.nc", var)
        b, ids_b, _ = _read(tmp_path / "jax" / f"{name}_basin_rank_0.nc", var)
        assert np.array_equal(ids_a, ids_b), name
        _close_solve(a, b, np.float64 if precision == "f64" else np.float32,
                     SLIVER_M * (area if name == "discharge" else 1.0))
