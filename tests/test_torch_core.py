"""tiger_tpu_torch against tiger_tpu: constants, config, model, forcing, h0.

The same numpy-made inputs go through the JAX package and its counterpart in
the port (``tiger_tpu_torch.convert`` carries them across), with the dtypes
set explicitly on both sides: the JAX tests run with x64 on, torch defaults
to float32.
"""

import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tiger_tpu_torch as tt
from tiger_tpu.forcing import ForcingSet as JForcingSet
from tiger_tpu.forcing import ZOH_SNAP as J_ZOH_SNAP
from tiger_tpu.forcing import gather_forcings_column as j_gather
from tiger_tpu.forcing import zoh_step_cap as j_step_cap
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.models import PARAM_FIELDS as J_PARAM_FIELDS
from tiger_tpu.models import Y0_COMMON as J_Y0_COMMON
from tiger_tpu.solver import tableau as jtab
from tiger_tpu.solver.config import SolverConfig as JSolverConfig
from tiger_tpu.solver.controller import initial_step as j_initial_step
from tiger_tpu_torch import convert
from tiger_tpu_torch.forcing import ZOH_SNAP, ForcingSet, gather_forcings_column, zoh_step_cap
from tiger_tpu_torch.kernels import _common as k_common
from tiger_tpu_torch.kernels import launch_counts, launch_totals, reset_launch_counts
from tiger_tpu_torch.kernels import radau as k_radau
from tiger_tpu_torch.kernels import rk45 as k_rk45
from tiger_tpu_torch.models import PARAM_FIELDS, Y0_COMMON, Model200, Model204
from tiger_tpu_torch.scenario import scenario, scenario_arrays
from tiger_tpu_torch.solver import tableau
from tiger_tpu_torch.solver.config import SolverConfig
from tiger_tpu_torch.solver.controller import initial_step

DT = {np.float32: torch.float32, np.float64: torch.float64}


def _params(rng, s):
    """Per-system Model-204 params around the synthetic basin's values."""
    arrs, _, _ = scenario_arrays(s)
    return {k: v * rng.uniform(0.9, 1.1, s) for k, v in arrs.items()}


# --- (a) constants, config, jax-free import ---------------------------------


TABLEAU_NAMES = (
    "DP_A", "DP_B", "DP_B_ALT", "DP_C", "DP_E", "DP_P",
    "RADAU_A", "RADAU_B", "RADAU_B_ALT", "RADAU_C", "RADAU_E", "RADAU_DENSE",
    "RADAU_A_INV", "RADAU_E3", "RADAU_EIG_GAMMA", "RADAU_EIG_ALPHA",
    "RADAU_EIG_BETA", "RADAU_EIG_V", "RADAU_EIG_P",
)


@pytest.mark.parametrize("name", TABLEAU_NAMES)
def test_tableau_bit_equal(name):
    ours, ref = np.asarray(getattr(tableau, name)), np.asarray(getattr(jtab, name))
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert np.array_equal(ours, ref)


def test_solver_config_defaults_equal():
    ours = dataclasses.fields(SolverConfig)
    ref = dataclasses.fields(JSolverConfig)
    assert [f.name for f in ours] == [f.name for f in ref]
    for f in ref:
        assert getattr(SolverConfig(), f.name) == getattr(JSolverConfig(), f.name), f.name
    assert dataclasses.asdict(SolverConfig.reference_parity()) == dataclasses.asdict(
        JSolverConfig.reference_parity()
    )


@pytest.mark.parametrize(
    "solver, override",
    [
        ("rk45", {"dense_lockstep": True}),
        ("rk45", {"forcing_dtype": "bf16"}),
        ("radau", {"radau_factor_reuse": True}),
        ("radau", {"forcing_dtype": "bf16"}),
        # solve() refuses either solver's options before any work, so even
        # a run with no stiff system cannot ignore a Radau option.
        ("solve", {"radau_factor_reuse": True}),
    ],
)
def test_unported_options_raise(solver, override):
    from tiger_tpu_torch.solver import radau_solve, rk45_solve

    fn = {"rk45": rk45_solve, "radau": radau_solve, "solve": tt.solve}[solver]
    y0 = torch.ones((2, 5), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match=next(iter(override))):
        fn(tt.DummyModel(), y0, 0.0, 1.0, config=SolverConfig(**override))


def test_import_without_jax():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import tiger_tpu_torch, tiger_tpu_torch.kernels.rk45, tiger_tpu_torch.kernels.radau
        import tiger_tpu_torch.convert, tiger_tpu_torch.scenario, tiger_tpu_torch.profile_solve
        import tiger_tpu_torch.radau_phases, tiger_tpu_torch.rk45_phases
        import tiger_tpu_torch.config, tiger_tpu_torch.params, tiger_tpu_torch.native
        import tiger_tpu_torch.io, tiger_tpu_torch.io.lookup, tiger_tpu_torch.io.netcdf
        import tiger_tpu_torch.io.output, tiger_tpu_torch.forcing, tiger_tpu_torch.models
        import tiger_tpu_torch.routing, tiger_tpu_torch.checkpoint, tiger_tpu_torch.profiling
        import tiger_tpu_torch.run, tiger_tpu_torch.chunked, tiger_tpu_torch.streams
        import tiger_tpu_torch.diagnostics, tiger_tpu_torch.models.et
        import tiger_tpu_torch.models.soiltemp, tiger_tpu_torch.models.model200
        import tiger_tpu_torch.kernels.libm, tiger_tpu_torch.dist, tiger_tpu_torch.elementwise
        from tiger_tpu_torch.routing import exchange_sharded, plan_sharded_topology
        from tiger_tpu_torch.solver.api import solve_on_devices
        loaded = [m for m in sys.modules if sys.modules[m] is not None]
        assert not any(m == "jax" or m.startswith(("jax.", "tiger_tpu.")) for m in loaded)
        # Reading a config document and the files needs neither PyYAML nor h5py.
        assert not any(m.split(".")[0] in ("yaml", "h5py") for m in loaded)
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_model_constants_equal():
    assert PARAM_FIELDS == J_PARAM_FIELDS
    assert Y0_COMMON == J_Y0_COMMON
    assert ZOH_SNAP == J_ZOH_SNAP


# --- (b) model, forcing gather, step cap, initial step ----------------------


def _rhs_pair(np_dtype, safe_pow, derived, seed=3, s=512):
    rng = np.random.default_rng(seed)
    p = _params(rng, s)
    y = rng.uniform(-0.5, 4.0, (5, s))
    y[2, : s // 8] = -rng.uniform(1e-6, 1e-2, s // 8)  # negative h_surf
    y[2, s // 8 : s // 4] = 0.0
    f = [rng.uniform(0, 0.0015, s), rng.uniform(-2.0, 10.0, s)]
    y, f = y.astype(np_dtype), [v.astype(np.float32) for v in f]
    jm, tm = JModel204(safe_pow=safe_pow), Model204(safe_pow=safe_pow)
    jp = {k: jnp.asarray(v, np_dtype) for k, v in p.items()}
    tp = convert.params(p, device="cpu", dtype=DT[np_dtype])
    if derived:
        jp, tp = jm.derived_params(jp), tm.derived_params(tp)
    ref = jm.rhs_tuple(0.0, [jnp.asarray(r) for r in y], jp, [jnp.asarray(v) for v in f])
    ours = tm.rhs_tuple(
        0.0, [torch.from_numpy(r) for r in y], tp, [torch.from_numpy(v) for v in f]
    )
    return np.stack([np.asarray(r) for r in ref]), torch.stack(ours).numpy(), y


@pytest.mark.parametrize("derived", [False, True])
@pytest.mark.parametrize("safe_pow", [True, False])
@pytest.mark.parametrize(
    "np_dtype, rtol, atol",
    # f64: the same formulas in the same order, so ~1 ulp (libm exp2/log2).
    # f32: torch's and XLA's float32 exp2/log2 (and XLA's fusion) differ by a
    # few ulp.  atol: a derivative that cancels to ~1e-25 keeps the absolute
    # rounding of its ~1e-3 terms, far below 1e-12 in either dtype.
    [(np.float64, 1e-12, 1e-300), (np.float32, 1e-6, 1e-12)],
)
def test_model204_rhs_matches(np_dtype, rtol, atol, safe_pow, derived):
    ref, ours, y = _rhs_pair(np_dtype, safe_pow, derived)
    assert ours.dtype == np_dtype
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    if not safe_pow:
        # pow's NaN-on-negative semantics: negative h_surf gives NaN in both.
        assert np.isnan(ours[2, y[2] < 0]).all()
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(ours[fin], ref[fin], rtol=rtol, atol=atol)


def test_pow23_is_exp2_log2():
    from tiger_tpu.models.model204 import _pow23 as j_pow23
    from tiger_tpu_torch.models.model204 import _pow23

    x = np.geomspace(1e-35, 10.0, 257)
    # float64 exp2(log2 x * 2/3): one ulp of a log2 of magnitude ~70 is
    # ~1e-14 relative after exp2, whichever library rounds it.
    np.testing.assert_allclose(
        _pow23(torch.from_numpy(x)).numpy(), np.asarray(j_pow23(jnp.asarray(x))), rtol=1e-13
    )


def _forcing_case(seed=5, s=32):
    rng = np.random.default_rng(seed)
    series = [
        rng.uniform(0, 1, (48, s)).astype(np.float32),
        rng.uniform(-2, 10, (2, s)).astype(np.float32),
    ]
    dts = [60.0, 1440.0]
    jf = JForcingSet.from_series(series, dts)
    tf = convert.forcings(np.asarray(jf.data), jf.meta, device="cpu")
    # Step-start times on, just below, just above and between the boundaries,
    # and past the record's end.
    t = np.concatenate(
        [
            np.arange(0.0, 3000.0, 60.0),
            np.arange(60.0, 3000.0, 60.0) - 0.02,
            np.arange(60.0, 3000.0, 60.0) - 1e-4,
            rng.uniform(0.0, 3000.0, 200),
        ]
    )
    return jf, tf, t


@pytest.mark.parametrize("snap", [0.0, ZOH_SNAP])
def test_gather_forcings_exact(snap):
    jf, tf_, t = _forcing_case()
    data = np.asarray(jf.data)
    s = data.shape[1]
    t_lane = np.resize(t, s * (len(t) // s))
    for chunk in t_lane.reshape(-1, s):
        ours = gather_forcings_column(
            tf_.data, tf_.meta, torch.from_numpy(chunk), snap
        )
        for lane in range(s):
            ref = np.asarray(
                j_gather(jnp.asarray(data[:, lane]), jf.meta, jnp.asarray(chunk[lane]), snap)
            )
            got = np.array([float(v[lane]) for v in ours], np.float32)
            np.testing.assert_array_equal(got, ref)


def test_forcing_set_defaults_to_the_card():
    """Without a device argument a ForcingSet lands on the card; where there
    is none that raises instead of handing back CPU tensors."""
    series, dts = [np.arange(6, dtype=np.float32).reshape(3, 2)], [60.0]
    on_cpu = ForcingSet.from_series(series, dts, device="cpu")
    assert on_cpu.data.device.type == "cpu"
    if torch.cuda.is_available():
        assert ForcingSet.from_series(series, dts).data.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ForcingSet.from_series(series, dts)


def test_zoh_step_cap_exact():
    jf, tf_, t = _forcing_case()
    h = np.geomspace(1e-3, 5000.0, t.shape[0])
    ref = np.asarray(j_step_cap(jf.meta, jnp.asarray(t), jnp.asarray(h)))
    ours = zoh_step_cap(tf_.meta, torch.from_numpy(t), torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(ours, ref)
    past = t >= 2880.0  # past both records' last samples nothing caps the step
    assert past.any() and np.array_equal(ours[past], h[past])


@pytest.mark.parametrize("h0_mode", ["per-system", "global-zero-y0"])
def test_initial_step_matches_f64(h0_mode):
    rng = np.random.default_rng(7)
    s = 64
    p = _params(rng, s)
    y0 = np.tile(np.asarray(Y0_COMMON), (s, 1)) * rng.uniform(0.5, 1.5, (s, 5))
    series = [rng.uniform(0, 0.0015, (6, s)).astype(np.float32),
              rng.uniform(-2, 10, (1, s)).astype(np.float32)]
    jf = JForcingSet.from_series(series, [60.0, 1440.0])
    cfg_j = JSolverConfig(rtol=1e-5, atol=1e-8, h0_mode=h0_mode)
    cfg_t = SolverConfig(rtol=1e-5, atol=1e-8, h0_mode=h0_mode)
    ref = np.asarray(
        j_initial_step(
            JModel204(), jnp.asarray(y0), 0.0,
            {k: jnp.asarray(v) for k, v in p.items()}, jf, cfg_j,
        )
    )
    ty0, tp, tfc, _ = convert.solver_inputs(
        y0, p, np.asarray(jf.data), jf.meta, None, device="cpu", dtype=torch.float64
    )
    ours = initial_step(Model204(), ty0, 0.0, tp, tfc, cfg_t).numpy()
    assert ours.dtype == np.float64
    # The same float64 arithmetic; XLA may sum the five squares in another
    # order, so allow a few ulp.
    np.testing.assert_allclose(ours, ref, rtol=4e-16 * 8, atol=0)


# --- the scenario and the carried-across inputs -----------------------------


def test_scenario_arrays_bit_equal_to_graft_entry():
    from __graft_entry__ import _scenario

    jy0, jp, jf = _scenario(256, jnp.float64, days=2.0, stiff_frac=0.01)
    ty0, tp, tf_ = scenario(256, 2.0, 0.01, device="cpu", dtype=torch.float64)
    assert np.array_equal(ty0.numpy(), np.asarray(jy0))
    assert set(tp) == set(jp)
    for k in jp:
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    assert tf_.data.dtype == torch.float32
    assert np.array_equal(tf_.data.numpy(), np.asarray(jf.data))
    assert tuple(tf_.meta) == tuple(jf.meta)


def test_convert_is_bit_exact():
    rng = np.random.default_rng(11)
    p = _params(rng, 16)
    y0 = rng.uniform(0, 1, (16, 5))
    data = rng.uniform(0, 1, (7, 16)).astype(np.float32)
    meta = ((0, 6), (6, 1), (60.0, 1440.0))
    qt = np.arange(0.0, 361.0, 60.0)
    ty0, tp, tfc, tq = convert.solver_inputs(
        y0, p, data, meta, qt, device="cpu", dtype=torch.float64
    )
    assert np.array_equal(ty0.numpy(), y0) and np.array_equal(tq.numpy(), qt)
    assert all(np.array_equal(tp[k].numpy(), p[k]) for k in p)
    assert np.array_equal(tfc.data.numpy(), data)
    assert tfc.meta == tt.ForcingMeta((0, 6), (6, 1), (60.0, 1440.0))


# --- (f) launch counters and device dispatch --------------------------------


def test_cpu_tensors_run_plain_versions_and_count_no_launch():
    y0, p, f = scenario(8, 0.05, 0.25, device="cpu")
    reset_launch_counts()
    qt = torch.arange(0.0, 72.0 + 1e-9, 12.0)
    res = tt.solve(Model204(), y0, 0.0, 72.0, qt, p, f, SolverConfig(rtol=1e-5, atol=1e-8))
    assert res.n_stiff > 0 and res.radau_stats is not None
    assert launch_totals() == {"rk45": 0, "radau": 0}
    assert res.y_final.device.type == "cpu"


def test_wrappers_refuse_other_devices():
    y0 = torch.ones((2, 5), device="meta")
    h0 = torch.ones((2,), device="meta")
    with pytest.raises(ValueError, match="no implementation for device"):
        k_rk45.rk45(Model204(), y0, h0, 0.0, 1.0)
    with pytest.raises(ValueError, match="no implementation for device"):
        k_radau.radau(Model204(), y0, h0, 0.0, 1.0)


def _kernel_case(dtype):
    y0, p, f = scenario(4, 0.05, 0.25, device="cpu", dtype=dtype)
    return dict(y0=y0, h0=torch.ones(4, dtype=dtype), params=p, forcings=f,
                query_times=torch.arange(0.0, 60.0 + 1e-9, 30.0, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_inputs_take_float32_or_float64(dtype):
    """The kernels' input check takes a call whose tensors are all in y0's
    dtype, float32 or float64, with float32 forcing data (both kernels have
    instances of both scalars)."""
    c = _kernel_case(dtype)
    assert c["forcings"].data.dtype == torch.float32
    y0_soa, p_block = k_common.kernel_inputs("rk45", Model204(), c["y0"], c["h0"], c["params"],
                                             c["forcings"], c["query_times"])
    assert y0_soa.dtype == p_block.dtype == dtype and p_block.shape == (15, 4)


MIXED = {
    "h0": lambda c: c.update(h0=c["h0"].float()),
    "params": lambda c: c["params"].update(Hu=c["params"]["Hu"].float()),
    "query_times": lambda c: c.update(query_times=c["query_times"].float()),
    "forcing_data": lambda c: c.update(
        forcings=ForcingSet(c["forcings"].data.double(), c["forcings"].meta)),
}


@pytest.mark.parametrize("case", sorted(MIXED))
def test_kernel_inputs_refuse_mixed_dtypes(case):
    """A float64 call with one tensor in another dtype (or float64 forcing
    data) raises TypeError before any launch."""
    c = _kernel_case(torch.float64)
    MIXED[case](c)
    with pytest.raises(TypeError, match="must be torch.float"):
        k_common.kernel_inputs("radau", Model204(), c["y0"], c["h0"], c["params"],
                               c["forcings"], c["query_times"])


F64_OPTION_SETS = {
    "default": {},
    "fsal": dict(fsal=True),
    "compensated": dict(compensated=True),
    "pi": dict(controller="pi"),
    "predictor": dict(radau_predictor=True),
    "radau5": dict(radau_error_mode="radau5"),
    "reference": dict(radau_error_mode="reference"),
    "fsal_pi_predictor": dict(fsal=True, controller="pi", radau_predictor=True),
}


@pytest.mark.parametrize("case", sorted(F64_OPTION_SETS))
def test_float64_runs_every_option_set(case):
    """Each kernel has a double instance of every option set, so float64
    takes each of them on the card as float32 does: the solvers accept it,
    and each wrapper counts it under the float instance's name with
    '/f64'."""
    from tiger_tpu_torch.solver.config import require_supported

    cfg = SolverConfig(**F64_OPTION_SETS[case])
    for solver in ("rk45", "radau"):
        require_supported(cfg, solver)
    counts = launch_counts()
    b1 = k_rk45.INSTANCES[k_rk45.rk45_options(cfg)]
    assert k_rk45.F64_INSTANCES[k_rk45.rk45_options(cfg)] == b1 + "/f64"
    b2 = k_radau.instance_name(cfg, torch.float64)
    assert b2 == k_radau.instance_name(cfg) + "/f64"
    assert b1 + "/f64" in counts["rk45"] and b2 in counts["radau"]


@pytest.mark.parametrize(
    "meta",
    [((0, 6), (6, 2), (60.0, 1440.0)), ((0, -1), (6, 1), (60.0, 1440.0)),
     ((0, 6), (6, 1), (60.0, 0.0))],
)
def test_kernel_forcing_meta_is_bounds_checked(meta):
    """The kernels index the forcing rows through the meta: a meta that
    does not fit the data is refused before any pointer is passed."""
    data = np.zeros((7, 4), np.float32)
    with pytest.raises(ValueError, match="do not fit"):
        k_common.forcing_meta_c(convert.forcings(data, meta, device="cpu"), SolverConfig())
    ok = convert.forcings(data, ((0, 6), (6, 1), (60.0, 1440.0)), device="cpu")
    m = k_common.forcing_meta_c(ok, SolverConfig())
    assert (m.n_forc, m.n_cap, list(m.offset)[:2], m.align) == (2, 2, [0, 6], 1)


# --- the kernel build's flag sets ----------------------------------------------


def test_build_flag_sets_differ_only_in_contraction():
    from tiger_tpu_torch.kernels import _build

    assert "-fmad=false" in _build.NVCC_FLAGS and "-fmad=false" not in _build.FMAD_FLAGS
    assert [f for f in _build.NVCC_FLAGS if f != "-fmad=false"] == list(_build.FMAD_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.source_hash(_build.NVCC_FLAGS) != _build.source_hash(_build.FMAD_FLAGS)


def test_flags_in_use_selects_and_restores():
    from tiger_tpu_torch.kernels import _build

    assert _build._flags_in_use == _build.NVCC_FLAGS
    with pytest.raises(RuntimeError, match="inside"):
        with _build.flags_in_use(_build.FMAD_FLAGS):
            assert _build._flags_in_use == _build.FMAD_FLAGS
            raise RuntimeError("inside")
    assert _build._flags_in_use == _build.NVCC_FLAGS


# --- solve()'s one input check ------------------------------------------------


BAD_INPUTS = {
    "unsorted_queries": (dict(query_times=torch.tensor([0.0, 2.0, 1.0])), ValueError, "sorted"),
    "nan_query": (dict(query_times=torch.tensor([0.0, float("nan")])), ValueError, "NaN"),
    "queries_past_tf": (dict(query_times=torch.tensor([0.0, 5.0])), ValueError, "past tf"),
    "queries_not_a_tensor": (dict(query_times=[0.0, 1.0]), TypeError, "tensor"),
    "param_shape": (dict(params={"lam": torch.ones(3)}), ValueError, "params"),
    "empty_span": (dict(tf=0.0), ValueError, "greater than t0"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_solve_refuses_bad_inputs(case):
    kwargs, err, match = BAD_INPUTS[case]
    args = dict(t0=0.0, tf=4.0, query_times=None, params=None)
    args.update(kwargs)
    with pytest.raises(err, match=match):
        tt.solve(tt.DummyModel(), torch.ones((2, 5), dtype=torch.float64), **args)


def test_solve_duplicate_queries_get_the_same_row():
    y0, p, f = scenario(4, 0.05, 0.25, device="cpu", dtype=torch.float64)
    qt = torch.arange(0.0, 72.0 + 1e-9, 12.0, dtype=torch.float64)
    cfg = SolverConfig(rtol=1e-5, atol=1e-8)
    one = tt.solve(Model204(), y0, 0.0, 72.0, qt, p, f, cfg)
    two = tt.solve(Model204(), y0, 0.0, 72.0, torch.repeat_interleave(qt, 2), p, f, cfg)
    assert one.n_stiff == two.n_stiff > 0
    assert torch.equal(two.dense[:, ::2], one.dense) and torch.equal(two.dense[:, 1::2], one.dense)


def test_model_registry_matches_jax():
    from tiger_tpu.models import get_model as j_get_model
    from tiger_tpu_torch.models import get_model

    for uid in (1, 200, 204):
        ours, ref = get_model(uid, doy0=182.0), j_get_model(uid, doy0=182.0)
        assert (ours.UID, ours.N_EQ) == (ref.UID, ref.N_EQ)
        assert getattr(ours, "doy0", None) == getattr(ref, "doy0", None)
    assert get_model(204, safe_pow=False) == Model204(safe_pow=False)
    assert get_model(200) == Model200() and Model200().doy0 == j_get_model(200).doy0 == 1.0
    with pytest.raises(KeyError, match="known"):
        get_model(999)


def test_every_legal_option_set_has_a_kernel_instance():
    """Every SolverConfig that validation accepts picks a float instance of
    B1 and of B2, and together they reach all twelve; the launch counters
    hold those and their double twins, for Model 204, (prefixed 'm200/')
    for Model 200 and (prefixed 'dummy/') for DummyModel, and nothing
    else."""
    import itertools

    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.kernels import rk45 as k_rk45

    b1, b2 = set(), set()
    for fsal, comp, controller, mode, pred in itertools.product(
            (False, True), (False, True), ("i", "pi"), ("embedded3", "reference", "radau5"),
            (False, True)):
        if fsal and comp:
            with pytest.raises(ValueError, match="mutually exclusive"):
                SolverConfig(fsal=fsal, compensated=comp)
            continue
        cfg = SolverConfig(fsal=fsal, compensated=comp, controller=controller,
                           radau_error_mode=mode, radau_predictor=pred)
        b1.add(k_rk45.INSTANCES[k_rk45.rk45_options(cfg)])
        assert (mode, pred) in k_radau.INSTANCES
        b2.add(k_radau.instance_name(cfg))
    assert b1 == set(k_rk45.INSTANCES.values()) and len(b1) == 6
    assert len(b2) == 6
    for counts, names in ((k_rk45.rk45_launches, b1), (k_radau.radau_launches, b2)):
        per_model = names | {name + "/f64" for name in names}
        assert set(counts) == per_model | {prefix + name for prefix in ("m200/", "dummy/")
                                           for name in per_model}
        assert len(counts) == 36
