"""B1's schedule on the CPU: pooled, time-sliced systems against each system
run alone.

No CUDA compiler is needed: g++ builds the body of
``tiger_tpu_torch/kernels/csrc/rk45.cu`` (everything above its launch
section) against the stand-in ``tests/torch_shim/cuda_runtime.h``, with one
``std::thread`` a CUDA thread and a ``std::barrier`` for ``__syncthreads``.
The build is small on purpose (8 lanes a block, 16 pool slots, 4 attempts a
slice, 2 blocks), so that at 100 systems a block's share of 50 passes through
its pool in several admissions, more systems are live than there are lanes
(the least-t order decides who runs), and the drain packs the last systems
into fewer lanes.  The same library runs every system alone, from its start
to its end, through the same attempt function: the schedule must change no
system's result, bit for bit, in float32 and, through the double instance,
in float64.  (Against ``rk45_plain`` the g++ build differs where glibc's
exp2f/log2f/powf round otherwise than torch's; on the card the two agree
bit for bit, which tests/test_torch_cuda.py checks.)  The same g++ builds
check that the ctypes mirrors of the kernels' argument structs have the
C++ structs' sizes, and the double tableau's constants are checked against
``solver/tableau.py`` here too.  B1's runtime options (the lockstep cap and
the bf16 gather, ``tests/torch_shim/cuda_bf16.h`` standing in for the
bfloat16 header) are rehearsed the same way, and B2's warp body with factor
reuse on 32 threads a system (``radau_shim.cpp``).
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_cuda import OPTIONS, RK45_INSTANCES
from tiger_tpu_torch import DummyModel, Model200, Model204, SolverConfig
from tiger_tpu_torch.kernels import _build
from tiger_tpu_torch.kernels import radau as k_radau
from tiger_tpu_torch.kernels import rk45 as k_rk45
from tiger_tpu_torch.scenario import scenario
from tiger_tpu_torch.solver import tableau
from tiger_tpu_torch.solver.controller import initial_step

SHIM = Path(__file__).resolve().with_name("torch_shim")
CFG = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
TF = 360.0
LANES, POOL, SLICE = 8, 16, 4
SHAPE = (f"-DTT_RK45_THREADS={LANES}", f"-DTT_RK45_THREADS_F64={LANES}",
         f"-DTT_RK45_THREADS_M200={LANES}", f"-DTT_RK45_POOL={POOL}",
         f"-DTT_RK45_SLICE={SLICE}", "-DTT_SHIM_BLOCKS=2")
F64 = {torch.float32: 0, torch.float64: 1}


def _gxx(work, body: str, source: str, lib_name: str, *defines) -> ctypes.CDLL:
    """g++ builds ``source`` (tests/torch_shim) with ``body``'s kernel body
    (csrc/<body>.cu above its launch section) as ``<body>_body.h``."""
    text = (_build.CSRC / f"{body}.cu").read_text()
    (work / f"{body}_body.h").write_text(text.split("// ---- launch ----")[0])
    (work / "rk45_tableau.cuh").write_text(_build.tableau_header())
    lib_path = work / lib_name
    cmd = ["g++", "-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-shared", "-fPIC",
           "-x", "c++", *defines, "-I", str(SHIM), "-I", str(work), "-I", str(_build.CSRC),
           "-o", str(lib_path), str(SHIM / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    for name in ("tt_rk45_args_size", "tt_radau_args_size"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [ctypes.c_int32]
            getattr(lib, name).restype = ctypes.c_int
    for name in ("tt_rk45_args_offsets", "tt_radau_args_offsets"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [ctypes.c_int32, ctypes.c_void_p]
            getattr(lib, name).restype = None
    return lib


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    lib = _gxx(tmp_path_factory.mktemp("rk45_shim"), "rk45", "rk45_shim.cpp",
               "librk45_shim.so", *SHAPE)
    for name in ("tt_rk45_launch", "tt_rk45_serial"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def radau_sizes_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return _gxx(tmp_path_factory.mktemp("radau_sizes"), "radau", "radau_sizes.cpp",
                "libradau_sizes.so")


@pytest.fixture(scope="module")
def radau_shim_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    lib = _gxx(tmp_path_factory.mktemp("radau_shim"), "radau", "radau_shim.cpp",
               "libradau_shim.so")
    lib.tt_radau_launch.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    lib.tt_radau_launch.restype = ctypes.c_int
    return lib


def _run(lib, monkeypatch, entry, model, y0, h0, qt, p, f, cfg, t_shift=0.0, tf=TF):
    """The wrapper's CUDA path on CPU tensors, its launch sent to ``entry``
    of the shim library."""

    def launch(fn_name, size_name, args, f64, device, options):
        assert fn_name == "tt_rk45_launch"
        assert getattr(lib, size_name)(int(f64)) == ctypes.sizeof(args)
        assert getattr(lib, entry)(ctypes.addressof(args), int(f64), None) == 0

    monkeypatch.setattr(k_rk45, "launch", launch)
    return k_rk45._rk45_cuda(model, y0, h0, 0.0, tf, qt, p, f, cfg, t_shift)


# Every option case in float32, and again in float64 (the double instance:
# these cases change SolverConfig fields, never the instance's option set).
SCALAR_CASES = [pytest.param(name, torch.float32, id=name) for name in sorted(OPTIONS)] + [
    pytest.param(name, torch.float64, id=f"{name}_f64") for name in sorted(OPTIONS)]


#: 6-hour runs from the cold state at three batch sizes; and hot-started
#: windows (the state carried out of a 1-hour warm-up, one query at the
#: end), each h0 scaled by 10^u with u uniform in [u_low, 2], so that the
#: systems' lifetimes lie wide apart and most systems end inside a slice:
#: their lanes take the next system there and then (300 systems: a share
#: of 150 through 16 slots).  In 1-hour windows ("wide": 3 to ~50
#: attempts, u_low -2) they take it from the slice's order; in half-minute
#: windows ("short": most systems 1 or 2 attempts, the planted stiff ones
#: ~20, u_low -1) a slice's lanes use up its order and admit systems of
#: the share into the slots they free.
HOT = {"wide": (60.0, -2.0), "short": (0.5, -1.0)}
SCHEDULE_CASES = [pytest.param(n, None, id=str(n)) for n in (1, 31, 100)] + [
    pytest.param(n, "wide", id=f"hot_wide_{n}") for n in (100, 300)] + [
    pytest.param(300, "short", id="hot_short_300")]


def _hot_window(model, n_sys, dtype, hot):
    """(y0, h0, qt, params, forcing, tf) of a hot-started window whose
    systems' lifetimes lie wide apart (the warm-up and the initial steps
    under the default options)."""
    tf, u_low = HOT[hot]
    y_cold, p, f = scenario(n_sys, 60.0 / 1440.0, 0.05, device="cpu", dtype=dtype)
    warm = k_rk45.rk45_plain(model, y_cold, initial_step(model, y_cold, 0.0, p, f, CFG), 0.0,
                             60.0, torch.tensor([60.0], dtype=dtype), p, f, CFG)
    y0 = torch.where(torch.isnan(warm.y_final), y_cold, warm.y_final)
    scale = 10.0 ** np.random.default_rng(3).uniform(u_low, 2.0, n_sys)
    h0 = initial_step(model, y0, 0.0, p, f, CFG) * torch.as_tensor(scale).to(dtype)
    return y0, h0, torch.tensor([tf], dtype=dtype), p, f, tf


@pytest.mark.parametrize("name,dtype", SCALAR_CASES)
@pytest.mark.parametrize("n_sys,hot", SCHEDULE_CASES)
def test_schedule_changes_no_result(shim_lib, monkeypatch, n_sys, hot, name, dtype):
    options, safe_pow = OPTIONS[name]
    cfg = dataclasses.replace(CFG, **options)
    model = Model204(safe_pow=safe_pow)
    if hot:
        y0, h0, qt, p, f, tf = _hot_window(model, n_sys, dtype, hot)
    else:
        tf = TF
        y0, p, f = scenario(n_sys, TF / 1440.0, 0.05, device="cpu", dtype=dtype)
        qt = torch.arange(0.0, TF + 1e-9, 60.0, dtype=dtype)
        h0 = initial_step(model, y0, 0.0, p, f, cfg)
    pooled = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f, cfg, tf=tf)
    alone = _run(shim_lib, monkeypatch, "tt_rk45_serial", model, y0, h0, qt, p, f, cfg, tf=tf)
    assert pooled.y_final.dtype == pooled.dense.dtype == dtype
    diff = k_rk45.rk45_mismatch(pooled, alone)
    assert not any(diff.values()), diff
    # The run did something: attempts were made, and where the scenario has
    # stiff rows and the detector is on they were flagged.
    assert int(alone.stats.n_attempts.min()) > 0
    if n_sys >= 31 and cfg.stiff_detect and cfg.max_steps > 40:
        assert bool(alone.stiff[p["Hu"] < 1e-5].all())
    if hot:
        # Lifetimes from a slice or less to more than a slice, most of them
        # ending inside a slice.
        att = alone.stats.n_attempts
        assert int(att.min()) <= SLICE and int(att.max()) > SLICE, att
        assert int((att % SLICE != 0).sum()) > n_sys // 2, att
    if hot == "wide":
        assert int(att.max()) >= 3 * SLICE, att
    if hot == "short":
        # A slice's lanes, LANES * SLICE attempts, outrun the POOL systems
        # of its order: the plain rows' mean lifetime is under
        # LANES * SLICE / POOL attempts.
        plain = att[p["Hu"] >= 1e-5].double()
        assert float(plain.mean()) * POOL < LANES * SLICE, plain.mean()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(RK45_INSTANCES))
def test_option_instance_schedule_changes_no_result(shim_lib, monkeypatch, name, dtype):
    """Each option instance, float and double (its pool rows k0, y_c and
    facold stored and loaded between slices), gives every system the result
    it gets alone, and the FSAL instances give the default instances'
    results: bit for bit, 100 systems over 6 hours with stiff rows and
    hourly rain."""
    cfg = dataclasses.replace(CFG, **RK45_INSTANCES[name])
    model = Model204()
    y0, p, f = scenario(100, TF / 1440.0, 0.05, device="cpu", dtype=dtype)
    qt = torch.arange(0.0, TF + 1e-9, 60.0, dtype=dtype)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    pooled = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f, cfg)
    alone = _run(shim_lib, monkeypatch, "tt_rk45_serial", model, y0, h0, qt, p, f, cfg)
    assert pooled.y_final.dtype == dtype
    diff = k_rk45.rk45_mismatch(pooled, alone)
    assert not any(diff.values()), diff
    assert bool(alone.stiff[p["Hu"] < 1e-5].all())
    if cfg.fsal:
        plain_k1 = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f,
                        dataclasses.replace(cfg, fsal=False))
        diff = k_rk45.rk45_mismatch(pooled, plain_k1)
        assert not any(diff.values()), diff


@pytest.mark.parametrize("name,dtype", [
    pytest.param("defaults", torch.float32, id="defaults-f32"),
    pytest.param("defaults", torch.float64, id="defaults-f64"),
    pytest.param("fsal_pi", torch.float32, id="fsal_pi-f32"),
    pytest.param("compensated", torch.float64, id="compensated-f64")])
def test_model200_schedule_changes_no_result_with_a_shift(shim_lib, monkeypatch, name, dtype):
    """Model 200's instances (its rhs reads t + t_shift) give every system
    the result it gets alone, bit for bit, in float32 and float64, with a
    one-day shift: 100 systems over 6 hours with hourly rain.  The shift
    reaches the rhs: the results move with it."""
    cfg = dataclasses.replace(CFG, **RK45_INSTANCES.get(name, {}))
    model = Model200(doy0=182.0)
    y0, p, f = scenario(100, TF / 1440.0, 0.0, device="cpu", dtype=dtype)
    p["lat"] = torch.linspace(25.0, 50.0, 100, dtype=dtype)
    qt = torch.arange(0.0, TF + 1e-9, 60.0, dtype=dtype)
    h0 = initial_step(model, y0, 0.0, p, f, cfg, 1440.0)
    pooled = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f, cfg, 1440.0)
    alone = _run(shim_lib, monkeypatch, "tt_rk45_serial", model, y0, h0, qt, p, f, cfg, 1440.0)
    diff = k_rk45.rk45_mismatch(pooled, alone)
    assert not any(diff.values()), diff
    assert int(alone.stats.n_attempts.min()) > 0 and not alone.stiff.any()
    unshifted = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f, cfg)
    assert not torch.equal(unshifted.y_final, pooled.y_final)
    # Against the plain version: the g++ build's libm (glibc's) rounds
    # otherwise than torch's CPU functions here and there (on the card the
    # two agree bit for bit; tests/test_torch_cuda.py).
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg, 1440.0)
    rtol = 1e-9 if dtype == torch.float64 else 5e-4
    torch.testing.assert_close(pooled.y_final, ref.y_final, rtol=rtol, atol=5e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["defaults", "fsal_pi", "compensated"])
def test_dummy_schedule_changes_no_result_without_params(shim_lib, monkeypatch, name, dtype):
    """DummyModel's instances, launched with a null parameter pointer (its
    rhs reads no param, forcing or time), give every system the result it
    gets alone, bit for bit, in float32 and float64: 100 systems from
    seeded states over the golden span with hourly rain (the forcing step
    cap is the solver's, so it applies to this model too).  Against the
    plain version they agree to the solver's tolerance (glibc's libm in the
    controller rounds otherwise than torch's CPU functions here and there;
    on the card the two agree bit for bit, tests/test_torch_cuda.py)."""
    cfg = dataclasses.replace(CFG, **RK45_INSTANCES.get(name, {}))
    model = DummyModel()
    _, _, f = scenario(100, TF / 1440.0, 0.0, device="cpu", dtype=dtype)
    y0 = torch.as_tensor(np.random.default_rng(1).uniform(0.5, 2.0, (100, 5))).to(dtype)
    qt = torch.arange(0.0, TF + 1e-9, 60.0, dtype=dtype)
    h0 = initial_step(model, y0, 0.0, None, f, cfg)
    pooled = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, None, f, cfg)
    alone = _run(shim_lib, monkeypatch, "tt_rk45_serial", model, y0, h0, qt, None, f, cfg)
    diff = k_rk45.rk45_mismatch(pooled, alone)
    assert not any(diff.values()), diff
    assert int(alone.stats.n_attempts.min()) > 0 and not alone.stiff.any()
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, None, f, cfg)
    rtol = 1e-9 if dtype == torch.float64 else 5e-4
    torch.testing.assert_close(pooled.y_final, ref.y_final, rtol=rtol, atol=1e-6)
    torch.testing.assert_close(pooled.dense, ref.dense, rtol=rtol, atol=1e-6)


#: B1's runtime options (Rk45Args.lockstep, .forc_bf16), alone and with
#: option instances.
RUNTIME = {"lockstep": dict(dense_lockstep=True), "bf16": dict(forcing_dtype="bf16"),
           "lockstep_bf16": dict(dense_lockstep=True, forcing_dtype="bf16"),
           "lockstep_fsal_pi": dict(dense_lockstep=True, fsal=True, controller="pi"),
           "lockstep_compensated": dict(dense_lockstep=True, compensated=True)}


@pytest.mark.parametrize("name,dtype", [
    pytest.param("lockstep", torch.float32, id="lockstep-f32"),
    pytest.param("lockstep", torch.float64, id="lockstep-f64"),
    pytest.param("bf16", torch.float32, id="bf16-f32"),
    pytest.param("lockstep_bf16", torch.float32, id="lockstep_bf16-f32"),
    pytest.param("lockstep_fsal_pi", torch.float32, id="lockstep_fsal_pi-f32"),
    pytest.param("lockstep_compensated", torch.float64, id="lockstep_compensated-f64")])
def test_runtime_options_schedule_changes_no_result(shim_lib, monkeypatch, name, dtype):
    """B1's lockstep cap and bf16 gather, in the pooled schedule, give every
    system the result it gets alone, bit for bit: 100 systems over 6 hours
    with stiff rows, a query every 20 minutes (between the forcing's hourly
    boundaries, so the cap bites: more attempts than without it).  The
    kernel finds each system's lockstep barrier from its dense cursor;
    rk45_plain carries the TPU kernel's cursor: the two agree to the g++
    build's libm (on the card bit for bit, tests/test_torch_cuda.py)."""
    cfg = dataclasses.replace(CFG, **RUNTIME[name])
    model = Model204()
    y0, p, f = scenario(100, TF / 1440.0, 0.05, device="cpu", dtype=dtype)
    qt = torch.arange(0.0, TF + 1e-9, 20.0, dtype=dtype)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    pooled = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f, cfg)
    alone = _run(shim_lib, monkeypatch, "tt_rk45_serial", model, y0, h0, qt, p, f, cfg)
    diff = k_rk45.rk45_mismatch(pooled, alone)
    assert not any(diff.values()), diff
    assert bool(alone.stiff[p["Hu"] < 1e-5].all())
    if cfg.dense_lockstep:
        free = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f,
                    dataclasses.replace(cfg, dense_lockstep=False))
        calm = ~pooled.stiff
        assert int(pooled.stats.n_attempts[calm].sum()) > int(free.stats.n_attempts[calm].sum())
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    assert torch.equal(pooled.stiff, ref.stiff)
    calm = ~ref.stiff
    rtol = 1e-9 if dtype == torch.float64 else 5e-4
    torch.testing.assert_close(pooled.y_final[calm], ref.y_final[calm], rtol=rtol, atol=5e-5)
    torch.testing.assert_close(pooled.dense[calm], ref.dense[calm], rtol=10 * rtol, atol=5e-5)


@pytest.mark.parametrize("name", ["defaults", "fsal_pi"])
def test_bf16_gather_reads_the_rounded_forcing(shim_lib, monkeypatch, name):
    """The float instance with a bfloat16 copy of the forcing (its samples
    widened at each gather, FSAL's refresh too) equals the same instance on
    float32 forcing rounded to bfloat16 beforehand, bit for bit, and
    differs from the float32 run."""
    from tiger_tpu_torch.forcing import ForcingSet

    cfg = dataclasses.replace(CFG, **RK45_INSTANCES.get(name, {}))
    model = Model204()
    y0, p, f = scenario(100, TF / 1440.0, 0.05, device="cpu")
    qt = torch.arange(0.0, TF + 1e-9, 60.0)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    bf16 = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f,
                dataclasses.replace(cfg, forcing_dtype="bf16"))
    pre = ForcingSet(f.data.to(torch.bfloat16).float(), f.meta)
    rounded = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, pre, cfg)
    diff = k_rk45.rk45_mismatch(bf16, rounded)
    assert not any(diff.values()), diff
    f32 = _run(shim_lib, monkeypatch, "tt_rk45_launch", model, y0, h0, qt, p, f, cfg)
    assert k_rk45.rk45_mismatch(bf16, f32)["y_final"] > 0


def _run_radau(lib, monkeypatch, model, y0, h0, qt, p, f, cfg, span):
    """The B2 wrapper's CUDA path on CPU tensors, its launch sent to the
    warp rehearsal (radau_shim.cpp)."""

    def launch(fn_name, size_name, args, f64, device, options):
        assert fn_name == "tt_radau_launch"
        assert getattr(lib, size_name)(int(f64)) == ctypes.sizeof(args)
        assert lib.tt_radau_launch(ctypes.addressof(args), int(f64), None) == 0

    monkeypatch.setattr(k_radau, "launch", launch)
    return k_radau._radau_cuda(model, y0, h0, 0.0, span, qt, p, f, cfg)


@pytest.mark.parametrize("name,dtype", [
    pytest.param("embedded3", torch.float32, id="embedded3-f32"),
    pytest.param("radau5", torch.float32, id="radau5-f32"),
    pytest.param("embedded3", torch.float64, id="embedded3-f64"),
    pytest.param("radau5_predictor", torch.float64, id="radau5_predictor-f64")])
def test_radau_warp_factor_reuse_matches_plain(radau_shim_lib, monkeypatch, name, dtype):
    """B2's warp body with factor reuse (the kept factors in shared memory,
    each system's own vote), rehearsed on 32 threads a system: 3 stiff
    systems over 10 minutes against radau_plain with reuse.  Fewer
    factorizations than attempts, the same failures, and in float64 the
    same counters (glibc's double libm rounded as torch's here); in float32
    glibc's powf moves a sweep here and there (without reuse too), so the
    counters agree to 1% and the states to the g++ build's libm (on the
    card bit for bit, tests/test_torch_cuda.py)."""
    opts = {"embedded3": {}, "radau5": dict(radau_error_mode="radau5"),
            "radau5_predictor": dict(radau_error_mode="radau5", radau_predictor=True)}[name]
    cfg = dataclasses.replace(CFG, radau_factor_reuse=True, **opts)
    model, span = Model204(), 10.0
    y0, p, f = scenario(3, span / 1440.0, 1.0, device="cpu", dtype=dtype)
    qt = torch.arange(0.0, span + 1e-9, 2.5, dtype=dtype)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    ker = _run_radau(radau_shim_lib, monkeypatch, model, y0, h0, qt, p, f, cfg, span)
    ref = k_radau.radau_plain(model, y0, h0, 0.0, span, qt, p, f, cfg)
    assert torch.equal(ker.failed, ref.failed) and not ref.failed.any()
    for field, a, b in zip(ref.stats._fields, ker.stats, ref.stats):
        if dtype == torch.float64:
            assert torch.equal(a, b), (field, a, b)
        else:
            assert bool(((a - b).abs() <= 0.01 * b + 2).all()), (field, a, b)
    assert 0 < int(ker.stats.n_fact.sum()) < int(ker.stats.n_attempts.sum())
    rtol = 1e-9 if dtype == torch.float64 else 5e-4
    torch.testing.assert_close(ker.y_final, ref.y_final, rtol=rtol, atol=1e-7)
    torch.testing.assert_close(ker.dense, ref.dense, rtol=rtol, atol=1e-7)


#: The argument-struct fields whose offsets the shims report, in order (B2's
#: own in place of B1's first and last two).
OFFSET_FIELDS = ("options", "model", "t_shift", "doy0", "forcing", "lockstep", "forc_bf16")
RADAU_OFFSET_FIELDS = ("err_mode",) + OFFSET_FIELDS[1:5] + ("factor_reuse", "reuse_hi")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["rk45", "radau"])
def test_args_mirrors_match_the_kernel_structs(shim_lib, radau_sizes_lib, kernel, dtype):
    """Each ctypes mirror (kernels.rk45.ARGS, kernels.radau.ARGS) has the
    size of the C++ struct it mirrors, as g++ lays it out: the float
    struct and the double one (whose scalars and ForcingMeta are double);
    and the model, the shift, doy0, the runtime options at the end and
    what surrounds them lie at the C++ struct's offsets."""
    lib, args = ((shim_lib, k_rk45.ARGS) if kernel == "rk45" else (radau_sizes_lib, k_radau.ARGS))
    size = getattr(lib, f"tt_{kernel}_args_size")(F64[dtype])
    assert size == ctypes.sizeof(args[dtype])
    if dtype == torch.float64:
        assert size > ctypes.sizeof(args[torch.float32])
    out = (ctypes.c_int64 * len(OFFSET_FIELDS))()
    getattr(lib, f"tt_{kernel}_args_offsets")(F64[dtype], out)
    fields = OFFSET_FIELDS if kernel == "rk45" else RADAU_OFFSET_FIELDS
    assert list(out) == [getattr(args[dtype], f).offset for f in fields]


def test_tableau_header_holds_the_float64_tableau():
    """``TT_DP_TABLEAU_F64`` (the double instance's tableau) parses back to
    solver/tableau.py's float64 values exactly, and ``TT_DP_TABLEAU`` to
    those values rounded to float32."""
    header = _build.tableau_header()
    want = np.concatenate([np.ravel(x) for x in (tableau.DP_A, tableau.DP_C, tableau.DP_B,
                                                 tableau.DP_E, tableau.DP_P)])
    for name, dtype in (("TT_DP_TABLEAU_F64", np.float64), ("TT_DP_TABLEAU", np.float32)):
        body = header.split(f"#define {name} ")[1].split("#define")[0]
        literals = re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f?", body)
        assert all(v.endswith("f") == (dtype == np.float32) for v in literals), name
        got = np.array([float.fromhex(v.rstrip("f")) for v in literals])
        assert got.shape == want.shape, name
        assert np.array_equal(got, want.astype(dtype).astype(np.float64)), name


def test_radau_double_constants_are_the_float64_tableau(monkeypatch):
    """B2's double instance gets tableau.py's float64 constants and the
    solver's scalars as doubles (not floats widened); its float instance
    the same rounded to float32."""
    seen = {}

    def launch(fn_name, size_name, args, f64, device, options):
        seen[bool(f64)] = args

    monkeypatch.setattr(k_radau, "launch", launch)
    for dtype in (torch.float32, torch.float64):
        y0, p, f = scenario(2, 0.1, 1.0, device="cpu", dtype=dtype)
        h0 = torch.ones(2, dtype=dtype)
        qt = torch.arange(0.0, 60.0 + 1e-9, 30.0, dtype=dtype)
        k_radau._radau_cuda(Model204(), y0, h0, 0.0, 60.0, qt, p, f, CFG)
    for f64, dtype in ((True, np.float64), (False, np.float32)):
        a = seen[f64]
        for field, want in (("ra", tableau.RADAU_A), ("rb", tableau.RADAU_B),
                            ("rc", tableau.RADAU_C), ("re", tableau.RADAU_E3),
                            ("rw", tableau.RADAU_DENSE), ("inv_a", tableau.RADAU_A_INV)):
            got = np.array([list(r) if hasattr(r, "__len__") else r for r in getattr(a, field)])
            assert np.array_equal(got, np.asarray(want, np.float64).astype(dtype)), field
        assert a.gam == float(dtype(tableau.RADAU_EIG_GAMMA))
        assert a.rtol == float(dtype(CFG.rtol)) and a.atol == float(dtype(CFG.atol))
        assert a.forcing.snap == float(dtype(5e-4))
        assert a.fd_eps == float(dtype(np.sqrt(np.finfo(dtype).eps)))
