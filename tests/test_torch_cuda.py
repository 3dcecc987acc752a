"""The CUDA kernels against their plain versions on the card.

Runs only where torch sees a CUDA device (``python -m pytest -m gpu
tests/test_torch_cuda.py`` on a machine with an H100); elsewhere each test
skips.  The kernels are built with nvcc from ``tiger_tpu_torch/kernels/csrc``
at first use.
"""

import contextlib
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from tiger_tpu_torch import Model204, SolverConfig, solve
from tiger_tpu_torch.kernels import _build, launch_totals, reset_launch_counts
from tiger_tpu_torch.kernels import radau as k_radau
from tiger_tpu_torch.kernels import rk45 as k_rk45
from tiger_tpu_torch.scenario import scenario
from tiger_tpu_torch.solver.controller import initial_step

pytestmark = pytest.mark.gpu

CFG = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
TF = 360.0


# Non-default options that the kernels implement, each held against the
# plain version as the defaults are.
OPTIONS = {
    "defaults": ({}, True),
    "reference_switches": (
        dict(h0_mode="global-zero-y0", fill_t0_queries=False, nan_shrink=1.0, max_rejects=5,
             stiff_detect=False, forcing_step_align=False),
        False,
    ),
    "detector_and_newton": (
        dict(stiff_test_every=8, stiff_streak=3, stiff_forgive=2, stiff_floor_streak=8,
             newton_reject_unconverged=False, radau_h_freeze_hi=1.2, newton_max_iter=4),
        True,
    ),
    "step_capped": (dict(max_steps=40), True),  # systems stop short: failed, NaN
}

# Each kernel's option instances beside its default one (B1: csrc/rk45.cu
# Rk45Option; B2: csrc/radau.cu RadauErrMode x predictor).
RK45_INSTANCES = {
    "fsal": dict(fsal=True),
    "compensated": dict(compensated=True),
    "pi": dict(controller="pi", pi_beta=0.08),
    "fsal_pi": dict(fsal=True, controller="pi"),
    "compensated_pi": dict(compensated=True, controller="pi"),
    # f32c at the reference's own tolerances
    "compensated_tight": dict(compensated=True, rtol=1e-6, atol=1e-9),
}
RADAU_INSTANCES = {
    "predictor": dict(radau_predictor=True),
    "reference": dict(radau_error_mode="reference", rtol=1e-3, atol=1e-6, max_steps=2_000),
    "reference_predictor": dict(radau_error_mode="reference", radau_predictor=True, rtol=1e-3,
                                atol=1e-6, max_steps=2_000),
    "radau5": dict(radau_error_mode="radau5"),
    "radau5_predictor": dict(radau_error_mode="radau5", radau_predictor=True),
}


@pytest.fixture(scope="module")
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    y0, p, f = scenario(512, TF / 1440.0, 0.01, device=dev)
    qt = torch.arange(0.0, TF + 1e-9, 60.0, device=dev)
    h0 = initial_step(Model204(), y0, 0.0, p, f, CFG)
    return y0, h0, qt, p, f


def _close(a, b):
    # Built without FMA contraction, each kernel rounds every operation as
    # the plain version's torch ops do on the card.
    return bool(((a - b).abs() <= 1e-6 + 1e-3 * b.abs()).all())


def _options(name, case):
    y0, _, qt, p, f = case
    options, safe_pow = OPTIONS[name]
    cfg = dataclasses.replace(CFG, **options)
    model = Model204(safe_pow=safe_pow)
    return model, cfg, initial_step(model, y0, 0.0, p, f, cfg)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_rk45_kernel_matches_plain(case, name):
    y0, _, qt, p, f = case
    model, cfg, h0 = _options(name, case)
    before = launch_totals()["rk45"]
    ker = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    torch.cuda.synchronize()
    assert launch_totals()["rk45"] == before + 1
    _assert_rk45_equal(ker, ref)


def _assert_rk45_equal(ker, ref):
    """Bit for bit: flags, all three counters, NaN in the same places."""
    assert torch.equal(ker.stiff, ref.stiff) and torch.equal(ker.failed, ref.failed)
    for a, b in zip(ker.stats, ref.stats):
        assert torch.equal(a, b)
    for a, b in ((ker.y_final, ref.y_final), (ker.dense, ref.dense)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


# B1 pools its systems in shared memory and runs them in time slices.  The
# package's pool holds a block's whole share at these sizes; the build with
# 64 slots makes a share of 16,384 systems pass through its pool twice over,
# so admission into freed slots runs on the card too.
POOL_BUILDS = {"package": (), "pool_of_64": ("-DTT_RK45_POOL=64",)}
_plain_results = {}


def _b1_inputs(n_sys, name):
    dev = torch.device("cuda", 0)
    options, safe_pow = OPTIONS[name]
    cfg = dataclasses.replace(CFG, **options)
    model = Model204(safe_pow=safe_pow)
    y0, p, f = scenario(n_sys, TF / 1440.0, 0.01, device=dev)
    qt = torch.arange(0.0, TF + 1e-9, 60.0, device=dev)
    return model, y0, initial_step(model, y0, 0.0, p, f, cfg), qt, p, f, cfg


POOL_CASES = [(n, "package") for n in (1, 31, 512, 4097)] + [
    (n, "pool_of_64") for n in (1, 31, 512, 4097, 16384)
]


@pytest.mark.parametrize("name", sorted(OPTIONS))
@pytest.mark.parametrize("n_sys,build", POOL_CASES)
def test_rk45_pooled_schedule_equals_plain(case, n_sys, build, name):
    model, y0, h0, qt, p, f, cfg = _b1_inputs(n_sys, name)
    if (n_sys, name) not in _plain_results:
        _plain_results[n_sys, name] = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    with _build.flags_in_use(_build.NVCC_FLAGS + POOL_BUILDS[build]):
        ker = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
        torch.cuda.synchronize()
    _assert_rk45_equal(ker, _plain_results[n_sys, name])
    if name == "step_capped":
        assert bool(ker.stiff.any()) and bool(torch.isnan(ker.y_final).any())


def test_rk45_two_launches_give_the_same_bytes(case):
    """No atomics and no traffic between blocks, and no system's result
    depends on the lane that runs it: every byte of the result repeats from
    launch to launch."""
    model, y0, h0, qt, p, f, cfg = _b1_inputs(4097, "defaults")
    one = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    two = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    torch.cuda.synchronize()
    for a, b in zip((one.y_final, one.dense, one.stiff, one.failed, *one.stats),
                    (two.y_final, two.dense, two.stiff, two.failed, *two.stats)):
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def test_rk45_nan_state_ends_as_in_plain(case):
    """A NaN state makes every error norm NaN: the system is rejected until
    a stiffness criterion or max_steps ends it, exactly as in rk45_plain."""
    model, y0, h0, qt, p, f, cfg = _b1_inputs(31, "defaults")
    y0[3, 4] = float("nan")
    ker = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    torch.cuda.synchronize()
    _assert_rk45_equal(ker, ref)
    assert bool(ker.stiff[3]) and int(ker.stats.n_accepted[3]) == 0
    assert bool(torch.isnan(ker.y_final[3]).all())


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_radau_kernel_matches_plain(case, name):
    y0, _, qt, p, f = case
    model, cfg, h0 = _options(name, case)
    rows = torch.nonzero(p["Hu"] < 1e-5).squeeze(1)
    sub = (y0[rows].contiguous(), h0[rows].contiguous())
    sp = {k: v[rows].contiguous() for k, v in p.items()}
    sf = f.take_systems(rows)
    before = launch_totals()["radau"]
    ker = k_radau.radau(model, *sub, 0.0, TF, qt, sp, sf, cfg)
    ref = k_radau.radau_plain(model, *sub, 0.0, TF, qt, sp, sf, cfg)
    torch.cuda.synchronize()
    assert launch_totals()["radau"] == before + 1
    assert torch.equal(ker.failed, ref.failed)
    for a, b in zip(ker.stats, ref.stats):
        assert torch.equal(a, b)
    ok = ~ker.failed
    assert _close(ker.y_final[ok], ref.y_final[ok]) and _close(ker.dense[ok], ref.dense[ok])


# B2 runs one warp per system: held to radau_plain bit for bit on stiff
# systems (every row Hu = 1e-6) over the first half hour, where most of a
# stiff system's attempts fall.
SPAN = 30.0


@pytest.fixture(scope="module")
def stiff_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    y0, p, f = scenario(131, SPAN / 1440.0, 1.0, device=dev)
    qt = torch.arange(0.0, SPAN + 1e-9, 5.0, device=dev)
    return y0, p, f, qt


def _first(stiff_case, n_sys):
    """(y0, params, forcings, qt) of the first ``n_sys`` stiff systems."""
    y0, p, f, qt = stiff_case
    rows = torch.arange(n_sys, device=y0.device)
    return y0[rows], {k: v[rows] for k, v in p.items()}, f.take_systems(rows), qt


def _radau_pair(model, y0, h0, qt, p, f, cfg):
    before = launch_totals()["radau"]
    ker = k_radau.radau(model, y0, h0, 0.0, SPAN, qt, p, f, cfg)
    ref = k_radau.radau_plain(model, y0, h0, 0.0, SPAN, qt, p, f, cfg)
    torch.cuda.synchronize()
    assert launch_totals()["radau"] == before + 1
    assert torch.equal(ker.failed, ref.failed)
    for a, b in zip(ker.stats, ref.stats):
        assert torch.equal(a, b)
    for a, b in ((ker.y_final, ref.y_final), (ker.dense, ref.dense)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    return ker


@pytest.mark.parametrize("name", sorted(OPTIONS))
@pytest.mark.parametrize("n_sys", [1, 3, 33, 131])
def test_radau_warp_per_system_equals_plain(stiff_case, n_sys, name):
    y0, p, f, qt = _first(stiff_case, n_sys)
    options, safe_pow = OPTIONS[name]
    cfg = dataclasses.replace(CFG, **options)
    model = Model204(safe_pow=safe_pow)
    ker = _radau_pair(model, y0, initial_step(model, y0, 0.0, p, f, cfg), qt, p, f, cfg)
    if name == "step_capped":
        assert bool(ker.failed.all())


def test_radau_max_rejects_fails_the_system(stiff_case):
    """A first step of the whole span is rejected twice in a row, past
    radau_max_rejects=1: those systems stop and report failed."""
    y0, p, f, qt = _first(stiff_case, 4)
    cfg = dataclasses.replace(CFG, radau_max_rejects=1)
    h0 = initial_step(Model204(), y0, 0.0, p, f, cfg)
    h0[::2] = SPAN
    ker = _radau_pair(Model204(), y0, h0, qt, p, f, cfg)
    assert bool(ker.failed[::2].all())
    assert bool(torch.isnan(ker.y_final[::2]).all())


def test_radau_keeps_a_nan_in_the_warp_maxima(stiff_case):
    """A NaN aquifer state makes the Newton norms and the error NaN: the
    warp's maxima must keep it (fmaxf would drop it and accept the step), so
    the system is rejected until it fails, as in radau_plain."""
    y0, p, f, qt = _first(stiff_case, 3)
    h0 = initial_step(Model204(), y0, 0.0, p, f, CFG)
    y0[0, 4] = float("nan")
    ker = _radau_pair(Model204(), y0, h0, qt, p, f, CFG)
    assert ker.failed.tolist() == [True, False, False]
    assert int(ker.stats.n_accepted[0]) == 0


def test_solve_on_card(case):
    y0, _, qt, p, f = case
    res = solve(Model204(), y0, 0.0, TF, qt, p, f, CFG)
    assert res.n_stiff >= 5 and not res.failed.any()
    assert bool(res.stiff[p["Hu"] < 1e-5].all())
    assert bool(torch.isfinite(res.y_final).all())


def test_plain_gather_divides_on_the_card_as_on_the_cpu():
    """The plain versions' forcing index and step cap round t/dt as one
    division on the card too (torch would multiply by 1/dt), so they pick
    the sample and the boundary the kernels pick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch.forcing import ForcingMeta, gather_forcings_column, zoh_step_cap

    meta = ForcingMeta((0, 48), (48, 2), (60.0, 1440.0))
    # Every float32 within 2,048 ulp of each snapped boundary (k - 5e-4) * dt.
    edges = np.array([(k - 5e-4) * 60.0 for k in range(1, 49)] + [(1 - 5e-4) * 1440.0],
                     dtype=np.float32)
    near = (edges.view(np.int32)[:, None] + np.arange(-2048, 2048, dtype=np.int32)).view(np.float32)
    t = torch.from_numpy(near.ravel().copy())
    data = torch.arange(50.0).repeat(t.numel(), 1).t().contiguous()
    h = torch.full_like(t, 90.0)
    on_card = gather_forcings_column(data.cuda(), meta, t.cuda(), 5e-4)
    on_cpu = gather_forcings_column(data, meta, t, 5e-4)
    for got, want in zip(on_card, on_cpu):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(zoh_step_cap(meta, t.cuda(), h.cuda()).cpu(), zoh_step_cap(meta, t, h))


def test_wrappers_raise_on_what_the_kernels_do_not_take(case):
    y0, h0, qt, p, f = case
    # float64 runs the double instances, but every tensor in y0's dtype:
    # float32 params (and queries) beside a float64 state are refused.
    with pytest.raises(TypeError, match="float64"):
        k_rk45.rk45(Model204(), y0.double(), h0.double(), 0.0, TF, qt, p, f, CFG)
    with pytest.raises(TypeError, match="float16"):
        k_rk45.rk45(Model204(), y0.half(), h0.half(), 0.0, TF, qt, p, f, CFG)
    with pytest.raises(ValueError, match="contiguous"):
        k_rk45.rk45(Model204(), y0, h0, 0.0, TF, qt[::2], p, f, CFG)
    with pytest.raises(ValueError, match="on cpu"):
        k_radau.radau(Model204(), y0, h0.cpu(), 0.0, TF, qt, p, f, CFG)
    with pytest.raises(ValueError, match="atol >= 0"):
        k_radau.radau(Model204(), y0, h0, 0.0, TF, qt, p, f, dataclasses.replace(CFG, atol=-1e-8))


def test_cli_run_equals_a_direct_solve(tmp_path):
    """The CLI on the card (no jax, no PyYAML: the config document comes from
    scenario.write_basin) writes the dense and final states of a direct
    solve() on the loaders' tensors bit for bit, and the direct routed
    discharge bit for bit (routing sums in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch import routing
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import solve_written_basin, write_basin

    s_count = 384
    cfg = config_from_dict(write_basin(str(tmp_path), s_count, days=0.5, stiff_frac=0.01))
    reset_launch_counts()
    out = run(cfg)
    assert all(n > 0 for n in launch_totals().values())
    assert out["n_failed"] == 0 and out["n_stiff"] > 0
    res, params, sp = solve_written_basin(cfg, "cuda")
    files = {name: read_netcdf(os.path.join(cfg.output.path, f"{name}_basin_rank_0.nc"),
                               (var,))[0][var]
             for name, var in (("final", "outputs"), ("dense", "outputs"),
                               ("discharge", "discharge"), ("state", "outputs"))}
    assert np.array_equal(files["dense"], res.dense.cpu().numpy())
    assert np.array_equal(files["final"], res.y_final.cpu().numpy())
    assert np.array_equal(files["state"], res.y_final.cpu().numpy().astype(np.float64))
    topo = routing.build_topology(sp["stream"], sp["next_stream"])
    direct = routing.routed_discharge(res.dense, params, topo).cpu().numpy()
    assert np.array_equal(files["discharge"], direct.astype(np.float64))


def test_routing_gives_the_same_bits_in_every_run_and_on_the_cpu():
    """accumulate_downstream_log on the card: two runs equal bit for bit,
    and equal to the CPU's (gathers and elementwise adds in a fixed order);
    routed_discharge twice on the card, equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch import routing
    from tiger_tpu_torch.scenario import scenario_arrays

    s_count, n_q = 65_535, 25
    rows = np.arange(s_count)
    topo = routing.build_topology(rows + 1, np.where(rows > 0, (rows - 1) // 2 + 1, -1))
    q = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (s_count, n_q)).astype(np.float32))
    runs = [routing.accumulate_downstream_log(q.cuda(), topo).cpu() for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], routing.accumulate_downstream_log(q, topo))
    p, _, _ = scenario_arrays(s_count)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda") for k, v in p.items()}
    dense = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (s_count, n_q, 5))
                             .astype(np.float32)).cuda()
    a, b = (routing.routed_discharge(dense, params, topo).cpu() for _ in range(2))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_chunked_run_crash_and_resume_equal_bit_for_bit(tmp_path, monkeypatch):
    """A windowed run on the card with stiff links, killed in its second
    window and resumed from the day-1 checkpoint into the same files,
    writes the files of the uninterrupted run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch import chunked
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import write_basin

    doc = write_basin(str(tmp_path / "basin"), 384, days=2.0, stiff_frac=0.01)
    doc["time"]["chunk_days"] = 1.0

    def cfg(outdir, **initial):
        doc["output"].update(checkpoint_interval="1d", path=str(tmp_path / outdir))
        doc["initial"] = dict(mode="hot", resume=True, **initial) if initial else {"mode": "cold"}
        return config_from_dict(doc)

    reset_launch_counts()
    out = run(cfg("ref"))
    assert launch_totals()["rk45"] == 2 and launch_totals()["radau"] >= 1
    assert out["n_failed"] == 0 and out["n_stiff"] > 0 and out["n_windows"] == 2
    real_solve, calls = chunked.solve, {"n": 0}

    def dying_solve(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real_solve(*a, **kw)

    monkeypatch.setattr(chunked, "solve", dying_solve)
    with pytest.raises(RuntimeError, match="simulated crash"):
        run(cfg("crashed"))
    monkeypatch.setattr(chunked, "solve", real_solve)
    state = str(tmp_path / "crashed" / "state_basin_rank_0.nc")
    run(cfg("crashed", file=state))
    for name, var in (("final", "outputs"), ("dense", "outputs"), ("discharge", "discharge"),
                      ("state", "outputs")):
        a, b = (read_netcdf(str(tmp_path / d / f"{name}_basin_rank_0.nc"), (var,))[0][var]
                for d in ("ref", "crashed"))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("name", sorted(RK45_INSTANCES))
def test_rk45_option_instance_equals_plain(name):
    """Each option instance of B1 equals rk45_plain bit for bit on 256
    systems (a pool's share passes through its slots), and FSAL also
    equals the default instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, y0, h0, qt, p, f, cfg = _b1_inputs(256, "defaults")
    cfg = dataclasses.replace(cfg, **RK45_INSTANCES[name])
    before = launch_totals()["rk45"]
    ker = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    torch.cuda.synchronize()
    assert launch_totals()["rk45"] == before + 1
    _assert_rk45_equal(ker, ref)
    assert bool(ker.stiff[p["Hu"] < 1e-5].all())
    if cfg.fsal:
        without = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, dataclasses.replace(cfg, fsal=False))
        torch.cuda.synchronize()
        _assert_rk45_equal(ker, without)


def test_option_set_without_an_instance_raises():
    """fsal with compensated has no B1 instance (SolverConfig refuses it;
    forced here past the check): the C dispatcher refuses the launch and the
    wrapper raises, naming the set; nothing falls back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, y0, h0, qt, p, f, cfg = _b1_inputs(64, "defaults")
    cfg = dataclasses.replace(cfg, fsal=True)
    object.__setattr__(cfg, "compensated", True)
    before = launch_totals()["rk45"]
    with pytest.raises(NotImplementedError, match="no instance for fsal=True, compensated=True"):
        k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    assert launch_totals()["rk45"] == before


@pytest.mark.parametrize("name", sorted(RADAU_INSTANCES))
def test_radau_option_instance_equals_plain(stiff_case, name):
    """Each option instance of B2 equals radau_plain bit for bit on the
    stiff systems over the first half hour ('reference' fails them at
    max_steps, as in the plain version: its estimate caps h near the
    tolerance)."""
    y0, p, f, qt = _first(stiff_case, 33)
    cfg = dataclasses.replace(CFG, **RADAU_INSTANCES[name])
    h0 = initial_step(Model204(), y0, 0.0, p, f, cfg)
    _radau_pair(Model204(), y0, h0, qt, p, f, cfg)


def test_f32c_run_equals_a_direct_solve(tmp_path):
    """solver.precision f32c (compensated B1) through the CLI on the card
    at the reference's rtol 1e-6 / atol 1e-9, with the PI controller: the
    dense and final files equal a direct solve() bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import solve_written_basin, write_basin

    doc = write_basin(str(tmp_path), 384, days=0.5, stiff_frac=0.01)
    doc["solver"].update(precision="f32c", tolerances={"rtol": 1e-6, "atol": 1e-9}, controller="pi")
    cfg = config_from_dict(doc)
    assert cfg.solver_config().compensated and cfg.solver_config().rtol == 1e-6
    reset_launch_counts()
    out = run(cfg)
    assert all(n > 0 for n in launch_totals().values())
    assert out["n_failed"] == 0
    res, _, _ = solve_written_basin(cfg, "cuda")
    for name, want in (("dense", res.dense), ("final", res.y_final)):
        got = read_netcdf(os.path.join(cfg.output.path, f"{name}_basin_rank_0.nc"),
                          ("outputs",))[0]["outputs"]
        assert np.array_equal(got, want.cpu().numpy()), name


# ---- float64: the double instances -----------------------------------------


def _double(y0, p, f, qt):
    return (y0.double(), {k: v.double() for k, v in p.items()}, f, qt.double())


@pytest.fixture(scope="module")
def case64(case):
    y0, _, qt, p, f = case
    return _double(y0, p, f, qt)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_rk45_f64_instance_equals_plain(case64, name):
    """B1's double instance equals rk45_plain in float64 bit for bit, on
    the option cases of the float instances (each a default option set)."""
    y0, p, f, qt = case64
    options, safe_pow = OPTIONS[name]
    cfg = dataclasses.replace(CFG, **options)
    model = Model204(safe_pow=safe_pow)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    before = k_rk45.rk45_launches["default/f64"]
    ker = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    torch.cuda.synchronize()
    assert k_rk45.rk45_launches["default/f64"] == before + 1
    assert ker.y_final.dtype == ker.dense.dtype == torch.float64
    _assert_rk45_equal(ker, ref)


@pytest.mark.parametrize("n_sys,build", POOL_CASES)
def test_rk45_f64_pooled_schedule_equals_plain(case, n_sys, build):
    """The double instance's pool (256 lanes a block) under both builds,
    with admission into freed slots at 4,097 and 16,384 systems."""
    model, y0, h0, qt, p, f, cfg = _b1_inputs(n_sys, "defaults")
    y0, p, f, qt = _double(y0, p, f, qt)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    with _build.flags_in_use(_build.NVCC_FLAGS + POOL_BUILDS[build]):
        ker = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
        torch.cuda.synchronize()
    _assert_rk45_equal(ker, ref)


def test_rk45_f64_two_launches_give_the_same_bytes(case):
    model, y0, h0, qt, p, f, cfg = _b1_inputs(4097, "defaults")
    y0, p, f, qt = _double(y0, p, f, qt)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    one = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    two = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    torch.cuda.synchronize()
    for a, b in zip((one.y_final, one.dense, one.stiff, one.failed, *one.stats),
                    (two.y_final, two.dense, two.stiff, two.failed, *two.stats)):
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def test_rk45_f64_nan_state_ends_as_in_plain(case):
    model, y0, h0, qt, p, f, cfg = _b1_inputs(31, "defaults")
    y0, p, f, qt = _double(y0, p, f, qt)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    y0[3, 4] = float("nan")
    ker = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    torch.cuda.synchronize()
    _assert_rk45_equal(ker, ref)
    assert bool(ker.stiff[3]) and int(ker.stats.n_accepted[3]) == 0
    assert bool(torch.isnan(ker.y_final[3]).all())


# A real-time hourly update: the second hour of a 2-hour scenario, from the
# state B1 carried out of the first (a NaN row keeps its start), one query
# at the window's end, at the solver's defaults in float64 (rtol 1e-6) and
# CFG's tolerances in float32.  The systems live some tens of attempts,
# under a slice, so nearly every lane takes its next system mid-slice: from
# the slice's order, then from the block's share.
HOT_SYSTEMS = 65_536
HOT_CFG = {torch.float32: CFG, torch.float64: SolverConfig()}
_hot_cases = {}


def _hot_window(dtype):
    """(model, y0, h0, qt, params, forcing, cfg, rk45_plain's result)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if dtype not in _hot_cases:
        dev, model, cfg = torch.device("cuda", 0), Model204(), HOT_CFG[dtype]
        y_cold, p, f = scenario(HOT_SYSTEMS, 2.0 / 24.0, 0.001, device=dev, dtype=dtype)
        qt0 = torch.tensor([0.0, 60.0], dtype=dtype, device=dev)
        warm = k_rk45.rk45(model, y_cold, initial_step(model, y_cold, 0.0, p, f, cfg), 0.0, 60.0,
                           qt0, p, f, cfg)
        y0 = torch.where(torch.isnan(warm.y_final), y_cold, warm.y_final)
        h0 = initial_step(model, y0, 60.0, p, f, cfg)
        qt = torch.tensor([120.0], dtype=dtype, device=dev)
        ref = k_rk45.rk45_plain(model, y0, h0, 60.0, 120.0, qt, p, f, cfg)
        _hot_cases[dtype] = (model, y0, h0, qt, p, f, cfg, ref)
    return _hot_cases[dtype]


@pytest.mark.parametrize("build", sorted(POOL_BUILDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rk45_hot_window_equals_plain(dtype, build):
    """B1's float and double default instances on a hot-started 1-hour
    window of 65,536 systems equal rk45_plain bit for bit, under the
    package's pool and under 64 slots (a share of ~496 systems through
    them)."""
    model, y0, h0, qt, p, f, cfg, ref = _hot_window(dtype)
    with _build.flags_in_use(_build.NVCC_FLAGS + POOL_BUILDS[build]):
        ker = k_rk45.rk45(model, y0, h0, 60.0, 120.0, qt, p, f, cfg)
        torch.cuda.synchronize()
        slice_attempts = k_rk45.rk45_geometry(HOT_SYSTEMS, 0, dtype)["slice_attempts"]
    _assert_rk45_equal(ker, ref)
    assert ker.y_final.dtype == dtype
    # Most systems end inside their first slice.
    assert int(ref.stats.n_attempts.median()) < slice_attempts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rk45_hot_window_two_launches_give_the_same_bytes(dtype):
    """Lanes claim the next system from a counter in shared memory, so which
    lane runs which system may differ from launch to launch; no byte of the
    result does."""
    model, y0, h0, qt, p, f, cfg, _ = _hot_window(dtype)
    one = k_rk45.rk45(model, y0, h0, 60.0, 120.0, qt, p, f, cfg)
    two = k_rk45.rk45(model, y0, h0, 60.0, 120.0, qt, p, f, cfg)
    torch.cuda.synchronize()
    for a, b in zip((one.y_final, one.dense, one.stiff, one.failed, *one.stats),
                    (two.y_final, two.dense, two.stiff, two.failed, *two.stats)):
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("name", sorted(OPTIONS))
@pytest.mark.parametrize("n_sys", [1, 3, 33, 131])
def test_radau_f64_warp_per_system_equals_plain(stiff_case, n_sys, name):
    """B2's double instance equals radau_plain in float64 bit for bit on
    the stiff systems over the first half hour (its warp maxima reduce
    64-bit patterns)."""
    y0, p, f, qt = _double(*_first(stiff_case, n_sys))
    options, safe_pow = OPTIONS[name]
    cfg = dataclasses.replace(CFG, **options)
    model = Model204(safe_pow=safe_pow)
    before = k_radau.radau_launches["embedded3/f64"]
    ker = _radau_pair(model, y0, initial_step(model, y0, 0.0, p, f, cfg), qt, p, f, cfg)
    assert k_radau.radau_launches["embedded3/f64"] == before + 1
    assert ker.y_final.dtype == torch.float64
    if name == "step_capped":
        assert bool(ker.failed.all())


def test_radau_f64_keeps_a_nan_in_the_warp_maxima(stiff_case):
    y0, p, f, qt = _double(*_first(stiff_case, 3))
    h0 = initial_step(Model204(), y0, 0.0, p, f, CFG)
    y0[0, 4] = float("nan")
    ker = _radau_pair(Model204(), y0, h0, qt, p, f, CFG)
    assert ker.failed.tolist() == [True, False, False]
    assert int(ker.stats.n_accepted[0]) == 0


@pytest.mark.parametrize("name", sorted(RK45_INSTANCES))
def test_rk45_f64_option_instance_equals_plain(case64, name):
    """Each option instance's double twin equals rk45_plain in float64 bit
    for bit (512 systems: a pool's share passes through its slots), and
    FSAL's the default double instance; each is counted under its name."""
    y0, p, f, qt = case64
    cfg = dataclasses.replace(CFG, **RK45_INSTANCES[name])
    h0 = initial_step(Model204(), y0, 0.0, p, f, cfg)
    instance = k_rk45.F64_INSTANCES[k_rk45.rk45_options(cfg)]
    before = k_rk45.rk45_launches[instance]
    ker = k_rk45.rk45(Model204(), y0, h0, 0.0, TF, qt, p, f, cfg)
    ref = k_rk45.rk45_plain(Model204(), y0, h0, 0.0, TF, qt, p, f, cfg)
    torch.cuda.synchronize()
    assert k_rk45.rk45_launches[instance] == before + 1
    assert ker.y_final.dtype == torch.float64
    _assert_rk45_equal(ker, ref)
    assert bool(ker.stiff[p["Hu"] < 1e-5].all())
    if cfg.fsal:
        without = k_rk45.rk45(Model204(), y0, h0, 0.0, TF, qt, p, f, dataclasses.replace(cfg, fsal=False))
        torch.cuda.synchronize()
        _assert_rk45_equal(ker, without)


@pytest.mark.parametrize("name", sorted(RADAU_INSTANCES))
def test_radau_f64_option_instance_equals_plain(stiff_case, name):
    """Each option instance's double twin equals radau_plain in float64 bit
    for bit on 33 stiff systems over the first half hour, counted under its
    name."""
    y0, p, f, qt = _double(*_first(stiff_case, 33))
    cfg = dataclasses.replace(CFG, **RADAU_INSTANCES[name])
    h0 = initial_step(Model204(), y0, 0.0, p, f, cfg)
    instance = k_radau.instance_name(cfg, torch.float64)
    before = k_radau.radau_launches[instance]
    ker = _radau_pair(Model204(), y0, h0, qt, p, f, cfg)
    assert k_radau.radau_launches[instance] == before + 1
    assert ker.y_final.dtype == torch.float64


def test_solve_f32_retries_radau_failures_in_f64(stiff_case):
    """A float32 solve() on the card retries the systems B2 fails through
    the double instances of the same config (radau5 with the predictor and
    radau_max_rejects 2 fail stiff systems in float32): each retried row
    equals the chain run by hand through the kernels, cast to float32."""
    y0, p, f, qt = _first(stiff_case, 33)
    cfg = dataclasses.replace(CFG, radau_error_mode="radau5", radau_predictor=True,
                              radau_max_rejects=2)
    reset_launch_counts()
    res = solve(Model204(), y0, 0.0, SPAN, qt, p, f, cfg)
    h0 = initial_step(Model204(), y0, 0.0, p, f, cfg)
    rk = k_rk45.rk45(Model204(), y0, h0, 0.0, SPAN, qt, p, f, cfg)
    rows = torch.nonzero(rk.stiff).squeeze(1)
    rd = k_radau.radau(Model204(), y0[rows], h0[rows], 0.0, SPAN, qt,
                       {k: v[rows] for k, v in p.items()}, f.take_systems(rows), cfg)
    lost = rows[rd.failed]
    assert lost.numel() > 0, "no system failed in float32: nothing to retry"
    from tiger_tpu_torch.solver.api import retry_failed_f64

    retry = retry_failed_f64(Model204(), y0, h0, 0.0, SPAN, qt.double(), p, f, cfg, 0.0, lost)
    assert retry.radau_rows is not None  # B1 flags the stiff systems again
    assert k_rk45.rk45_launches["default/f64"] == k_radau.radau_launches["radau5+predictor/f64"] == 2
    assert torch.equal(res.failed[retry.rows], retry.failed)
    for got, want in ((res.y_final, retry.y_final), (res.dense, retry.dense)):
        got, want = got[retry.rows], want.float()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def test_solve_f64_on_card(case64):
    y0, p, f, qt = case64
    reset_launch_counts()
    res = solve(Model204(), y0, 0.0, TF, qt, p, f, SolverConfig())
    assert k_rk45.rk45_launches["default/f64"] == 1 and k_radau.radau_launches["embedded3/f64"] == 1
    assert res.y_final.dtype == res.dense.dtype == torch.float64
    assert res.n_stiff >= 5 and not res.failed.any()
    assert bool(res.stiff[p["Hu"] < 1e-5].all())
    assert bool(torch.isfinite(res.y_final).all())


def test_f64_default_run_equals_a_direct_solve(tmp_path):
    """A config without solver.precision runs float64 on the card (the
    double instances): its dense, final and state files equal a direct
    solve() bit for bit, its discharge the direct routed discharge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch import routing
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import solve_written_basin, write_basin

    doc = write_basin(str(tmp_path), 384, days=0.5, stiff_frac=0.01)
    doc["solver"].pop("precision")
    doc["solver"]["tolerances"] = {"rtol": 1e-6, "atol": 1e-9}
    cfg = config_from_dict(doc)
    assert cfg.solver.precision == "f64"
    reset_launch_counts()
    out = run(cfg)
    assert k_rk45.rk45_launches["default/f64"] == 1 and k_radau.radau_launches["embedded3/f64"] == 1
    assert out["n_failed"] == 0 and out["n_stiff"] > 0
    res, params, sp = solve_written_basin(cfg, "cuda")
    assert res.y_final.dtype == torch.float64
    files = {name: read_netcdf(os.path.join(cfg.output.path, f"{name}_basin_rank_0.nc"),
                               (var,))[0][var]
             for name, var in (("final", "outputs"), ("dense", "outputs"),
                               ("discharge", "discharge"), ("state", "outputs"))}
    assert files["dense"].dtype == np.float64
    assert np.array_equal(files["dense"], res.dense.cpu().numpy())
    assert np.array_equal(files["final"], res.y_final.cpu().numpy())
    assert np.array_equal(files["state"], res.y_final.cpu().numpy())
    topo = routing.build_topology(sp["stream"], sp["next_stream"])
    direct = routing.routed_discharge(res.dense, params, topo).cpu().numpy()
    assert np.array_equal(files["discharge"], direct.astype(np.float64))


def test_f64_chunked_run_equals_the_windows_and_a_resume(tmp_path, monkeypatch):
    """A windowed float64 run on the card (2 one-day windows, a daily
    checkpoint): its files equal the windows run by hand, and a run killed
    in its second window and resumed from the day-1 checkpoint, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch import chunked, routing
    from tiger_tpu_torch.checkpoint import cold_state
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.forcing import ForcingSpec
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.models.model204 import Y0_COMMON
    from tiger_tpu_torch.params import load_spatial_params, model_params
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import write_basin

    doc = write_basin(str(tmp_path / "basin"), 384, days=2.0, stiff_frac=0.01)
    doc["time"]["chunk_days"] = 1.0
    doc["solver"] = {"precision": "f64", "tolerances": {"rtol": 1e-6, "atol": 1e-9}}

    def cfg(outdir, **initial):
        doc["output"].update(checkpoint_interval="1d", path=str(tmp_path / outdir))
        doc["initial"] = dict(mode="hot", resume=True, **initial) if initial else {"mode": "cold"}
        return config_from_dict(doc)

    def files(outdir):
        return {name: read_netcdf(str(tmp_path / outdir / f"{name}_basin_rank_0.nc"), (var,))[0][var]
                for name, var in (("final", "outputs"), ("dense", "outputs"),
                                  ("discharge", "discharge"), ("state", "outputs"))}

    reset_launch_counts()
    out = run(cfg("ref"))
    assert k_rk45.rk45_launches["default/f64"] == 2 and k_radau.radau_launches["embedded3/f64"] >= 1
    assert out["n_failed"] == 0 and out["n_stiff"] > 0 and out["n_windows"] == 2
    ref = files("ref")
    assert ref["dense"].dtype == ref["state"].dtype == np.float64

    # The windows by hand.
    c = cfg("ref")
    sp = load_spatial_params(c.params_file)
    params = {k: torch.as_tensor(v, device="cuda").to(torch.float64)
              for k, v in model_params(sp).items()}
    specs = [ForcingSpec(os.path.join(c.forcings.path, x["file"]), x["var"], float(x["dt_hours"]))
             for x in c.forcings.files]
    loader = chunked.netcdf_window_loader(specs, sp["stream"], c.forcings.lookup, "cuda")
    topo = routing.build_topology(sp["stream"], sp["next_stream"])
    y = torch.as_tensor(cold_state(Y0_COMMON, 384), device="cuda").to(torch.float64)
    dense, discharge = [], []
    for w in range(2):
        w0 = 1440.0 * w
        qt = torch.as_tensor(np.arange(0 if w == 0 else 1, 25) * 60.0, device="cuda")
        res = solve(Model204(), y, 0.0, 1440.0, qt.to(torch.float64), params,
                    loader(w0, w0 + 1440.0), c.solver_config(), t_shift=w0)
        y = torch.where(torch.isnan(res.y_final), y, res.y_final)
        dense.append(res.dense.cpu().numpy())
        discharge.append(routing.routed_discharge(res.dense, params, topo).cpu().numpy())
    assert np.array_equal(ref["dense"], np.concatenate(dense, axis=1))
    assert np.array_equal(ref["final"], y.cpu().numpy())
    assert np.array_equal(ref["state"], y.cpu().numpy())
    assert np.array_equal(ref["discharge"], np.concatenate(discharge, axis=1))

    # A crash in the second window, then the resume.
    real_solve, calls = chunked.solve, {"n": 0}

    def dying_solve(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real_solve(*a, **kw)

    monkeypatch.setattr(chunked, "solve", dying_solve)
    with pytest.raises(RuntimeError, match="simulated crash"):
        run(cfg("crashed"))
    monkeypatch.setattr(chunked, "solve", real_solve)
    run(cfg("crashed", file=str(tmp_path / "crashed" / "state_basin_rank_0.nc")))
    again = files("crashed")
    for name in ref:
        assert again[name].dtype == ref[name].dtype and np.array_equal(again[name], ref[name]), name


# --- Model 200 (Hamon PET and the ET ramp): every instance of both kernels,
# float and double, with and without a time shift, against its plain version.

M200_B1 = {"default": {}, "fsal": dict(fsal=True), "compensated": dict(compensated=True),
           "pi": dict(controller="pi"), "fsal+pi": dict(fsal=True, controller="pi"),
           "compensated+pi": dict(compensated=True, controller="pi")}
M200_B2 = {"embedded3": {}, "embedded3+predictor": dict(radau_predictor=True),
           "reference": RADAU_INSTANCES["reference"],
           "reference+predictor": RADAU_INSTANCES["reference_predictor"],
           "radau5": dict(radau_error_mode="radau5"),
           "radau5+predictor": dict(radau_error_mode="radau5", radau_predictor=True)}
M200_SHIFTS = [pytest.param(0.0, id="unshifted"), pytest.param(1440.0, id="shift_1440")]
M200_DTYPES = [pytest.param(torch.float32, id="f32"), pytest.param(torch.float64, id="f64")]


def _m200_inputs(n_sys, dtype, span=TF):
    """Model 200 on scenario()'s basin from early July, the latitude over
    25-50 degrees, on the card."""
    from tiger_tpu_torch.models import Model200

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    y0, p, f = scenario(n_sys, span / 1440.0, 0.0, device=dev, dtype=dtype)
    p["lat"] = torch.linspace(25.0, 50.0, n_sys, dtype=dtype, device=dev)
    return Model200(doy0=182.0), y0, p, f


@pytest.mark.parametrize("shift", M200_SHIFTS)
@pytest.mark.parametrize("dtype", M200_DTYPES)
@pytest.mark.parametrize("name", sorted(M200_B1))
def test_model200_rk45_instance_equals_plain(name, dtype, shift):
    model, y0, p, f = _m200_inputs(512, dtype)
    cfg = dataclasses.replace(CFG, **M200_B1[name])
    qt = torch.arange(0.0, TF + 1e-9, 60.0, dtype=dtype, device=y0.device)
    h0 = initial_step(model, y0, 0.0, p, f, cfg, shift)
    instance = "m200/" + name + ("/f64" if dtype == torch.float64 else "")
    before = k_rk45.rk45_launches[instance]
    ker = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg, shift)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg, shift)
    torch.cuda.synchronize()
    assert k_rk45.rk45_launches[instance] == before + 1
    _assert_rk45_equal(ker, ref)
    assert not bool(ker.stiff.any())


@pytest.mark.parametrize("shift", M200_SHIFTS)
@pytest.mark.parametrize("dtype", M200_DTYPES)
@pytest.mark.parametrize("name", sorted(M200_B2))
def test_model200_radau_instance_equals_plain(name, dtype, shift):
    model, y0, p, f = _m200_inputs(4, dtype)
    cfg = dataclasses.replace(CFG, **M200_B2[name])
    qt = torch.arange(0.0, SPAN + 1e-9, 5.0, dtype=dtype, device=y0.device)
    h0 = torch.full((4,), 1e-3, dtype=dtype, device=y0.device)
    instance = "m200/" + name + ("/f64" if dtype == torch.float64 else "")
    before = k_radau.radau_launches[instance]
    ker = k_radau.radau(model, y0, h0, 0.0, SPAN, qt, p, f, cfg, shift)
    ref = k_radau.radau_plain(model, y0, h0, 0.0, SPAN, qt, p, f, cfg, shift)
    torch.cuda.synchronize()
    assert k_radau.radau_launches[instance] == before + 1
    assert torch.equal(ker.failed, ref.failed)
    for a, b in zip(ker.stats, ref.stats):
        assert torch.equal(a, b)
    for a, b in ((ker.y_final, ref.y_final), (ker.dense, ref.dense)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("dtype", M200_DTYPES)
def test_model200_two_launches_give_the_same_bytes(dtype):
    model, y0, p, f = _m200_inputs(4097, dtype)
    qt = torch.arange(0.0, TF + 1e-9, 60.0, dtype=dtype, device=y0.device)
    h0 = initial_step(model, y0, 0.0, p, f, CFG, 1440.0)
    one = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, CFG, 1440.0)
    two = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, CFG, 1440.0)
    rows = torch.arange(64, device=y0.device)
    sub = (y0[rows], h0[rows], 0.0, SPAN, qt[qt <= SPAN], {k: v[rows] for k, v in p.items()},
           f.take_systems(rows), CFG, 1440.0)
    r_one, r_two = k_radau.radau(model, *sub), k_radau.radau(model, *sub)
    torch.cuda.synchronize()
    for a, b in zip((one.y_final, one.dense, one.stiff, *one.stats, r_one.y_final, r_one.dense,
                     *r_one.stats),
                    (two.y_final, two.dense, two.stiff, *two.stats, r_two.y_final, r_two.dense,
                     *r_two.stats)):
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def test_model200_run_and_windows_equal_a_direct_solve(tmp_path):
    """model.uid 200 from 2000-07-01 (doy0 183) on the card, float32: the
    run's files equal a direct solve() bit for bit, and a run in 2 one-day
    windows (the second with t_shift 1440) equals the windows by hand."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch import chunked, routing
    from tiger_tpu_torch.checkpoint import cold_state
    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.forcing import ForcingSpec
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.models import Model200
    from tiger_tpu_torch.params import model_params
    from tiger_tpu_torch.run import COLD_STATE_DEFAULTS, run
    from tiger_tpu_torch.scenario import solve_written_basin, write_basin

    doc = write_basin(str(tmp_path / "basin"), 384, days=2.0)
    doc["model"] = {"uid": 200}
    doc["time"] = {"start": "2000-07-01T00:00:00", "end": "2000-07-03T00:00:00"}

    def files(cfg):
        return {name: read_netcdf(os.path.join(cfg.output.path, f"{name}_basin_rank_0.nc"),
                                  (var,))[0][var]
                for name, var in (("final", "outputs"), ("dense", "outputs"),
                                  ("discharge", "discharge"), ("state", "outputs"))}

    doc["output"]["path"] = str(tmp_path / "cli")
    cfg = config_from_dict(doc)
    reset_launch_counts()
    out = run(cfg)
    assert k_rk45.rk45_launches["m200/default"] == 1 and out["n_failed"] == 0
    res, params, sp = solve_written_basin(cfg, "cuda")
    got = files(cfg)
    topo = routing.build_topology(sp["stream"], sp["next_stream"])
    assert np.array_equal(got["dense"], res.dense.cpu().numpy())
    assert np.array_equal(got["final"], res.y_final.cpu().numpy())
    assert np.array_equal(got["state"], res.y_final.cpu().numpy())
    assert np.array_equal(got["discharge"], routing.routed_discharge(res.dense, params, topo).cpu().numpy())

    doc["time"]["chunk_days"] = 1.0
    doc["output"].update(path=str(tmp_path / "win"), checkpoint_interval="1d")
    wcfg = config_from_dict(doc)
    reset_launch_counts()
    out = run(wcfg)
    assert k_rk45.rk45_launches["m200/default"] == 2 and out["n_windows"] == 2
    specs = [ForcingSpec(os.path.join(wcfg.forcings.path, x["file"]), x["var"], float(x["dt_hours"]))
             for x in wcfg.forcings.files]
    loader = chunked.netcdf_window_loader(specs, sp["stream"], wcfg.forcings.lookup, "cuda")
    p32 = {k: torch.as_tensor(v, device="cuda").to(torch.float32) for k, v in model_params(sp).items()}
    y = torch.as_tensor(cold_state(COLD_STATE_DEFAULTS.get(200, (0.0,) * 5), 384),
                        device="cuda").to(torch.float32)
    dense = []
    for w in range(2):
        w0 = 1440.0 * w
        qt = torch.as_tensor(np.arange(0 if w == 0 else 1, 25) * 60.0, device="cuda").to(torch.float32)
        r = solve(Model200(doy0=183.0), y, 0.0, 1440.0, qt, p32, loader(w0, w0 + 1440.0),
                  wcfg.solver_config(), t_shift=w0)
        y = torch.where(torch.isnan(r.y_final), y, r.y_final)
        dense.append(r.dense.cpu().numpy())
    got = files(wcfg)
    assert np.array_equal(got["dense"], np.concatenate(dense, axis=1))
    assert np.array_equal(got["final"], y.cpu().numpy())


# --- DummyModel (the reference's 5-state linear test system): every
# instance of both kernels, float and double, against its plain version, and
# the reference's golden final state.

DUMMY_GOLDEN = [1.91791, 1.90017, 2.39397, 1.71872, 3.06922]


def _dummy_inputs(n_sys, dtype):
    """n_sys systems from seeded states uniform over 0.5-2.0, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch import DummyModel

    y0 = np.random.default_rng(5).uniform(0.5, 2.0, (n_sys, 5))
    return DummyModel(), torch.as_tensor(y0, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", M200_DTYPES)
@pytest.mark.parametrize("name", sorted(M200_B1))
def test_dummy_rk45_instance_equals_plain(name, dtype):
    """Each B1 instance of DummyModel (no parameter block, a null params
    pointer) equals rk45_plain bit for bit on 64 systems over 5 minutes,
    and a one-day shift changes nothing (its rhs reads no time)."""
    model, y0 = _dummy_inputs(64, dtype)
    cfg = dataclasses.replace(CFG, **M200_B1[name])
    qt = torch.linspace(0.0, 5.0, 11, dtype=dtype, device=y0.device)
    h0 = initial_step(model, y0, 0.0, None, None, cfg)
    instance = "dummy/" + name + ("/f64" if dtype == torch.float64 else "")
    before = k_rk45.rk45_launches[instance]
    ker = k_rk45.rk45(model, y0, h0, 0.0, 5.0, qt, None, None, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, 5.0, qt, None, None, cfg)
    shifted = k_rk45.rk45(model, y0, h0, 0.0, 5.0, qt, None, None, cfg, 1440.0)
    torch.cuda.synchronize()
    assert k_rk45.rk45_launches[instance] == before + 2
    _assert_rk45_equal(ker, ref)
    _assert_rk45_equal(shifted, ker)
    assert not bool(ker.stiff.any()) and int(ker.stats.n_attempts.min()) > 0


@pytest.mark.parametrize("dtype", M200_DTYPES)
@pytest.mark.parametrize("name", sorted(M200_B2))
def test_dummy_radau_instance_equals_plain(name, dtype):
    """Each B2 instance of DummyModel equals radau_plain bit for bit on 64
    systems over 5 minutes (every flag and counter)."""
    model, y0 = _dummy_inputs(64, dtype)
    cfg = dataclasses.replace(CFG, **M200_B2[name])
    qt = torch.linspace(0.0, 5.0, 11, dtype=dtype, device=y0.device)
    h0 = initial_step(model, y0, 0.0, None, None, cfg)
    instance = "dummy/" + name + ("/f64" if dtype == torch.float64 else "")
    before = k_radau.radau_launches[instance]
    ker = k_radau.radau(model, y0, h0, 0.0, 5.0, qt, None, None, cfg)
    ref = k_radau.radau_plain(model, y0, h0, 0.0, 5.0, qt, None, None, cfg)
    torch.cuda.synchronize()
    assert k_radau.radau_launches[instance] == before + 1
    assert torch.equal(ker.failed, ref.failed)
    for a, b in zip(ker.stats, ref.stats):
        assert torch.equal(a, b)
    for a, b in ((ker.y_final, ref.y_final), (ker.dense, ref.dense)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_dummy_golden_final_state_f64():
    """solve() on the card, float64 at the reference's rtol 1e-6 / atol
    1e-9: 4 systems of ones over t in [0, 5] reach the golden final state
    within 5e-6 through B1's dummy/default/f64 (no system stiff, so B2 is
    not launched), and the 10,000-query grid equals rk45_plain's bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch import DummyModel

    qt = torch.tensor((np.arange(1, 10001) * 5.0) / 10001.0, dtype=torch.float64, device="cuda")
    y0 = torch.ones((4, 5), dtype=torch.float64, device="cuda")
    cfg = SolverConfig(fill_t0_queries=False)
    reset_launch_counts()
    res = solve(DummyModel(), y0, 0.0, 5.0, qt, config=cfg)
    torch.cuda.synchronize()
    assert launch_totals() == {"rk45": 1, "radau": 0}
    assert k_rk45.rk45_launches["dummy/default/f64"] == 1
    assert res.n_stiff == 0 and not bool(res.failed.any())
    golden = torch.tensor(DUMMY_GOLDEN, dtype=torch.float64, device="cuda").expand(4, 5)
    assert float(((res.y_final - golden).abs() / golden).max()) <= 5e-6
    h0 = initial_step(DummyModel(), y0, 0.0, None, None, cfg)
    ref = k_rk45.rk45_plain(DummyModel(), y0, h0, 0.0, 5.0, qt, None, None, cfg)
    assert torch.equal(res.dense, ref.dense) and torch.equal(res.y_final, ref.y_final)


def test_dummy_run_and_windows_equal_a_direct_solve(tmp_path):
    """model.uid 1 on the card, float32: the run's dense file equals a
    direct solve() bit for bit, through run() and through
    ``python -m tiger_tpu_torch.run``, whole and in 2 one-day windows,
    through B1's dummy/default instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import sys

    import yaml

    from tiger_tpu_torch.config import config_from_dict
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.run import run
    from tiger_tpu_torch.scenario import solve_written_basin, write_basin

    doc = write_basin(str(tmp_path / "basin"), 384, days=2.0)
    doc["model"] = {"uid": 1, "name": "DummyModel"}
    doc["output"]["path"] = str(tmp_path / "cli")
    cfg = config_from_dict(doc)
    reset_launch_counts()
    out = run(cfg)
    assert k_rk45.rk45_launches["dummy/default"] == 1 and out["n_failed"] == 0
    res, _, _ = solve_written_basin(cfg, "cuda")

    def dense(folder):
        return read_netcdf(os.path.join(folder, "dense_basin_rank_0.nc"), ("outputs",))[0]["outputs"]

    assert np.array_equal(dense(cfg.output.path), res.dense.cpu().numpy())

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the repository's

    def module_run(name):
        doc["output"]["path"] = str(tmp_path / name)
        (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump(doc))
        proc = subprocess.run([sys.executable, "-m", "tiger_tpu_torch.run", "--config",
                               str(tmp_path / f"{name}.yaml")], capture_output=True, text=True,
                              timeout=600, cwd=root)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return dense(str(tmp_path / name))

    assert np.array_equal(module_run("module"), res.dense.cpu().numpy())
    doc["time"]["chunk_days"] = 1.0
    doc["output"].update(path=str(tmp_path / "win"), checkpoint_interval="1d")
    reset_launch_counts()
    out = run(config_from_dict(doc))
    assert k_rk45.rk45_launches["dummy/default"] == 2 and out["n_windows"] == 2
    assert np.array_equal(module_run("module_win"), dense(str(tmp_path / "win")))


def test_model200_radau_stays_within_the_2_day_budget():
    """tests/test_radau_regression.py::test_model200_radau_attempts_budget
    on the card, over its full 2 days: Model 200 (doy0 1, as there) on the
    basin without stiff rows, 8 systems, float32 at rtol 1e-5 / atol 1e-8,
    max_steps 100,000, through B2's m200/embedded3 from initial_step's h0:
    no system fails, none takes more than 14,000 attempts, and the Newton
    sweeps stay at or under 7 an attempt."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tiger_tpu_torch.models import Model200

    y0, p, f = scenario(8, 2.0, device=torch.device("cuda", 0), dtype=torch.float32)
    model = Model200()
    h0 = initial_step(model, y0, 0.0, p, f, CFG)
    before = k_radau.radau_launches["m200/embedded3"]
    res = k_radau.radau(model, y0, h0, 0.0, 2880.0, None, p, f, CFG)
    torch.cuda.synchronize()
    assert k_radau.radau_launches["m200/embedded3"] == before + 1
    assert not bool(res.failed.any())
    att = res.stats.n_attempts
    assert int(att.max()) <= 14_000
    assert int(res.stats.n_newton.sum()) / max(int(att.sum()), 1) <= 7.0


# --- The TPU kernels' last options: lockstep and bf16 forcing in B1 (runtime
# flags of every instance), factor reuse in B2 (each system its own vote).

B1_RUNTIME = {
    "lockstep": dict(dense_lockstep=True),
    "bf16": dict(forcing_dtype="bf16"),
    "lockstep_bf16": dict(dense_lockstep=True, forcing_dtype="bf16"),
    "lockstep_fsal_pi": dict(dense_lockstep=True, fsal=True, controller="pi"),
    "bf16_compensated": dict(forcing_dtype="bf16", compensated=True),
}
RUNTIME_MODELS = ["m204", "m200", "dummy"]


def _runtime_inputs(model_name, dtype):
    """(model, y0, params, forcings, span, queries) of a model on the card:
    Model 204's and Model 200's basins over 6 hours with a query every 20
    minutes (off the hourly forcing boundaries), DummyModel over 5 minutes
    with 200 queries."""
    if model_name == "m200":
        model, y0, p, f = _m200_inputs(512, dtype)
    elif model_name == "dummy":
        model, y0 = _dummy_inputs(512, dtype)
        qt = (torch.arange(1, 201, dtype=dtype, device=y0.device) * 5.0 / 201)
        return model, y0, None, None, 5.0, qt
    else:
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        model = Model204()
        y0, p, f = scenario(512, TF / 1440.0, 0.01, device="cuda", dtype=dtype)
    return model, y0, p, f, TF, torch.arange(0.0, TF + 1e-9, 20.0, dtype=dtype, device=y0.device)


@pytest.mark.parametrize("dtype", M200_DTYPES)
@pytest.mark.parametrize("model_name", RUNTIME_MODELS)
@pytest.mark.parametrize("name", sorted(B1_RUNTIME))
def test_rk45_runtime_option_equals_plain(name, model_name, dtype):
    """B1 with lockstep and/or bf16 forcing equals rk45_plain bit for bit,
    each model, float and double (bf16 reaches float32 only: a float64
    launch reads the float32 data, as rk45_plain does), one launch counted
    on the instance of the option set.  Each option acts: with the queries
    between the steps the cap moves the attempts against the same run
    without it, and bf16 moves a float32 run's states where there is
    forcing to round."""
    model, y0, p, f, span, qt = _runtime_inputs(model_name, dtype)
    cfg = dataclasses.replace(CFG, **B1_RUNTIME[name])
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    before = launch_totals()["rk45"]
    ker = k_rk45.rk45(model, y0, h0, 0.0, span, qt, p, f, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, span, qt, p, f, cfg)
    torch.cuda.synchronize()
    assert launch_totals()["rk45"] == before + 1
    _assert_rk45_equal(ker, ref)
    if cfg.dense_lockstep:
        free = k_rk45.rk45(model, y0, h0, 0.0, span, qt, p, f,
                           dataclasses.replace(cfg, dense_lockstep=False))
        assert not torch.equal(ker.stats.n_attempts, free.stats.n_attempts)
    if cfg.forcing_dtype == "bf16":
        f32 = k_rk45.rk45(model, y0, h0, 0.0, span, qt, p, f,
                          dataclasses.replace(cfg, forcing_dtype="f32"))
        if f is not None and dtype == torch.float32:
            assert not torch.equal(ker.y_final, f32.y_final)  # the rounding reached the rhs
        else:
            _assert_rk45_equal(ker, f32)


def test_bf16_copy_rounds_on_the_card_as_on_the_cpu():
    """The wrapper's bfloat16 copy of the forcing, made on the card, has the
    CPU's bits (each rounded to nearest even): 2^20 seeded values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(1 << 20).astype(np.float32) * 1e3)
    card = x.cuda().to(torch.bfloat16).view(torch.int16).cpu()
    assert torch.equal(card, x.to(torch.bfloat16).view(torch.int16))


REUSE_SETS = {"embedded3": {}, "radau5": dict(radau_error_mode="radau5"),
              "embedded3+predictor": dict(radau_predictor=True),
              "radau5_narrow_band": dict(radau_error_mode="radau5", radau_reuse_lo=0.8,
                                         radau_reuse_hi=1.25, radau_refresh_sweeps=3)}


@pytest.mark.parametrize("dtype", M200_DTYPES)
@pytest.mark.parametrize("name", sorted(REUSE_SETS))
def test_radau_factor_reuse_equals_plain(stiff_case, name, dtype):
    """B2 with factor reuse equals radau_plain bit for bit on the stiff
    systems over the first half hour, float and double, every counter
    included: fewer factorizations than attempts, and each system's own."""
    y0, p, f, qt = _first(stiff_case, 33)
    if dtype == torch.float64:
        y0, p, f, qt = _double(y0, p, f, qt)
    cfg = dataclasses.replace(CFG, radau_factor_reuse=True, **REUSE_SETS[name])
    h0 = initial_step(Model204(), y0, 0.0, p, f, cfg)
    ker = _radau_pair(Model204(), y0, h0, qt, p, f, cfg)
    assert 0 < int(ker.stats.n_fact.sum()) < int(ker.stats.n_attempts.sum())


@pytest.mark.parametrize("model_name", ["m200", "dummy"])
def test_radau_factor_reuse_other_models_equal_plain(model_name):
    """B2 with factor reuse on Model 200 (64 systems over 30 minutes) and
    DummyModel (64 over 5 minutes) equals radau_plain bit for bit."""
    if model_name == "m200":
        model, y0, p, f = _m200_inputs(64, torch.float32, SPAN)
        span, qt = SPAN, torch.arange(0.0, SPAN + 1e-9, 5.0, device=y0.device)
    else:
        (model, y0), p, f = _dummy_inputs(64, torch.float32), None, None
        span, qt = 5.0, torch.linspace(0.0, 5.0, 11, device=y0.device)
    cfg = dataclasses.replace(CFG, radau_factor_reuse=True)
    h0 = initial_step(model, y0, 0.0, p, f, cfg)
    ker = k_radau.radau(model, y0, h0, 0.0, span, qt, p, f, cfg)
    ref = k_radau.radau_plain(model, y0, h0, 0.0, span, qt, p, f, cfg)
    torch.cuda.synchronize()
    assert torch.equal(ker.failed, ref.failed)
    for a, b in zip(ker.stats, ref.stats):
        assert torch.equal(a, b)
    for a, b in ((ker.y_final, ref.y_final), (ker.dense, ref.dense)):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_solve_with_every_option_on_card(case):
    """solve() on the card with lockstep, bf16 forcing and factor reuse
    equals its chain through the plain versions bit for bit."""
    y0, _, _, p, f = case
    qt = torch.arange(0.0, TF + 1e-9, 20.0, device=y0.device)
    cfg = dataclasses.replace(CFG, dense_lockstep=True, forcing_dtype="bf16",
                              radau_factor_reuse=True)
    res = solve(Model204(), y0, 0.0, TF, qt, p, f, cfg)
    h0 = initial_step(Model204(), y0, 0.0, p, f, cfg)
    rk = k_rk45.rk45_plain(Model204(), y0, h0, 0.0, TF, qt, p, f, cfg)
    rows = torch.nonzero(rk.stiff).squeeze(1)
    rd = k_radau.radau_plain(Model204(), y0[rows], h0[rows], 0.0, TF, qt,
                             {k: v[rows] for k, v in p.items()}, f.take_systems(rows), cfg)
    assert res.n_stiff == rows.numel() > 0 and not rd.failed.any() and not res.failed.any()
    want_y, want_d = rk.y_final.clone(), rk.dense.clone()
    want_y[rows], want_d[rows] = rd.y_final, rd.dense
    assert torch.equal(res.y_final, want_y) and torch.equal(res.dense, want_d)


def _sync_case(request, name):
    """(initial state, [each window's solve() of a state]) of a case."""
    if name == "cell_f64_1h":
        # The benchmark's cell at its shape: 1,048,576 links of Model 204 in
        # float64 at the reference's settings, 0.1% stiff, in hot 1-hour
        # windows with one query each (two in window 0).
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        dev = torch.device("cuda", 0)
        y0, p, f = scenario(1 << 20, 1.0, 0.001, device=dev, dtype=torch.float64)
        cfg = SolverConfig(rtol=1e-6, atol=1e-9, safety=0.9, min_scale=0.2, max_scale=10.0)
        grid = torch.tensor([0.0, 60.0], dtype=torch.float64, device=dev)
        return y0, [lambda y, k=k: solve(Model204(), y, 0.0, 60.0, grid if k == 0 else grid[1:],
                                         p, f, cfg, t_shift=60.0 * k) for k in range(4)]
    # A float32 solve whose B2 fails systems, so that the retry in float64 runs
    # (as test_solve_f32_retries_radau_failures_in_f64).
    y0, p, f, qt = _first(request.getfixturevalue("stiff_case"), 33)
    cfg = dataclasses.replace(CFG, radau_error_mode="radau5", radau_predictor=True,
                              radau_max_rejects=2)
    return y0, [lambda y: solve(Model204(), y, 0.0, SPAN, qt, p, f, cfg)]


def _run_windows(y0, windows, around=contextlib.nullcontext):
    """Run the windows in turn, each from the last one's state, with
    ``around()`` entered around each solve(); the last state."""
    y = y0
    for solve_window in windows:
        with around():
            res = solve_window(y)
        y = torch.where(torch.isnan(res.y_final), y, res.y_final)
    return y


@pytest.mark.parametrize("name", ["cell_f64_1h", "retry_f32"])
def test_every_host_sync_in_solve_is_marked(request, tmp_path, name):
    """Over the same solve() calls, the trace's ``tiger.sync.*`` marks
    number the synchronizing calls that torch's sync debug mode reports:
    every host sync on the card's path is marked, and no mark is left
    where the sync has gone."""
    y0, windows = _sync_case(request, name)
    _run_windows(y0, windows)  # builds the kernels
    found = []

    @contextlib.contextmanager
    def sync_debug():
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                yield
                found.extend(w for w in seen if "synchronizing" in str(w.message))
        finally:
            torch.cuda.set_sync_debug_mode("default")

    y_debug = _run_windows(y0, windows, sync_debug)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        y_traced = _run_windows(y0, windows)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as fh:
        marks = [e["name"] for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "user_annotation" and e["name"].startswith("tiger.sync.")]
    assert torch.equal(y_debug, y_traced)
    assert "tiger.sync.handoff" in marks
    if name == "retry_f32":
        assert "tiger.sync.retry_failed" in marks
    assert len(found) == len(marks), sorted(marks)
