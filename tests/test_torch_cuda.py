"""The CUDA kernels against their plain versions on the card.

Runs only where torch sees a CUDA device (``python -m pytest -m gpu
tests/test_torch_cuda.py`` on a machine with an H100); elsewhere each test
skips.  The kernels are built with nvcc from ``tiger_tpu_torch/kernels/csrc``
at first use.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tiger_tpu_torch import Model204, SolverConfig, solve
from tiger_tpu_torch.kernels import _build
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
    before = k_rk45.rk45_launches
    ker = k_rk45.rk45(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    ref = k_rk45.rk45_plain(model, y0, h0, 0.0, TF, qt, p, f, cfg)
    torch.cuda.synchronize()
    assert k_rk45.rk45_launches == before + 1
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
    """No atomics and no traffic between blocks: the schedule, and so every
    byte of the result, repeats from launch to launch."""
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
    before = k_radau.radau_launches
    ker = k_radau.radau(model, *sub, 0.0, TF, qt, sp, sf, cfg)
    ref = k_radau.radau_plain(model, *sub, 0.0, TF, qt, sp, sf, cfg)
    torch.cuda.synchronize()
    assert k_radau.radau_launches == before + 1
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
    before = k_radau.radau_launches
    ker = k_radau.radau(model, y0, h0, 0.0, SPAN, qt, p, f, cfg)
    ref = k_radau.radau_plain(model, y0, h0, 0.0, SPAN, qt, p, f, cfg)
    torch.cuda.synchronize()
    assert k_radau.radau_launches == before + 1
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
    with pytest.raises(TypeError, match="float32"):
        k_rk45.rk45(Model204(), y0.double(), h0.double(), 0.0, TF, qt, p, f, CFG)
    with pytest.raises(ValueError, match="contiguous"):
        k_rk45.rk45(Model204(), y0, h0, 0.0, TF, qt[::2], p, f, CFG)
    with pytest.raises(ValueError, match="on cpu"):
        k_radau.radau(Model204(), y0, h0.cpu(), 0.0, TF, qt, p, f, CFG)
    with pytest.raises(ValueError, match="atol >= 0"):
        k_radau.radau(Model204(), y0, h0, 0.0, TF, qt, p, f, dataclasses.replace(CFG, atol=-1e-8))
