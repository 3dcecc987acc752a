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
    assert torch.equal(ker.stiff, ref.stiff) and torch.equal(ker.failed, ref.failed)
    assert torch.equal(ker.stats.n_attempts, ref.stats.n_attempts)
    ok = ~ker.stiff
    assert _close(ker.y_final[ok], ref.y_final[ok]) and _close(ker.dense[ok], ref.dense[ok])


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
