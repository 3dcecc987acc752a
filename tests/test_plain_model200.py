"""The port's Model 200 against the plain torch reference ``plain/model200.py``, on the CPU.

The reference is loaded by its path; this file imports neither JAX nor the
JAX package.  The rows are seeded draws around ``scenario.py``'s base
parameters (each within +-20%), at latitudes 25-49 N, with temperatures on
both sides of 0 degC, as the benchmark's cell ``m200f64_1m_stiff_1h`` draws
them.

Gaps in a solve are in units of the tolerance the configuration states,
|program - reference| / (atol + rtol |reference|), the unit of the cell's
check (``gpu_bench/harness/check.py``).
"""

import ast
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tiger_tpu_torch import ForcingMeta, ForcingSet, Model200, SolverConfig, get_model, solve
from tiger_tpu_torch.models.et import hamon_pet
from tiger_tpu_torch.scenario import scenario_arrays

ROOT = Path(__file__).resolve().parents[1]
PLAIN_PATH = ROOT / "plain" / "model200.py"
CELL = ROOT / "gpu_bench" / "cells" / "m200f64_1m_stiff_1h.json"


def _load_plain():
    spec = importlib.util.spec_from_file_location("plain_model200", PLAIN_PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


plain = _load_plain()

RTOL, ATOL = 1e-6, 1e-9  # the reference's solver settings (main.cpp:633-640)
LINKS = 256
WINDOW = 60.0
QUERIES = [20.0, 40.0, 60.0]
# Snow, gravitational and aquifer stores: 0.3 tolerance units, the cell's
# limit.  Their right-hand sides have no kink inside a window, so the
# program's error is its own local error, far below one unit (the cell reads
# <= 1.8e-8 on the card, PERF.md); the float32 path reads several units.
SMOOTH_LIMIT = 0.3
SMOOTH = (0, 3, 4)
STATIC = 1
# Static: the cell's own limit, the store ET moves.  The surface store is
# compared nowhere, as in the cell: x2 = max(0, x1 + static - Hu) switches
# it on and off inside a step, and the error across that kink is not the
# integrator's tolerance (PERF.md section 2).
STATIC_LIMIT = json.loads(CELL.read_text())["limits"]["plain_static_err"]


def draw_rows(seed: int, n: int) -> dict:
    """Raw parameters (float64 [n]) within +-20% of scenario.py's base, at
    latitudes 25-49 N."""
    params, _, _ = scenario_arrays(n)
    rng = np.random.default_rng(seed)
    params = {k: rng.permutation(v) for k, v in params.items()}
    params["lat"] = rng.uniform(25.0, 49.0, n)
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}


# ---- (a) one evaluation of the right-hand side ---------------------------


def rhs_inputs(seed: int, n: int = 3000):
    """Parameters, states, forcing, times and doy0 for one evaluation: the
    static store's fill below sw, between sw and ss, above ss and above Hu
    (a third of the rows in each band, the last with overflow)."""
    p = draw_rows(seed, n)
    rng = np.random.default_rng(seed + 1)
    band = rng.integers(0, 3, n)
    sw, ss, hu = p["sw"].numpy(), p["ss"].numpy(), p["Hu"].numpy()
    fill = np.where(band == 0, rng.uniform(0.0, 1.0, n) * sw,
                    np.where(band == 1, sw + rng.uniform(0.0, 1.0, n) * (ss - sw),
                             ss + rng.uniform(0.0, 1.0, n) * (1.3 - ss)))
    y = np.stack([rng.uniform(0.0, 0.05, n), fill * hu, rng.uniform(0.0, 0.02, n),
                  rng.uniform(0.0, 6.0, n), rng.uniform(0.0, 0.5, n)], axis=1)
    rain = rng.uniform(0.0, 0.0015, n)
    temp = rng.uniform(-5.0, 15.0, n)
    t = rng.uniform(0.0, 3.0 * 1440.0, n)
    as64 = functools.partial(torch.tensor, dtype=torch.float64)
    return p, as64(y), as64(rain), as64(temp), as64(t)


def close(port, ref, rtol=1e-12, atol=1e-20):
    """The port within 1e-12 relative and 1e-20 absolute of the reference:
    both are float64 torch on the CPU, the same libm, and differ only where
    their operations are ordered or rounded apart (the port multiplies by
    1/1440 and pi/180, the reference divides), a few ulps; 1e-20 m/min is
    below any PET that moves a store and covers values near zero."""
    gap = (port - ref).abs() - (atol + rtol * ref.abs())
    assert float(gap.max()) <= 0.0, float(gap.max())


@pytest.mark.parametrize("doy0", [1.0, 80.0, 172.0])
@pytest.mark.parametrize("seed", [3, 17])
def test_hamon_pet_matches_plain(seed, doy0):
    p, _, _, temp, t = rhs_inputs(seed)
    doy = doy0 + t / 1440.0
    ref = plain.hamon_pet(temp, p["lat"], doy)
    assert float((ref > 0).double().mean()) > 0.5  # most rows above 0 degC
    close(hamon_pet(temp, p["lat"], doy), ref)


@pytest.mark.parametrize("derived", [False, True], ids=["raw", "derived"])
@pytest.mark.parametrize("doy0", [1.0, 80.0])
@pytest.mark.parametrize("seed", [3, 17])
def test_rhs_matches_plain(seed, doy0, derived):
    """``Model200.rhs_tuple`` on raw parameters (as the initial step calls
    it) and on ``derived_params`` (as the kernels' twin reads them)."""
    p, y, rain, temp, t = rhs_inputs(seed)
    model = Model200(doy0=doy0)
    params = model.derived_params(p) if derived else p
    port = torch.stack(model.rhs_tuple(t, list(y.unbind(1)), params, (rain, temp)), dim=1)
    ref = plain.rhs(t, y, p, rain, temp, doy0)
    close(port, ref)
    # Every branch of the ramp and of the overflow is taken.
    fill = y[:, 1] / p["Hu"]
    assert bool((fill < p["sw"]).any() and ((fill > p["sw"]) & (fill < p["ss"])).any()
                and (fill > 1.0).any())


# ---- (b) solve() against the plain integrator -----------------------------


def window_forcing(k: int, links: int, seed: int = 5):
    """Window k's forcing, float32 as the program holds it: the hour's rain
    (uniform in [0, 0.0015] m/min) and the day's temperature (uniform in
    [-2, 10] degC), each drawn by its place in the stream."""
    hour = np.random.default_rng([seed, 0, k]).uniform(0.0, 0.0015, (1, links))
    day = np.random.default_rng([seed, 1, k // 24]).uniform(-2.0, 10.0, (1, links))
    return [torch.tensor(hour, dtype=torch.float32), torch.tensor(day, dtype=torch.float32)]


FORCING_DT = (60.0, 1440.0)


def run_program(doy0: float, starts, dtype=torch.float64, shift=True):
    """The port's ``solve()`` over the windows starting at ``starts``
    (minutes), each hot-started from the last, from the cold state: the
    dense rows of each window and its final state."""
    model = get_model(200, doy0=doy0)
    params = {k: v.to(dtype) for k, v in draw_rows(11, LINKS).items()}
    y = torch.tensor(plain.Y_COLD, dtype=dtype).repeat(LINKS, 1)
    cfg = SolverConfig(rtol=RTOL, atol=ATOL)
    qt = torch.tensor(QUERIES, dtype=dtype)
    out = []
    for start in starts:
        f = window_forcing(int(start // WINDOW), LINKS)
        forcing = ForcingSet(data=torch.cat(f), meta=ForcingMeta((0, 1), (1, 1), FORCING_DT))
        res = solve(model, y, 0.0, WINDOW, qt, params, forcing, cfg,
                    t_shift=float(start) if shift else 0.0)
        assert not bool(res.failed.any())
        y = torch.where(torch.isnan(res.y_final), y, res.y_final)
        out.append((res.dense.double(), y.double()))
    return out


@functools.lru_cache(maxsize=None)
def run_plain(doy0: float, starts: tuple):
    """The reference over the same windows and inputs."""
    params = draw_rows(11, LINKS)
    y = torch.tensor(plain.Y_COLD, dtype=torch.float64).repeat(LINKS, 1)
    out = []
    for start in starts:
        f = window_forcing(int(start // WINDOW), LINKS)
        dense, y = plain.integrate(y, params, f, FORCING_DT, WINDOW, QUERIES,
                                   t_shift=float(start), doy0=doy0)
        out.append((dense, y))
    return out


def widest_gaps(program, reference) -> np.ndarray:
    """The widest gap of each state over every row, query and window."""
    worst = torch.zeros(plain.N_EQ, dtype=torch.float64)
    for (p_dense, p_final), (r_dense, r_final) in zip(program, reference):
        for got, ref in ((p_dense, r_dense), (p_final[:, None], r_final[:, None])):
            gap = (got - ref).abs() / (ATOL + RTOL * ref.abs())
            gap = torch.where(torch.isnan(gap), torch.inf, gap)
            worst = torch.maximum(worst, gap.amax(dim=(0, 1)))
    return worst.numpy()


def within(gaps) -> bool:
    return bool(gaps[list(SMOOTH)].max() <= SMOOTH_LIMIT and gaps[STATIC] <= STATIC_LIMIT)


HOT = (0.0, 60.0, 120.0)


@pytest.mark.parametrize("doy0", [1.0, 80.0])
def test_solve_matches_plain(doy0):
    """Three hot-started hours from the cold state, at January 1 and at day
    80, near the equinox, where the day length moves fastest."""
    gaps = widest_gaps(run_program(doy0, HOT), run_plain(doy0, HOT))
    assert gaps[list(SMOOTH)].max() <= SMOOTH_LIMIT, gaps
    assert gaps[STATIC] <= STATIC_LIMIT, gaps


# ---- (c) negative controls: each falls outside (b)'s bounds --------------


def test_float32_path_fails():
    gaps = widest_gaps(run_program(80.0, HOT, dtype=torch.float32), run_plain(80.0, HOT))
    assert not within(gaps), gaps


def test_wrong_start_date_fails():
    """The program on day 172 held to the reference on day 80."""
    gaps = widest_gaps(run_program(172.0, HOT), run_plain(80.0, HOT))
    assert not within(gaps), gaps


def test_dropped_time_shift_fails():
    """At doy0 80, a window 30 days in: with its t_shift it holds, without
    it the program reads day 80 where the reference reads day 110."""
    day30 = (30 * 1440.0,)
    reference = run_plain(80.0, day30)
    assert within(widest_gaps(run_program(80.0, day30), reference))
    gaps = widest_gaps(run_program(80.0, day30, shift=False), reference)
    assert not within(gaps), gaps


# ---- (d) the reference stands alone ----------------------------------------


def test_plain_reference_imports_torch_and_math_only():
    """Read from the file's syntax tree, not from ``sys.modules``, which
    other tests in the same worker fill."""
    tree = ast.parse(PLAIN_PATH.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if node.level == 0 else ".")
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            names.add("__import__")
    assert names == {"torch", "math"}
