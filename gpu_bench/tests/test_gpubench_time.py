"""A model whose right-hand side reads time: the window's start and the
start date reach the reference as they reach the program, a model blind to
time reads the same numbers whatever the start, and the work counts follow
the model's operations per right-hand side."""

import copy
import types

import _bench_path  # noqa: F401
import numpy as np
import pytest
from _tiny import tiny_cell

import run
from harness import inputs, reference, spec, work
from harness.stream import CheckPlan

SEED = 2_718_281_828
STANDING = "m204f64_1m_stiff_1h"


def load_model(name):
    return spec.load_module(spec.BENCH_DIR / "models" / f"{name}.py", f"time_t_{name}")


# dy/dt = a cos(2 pi t / P) + rain, rain held over each window.
A, PERIOD = 2e-3, 1440.0
WAVE = types.SimpleNamespace(
    N_EQ=1,
    derived=lambda p, doy0=None: dict(p),
    rhs=lambda t, y, q, rain: np.stack([q["a"] * np.cos(2 * np.pi * t / PERIOD) + rain]),
)


def wave_exact(y0, rain, t_from, t):
    return y0 + A * PERIOD / (2 * np.pi) * (np.sin(2 * np.pi * t / PERIOD)
                                            - np.sin(2 * np.pi * t_from / PERIOD)) \
        + rain * (t - t_from)


@pytest.mark.parametrize("shifted", [True, False])
def test_reference_reads_the_window_start(shifted):
    """Consecutive 7-hour windows with t0 = k x length follow the closed form
    to 1e-8; with t0 = 0 in every window they do not."""
    rng = np.random.default_rng(1)
    n, length = 3, 420.0
    queries = np.arange(60.0, length + 1e-9, 60.0)
    y = np.full((n, 1), 0.5)
    exact = y[:, 0].copy()
    worst = 0.0
    for k in range(5):
        rain = rng.uniform(0.0, 1e-3, (1, n))
        t0 = k * length if shifted else 0.0
        dense, final, _ = reference.integrate(WAVE, y, {"a": np.full(n, A)}, [rain], [length],
                                              length, queries, t0=t0)
        want = np.stack([wave_exact(exact, rain[0], k * length, k * length + q)
                         for q in queries], axis=1)
        worst = max(worst, float(np.max(np.abs(dense[:, :, 0] - want) / np.abs(want))))
        exact, y = want[:, -1], final
    assert (worst < 1e-8) == shifted, worst


def test_model204_is_blind_to_time():
    model = load_model("model204")
    assert not model.READS_TIME and model.RHS_OPS == 32
    rng = np.random.default_rng(0)
    n = 6
    base = spec.load_json(spec.BENCH_DIR / "traffic" / "win1h_1m_stiff.json")["params"]["base"]
    params = {k: base[k] * rng.uniform(0.8, 1.2, n) for k in model.PARAM_FIELDS}
    rain = rng.uniform(0, 0.0015, (3, n))
    temp = rng.uniform(-2, 10, (1, n))
    y0 = np.tile(np.asarray(model.Y_COLD), (n, 1))
    args = (model, y0, params, [rain, temp], [60.0, 1440.0], 180.0, np.arange(0.0, 181.0, 60.0))
    at_zero = reference.integrate(*args)
    later = reference.integrate(*args, t0=1e5, doy0=200.0)
    for a, b in zip(at_zero, later):
        assert np.array_equal(a, b)


def test_work_counts_of_the_standing_cell_stand():
    r = load_model("model204").RHS_OPS
    assert (work.b1_step(r), work.B1_QUERY, work.b2_attempt(r), work.b2_sweep(r),
            work.B2_QUERY) == (578, 141, 837, 550, 58)
    assert (work.b1_step(72), work.b2_attempt(72), work.b2_sweep(72)) == (818, 1117, 670)
    cell = spec.resolve(STANDING)
    tr = cell.traffic
    got = work.window_work(cell.data["work"], cell.model.RHS_OPS, int(tr["links"]),
                           round(tr["window_minutes"] / tr["query_minutes"]),
                           sum(inputs.forcing_layout(tr)[1]), 8)
    # The values of the counts frozen before the model stated its own.
    assert got == {"b1_ops": 8900205043.0783, "b2_ops": 6212202.398404109,
                   "b1_bytes": 283115520, "b2_bytes": 2087.559}


#: The static and surface stores, which ET moves, in units of the tolerance:
#: the sound run below reads under 1, the reference on the wrong date over 50.
ET_LIMIT = 10.0


def m200_cell(doy0=172.0):
    """A tiny cell of the program's Model 200 in float64 at the standing
    cell's settings, held to the standing cell's limits on plain and planted
    rows and to ``ET_LIMIT`` on their static and surface stores.  (Model
    200's planted rows do not reach B2, so no ``b2`` number is read; and the
    date moves only the stores ET moves, which the standing limits leave
    out.)"""
    cell = tiny_cell(STANDING)
    config = copy.deepcopy(cell.config)
    config.update(model="model200", program_model=200, doy0=doy0)
    cell.config = config
    limits = {k: v for k, v in cell.data["limits"].items() if not k.startswith("b2_")}
    limits.update({f"{kind}_{store}_err": ET_LIMIT for kind in ("plain", "planted")
                   for store in ("static", "surface")})
    cell.data["limits"] = limits
    return cell


def test_program_model200_is_correct_on_its_date(monkeypatch):
    """The program's Model 200 in float64 from day 172 against the NumPy
    Model 200; the reference told the run starts on day 1 finds it wrong."""
    cell = m200_cell()
    result, info = run.run_cell(cell, SEED, 0.5, False, device="cpu")
    assert result["correct"], info["numbers"]
    integrate = reference.integrate

    def on_day_one(*args, **kw):
        return integrate(*args, **{**kw, "doy0": 1.0})

    monkeypatch.setattr(reference, "integrate", on_day_one)
    result, info = run.run_cell(cell, SEED, 0.5, False, device="cpu")
    assert not result["correct"], info["numbers"]


def test_polar_day_and_night():
    """At 80 degrees the sun stays up at midsummer and down at midwinter; the
    program's Hamon PET agrees there and at the cells' latitudes."""
    import torch

    from tiger_tpu_torch.models import et

    model = load_model("model200")
    lat = np.array([80.0, 80.0, -80.0, -80.0, 41.5, 33.2, 49.8])
    doy = np.array([172.0, 355.0, 172.0, 355.0, 1.0, 100.0, 250.0])
    temp = np.full(lat.shape, 8.0)
    q = model.derived({k: lat if k == "lat" else np.ones(lat.shape) for k in model.PARAM_FIELDS},
                      doy0=0.0)
    pet = model.hamon_pet(temp, q["sin_lat"], q["cos_lat"], doy)
    assert pet[1] == pet[2] == 0.0 and pet[0] == pet[3] > pet[4:].max() > 0.0
    theirs = et.hamon_pet(*(torch.tensor(x) for x in (temp, lat, doy))).numpy()
    assert np.allclose(pet, theirs, rtol=1e-12, atol=0.0)


def test_a_time_reading_model_needs_its_start_date(tmp_path):
    config = spec.load_json(spec.ROOT / "gpu_bench" / "configs" / "m204_ref_f64.json")
    config.update(model="model200", program_model=200)
    bench = {"configs": [{"name": "m200_t", "file": str(tmp_path / "m200_t.json")}],
             "workloads": [{"name": "m200_t_cell", "config": "m200_t",
                            "traffic": "win1h_131k_stiff", "chips": 1}],
             "end_to_end": [], "per_layer": []}
    (tmp_path / "m200_t.json").write_text(spec.json.dumps(config))
    with pytest.raises(ValueError, match="'doy0'"):
        spec.resolve("m200_t_cell", bench)
    config["doy0"] = 172
    (tmp_path / "m200_t.json").write_text(spec.json.dumps(config))
    assert spec.resolve("m200_t_cell", bench).doy0 == 172.0
    assert spec.resolve(STANDING).doy0 is None


def test_check_gives_the_reference_each_window_start(monkeypatch):
    """The reference integrates each checked window from the start the
    program was given as its ``t_shift``."""
    import tiger_tpu_torch

    shifts, starts = [], []
    integrate = reference.integrate

    def solve(*args, t_shift=0.0, **kw):
        shifts.append(t_shift)
        return tiger_tpu_torch.solve(*args, t_shift=t_shift, **kw)

    def recorded(*args, **kw):
        starts.append(kw["t0"])
        return integrate(*args, **kw)

    monkeypatch.setattr(reference, "integrate", recorded)
    cell = tiny_cell(STANDING)
    cell.traffic["check"].update(first_windows=1, sampled_windows=2)
    _, info = run.run_cell(cell, SEED, 1.0, False, device="cpu", solve=solve)
    plan = CheckPlan(cell.traffic["check"], SEED)
    kept = set()
    for k in range(len(shifts)):
        keep, dropped = plan.admit(k)
        kept = (kept - {dropped}) | ({k} if keep else set())
    assert len(shifts) == info["windows"] + 1 and len(kept) == 3
    assert starts == [shifts[k] for k in sorted(kept)] and max(starts) > 0
