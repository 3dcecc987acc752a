"""The generator: the same seed gives the same inputs, another seed others."""

import _bench_path  # noqa: F401
import pytest
import torch

from harness import inputs, spec

FIELDS = spec.load_module(spec.BENCH_DIR / "models" / "model204.py", "m204_ref").PARAM_FIELDS


def traffic(name="win2d_131k_stiff", **over):
    tr = spec.load_json(spec.BENCH_DIR / "traffic" / f"{name}.json")
    tr.update(links=96, stiff_share=1 / 32, **over)
    return tr


def draw(tr, seed, dtype=torch.float32):
    return inputs.Inputs(tr, FIELDS, seed, "cpu", dtype)


def test_same_seed_same_inputs():
    a, b = draw(traffic(), 2**31 + 5), draw(traffic(), 2**31 + 5)
    for k in FIELDS:
        assert torch.equal(a.params[k], b.params[k])
    for w in (0, 1, 7):
        assert torch.equal(a.forcing(w), b.forcing(w))


def test_window_forcing_does_not_depend_on_order():
    a, b = draw(traffic("win2d_131k_stiff"), 17), draw(traffic("win2d_131k_stiff"), 17)
    later = a.forcing(3)
    b.forcing(0), b.forcing(1)
    assert torch.equal(later, b.forcing(3))


def test_other_seed_other_weather_same_basin():
    a, b = draw(traffic(), 1), draw(traffic(), 2)
    for k in FIELDS:
        assert torch.equal(a.params[k], b.params[k])
    other = traffic()
    other["params"]["basin_seed"] = 2
    assert not torch.equal(a.params["slope"], draw(other, 1).params["slope"])
    assert not torch.equal(a.forcing(0), b.forcing(0))
    assert not torch.equal(a.forcing(0), a.forcing(1))


def test_distributions_and_planted_rows():
    tr = traffic("win2d_131k_stiff")
    x = draw(tr, 99, torch.float64)
    stiff = x.stiff
    assert stiff.tolist() == torch.linspace(0, 95, 3).long().tolist()
    hu = x.params["Hu"]
    assert torch.all(hu[stiff] == 1e-6)
    others = torch.ones(96, dtype=torch.bool)
    others[stiff] = False
    assert torch.all((hu[others] >= 0.4) & (hu[others] <= 0.6))
    f = x.forcing(2)
    assert f.shape == (48 + 2, 96) and f.dtype == torch.float32
    rain, temp = f[:48], f[48:]
    assert torch.all((rain >= 0) & (rain <= 0.0015))
    assert torch.all((temp >= -2) & (temp <= 10))
    assert torch.all(temp[:, stiff] >= 2)
    assert not torch.equal(rain[0], rain[1])


def test_forcing_changes_from_sample_to_sample():
    f = draw(traffic(), 5).forcing(4)
    rain, temp = f[:48], f[48:]
    assert all(not torch.equal(rain[i], rain[i + 1]) for i in range(47))
    assert not torch.equal(temp[0], temp[1])


def test_large_seeds():
    assert inputs.stream_seed(2**33 + 1, "window", 3) < 2**63
    assert inputs.stream_seed(2**33 + 1, "window", 3) != inputs.stream_seed(2**33 + 2, "window", 3)


def test_hourly_windows_hold_the_day_s_temperature():
    x = draw(traffic("win1h_131k_stiff"), 23)
    assert x.samples == (1, 1) and x.dt == (60.0, 1440.0)
    blocks = [x.forcing(k) for k in range(26)]
    rain = torch.stack([f[0] for f in blocks])
    temp = torch.stack([f[1] for f in blocks])
    assert all(not torch.equal(rain[k], rain[k + 1]) for k in range(25))
    assert all(torch.equal(temp[k], temp[0]) for k in range(24))
    assert not torch.equal(temp[24], temp[23]) and torch.equal(temp[25], temp[24])


def test_windows_and_samples_may_not_straddle():
    with pytest.raises(ValueError):
        inputs.forcing_layout(traffic("win1h_131k_stiff", window_minutes=90))
