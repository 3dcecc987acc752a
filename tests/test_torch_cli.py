"""The port's CLI run against the JAX package's, on the CPU.

``tiger_tpu.run.run(cfg, use_mesh=False)`` and
``tiger_tpu_torch.run.run(cfg, device="cpu")`` run the same config over
``tests/test_cli.py::make_scenario``'s basin (6 links, 2 days, routed
discharge), and their final, dense, discharge and state files are compared.

Tolerances, per element, |ours - ref| <= RTOL * |ref| + ATOL:
  - f64 at rtol 1e-6: RTOL 1e-9, ATOL 1e-12.  The float64 plain RK45 takes
    the same attempts as the JAX package's vmap RK45, so the two differ by
    rounding only; ATOL covers states that pass near zero.
  - f32 at rtol 1e-5: RTOL 5e-4, the port's float32 parity bound, and
    ATOL 5e-4 of each state's largest magnitude in the run.  torch's and
    XLA's float32 arithmetic differ by an ulp here and there, so the two
    take other step sequences; h_snow's melt kink near an empty store turns
    that into an absolute error of ~1.2e-5 of the state's range.
"""

import datetime as dt
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from test_cli import make_scenario
from tiger_tpu.config import load_config as j_load_config
from tiger_tpu.run import run as j_run
from tiger_tpu_torch.config import config_from_dict, load_config
from tiger_tpu_torch.run import run

TOL = {"f64": (1e-9, 1e-12), "f32": (5e-4, 5e-4)}
# The JAX summary's keys the port's leaves out: its attempted steps a second
# read faster the more steps were rejected.
NOT_PORTED = {"system_steps_per_s"}
OUTPUTS = (("final", "outputs"), ("dense", "outputs"), ("discharge", "discharge"),
           ("state", "outputs"))


@pytest.fixture
def scenario(tmp_path):
    return make_scenario(tmp_path)


def _configs(scenario, out, **changes):
    """The JAX and the port's config of the scenario, each writing into its
    own directory under ``out``."""
    cfgs = []
    for loader, name in ((j_load_config, "jax"), (load_config, "torch")):
        cfg = loader(str(scenario["cfg_path"]))
        cfg.output.path = str(out / name)
        for key, value in changes.items():
            section, field = key.split("__")
            setattr(getattr(cfg, section), field, value)
        cfgs.append(cfg)
    return cfgs


def _read(path, var="outputs"):
    with h5py.File(path) as f:
        return np.asarray(f[var]), np.asarray(f["system"]), dict(f.attrs)


def _assert_close(ours, ref, precision):
    rtol, atol = TOL[precision]
    if precision == "f32":  # ATOL relative to each state's largest magnitude
        atol = atol * np.abs(ref).max(axis=tuple(range(ref.ndim - 1)))
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    np.testing.assert_array_less(np.abs(ours - ref), rtol * np.abs(ref) + atol + 1e-300)


@pytest.mark.parametrize("precision", ["f64", "f32", "default"])
def test_run_matches_jax(scenario, tmp_path, precision):
    """Both packages' runs of the scenario, held to the bound of the
    precision.  'default' leaves solver.precision out of the config, as
    the scenario's YAML does: both packages run it in float64."""
    changes = {} if precision == "default" else {"solver__precision": precision}
    if precision == "f32":
        changes.update(solver__rtol=1e-5, solver__atol=1e-8)
    jcfg, cfg = _configs(scenario, tmp_path, **changes)
    if precision == "default":
        assert jcfg.solver.precision == cfg.solver.precision == "f64"
        precision = "f64"
    ref, ours = j_run(jcfg, use_mesh=False), run(cfg, device="cpu")
    assert set(ours) == set(ref) - NOT_PORTED
    for key in ("num_systems", "n_stiff", "n_failed"):
        assert ours[key] == ref[key], key
    assert set(ours["phases_s"]) == set(ref["phases_s"])
    for name, var in OUTPUTS:
        a, ids_a, attrs_a = _read(tmp_path / "torch" / f"{name}_basin_rank_0.nc", var)
        b, ids_b, attrs_b = _read(tmp_path / "jax" / f"{name}_basin_rank_0.nc", var)
        assert np.array_equal(ids_a, ids_b) and attrs_a == attrs_b, name
        _assert_close(a, b, precision)


def test_cli_module_prints_the_jax_summary_keys(scenario, tmp_path):
    jcfg, _ = _configs(scenario, tmp_path)
    ref = j_run(jcfg, use_mesh=False)
    proc = subprocess.run(
        [sys.executable, "-m", "tiger_tpu_torch.run", "--config", str(scenario["cfg_path"]),
         "--cpu"],
        capture_output=True, text=True, timeout=600,
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": str(tmp_path),
             "PYTHONPATH": os.getcwd()},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(summary) == set(ref) - NOT_PORTED
    assert summary["n_failed"] == 0 and summary["num_systems"] == scenario["n_sys"]
    out = scenario["tmp_path"] / "out"
    for name in ("final", "dense", "discharge", "state"):
        assert (out / f"{name}_basin_rank_0.nc").exists(), name


def test_trace_writes_a_chrome_trace(tmp_path):
    """--profile-dir: torch.profiler over the block, as a Chrome trace."""
    import torch

    from tiger_tpu_torch.profiling import trace

    with trace(str(tmp_path / "trace")):
        torch.ones(8).cumsum(0)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    with trace(None):  # no directory: no profiler
        pass


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hot_restart_across_packages(scenario, tmp_path, writer):
    """Day 1 by one package, then a hot start of day 1's state by the
    other: the t=0 dense row of the second run is day 1's final state."""
    day = dict(time__end=dt.datetime(2019, 1, 2))
    jcfg, cfg = _configs(scenario, tmp_path / "a", **day)
    first = (j_run(jcfg, use_mesh=False) if writer == "jax" else run(cfg, device="cpu"))
    jcfg, cfg = _configs(scenario, tmp_path / "b", initial__mode="hot",
                         initial__file=first["state_path"], **day)
    second = (run(cfg, device="cpu") if writer == "jax" else j_run(jcfg, use_mesh=False))
    state, _, attrs = _read(first["state_path"])
    assert attrs["sim_time_minutes"] == 1440.0
    dense, _, _ = _read(second["dense_path"])
    np.testing.assert_array_equal(dense[:, 0, :], state)
    assert first["num_systems"] == second["num_systems"] == scenario["n_sys"]


def test_hot_restart_equivalence(scenario, tmp_path):
    """tests/test_cli.py's case on the port: a hot start from day 1's
    checkpoint restores its state at t=0."""
    full = load_config(str(scenario["cfg_path"]))
    full.output.path = str(tmp_path / "full")
    full_res = run(full, device="cpu")
    a = load_config(str(scenario["cfg_path"]))
    a.time.end = a.time.start + dt.timedelta(days=1)
    a.output.path = str(tmp_path / "a")
    a_res = run(a, device="cpu")
    b = load_config(str(scenario["cfg_path"]))
    b.initial.mode, b.initial.file = "hot", a_res["state_path"]
    b.time.end = b.time.start + dt.timedelta(days=1)
    b.output.path = str(tmp_path / "b")
    b_res = run(b, device="cpu")
    day1, _, attrs = _read(a_res["state_path"])
    assert attrs["sim_time_minutes"] == 1440.0
    dense, _, _ = _read(b_res["dense_path"])
    np.testing.assert_allclose(dense[:, 0, :], day1)
    assert full_res["num_systems"] == a_res["num_systems"] == b_res["num_systems"]


def test_i16_packed_output(scenario, tmp_path):
    """tests/test_cli.py's case on the port: the CF-packed per-state vars
    decode to the unpacked run's dense output within quantization error."""
    ref_cfg = load_config(str(scenario["cfg_path"]))
    ref_cfg.output.path, ref_cfg.output.routed_discharge = str(tmp_path / "ref"), False
    ref = run(ref_cfg, device="cpu")
    cfg = load_config(str(scenario["cfg_path"]))
    cfg.output.path, cfg.output.routed_discharge = str(tmp_path / "packed"), False
    cfg.output.precision = "i16"
    packed = run(cfg, device="cpu")
    dense, _, _ = _read(ref["dense_path"])
    with h5py.File(packed["dense_path"]) as f:
        assert "outputs" not in f
        for v in range(dense.shape[2]):
            ds = f[f"outputs_{v}"]
            dec = np.where(
                ds[...] == int(ds.attrs["_FillValue"]),
                np.nan,
                ds[...] * float(ds.attrs["scale_factor"]) + float(ds.attrs["add_offset"]),
            )
            ref_v = dense[:, :, v]
            span = max(float(ref_v.max() - ref_v.min()), 1e-30)
            np.testing.assert_allclose(dec, ref_v, atol=span / 65532 * 0.51 + 1e-12, rtol=0)
        np.testing.assert_array_equal(np.asarray(f["system"]), scenario["streams"])


def test_states_subset_and_csv_format(scenario, tmp_path):
    """output.states selects columns; output.format csv writes the legacy
    CSVs, with the same bytes as the JAX run's in float64."""
    jcfg, cfg = _configs(scenario, tmp_path, output__format="csv", output__states=[0, 3],
                         output__routed_discharge=False)
    ref, ours = j_run(jcfg, use_mesh=False), run(cfg, device="cpu")
    for key in ("final_path", "dense_path"):
        a = np.loadtxt(ours[key], delimiter=",", skiprows=1, ndmin=2)
        b = np.loadtxt(ref[key], delimiter=",", skiprows=1, ndmin=2)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)  # 6 and 9 printed digits
    assert a.shape == (49, 1 + 2 * scenario["n_sys"])


# The solver options the port runs (they were refused before it had them):
# compensated float32 at the reference's tolerances, and the PI controller.
SOLVER_OPTIONS = {
    "f32c": dict(solver__precision="f32c", solver__rtol=1e-6, solver__atol=1e-9),
    "pi_controller": dict(solver__precision="f32", solver__controller="pi",
                          solver__rtol=1e-5, solver__atol=1e-8),
}


@pytest.mark.parametrize("case", sorted(SOLVER_OPTIONS))
def test_solver_option_run_matches_jax(scenario, tmp_path, case):
    """solver.precision f32c and solver.controller pi through both packages'
    runs on the CPU: the same stiff and failed counts, and the final and
    dense files within the f32 bound above.  Except the dense row at the
    inner day boundary (t = 1440): the daily temperature jumps there, and
    the row is the interpolant of a step that read the old day's sample or,
    landing a snap (0.72 min) short of it, the new day's, as the step
    sequence falls (measured 0.5515 and 0.4784 in h_static, both packages
    taking either), so it is one of two values and not held."""
    jcfg, cfg = _configs(scenario, tmp_path, **SOLVER_OPTIONS[case])
    solver = cfg.solver_config()
    assert solver.compensated == (case == "f32c") and solver.controller == ("pi" if case == "pi_controller" else "i")
    ref, ours = j_run(jcfg, use_mesh=False), run(cfg, device="cpu")
    for key in ("num_systems", "n_stiff", "n_failed"):
        assert ours[key] == ref[key], key
    assert ours["n_failed"] == 0
    for name, var in OUTPUTS[:2]:
        a, ids_a, _ = _read(tmp_path / "torch" / f"{name}_basin_rank_0.nc", var)
        b, ids_b, _ = _read(tmp_path / "jax" / f"{name}_basin_rank_0.nc", var)
        assert np.array_equal(ids_a, ids_b), name
        if name == "dense":  # hourly rows over 2 days: row 24 is t = 1440
            assert a.shape[1] == 49
            a, b = np.delete(a, 24, axis=1), np.delete(b, 24, axis=1)
        _assert_close(a, b, "f32")


# Configs that run float64 on the card, each option set through a double
# instance of the kernels.
F64_ON_THE_CARD = {
    "f64": dict(solver__precision="f64"),
    "default": {},
    "f64_pi": dict(solver__precision="f64", solver__controller="pi"),
}


@pytest.mark.parametrize("case", sorted(F64_ON_THE_CARD))
def test_f64_on_the_card_is_not_refused(scenario, tmp_path, case):
    """solver.precision f64, the default, reaches the kernels' launches with
    either controller, as float32 does: each wrapper builds its double
    (float) instance's arguments from the run's solver config and launches
    (the launch recorded, not made, on CPU tensors).  Nothing refuses an
    option by device: the card runs every option set in float64 as the CPU
    does."""
    import torch

    from tiger_tpu_torch import Model204
    from tiger_tpu_torch.kernels import radau as k_radau
    from tiger_tpu_torch.kernels import rk45 as k_rk45
    from tiger_tpu_torch.scenario import scenario as basin

    _, cfg = _configs(scenario, tmp_path, **F64_ON_THE_CARD[case])
    assert cfg.solver.precision == "f64"
    assert cfg.solver_config().controller == ("pi" if case == "f64_pi" else "i")
    for precision, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        cfg.solver.precision = precision
        for module, launch_fn in ((k_rk45, k_rk45._rk45_cuda), (k_radau, k_radau._radau_cuda)):
            seen = []
            with pytest.MonkeyPatch.context() as m:
                m.setattr(module, "launch", lambda fn, size, args, f64, dev, o: seen.append(f64))
                y0, p, f = basin(2, 0.1, 0.0, device="cpu", dtype=dtype)
                qt = torch.arange(0.0, 60.0 + 1e-9, 30.0, dtype=dtype)
                launch_fn(Model204(), y0, torch.ones(2, dtype=dtype), 0.0, 60.0, qt, p, f,
                          cfg.solver_config())
            assert seen == [dtype == torch.float64]


def test_written_basin_runs_like_jax(tmp_path):
    """scenario.write_basin's files (classic NetCDF grids, a binary-tree
    topology, a config document without PyYAML) give the same run in both
    packages: the basin chip_smoke.py drives at full width, at 48 links.

    Its stiff systems (Hu = 1e-6) are held to the solver's tolerances
    only, rtol 1e-4 and atol 1e-9: the JAX package's float64 CPU solve
    re-integrates them through its own pipeline (an RK45 retry, then
    segmented Radau; ROADMAP Queue 1 #9), not the Radau phase the port
    runs.  So are the discharges of the links they drain into.  Every
    other value is held to the f64 bound above, except that dense values
    get RTOL 1e-8: two of this basin's early hourly values (of links 24
    and 34, at 60 and 120 minutes) lie 2.7e-9 and 7.2e-9 apart relative,
    on the same attempts per system, 140 times below the solver's rtol.
    """
    import torch
    import yaml

    from tiger_tpu_torch import routing
    from tiger_tpu_torch.scenario import STIFF_HU, write_basin

    doc = write_basin(str(tmp_path), 48, days=0.5, stiff_frac=0.05, n_lon=16)
    # The f64 case above: float64 at the config's default tolerances.
    doc["solver"] = {"precision": "f64", "tolerances": {"rtol": 1e-6, "atol": 1e-9}}
    cfg = config_from_dict(doc)
    (tmp_path / "basin.yaml").write_text(yaml.safe_dump(doc))
    jcfg = j_load_config(str(tmp_path / "basin.yaml"))
    jcfg.output.path = str(tmp_path / "jax")
    ours, ref = run(cfg, device="cpu"), j_run(jcfg, use_mesh=False)
    assert ours["n_stiff"] == ref["n_stiff"] == 2 and ours["n_failed"] == ref["n_failed"] == 0

    from tiger_tpu_torch.params import load_spatial_params

    sp = load_spatial_params(str(tmp_path / "params.csv"))
    stiff = sp["Hu"] == STIFF_HU
    topo = routing.build_topology(sp["stream"], sp["next_stream"])
    below_stiff = routing.accumulate_downstream_log(
        torch.as_tensor(stiff, dtype=torch.float64), topo
    ).numpy() > 0
    for name, var in OUTPUTS:
        a, _, _ = _read(os.path.join(cfg.output.path, f"{name}_basin_rank_0.nc"), var)
        b, _, _ = _read(tmp_path / "jax" / f"{name}_basin_rank_0.nc", var)
        loose = below_stiff if name == "discharge" else stiff
        if name == "dense":
            np.testing.assert_allclose(a[~loose], b[~loose], rtol=1e-8, atol=TOL["f64"][1])
        else:
            _assert_close(a[~loose], b[~loose], "f64")
        np.testing.assert_allclose(a[loose], b[loose], rtol=1e-4, atol=1e-9)


def test_run_without_h5py_writes_classic_netcdf(tmp_path, monkeypatch):
    """Where h5py is not installed the run writes classic NetCDF through
    scipy: the same variables with equal values and coordinates, and a
    state file that hot-starts the next run."""
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.scenario import write_basin

    doc = write_basin(str(tmp_path / "basin"), 24, days=0.25, stiff_frac=0.05, n_lon=8)
    doc["output"]["path"] = str(tmp_path / "NETCDF4")
    run(config_from_dict(doc), device="cpu")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
        doc["output"]["path"] = str(tmp_path / "classic")
        classic = run(config_from_dict(doc), device="cpu")
        doc["initial"] = {"mode": "hot", "file": classic["state_path"]}
        doc["output"]["path"] = str(tmp_path / "hot")
        hot = run(config_from_dict(doc), device="cpu")
        dense, _ = read_netcdf(hot["dense_path"], ("outputs",))
        state, _ = read_netcdf(classic["state_path"], ("outputs",))
    np.testing.assert_array_equal(dense["outputs"][:, 0, :], state["outputs"])
    for name, var in OUTPUTS:
        paths = [tmp_path / fmt / f"{name}_basin_rank_0.nc" for fmt in ("NETCDF4", "classic")]
        assert [open(p, "rb").read(3) == b"CDF" for p in paths] == [False, True]
        (a, attrs_a), (b, attrs_b) = (read_netcdf(str(p), (var, "system")) for p in paths)
        for key in (var, "system"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), (name, key)
        if name == "state":
            assert attrs_a["sim_time_minutes"] == attrs_b["sim_time_minutes"] == 360.0


def test_run_equals_a_direct_solve_of_its_files(tmp_path):
    """tests/test_torch_cuda.py's check of the CLI on the card, on the CPU:
    the files hold exactly what a direct solve() on the loaders' tensors
    gives (chip_smoke.py phase 7 makes the same check at full width)."""
    import torch

    from tiger_tpu_torch import routing
    from tiger_tpu_torch.io.netcdf import read_netcdf
    from tiger_tpu_torch.scenario import solve_written_basin, write_basin

    cfg = config_from_dict(write_basin(str(tmp_path), 40, days=0.25, stiff_frac=0.05, n_lon=8))
    out = run(cfg, device="cpu")
    res, params, sp = solve_written_basin(cfg, "cpu")
    assert out["n_stiff"] == res.n_stiff > 0 and out["n_failed"] == 0
    files = {name: read_netcdf(os.path.join(cfg.output.path, f"{name}_basin_rank_0.nc"),
                               (var,))[0][var] for name, var in OUTPUTS}
    assert np.array_equal(files["dense"], res.dense.numpy())
    assert np.array_equal(files["final"], res.y_final.numpy())
    assert np.array_equal(files["state"], res.y_final.numpy().astype(np.float64))
    topo = routing.build_topology(sp["stream"], sp["next_stream"])
    direct = routing.routed_discharge(res.dense, params, topo)
    assert np.array_equal(files["discharge"], direct.to(torch.float64).numpy())
