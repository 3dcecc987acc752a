"""The port's windowed runs against the JAX package's, on the CPU.

``tiger_tpu_torch.chunked`` (``solve_chunked``, ``netcdf_window_loader``),
the windowed writers of ``io/output.py`` with the streaming classic writer
of ``io/netcdf.py``, the windowed CLI run with checkpoints and crash resume
(``run._run_chunked``), and the small modules ``streams.py`` and
``diagnostics.py``, each held to its ``tiger_tpu`` counterpart on the same
numpy-seeded inputs.

Tolerances, per element, |ours - ref| <= RTOL * |ref| + ATOL:
  - float64 at rtol 1e-6: RTOL 1e-9 (ATOL 1e-12 for the CLI files, which
    hold states that pass near zero).  The float64 plain solvers take the
    JAX package's attempts, so the two differ by rounding only.
  - float32 at rtol 1e-5: RTOL 5e-4 and ATOL 5e-4 of each state's largest
    magnitude, ``test_torch_cli.py``'s float32 bounds: torch's and XLA's
    float32 arithmetic differ by an ulp here and there, so the step
    sequences differ.
  - chunked against unchunked: the JAX test's own 2e-2 relative (+1e-7 on
    y_final, +5e-4 on dense); integration restarts at each window edge.
Everything else (window loader, crash resume, streaming writer, i16 codes
run op by op, StreamSet, the diagnostics) is held to exact equality.
"""

import os
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli import make_scenario
from test_torch_cli import NOT_PORTED, OUTPUTS, TOL, _assert_close, _configs
from tests.test_model204 import NB_PARAMS
from tiger_tpu import chunked as jchunked
from tiger_tpu.forcing import ForcingSet as JForcingSet
from tiger_tpu.forcing import ForcingSpec as JForcingSpec
from tiger_tpu.models import Model204 as JModel204
from tiger_tpu.run import run as j_run
from tiger_tpu.solver import SolverConfig as JSolverConfig
from tiger_tpu_torch import chunked
from tiger_tpu_torch.config import config_from_dict
from tiger_tpu_torch.forcing import ForcingSet, ForcingSpec
from tiger_tpu_torch.io import netcdf as tnetcdf
from tiger_tpu_torch.io import output as toutput
from tiger_tpu_torch.io.netcdf import read_netcdf
from tiger_tpu_torch.models import DummyModel, Model204
from tiger_tpu_torch.models.model204 import Y0_COMMON
from tiger_tpu_torch.run import run
from tiger_tpu_torch.solver import SolverConfig, solve

TF = 4 * 1440.0


@pytest.fixture
def four_days():
    """tests/test_chunked.py's scenario: 4 systems, hourly pr and daily t2m
    over 4 days."""
    rng = np.random.default_rng(21)
    pr = rng.uniform(0, 0.0015, (96, 4)).astype(np.float32)
    t2m = rng.uniform(2, 12, (4, 4)).astype(np.float32)
    return pr, t2m


def _window(pr, t2m, make):
    def load_window(w_start, w_end):
        return make([pr[int(w_start // 60): int(np.ceil(w_end / 60))],
                     t2m[int(w_start // 1440): int(np.ceil(w_end / 1440))]], [60.0, 1440.0])

    return load_window


def _four_day_inputs(four_days, np_dtype):
    pr, t2m = four_days
    params = {k: np.full(4, v, np_dtype) for k, v in NB_PARAMS.items()}
    y0 = np.tile(np.asarray(Y0_COMMON, np_dtype), (4, 1))
    return pr, t2m, params, y0


def _both_chunked(four_days, np_dtype, tf=TF, topology=None, jtopology=None):
    """(ours, ref) of one solve_chunked call in each package: 1-day
    windows, 6-hourly queries, the tolerances of the dtype's row above."""
    pr, t2m, params, y0 = _four_day_inputs(four_days, np_dtype)
    rtol, atol = (1e-6, 1e-9) if np_dtype == np.float64 else (1e-5, 1e-8)
    ours = chunked.solve_chunked(
        Model204(), torch.from_numpy(y0), 0.0, tf, 1440.0,
        _window(pr, t2m, lambda s, d: ForcingSet.from_series(s, d, device="cpu")),
        query_interval=360.0, params={k: torch.from_numpy(v) for k, v in params.items()},
        config=SolverConfig(rtol=rtol, atol=atol), topology=topology,
    )
    ref = jchunked.solve_chunked(
        JModel204(), jnp.asarray(y0), 0.0, tf, 1440.0, _window(pr, t2m, JForcingSet.from_series),
        query_interval=360.0, params={k: jnp.asarray(v) for k, v in params.items()},
        config=JSolverConfig(rtol=rtol, atol=atol), backend="xla", topology=jtopology,
    )
    return ours, ref


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_chunked_matches_jax(four_days, dtype):
    ours, ref = _both_chunked(four_days, dtype)
    assert ours.n_stiff == ref.n_stiff == 0
    assert not ours.failed.any() and not np.asarray(ref.failed).any()
    for a, b in ((ours.y_final, ref.y_final), (ours.dense, ref.dense)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
        else:
            atol = TOL["f32"][1] * np.abs(b).max(axis=tuple(range(b.ndim - 1)))
            np.testing.assert_array_less(np.abs(a - b), TOL["f32"][0] * np.abs(b) + atol)
    for a, b in zip(ours.rk_stats, ref.rk_stats):
        if dtype == np.float64:  # the same attempts, window by window
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_solve_chunked_routing_matches_jax(four_days):
    from tiger_tpu import routing as jrouting
    from tiger_tpu_torch import routing

    stream = np.arange(1, 5)
    nxt = np.concatenate([stream[1:], [-1]])
    topo = routing.build_topology(stream, nxt)
    (res, routed), (jres, jrouted) = _both_chunked(
        four_days, np.float64, tf=2880.0, topology=topo,
        jtopology=jrouting.build_topology(stream, nxt))
    assert routed.shape == (4, res.dense.shape[1]) == (4, 9)
    np.testing.assert_allclose(routed.numpy(), np.asarray(jrouted), rtol=1e-9)
    # Each window's routed block is routed_discharge of its dense block.
    _, _, params, _ = _four_day_inputs(four_days, np.float64)
    direct = routing.routed_discharge(res.dense, {k: torch.from_numpy(v) for k, v in params.items()},
                                      topo)
    np.testing.assert_array_equal(routed.numpy(), direct.numpy())


def test_chunked_matches_unchunked(four_days):
    """tests/test_chunked.py::test_chunked_matches_unchunked on the port."""
    pr, t2m = four_days
    params = {k: torch.full((4,), v, dtype=torch.float64) for k, v in NB_PARAMS.items()}
    y0 = torch.tensor(Y0_COMMON, dtype=torch.float64).repeat(4, 1)
    full = ForcingSet.from_series([pr, t2m], [60.0, 1440.0], device="cpu")
    ref = solve(Model204(), y0, 0.0, TF, torch.arange(0.0, TF + 1, 360.0, dtype=torch.float64),
                params=params, forcings=full)
    res = chunked.solve_chunked(
        Model204(), y0, 0.0, TF, 1440.0,
        _window(pr, t2m, lambda s, d: ForcingSet.from_series(s, d, device="cpu")),
        query_interval=360.0, params=params,
    )
    assert res.dense.shape == ref.dense.shape
    np.testing.assert_allclose(res.y_final.numpy(), ref.y_final.numpy(), rtol=2e-2, atol=1e-7)
    np.testing.assert_allclose(res.dense.numpy(), ref.dense.numpy(), rtol=2e-2, atol=5e-4)
    np.testing.assert_array_equal(res.dense[:, 0, :].numpy(), y0.numpy())  # t0 row once


def test_chunked_queries_survive_misaligned_interval():
    """chunk_minutes=100 is not a multiple of query_interval=30: every
    multiple of 30 in [0, 200] appears exactly once."""
    y0 = torch.ones((2, 5), dtype=torch.float64)
    cfg = SolverConfig(rtol=1e-6, atol=1e-9)
    res = chunked.solve_chunked(DummyModel(), y0, 0.0, 200.0, 100.0, lambda a, b: None,
                                query_interval=30.0, config=cfg)
    assert res.dense.shape[1] == 7  # t = 0, 30, ..., 180
    ref = solve(DummyModel(), y0, 0.0, 200.0, torch.arange(0.0, 200.0, 30.0, dtype=torch.float64),
                config=cfg)
    np.testing.assert_allclose(res.dense.numpy(), ref.dense.numpy(), rtol=1e-4, atol=1e-8)


def test_chunked_rejects_misaligned_forcing_dt(four_days):
    pr, _ = four_days
    y0 = torch.tensor(Y0_COMMON, dtype=torch.float64).repeat(4, 1)
    params = {k: torch.full((4,), v, dtype=torch.float64) for k, v in NB_PARAMS.items()}
    with pytest.raises(ValueError, match="not a multiple of"):
        chunked.solve_chunked(
            Model204(), y0, 0.0, 2880.0, 90.0,
            lambda a, b: ForcingSet.from_series([pr[:24]], [60.0], device="cpu"), params=params,
        )


def test_dense_sink_matches_accumulated(four_days, tmp_path):
    """dense_sink streaming equals the accumulated dense bit for bit; the
    sink and state_sink see every window in order."""
    from tiger_tpu_torch import routing

    pr, t2m = four_days
    stream = np.arange(1, 5)
    topo = routing.build_topology(stream, np.concatenate([stream[1:], [-1]]))
    params = {k: torch.full((4,), v, dtype=torch.float64) for k, v in NB_PARAMS.items()}
    y0 = torch.tensor(Y0_COMMON, dtype=torch.float64).repeat(4, 1)
    kw = dict(chunk_minutes=1440.0, query_interval=360.0, params=params, topology=topo,
              load_window=_window(pr, t2m, lambda s, d: ForcingSet.from_series(s, d, device="cpu")))
    ref, ref_routed = chunked.solve_chunked(Model204(), y0, 0.0, 2880.0, **kw)
    got = np.full((4, 9, 5), np.nan)
    got_routed = np.full((4, 9), np.nan)
    seen = []

    def sink(q0, qt_abs, dense_blk, routed_blk):
        seen.append(("dense", q0))
        np.testing.assert_allclose(qt_abs, np.arange(0.0, 2881.0, 360.0)[q0 : q0 + len(qt_abs)])
        got[:, q0 : q0 + dense_blk.shape[1]] = dense_blk.numpy()
        got_routed[:, q0 : q0 + routed_blk.shape[1]] = routed_blk.numpy()

    res, routed_empty = chunked.solve_chunked(
        Model204(), y0, 0.0, 2880.0, dense_sink=sink,
        state_sink=lambda t, y: seen.append(("state", t)), **kw,
    )
    assert res.dense.shape == (4, 0, 5) and routed_empty.shape == (4, 0)
    assert seen == [("dense", 0), ("state", 1440.0), ("dense", 5), ("state", 2880.0)]
    np.testing.assert_array_equal(got, ref.dense.numpy())
    np.testing.assert_array_equal(got_routed, ref_routed.numpy())
    np.testing.assert_array_equal(res.y_final.numpy(), ref.y_final.numpy())


def test_metrics_record_the_windows(four_days):
    from tiger_tpu_torch.profiling import Metrics

    pr, t2m = four_days
    params = {k: torch.full((4,), v, dtype=torch.float64) for k, v in NB_PARAMS.items()}
    m = Metrics()
    chunked.solve_chunked(
        Model204(), torch.tensor(Y0_COMMON, dtype=torch.float64).repeat(4, 1), 0.0, TF, 1440.0,
        _window(pr, t2m, lambda s, d: ForcingSet.from_series(s, d, device="cpu")),
        query_interval=360.0, params=params, dense_sink=lambda *a: None, metrics=m,
    )
    for kind in ("window", "load", "solve", "sink"):
        spans = [s for s in m.spans if s[0] == kind]
        assert sorted(s[1] for s in spans) == [0, 1, 2, 3], kind
        assert all(b >= a for _, _, a, b in spans)
    assert not [s for s in m.spans if s[0] == "device"]  # the CPU has no device spans


# --- time shift -----------------------------------------------------------


class TimeProbe:
    """dy/dt = cos(2 pi t / 1440): depends only on absolute time, so a
    window-relative time leak shows at once."""

    N_EQ = 1
    UID = 901

    def rhs_tuple(self, t, y, params, forcings=None):
        return tuple(torch.cos(2.0 * torch.pi * t / 1440.0) + 0.0 * yi for yi in y)


def test_chunked_passes_absolute_time_to_model():
    """tests/test_chunked.py's case on the port: t_shift reaches the plain
    rhs (and the initial step), so the windows integrate the absolute
    time's wave."""
    model = TimeProbe()
    y0 = torch.zeros((3, 1), dtype=torch.float64)
    qt = torch.arange(0.0, 2881.0, 360.0, dtype=torch.float64)
    ref = solve(model, y0, 0.0, 2880.0, qt)
    res = chunked.solve_chunked(model, y0, 0.0, 2880.0, 720.0, lambda a, b: None,
                                query_interval=360.0)
    exact = 1440.0 / (2 * np.pi) * np.sin(2 * np.pi * qt.numpy() / 1440.0)
    np.testing.assert_allclose(res.dense.numpy()[:, :, 0], np.broadcast_to(exact, (3, len(exact))),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(res.y_final.numpy(), ref.y_final.numpy(), rtol=1e-6, atol=1e-3)


def test_solve_t_shift_equals_absolute_time():
    """solve() over [0, 360] shifted by 4320 takes the steps of the same
    span unshifted at 4320 (the plain RK45 and Radau both add the shift)."""
    from tiger_tpu_torch.kernels.radau import radau_plain

    model = TimeProbe()
    y0 = torch.zeros((4, 1), dtype=torch.float64)
    h0 = torch.full((4,), 1.0, dtype=torch.float64)
    shift = 4320.0
    a = solve(model, y0, shift, shift + 360.0)
    b = solve(model, y0, 0.0, 360.0, t_shift=shift)
    np.testing.assert_allclose(a.y_final.numpy(), 1440.0 / (2 * np.pi), rtol=1e-4)
    np.testing.assert_allclose(b.y_final.numpy(), a.y_final.numpy(), rtol=1e-9)
    ra = radau_plain(model, y0, h0, shift, shift + 360.0)
    rb = radau_plain(model, y0, h0, 0.0, 360.0, t_shift=shift)
    np.testing.assert_allclose(rb.y_final.numpy(), ra.y_final.numpy(), rtol=1e-9)


@pytest.mark.parametrize("model", ["Model204", "Model200", "TimeProbe", "DummyModel"])
def test_kernel_inputs_take_a_shift_for_the_models_the_kernels_carry(model):
    """The CUDA kernels carry Model 204, Model 200 and DummyModel and pass
    t_shift to each one's rhs, so their input check takes a shift for all
    three (DummyModel's instances read no parameter block); a model without
    a device twin (TimeProbe) is refused, with or without a shift, naming
    the models the kernels carry."""
    from tiger_tpu_torch.kernels._common import kernel_inputs, kernel_model
    from tiger_tpu_torch.models import Model200
    from tiger_tpu_torch.scenario import scenario

    y0, params, forc = scenario(8, days=1.0, device="cpu")
    h0 = torch.ones(8)
    m = {"Model204": Model204(), "Model200": Model200(doy0=183.0), "TimeProbe": TimeProbe(),
         "DummyModel": DummyModel()}[model]
    if model != "TimeProbe":
        for shift in (0.0, 60.0, 1440.0):
            y_soa, p_block = kernel_inputs("rk45", m, y0, h0, params, forc, None, t_shift=shift)
            assert y_soa.shape == (5, 8)
            if model == "DummyModel":
                assert p_block is None
            else:
                assert p_block.shape == (15, 8)
        assert kernel_model("radau", m)[0] == {"Model204": 0, "Model200": 1, "DummyModel": 2}[model]
        with pytest.raises(ValueError, match="finite"):
            kernel_inputs("radau", m, y0, h0, params, forc, None, t_shift=float("nan"))
    else:
        for shift in (0.0, 60.0):
            with pytest.raises(NotImplementedError, match="Model 204, Model 200 and DummyModel only"):
                kernel_inputs("radau", m, y0, h0, params, forc, None, t_shift=shift)


# --- stiff rows -----------------------------------------------------------


class StiffMix(DummyModel):
    """tests/test_solve_device_rung.py's model: lam << 0 lanes are stiff."""

    def rhs_tuple(self, t, y, params=None, forcings=None):
        return tuple(params["lam"] * yi for yi in y)


def test_chunked_resolves_stiff_lanes_per_window():
    """Stiff-flagged lanes are resolved inside each window (Radau) and
    their states feed the next window's start."""
    lam = np.full(8, -0.05)
    lam[[2, 5]] = -1e6
    y0 = torch.ones((8, 5), dtype=torch.float64)
    params = {"lam": torch.from_numpy(lam)}
    cfg = SolverConfig(rtol=1e-6, atol=1e-9)
    ref = solve(StiffMix(), y0, 0.0, 100.0, torch.tensor([50.0, 100.0], dtype=torch.float64),
                params=params, config=cfg)
    res = chunked.solve_chunked(StiffMix(), y0, 0.0, 100.0, 50.0, lambda a, b: None,
                                query_interval=50.0, params=params, config=cfg)
    assert res.n_stiff >= 2 * 2 and not res.failed.any()  # both lanes, both windows
    assert res.stiff[[2, 5]].all()
    np.testing.assert_allclose(res.y_final.numpy(), ref.y_final.numpy(), rtol=1e-5, atol=1e-12)
    assert np.isfinite(res.dense.numpy()).all()
    np.testing.assert_allclose(res.dense[:, 1].numpy(), np.exp(lam * 50.0)[:, None].repeat(5, 1),
                               rtol=1e-4, atol=1e-12)


# --- window loader --------------------------------------------------------


def test_netcdf_window_loader_equals_jax(tmp_path, four_days):
    from tiger_tpu.io import write_grid_forcing

    pr, t2m = four_days
    write_grid_forcing(str(tmp_path / "pr.nc"), "pr", pr.reshape(96, 1, 4))
    write_grid_forcing(str(tmp_path / "t2m.nc"), "t2m", t2m.reshape(4, 1, 4))
    streams = np.arange(1, 5)
    with open(tmp_path / "lookup.csv", "w") as f:
        f.write("stream,lat_index,lon_index\n")
        for i, s in enumerate(streams[::-1]):  # systems mapped to reversed cells
            f.write(f"{s},0,{i}\n")
    lookup = str(tmp_path / "lookup.csv")
    ours = chunked.netcdf_window_loader(
        [ForcingSpec(str(tmp_path / "pr.nc"), "pr", 1.0),
         ForcingSpec(str(tmp_path / "t2m.nc"), "t2m", 24.0)], streams, lookup, device="cpu")
    ref = jchunked.netcdf_window_loader(
        [JForcingSpec(str(tmp_path / "pr.nc"), "pr", 1.0),
         JForcingSpec(str(tmp_path / "t2m.nc"), "t2m", 24.0)], streams, lookup)
    for w_start, w_end in ((0.0, 1440.0), (1440.0, 2880.0), (4320.0, 5760.0), (2880.0, 3000.0)):
        a, b = ours(w_start, w_end), ref(w_start, w_end)
        assert a.data.dtype == torch.float32 and a.data.device.type == "cpu"
        assert np.array_equal(a.data.numpy(), np.asarray(b.data))
        assert tuple(a.meta) == tuple(tuple(x) for x in b.meta)
    np.testing.assert_array_equal(ours(1440.0, 2880.0).data[:24].numpy(), pr[24:48, ::-1])
    with pytest.raises(ValueError, match="not aligned"):
        ours(30.0, 1470.0)


# --- streaming classic writer ---------------------------------------------


def _coords(s, n_q, n):
    return np.arange(s) * 3 + 1, np.arange(n_q) * 60.0, np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
def test_classic_stream_writer_equals_scipy_writer(tmp_path, monkeypatch, dtype):
    """Filled window by window (and mapped a few rows at a time), the file
    reads back through scipy and through read_netcdf with the values,
    dimensions and attributes of ClassicNetCDFWriter's file."""
    from scipy.io import netcdf_file

    from tiger_tpu_torch.io.output import _def_output_dims

    rng = np.random.default_rng(4)
    s, n_q, n = 37, 11, 3
    data = (rng.standard_normal((s, n_q, n)) * 100).astype(dtype)
    ids, qt, states = _coords(s, n_q, n)
    attrs = {"long_name": "x", "scale_factor": np.float64(0.5), "_FillValue": np.int16(-3),
             "count": 7, "ratio": 0.25}
    dims = ("system", "time", "variable")
    with tnetcdf.ClassicNetCDFWriter(str(tmp_path / "ref.nc")) as w:
        _def_output_dims(w, ids, qt, states)
        w.def_var("outputs", data, dims, attrs=attrs)
    monkeypatch.setattr(tnetcdf, "MAP_BYTES", 200)  # several maps a window
    w = tnetcdf.ClassicStreamWriter(str(tmp_path / "new.nc"))
    _def_output_dims(w, ids, qt, states)
    var = w.def_var_empty("outputs", data.shape, dims, dtype, attrs=attrs)
    w.end_define()
    for q0 in range(0, n_q, 4):
        var[:, q0 : q0 + 4] = data[:, q0 : q0 + 4]
        w.flush()
    w.close()
    with netcdf_file(str(tmp_path / "ref.nc"), "r", mmap=False) as a, \
            netcdf_file(str(tmp_path / "new.nc"), "r", mmap=False) as b:
        assert a.dimensions == b.dimensions and a._attributes == b._attributes
        assert set(a.variables) == set(b.variables)
        for name, va in a.variables.items():
            vb = b.variables[name]
            assert va.dimensions == vb.dimensions and va.typecode() == vb.typecode(), name
            assert va._attributes.keys() == vb._attributes.keys(), name
            for k in va._attributes:
                assert np.array_equal(va._attributes[k], vb._attributes[k]), (name, k)
            assert np.array_equal(va[:], vb[:]), name
    names = ("outputs", "system", "time", "variable")
    (ra, ga), (rb, gb) = (read_netcdf(str(tmp_path / p), names) for p in ("ref.nc", "new.nc"))
    assert ga == gb
    for k in names:
        assert ra[k].dtype == rb[k].dtype and np.array_equal(ra[k], rb[k]), k
    # Re-opened for more windows: the header reads back, slabs write in place.
    again = tnetcdf.ClassicStreamWriter.open(str(tmp_path / "new.nc"))
    assert again["outputs"].shape == data.shape and again["outputs"].dtype == np.dtype(dtype)
    assert np.array_equal(np.asarray(again["system"]), ids)
    again["outputs"][:, 2:3] = np.zeros((s, 1, n), dtype)
    again.close()
    back, _ = read_netcdf(str(tmp_path / "new.nc"), ("outputs",))
    assert (back["outputs"][:, 2] == 0).all() and np.array_equal(back["outputs"][:, 3:], data[:, 3:])


def test_classic_stream_writer_beyond_4_gib(tmp_path):
    """The header of a variable above 4 GiB, last in the file: the file is
    sparse (sized by truncate), and scipy opens it and reads back the two
    corner slabs written."""
    from scipy.io import netcdf_file

    from tiger_tpu_torch.io.output import _def_output_dims

    s, n_q, n = 65_536, 8_761, 2  # 4.6e9 bytes of float32
    ids, qt, states = _coords(s, n_q, n)
    path = str(tmp_path / "big.nc")
    w = tnetcdf.ClassicStreamWriter(path)
    _def_output_dims(w, ids, qt, states)
    var = w.def_var_empty("outputs", (s, n_q, n), ("system", "time", "variable"), np.float32)
    w.end_define()
    corner = np.arange(12, dtype=np.float32).reshape(2, 3, 2) + 1
    var[:2, :3] = corner
    var[s - 2 :, n_q - 3 :] = -corner
    w.close()
    assert os.path.getsize(path) > 2**32 + s * 4 + n_q * 8
    assert os.stat(path).st_blocks * 512 < 2**26  # holes, not 4.6 GB of zeros
    f = netcdf_file(path, "r", mmap=True)
    data = f.variables["outputs"]
    assert data.shape == (s, n_q, n)
    assert np.array_equal(np.array(data[:2, :3]), corner)
    assert np.array_equal(np.array(data[s - 2 :, n_q - 3 :]), -corner)
    assert np.array_equal(np.array(f.variables["time"][:]), qt)
    del data
    f.close()
    # A second variable above 4 GiB cannot be stated in a CDF-2 header.
    w = tnetcdf.ClassicStreamWriter(str(tmp_path / "two.nc"))
    _def_output_dims(w, ids, qt, states)
    for name in ("a", "b"):
        w.def_var_empty(name, (s, n_q, n), ("system", "time", "variable"), np.float32)
    with pytest.raises(ValueError, match="the last"):
        w.end_define()


@pytest.mark.parametrize("fmt", ["NETCDF4", "classic"])
def test_windowed_var_writer_equals_a_whole_write(tmp_path, monkeypatch, fmt):
    """WindowedVarWriter filled window by window equals write_dense_netcdf
    of the whole array (and, in NETCDF4, the JAX WindowedVarWriter's file)."""
    from test_torch_io import _assert_same_file
    from tiger_tpu.io.output import WindowedVarWriter as JWindowed

    rng = np.random.default_rng(5)
    data = rng.standard_normal((9, 13, 5)).astype(np.float32)
    ids, qt, states = _coords(9, 13, 5)
    if fmt == "classic":
        monkeypatch.setitem(sys.modules, "h5py", None)
    with toutput.WindowedVarWriter(str(tmp_path / "w.nc"), "outputs", ids, qt,
                                   state_ids=states, dtype=np.float64) as w:
        for q0 in (0, 5, 10):
            w.write(q0, torch.from_numpy(data[:, q0 : q0 + 5]))
            w.flush()
    toutput.write_dense_netcdf(str(tmp_path / "full.nc"), data, qt, ids, states, dtype=np.float64)
    monkeypatch.undo()
    a, _ = read_netcdf(str(tmp_path / "w.nc"), ("outputs", "system", "time"))
    b, _ = read_netcdf(str(tmp_path / "full.nc"), ("outputs", "system", "time"))
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert (open(tmp_path / "w.nc", "rb").read(3) == b"CDF") == (fmt == "classic")
    if fmt == "NETCDF4":
        with JWindowed(str(tmp_path / "j.nc"), "outputs", ids, qt, state_ids=states,
                       dtype=np.float64) as jw:
            for q0 in (0, 5, 10):
                jw.write(q0, data[:, q0 : q0 + 5])
        _assert_same_file(tmp_path / "w.nc", tmp_path / "j.nc")


# --- int16 ------------------------------------------------------------------


def test_pack_cf_int16_declared_equals_jax_op_by_op():
    """The codes of the JAX function run op by op (each operation rounded
    once, as the port's torch ops round them): equal."""
    from tiger_tpu.io.output import _pack_cf_int16_declared as j_pack

    rng = np.random.default_rng(6)
    x = rng.uniform(-1.0, 7.0, (50, 9, 5)).astype(np.float32)
    x[3, 2, :] = np.nan
    x[4, 1, 1] = np.inf
    lo = np.array([0.0, 0.0, -1.0, 0.0, 2.0])
    hi = np.array([0.05, 4.0, 1.0, 6.0, 3.0])
    scale = np.maximum((hi - lo) / 65532.0, 1e-30).astype(np.float32)
    offset = ((hi + lo) / 2.0).astype(np.float32)
    ours = toutput._pack_cf_int16_declared(torch.from_numpy(x), torch.from_numpy(scale),
                                           torch.from_numpy(offset)).numpy()
    ref = np.asarray(j_pack(jnp.asarray(x), scale, offset))
    assert ours.dtype == ref.dtype == np.int16
    assert np.array_equal(ours, ref)
    assert (ours == -32767).sum() == 6 and ours.max() == 32766


I16_RANGES = {0: (0.0, 0.05), 1: (0.0, 4.0), 2: (0.0, 0.01), 3: (0.0, 6.0), 4: (0.0, 1.0)}


def test_chunked_i16_within_one_code_of_the_jax_file(tmp_path):
    """The windowed i16 run against the JAX one: the JAX writer packs under
    jit, where XLA multiplies by the reciprocal of the constant scale, so a
    code may lie one step from the port's (ROADMAP Queue 3); and the codes
    decode to the f64 run within 0.75 of a step, clipped to the range."""
    sc = make_scenario(tmp_path)
    kw = dict(time__chunk_days=1.0, output__precision="i16", output__i16_ranges=I16_RANGES)
    jcfg, cfg = _configs(sc, tmp_path / "i16", **kw)
    j_run(jcfg, use_mesh=False)
    run(cfg, device="cpu")
    _, ref_cfg = _configs(sc, tmp_path / "f64", time__chunk_days=1.0, output__precision="f64")
    run(ref_cfg, device="cpu")
    ref, _ = read_netcdf(str(tmp_path / "f64" / "torch" / "dense_basin_rank_0.nc"), ("outputs",))
    with h5py.File(tmp_path / "i16" / "torch" / "dense_basin_rank_0.nc") as fa, \
            h5py.File(tmp_path / "i16" / "jax" / "dense_basin_rank_0.nc") as fb:
        for v, (lo, hi) in I16_RANGES.items():
            a, b = fa[f"outputs_{v}"], fb[f"outputs_{v}"]
            assert a.dtype == b.dtype == np.int16
            for k in ("scale_factor", "add_offset", "_FillValue"):
                assert a.attrs[k] == b.attrs[k], k
            assert np.abs(a[...].astype(np.int32) - b[...]).max() <= 1, v
            scale = a.attrs["scale_factor"]
            dec = a[...] * scale + a.attrs["add_offset"]
            assert np.abs(dec - np.clip(ref["outputs"][:, :, v], lo, hi)).max() <= 0.75 * scale


@pytest.mark.parametrize("ranges,match", [(None, "i16_ranges"),
                                          ({k: v for k, v in I16_RANGES.items() if k != 3},
                                           "missing output states")])
def test_chunked_i16_refusals(tmp_path, ranges, match):
    sc = make_scenario(tmp_path)
    _, cfg = _configs(sc, tmp_path, time__chunk_days=1.0, output__precision="i16",
                      output__i16_ranges=ranges)
    with pytest.raises(ValueError, match=match):
        run(cfg, device="cpu")


# --- the windowed CLI run -------------------------------------------------


@pytest.mark.parametrize("precision,states", [("f64", None), ("f32", None), ("f64", [3, 0]),
                                              ("f32c", None)])
def test_chunked_run_matches_jax(tmp_path, precision, states):
    """Both packages' windowed runs (2 windows, checkpoints every day, all
    states or a subset) write the same files within the CLI's tolerances,
    and the same summary keys.  f32c (compensated float32) runs at the
    reference's rtol 1e-6 / atol 1e-9 and is held to the f32 bound."""
    sc = make_scenario(tmp_path)
    changes = dict(time__chunk_days=1.0, output__checkpoint_interval="1d",
                   solver__precision=precision, output__states=states)
    if precision == "f32":
        changes.update(solver__rtol=1e-5, solver__atol=1e-8)
    if precision == "f32c":
        changes.update(solver__rtol=1e-6, solver__atol=1e-9)
    jcfg, cfg = _configs(sc, tmp_path, **changes)
    assert cfg.solver_config().compensated == (precision == "f32c")
    ref, ours = j_run(jcfg, use_mesh=False), run(cfg, device="cpu")
    assert set(ours) == set(ref) - NOT_PORTED
    for key in ("num_systems", "n_stiff", "n_failed", "n_windows"):
        assert ours[key] == ref[key], key
    assert ours["n_windows"] == 2 and set(ours["phases_s"]) == set(ref["phases_s"])
    for name, var in OUTPUTS:
        with h5py.File(tmp_path / "torch" / f"{name}_basin_rank_0.nc") as fa, \
                h5py.File(tmp_path / "jax" / f"{name}_basin_rank_0.nc") as fb:
            a, b = np.asarray(fa[var]), np.asarray(fb[var])
            assert np.array_equal(fa["system"], fb["system"]), name
            if name in ("final", "dense"):
                assert np.array_equal(fa["variable"], fb["variable"]), name
            if name == "state":
                assert fa.attrs["sim_time_minutes"] == fb.attrs["sim_time_minutes"] == 2880.0
        _assert_close(a, b, "f32" if precision == "f32c" else precision)


def test_chunked_cli_module_runs_a_windowed_config(tmp_path):
    """python -m tiger_tpu_torch.run --cpu with time.chunk_days set."""
    import json
    import subprocess

    import yaml

    from tiger_tpu_torch.scenario import write_basin

    doc = write_basin(str(tmp_path), 12, days=2.0, n_lon=4)
    doc["time"]["chunk_days"] = 1.0
    (tmp_path / "sim.yaml").write_text(yaml.safe_dump(doc))
    proc = subprocess.run(
        [sys.executable, "-m", "tiger_tpu_torch.run", "--config", str(tmp_path / "sim.yaml"),
         "--cpu"], capture_output=True, text=True, timeout=600,
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": str(tmp_path),
             "PYTHONPATH": os.getcwd()},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["n_windows"] == 2 and summary["n_failed"] == 0
    dense, _ = read_netcdf(summary["dense_path"], ("outputs",))
    assert dense["outputs"].shape == (12, 49, 5) and np.isfinite(dense["outputs"]).all()


def _basin_cfg(tmp_path, outdir, output=None, **initial):
    from tiger_tpu_torch.scenario import write_basin

    # No stiff link: radau_plain over a Hu = 1e-6 link's transient takes
    # the CPU ~20 s (the card's crash-and-resume test has stiff links).
    doc = write_basin(str(tmp_path / "basin"), 24, days=2.0, n_lon=8)
    doc["time"]["chunk_days"] = 1.0
    doc["output"].update(checkpoint_interval="1d", path=str(tmp_path / outdir), **(output or {}))
    if initial:
        doc["initial"] = dict(mode="hot", resume=True, **initial)
    return config_from_dict(doc)


@pytest.mark.parametrize("fmt,precision", [("NETCDF4", None), ("classic", None),
                                            ("classic", "i16")])
def test_crash_resume_bitwise(tmp_path, monkeypatch, fmt, precision):
    """tests/test_chunked.py::test_crash_resume_bitwise on the port, in both
    output formats (classic: h5py hidden, so the streaming classic writer
    fills and re-opens the files) and with int16 dense output: kill a
    windowed run in its second window, resume from the day-1 checkpoint
    into the same files, and get the files of an uninterrupted run bit for
    bit."""
    if fmt == "classic":
        monkeypatch.setitem(sys.modules, "h5py", None)
    output = {}
    if precision == "i16":
        output = dict(precision="i16", i16_ranges={v: [0.0, 6.0] for v in range(5)})
    run(_basin_cfg(tmp_path, "ref", output), device="cpu")

    real_solve, calls = chunked.solve, {"n": 0}

    def dying_solve(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real_solve(*a, **kw)

    with monkeypatch.context() as m:
        m.setattr(chunked, "solve", dying_solve)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run(_basin_cfg(tmp_path, "crashed", output), device="cpu")
    state = tmp_path / "crashed" / "state_basin_rank_0.nc"
    (y, _), (_, attrs) = read_netcdf(str(state), ("outputs",)), read_netcdf(str(state), ())
    assert attrs["sim_time_minutes"] == 1440.0
    out = run(_basin_cfg(tmp_path, "crashed", output, file=str(state)), device="cpu")
    assert out["n_windows"] == 1 and out["n_failed"] == 0
    outputs = list(OUTPUTS)
    if precision == "i16":
        outputs = [o for o in outputs if o[0] != "dense"] + [("dense", f"outputs_{v}")
                                                              for v in range(5)]
    for name, var in outputs:
        paths = [tmp_path / d / f"{name}_basin_rank_0.nc" for d in ("ref", "crashed")]
        assert all((open(p, "rb").read(3) == b"CDF") == (fmt == "classic") for p in paths)
        a, b = (read_netcdf(str(p), (var,))[0][var] for p in paths)
        assert a.dtype == b.dtype and np.array_equal(a, b), (name, var)


def test_resume_rejects_misaligned_time(tmp_path):
    from tiger_tpu_torch import checkpoint as ckpt

    sc = make_scenario(tmp_path)
    _, cfg = _configs(sc, tmp_path, time__chunk_days=1.0)
    run(cfg, device="cpu")  # the full-extent output files
    state = tmp_path / "torch" / "state_basin_rank_0.nc"
    y, ids, _ = ckpt.load_state(str(state))
    ckpt.save_state(str(state), y, ids, 1500.0)  # not a window boundary
    _, cfg2 = _configs(sc, tmp_path, time__chunk_days=1.0, initial__mode="hot",
                       initial__file=str(state), initial__resume=True)
    with pytest.raises(ValueError, match="not aligned"):
        run(cfg2, device="cpu")


def test_checkpoint_interval_rejects_offgrid_windows(tmp_path):
    """Window ends off the query grid could never be resumed: refused up
    front."""
    sc = make_scenario(tmp_path)
    _, cfg = _configs(sc, tmp_path, time__chunk_days=1.5, output__print_interval="1d",
                      output__checkpoint_interval="1d")
    with pytest.raises(ValueError, match="multiple of"):
        run(cfg, device="cpu")


@pytest.mark.parametrize("fault", ["missing", "mismatched", "not_chunked", "no_time"])
def test_resume_refusals(tmp_path, fault):
    """A resume needs the run's own output files and a checkpoint."""
    from tiger_tpu_torch import checkpoint as ckpt

    sc = make_scenario(tmp_path)
    _, cfg = _configs(sc, tmp_path / "a", time__chunk_days=1.0, output__checkpoint_interval="1d")
    run(cfg, device="cpu")
    state = tmp_path / "a" / "torch" / "state_basin_rank_0.nc"
    y, ids, _ = ckpt.load_state(str(state))
    ckpt.save_state(str(state), y, ids, 1440.0)
    changes = dict(time__chunk_days=1.0, initial__mode="hot", initial__file=str(state),
                   initial__resume=True)
    out = tmp_path / "a"
    if fault == "missing":
        out = tmp_path / "empty"
        want = (FileNotFoundError, "output file is missing")
    elif fault == "mismatched":
        changes["output__print_interval"] = "2h"
        want = (ValueError, "resume shape mismatch")
    elif fault == "not_chunked":
        changes["time__chunk_days"] = 0.0
        want = (ValueError, "requires time.chunk_days")
    else:
        from tiger_tpu_torch.io import write_final_netcdf

        write_final_netcdf(str(state), y, ids)  # a plain final file: no time
        want = (ValueError, "not a resumable checkpoint")
    _, cfg2 = _configs(sc, out, **changes)
    with pytest.raises(want[0], match=want[1]):
        run(cfg2, device="cpu")


# --- streams and diagnostics ------------------------------------------------


def test_streamset_equals_jax(tmp_path):
    """tests/test_streams_checkpoint.py's StreamSet case on the port's own
    CSV (make_scenario's)."""
    from tiger_tpu.streams import StreamSet as JStreamSet
    from tiger_tpu_torch.streams import StreamSet

    sc = make_scenario(tmp_path)
    y0c = (0.01, 3.0, 0.0, 5.0, 0.2)
    ours = StreamSet.from_csv(str(tmp_path / "params.csv"), y0c)
    ref = JStreamSet.from_csv(str(tmp_path / "params.csv"), y0c)
    assert len(ours) == len(ref) == sc["n_sys"]
    np.testing.assert_array_equal(ours.y0, ref.y0)
    np.testing.assert_array_equal(ours.ids, ref.ids)
    np.testing.assert_array_equal(ours.next_ids, ref.next_ids)
    assert ours.model_params().keys() == ref.model_params().keys()
    for k, v in ref.model_params().items():
        assert np.array_equal(ours.model_params()[k], v), k
    assert np.array_equal(ours.topology.next_idx, ref.topology.next_idx)
    assert ours.topology.depth == ref.topology.depth
    sub, jsub = ours.subset([0, 2, 4]), ref.subset([0, 2, 4])
    assert len(sub) == 3
    np.testing.assert_array_equal(sub.ids, jsub.ids)
    np.testing.assert_array_equal(sub.y0, jsub.y0)


def _forc(s=4, torch_side=True):
    pr = np.arange(24 * s, dtype=np.float32).reshape(24, s) * 0.01
    t2m = np.full((2, s), 5.0, np.float32)
    pr[5, 1] = np.nan
    if torch_side:
        return ForcingSet.from_series([pr, t2m], [60.0, 1440.0], device="cpu")
    return JForcingSet.from_series([pr, t2m], [60.0, 1440.0])


def test_diagnostics_equal_jax():
    """Every helper of tests/test_diagnostics.py, against the JAX one."""
    from tiger_tpu import diagnostics as jd
    from tiger_tpu_torch import diagnostics as td

    f, jf = _forc(), _forc(torch_side=False)
    for t in (90.0, 1e9, 0.0, 350.0):
        a, b = td.forcing_at(f, t), jd.forcing_at(jf, t)
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    assert np.array_equal(td.forcing_at(f, 90.0, [1, 3]), jd.forcing_at(jf, 90.0, [1, 3]))
    a, b = td.forcing_series(f, 0, system=2, n=3), jd.forcing_series(jf, 0, system=2, n=3)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(td.forcing_series(f, 1, system=1), jd.forcing_series(jf, 1, system=1))
    assert td.describe_forcings(f) == jd.describe_forcings(jf)
    params = {k: np.full((4,), v, np.float32) for k, v in NB_PARAMS.items()}
    params["Hu"][2] = np.nan
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    assert td.describe_params(tparams, system=1) == jd.describe_params(params, system=1)
    a, b = td.describe_params(tparams), jd.describe_params(params)
    assert a.keys() == b.keys()
    for k in a:
        assert np.allclose([a[k][x] for x in sorted(a[k])], [b[k][x] for x in sorted(b[k])],
                           equal_nan=True, rtol=1e-7), k
    y = np.array([[1.0, -2.0], [np.nan, 3.0]])
    assert td.holding_summary(torch.from_numpy(y), ["a", "b"]) == jd.holding_summary(y, ["a", "b"])
    with pytest.raises(ValueError, match="labels"):
        td.holding_summary(y, ["a"])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eval_rhs_equals_jax(dtype):
    from tiger_tpu import diagnostics as jd
    from tiger_tpu_torch import diagnostics as td

    params = {k: np.full((4,), v, dtype) for k, v in NB_PARAMS.items()}
    y = np.tile(np.asarray([0.01, 0.3, 0.0, 5.0, 0.2], dtype), (4, 1))
    y[1, 0] = 0.02
    ours = td.eval_rhs(Model204(), torch.from_numpy(y), 90.0,
                       {k: torch.from_numpy(v) for k, v in params.items()}, _forc())
    ref = np.asarray(jd.eval_rhs(JModel204(), jnp.asarray(y), 90.0,
                                 {k: jnp.asarray(v) for k, v in params.items()},
                                 _forc(torch_side=False)))
    assert ours.shape == (4, 5) and ours.dtype == ref.dtype
    # The same float formulas; exp2/log2 of two libms in the Manning term.
    np.testing.assert_allclose(ours, ref, rtol=1e-6 if dtype == np.float32 else 1e-13)
