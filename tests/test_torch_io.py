"""tiger_tpu_torch's file half against tiger_tpu's: config, parameter CSV,
forcing files, output writers, int16 packing and state files.

Everything here is held to exact equality: the same bytes are parsed by
copies of the same code, the forcing remap is a gather, and the writers are
given the same arrays.  The one exception is named where it occurs.
"""

import dataclasses
import os
import warnings

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli import make_scenario
from tiger_tpu import checkpoint as jckpt
from tiger_tpu import params as jparams
from tiger_tpu.config import load_config as j_load_config
from tiger_tpu.forcing import ForcingSpec as JForcingSpec
from tiger_tpu.forcing import discover_forcings as j_discover
from tiger_tpu.forcing import load_forcings as j_load_forcings
from tiger_tpu.io import output as joutput
from tiger_tpu_torch import checkpoint as ckpt
from tiger_tpu_torch import native
from tiger_tpu_torch import params as tparams
from tiger_tpu_torch.config import config_from_dict, load_config
from tiger_tpu_torch.forcing import (
    ForcingSet,
    ForcingSpec,
    discover_forcings,
    load_forcings,
    remap_grid_to_systems,
)
from tiger_tpu_torch.io import netcdf as tnetcdf
from tiger_tpu_torch.io import output as toutput


@pytest.fixture
def scenario(tmp_path):
    return make_scenario(tmp_path)


# --- config ---------------------------------------------------------------


def _yaml_doc(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["solver_config"] = dataclasses.asdict(cfg.solver_config())
    return d


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_config_fields_equal(scenario, precision):
    path = scenario["cfg_path"]
    if precision == "f32":
        path = scenario["tmp_path"] / "f32.yaml"
        path.write_text(
            scenario["cfg_path"].read_text()
            .replace("initial_step: null", "initial_step: null\n  precision: f32")
            .replace("rtol: 1.0e-6", "rtol: 1.0e-5")
        )
    ours, ref = load_config(str(path)), j_load_config(str(path))
    assert _fields(ours) == _fields(ref)
    assert _fields(config_from_dict(_yaml_doc(path))) == _fields(ref)
    assert ours.solver.precision == precision


def test_f32_tight_tolerance_warns(scenario):
    path = scenario["tmp_path"] / "f32.yaml"
    path.write_text(
        scenario["cfg_path"].read_text().replace(
            "initial_step: null", "initial_step: null\n  precision: f32"
        )
    )
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        load_config(str(path))
    assert any("float32 rounding" in str(w.message) for w in caught)


BAD_DOCS = {
    "end_before_start": {"time": {"start": "2019-01-02", "end": "2019-01-01"}},
    "negative_chunk": {"time": {"start": "2019-01-01", "end": "2019-01-02", "chunk_days": -1}},
    "hot_without_file": {"initial": {"mode": "hot"}},
    "bad_mode": {"initial": {"mode": "warm"}},
    "resume_cold": {"initial": {"mode": "cold", "resume": True}},
    "bad_interval": {"output": {"print_interval": "500ms"}},
    "bad_exchange": {"output": {"routed_exchange": "mesh"}},
    "bad_out_precision": {"output": {"precision": "f16"}},
    "i16_ranges_without_i16": {"output": {"i16_ranges": {0: [0, 1]}}},
    "i16_range_inverted": {"output": {"precision": "i16", "i16_ranges": {0: [1, 0]}}},
    "radau_method": {"solver": {"method": "Radau"}},
    "bad_precision": {"solver": {"precision": "f16"}},
    "bad_controller": {"solver": {"controller": "pid"}},
    "bad_pi_beta": {"solver": {"pi_beta": 0.5}},
}


@pytest.mark.parametrize("case", sorted(BAD_DOCS))
def test_config_refuses_what_jax_refuses(case, tmp_path):
    import yaml

    doc = BAD_DOCS[case]
    path = tmp_path / "bad.yaml"
    path.write_text(yaml.safe_dump(doc))
    with pytest.raises(ValueError) as ref:
        j_load_config(str(path))
    with pytest.raises(ValueError) as ours:
        config_from_dict(doc)
    assert str(ours.value) == str(ref.value)


# --- parameter CSV --------------------------------------------------------


def _assert_params_equal(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_params_csv_equal(scenario, route, monkeypatch):
    path = str(scenario["tmp_path"] / "params.csv")
    ref = jparams.load_spatial_params(path)
    if route == "numpy":
        def no_library(*args):
            raise ImportError("no native library")

        monkeypatch.setattr(native, "load_csv_columns", no_library)
    else:  # the library builds here, so the native parser reads the file
        cols = native.load_csv_columns(path, tparams.REQUIRED_COLUMNS)
        assert len(cols["stream"]) == scenario["n_sys"]
    _assert_params_equal(tparams.load_spatial_params(path), ref)


def test_params_csv_bom_header_falls_back_to_numpy(scenario, tmp_path):
    """The strict native parser refuses a BOM and padded names; numpy reads
    them, in both packages alike."""
    text = (scenario["tmp_path"] / "params.csv").read_text()
    header, rest = text.split("\n", 1)
    path = tmp_path / "bom.csv"
    path.write_text("\ufeff" + header.replace(",", ", ") + "\n" + rest, encoding="utf-8")
    _assert_params_equal(
        tparams.load_spatial_params(str(path)), jparams.load_spatial_params(str(path))
    )


@pytest.mark.parametrize("num_params", [16, 15])
def test_params_positional_columns_equal(scenario, tmp_path, num_params):
    cols = jparams._load_csv_numpy(str(scenario["tmp_path"] / "params.csv"))
    order = ("stream", "next_stream") + jparams.POSITIONAL_ORDER
    path = tmp_path / "pos.csv"
    with open(path, "w") as f:
        for r in range(len(cols["stream"])):
            f.write(",".join(repr(float(cols[c][r])) for c in order) + "\n")
    columns = {"stream_id": 0, "next_stream_id": 1, "params_start": 2, "num_params": num_params}
    _assert_params_equal(
        tparams.load_spatial_params(str(path), columns=columns),
        jparams.load_spatial_params(str(path), columns=columns),
    )


# --- forcing files --------------------------------------------------------


def _forcing_folder(tmp_path, fmt):
    """pr (hourly) and t2m (daily) grids with time coordinates, in NETCDF4
    or classic format, and a lookup CSV for 6 links."""
    rng = np.random.default_rng(21)
    n_lat, n_lon = 3, 5
    pr = rng.uniform(0, 0.0015, (48, n_lat, n_lon)).astype(np.float32)
    t2m = rng.uniform(-2, 10, (3, n_lat, n_lon)).astype(np.float32)
    for name, grid, dt in (("pr", pr, 1.0), ("t2m", t2m, 24.0)):
        tvals = np.arange(grid.shape[0]) * dt
        attrs = {"units": "hours since 2019-01-01"}
        path = str(tmp_path / f"{name}.nc")
        if fmt == "classic":
            tnetcdf.write_grid_forcing(path, name, grid, time_vals=tvals, time_attrs=attrs,
                                       writer=tnetcdf.ClassicNetCDFWriter)
            assert open(path, "rb").read(3) == b"CDF"
        else:
            tnetcdf.write_grid_forcing(path, name, grid, time_vals=tvals, time_attrs=attrs)
    streams = np.array([14, 7, 21, 35, 28, 42])
    with open(tmp_path / "lookup.csv", "w") as f:
        f.write("stream,lat_index,lon_index\n")
        for s, la, lo in zip(streams, rng.integers(0, n_lat, 6), rng.integers(0, n_lon, 6)):
            f.write(f"{s},{la},{lo}\n")
    return streams, str(tmp_path / "lookup.csv")


@pytest.mark.parametrize("duration_days", [2.0, 2.5, None])
@pytest.mark.parametrize("fmt", ["netcdf4", "classic"])
def test_load_forcings_equal(tmp_path, fmt, duration_days):
    streams, lookup = _forcing_folder(tmp_path, fmt)
    specs = discover_forcings(str(tmp_path), ["pr", "t2m"])
    jspecs = j_discover(str(tmp_path), ["pr", "t2m"])
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs]
    ours = load_forcings(specs, streams, lookup, duration_days=duration_days, device="cpu")
    ref = j_load_forcings(jspecs, streams, lookup, duration_days=duration_days)
    assert tuple(ours.meta) == tuple(ref.meta)
    assert ours.data.dtype == torch.float32 and ours.data.device.type == "cpu"
    assert np.array_equal(ours.data.numpy(), np.asarray(ref.data))


def test_explicit_specs_and_per_forcing_lookup_equal(tmp_path):
    streams, lookup = _forcing_folder(tmp_path, "classic")
    specs = [ForcingSpec(str(tmp_path / "pr.nc"), "pr", 1.0, lookup),
             ForcingSpec(str(tmp_path / "t2m.nc"), "t2m", 24.0)]
    jspecs = [JForcingSpec(*dataclasses.astuple(s)) for s in specs]
    ours = load_forcings(specs, streams[::-1], lookup, duration_days=1.0, device="cpu")
    ref = j_load_forcings(jspecs, streams[::-1], lookup, duration_days=1.0)
    assert tuple(ours.meta) == tuple(ref.meta)
    assert np.array_equal(ours.data.numpy(), np.asarray(ref.data))


def test_from_grid_series_equals_host_remap(tmp_path):
    rng = np.random.default_rng(4)
    grids = [rng.uniform(0, 1, (5, 3, 4)).astype(np.float32),
             rng.uniform(0, 1, (2, 3, 4)).astype(np.float32)]
    flat = rng.integers(0, 12, 9)
    dev = ForcingSet.from_grid_series([g.reshape(g.shape[0], -1) for g in grids], flat,
                                      [60.0, 1440.0], device="cpu")
    host = ForcingSet.from_series([remap_grid_to_systems(g, flat) for g in grids],
                                  [60.0, 1440.0], device="cpu")
    assert dev.meta == host.meta and torch.equal(dev.data, host.data)


@pytest.mark.parametrize("flat", [[0, 12], [-1, 3]])
def test_out_of_grid_index_refused_on_the_host(flat):
    grid = np.zeros((2, 12), np.float32)
    with pytest.raises(ValueError, match="outside the 12-cell grid"):
        ForcingSet.from_grid_series([grid], np.asarray(flat), [60.0], device="cpu")
    with pytest.raises(ValueError, match="outside the 12-cell grid"):
        ForcingSet.from_grid_series([grid], torch.tensor(flat), [60.0], device="cpu")


def test_missing_cell_refused(tmp_path):
    streams, lookup = _forcing_folder(tmp_path, "netcdf4")
    grid = np.full((48, 3, 5), np.nan, np.float32)
    tnetcdf.write_grid_forcing(str(tmp_path / "pr.nc"), "pr", grid)
    specs = [ForcingSpec(str(tmp_path / "pr.nc"), "pr", 1.0)]
    with pytest.raises(ValueError, match="missing"):
        load_forcings(specs, streams, lookup, device="cpu")


# --- writers --------------------------------------------------------------


def _h5_tree(path):
    """Every dataset's values, dtype, attributes and dimension scales, and
    the file's attributes."""
    skip = ("DIMENSION_LIST", "REFERENCE_LIST")
    tree = {}
    with h5py.File(path, "r") as f:
        tree["/"] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
        for name, ds in f.items():
            tree[name] = dict(
                dtype=str(ds.dtype),
                values=np.asarray(ds[...]),
                attrs={k: np.asarray(v).tolist() for k, v in ds.attrs.items() if k not in skip},
                dims=[[s.name for s in d.values()] for d in ds.dims],
                scale=ds.is_scale,
            )
    return tree


def _assert_same_file(ours, ref):
    a, b = _h5_tree(ours), _h5_tree(ref)
    assert a.keys() == b.keys() and a["/"] == b["/"]
    for name in b:
        if name == "/":
            continue
        va, vb = a[name].pop("values"), b[name].pop("values")
        assert a[name] == b[name], name
        assert va.dtype == vb.dtype and np.array_equal(va, vb, equal_nan=va.dtype.kind == "f"), name


def _dense_case(dtype, s=7, n_q=5, n=5):
    rng = np.random.default_rng(12)
    dense = rng.uniform(-1.0, 3.0, (s, n_q, n)).astype(dtype)
    dense[:, :, 1] *= 1e-7  # states of very different ranges
    dense[2, 3, 0] = np.nan
    dense[4, 1, 2] = np.inf
    return dense, np.arange(n_q) * 60.0, np.array([5, 3, 9, 1, 8, 2, 7][:s])


@pytest.mark.parametrize("out_dtype", [None, np.float32, np.float64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["final", "dense"])
def test_netcdf_writers_equal(tmp_path, kind, dtype, out_dtype):
    dense, qt, ids = _dense_case(dtype)
    states = np.array([0, 2, 4], np.int32)
    if kind == "final":
        data = dense[:, -1, :3]
        toutput.write_final_netcdf(str(tmp_path / "a.nc"), torch.from_numpy(data), ids, states,
                                   dtype=out_dtype)
        joutput.write_final_netcdf(str(tmp_path / "b.nc"), data, ids, states, dtype=out_dtype)
    else:
        toutput.write_dense_netcdf(str(tmp_path / "a.nc"), torch.from_numpy(dense), qt, ids,
                                   compression_level=4, dtype=out_dtype)
        joutput.write_dense_netcdf(str(tmp_path / "b.nc"), dense, qt, ids,
                                   compression_level=4, dtype=out_dtype)
    _assert_same_file(tmp_path / "a.nc", tmp_path / "b.nc")


def test_def_var_streams_a_tensor_in_slabs(tmp_path, monkeypatch):
    """A tensor larger than one slab reaches the file whole, slab by slab."""
    dense, qt, ids = _dense_case(np.float32)
    monkeypatch.setattr(tnetcdf, "SLAB_BYTES", 2 * 5 * 5 * 4)  # two systems a slab
    toutput.write_dense_netcdf(str(tmp_path / "a.nc"), torch.from_numpy(dense), qt, ids,
                               dtype=np.float64)
    joutput.write_dense_netcdf(str(tmp_path / "b.nc"), dense, qt, ids, dtype=np.float64)
    _assert_same_file(tmp_path / "a.nc", tmp_path / "b.nc")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_cf_int16_equal(dtype):
    """The codes, scales and offsets of the JAX function run op by op, each
    operation rounded once, as the port's torch ops round them."""
    from tiger_tpu.io.output import _pack_cf_int16 as j_pack

    dense, _, _ = _dense_case(dtype, s=64, n_q=9, n=6)
    dense[:, :, 3] = 0.25  # a constant state
    dense[:, :, 4] = np.nan  # an all-NaN state
    dense[:, :, 5] = np.where(dense[:, :, 5] > 1.0, 3e38, -3e38)  # huge but finite
    ours = toutput._pack_cf_int16(torch.from_numpy(dense))
    ref = j_pack(jnp.asarray(dense))
    for a, b in zip(ours, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_packed_dense_file_equal(tmp_path):
    """The JAX writer runs _pack_cf_int16 under jit, and XLA on the CPU
    compiles hi / 65532 - lo / 65532 as fma(hi, 1/65532, -(lo * 1/65532)),
    which is not the function's own arithmetic (test_pack_cf_int16_equal).
    So its scale_factor may lie one float32 ulp from the port's, and a code
    one step away; everything else in the two files is equal."""
    dense, qt, ids = _dense_case(np.float32)
    states = np.array([4, 3, 2, 1, 0], np.int32)
    toutput.write_dense_netcdf_packed(str(tmp_path / "a.nc"), torch.from_numpy(dense), qt, ids,
                                      states, compression_level=2)
    joutput.write_dense_netcdf_packed(str(tmp_path / "b.nc"), dense, qt, ids, states,
                                      compression_level=2)
    a, b = _h5_tree(tmp_path / "a.nc"), _h5_tree(tmp_path / "b.nc")
    assert a.keys() == b.keys() and a["/"] == b["/"]
    for name in b:
        if not name.startswith("outputs_"):
            continue
        sa, sb = (np.float32(t[name]["attrs"].pop("scale_factor")) for t in (a, b))
        assert abs(sa - sb) <= np.spacing(sb), name
        ca, cb = a[name].pop("values"), b[name].pop("values")
        assert ca.dtype == cb.dtype == np.int16
        assert np.array_equal(ca == -32767, cb == -32767)
        assert np.abs(ca.astype(np.int32) - cb).max() <= 1, name
        assert a[name] == b[name], name
    for name in b:
        if name != "/" and not name.startswith("outputs_"):
            assert np.array_equal(a[name].pop("values"), b[name].pop("values"))
            assert a[name] == b[name], name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csv_writers_byte_equal(tmp_path, dtype):
    dense, qt, _ = _dense_case(dtype)
    toutput.write_final_csv(str(tmp_path / "fa.csv"), torch.from_numpy(dense[:, -1]))
    joutput.write_final_csv(str(tmp_path / "fb.csv"), dense[:, -1])
    toutput.write_final_csv(str(tmp_path / "va.csv"), dense[:, 0], header="vars")
    joutput.write_final_csv(str(tmp_path / "vb.csv"), dense[:, 0], header="vars")
    toutput.write_dense_csv(str(tmp_path / "da.csv"), torch.from_numpy(dense), qt)
    joutput.write_dense_csv(str(tmp_path / "db.csv"), dense, qt)
    for a, b in (("fa", "fb"), ("va", "vb"), ("da", "db")):
        assert (tmp_path / f"{a}.csv").read_bytes() == (tmp_path / f"{b}.csv").read_bytes()


# --- state files ----------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_state_file_hot_starts_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(6)
    y = rng.uniform(0, 2, (6, 5))
    ids = np.array([70, 10, 50, 20, 60, 30])
    path = str(tmp_path / "state.nc")
    if writer == "jax":
        jckpt.save_state(path, y, ids, 1440.0)
        reader = ckpt.load_state
    else:
        ckpt.save_state(path, torch.from_numpy(y), ids, 1440.0)
        reader = jckpt.load_state
    want = np.array([30, 70, 20])  # a subset, in another order
    got, got_ids, t = reader(path, want, require_time=True)
    assert t == 1440.0 and np.array_equal(got_ids, want)
    assert np.array_equal(got, y[[5, 0, 3]])
    with pytest.raises(KeyError, match="missing links"):
        reader(path, np.array([10, 99]))
    assert not os.path.exists(path + ".tmp")


def test_state_file_equal(tmp_path):
    y = np.random.default_rng(2).uniform(0, 2, (4, 5))
    ids = np.array([4, 3, 2, 1])
    ckpt.save_state(str(tmp_path / "a.nc"), torch.from_numpy(y), ids, 60.0)
    jckpt.save_state(str(tmp_path / "b.nc"), y, ids, 60.0)
    _assert_same_file(tmp_path / "a.nc", tmp_path / "b.nc")


def test_cold_state_equal():
    assert np.array_equal(ckpt.cold_state((1.0, 2.0, 3.0), 4),
                          jckpt.cold_state((1.0, 2.0, 3.0), 4))
