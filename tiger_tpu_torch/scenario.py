"""The synthetic Model-204 basin of the benchmarks, on a given device or on disk.

Port of ``__graft_entry__.py::_scenario``: the same numpy RNG calls in the
same order from ``default_rng(0)``, so the arrays are bit-identical to the
JAX version's; only the final conversion differs (torch tensors on
``device``).  ``write_basin`` writes the same basin as the files a CLI run
reads (parameter CSV, lookup CSV, classic NetCDF forcing grids) and returns
its config document.
"""

from __future__ import annotations

import datetime as _dt
import os

import numpy as np
import torch

from tiger_tpu_torch.forcing import ForcingSet
from tiger_tpu_torch.models.model204 import Y0_COMMON

#: Static-storage capacity Hu [m] of the stiff systems: ET drains h_static
#: at ~0.1*T/Hu per minute, a stable timescale far below RK45's reach.
STIFF_HU = 1e-6


def scenario_arrays(s_count: int, days: float = 2.0, stiff_frac: float = 0.0):
    """(params, [rainfall, temperature], dt_minutes) as numpy arrays.

    ``stiff_frac`` of the systems (spread evenly) get Hu = STIFF_HU and a
    strictly positive temperature, which makes them genuinely stiff; the
    forcing record covers ``days``.
    """
    rng = np.random.default_rng(0)
    base = dict(
        c1=0.001 / 60.0,
        infil=0.0001 * (0.001 / 60.0),
        perco=0.00005 * (0.001 / 60.0),
        Hu=0.5,
        lat=41.5,
        sw=0.2,
        ss=0.8,
        n_mann=0.03,
        slope=0.05,
        L=1.0,
        A_h=10.0,
        alpha3=2880.0,
        alpha4=7200.0,
        melt_f=1e-5,
        temp_thr=0.0,
    )
    params = {
        k: np.full(s_count, v) * rng.uniform(0.8, 1.2, s_count) for k, v in base.items()
    }
    n_stiff = int(round(s_count * stiff_frac))
    rows = np.linspace(0, s_count - 1, n_stiff).astype(np.int64) if n_stiff else None
    if n_stiff:
        params["Hu"][rows] = STIFF_HU
    n_hours = max(int(np.ceil(days * 24.0)), 1)
    n_days = max(int(np.ceil(days)), 1)
    pr = rng.uniform(0, 0.0015, (n_hours, s_count)).astype(np.float32)
    t2m = rng.uniform(-2.0, 10.0, (n_days, s_count)).astype(np.float32)
    if n_stiff:
        t2m[:, rows] = rng.uniform(2.0, 10.0, (n_days, n_stiff))
    return params, [pr, t2m], [60.0, 1440.0]


def scenario(
    s_count: int,
    days: float = 2.0,
    stiff_frac: float = 0.0,
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.float32,
):
    """(y0 [S, 5], params dict of [S], ForcingSet) on ``device``.

    States and params are in ``dtype``; the packed forcing is float32.
    """
    params_np, series, dt = scenario_arrays(s_count, days, stiff_frac)
    params = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in params_np.items()}
    forcings = ForcingSet.from_series(series, dt, device=device)
    y0 = torch.tensor(Y0_COMMON, dtype=dtype, device=device).repeat(s_count, 1)
    return y0, params, forcings


#: Column order of the reference's parameter CSV (small_test.csv).
BASIN_CSV_COLUMNS = (
    "stream", "next_stream", "drainage_area_km2", "length_km", "area_sqkm", "centroid_lon",
    "centroid_lat", "hu", "i2", "i3", "sw", "ss", "n", "slope", "res_ss", "res_gw",
    "melt", "t_thres",
)


def write_basin(
    folder: str,
    s_count: int,
    days: float = 2.0,
    stiff_frac: float = 0.0,
    n_lon: int = 512,
) -> dict:
    """Write ``scenario_arrays``' basin as CLI input files into ``folder``;
    return the config document (``config.config_from_dict`` takes it).

    - ``params.csv``: the parameters mapped back through
      ``params.from_columns``' transforms into the reference schema
      (``%.17g``; ``c1`` is a constant of the loader, so its draw is lost);
      link i (id i + 1) drains into link (i - 1) // 2, a binary tree whose
      depth grows with log2(S), and link 0 is the outlet;
    - ``pr.nc`` (hourly) and ``t2m.nc`` (daily): classic NetCDF grids of
      ceil(S / n_lon) x n_lon cells, one cell per link, which hold the
      scenario's series (cells past the last link are 0);
    - ``lookup.csv``: each link's cell.

    The config runs Model 204 in float32 at rtol 1e-5 / atol 1e-8 over
    ``days`` from 2019-01-01 with hourly output and routed discharge, and
    names the forcing files relative to the folder.
    """
    from tiger_tpu_torch.io.netcdf import ClassicNetCDFWriter, write_grid_forcing
    from tiger_tpu_torch.params import C1

    p, (pr, t2m), _ = scenario_arrays(s_count, days, stiff_frac)
    rows = np.arange(s_count)
    cols = {
        "stream": rows + 1,
        "next_stream": np.where(rows > 0, (rows - 1) // 2 + 1, -1),
        "drainage_area_km2": p["A_h"],
        "length_km": p["L"],
        "area_sqkm": np.zeros(s_count),
        "centroid_lon": np.zeros(s_count),
        "centroid_lat": p["lat"],
        "hu": p["Hu"],
        "i2": p["infil"] / C1,
        "i3": p["perco"] / C1,
        "sw": p["sw"],
        "ss": p["ss"],
        "n": p["n_mann"],
        "slope": p["slope"],
        "res_ss": p["alpha3"] / 1440.0,
        "res_gw": p["alpha4"] / 1440.0,
        "melt": p["melt_f"],
        "t_thres": p["temp_thr"],
    }
    os.makedirs(folder, exist_ok=True)
    np.savetxt(
        os.path.join(folder, "params.csv"),
        np.stack([np.asarray(cols[c], np.float64) for c in BASIN_CSV_COLUMNS], axis=1),
        fmt="%.17g", delimiter=",", header=",".join(BASIN_CSV_COLUMNS), comments="",
    )
    n_lat = -(-s_count // n_lon)
    lat_idx, lon_idx = rows // n_lon, rows % n_lon
    np.savetxt(
        os.path.join(folder, "lookup.csv"), np.stack([rows + 1, lat_idx, lon_idx], axis=1),
        fmt="%d", delimiter=",", header="stream,lat_index,lon_index", comments="",
    )
    for name, series, dt_hours in (("pr", pr, 1.0), ("t2m", t2m, 24.0)):
        grid = np.zeros((series.shape[0], n_lat * n_lon), np.float32)
        grid[:, :s_count] = series
        write_grid_forcing(
            os.path.join(folder, f"{name}.nc"), name, grid.reshape(-1, n_lat, n_lon),
            time_vals=np.arange(series.shape[0]) * dt_hours,
            time_attrs={"units": "hours since 2019-01-01 00:00:00"},
            writer=ClassicNetCDFWriter,
        )
    start = _dt.datetime(2019, 1, 1)
    return {
        "model": {"uid": 204, "name": "Model204"},
        "time": {"start": start.isoformat(),
                 "end": (start + _dt.timedelta(days=days)).isoformat()},
        "initial": {"mode": "cold"},
        "local_params": {"file": os.path.join(folder, "params.csv")},
        "forcings": {
            "type": "folder_nc",
            "path": folder,
            "lookup": os.path.join(folder, "lookup.csv"),
            "files": [
                {"file": "pr.nc", "var": "pr", "dt_hours": 1.0},
                {"file": "t2m.nc", "var": "t2m", "dt_hours": 24.0},
            ],
        },
        "output": {
            "print_interval": "1h",
            "path": os.path.join(folder, "out"),
            "prefix": "basin",
            "routed_discharge": True,
        },
        "solver": {
            "method": "RK45",
            "tolerances": {"rtol": 1e-5, "atol": 1e-8},
            "precision": "f32",
        },
    }


def solve_written_basin(cfg, device: torch.device | str):
    """The direct path a CLI run of ``write_basin``'s files is held against:
    the port's loaders and ``solve()`` with the config's model (the start
    date's day of year as ``doy0``) from ``run``'s cold state, without
    ``run``'s glue.

    Returns (SolveResult, params dict of [S] tensors, the loaded spatial
    parameters).  On the card ``solve()`` is deterministic, so the run's
    dense and final outputs must equal this result bit for bit.
    """
    from tiger_tpu_torch.checkpoint import cold_state
    from tiger_tpu_torch.forcing import ForcingSpec, load_forcings
    from tiger_tpu_torch.models import get_model
    from tiger_tpu_torch.params import load_spatial_params, model_params
    from tiger_tpu_torch.run import COLD_STATE_DEFAULTS
    from tiger_tpu_torch.solver import solve

    dtype = torch.float64 if cfg.solver.precision == "f64" else torch.float32
    sp = load_spatial_params(cfg.params_file)
    params = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in model_params(sp).items()}
    folder = cfg.forcings.path
    specs = [ForcingSpec(os.path.join(folder, f["file"]), f["var"], float(f["dt_hours"]))
             for f in cfg.forcings.files]
    tf = cfg.time.duration_minutes
    forcings = load_forcings(specs, sp["stream"], cfg.forcings.lookup,
                             duration_days=tf / 1440.0, device=device)
    model = get_model(cfg.model.uid, doy0=float(cfg.time.start.timetuple().tm_yday))
    cold = COLD_STATE_DEFAULTS.get(cfg.model.uid, (0.0,) * model.N_EQ)
    y0 = torch.as_tensor(cold_state(cold, len(sp["stream"])), device=device).to(dtype)
    qt = torch.as_tensor(np.arange(0.0, tf + 1e-9, 60.0), device=device).to(dtype)
    res = solve(model, y0, 0.0, tf, qt, params, forcings, cfg.solver_config())
    return res, params, sp
