"""Spatial parameters: SoA loader for the per-link parameter table.

A copy of ``tiger_tpu/params.py`` (numpy only), so that the port imports no
jax.  The table is a structure-of-arrays: a dict of [S] float64/int64 numpy
arrays, one contiguous vector per field; ``run`` moves the float fields to
the device.  The header-indexed CSV goes through the native C++ parser
(``tiger_tpu_torch.native``) and through numpy where that is unavailable.

Unit conversions (parameters_loader.cpp:57-101):
  - c1 = 0.001/60 stored per row  [mm/hr -> m/min conversion constant]
  - infil = i2 * c1, perco = i3 * c1           [m/min]
  - alpha3 = res_ss * 1440, alpha4 = res_gw * 1440  [days -> minutes]
  - everything else copied as-is; ``area_sqkm``/``centroid_lon`` columns are
    present in the data files but ignored, like the reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

C1 = 0.001 / 60.0  # mm/hr -> m/min (parameters_loader.cpp:57)

#: CSV column -> (field, transform) mapping.
REQUIRED_COLUMNS = (
    "stream",
    "next_stream",
    "i2",
    "i3",
    "hu",
    "centroid_lat",
    "sw",
    "ss",
    "n",
    "slope",
    "length_km",
    "drainage_area_km2",
    "melt",
    "t_thres",
    "res_ss",
    "res_gw",
)

#: Float fields of the SoA (model-facing; see models.model204.PARAM_FIELDS).
FLOAT_FIELDS = (
    "c1",
    "infil",
    "perco",
    "Hu",
    "lat",
    "sw",
    "ss",
    "n_mann",
    "slope",
    "L",
    "A_h",
    "alpha3",
    "alpha4",
    "melt_f",
    "temp_thr",
)

SpatialParams = Dict[str, np.ndarray]


def from_columns(cols: Dict[str, np.ndarray]) -> SpatialParams:
    """Build the SoA from raw CSV columns (named as in the file)."""
    missing = [c for c in REQUIRED_COLUMNS if c not in cols]
    if missing:
        raise ValueError(f"Missing parameter columns: {missing}")
    f64 = lambda name: np.asarray(cols[name], np.float64)
    n = len(cols["stream"])
    return {
        "stream": np.asarray(cols["stream"], np.int64),
        "next_stream": np.asarray(cols["next_stream"], np.int64),
        "c1": np.full(n, C1),
        "infil": f64("i2") * C1,
        "perco": f64("i3") * C1,
        "Hu": f64("hu"),
        "lat": f64("centroid_lat"),
        "sw": f64("sw"),
        "ss": f64("ss"),
        "n_mann": f64("n"),
        "slope": f64("slope"),
        "L": f64("length_km"),
        "A_h": f64("drainage_area_km2"),
        "alpha3": f64("res_ss") * 24.0 * 60.0,
        "alpha4": f64("res_gw") * 24.0 * 60.0,
        "melt_f": f64("melt"),
        "temp_thr": f64("t_thres"),
    }


#: Canonical physics-column order of the reference CSV schema after the two id
#: columns (data/small_test.csv header; parameters_loader.cpp:35-101).  Used
#: by the positional ``local_params.columns`` mode.
POSITIONAL_ORDER = (
    "drainage_area_km2", "length_km", "area_sqkm", "centroid_lon",
    "centroid_lat", "hu", "i2", "i3", "sw", "ss", "n", "slope",
    "res_ss", "res_gw", "melt", "t_thres",
)
#: Columns that exist in the schema but are never read (SURVEY.md 2.5).
_UNUSED_COLUMNS = ("area_sqkm", "centroid_lon")


def load_spatial_params(csv_path: str, columns: dict | None = None) -> SpatialParams:
    """Load the per-link parameter CSV.

    Default: header-indexed, any column order (loadSpatialParams,
    parameters_loader.cpp:8-107).  With ``columns`` (the config schema's
    ``local_params.columns``: stream_id / next_stream_id / params_start /
    num_params, data/config.yaml:27-31) the file is read POSITIONALLY: ids
    from the two given column indices, then ``num_params`` physics columns
    starting at ``params_start`` in the canonical reference order
    (POSITIONAL_ORDER); trailing columns beyond num_params default to 0.
    """
    if columns is not None:
        return _load_positional(csv_path, columns)
    try:
        from tiger_tpu_torch.native import load_csv_columns

        cols = load_csv_columns(csv_path, REQUIRED_COLUMNS)
    except (ImportError, ValueError, OSError):
        # No native library, or a file the strict parser refuses (a BOM, a
        # padded header): numpy reads it, or raises the error users see.
        cols = _load_csv_numpy(csv_path)
    return from_columns(cols)


def _load_positional(csv_path: str, columns: dict) -> SpatialParams:
    # ``has_header`` in local_params.columns makes the header question
    # explicit; without it, sniff (a numeric-looking first cell means no
    # header — ambiguous for headerless rows starting with an empty field
    # or headers of numeric labels, hence the explicit override).
    if "has_header" in columns:
        skip = 1 if columns["has_header"] else 0
    else:
        with open(csv_path, encoding="utf-8-sig") as f:
            first = f.readline()
        try:
            float(first.split(",")[0])
            skip = 0
        except ValueError:
            skip = 1
    data = np.loadtxt(csv_path, delimiter=",", skiprows=skip, ndmin=2)
    start = int(columns.get("params_start", 2))
    n_par = int(columns.get("num_params", len(POSITIONAL_ORDER)))
    if n_par > len(POSITIONAL_ORDER):
        raise ValueError(
            f"num_params={n_par} exceeds the {len(POSITIONAL_ORDER)}-column "
            f"reference schema ({POSITIONAL_ORDER})"
        )
    if start + n_par > data.shape[1]:
        raise ValueError(
            f"{csv_path}: needs columns [{start}, {start + n_par}) but rows "
            f"have only {data.shape[1]} fields"
        )
    cols = {
        "stream": data[:, int(columns.get("stream_id", 0))],
        "next_stream": data[:, int(columns.get("next_stream_id", 1))],
    }
    for k, name in enumerate(POSITIONAL_ORDER):
        if k < n_par:
            cols[name] = data[:, start + k]
        elif name not in _UNUSED_COLUMNS:
            cols[name] = np.zeros(data.shape[0])
    return from_columns(cols)


def _load_csv_numpy(csv_path: str) -> Dict[str, np.ndarray]:
    # utf-8-sig + per-name strip: a BOM or ", "-separated header would
    # otherwise report present columns as missing.
    with open(csv_path, encoding="utf-8-sig") as f:
        header = [h.strip() for h in f.readline().strip().split(",")]
    data = np.loadtxt(csv_path, delimiter=",", skiprows=1, ndmin=2)
    if data.shape[1] < len(header):
        raise ValueError(f"Bad row width in {csv_path}")
    return {name: data[:, i] for i, name in enumerate(header)}


def num_systems(params: SpatialParams) -> int:
    return len(params["stream"])


def slice_rows(params: SpatialParams, idx) -> SpatialParams:
    """Row-subset the SoA."""
    return {k: v[idx] for k, v in params.items()}


def model_params(params: SpatialParams) -> Dict[str, np.ndarray]:
    """The float fields the model RHS consumes (drops the id columns)."""
    return {k: params[k] for k in FLOAT_FIELDS}
