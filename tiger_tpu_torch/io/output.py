"""Result writers: NetCDF (primary) and CSV (legacy/parity artifact format).

The unchunked writers of ``tiger_tpu/io/output.py``, writing the same files
for the same arrays (NETCDF4 where h5py is installed, else classic NetCDF:
``netcdf.open_writer``).  Dense output may be a torch tensor on the card:
the NetCDF writer streams it slab by slab, and the int16 packing runs on
its device.

NetCDF layouts mirror the reference (src/I_O/output_series.cpp:18-124):
  - final:  dims (system, variable); int coord vars ``system`` (LinkID,
    long_name "LinkID") and ``variable``; data var ``outputs``.
  - dense:  dims (system, time, variable); double coord ``time`` with units
    "minutes since start of simulation"; data var ``outputs``; optional
    gzip deflate.

CSV layouts match the writers that produced the reference's golden
artifacts (src/main.cpp:734-773): final header ``h_snow,var1..var4`` one row
per system; dense header ``time,var{i}_sys{s}...`` with time at fixed 8
decimals and values at 9 significant digits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tiger_tpu_torch.io.netcdf import _to_host, open_writer


def _def_output_dims(w, link_ids, query_times=None, state_ids=None):
    """Shared dimension/coordinate boilerplate of every output layout."""
    w.def_dim("system", len(link_ids), np.asarray(link_ids, np.int32), np.int32)
    w.set_dim_attrs("system", {"long_name": "LinkID"})
    if query_times is not None:
        w.def_dim("time", len(query_times), np.asarray(query_times, np.float64), np.float64)
        w.set_dim_attrs(
            "time", {"long_name": "Time", "units": "minutes since start of simulation"}
        )
    if state_ids is not None:
        w.def_dim("variable", len(state_ids), np.asarray(state_ids, np.int32), np.int32)
        w.set_dim_attrs(
            "variable", {"long_name": "state variable", "units": "various units"}
        )


def write_final_netcdf(
    path: str,
    y_final,  # [S, N] array or tensor
    link_ids: np.ndarray,  # [S]
    state_ids: Optional[np.ndarray] = None,
    compression_level: int = 0,
    dtype=None,
) -> None:
    """Final-state file: dims (system, variable).

    ``dtype=None`` preserves the input precision; pass ``np.float64`` for
    reference-identical files.
    """
    s_count, n_eq = y_final.shape
    if state_ids is None:
        state_ids = np.arange(n_eq, dtype=np.int32)
    with open_writer(path) as w:
        _def_output_dims(w, link_ids, state_ids=state_ids)
        w.def_var("outputs", y_final, ("system", "variable"), compression_level, dtype=dtype)


def write_dense_netcdf(
    path: str,
    dense,  # [S, Q, N] array or tensor
    query_times: np.ndarray,  # [Q] minutes
    link_ids: np.ndarray,  # [S]
    state_ids: Optional[np.ndarray] = None,
    compression_level: int = 0,
    dtype=None,
) -> None:
    """Dense-output file: dims (system, time, variable).

    ``dtype`` as in write_final_netcdf.  A tensor on the card is not pulled
    here; the writer streams it slab by slab.
    """
    s_count, n_q, n_eq = dense.shape
    if state_ids is None:
        state_ids = np.arange(n_eq, dtype=np.int32)
    with open_writer(path) as w:
        _def_output_dims(w, link_ids, query_times, state_ids)
        w.def_var("outputs", dense, ("system", "time", "variable"), compression_level, dtype=dtype)


def _pack_cf_int16(dense: torch.Tensor):
    """CF quantization on the tensor's device: per-state int16 codes + f32
    scale/offset, the JAX package's codes exactly.

    Non-finite samples map to the CF fill value -32767; codes use the
    symmetric range [-32766, 32766].  Every division is by a tensor: on the
    card torch turns a division by a Python number into a product with its
    reciprocal, which would round otherwise than XLA.
    """
    x = dense.to(torch.float32)
    dev = x.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    finite = torch.isfinite(x)
    big = f32(3.4e38)
    lo = torch.where(finite, x, big).amin(dim=(0, 1))
    hi = torch.where(finite, x, -big).amax(dim=(0, 1))
    lo, hi = torch.minimum(lo, hi), torch.maximum(lo, hi)  # all-NaN state: lo>hi
    # Divide before subtracting: hi-lo overflows float32 to inf when a state
    # spans huge-but-finite magnitudes; hi/65532 - lo/65532 cannot.
    n_codes = f32(65532.0)
    scale = torch.maximum(hi / n_codes - lo / n_codes, f32(1e-30))
    offset = hi * 0.5 + lo * 0.5
    q = torch.clamp(torch.round((x - offset) / scale), -32766.0, 32766.0)
    q = torch.where(finite, q.to(torch.int16), torch.tensor(-32767, dtype=torch.int16, device=dev))
    return q, scale, offset


def write_dense_netcdf_packed(
    path: str,
    dense,  # [S, Q, N] tensor (on the card welcome) or array
    query_times: np.ndarray,  # [Q] minutes
    link_ids: np.ndarray,  # [S]
    state_ids: Optional[np.ndarray] = None,
    compression_level: int = 0,
) -> None:
    """CF int16-packed dense output (``output.precision: i16``).

    scale_factor/add_offset/_FillValue per variable, as ERA5 files carry
    them; since a NetCDF scale is a scalar per variable and the states'
    ranges differ by orders of magnitude, each state is its own var
    ``outputs_<state_id>`` with dims (system, time).  Quantized on the
    dense tensor's device, so the host pull moves 2 bytes a sample.
    """
    s_count, n_q, n_eq = dense.shape
    if state_ids is None:
        state_ids = np.arange(n_eq, dtype=np.int32)
    if not torch.is_tensor(dense):
        dense = torch.as_tensor(np.asarray(dense))
    q, scale, offset = _pack_cf_int16(dense)
    scale = scale.cpu().numpy().astype(np.float64)
    offset = offset.cpu().numpy().astype(np.float64)
    with open_writer(path) as w:
        _def_output_dims(w, link_ids, query_times)
        for v in range(n_eq):
            w.def_var(
                f"outputs_{int(state_ids[v])}",
                q[:, :, v],
                ("system", "time"),
                compression_level,
                attrs={
                    "scale_factor": scale[v],
                    "add_offset": offset[v],
                    "_FillValue": np.int16(-32767),
                    "long_name": f"state variable {int(state_ids[v])}",
                    "units": "various units",
                },
            )


def write_final_csv(path: str, y_final, header: str = "model204") -> None:
    """Legacy final CSV (main.cpp:736-752).  header='model204' -> h_snow,var1..;
    header='vars' -> Var0..Var4 (dummy artifacts)."""
    y_final = _to_host(y_final)
    n_eq = y_final.shape[1]
    if header == "model204":
        cols = ["h_snow"] + [f"var{i}" for i in range(1, n_eq)]
    else:
        cols = [f"Var{i}" for i in range(n_eq)]
    fmt = "{:.6g}".format  # std::ostream default formatting: 6 significant digits
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for row in y_final.tolist():
            f.write(",".join(map(fmt, row)) + "\n")


def write_dense_csv(
    path: str,
    dense,  # [S, Q, N] array or tensor
    query_times: np.ndarray,
    var_prefix: str = "var",
) -> None:
    """Legacy dense CSV (main.cpp:755-773): time fixed 8 decimals, values 9
    significant digits; one row per query time, one column per system and
    state, system-major."""
    dense = _to_host(dense)
    s_count, n_q, n_eq = dense.shape
    fmt = "{:.9g}".format
    with open(path, "w") as f:
        cols = ["time"] + [
            f"{var_prefix}{i}_sys{s}" for s in range(s_count) for i in range(n_eq)
        ]
        f.write(",".join(cols) + "\n")
        for q in range(n_q):
            # tolist() gives Python floats of the same values, formatted as
            # numpy's scalars format themselves.
            parts = [f"{query_times[q]:.8f}"]
            parts.extend(map(fmt, dense[:, q, :].ravel().tolist()))
            f.write(",".join(parts) + "\n")
