"""Checkpoint / hot-start support.

A copy of ``tiger_tpu/checkpoint.py``: where h5py is installed the files
are the same NETCDF4 files, so a state file written by either package
hot-starts the other.  Cold start = one
per-variable y0 vector broadcast over the systems; hot start = the full
[S, N] state restored from a state file.

State files use the final-state NetCDF layout (system, variable) plus a
``sim_time_minutes`` attribute, so a run's final output can be fed back as the
next run's hot start.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from tiger_tpu_torch.io.netcdf import _to_host, open_writer, read_netcdf
from tiger_tpu_torch.io.output import _def_output_dims


def save_state(path: str, y, link_ids: np.ndarray, sim_time_minutes: float) -> None:
    """Write a hot-start/checkpoint state file atomically.

    Written to a sibling temp file, flushed to disk, then ``os.replace``d
    over the target, so a crash mid-write never destroys the previous
    state file.  ``y`` may be an array or a tensor on any device.  NETCDF4
    where h5py is installed (the JAX package's file), else classic NetCDF
    (``io.netcdf.open_writer``), which only this package's ``load_state``
    reads.
    """
    y = _to_host(y)
    tmp = path + ".tmp"
    with open_writer(tmp) as w:
        _def_output_dims(w, link_ids, state_ids=np.arange(y.shape[1], dtype=np.int32))
        w.def_var("outputs", y, ("system", "variable"))
        w.set_attr("sim_time_minutes", float(sim_time_minutes))
    # fsync the data before the rename: the rename can become durable while
    # the contents are still in the page cache.
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


def load_state(
    path: str, link_ids: Optional[np.ndarray] = None, require_time: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Read (y [S, N], link_ids [S], sim_time_minutes) from a state file
    (NETCDF4 or classic).

    If ``link_ids`` is given, rows are re-ordered to match it (a hot start may
    use a subset or permutation of the checkpointed basin); missing links
    raise.  ``require_time``: a file without the sim_time_minutes attribute
    is not a resumable checkpoint (e.g. a plain final_*.nc), so raise.
    """
    data, attrs = read_netcdf(path, ("outputs", "system"))
    y = np.asarray(data["outputs"], np.float64)
    ids = np.asarray(data["system"], np.int64)
    if require_time and "sim_time_minutes" not in attrs:
        raise ValueError(
            f"{path} has no sim_time_minutes attribute — it is a plain "
            "state/final file, not a resumable checkpoint"
        )
    t = float(attrs.get("sim_time_minutes", 0.0))
    if link_ids is not None:
        link_ids = np.asarray(link_ids, np.int64)
        order = np.argsort(ids, kind="stable")
        pos = np.searchsorted(ids[order], link_ids)
        pos = np.clip(pos, 0, len(ids) - 1)
        found = ids[order][pos] == link_ids
        if not found.all():
            raise KeyError(f"Hot-start file missing links: {link_ids[~found][:10]}")
        y = y[order][pos]
        ids = link_ids
    return y, ids, t


def cold_state(y0_common, num_systems: int) -> np.ndarray:
    """Broadcast a per-variable cold-start vector over the basin."""
    y0 = np.asarray(y0_common, np.float64)
    return np.tile(y0, (num_systems, 1))
