"""Forcing: NetCDF grids -> lookup remap -> packed series + zero-order hold.

Port of ``tiger_tpu/forcing.py``.  The packed tensor is [T_total, S] float32
(time-major blocks concatenated on axis 0, the system index innermost), and
``ForcingMeta`` describes the blocks.  Forcing values are sampled once per
attempted step at the step-start time and held across all stages.

The file half (``discover_forcings``, ``load_forcings``) reads the gridded
NetCDF variables on the host, checks the lookup against each grid there, and
ships only the grids to the device, where ``ForcingSet.from_grid_series``
gathers each system's cell with ``index_select``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class ForcingMeta(NamedTuple):
    """Description of the packed forcing blocks."""

    offsets: tuple[int, ...]  # start row of each forcing block
    n_steps: tuple[int, ...]  # number of time steps per forcing
    dt_min: tuple[float, ...]  # minutes per time step


@dataclasses.dataclass(frozen=True)
class ForcingSet:
    """Packed forcing data [T_total, S] (float32) plus its metadata.

    ``data[offsets[j] + k, s]`` is forcing j at time-step k for system s.
    """

    data: torch.Tensor  # [T_total, S] float32
    meta: ForcingMeta

    @property
    def num_systems(self) -> int:
        return self.data.shape[1]

    @staticmethod
    def from_series(
        series: Sequence[np.ndarray],
        dt_minutes: Sequence[float],
        device: torch.device | str = "cuda",
    ) -> "ForcingSet":
        """Build from per-forcing arrays shaped [T_j, S], on ``device``: the
        card unless the caller asks for another (``device="cpu"``)."""
        if len(series) != len(dt_minutes):
            raise ValueError("series and dt_minutes must have equal length")
        offsets, n_steps = [], []
        row = 0
        for arr in series:
            offsets.append(row)
            n_steps.append(arr.shape[0])
            row += arr.shape[0]
        data = np.concatenate([np.asarray(a, np.float32) for a in series], axis=0)
        meta = ForcingMeta(
            tuple(offsets), tuple(n_steps), tuple(float(d) for d in dt_minutes)
        )
        return ForcingSet(data=torch.as_tensor(data, device=device), meta=meta)

    @staticmethod
    def from_grid_series(
        grids: Sequence,  # [T_j, n_cells] flat grids (arrays or tensors)
        flat_index,  # [S] cell index per system, or one such per grid
        dt_minutes: Sequence[float],
        device: torch.device | str = "cuda",
    ) -> "ForcingSet":
        """Build by remapping flat grids onto systems on ``device``.

        Only the grids (n_cells values per step) cross to the device; the
        [T, S] per-system layout is gathered there.  Values are bit-equal to
        ``from_series(remap_grid_to_systems(...))``.  Every index is checked
        against its grid on the host first: an out-of-range ``index_select``
        on the card is a device-side assert that ends the CUDA context.
        """
        if len(grids) != len(dt_minutes):
            raise ValueError("grids and dt_minutes must have equal length")
        if isinstance(flat_index, (list, tuple)):
            flats = tuple(flat_index)
        else:
            flats = (flat_index,) * len(grids)
        offsets, n_steps, blocks = [], [], []
        row = 0
        for g, f in zip(grids, flats):
            offsets.append(row)
            n_steps.append(g.shape[0])
            row += g.shape[0]
            f_host = f.cpu().numpy() if torch.is_tensor(f) else np.asarray(f)
            _check_flat_bounds(f_host, int(np.prod(g.shape[1:])), None)
            g = torch.as_tensor(g, dtype=torch.float32, device=device)
            idx = torch.as_tensor(f_host, dtype=torch.int64, device=device)
            blocks.append(g.reshape(g.shape[0], -1).index_select(1, idx))
        meta = ForcingMeta(
            tuple(offsets), tuple(n_steps), tuple(float(d) for d in dt_minutes)
        )
        return ForcingSet(data=torch.cat(blocks, dim=0), meta=meta)

    def take_systems(self, rows: torch.Tensor) -> "ForcingSet":
        """The forcing columns of the systems ``rows`` (same metadata)."""
        return ForcingSet(data=self.data[:, rows].contiguous(), meta=self.meta)


def _check_flat_bounds(flat: np.ndarray, n_cells: int, spec) -> None:
    """Fail loudly on lookup rows outside the forcing grid, on the host,
    before any device gather."""
    if len(flat) and (flat.min() < 0 or flat.max() >= n_cells):
        bad = int((np.asarray(flat) >= n_cells).sum() + (np.asarray(flat) < 0).sum())
        raise ValueError(
            f"lookup maps {bad} system(s) outside the {n_cells}-cell grid of "
            f"{getattr(spec, 'var', '?')} ({getattr(spec, 'path', '?')}); "
            "check lat_index/lon_index against the forcing file dimensions"
        )


def _check_remap_finite(chunk: np.ndarray, flat: np.ndarray, spec) -> None:
    """Reject lookups that map systems onto missing cells (NaN after fill
    handling, e.g. ocean cells or a missing hour mid-record): NaN forcing
    would otherwise poison every trajectory on the cell."""
    flat = np.asarray(flat)
    grid2d = chunk.reshape(chunk.shape[0], -1)
    bad = np.isnan(grid2d).any(axis=0)[flat]
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} system(s) map to missing ({np.nan}) cells of "
            f"{getattr(spec, 'var', '?')} ({getattr(spec, 'path', '?')}); "
            "fix the lookup or fill the forcing file"
        )


#: Relative gather-index snap used when SolverConfig.forcing_step_align is
#: on: sample index = floor(t/dt + ZOH_SNAP), so a system whose float32 time
#: landed an ulp below the boundary its aligned step targeted still reads the
#: new sample.
ZOH_SNAP = 5e-4


def _true_div(t: torch.Tensor, dt: float) -> torch.Tensor:
    """``t / dt`` rounded as one IEEE division, as the CUDA kernels divide.

    On a CUDA tensor torch turns a division by a Python number into a
    multiplication by its reciprocal, which is an ulp off for most t; where
    t/dt + snap lies within that ulp of an integer, the gather would read
    the neighbouring sample and the step cap would aim at the neighbouring
    boundary.  Dividing by a tensor keeps the division.
    """
    return t / torch.full((), dt, dtype=t.dtype, device=t.device)


def _sample_index(t: torch.Tensor, n_t: int, dt: float, snap: float) -> torch.Tensor:
    """The ZOH sample a gather at ``t`` reads: floor(t / dt + snap) in [0, n_t - 1]."""
    return torch.clamp(torch.floor(_true_div(t, dt) + snap).to(torch.int64), 0, n_t - 1)


def forcing_index_changed(meta: ForcingMeta, t_a: torch.Tensor, t_b: torch.Tensor,
                          snap: float = 0.0) -> torch.Tensor:
    """[S] bool: a gather at ``t_b`` reads another sample of some forcing
    than a gather at ``t_a`` (RK45's FSAL carry is stale there)."""
    out = torch.zeros(t_a.shape, dtype=torch.bool, device=t_a.device)
    for n_t, dt in zip(meta.n_steps, meta.dt_min):
        out = out | (_sample_index(t_a, n_t, dt, snap) != _sample_index(t_b, n_t, dt, snap))
    return out


def gather_forcings_column(
    data: torch.Tensor, meta: ForcingMeta, t, snap: float = 0.0
) -> tuple:
    """Zero-order-hold gather at time ``t`` [min]: one tensor per forcing.

    ``data`` is [T_total, S].  With a scalar ``t`` each forcing is the row
    [S] of the sample at t; with ``t`` of shape [S] each system reads its own
    sample.  Index = floor(t / dt + snap) clamped to [0, nT - 1].
    """
    if not torch.is_tensor(t):
        t = torch.tensor(float(t), dtype=torch.float64, device=data.device)
    vals = []
    for off, n_t, dt in zip(meta.offsets, meta.n_steps, meta.dt_min):
        idx = _sample_index(t, n_t, dt, snap)
        if idx.ndim == 0:
            vals.append(data[off + idx])
        else:
            vals.append(torch.gather(data, 0, (off + idx)[None, :])[0])
    return tuple(vals)


def zoh_step_cap(meta: ForcingMeta, t: torch.Tensor, h_eff: torch.Tensor) -> torch.Tensor:
    """Clamp ``h_eff`` so the step from ``t`` lands on (never across) the
    next ZOH forcing-sample boundary, with the gather's snapped index.
    Boundaries exist only inside each record: past its last sample the ZOH
    clamps and nothing caps the step."""
    inf = torch.full((), float("inf"), dtype=h_eff.dtype, device=h_eff.device)
    for n_t, dt in sorted(set(zip(meta.n_steps, meta.dt_min))):
        k = torch.floor(_true_div(t, dt) + ZOH_SNAP)
        nb = (k + 1.0) * dt - t
        nb = torch.where(k + 1.0 >= n_t, inf, nb.to(h_eff.dtype))
        h_eff = torch.minimum(h_eff, nb)
    return h_eff


@dataclasses.dataclass(frozen=True)
class ForcingSpec:
    """One gridded forcing source (reference NCForcing, main.cpp:508-515).

    ``lookup``: optional per-forcing remap CSV (grids may differ in
    resolution); None uses the run-level lookup.
    """

    path: str
    var: str
    dt_hours: float  # hours per time step (converted to minutes at pack time)
    lookup: Optional[str] = None


def _units_to_hours(units: str) -> Optional[float]:
    """CF time-units string -> hours per unit ('hours since ...' -> 1.0)."""
    head = units.strip().lower().split()[0] if units else ""
    return {
        "seconds": 1.0 / 3600.0, "second": 1.0 / 3600.0, "s": 1.0 / 3600.0,
        "minutes": 1.0 / 60.0, "minute": 1.0 / 60.0, "min": 1.0 / 60.0,
        "hours": 1.0, "hour": 1.0, "h": 1.0, "hrs": 1.0,
        "days": 24.0, "day": 24.0, "d": 24.0,
    }.get(head)


def discover_forcings(folder: str, var_names: Sequence[str]) -> list:
    """``forcings.type: folder_nc`` discovery: scan ``folder`` for NetCDF files
    holding each variable in ``var_names``; infer dt from the time coordinate.

    Returns ForcingSpec list in ``var_names`` order.  Raises with a pointer
    to the explicit ``files:`` form when a variable is missing, found twice,
    or its time coordinate has no usable units.
    """
    import glob as _glob
    import os

    from tiger_tpu_torch.io.netcdf import NetCDFReader

    candidates = sorted(
        _glob.glob(os.path.join(folder, "*.nc"))
        + _glob.glob(os.path.join(folder, "*.nc4"))
    )
    # One open per (file, var) pair.
    found: dict = {v: [] for v in var_names}
    for path in candidates:
        for var in var_names:
            try:
                rd = NetCDFReader(path, var)
            except (KeyError, ValueError, OSError):
                continue
            with rd:
                tvals, units = rd.time_info()
            found[var].append((path, tvals, units))
    specs = []
    for var in var_names:
        hits = found[var]
        if not hits:
            raise FileNotFoundError(
                f"forcings.type folder_nc: no NetCDF file in {folder!r} has a "
                f"3-D variable {var!r}; list sources explicitly under "
                "forcings.files instead"
            )
        if len(hits) > 1:
            raise ValueError(
                f"forcings.type folder_nc: variable {var!r} found in multiple "
                f"files ({[h[0] for h in hits]}); disambiguate with "
                "forcings.files"
            )
        path, tvals, units = hits[0]
        per_unit = _units_to_hours(units) if units else None
        if tvals is None or len(tvals) < 2 or per_unit is None:
            raise ValueError(
                f"Cannot infer time step for {var!r} in {path}: time "
                f"coordinate/units missing or unparseable ({units!r}); set "
                "dt_hours explicitly under forcings.files"
            )
        steps = np.diff(np.asarray(tvals, np.float64))
        if steps.min() <= 0 or not np.allclose(steps, steps[0], rtol=1e-6):
            raise ValueError(
                f"Non-uniform time coordinate for {var!r} in {path}; "
                "zero-order-hold forcing needs a constant step"
            )
        specs.append(ForcingSpec(path=path, var=var, dt_hours=float(steps[0] * per_unit)))
    return specs


def load_forcings(
    specs: Sequence[ForcingSpec],
    stream_ids: np.ndarray,
    lookup_csv: str,
    start_step: int = 0,
    duration_days: Optional[float] = None,
    device: torch.device | str = "cuda",
) -> ForcingSet:
    """NetCDF grids -> lookup remap -> packed ForcingSet on ``device``.

    The lookup CSV maps stream id -> (lat_idx, lon_idx); each forcing
    contributes ceil(duration_days*24/dt_hours) steps (capped at the file's
    length); ``duration_days=None`` loads the whole file.
    """
    from tiger_tpu_torch.io.lookup import LookupTable
    from tiger_tpu_torch.io.netcdf import NetCDFReader

    luts = {
        p: LookupTable.load(p)
        for p in {spec.lookup or lookup_csv for spec in specs}
    }
    grids, flats, dt_minutes = [], [], []
    for spec in specs:
        lut = luts[spec.lookup or lookup_csv]
        with NetCDFReader(spec.path, spec.var) as rd:
            if duration_days is None:
                n_steps = rd.time_size - start_step
            else:
                # ceil: a span that is not a whole multiple of dt still needs
                # the partially covered step.
                n_steps = int(np.ceil(duration_days * 24.0 / spec.dt_hours - 1e-9))
                n_steps = min(n_steps, rd.time_size - start_step)
            flat = lut.flat_index(np.asarray(stream_ids), rd.lon_size)
            chunk = rd.load_time_chunk(start_step, n_steps)
            _check_flat_bounds(flat, chunk.shape[1] * chunk.shape[2], spec)
            _check_remap_finite(chunk, flat, spec)
            flats.append(flat)
            grids.append(chunk.reshape(chunk.shape[0], -1))
            dt_minutes.append(spec.dt_hours * 60.0)
    return ForcingSet.from_grid_series(grids, flats, dt_minutes, device=device)


def remap_grid_to_systems(grid_chunk: np.ndarray, flat_index: np.ndarray) -> np.ndarray:
    """Host lookup remap: [T, lat, lon] grid -> [T, S] per-system series.

    ``flat_index[s] = lat_idx[s] * lon_size + lon_idx[s]``; the native
    gather where the library builds, one numpy fancy index otherwise.
    """
    try:
        from tiger_tpu_torch.native import remap_gather

        return remap_gather(np.asarray(grid_chunk, np.float32), flat_index)
    except ImportError:
        t_dim = grid_chunk.shape[0]
        flat = grid_chunk.reshape(t_dim, -1)
        return np.ascontiguousarray(flat[:, flat_index])
