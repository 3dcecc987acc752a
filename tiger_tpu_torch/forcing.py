"""Forcing core: packed per-system forcing series + zero-order-hold gather.

Port of the array half of ``tiger_tpu/forcing.py``.  The packed tensor is
[T_total, S] float32 (time-major blocks concatenated on axis 0, the system
index innermost), and ``ForcingMeta`` describes the blocks.  Forcing values
are sampled once per attempted step at the step-start time and held across
all stages.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

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

    def take_systems(self, rows: torch.Tensor) -> "ForcingSet":
        """The forcing columns of the systems ``rows`` (same metadata)."""
        return ForcingSet(data=self.data[:, rows].contiguous(), meta=self.meta)


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
        idx = torch.clamp(torch.floor(_true_div(t, dt) + snap).to(torch.int64), 0, n_t - 1)
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
