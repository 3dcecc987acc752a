"""Carry the JAX package's inputs across to the port.

The JAX package's solver inputs -- the per-system ``params`` dict, the
packed forcing ``ForcingSet.data`` with its ``meta``, ``y0`` and the query
times -- are handed over as numpy arrays (``np.asarray`` of the JAX arrays)
and become the port's tensors on a given device, bit for bit.  Nothing here
imports jax: ``meta`` may be the JAX package's ForcingMeta or any
(offsets, n_steps, dt_min) triple.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from tiger_tpu_torch.forcing import ForcingMeta, ForcingSet


def tensor(a, *, device: torch.device | str, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy array (or array-like) -> tensor on ``device``, optionally cast."""
    t = torch.as_tensor(np.array(a, copy=True), device=device)
    return t if dtype is None else t.to(dtype)


def params(
    p: Mapping[str, np.ndarray], *, device: torch.device | str, dtype: torch.dtype | None = None
) -> dict:
    """Per-system parameter dict of [S] arrays -> dict of tensors."""
    return {k: tensor(v, device=device, dtype=dtype) for k, v in p.items()}


def forcings(
    data: np.ndarray, meta: Sequence, *, device: torch.device | str
) -> ForcingSet:
    """Packed forcing [T_total, S] (float32) + its meta -> ForcingSet."""
    offsets, n_steps, dt_min = meta
    return ForcingSet(
        data=tensor(data, device=device, dtype=torch.float32),
        meta=ForcingMeta(
            tuple(int(o) for o in offsets),
            tuple(int(n) for n in n_steps),
            tuple(float(d) for d in dt_min),
        ),
    )


def solver_inputs(
    y0,
    p: Mapping[str, np.ndarray] | None,
    forcing_data: np.ndarray | None,
    forcing_meta: Sequence | None,
    query_times,
    *,
    device: torch.device | str,
    dtype: torch.dtype,
):
    """(y0, params, forcings, query_times) for ``solve``: states, params and
    queries in ``dtype``, forcing in float32, all on ``device``."""
    return (
        tensor(y0, device=device, dtype=dtype),
        None if p is None else params(p, device=device, dtype=dtype),
        None if forcing_data is None else forcings(forcing_data, forcing_meta, device=device),
        None if query_times is None else tensor(query_times, device=device, dtype=dtype),
    )
