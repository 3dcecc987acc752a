"""Diagnostic helpers: the analog of the reference's debug kernels.

Port of ``tiger_tpu/diagnostics.py``.  The reference's diagnostics are
printf CUDA kernels in ``main.cpp`` (``debugForcings*`` :44-141,
``debugHolding`` :145-175, ``debugParams`` :187-213, ``debugRHS`` :219-246);
here the same inspections are functions over the port's tensors that return
numpy arrays and dicts, for tests and notebooks.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tiger_tpu_torch.forcing import ForcingSet


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _ranges(col: np.ndarray) -> Dict:
    """min/max/mean over the finite values (NaN when there is none), and
    the NaN count: one NaN, the thing being debugged, must not blank out
    the range."""
    finite = np.isfinite(col).any()
    return {
        "min": float(np.nanmin(col)) if finite else float("nan"),
        "max": float(np.nanmax(col)) if finite else float("nan"),
        "mean": float(np.nanmean(col)) if finite else float("nan"),
        "n_nan": int(np.isnan(col).sum()),
    }


def forcing_at(forcings: ForcingSet, t_minutes: float, systems=None) -> np.ndarray:
    """Forcing values the rhs sees at ``t_minutes``: [n_forcings,
    len(systems)], the zero-order-hold sample of each system
    (``debugForcingsMulti``/``debugMinuteForcings``)."""
    sel = np.arange(forcings.num_systems) if systems is None else np.asarray(systems)
    rows = []
    for off, n_t, dt in zip(forcings.meta.offsets, forcings.meta.n_steps, forcings.meta.dt_min):
        k = int(np.clip(int(t_minutes / dt), 0, n_t - 1))
        rows.append(_host(forcings.data[off + k])[sel])
    return np.stack(rows)


def forcing_series(
    forcings: ForcingSet, f_idx: int, system: int, n: Optional[int] = None
) -> np.ndarray:
    """The first ``n`` stored steps of forcing ``f_idx`` for one system
    (``debugForcings2``)."""
    off = forcings.meta.offsets[f_idx]
    n_t = forcings.meta.n_steps[f_idx]
    n = n_t if n is None else min(n, n_t)
    return _host(forcings.data[off : off + n, system])


def describe_forcings(forcings: ForcingSet) -> Dict:
    """Layout summary (``checkForcingPtr`` and the nT/dt dumps): offsets,
    step counts, dt and each forcing's value range."""
    out = {"num_systems": int(forcings.num_systems), "forcings": []}
    for off, n_t, dt in zip(forcings.meta.offsets, forcings.meta.n_steps, forcings.meta.dt_min):
        block = _host(forcings.data[off : off + n_t])
        out["forcings"].append(
            {"offset_rows": int(off), "n_steps": int(n_t), "dt_min": float(dt), **_ranges(block)}
        )
    return out


def describe_params(params: Dict, system: Optional[int] = None) -> Dict:
    """Each field's value of one system, or its range over all systems
    (``debugParams``/``debugAllParams``)."""
    out = {}
    for k in sorted(params):
        col = _host(params[k])
        out[k] = float(col[system]) if system is not None else _ranges(col)
    return out


def eval_rhs(model, y, t, params=None, forcings: Optional[ForcingSet] = None) -> np.ndarray:
    """Slopes dy/dt at (t, y) of every system (``debugRHS``): ``y`` is
    [S, N_EQ], the result [S, N_EQ]; the forcing is the sample at t."""
    y = torch.as_tensor(y)
    dev = y.device
    f_vals = None
    if forcings is not None:
        f_vals = tuple(torch.as_tensor(row, device=dev) for row in forcing_at(forcings, float(t)))
    p = None if params is None else {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    cols = tuple(y[:, i] for i in range(y.shape[1]))
    t_vec = torch.full((y.shape[0],), float(t), dtype=y.dtype, device=dev)
    return _host(torch.stack(model.rhs_tuple(t_vec, cols, p, f_vals), dim=1))


def holding_summary(y, labels=None) -> Dict:
    """State ranges (``debugHolding``): each state's min/max/mean over all
    systems, with NaN and negative counts."""
    y = _host(y)
    labels = labels or [f"state_{i}" for i in range(y.shape[1])]
    if len(labels) != y.shape[1]:
        raise ValueError(
            f"{len(labels)} labels for {y.shape[1]} states — a short list "
            "would silently drop trailing states from the report"
        )
    return {
        lab: {**_ranges(y[:, i]), "n_negative": int((y[:, i] < 0).sum())}
        for i, lab in enumerate(labels)
    }
