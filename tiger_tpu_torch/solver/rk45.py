"""Batched adaptive Dormand-Prince RK45 with dense output and stiffness flags.

``rk45_solve`` is the entry point of the explicit phase: it checks the
inputs (``check_inputs``, shared with the other entry points), estimates the
initial steps, collapses duplicate queries, and hands the batch to kernel
B1 (``kernels/rk45.py``), which runs the CUDA kernel for CUDA tensors and
its plain torch version for CPU ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tiger_tpu_torch.forcing import ForcingSet
from tiger_tpu_torch.profiling import span
from tiger_tpu_torch.solver.config import SolverConfig
from tiger_tpu_torch.solver.controller import initial_step


class RKStats(NamedTuple):
    n_accepted: torch.Tensor  # [S] accepted steps
    n_rejected: torch.Tensor  # [S] rejected attempts
    n_attempts: torch.Tensor  # [S] total attempted steps


class RK45Result(NamedTuple):
    y_final: torch.Tensor  # [S, N]; NaN for systems that did not finish
    dense: torch.Tensor  # [S, Q, N]
    stiff: torch.Tensor  # [S] bool: flagged for the Radau pass (includes failed)
    failed: torch.Tensor  # [S] bool: stopped by max_steps without a stiff flag
    h0: torch.Tensor  # [S] initial step used (the Radau pass reuses it)
    stats: RKStats


def check_inputs(model, y0, t0, tf, query_times, params, forcings) -> None:
    """Raise ValueError unless the solve's inputs fit together.

    ``y0`` is [S, N] with the model's N; every param is [S]; the forcings
    cover S systems; ``query_times`` is 1-D, NaN-free and sorted ascending;
    every tensor lies on ``y0``'s device; tf > t0.  The solvers' entry
    points call this once, before any work.
    """
    if y0.ndim != 2:
        raise ValueError(f"y0 must be [num_systems, N_EQ]; got shape {tuple(y0.shape)}")
    s_count, n_eq = y0.shape
    if getattr(model, "N_EQ", n_eq) != n_eq:
        raise ValueError(
            f"y0 has {n_eq} state variables but {type(model).__name__} expects {model.N_EQ}"
        )
    tensors = {"y0": y0}
    for k, v in (params or {}).items():
        if v.ndim != 1 or v.shape[0] != s_count:
            raise ValueError(
                f"params[{k!r}] has shape {tuple(v.shape)}; expected [{s_count}]"
            )
        tensors[f"params[{k!r}]"] = v
    if forcings is not None:
        if forcings.num_systems != s_count:
            raise ValueError(
                f"forcings cover {forcings.num_systems} systems; expected {s_count}"
            )
        tensors["forcings.data"] = forcings.data
    if query_times is not None:
        qt = query_times
        if not torch.is_tensor(qt):
            raise TypeError(f"query_times must be a tensor, got {type(qt).__name__}")
        if (
            qt.ndim != 1
            or _synced_any(torch.isnan(qt), "tiger.sync.check_nan")
            or (qt.numel() > 1 and _synced_any(qt[1:] < qt[:-1], "tiger.sync.check_order"))
        ):
            raise ValueError("query_times must be a 1-D NaN-free tensor sorted ascending")
        tensors["query_times"] = qt
    for name, v in tensors.items():
        if v.device != y0.device:
            raise ValueError(f"{name} is on {v.device}, y0 on {y0.device}")
    if not float(tf) > float(t0):
        raise ValueError(f"tf ({tf}) must be greater than t0 ({t0})")


def _synced_any(mask: torch.Tensor, mark: str) -> bool:
    """``mask.any()`` read on the host (a sync on the card), marked ``mark``."""
    with span(mark):
        return bool(mask.any())


def dedup_queries(query_times: torch.Tensor | None, dtype):
    """(unique queries | None, inverse index | None) of checked queries.

    Duplicates are collapsed before the kernel and the dense rows
    re-expanded after (``dense[:, inverse]``), so every copy of a query gets
    the same row.
    """
    if query_times is None:
        return None, None
    with span("tiger.sync.dedup"):  # the output's size is read on the host
        uniq, inverse = torch.unique_consecutive(query_times, return_inverse=True)
    uniq = uniq.to(dtype).contiguous()
    if uniq.shape[0] == query_times.shape[0]:
        return uniq, None
    return uniq, inverse


def start_steps(model, y0, t0, params, forcings, h0, config) -> torch.Tensor:
    """Initial steps [S] in y0's dtype: ``h0`` broadcast, or the estimate."""
    if h0 is None:
        return initial_step(model, y0, t0, params, forcings, config)
    h0 = torch.as_tensor(h0, dtype=y0.dtype, device=y0.device)
    return torch.broadcast_to(h0, (y0.shape[0],)).contiguous()


def rk45_solve(
    model,
    y0: torch.Tensor,
    t0: float,
    tf: float,
    query_times: Optional[torch.Tensor] = None,
    params: Optional[dict] = None,
    forcings: Optional[ForcingSet] = None,
    h0: Optional[torch.Tensor] = None,
    config: SolverConfig = SolverConfig(),
) -> RK45Result:
    """Batched RK45 integration of ``y0[S, N]`` from t0 to tf.

    Runs on ``y0``'s device (every other tensor must live there too).
    ``params``: dict of [S] tensors or None; ``forcings``: ForcingSet with
    data [T_total, S] or None; ``h0``: per-system initial steps [S], or None
    for the estimate of ``config`` (``controller.initial_step``).
    """
    from tiger_tpu_torch.kernels.rk45 import rk45

    check_inputs(model, y0, t0, tf, query_times, params, forcings)
    qt, inverse = dedup_queries(query_times, y0.dtype)
    h0 = start_steps(model, y0, t0, params, forcings, h0, config)
    res = rk45(model, y0, h0, float(t0), float(tf), qt, params, forcings, config)
    if inverse is not None:
        res = res._replace(dense=res.dense[:, inverse.to(res.dense.device), :])
    return res
