"""Initial step-size estimate (port of ``tiger_tpu/solver/controller.py``).

    scale_i = atol + rtol * |y0_i|
    d0 = ||y0 / scale||_2, d1 = ||f(t0, y0) / scale||_2
    h0 = max(1e-6, 0.01 * d0 / (d1 + 1e-16))

``h0_mode='per-system'`` (default) evaluates it from every system's own
initial state, as batched tensor ops; ``'global-zero-y0'`` is the
reference's single estimate from a zero state with system 0's parameters and
forcings, broadcast to every system.  As in the JAX package the RHS sees the
raw parameters (not ``derived_params``) and the un-snapped forcing sample.
"""

from __future__ import annotations

import torch

from tiger_tpu_torch.forcing import ForcingSet, gather_forcings_column
from tiger_tpu_torch.solver.config import SolverConfig

_H_FLOOR = 1e-6


def _norm(terms) -> torch.Tensor:
    """2-norm over the component list, summed left to right."""
    acc = terms[0] * terms[0]
    for x in terms[1:]:
        acc = acc + x * x
    return torch.sqrt(acc)


def _estimate(model, t0, y0_cols, params, f_vals, rtol, atol) -> torch.Tensor:
    f0 = model.rhs_tuple(t0, y0_cols, params, f_vals)
    scale = [atol + rtol * torch.abs(y) for y in y0_cols]
    d0 = _norm([y / s for y, s in zip(y0_cols, scale)])
    d1 = _norm([f / s for f, s in zip(f0, scale)])
    return torch.clamp_min(0.01 * d0 / (d1 + 1e-16), _H_FLOOR)


def initial_step(
    model,
    y0: torch.Tensor,
    t0: float,
    params: dict | None = None,
    forcings: ForcingSet | None = None,
    config: SolverConfig = SolverConfig(),
    t_shift: float = 0.0,
) -> torch.Tensor:
    """Per-system initial steps [S] on ``y0``'s device, in ``y0``'s dtype.

    ``config.initial_step`` (an explicit scalar) wins; otherwise
    ``config.h0_mode`` selects the estimate.  The rhs sees t0 + ``t_shift``
    (in ``y0``'s dtype); the forcing is sampled at t0.
    """
    s_count, n_eq = y0.shape
    dtype, device = y0.dtype, y0.device
    if config.initial_step is not None:
        return torch.full((s_count,), config.initial_step, dtype=dtype, device=device)
    t0_t = torch.full((), float(t0), dtype=dtype, device=device)
    t_rhs = t0_t + torch.tensor(float(t_shift), dtype=dtype, device=device) if t_shift else t0_t
    if config.h0_mode == "global-zero-y0":
        cols = [torch.zeros((1,), dtype=dtype, device=device) for _ in range(n_eq)]
        p_row = None if params is None else {k: v[:1] for k, v in params.items()}
        f_vals = None
        if forcings is not None:
            f_vals = tuple(
                v[:1].to(dtype)
                for v in gather_forcings_column(forcings.data, forcings.meta, t0_t)
            )
        h = _estimate(model, t_rhs, cols, p_row, f_vals, config.rtol, config.atol)
        return h.expand(s_count).contiguous()
    cols = [y0[:, i] for i in range(n_eq)]
    f_vals = None
    if forcings is not None:
        f_vals = tuple(
            v.to(dtype)
            for v in gather_forcings_column(forcings.data, forcings.meta, t0_t)
        )
    return _estimate(model, t_rhs, cols, params, f_vals, config.rtol, config.atol)
