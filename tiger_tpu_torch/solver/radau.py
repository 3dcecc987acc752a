"""Batched implicit 3-stage Radau IIA (order 5) for stiff systems.

``radau_solve`` is the entry point of the stiff phase: systems the RK45
pass flagged are restarted from t0 and re-integrated, rewriting their dense
output.  It checks the inputs, collapses duplicate queries and hands the
batch to kernel B2 (``kernels/radau.py``): the CUDA kernel for CUDA
tensors, its plain torch version for CPU ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tiger_tpu_torch.forcing import ForcingSet
from tiger_tpu_torch.solver.config import SolverConfig, require_supported
from tiger_tpu_torch.solver.rk45 import check_inputs, dedup_queries, start_steps


class RadauStats(NamedTuple):
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    n_attempts: torch.Tensor
    n_newton: torch.Tensor  # Newton sweeps each system ran
    n_fact: torch.Tensor  # Jacobian + LU factorizations (one per attempt)


class RadauResult(NamedTuple):
    y_final: torch.Tensor  # [S, N]; NaN where the system did not finish
    dense: torch.Tensor  # [S, Q, N]
    failed: torch.Tensor  # [S] bool
    stats: RadauStats


def radau_solve(
    model,
    y0: torch.Tensor,
    t0: float,
    tf: float,
    query_times: Optional[torch.Tensor] = None,
    params: Optional[dict] = None,
    forcings: Optional[ForcingSet] = None,
    h0: Optional[torch.Tensor] = None,
    config: SolverConfig = SolverConfig(),
) -> RadauResult:
    """Batched Radau IIA integration of ``y0[S, N]`` from t0 to tf on
    ``y0``'s device (arguments as ``rk45_solve``)."""
    from tiger_tpu_torch.kernels.radau import radau

    require_supported(config, "radau")
    check_inputs(model, y0, t0, tf, query_times, params, forcings)
    qt, inverse = dedup_queries(query_times, y0.dtype)
    h0 = start_steps(model, y0, t0, params, forcings, h0, config)
    res = radau(model, y0, h0, float(t0), float(tf), qt, params, forcings, config)
    if inverse is not None:
        res = res._replace(dense=res.dense[:, inverse.to(res.dense.device), :])
    return res
