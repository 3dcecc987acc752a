"""Two-phase solve: RK45 over all systems, then Radau IIA over the stiff subset.

Port of ``tiger_tpu/solver/api.py::solve`` for one device.  The explicit
phase runs kernel B1 over every system; the stiff flags are read back with
one host sync, which gives the exact subset size; the subset's inputs are
gathered and kernel B2 re-integrates exactly those systems from t0; the
results are merged back.  The TPU package's speculative 256-lane rung with
NaN sentinels and its overflow rung hid a remote-TPU round trip that a local
card does not pay, so this port launches B2 once at the exact count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tiger_tpu_torch.forcing import ForcingSet
from tiger_tpu_torch.solver.config import SolverConfig, require_supported
from tiger_tpu_torch.solver.controller import initial_step
from tiger_tpu_torch.solver.radau import RadauStats
from tiger_tpu_torch.solver.rk45 import RKStats, check_inputs, dedup_queries


class SolveResult(NamedTuple):
    y_final: torch.Tensor  # [S, N]
    dense: torch.Tensor  # [S, Q, N]
    stiff: torch.Tensor  # [S] bool: went through the Radau phase
    failed: torch.Tensor  # [S] bool: did not finish in either phase
    rk_stats: RKStats
    # [S]-shaped per-system Radau counters (zero for systems that never
    # entered the stiff phase); None when no system did.
    radau_stats: Optional[RadauStats]
    n_stiff: int


def solve(
    model,
    y0: torch.Tensor,
    t0: float,
    tf: float,
    query_times: Optional[torch.Tensor] = None,
    params: Optional[dict] = None,
    forcings: Optional[ForcingSet] = None,
    config: SolverConfig = SolverConfig(),
) -> SolveResult:
    """Integrate ``y0[S, N]`` from t0 to tf with dense output at query_times.

    Runs on ``y0``'s device; every input tensor must be on it (CUDA runs
    the kernels in float32; CPU runs their plain versions in y0's dtype).
    The inputs are checked once, here (``solver.rk45.check_inputs``), and
    the two phases call the kernels' wrappers directly.

    Stiff systems (flagged by the RK45 phase, including those that hit
    ``max_steps``) are re-integrated from t0 by Radau at their RK45 initial
    step.  Those Radau solves take Radau's y_final, dense rows and
    ``failed=False``.  A system Radau fails keeps its RK45 values and
    reports ``failed=True``: this port has no CPU float64 retry, and a
    criteria-stiff system's RK45 result has ``failed=False`` with a NaN
    y_final, so keeping the RK45 flag would report it as solved.
    """
    from tiger_tpu_torch.kernels.radau import radau
    from tiger_tpu_torch.kernels.rk45 import rk45

    require_supported(config, "rk45")
    require_supported(config, "radau")
    check_inputs(model, y0, t0, tf, query_times, params, forcings)
    # As tiger_tpu's solve (api.py:248-251); the single-phase solvers
    # accept such queries and leave their rows unfilled.
    if query_times is not None and query_times.numel():
        if float(query_times[-1]) > float(tf) + 1e-9:
            raise ValueError(f"query_times extend past tf ({float(query_times[-1])} > {tf})")
    t0, tf = float(t0), float(tf)
    qt, inverse = dedup_queries(query_times, y0.dtype)
    h0 = initial_step(model, y0, t0, params, forcings, config)
    rk = rk45(model, y0, h0, t0, tf, qt, params, forcings, config)
    y_final, dense, failed = rk.y_final, rk.dense, rk.failed

    rows = torch.nonzero(rk.stiff).squeeze(1)  # the one host sync
    n_stiff = int(rows.shape[0])
    radau_stats = None
    if n_stiff:
        sub_forc = None if forcings is None else forcings.take_systems(rows)
        sub_params = None if params is None else {k: v[rows] for k, v in params.items()}
        rd = radau(model, y0[rows], rk.h0[rows], t0, tf, qt, sub_params, sub_forc, config)
        # In-place merge into the RK45 phase's own output tensors.
        ok = ~rd.failed
        y_final[rows] = torch.where(ok[:, None], rd.y_final.to(y_final.dtype), y_final[rows])
        dense[rows] = torch.where(ok[:, None, None], rd.dense.to(dense.dtype), dense[rows])
        failed[rows] = rd.failed
        radau_stats = RadauStats(
            *(
                torch.zeros(y0.shape[0], dtype=torch.int64, device=y0.device).index_copy_(
                    0, rows, field.to(torch.int64)
                )
                for field in rd.stats
            )
        )
    if inverse is not None:
        dense = dense[:, inverse.to(dense.device), :]
    return SolveResult(
        y_final=y_final,
        dense=dense,
        stiff=rk.stiff,
        failed=failed,
        rk_stats=rk.stats,
        radau_stats=radau_stats,
        n_stiff=n_stiff,
    )
