"""Solver layer: adaptive RK45 + Radau IIA, step control, dense output."""

from tiger_tpu_torch.solver.config import SolverConfig
from tiger_tpu_torch.solver.controller import initial_step
from tiger_tpu_torch.solver.rk45 import RK45Result, RKStats, rk45_solve
from tiger_tpu_torch.solver.radau import RadauResult, RadauStats, radau_solve
from tiger_tpu_torch.solver.api import SolveResult, solve

__all__ = [
    "SolverConfig",
    "solve",
    "SolveResult",
    "rk45_solve",
    "RK45Result",
    "RKStats",
    "radau_solve",
    "RadauResult",
    "RadauStats",
    "initial_step",
]
