"""tiger_tpu_torch — the hillslope hydrologic model engine on PyTorch and CUDA.

A port of ``tiger_tpu`` (JAX on a TPU, kept in this repository as the
reference) to one NVIDIA H100: the two-phase Model-204 solve -- fused RK45
over every system, then Radau IIA over the stiff subset -- with both
integrators as hand-written CUDA kernels (``kernels/csrc``) and their plain
PyTorch versions as the CPU path.  This package imports torch, never jax.
"""

from tiger_tpu_torch.forcing import ForcingMeta, ForcingSet
from tiger_tpu_torch.models import DummyModel, Model204
from tiger_tpu_torch.solver import SolveResult, SolverConfig, solve

__version__ = "0.1.0"

__all__ = [
    "solve",
    "SolveResult",
    "SolverConfig",
    "Model204",
    "DummyModel",
    "ForcingSet",
    "ForcingMeta",
]
