"""tiger_tpu_torch — the hillslope hydrologic model engine on PyTorch and CUDA.

A port of ``tiger_tpu`` (JAX on a TPU, kept in this repository as the
reference) to one NVIDIA H100: the two-phase solve of Model 204 or Model
200 (Hamon PET and the ET ramp) -- fused RK45
over every system, then Radau IIA over the stiff subset -- with both
integrators as hand-written CUDA kernels (``kernels/csrc``) and their plain
PyTorch versions as the CPU path, and the CLI run around it
(``python -m tiger_tpu_torch.run --config sim.yaml``: YAML config, parameter
CSV, NetCDF forcings, NetCDF outputs, routed discharge, hot start, windowed
runs, several processes).  This package imports torch, never jax; importing
it needs neither h5py nor PyYAML.
"""

from tiger_tpu_torch.chunked import solve_chunked
from tiger_tpu_torch.config import config_from_dict, load_config
from tiger_tpu_torch.forcing import ForcingMeta, ForcingSet, ForcingSpec, load_forcings
from tiger_tpu_torch.models import DummyModel, Model200, Model204, get_model
from tiger_tpu_torch.solver import SolveResult, SolverConfig, radau_solve, rk45_solve, solve
from tiger_tpu_torch.streams import StreamSet

__version__ = "0.1.0"

__all__ = [
    "solve",
    "SolveResult",
    "SolverConfig",
    "rk45_solve",
    "radau_solve",
    "solve_chunked",
    "StreamSet",
    "Model200",
    "Model204",
    "DummyModel",
    "get_model",
    "ForcingSet",
    "ForcingMeta",
    "ForcingSpec",
    "load_forcings",
    "load_config",
    "config_from_dict",
]
