"""Model protocol: what a Tiger-HLM physics model looks like in the port.

A model is a frozen dataclass with

  - ``N_EQ``: number of prognostic equations,
  - ``UID``: model id of the registry,
  - ``rhs_tuple(t, y, params, forcings)``: the right-hand side on UNSTACKED
    components — ``y`` is an indexable of ``N_EQ`` tensors of one shape
    (one entry per system), ``params`` a dict of such tensors (or None),
    ``forcings`` an indexable of forcing tensors frozen at the step-start
    time (or None).  It returns a tuple of ``N_EQ`` tensors.  ``t`` is the
    time of the evaluation in minutes, a window's shift included.

The batched plain solvers call ``rhs_tuple`` with [S]-shaped tensors; the
CUDA kernels carry their own device twin of each model they support
(``kernels._common.KERNEL_MODELS``: Model 204, Model 200 and DummyModel).
"""

from __future__ import annotations

from typing import Mapping, Optional, Protocol, Sequence, runtime_checkable

import torch


@runtime_checkable
class Model(Protocol):
    N_EQ: int
    UID: int

    def rhs_tuple(
        self,
        t,
        y: Sequence[torch.Tensor],
        params: Optional[Mapping[str, torch.Tensor]],
        forcings: Optional[Sequence[torch.Tensor]],
    ) -> tuple:
        """Return dy/dt as a tuple of ``N_EQ`` tensors."""
        ...
