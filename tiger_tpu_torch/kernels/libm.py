"""Model 200's libm calls on the card, element by element.

The kernels are built with ``-fmad=false``, and that flag reaches the libm
code nvcc inlines into them: a function may then round otherwise than
torch's CUDA function of the same name, which is built with contraction
(double ``pow`` does, hence ``csrc/contracted.cu``).  ``libm_eval`` runs
``csrc/libm_check.cu``, built on first use into a library of its own with
the Model 200 instances' flags (``_build.build_libm_check``), which calls
each function as those instances do (``csrc/common.cuh``'s ``*_t``
overloads), on a CUDA tensor; ``mismatch`` counts the elements that differ
from torch's function bit for bit (chip_smoke phase 12a).
"""

from __future__ import annotations

import ctypes

import torch

from tiger_tpu_torch.kernels import _build

#: Model 200's libm calls, in libm_check.cu's order.
FUNCTIONS = ("exp", "sin", "cos", "tan", "atan", "asin", "acos")
_lib: list[ctypes.CDLL] = []


def _load() -> ctypes.CDLL:
    if not _lib:
        lib = ctypes.CDLL(str(_build.build_libm_check()[0]))
        lib.tt_libm_eval.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.tt_libm_eval.restype = ctypes.c_int
        _lib.append(lib)
    return _lib[0]


def libm_eval(name: str, x: torch.Tensor) -> torch.Tensor:
    """Function ``name`` of every element of the float32 or float64 CUDA
    tensor ``x``, as the Model 200 instances compute it, on the current
    stream."""
    if x.device.type != "cuda" or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"libm_eval: needs a float32 or float64 CUDA tensor, got {x.dtype} on {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tt_libm_eval(FUNCTIONS.index(name), int(x.dtype == torch.float64), x.data_ptr(),
                              y.data_ptr(), x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"tt_libm_eval ({name}): CUDA error {rc}")
    return y


def mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of ``a`` and ``b`` that differ bit for bit (a NaN equals a
    NaN, whatever its payload)."""
    nan = torch.isnan(a) & torch.isnan(b)
    same = ((a == b) & (torch.signbit(a) == torch.signbit(b))) | nan
    return int((~same).sum())
