"""``pow`` and ``exp2`` whose every result depends on its own inputs alone.

On the CPU, torch evaluates ``pow`` and ``exp2`` of a contiguous tensor with
a SIMD routine over whole vectors and with the C library's routine over the
elements left at the end (and at the ends of the pieces its threads take);
the two round apart in the last bit (about 1 in 15 results of ``exp2``, 1 in
4 of float32 ``pow``).  A system's result would then depend on where its row
falls in the batch, and a batch split over devices or processes would not
equal the whole.  On the CPU these helpers give every float64 element to the
SIMD routine: the input is padded to whole vectors and handed over in pieces
too small to be split over threads.  Float32 keeps torch's own rounding: the
port's float32 CPU runs are held to the JAX package's by bounds and failure
patterns that rest on it (either routine throughout moves some of them
out), so a float32 CPU run split over devices or processes agrees with the
whole to rounding, not bit for bit.  On CUDA every element is computed
alike, in either type, and these are torch's own functions.
"""

from __future__ import annotations

import torch

#: Elements a padded input is a multiple of: twice the widest SIMD vector
#: (AVX-512: 16 floats), which torch's element loop takes at a time.
_VECTOR = 64
#: Elements a piece: below torch's grain (32,768), so one thread takes it.
_PIECE = 16_384


def _simd(fn, x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    n = flat.numel()
    padded = torch.ones(-(-n // _VECTOR) * _VECTOR, dtype=x.dtype)
    padded[:n] = flat
    out = torch.cat([fn(padded[i:i + _PIECE]) for i in range(0, padded.numel(), _PIECE)]) \
        if padded.numel() > _PIECE else fn(padded)
    return out[:n].reshape(x.shape)


def pow(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """``x ** exponent`` for a Python number ``exponent``."""
    if x.device.type != "cpu" or x.dtype != torch.float64:
        return torch.pow(x, exponent)
    return _simd(lambda v: torch.pow(v, exponent), x)


def exp2(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cpu" or x.dtype != torch.float64:
        return torch.exp2(x)
    return _simd(torch.exp2, x)
