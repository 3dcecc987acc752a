"""Evapotranspiration: Hamon PET and the actual-ET ramp.

Port of ``tiger_tpu/models/et.py`` on torch tensors, branchless as there.
Exact trig only (the JAX package's ``approx_trig`` polynomials answer a
Mosaic limit the port does not have).  Every division by a constant is
written as the product by its reciprocal, which is what torch computes for
``x / c`` on a CUDA tensor, so the CPU and the card run the same operations
and the CUDA twin (``kernels/csrc/common.cuh`` Model200) repeats them.
The divisions that feed a comparison (``arg``, the ramp) divide by a
tensor.
"""

from __future__ import annotations

import math

import torch

#: Hamon's constants (reference src/models/ETmethods.cpp:11-42).  The CUDA
#: twin writes the same Python numbers, rounded to the solve's scalar.
DAY_OF_MIN = 1.0 / 1440.0  # day-of-year per minute
RAD = math.pi / 180.0
SIN_REFRACTION = math.sin(0.8333 * math.pi / 180.0)
HOURS_PER_RAD = 24.0 / math.pi
HALF_DAY = 1.0 / 12.0  # daylight in units of 12 h
PER_MM = 1.0 / 1000.0


def hamon_pet(
    temperature: torch.Tensor,
    latitude: torch.Tensor,
    doy: torch.Tensor,
    sin_lat: torch.Tensor | None = None,
    cos_lat: torch.Tensor | None = None,
) -> torch.Tensor:
    """Hamon potential evapotranspiration [m/min].

    ``temperature`` in degC, ``latitude`` in degrees, ``doy`` day of year;
    ``sin_lat``/``cos_lat`` are the latitude's, precomputed where the caller
    has them (``Model200.derived_params``).
    """
    zero = torch.zeros((), dtype=temperature.dtype, device=temperature.device)
    # Saturation vapour pressure (mb) and saturated vapour density (g/m^3)
    esat = 6.108 * torch.exp((17.26939 * temperature) / (temperature + 237.3))
    wt = 216.7 * esat / (temperature + 273.3)

    # Daylight fraction (units of 12 h) from the CBM model
    theta = 0.2163108 + 2.0 * torch.atan(0.9671396 * torch.tan(0.00860 * (doy - 186.0)))
    phi = torch.asin(0.39795 * torch.cos(theta))
    if sin_lat is None:
        sin_lat = torch.sin(latitude * RAD)
    if cos_lat is None:
        cos_lat = torch.cos(latitude * RAD)
    num = SIN_REFRACTION + sin_lat * torch.sin(phi)
    den = cos_lat * torch.cos(phi)
    arg = num / den
    d = (24.0 - HOURS_PER_RAD * torch.acos(arg)) * HALF_DAY

    # acos out of [-1, 1]: polar day or night (et.py:58-65, branchless).
    polar_day = ((phi > 0.0) & (latitude > 0.0)) | ((phi < 0.0) & (latitude < 0.0))
    d = torch.where(torch.abs(arg) > 1.0, torch.where(polar_day, zero + 2.0, zero), d)

    pet = 1.6169e-6 * d * d * wt * 60.0 * PER_MM
    return torch.where(temperature > 0.0, pet, zero)


def et_actual(e_max: torch.Tensor, s: torch.Tensor, sw: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """Actual ET: the linear ramp between the wilting point ``sw`` and
    stomatal closure ``ss`` (reference src/models/ETmethods.cpp:47-59)."""
    zero = torch.zeros((), dtype=e_max.dtype, device=e_max.device)
    ramp = e_max * (s - sw) / (ss - sw)
    return torch.where(s > ss, e_max, torch.where(s > sw, ramp, zero))
