"""Daily soil-temperature update (Rankinen et al. 2002) with snow insulation.

Port of ``tiger_tpu/models/soiltemp.py`` on torch tensors.  No model of the
port calls it yet, as in the JAX package: it is the reference's host-only
helper (src/models/soiltemp.cpp:11-29), kept for future model variants.
"""

from __future__ import annotations

import torch

# Parameters from Rankinen et al. 2002 (soiltemp.cpp:18-24)
_CS = 1e6  # soil heat capacity [J/m^3/degC]
_KT = 0.516  # thermal conductivity [W/m/degC]
_CICE = 8.93e6  # ice heat capacity [J/m^3/degC]
_FS = -2.7  # snow insulation damping [1/m]
_ZS = 3.5e-2  # depth of layer midpoint (0-7 cm) [m]
_DT = 3600.0 * 24.0  # one day [s]


def soiltemp(t_air: torch.Tensor, t_z: torch.Tensor, d_snow: torch.Tensor) -> torch.Tensor:
    """One daily soil-temperature step.

    ``t_air``: air temperature [degC]; ``t_z``: previous soil temperature
    [degC]; ``d_snow``: snow depth [m].  Returns the updated soil temperature.
    """
    ca = _CS + _CICE
    f = _DT * _KT / (ca * (2.0 * _ZS) * (2.0 * _ZS))
    t_star = t_z + f * (t_air - t_z)
    return t_star * torch.exp(-_FS * d_snow)
