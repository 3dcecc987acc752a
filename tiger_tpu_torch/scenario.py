"""The synthetic Model-204 basin of the benchmarks, on a given device.

Port of ``__graft_entry__.py::_scenario``: the same numpy RNG calls in the
same order from ``default_rng(0)``, so the arrays are bit-identical to the
JAX version's; only the final conversion differs (torch tensors on
``device``).
"""

from __future__ import annotations

import numpy as np
import torch

from tiger_tpu_torch.forcing import ForcingSet
from tiger_tpu_torch.models.model204 import Y0_COMMON

#: Static-storage capacity Hu [m] of the stiff systems: ET drains h_static
#: at ~0.1*T/Hu per minute, a stable timescale far below RK45's reach.
STIFF_HU = 1e-6


def scenario_arrays(s_count: int, days: float = 2.0, stiff_frac: float = 0.0):
    """(params, [rainfall, temperature], dt_minutes) as numpy arrays.

    ``stiff_frac`` of the systems (spread evenly) get Hu = STIFF_HU and a
    strictly positive temperature, which makes them genuinely stiff; the
    forcing record covers ``days``.
    """
    rng = np.random.default_rng(0)
    base = dict(
        c1=0.001 / 60.0,
        infil=0.0001 * (0.001 / 60.0),
        perco=0.00005 * (0.001 / 60.0),
        Hu=0.5,
        lat=41.5,
        sw=0.2,
        ss=0.8,
        n_mann=0.03,
        slope=0.05,
        L=1.0,
        A_h=10.0,
        alpha3=2880.0,
        alpha4=7200.0,
        melt_f=1e-5,
        temp_thr=0.0,
    )
    params = {
        k: np.full(s_count, v) * rng.uniform(0.8, 1.2, s_count) for k, v in base.items()
    }
    n_stiff = int(round(s_count * stiff_frac))
    rows = np.linspace(0, s_count - 1, n_stiff).astype(np.int64) if n_stiff else None
    if n_stiff:
        params["Hu"][rows] = STIFF_HU
    n_hours = max(int(np.ceil(days * 24.0)), 1)
    n_days = max(int(np.ceil(days)), 1)
    pr = rng.uniform(0, 0.0015, (n_hours, s_count)).astype(np.float32)
    t2m = rng.uniform(-2.0, 10.0, (n_days, s_count)).astype(np.float32)
    if n_stiff:
        t2m[:, rows] = rng.uniform(2.0, 10.0, (n_days, n_stiff))
    return params, [pr, t2m], [60.0, 1440.0]


def scenario(
    s_count: int,
    days: float = 2.0,
    stiff_frac: float = 0.0,
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.float32,
):
    """(y0 [S, 5], params dict of [S], ForcingSet) on ``device``.

    States and params are in ``dtype``; the packed forcing is float32.
    """
    params_np, series, dt = scenario_arrays(s_count, days, stiff_frac)
    params = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in params_np.items()}
    forcings = ForcingSet.from_series(series, dt, device=device)
    y0 = torch.tensor(Y0_COMMON, dtype=dtype, device=device).repeat(s_count, 1)
    return y0, params, forcings
