"""Model 200: Model 204's five stores with Hamon PET and the actual-ET ramp.

Port of ``tiger_tpu/models/model200.py`` on torch tensors.  Potential ET
is Hamon's (temperature, latitude and the day of year doy = doy0 + t/1440,
anchored to the run's start date), actual ET the sw/ss ramp on the static
store's fill s = h_static/Hu; snowmelt is gated on air temperature as in
Model 204, and the snow bucket, the surface (Manning), gravitational and
aquifer stores are Model 204's.  Unlike Model 204 the rhs reads t, so a
windowed solve passes the window's start as ``t_shift``.  The CUDA kernels
carry a device twin of ``rhs_tuple`` over ``derived_params``
(``kernels/csrc/common.cuh`` Model200), which repeats its operations in
their order.
"""

from __future__ import annotations

import dataclasses

import torch

from tiger_tpu_torch.models.et import DAY_OF_MIN, RAD, et_actual, hamon_pet
from tiger_tpu_torch.models.model204 import Model204, _pow23


@dataclasses.dataclass(frozen=True)
class Model200:
    N_EQ: int = 5
    UID: int = 200

    # As Model204.safe_pow.
    safe_pow: bool = True
    # Day of year at t = 0: run() passes time.start's (config.yaml:40).
    doy0: float = 1.0

    def derived_params(self, params: dict) -> dict:
        """Model 204's hoisted invariants, and the sine and cosine of the
        latitude."""
        p = Model204().derived_params(params)
        p["_sin_lat"] = torch.sin(p["lat"] * RAD)
        p["_cos_lat"] = torch.cos(p["lat"] * RAD)
        return p

    def rhs_tuple(self, t, y, params, forcings=None) -> tuple:
        P = params
        h_snow, h_stat, h_surf, h_grav, h_aq = y[0], y[1], y[2], y[3], y[4]
        zero = torch.zeros((), dtype=h_snow.dtype, device=h_snow.device)
        n_forc = 0 if forcings is None else len(forcings)
        rainfall = forcings[0].to(h_snow.dtype) if n_forc > 0 else zero
        temperature = forcings[1].to(h_snow.dtype) if n_forc > 1 else zero
        if not torch.is_tensor(t):
            t = zero + t
        doy = self.doy0 + t * DAY_OF_MIN

        # 1) Snow
        snowmelt = torch.where(
            temperature >= P["temp_thr"],
            torch.minimum(h_snow, temperature * P["melt_f"]),
            zero,
        )
        x1 = rainfall + snowmelt
        dy0 = rainfall - snowmelt

        # 2) Static store with Hamon PET and the moisture-ramp actual ET
        x2 = torch.maximum(zero, x1 + h_stat - P["Hu"])
        d1 = x1 - x2
        pet = hamon_pet(temperature, P["lat"], doy, P.get("_sin_lat"), P.get("_cos_lat"))
        e_max = torch.minimum(pet, h_stat)
        s = h_stat * P["_inv_Hu"] if "_inv_Hu" in P else h_stat / P["Hu"]
        dy1 = d1 - et_actual(e_max, s, P["sw"], P["ss"])

        # 3) Surface store (Manning), as Model 204
        x3 = torch.minimum(x2, P["infil"])
        d2 = x2 - x3
        if self.safe_pow:
            pow23 = _pow23(torch.maximum(h_surf, zero))
        else:
            pow23 = torch.pow(h_surf, 2.0 / 3.0)
        one = zero + 1.0
        if "_manning_c" in P:
            w = torch.minimum(one, pow23 * P["_manning_c"])
        else:
            alfa2 = (1.0 / P["n_mann"]) * pow23 * torch.sqrt(P["slope"])
            w = torch.minimum(one, alfa2 * P["L"] / P["A_h"] * 60.0)
        dy2 = d2 - h_surf * w

        # 4) Gravitational store and aquifer
        x4 = torch.minimum(x3, P["perco"])
        d3 = x3 - x4
        if "_inv_a3" in P:
            dy3 = d3 - h_grav * P["_inv_a3"]
            dy4 = x4 - h_aq * P["_inv_a4"]
        else:
            dy3 = d3 - torch.where(P["alpha3"] >= 1.0, h_grav / P["alpha3"], zero)
            dy4 = x4 - torch.where(P["alpha4"] >= 1.0, h_aq / P["alpha4"], zero)

        return (dy0, dy1, dy2, dy3, dy4)
