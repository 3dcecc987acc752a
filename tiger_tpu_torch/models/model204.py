"""Model 204: 5-equation snow / static / surface / grav / aquifer runoff model.

Port of ``tiger_tpu/models/model204.py`` on torch tensors.  State y =
[h_snow, h_static, h_surface, h_grav, h_aquifer] in meters; time t in
MINUTES.  Forcings: F[0] = rainfall [m/min], F[1] = temperature [degC];
missing forcings are 0.  The CUDA kernels carry a device twin of
``rhs_tuple`` over ``derived_params`` (``kernels/csrc/common.cuh``).
"""

from __future__ import annotations

import dataclasses

import torch


def _pow23(x: torch.Tensor) -> torch.Tensor:
    """x**(2/3) for clamped x >= 0 as exp2((2/3)*log2(max(x, 1e-30))).

    The same formula as the JAX package (and the CUDA twin, exp2f/log2f),
    not ``pow``: the two differ by ~1e-6 relative in float32.
    """
    xc = torch.clamp_min(x, 1e-30)
    return torch.exp2((2.0 / 3.0) * torch.log2(xc))


#: Parameter keys of the per-system params dict, in the order the CUDA
#: kernels read them (rows of the [15, S] parameter block).
PARAM_FIELDS = (
    "c1",
    "infil",
    "perco",
    "Hu",
    "lat",
    "sw",
    "ss",
    "n_mann",
    "slope",
    "L",
    "A_h",
    "alpha3",
    "alpha4",
    "melt_f",
    "temp_thr",
)


@dataclasses.dataclass(frozen=True)
class Model204:
    N_EQ: int = 5
    UID: int = 204

    # True: clamp the Manning base at 0 (no NaN for the negative surface
    # depths that transiently appear in stage evaluations).  False: pow's
    # NaN-on-negative semantics, bit-level parity with the reference.
    safe_pow: bool = True

    def derived_params(self, params: dict) -> dict:
        """Loop-invariant parameter math, hoisted out of the RHS (computed
        once per solve; ``rhs_tuple`` uses the keys when present)."""
        p = dict(params)
        p["_manning_c"] = (
            torch.sqrt(p["slope"]) / p["n_mann"] * (p["L"] / p["A_h"] * 60.0)
        )
        p["_inv_Hu"] = 1.0 / p["Hu"]
        zero = torch.zeros((), dtype=p["alpha3"].dtype, device=p["alpha3"].device)
        p["_inv_a3"] = torch.where(p["alpha3"] >= 1.0, 1.0 / p["alpha3"], zero)
        p["_inv_a4"] = torch.where(p["alpha4"] >= 1.0, 1.0 / p["alpha4"], zero)
        return p

    def rhs_tuple(self, t, y, params, forcings=None) -> tuple:
        P = params
        h_snow, h_stat, h_surf, h_grav, h_aq = y[0], y[1], y[2], y[3], y[4]
        zero = torch.zeros((), dtype=h_snow.dtype, device=h_snow.device)
        n_forc = 0 if forcings is None else len(forcings)
        rainfall = forcings[0].to(h_snow.dtype) if n_forc > 0 else zero
        temperature = forcings[1].to(h_snow.dtype) if n_forc > 1 else zero

        # 1) Snow
        snowmelt = torch.where(
            temperature >= P["temp_thr"],
            torch.minimum(h_snow, temperature * P["melt_f"]),
            zero,
        )
        x1 = rainfall + snowmelt
        dy0 = rainfall - snowmelt

        # 2) Static store
        x2 = torch.maximum(zero, x1 + h_stat - P["Hu"])
        d1 = x1 - x2
        e_max = torch.minimum(0.1 * temperature, h_stat)
        s = h_stat * P["_inv_Hu"] if "_inv_Hu" in P else h_stat / P["Hu"]
        dy1 = d1 - s * e_max

        # 3) Surface store (Manning)
        x3 = torch.minimum(x2, P["infil"])
        d2 = x2 - x3
        if self.safe_pow:
            pow23 = _pow23(torch.maximum(h_surf, zero))
        else:
            pow23 = torch.pow(h_surf, 2.0 / 3.0)  # NaN for h < 0, like CUDA pow
        one = zero + 1.0
        if "_manning_c" in P:
            w = torch.minimum(one, pow23 * P["_manning_c"])
        else:
            alfa2 = (1.0 / P["n_mann"]) * pow23 * torch.sqrt(P["slope"])
            w = torch.minimum(one, alfa2 * P["L"] / P["A_h"] * 60.0)
        dy2 = d2 - h_surf * w

        # 4) Gravitational store (interflow) and aquifer
        x4 = torch.minimum(x3, P["perco"])
        d3 = x3 - x4
        if "_inv_a3" in P:
            dy3 = d3 - h_grav * P["_inv_a3"]
            dy4 = x4 - h_aq * P["_inv_a4"]
        else:
            dy3 = d3 - torch.where(P["alpha3"] >= 1.0, h_grav / P["alpha3"], zero)
            dy4 = x4 - torch.where(P["alpha4"] >= 1.0, h_aq / P["alpha4"], zero)

        return (dy0, dy1, dy2, dy3, dy4)


def link_outflow(y: torch.Tensor, params: dict) -> torch.Tensor:
    """Instantaneous local outflow per link [m * km^2 / min] from the stores.

    Port of ``tiger_tpu/models/model204.py::link_outflow``: the surface,
    interflow and baseflow terms of ``rhs_tuple``, so that routed discharge
    uses the formulas the solver integrates.  ``y`` is [..., N] with the
    states last; each parameter broadcasts against ``y[..., 0]``.  Stores
    are clamped at 0: the dense interpolant can overshoot slightly below an
    empty store, and a negative Manning base would poison every downstream
    discharge with NaN.
    """
    P = params
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    h_surf = torch.maximum(y[..., 2], zero)
    h_grav = torch.maximum(y[..., 3], zero)
    h_aq = torch.maximum(y[..., 4], zero)
    pow23 = _pow23(h_surf)
    one = zero + 1.0
    if "_manning_c" in P:
        w = torch.minimum(one, pow23 * P["_manning_c"])
    else:
        alfa2 = (1.0 / P["n_mann"]) * pow23 * torch.sqrt(P["slope"])
        w = torch.minimum(one, alfa2 * P["L"] / P["A_h"] * 60.0)
    qs = h_surf * w
    if "_inv_a3" in P:
        qi = h_grav * P["_inv_a3"]
        qb = h_aq * P["_inv_a4"]
    else:
        qi = torch.where(P["alpha3"] >= 1.0, h_grav / P["alpha3"], zero)
        qb = torch.where(P["alpha4"] >= 1.0, h_aq / P["alpha4"], zero)
    return (qs + qi + qb) * P["A_h"]


#: Common cold-start initial state of the reference's main program.
Y0_COMMON = (0.01, 3.0, 0.0, 5.0, 0.2)
