"""Model 204 in plain NumPy: the reference the benchmark holds the program to.

Five stores in meters, time in minutes: y = [h_snow, h_static, h_surface,
h_grav, h_aquifer].  Forcings: rain [m/min] and air temperature [degC], each
held constant over its sample (zero-order hold).  The equations are those of
Tiger-HLM's ``model_204.hpp`` as the program states them; written here again
from the equations, in NumPy, so that the check shares no code with the
program.  The Manning base is clamped at zero (the program's default).  The
right-hand side does not read time.
"""

from __future__ import annotations

import numpy as np

N_EQ = 5
#: Names of the states, in order.
STATES = ("snow", "static", "surface", "grav", "aquifer")
#: Parameter names, one [R] array each.
PARAM_FIELDS = ("c1", "infil", "perco", "Hu", "lat", "sw", "ss", "n_mann", "slope", "L",
                "A_h", "alpha3", "alpha4", "melt_f", "temp_thr")
#: Names of the forcings, in the order the model reads them.
FORCINGS = ("rain", "temperature")
#: Cold-start state of the reference's main program.
Y_COLD = (0.01, 3.0, 0.0, 5.0, 0.2)
#: The right-hand side is blind to time: a configuration states no start date.
READS_TIME = False
#: Operations of one right-hand side (``harness/work.py`` counts them), 32:
#: snowmelt (compare, product, min, select) 4; x1, dy0 2; x2 (add, subtract,
#: max) 3; d1 1; e_max (product, min) 2; s 1; dy1 (product, subtract) 2;
#: x3, d2 2; the Manning base (max, floor at 1e-30, log2, product, exp2) 5;
#: w (product, min) 2; dy2 2; x4, d3 2; dy3 2; dy4 2.
RHS_OPS = 32


def derived(p: dict, doy0=None) -> dict:
    """The loop-invariant parameter terms of ``rhs``; ``doy0`` is not read."""
    q = dict(p)
    q["manning_c"] = np.sqrt(p["slope"]) / p["n_mann"] * (p["L"] / p["A_h"] * 60.0)
    q["inv_hu"] = 1.0 / p["Hu"]
    q["inv_a3"] = np.where(p["alpha3"] >= 1.0, 1.0 / p["alpha3"], 0.0)
    q["inv_a4"] = np.where(p["alpha4"] >= 1.0, 1.0 / p["alpha4"], 0.0)
    return q


def rhs(t: np.ndarray, y: np.ndarray, q: dict, rain: np.ndarray,
        temp: np.ndarray) -> np.ndarray:
    """dy/dt [N_EQ, R] of states ``y`` [N_EQ, R] at times ``t`` [R] (not
    read; ``q`` from ``derived``)."""
    snow, stat, surf, grav, aq = y
    melt = np.where(temp >= q["temp_thr"], np.minimum(snow, temp * q["melt_f"]), 0.0)
    x1 = rain + melt
    x2 = np.maximum(0.0, x1 + stat - q["Hu"])
    et = stat * q["inv_hu"] * np.minimum(0.1 * temp, stat)
    x3 = np.minimum(x2, q["infil"])
    w = np.minimum(1.0, np.maximum(surf, 0.0) ** (2.0 / 3.0) * q["manning_c"])
    x4 = np.minimum(x3, q["perco"])
    return np.stack([
        rain - melt,
        (x1 - x2) - et,
        (x2 - x3) - surf * w,
        (x3 - x4) - grav * q["inv_a3"],
        x4 - aq * q["inv_a4"],
    ])
