"""Model 200 in plain NumPy: the reference the benchmark holds the program to.

Model 204's five stores (``model204.py``: snow, static, surface,
gravitational, aquifer; rain [m/min] and air temperature [degC] held over
each sample) with its linear ET stub replaced by two pieces of Tiger-HLM's
``src/models/ETmethods.cpp``, written here again from their equations:

- Hamon potential ET (``ETmethods.cpp:11-42``): the saturation vapour
  pressure esat [mb] and the saturated vapour density wt [g/m^3] from the air
  temperature; the daylight D [in units of 12 h] by the CBM model from the
  latitude and the day of year, doy = doy0 + t/1440 with t in minutes from
  the run's start; PET = 1.6169e-6 D^2 wt 60 / 1000 [m/min] where the air is
  above 0 degC, else 0.
- the actual-ET ramp (``ETmethods.cpp:47-59``) on the static store's fill
  s = h_static/Hu: 0 up to the wilting point sw, e_max from stomatal closure
  ss up, linear between; e_max = min(PET, h_static).

Departures from the reference's code:

- the start date: the reference fixes doy = 1 + t/1440 (``model_204.hpp:84``),
  a run that starts on January 1; here the configuration states ``doy0``, the
  day of year at t = 0, as the program takes it from the run's start date.
- polar day and night: where the CBM argument of acos leaves [-1, 1], the
  reference computes D, tests it for NaN and picks day or night by a sign
  rule; here acos takes its limits (argument 1 or more: 24 h of daylight;
  -1 or less: none).  The two differ only within ~0.8 deg of the poles, where
  the refraction term decides.
- the sine and cosine of the latitude are taken once per system (``derived``),
  and every branch is a select over the whole batch.
"""

from __future__ import annotations

import numpy as np

N_EQ = 5
#: Names of the states, in order.
STATES = ("snow", "static", "surface", "grav", "aquifer")
#: Parameter names, one [R] array each (Model 204's; Model 200 reads lat, sw
#: and ss too).
PARAM_FIELDS = ("c1", "infil", "perco", "Hu", "lat", "sw", "ss", "n_mann", "slope", "L",
                "A_h", "alpha3", "alpha4", "melt_f", "temp_thr")
#: Names of the forcings, in the order the model reads them.
FORCINGS = ("rain", "temperature")
#: Cold-start state of the reference's main program (Model 204's).
Y_COLD = (0.01, 3.0, 0.0, 5.0, 0.2)
#: The right-hand side reads time (the day of year): a configuration states
#: ``doy0``.
READS_TIME = True
#: Operations of one right-hand side (``harness/work.py`` counts them), 72:
#: Model 204's stores without its ET, 27 (snowmelt 4; x1, dy0 2; x2 3; d1 1;
#: x3, d2 2; the Manning base 5; w 2; dy2 2; x4, d3 2; dy3 2; dy4 2); the day
#: of year (a product by 1/1440, an add) 2; Hamon's PET 34: esat (product,
#: add, divide, exp, product) 5, wt (product, add, divide) 3, theta
#: (subtract, product, tan, product, atan, product, add) 7, phi (cos,
#: product, asin) 3, the argument's numerator (sin, product, add) 3 and
#: denominator (cos, product) 2 and their quotient 1, acos's limits (max,
#: min) 2, D (acos, product, subtract, product) 4, PET (three products, the
#: constants folded) 3, the gate on temperature 1; e_max 1; s 1; the ramp
#: (two subtracts, product, divide, two selects) 6; dy1 1.
RHS_OPS = 72

SIN_REFRACTION = np.sin(0.8333 * np.pi / 180.0)


def derived(p: dict, doy0=None) -> dict:
    """The loop-invariant terms of ``rhs``: Model 204's, the sine and cosine
    of the latitude, and ``doy0``, the day of year at t = 0 (required)."""
    if doy0 is None:
        raise ValueError("Model 200 reads time: derived() needs doy0, the day of year at t = 0")
    q = dict(p)
    q["manning_c"] = np.sqrt(p["slope"]) / p["n_mann"] * (p["L"] / p["A_h"] * 60.0)
    q["inv_hu"] = 1.0 / p["Hu"]
    q["inv_a3"] = np.where(p["alpha3"] >= 1.0, 1.0 / p["alpha3"], 0.0)
    q["inv_a4"] = np.where(p["alpha4"] >= 1.0, 1.0 / p["alpha4"], 0.0)
    lat = p["lat"] * (np.pi / 180.0)
    q["sin_lat"] = np.sin(lat)
    q["cos_lat"] = np.cos(lat)
    q["doy0"] = float(doy0)
    return q


def hamon_pet(temp: np.ndarray, sin_lat: np.ndarray, cos_lat: np.ndarray,
              doy: np.ndarray) -> np.ndarray:
    """Hamon potential ET [m/min] at air temperature ``temp`` [degC], the
    latitude's sine and cosine, and day of year ``doy``."""
    esat = 6.108 * np.exp(17.26939 * temp / (temp + 237.3))
    wt = 216.7 * esat / (temp + 273.3)
    theta = 0.2163108 + 2.0 * np.arctan(0.9671396 * np.tan(0.00860 * (doy - 186.0)))
    phi = np.arcsin(0.39795 * np.cos(theta))
    arg = (SIN_REFRACTION + sin_lat * np.sin(phi)) / (cos_lat * np.cos(phi))
    daylight = (24.0 - (24.0 / np.pi) * np.arccos(np.clip(arg, -1.0, 1.0))) / 12.0
    pet = 1.6169e-6 * daylight * daylight * wt * 60.0 / 1000.0
    return np.where(temp > 0.0, pet, 0.0)


def et_actual(e_max: np.ndarray, s: np.ndarray, sw: np.ndarray, ss: np.ndarray) -> np.ndarray:
    """Actual ET: the ramp between the wilting point ``sw`` and stomatal
    closure ``ss`` on the fill ``s``."""
    return np.where(s > ss, e_max, np.where(s > sw, e_max * (s - sw) / (ss - sw), 0.0))


def rhs(t: np.ndarray, y: np.ndarray, q: dict, rain: np.ndarray,
        temp: np.ndarray) -> np.ndarray:
    """dy/dt [N_EQ, R] of states ``y`` [N_EQ, R] at times ``t`` [R], minutes
    from the run's start (``q`` from ``derived``)."""
    snow, stat, surf, grav, aq = y
    melt = np.where(temp >= q["temp_thr"], np.minimum(snow, temp * q["melt_f"]), 0.0)
    x1 = rain + melt
    x2 = np.maximum(0.0, x1 + stat - q["Hu"])
    doy = q["doy0"] + t / 1440.0
    e_max = np.minimum(hamon_pet(temp, q["sin_lat"], q["cos_lat"], doy), stat)
    et = et_actual(e_max, stat * q["inv_hu"], q["sw"], q["ss"])
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
