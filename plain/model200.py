"""Model 200 in plain torch: a reference to hold the port's Model 200 to.

Model 204's five stores (Tiger-HLM ``src/models/model_204.hpp:43-114``:
snow, static, surface, gravitational, aquifer; rain [m/min] and air
temperature [degC]) with its linear ET stub replaced by Tiger-HLM's ET
methods (``src/models/ETmethods.cpp``), written here again from their
equations in plain torch operations:

- Hamon potential ET (``ETmethods.cpp:11-42``): saturation vapour pressure
  esat [mb] and saturated vapour density wt [g/m^3] from the air
  temperature; the daylight D [units of 12 h] by the CBM model from the
  latitude and the day of year; PET = 1.6169e-6 D^2 wt 60 / 1000 [m/min]
  where the air is above 0 degC, else 0.
- the actual-ET ramp (``ETmethods.cpp:47-59``) on the static store's fill
  s = h_static / Hu: 0 up to the wilting point sw, e_max from stomatal
  closure ss up, linear between; e_max = min(PET, h_static).
- the day of year doy = doy0 + t / 1440, t in minutes from the run's start
  (``model_204.hpp:84``).

``integrate`` is a float64 Dormand-Prince 5(4) integrator at rtol 1e-10
over one window.  It cuts the window at every forcing sample's end and at
every query time, holds each forcing sample constant over its span, and
reports the state at each query time as the end of a step (no
interpolant).  Each row takes its own adaptive steps; the rows are
evaluated together and a row that has reached a segment's end is held
there.  The right-hand side sees ``t_shift + t``, the window's start plus
the time within it.

Departures from the reference's code:

- the start date: the reference fixes doy0 = 1 (``model_204.hpp:84``, a run
  that starts on January 1); here ``doy0`` is an argument.
- polar day and night: where the CBM argument of acos leaves [-1, 1], the
  reference computes D, tests it for NaN and picks day or night by a sign
  rule; here acos takes its limits (argument 1 or more: 24 h of daylight;
  -1 or less: none).  The two differ only within ~0.8 deg of the poles.
- every branch is a select over the rows.

This file imports ``torch`` and ``math`` only: nothing of the port, of the
JAX package or of the benchmark.
"""

import math

import torch

N_EQ = 5
#: Names of the states, in order.
STATES = ("snow", "static", "surface", "grav", "aquifer")
#: Cold-start state of the reference's main program.
Y_COLD = (0.01, 3.0, 0.0, 5.0, 0.2)
#: The integrator's tolerances: four orders of magnitude below the
#: reference's own rtol 1e-6, so that its error is a small part of any gap.
RTOL = 1e-10
ATOL = 1e-14

# Dormand-Prince 5(4) (Dormand and Prince 1980).
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
# Fifth-order minus embedded fourth-order weights; the seventh stage is f(y_new).
_E = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40)


def hamon_pet(temp: torch.Tensor, lat: torch.Tensor, doy: torch.Tensor) -> torch.Tensor:
    """Hamon potential ET [m/min] at air temperature ``temp`` [degC],
    latitude ``lat`` [degrees] and day of year ``doy``."""
    esat = 6.108 * torch.exp(17.26939 * temp / (temp + 237.3))
    wt = 216.7 * esat / (temp + 273.3)
    theta = 0.2163108 + 2.0 * torch.atan(0.9671396 * torch.tan(0.00860 * (doy - 186.0)))
    phi = torch.asin(0.39795 * torch.cos(theta))
    lat_rad = lat * math.pi / 180.0
    arg = ((math.sin(0.8333 * math.pi / 180.0) + torch.sin(lat_rad) * torch.sin(phi))
           / (torch.cos(lat_rad) * torch.cos(phi)))
    daylight = (24.0 - (24.0 / math.pi) * torch.acos(torch.clamp(arg, -1.0, 1.0))) / 12.0
    pet = 1.6169e-6 * daylight * daylight * wt * 60.0 / 1000.0
    return torch.where(temp > 0.0, pet, torch.zeros_like(pet))


def et_actual(e_max: torch.Tensor, s: torch.Tensor, sw: torch.Tensor,
              ss: torch.Tensor) -> torch.Tensor:
    """Actual ET on the static store's fill ``s``: 0 up to the wilting point
    ``sw``, ``e_max`` from stomatal closure ``ss`` up, linear between."""
    ramp = e_max * (s - sw) / (ss - sw)
    return torch.where(s > ss, e_max, torch.where(s > sw, ramp, torch.zeros_like(ramp)))


def rhs(t: torch.Tensor, y: torch.Tensor, p: dict, rain: torch.Tensor, temp: torch.Tensor,
        doy0: float) -> torch.Tensor:
    """dy/dt [R, N_EQ] of states ``y`` [R, N_EQ] at times ``t`` [R], minutes
    from the run's start; ``p`` holds the raw parameters, one [R] tensor each."""
    snow, stat, surf, grav, aq = y.unbind(1)
    zero = torch.zeros_like(snow)
    # Snow: melt above the temperature threshold, at most the pack.
    melt = torch.where(temp >= p["temp_thr"], torch.minimum(snow, temp * p["melt_f"]), zero)
    x1 = rain + melt
    # Static store: overflow above Hu, and actual ET out.
    x2 = torch.maximum(zero, x1 + stat - p["Hu"])
    doy = doy0 + t / 1440.0
    e_max = torch.minimum(hamon_pet(temp, p["lat"], doy), stat)
    et = et_actual(e_max, stat / p["Hu"], p["sw"], p["ss"])
    # Surface store: infiltration, and Manning's runoff with the base clamped at 0.
    x3 = torch.minimum(x2, p["infil"])
    alfa2 = torch.maximum(surf, zero) ** (2.0 / 3.0) * torch.sqrt(p["slope"]) / p["n_mann"]
    w = torch.minimum(zero + 1.0, alfa2 * p["L"] / p["A_h"] * 60.0)
    # Gravitational store and aquifer: percolation, and linear reservoirs.
    x4 = torch.minimum(x3, p["perco"])
    out3 = torch.where(p["alpha3"] >= 1.0, grav / p["alpha3"], zero)
    out4 = torch.where(p["alpha4"] >= 1.0, aq / p["alpha4"], zero)
    return torch.stack([
        rain - melt,
        (x1 - x2) - et,
        (x2 - x3) - surf * w,
        (x3 - x4) - out3,
        x4 - out4,
    ], dim=1)


def _segment(start, y, p, rain, temp, doy0, length, h, rtol, atol, max_steps=100_000):
    """Integrate ``y`` [R, N] over [start, start + length] minutes of constant
    forcing, each row from its step ``h`` [R]; returns (y, h)."""
    t = torch.zeros_like(h)
    done = torch.zeros_like(h, dtype=torch.bool)
    k1 = rhs(start + t, y, p, rain, temp, doy0)
    for _ in range(max_steps):
        remaining = length - t
        step = torch.where(done, torch.zeros_like(h), torch.minimum(h, remaining))
        now = start + t
        ks = [k1]
        for s in range(1, 6):
            acc = sum(a * k for a, k in zip(_A[s], ks))
            ks.append(rhs(now + _C[s] * step, y + step[:, None] * acc, p, rain, temp, doy0))
        y_new = y + step[:, None] * sum(b * k for b, k in zip(_B, ks))
        k7 = rhs(now + step, y_new, p, rain, temp, doy0)
        err = step[:, None] * sum(e * k for e, k in zip(_E, ks + [k7]))
        scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
        e = torch.sqrt(torch.mean((err / scale) ** 2, dim=1))
        finite = torch.isfinite(e) & torch.isfinite(y_new).all(dim=1)
        ok = (e <= 1.0) & finite & ~done
        fac = torch.clamp(0.9 * torch.clamp_min(e, 1e-12) ** -0.2, 0.2, 5.0)
        fac = torch.where(finite, fac, torch.full_like(fac, 0.2))
        fac = torch.where(ok, fac, torch.clamp_max(fac, 0.9))
        # A step cut short at the segment's end keeps the step it was given.
        h_next = torch.where(ok & (step < h), torch.maximum(h, step * fac), step * fac)
        h = torch.where(done, h, h_next)
        y = torch.where(ok[:, None], y_new, y)
        k1 = torch.where(ok[:, None], k7, k1)
        t = torch.where(ok, torch.where(step >= remaining, torch.full_like(t, length), t + step), t)
        done = done | (ok & (t >= length))
        if bool(done.all()):
            return y, h
        if bool((h[~done] < 1e-15 * max(length, 1.0)).any()):
            raise FloatingPointError("reference step size collapsed")
    raise FloatingPointError("reference did not finish a segment")


def integrate(y0: torch.Tensor, params: dict, forcing, forcing_dt, length: float, queries,
              t_shift: float = 0.0, doy0: float = 1.0, rtol: float = RTOL,
              atol: float = ATOL) -> tuple:
    """Integrate rows from ``y0`` [R, N] over one window of ``length`` minutes.

    ``params``: {name: [R]}, the raw parameters; ``forcing``: one [T_j, R]
    tensor a forcing (rain, then temperature), sample k of forcing j held over
    [k dt_j, (k + 1) dt_j) of the window with ``forcing_dt[j]`` = dt_j;
    ``queries``: window-relative times in (0, length], ascending.  The
    window starts ``t_shift`` minutes after the run's start, whose day of
    year is ``doy0``.  Returns (dense [R, Q, N] at the queries, final [R, N]),
    in float64.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f64 = torch.float64
    y = y0.to(f64).clone()
    p = {k: v.to(f64) for k, v in params.items()}
    forcing = [f.to(f64) for f in forcing]
    queries = [float(q) for q in queries]
    cuts = {float(length)} | {q for q in queries if 0.0 < q < length}
    for dt in forcing_dt:
        cuts |= {k * float(dt) for k in range(1, math.ceil(length / dt - 1e-9))}
    bounds = sorted(cuts)
    h = torch.full((y.shape[0],), 1e-3, dtype=f64, device=y.device)
    at = {}
    lo = 0.0
    for hi in bounds:
        rain, temp = (f[math.floor(lo / dt + 1e-9)] for f, dt in zip(forcing, forcing_dt))
        y, h = _segment(t_shift + lo, y, p, rain, temp, doy0, hi - lo, h, rtol, atol)
        at[hi] = y
        lo = hi
    dense = torch.stack([at[q] for q in queries], dim=1)
    return dense, y
