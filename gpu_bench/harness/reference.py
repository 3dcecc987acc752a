"""The plain reference integrator: Dormand-Prince 5(4) in float64 NumPy.

It integrates a batch of systems of a model in ``gpu_bench/models`` over one
window, segment by segment: the segments are cut at every forcing sample's
boundary and at every query time, so that each segment sees constant
forcing (the zero-order hold) and ends on the times the program reports.
Inside a segment each system takes its own adaptive steps at a tolerance
far below the configuration's (``REF_RTOL``, ``REF_ATOL``); the batch is
computed whole and the finished systems masked, since at a few hundred
systems NumPy's per-call cost outweighs the arithmetic.

Nothing here imports the program or the JAX package: the check compares the
program's outputs with this integration of the same inputs.
"""

from __future__ import annotations

import numpy as np

#: Tolerances of the reference: three or more orders of magnitude below any
#: configuration's, so that its own error stays a small part of any limit.
REF_RTOL = 1e-10
REF_ATOL = 1e-14

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
# 5th-order minus embedded 4th-order weights; the 7th stage is f(y_new).
_E = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40)


def bf16(x) -> np.ndarray:
    """``x`` rounded to bfloat16 (to nearest, ties to even), held in float32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


class Segments:
    """The cut of a window [0, length] into segments of constant forcing.

    ``forcing_dt`` are the minutes of each forcing's samples; ``queries``
    the window-relative query times.  ``bounds`` are the sorted segment
    ends, ``index[j][s]`` the sample of forcing j that segment s reads, and
    ``query_slots`` the segment end of each query (-1: the window start).
    """

    def __init__(self, length: float, forcing_dt, queries):
        cuts = {float(length)}
        for dt in forcing_dt:
            cuts.update(float(k * dt) for k in range(1, int(np.ceil(length / dt - 1e-9))))
        cuts.update(float(q) for q in queries if 0.0 < q < length)
        self.bounds = np.array(sorted(c for c in cuts if 0.0 < c <= length))
        starts = np.concatenate([[0.0], self.bounds[:-1]])
        self.index = [np.floor(starts / dt + 1e-9).astype(np.int64) for dt in forcing_dt]
        pos = {b: s for s, b in enumerate(self.bounds)}
        self.query_slots = [-1 if q <= 0.0 else pos[float(q)] for q in queries]


def _norm(err, y, y_new, rtol, atol):
    scale = atol + rtol * np.maximum(np.abs(y), np.abs(y_new))
    return np.sqrt(np.mean((err / scale) ** 2, axis=0))


def _segment(rhs, start, y, q, forcing, t_end, h, rtol, atol, max_iter=200_000):
    """Integrate ``y`` [N, R] over [start, start + t_end] of constant
    ``forcing``, ``start`` in minutes from the run's start; each system
    starts with its step ``h`` [R].  Stage s sees the time t + c_s step, and
    the seventh stage, which is the next step's first, t + step.  Returns
    (y, h for the next segment, iterations)."""
    n_rows = y.shape[1]
    t = np.zeros(n_rows)
    done = np.zeros(n_rows, dtype=bool)
    k1 = rhs(np.full(n_rows, float(start)), y, q, *forcing)
    for it in range(1, max_iter + 1):
        remaining = t_end - t
        step = np.where(done, 0.0, np.minimum(h, remaining))
        now = start + t
        ks = [k1]
        for s in range(1, 6):
            acc = _A[s][0] * ks[0]
            for j in range(1, s):
                if _A[s][j]:
                    acc = acc + _A[s][j] * ks[j]
            ks.append(rhs(now + _C[s] * step, y + step * acc, q, *forcing))
        acc = _B[0] * ks[0]
        for j in range(2, 6):
            acc = acc + _B[j] * ks[j]
        y_new = y + step * acc
        k7 = rhs(now + step, y_new, q, *forcing)
        err = _E[0] * ks[0]
        for j in range(2, 6):
            err = err + _E[j] * ks[j]
        err = step * (err + _E[6] * k7)
        e = _norm(err, y, y_new, rtol, atol)
        finite = np.isfinite(e) & np.all(np.isfinite(y_new), axis=0)
        ok = (e <= 1.0) & finite & ~done
        e_safe = np.where(finite, np.maximum(e, 1e-12), np.inf)
        fac = np.clip(0.9 * e_safe ** -0.2, 0.2, 5.0)
        fac = np.where(ok, fac, np.minimum(fac, 0.9))
        capped = step < h
        h = np.where(done, h, np.where(ok & capped, np.maximum(h, step * fac), step * fac))
        y = np.where(ok, y_new, y)
        k1 = np.where(ok, k7, k1)
        t = np.where(ok, np.where(step >= remaining, t_end, t + step), t)
        done = done | (ok & (t >= t_end))
        if done.all():
            return y, h, it
        if np.any(h[~done] < 1e-15 * max(t_end, 1.0)):
            raise FloatingPointError("reference step size collapsed")
    raise FloatingPointError("reference did not finish a segment")


def integrate(model, y0, params, forcing, forcing_dt, length, queries,
              rtol=REF_RTOL, atol=REF_ATOL, t0=0.0, doy0=None):
    """Integrate systems from ``y0`` [R, N] over a window of ``length`` minutes.

    ``params``: {name: [R]}; ``forcing``: one [T_j, R] array a forcing, in
    the model's order, with samples every ``forcing_dt[j]`` minutes from the
    window start; ``queries``: window-relative query times, ascending.  The
    window starts ``t0`` minutes after the run's start, the time the model's
    right-hand side reads; ``doy0``, the day of year at the run's start, goes
    to the model's ``derived`` (a model blind to time reads neither).
    Returns (dense [R, Q, N], final [R, N], iterations).
    """
    seg = Segments(length, forcing_dt, queries)
    q = model.derived({k: np.asarray(v, np.float64) for k, v in params.items()}, doy0=doy0)
    y0 = np.asarray(y0, np.float64)
    y = y0.T.copy()
    h = np.full(y.shape[1], 1e-3)
    ends = []
    iters = 0
    for s, t_end in enumerate(seg.bounds):
        t_start = seg.bounds[s - 1] if s else 0.0
        f = [np.asarray(f_j[idx[s]], np.float64) for f_j, idx in zip(forcing, seg.index)]
        y, h, n = _segment(model.rhs, t0 + t_start, y, q, f, t_end - t_start, h, rtol, atol)
        ends.append(y)
        iters += n
    dense = np.stack([y0.T if slot < 0 else ends[slot] for slot in seg.query_slots])
    return np.transpose(dense, (2, 0, 1)), y.T.copy(), iters
