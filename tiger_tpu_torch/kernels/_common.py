"""What the two kernels' wrappers and plain versions share.

The ctypes mirror of ``csrc/common.cuh``'s ForcingMeta, the check of a CUDA
launch's inputs, the launch itself, and the plain versions' parameter and
dense-output helpers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tiger_tpu_torch.forcing import ZOH_SNAP, ForcingSet
from tiger_tpu_torch.kernels import _build
from tiger_tpu_torch.models.model204 import PARAM_FIELDS, Model204
from tiger_tpu_torch.solver.config import SolverConfig

N_EQ = 5
MAX_FORCINGS = 4
c_float, c_i32, c_i64, c_ptr = ctypes.c_float, ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p


class ForcingMetaC(ctypes.Structure):
    """Mirror of ``tt::ForcingMeta`` (csrc/common.cuh)."""

    _fields_ = [
        ("n_forc", c_i32),
        ("offset", c_i32 * MAX_FORCINGS),
        ("n_steps", c_i32 * MAX_FORCINGS),
        ("dt", c_float * MAX_FORCINGS),
        ("n_cap", c_i32),
        ("cap_n_steps", c_i32 * MAX_FORCINGS),
        ("cap_dt", c_float * MAX_FORCINGS),
        ("snap", c_float),
        ("align", c_i32),
    ]


def c_floats(x):
    """numpy 1-D/2-D array -> ctypes float array (values rounded to f32)."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        return (c_float * len(x))(*x.tolist())
    row_t = c_float * x.shape[1]
    return (row_t * x.shape[0])(*[row_t(*r.tolist()) for r in x])


def forcing_meta_c(forcings: ForcingSet | None, config: SolverConfig) -> ForcingMetaC:
    m = ForcingMetaC()
    if forcings is None:
        return m
    meta = forcings.meta
    n = len(meta.offsets)
    if n > MAX_FORCINGS:
        raise ValueError(f"the CUDA kernels take at most {MAX_FORCINGS} forcings, got {n}")
    m.n_forc = n
    rows = forcings.data.shape[0]
    for j in range(n):
        if not (meta.offsets[j] >= 0 and meta.n_steps[j] >= 1 and meta.dt_min[j] > 0
                and meta.offsets[j] + meta.n_steps[j] <= rows):
            raise ValueError(
                f"forcing {j}: offset {meta.offsets[j]}, {meta.n_steps[j]} steps of "
                f"{meta.dt_min[j]} min do not fit the {rows}-row forcing data"
            )
        m.offset[j] = meta.offsets[j]
        m.n_steps[j] = meta.n_steps[j]
        m.dt[j] = meta.dt_min[j]
    caps = sorted(set(zip(meta.n_steps, meta.dt_min)))
    m.n_cap = len(caps)
    for j, (n_t, dt) in enumerate(caps):
        m.cap_n_steps[j] = n_t
        m.cap_dt[j] = dt
    m.align = int(config.forcing_step_align)
    m.snap = ZOH_SNAP if config.forcing_step_align else 0.0
    return m


def kernel_inputs(name, model, y0, h0, params, forcings, query_times):
    """Validate a CUDA launch's inputs; returns (y0 [5,S], params [15,S]).

    The kernels take Model 204 in float32 with every tensor on y0's device:
    anything else raises (there is no fallback for a CUDA tensor).
    """
    if not isinstance(model, Model204):
        raise NotImplementedError(
            f"{name}: the CUDA kernel implements Model204 only, got {type(model).__name__}"
        )
    dev, s_count = y0.device, y0.shape[0]

    def check(label, x, shape):
        if not torch.is_tensor(x):
            raise TypeError(f"{name}: {label} must be a tensor")
        if x.device != dev:
            raise ValueError(f"{name}: {label} is on {x.device}, y0 on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")

    check("y0", y0, (s_count, N_EQ))
    check("h0", h0, (s_count,))
    missing = [k for k in PARAM_FIELDS if params is None or k not in params]
    if missing:
        raise ValueError(f"{name}: params lack {missing}")
    for k in PARAM_FIELDS:
        check(f"params[{k!r}]", params[k], (s_count,))
    if forcings is not None:
        check("forcings.data", forcings.data, (forcings.data.shape[0], s_count))
    if query_times is not None:
        check("query_times", query_times, (query_times.shape[0],))
    return y0.t().contiguous(), torch.stack([params[k] for k in PARAM_FIELDS])


def data_ptr(x: torch.Tensor | None) -> int:
    return 0 if x is None else x.data_ptr()


def launch(fn_name: str, size_name: str, args: ctypes.Structure, device) -> None:
    """Enqueue a kernel on the device's current stream; raise if refused."""
    lib = _build.load()
    if getattr(lib, size_name)() != ctypes.sizeof(args):
        raise RuntimeError(f"{fn_name}: argument struct differs from the built library's")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(ctypes.addressof(args), stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")


# ---------------------------------------------------------------------------
# Plain-version helpers
# ---------------------------------------------------------------------------


def plain_params(model, params, dtype):
    """Params in the solve dtype, with the model's hoisted invariants."""
    if params is None:
        return None
    p = {k: v.to(dtype) for k, v in params.items()}
    return model.derived_params(p) if hasattr(model, "derived_params") else p


def dense_init(qt, y, t0, config: SolverConfig) -> torch.Tensor:
    """[Q, N, S] dense buffer for the state ``y`` [N, S]: y0 in the rows
    with qt <= t0 (fill_t0_queries), zeros elsewhere."""
    q_total = 0 if qt is None else qt.shape[0]
    dense = torch.zeros((q_total, *y.shape), dtype=y.dtype, device=y.device)
    if q_total and config.fill_t0_queries:
        dense[qt <= t0] = y
    return dense


def fill_dense(dense, qt, t, t1, mask, h_eff, y, coeffs) -> None:
    """Write the interpolant into every query in (t, t1] of the masked
    systems.  ``coeffs()`` gives the theta-monomial coefficients, 3 or 4
    tensors [N, S]; it is called only if some system has a query to fill.
    Each system writes its own queries, as the kernels' per-system cursor
    does."""
    if qt is None or qt.shape[0] == 0:
        return
    lo = torch.searchsorted(qt, t.contiguous(), right=True)
    hi = torch.searchsorted(qt, t1.contiguous(), right=True)
    count = torch.where(mask, hi - lo, torch.zeros_like(lo))
    n_fill = int(count.max())
    if n_fill == 0:
        return
    qm = coeffs()
    cols = torch.arange(t.shape[0], device=t.device)
    for j in range(n_fill):
        pred = j < count
        qi = torch.clamp(lo + j, max=qt.shape[0] - 1)
        theta = torch.where(pred, (qt[qi] - t) / h_eff, torch.zeros_like(t))
        th2 = theta * theta
        poly = qm[0] * theta + qm[1] * th2 + qm[2] * th2 * theta
        if len(qm) > 3:
            poly = poly + qm[3] * th2 * th2
        yd = y + h_eff * poly
        dense[qi, :, cols] = torch.where(pred[:, None], yd.t(), dense[qi, :, cols])


def finish(y, t, tf, dense):
    """(y_final [S, N] with NaN where t < tf, completed mask, dense [S, Q, N])
    from the state ``y`` [N, S] and the [Q, N, S] dense buffer."""
    completed = t >= tf
    nan = torch.full((), float("nan"), dtype=t.dtype, device=t.device)
    y_final = torch.where(completed, y, nan).t().contiguous()
    return y_final, completed, dense.permute(2, 0, 1).contiguous()
