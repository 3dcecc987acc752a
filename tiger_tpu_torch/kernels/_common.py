"""What the two kernels' wrappers and plain versions share.

The ctypes mirrors of ``csrc/common.cuh``'s ForcingMeta (one a scalar), the
check of a CUDA launch's inputs, the launch itself, and the plain versions'
parameter and dense-output helpers.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from tiger_tpu_torch.forcing import ZOH_SNAP, ForcingSet
from tiger_tpu_torch.kernels import _build
from tiger_tpu_torch.models.dummy import DummyModel
from tiger_tpu_torch.models.model200 import Model200
from tiger_tpu_torch.models.model204 import PARAM_FIELDS, Model204
from tiger_tpu_torch.solver.config import SolverConfig

N_EQ = 5
MAX_FORCINGS = 4
c_float, c_i32, c_i64, c_ptr = ctypes.c_float, ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
#: The kernels' scalar T of each solve dtype: float instances take float32
#: tensors, double instances float64 ones.
C_REAL = {torch.float32: c_float, torch.float64: ctypes.c_double}


def _forcing_meta_type(real):
    class ForcingMetaC(ctypes.Structure):
        """Mirror of ``tt::ForcingMeta<T>`` (csrc/common.cuh)."""

        _fields_ = [
            ("n_forc", c_i32),
            ("offset", c_i32 * MAX_FORCINGS),
            ("n_steps", c_i32 * MAX_FORCINGS),
            ("dt", real * MAX_FORCINGS),
            ("n_cap", c_i32),
            ("cap_n_steps", c_i32 * MAX_FORCINGS),
            ("cap_dt", real * MAX_FORCINGS),
            ("snap", real),
            ("align", c_i32),
        ]

    return ForcingMetaC


#: ``tt::ForcingMeta<T>`` by solve dtype.
FORCING_META = {dtype: _forcing_meta_type(real) for dtype, real in C_REAL.items()}


def c_reals(x, real=c_float):
    """numpy 1-D/2-D array -> ctypes array of ``real`` (c_float rounds the
    values to float32; c_double keeps them)."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        return (real * len(x))(*x.tolist())
    row_t = real * x.shape[1]
    return (row_t * x.shape[0])(*[row_t(*r.tolist()) for r in x])


def forcing_meta_c(forcings: ForcingSet | None, config: SolverConfig,
                   dtype: torch.dtype = torch.float32) -> ctypes.Structure:
    """The kernels' ForcingMeta of ``forcings`` for a solve in ``dtype``."""
    m = FORCING_META[dtype]()
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


#: The models the kernels carry, by class: each one's id in the argument
#: structs (csrc/common.cuh KernelModel), the prefix of its instances'
#: names in the launch counters (none for Model 204's), and whether its
#: instances read the [15, S] parameter block and ``safe_pow`` (Model 204's
#: stores).  Looked up by exact type: a subclass may change the rhs, which
#: the instances would not see.
KERNEL_MODELS = {Model204: (0, "", True), Model200: (1, "m200/", True),
                 DummyModel: (2, "dummy/", False)}


def kernel_model(name: str, model) -> tuple[int, str, bool]:
    """(kernel model id, instance-name prefix, reads params) of ``model``;
    raises for a model the kernels do not carry (no fallback for a CUDA
    tensor)."""
    try:
        return KERNEL_MODELS[type(model)]
    except KeyError:
        raise NotImplementedError(
            f"{name}: the CUDA kernel carries Model 204, Model 200 and DummyModel only, got "
            f"{type(model).__name__} (a model the kernels run is a template argument of "
            f"csrc/common.cuh with an entry in KERNEL_MODELS)"
        ) from None


def kernel_inputs(name, model, y0, h0, params, forcings, query_times, t_shift=0.0):
    """Validate a CUDA launch's inputs; returns (y0 [5,S], params [15,S]),
    the params block None for a model whose instances read no parameter
    (DummyModel: ``params`` may then be None or any dict, which is not
    read, as ``run()`` passes the CSV's fields whatever the model).

    The kernels take the models of ``KERNEL_MODELS`` in float32 or float64
    (y0's dtype), with h0, every param and the query times in y0's dtype,
    the forcing data in float32, and every tensor on y0's device: anything
    else raises (there is no fallback for a CUDA tensor).  A finite time
    shift reaches the rhs of every model (the argument structs'
    ``t_shift``).
    """
    reads = kernel_model(name, model)[2]
    if not math.isfinite(t_shift):
        raise ValueError(f"{name}: t_shift must be finite, got {t_shift}")
    dev, s_count = y0.device, y0.shape[0]
    if y0.dtype not in C_REAL:
        raise TypeError(f"{name}: y0 must be float32 or float64, got {y0.dtype}")

    def check(label, x, shape, dtype=y0.dtype):
        if not torch.is_tensor(x):
            raise TypeError(f"{name}: {label} must be a tensor")
        if x.device != dev:
            raise ValueError(f"{name}: {label} is on {x.device}, y0 on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype} (y0 is {y0.dtype}), got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")

    check("y0", y0, (s_count, N_EQ))
    check("h0", h0, (s_count,))
    if reads:
        missing = [k for k in PARAM_FIELDS if params is None or k not in params]
        if missing:
            raise ValueError(f"{name}: params lack {missing}")
        for k in PARAM_FIELDS:
            check(f"params[{k!r}]", params[k], (s_count,))
    elif params is not None and not isinstance(params, dict):
        raise TypeError(f"{name}: params must be None or a dict, got {type(params).__name__}")
    if forcings is not None:
        check("forcings.data", forcings.data, (forcings.data.shape[0], s_count), torch.float32)
    if query_times is not None:
        check("query_times", query_times, (query_times.shape[0],))
    block = torch.stack([params[k] for k in PARAM_FIELDS]) if reads else None
    return y0.t().contiguous(), block


def data_ptr(x: torch.Tensor | None) -> int:
    return 0 if x is None else x.data_ptr()


#: What a launcher returns for an option set that has no instance of its
#: kernel (csrc/common.cuh kNoInstance).
_NO_INSTANCE = -1


#: Held while a wrapper adds to its launch count: solve(devices=...) runs its
#: parts in threads.
COUNT_LOCK = threading.Lock()


def launch(fn_name: str, size_name: str, args: ctypes.Structure, f64: bool, device,
           options: str) -> None:
    """Enqueue a kernel on the device's current stream; raise if refused.
    ``f64`` picks the double instances (``args`` is then the double
    struct); ``options`` names the option set the arguments ask for."""
    lib = _build.load()
    if getattr(lib, size_name)(int(f64)) != ctypes.sizeof(args):
        raise RuntimeError(f"{fn_name}: argument struct differs from the built library's")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(ctypes.addressof(args), int(f64), stream)
    if rc == _NO_INSTANCE:
        raise NotImplementedError(f"{fn_name}: the kernel has no instance for {options}")
    if rc != 0:
        raise RuntimeError(f"{fn_name} ({options}): CUDA error {rc}")


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
    does.  Each value is the same elementwise arithmetic whichever way it
    is computed: query by query when a system fills at most
    ``_FILL_LOOP_MAX`` queries, else every (query, system) pair at once."""
    if qt is None or qt.shape[0] == 0:
        return
    lo = torch.searchsorted(qt, t.contiguous(), right=True)
    hi = torch.searchsorted(qt, t1.contiguous(), right=True)
    count = torch.where(mask, hi - lo, torch.zeros_like(lo))
    n_fill, total = torch.stack([count.max(), count.sum()]).tolist()  # the one host sync
    if n_fill == 0:
        return
    qm = coeffs()

    def interpolate(theta, q_m, y_s, h_s):
        th2 = theta * theta
        poly = q_m[0] * theta + q_m[1] * th2 + q_m[2] * th2 * theta
        if len(q_m) > 3:
            poly = poly + q_m[3] * th2 * th2
        return y_s + h_s * poly

    if n_fill > _FILL_LOOP_MAX:
        cols = torch.repeat_interleave(torch.arange(t.shape[0], device=t.device), count,
                                       output_size=total)
        first = torch.cumsum(count, 0) - count
        qi = lo[cols] + (torch.arange(total, device=t.device) - first[cols])
        h_s = h_eff[cols]
        yd = interpolate((qt[qi] - t[cols]) / h_s, [m[:, cols] for m in qm], y[:, cols], h_s)
        dense[qi, :, cols] = yd.t()
        return
    cols = torch.arange(t.shape[0], device=t.device)
    for j in range(n_fill):
        pred = j < count
        qi = torch.clamp(lo + j, max=qt.shape[0] - 1)
        theta = torch.where(pred, (qt[qi] - t) / h_eff, torch.zeros_like(t))
        yd = interpolate(theta, qm, y, h_eff)
        dense[qi, :, cols] = torch.where(pred[:, None], yd.t(), dense[qi, :, cols])


#: fill_dense's loop bound: one query costs it ~15 tensor ops a pass, all
#: pairs at once ~30.
_FILL_LOOP_MAX = 2


def finish(y, t, tf, dense):
    """(y_final [S, N] with NaN where t < tf, completed mask, dense [S, Q, N])
    from the state ``y`` [N, S] and the [Q, N, S] dense buffer."""
    completed = t >= tf
    nan = torch.full((), float("nan"), dtype=t.dtype, device=t.device)
    y_final = torch.where(completed, y, nan).t().contiguous()
    return y_final, completed, dense.permute(2, 0, 1).contiguous()
