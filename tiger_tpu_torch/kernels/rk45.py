"""B1, fused adaptive RK45: the CUDA kernel's wrapper and its plain version.

``rk45`` integrates every system from t0 to tf with Dormand-Prince 5(4),
ZOH forcing, the stiffness criteria and dense output -- the work of the TPU
kernel ``tiger_tpu/kernels/rk45_pallas.py`` (``_make_kernel``'s ``kernel``,
reached through ``pl.pallas_call`` at l.1051).  A CUDA tensor goes to the
hand-written kernel ``csrc/rk45.cu`` (or the call raises): its float
instances for float32, its double instances for float64, one of each for
every option set.  A CPU tensor goes to ``rk45_plain``, the same
per-system semantics as a batched, masked while-loop in torch.  ``rk45_launches`` counts the
kernel's launches by instance, ``rk45_option_launches`` those with the
runtime options (the lockstep query crossing, bf16 forcing);
``rk45_options`` picks the kernel's instance
for a ``SolverConfig``,
``rk45_geometry`` says how a launch is laid out on the card,
``rk45_mismatch`` counts where two results differ bit for bit, and
``read_probes`` reads the per-warp counters of the ``PROBE_FLAGS`` build.
"""

from __future__ import annotations

import ctypes

import torch

from tiger_tpu_torch import elementwise
from tiger_tpu_torch.forcing import (
    ZOH_SNAP,
    ForcingSet,
    forcing_index_changed,
    gather_forcings_column,
    zoh_step_cap,
)
from tiger_tpu_torch.kernels import _build
from tiger_tpu_torch.kernels._common import (
    C_REAL,
    b1_forcing_data,
    COUNT_LOCK,
    FORCING_META,
    N_EQ,
    c_i32,
    c_i64,
    c_ptr,
    data_ptr,
    dense_init,
    fill_dense,
    finish,
    forcing_meta_c,
    KERNEL_MODELS,
    kernel_inputs,
    kernel_model,
    launch,
    plain_params,
)
from tiger_tpu_torch.profiling import span
from tiger_tpu_torch.solver import tableau
from tiger_tpu_torch.solver.config import SolverConfig
from tiger_tpu_torch.solver.rk45 import RK45Result, RKStats


def _args_type(dtype):
    real = C_REAL[dtype]

    class Rk45ArgsC(ctypes.Structure):
        """Mirror of ``tt::Rk45Args<T>`` (csrc/rk45.cu)."""

        _fields_ = [
            ("y0", c_ptr), ("h0", c_ptr), ("params", c_ptr), ("forc", c_ptr), ("qt", c_ptr),
            ("y_final", c_ptr), ("dense", c_ptr), ("stiff", c_ptr), ("failed", c_ptr),
            ("stats", c_ptr),
            ("n_sys", c_i64), ("n_q", c_i32), ("safe_pow", c_i32),
            ("t0", real), ("tf", real), ("h_floor", real),
            ("rtol", real), ("atol", real), ("safety", real),
            ("min_scale", real), ("max_scale", real), ("expo", real),
            ("slope_jump_thresh", real), ("min_step_fraction", real),
            ("nan_shrink", real), ("stiff_hlamb", real), ("pi_beta", real),
            ("max_rejects", c_i32), ("max_steps", c_i32), ("stiff_detect", c_i32),
            ("stiff_streak", c_i32), ("stiff_forgive", c_i32),
            ("stiff_test_every", c_i32), ("stiff_floor_streak", c_i32),
            ("fill_t0_queries", c_i32), ("options", c_i32),
            ("forcing", FORCING_META[dtype]),
            ("model", c_i32), ("t_shift", real), ("doy0", real),
            ("lockstep", c_i32), ("forc_bf16", c_ptr),
        ]

    return Rk45ArgsC


#: ``tt::Rk45Args<T>`` by solve dtype.
ARGS = {dtype: _args_type(dtype) for dtype in C_REAL}

#: Option bits of ``Rk45Args.options`` (csrc/rk45.cu ``Rk45Option``);
#: RUNTIME: the instance reads ``Rk45Args.lockstep`` and ``.forc_bf16``.
FSAL, COMPENSATED, PI, RUNTIME = 1, 2, 4, 8
_SETS = {0: "default", FSAL: "fsal", COMPENSATED: "compensated", PI: "pi",
         FSAL | PI: "fsal+pi", COMPENSATED | PI: "compensated+pi"}
#: The option sets B1 has a float instance for: {I, PI} x {plain, FSAL,
#: compensated}, each without and with RUNTIME ('+runtime').
INSTANCES = {**_SETS, **{bits | RUNTIME: name + "+runtime" for bits, name in _SETS.items()}}
#: The same option sets' double instances.
F64_INSTANCES = {bits: name + "/f64" for bits, name in INSTANCES.items()}


def instance_name(options: int, dtype: torch.dtype = torch.float32, prefix: str = "") -> str:
    """B1's instance of the option bits ``options`` in ``dtype`` for the
    model whose ``_common.KERNEL_MODELS`` prefix is ``prefix``: e.g.
    'default', 'pi/f64', 'm200/fsal+pi', 'm200/compensated/f64'."""
    return prefix + (F64_INSTANCES if dtype == torch.float64 else INSTANCES)[options]


#: Kernel launches by instance (``instance_name``) since import (or since a
#: caller set them to 0: ``kernels.reset_launch_counts``).
rk45_launches = dict.fromkeys(
    [instance_name(bits, dtype, prefix) for _, prefix, _ in KERNEL_MODELS.values()
     for dtype in C_REAL for bits in INSTANCES], 0)


#: Launches with each runtime option of the RUNTIME instances
#: (Rk45Args.lockstep, .forc_bf16), named as the instances are ('lockstep',
#: 'm200/lockstep/f64', 'bf16', 'dummy/bf16'; bf16 reaches float32 only);
#: counted beside ``rk45_launches``.
rk45_option_launches = dict.fromkeys(
    [prefix + "lockstep" + suffix for _, prefix, _ in KERNEL_MODELS.values()
     for suffix in ("", "/f64")] + [prefix + "bf16" for _, prefix, _ in KERNEL_MODELS.values()], 0)


def rk45_options(config: SolverConfig) -> int:
    """The option bits of ``config``: which instance of B1 runs it (RUNTIME
    with lockstep or bf16 forcing)."""
    return ((FSAL if config.fsal else 0) | (COMPENSATED if config.compensated else 0)
            | (PI if config.controller == "pi" else 0)
            | (RUNTIME if config.dense_lockstep or config.forcing_dtype == "bf16" else 0))


def controller_exponent(config: SolverConfig) -> float:
    """The error exponent of the step controller: 1/5, or 1/5 - 0.75 beta
    for the PI controller (rk45_pallas.py l.629)."""
    return 0.2 - config.pi_beta * 0.75 if config.controller == "pi" else 0.2


def rk45_geometry(n_sys: int, options: int = 0, dtype: torch.dtype = torch.float32,
                  model=None) -> dict:
    """How the instance of (``model``, ``options``, ``dtype``) lays
    ``n_sys`` systems out on the current CUDA device: blocks, threads a
    block, pool slots, attempts a time slice and dynamic shared memory a
    block (csrc/rk45.cu).  ``model`` defaults to Model 204."""
    model_id = 0 if model is None else kernel_model("rk45_geometry", model)[0]
    out = (c_i32 * 5)()
    rc = _build.load().tt_rk45_geometry(n_sys, options, int(dtype == torch.float64), model_id, out)
    if rc != 0:
        raise RuntimeError(f"tt_rk45_geometry: CUDA error {rc}")
    keys = ("blocks", "threads", "pool_slots", "slice_attempts", "shared_bytes")
    return dict(zip(keys, out))


def rk45(
    model,
    y0: torch.Tensor,
    h0: torch.Tensor,
    t0: float,
    tf: float,
    query_times: torch.Tensor | None = None,
    params: dict | None = None,
    forcings: ForcingSet | None = None,
    config: SolverConfig = SolverConfig(),
    t_shift: float = 0.0,
) -> RK45Result:
    """B1 over ``y0[S, N]`` from t0 to tf; ``query_times`` sorted and unique.

    CPU tensors run ``rk45_plain``; CUDA tensors launch the kernel on the
    current stream without synchronising (Model 204 or Model 200 in float32
    or float64; any other input raises).  ``t_shift`` [min] is added to the time the
    model's rhs sees (forcing gathers stay unshifted).
    """
    if y0.device.type == "cpu":
        return rk45_plain(model, y0, h0, t0, tf, query_times, params, forcings, config, t_shift)
    if y0.device.type != "cuda":
        raise ValueError(f"rk45: no implementation for device {y0.device}")
    return _rk45_cuda(model, y0, h0, t0, tf, query_times, params, forcings, config, t_shift)


def _rk45_cuda(model, y0, h0, t0, tf, qt, params, forcings, cfg, t_shift=0.0) -> RK45Result:
    options = rk45_options(cfg)
    with span("tiger.b1.inputs"):
        y0_soa, p_block = kernel_inputs("rk45", model, y0, h0, params, forcings, qt, t_shift)
        # The bf16 copy, made on the device for this launch (float32 only).
        f_data = None if forcings is None else b1_forcing_data(forcings, cfg, y0.dtype)
    forc_bf16 = f_data if f_data is not None and f_data.dtype == torch.bfloat16 else None
    model_id, prefix, reads_params = kernel_model("rk45", model)
    s_count, dev, dtype = y0.shape[0], y0.device, y0.dtype
    f64 = dtype == torch.float64
    q_total = 0 if qt is None else qt.shape[0]
    y_final = torch.empty((N_EQ, s_count), dtype=dtype, device=dev)
    dense = torch.empty((q_total, N_EQ, s_count), dtype=dtype, device=dev)
    flags = torch.empty((2, s_count), dtype=torch.int32, device=dev)  # stiff, failed
    stats = torch.empty((3, s_count), dtype=torch.int32, device=dev)
    a = ARGS[dtype](
        y0=y0_soa.data_ptr(), h0=h0.data_ptr(), params=data_ptr(p_block),
        forc=data_ptr(None if forcings is None else forcings.data), qt=data_ptr(qt),
        y_final=y_final.data_ptr(), dense=dense.data_ptr(),
        stiff=flags[0].data_ptr(), failed=flags[1].data_ptr(), stats=stats.data_ptr(),
        n_sys=s_count, n_q=q_total, safe_pow=int(reads_params and model.safe_pow),
        t0=t0, tf=tf, h_floor=(tf - t0) * cfg.min_step_fraction,
        rtol=cfg.rtol, atol=cfg.atol, safety=cfg.safety,
        min_scale=cfg.min_scale, max_scale=cfg.max_scale, expo=controller_exponent(cfg),
        slope_jump_thresh=cfg.slope_jump_thresh,
        min_step_fraction=cfg.min_step_fraction, nan_shrink=cfg.nan_shrink,
        stiff_hlamb=cfg.stiff_hlamb, pi_beta=cfg.pi_beta, max_rejects=cfg.max_rejects,
        max_steps=cfg.max_steps, stiff_detect=int(cfg.stiff_detect),
        stiff_streak=cfg.stiff_streak, stiff_forgive=cfg.stiff_forgive,
        stiff_test_every=cfg.stiff_test_every,
        stiff_floor_streak=cfg.stiff_floor_streak,
        fill_t0_queries=int(cfg.fill_t0_queries), options=options,
        model=model_id, t_shift=t_shift, doy0=getattr(model, "doy0", 1.0),
        forcing=forcing_meta_c(forcings, cfg, dtype),
        lockstep=int(cfg.dense_lockstep), forc_bf16=data_ptr(forc_bf16),
    )
    launch("tt_rk45_launch", "tt_rk45_args_size", a, f64, dev,
           f"fsal={cfg.fsal}, compensated={cfg.compensated}, controller={cfg.controller!r}, "
           f"dense_lockstep={cfg.dense_lockstep}, forcing_dtype={cfg.forcing_dtype!r} "
           f"({type(model).__name__})")
    with COUNT_LOCK:
        rk45_launches[instance_name(options, dtype, prefix)] += 1
        if cfg.dense_lockstep:
            rk45_option_launches[prefix + "lockstep" + ("/f64" if f64 else "")] += 1
        if forc_bf16 is not None:
            rk45_option_launches[prefix + "bf16"] += 1
    with span("tiger.b1.outputs"):
        y_final, dense = y_final.t().contiguous(), dense.permute(2, 0, 1).contiguous()
    return RK45Result(
        y_final=y_final,
        dense=dense,
        stiff=flags[0] != 0,
        failed=flags[1] != 0,
        h0=h0,
        stats=RKStats(n_accepted=stats[0], n_rejected=stats[1], n_attempts=stats[2]),
    )


#: The package's build with per-warp probes in B1 (csrc/rk45.cu).
PROBE_FLAGS = _build.NVCC_FLAGS + ("-DTT_RK45_PHASES",)
PROBE_WORDS = 13  # csrc/rk45.cu kProbeWords


def read_probes(n_warps: int) -> list:
    """[n_warps][PROBE_WORDS] probe records of the last B1 launch, of any
    instance (start ns, end ns, SM, trips, trips with a dense fill,
    attempts, most attempts of a lane, cycles in the run section, cycles in
    all, systems its lanes took after their first in a slice, trips
    through the refill path, cycles of the trips through the attempt and
    through the refill path).  Call it inside
    ``_build.flags_in_use(PROBE_FLAGS)``; it waits for the device."""
    lib = _build.load()
    lib.tt_rk45_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tt_rk45_probe_read.restype = ctypes.c_int
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (n_warps * PROBE_WORDS))()
    rc = lib.tt_rk45_probe_read(buf, n_warps)
    if rc:
        raise RuntimeError(f"tt_rk45_probe_read: CUDA error {rc}")
    flat = list(buf)
    return [flat[i:i + PROBE_WORDS] for i in range(0, len(flat), PROBE_WORDS)]


def lane_efficiency(records) -> float:
    """Attempts over 32 x warp trips: the share of the lanes a warp ran that worked."""
    return sum(w[5] for w in records) / (32 * sum(w[3] for w in records))


def lockstep_cursor(qt: torch.Tensor, cursor: torch.Tensor, t: torch.Tensor,
                    act: torch.Tensor) -> torch.Tensor:
    """Advance each active system's lockstep cursor past every query it has
    reached: t >= tq - (4.8e-7 |tq| + 1e-6), the TPU kernel's landing
    tolerance (a Kahan commit may stop an ulp short of a query)."""
    n_q = qt.shape[0]
    while True:
        tq = qt[torch.clamp(cursor, max=n_q - 1)]
        reached = act & (cursor < n_q) & (t >= tq - (4.8e-7 * torch.abs(tq) + 1e-6))
        if not bool(reached.any()):
            return cursor
        cursor = cursor + reached.to(cursor.dtype)


def rk45_mismatch(a: RK45Result, b: RK45Result) -> dict:
    """How many entries of each field differ between two results, bit for
    bit: a NaN equals a NaN in the same place, nothing else is forgiven."""

    def n_diff(x, y) -> int:
        same = torch.isnan(x) == torch.isnan(y)
        return int((~same | (torch.nan_to_num(x) != torch.nan_to_num(y))).sum())

    out = {"y_final": n_diff(a.y_final, b.y_final), "dense": n_diff(a.dense, b.dense),
           "stiff": int((a.stiff != b.stiff).sum()), "failed": int((a.failed != b.failed).sum())}
    for name, x, y in zip(RKStats._fields, a.stats, b.stats):
        out[name] = int((x != y).sum())
    return out


def rk45_plain(
    model,
    y0: torch.Tensor,
    h0: torch.Tensor,
    t0: float,
    tf: float,
    query_times: torch.Tensor | None = None,
    params: dict | None = None,
    forcings: ForcingSet | None = None,
    config: SolverConfig = SolverConfig(),
    t_shift: float = 0.0,
    *,
    steps: list | None = None,
) -> RK45Result:
    """B1's plain PyTorch version, in y0's dtype (float32 or float64).

    A batched while-loop over all systems with the TPU kernel's per-system
    masks: ``act`` (still integrating), ``advance`` (accepted, committed),
    ``slope`` (accepted but cut by the slope-jump guard) and ``rejected``;
    every update commits through ``torch.where`` and the loop ends when no
    system is active.  Works on any device; the CPU path of ``rk45``.
    Given a list as ``steps``, it appends (t, h_eff, advance, t_new), [S]
    tensors, for every iteration: where each system was, the step it tried,
    whether it advanced, and where it went.
    """
    cfg = config
    dtype, dev = y0.dtype, y0.device
    s_count, n_eq = y0.shape
    p = plain_params(model, params, dtype)
    qt = None if query_times is None else query_times.to(dtype).contiguous()
    snap = ZOH_SNAP if (cfg.forcing_step_align and forcings is not None) else 0.0
    a, c = tableau.DP_A.tolist(), tableau.DP_C.tolist()
    b, e, pm = tableau.DP_B.tolist(), tableau.DP_E.tolist(), tableau.DP_P.tolist()

    shift = torch.tensor(float(t_shift), dtype=dtype, device=dev) if t_shift else None
    fsal, comp, pi = cfg.fsal, cfg.compensated, cfg.controller == "pi"
    expo = controller_exponent(cfg)

    def rhs(t, y, f_vals):
        if shift is not None:
            t = t + shift
        return torch.stack(model.rhs_tuple(t, y, p, f_vals))

    # bf16 forcing (float32 solves): the data rounded to bfloat16 once,
    # each gathered sample widened back to float32 (rk45_pallas.py
    # l.1011-1015 and l.207).
    f_data = None if forcings is None else b1_forcing_data(forcings, cfg, dtype)

    def gather(t):
        if forcings is None:
            return None
        vals = gather_forcings_column(f_data, forcings.meta, t, snap)
        return tuple(v.float() for v in vals) if f_data.dtype == torch.bfloat16 else vals

    # State and stage slopes as [N, S] tensors: every update below is
    # elementwise, in the TPU kernel's order, so it rounds as per-system
    # scalar code does.
    y = y0.t().contiguous()
    h0 = h0.to(dtype)
    t = torch.full((s_count,), float(t0), dtype=dtype, device=dev)
    t_c = torch.zeros_like(t)
    h = h0.clone()
    zi = torch.zeros(s_count, dtype=torch.int32, device=dev)
    reject, iasti, nonsti, fstreak = zi, zi, zi, zi
    n_acc, n_rej, n_att = zi, zi, zi
    stiff = torch.zeros(s_count, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    dense = dense_init(qt, y, t0, cfg)
    h_floor = (tf - t0) * cfg.min_step_fraction
    # Option state (rk45_pallas.py _Carry): the FSAL slope k1 = f(t, y)
    # carried from the last advance, the Kahan low word of y, and the PI
    # controller's last committed error norm.
    k0 = rhs(t, y, gather(t)) if fsal else None
    y_c = torch.zeros_like(y) if comp else None
    facold = torch.full_like(t, 1e-4) if pi else None
    # Lockstep (rk45_pallas.py l.345-351, 392-421): each system's cursor
    # starts at the first query past t0; the steps of a system are capped
    # at the first query it has not reached, tf + 1 once it passed them all.
    lockstep = cfg.dense_lockstep and qt is not None and qt.shape[0] > 0
    if lockstep:
        n_q = qt.shape[0]
        cursor = torch.full((s_count,), int((qt <= t0).sum()), dtype=torch.int64, device=dev)
        past_all = torch.tensor(tf, dtype=dtype, device=dev) + 1.0

    while True:
        act = (t < tf) & ~stiff & (n_att < cfg.max_steps)
        if not bool(act.any()):
            break
        clamp = t + h > tf
        h_eff = torch.where(clamp, tf - t, h)
        if lockstep:
            cursor = lockstep_cursor(qt, cursor, t, act)
            barrier = torch.where(cursor < n_q, qt[torch.clamp(cursor, max=n_q - 1)], past_all)
            h_eff = torch.minimum(h_eff, torch.maximum(barrier - t, zero))
        if snap:
            h_eff = zoh_step_cap(forcings.meta, t, h_eff)
        f_vals = gather(t)

        # FSAL: an advanced system's k1 is its last k7 (or the refresh at
        # a forcing boundary below); a rejected one's (t, y) are unchanged.
        ks = [k0 if fsal else rhs(t, y, f_vals)]
        g6 = y
        for s in range(1, 7):
            acc = y
            for j in range(s):
                if a[s][j] != 0.0:
                    acc = acc + (h_eff * a[s][j]) * ks[j]
            if s == 5:
                g6 = acc
            ks.append(rhs(t + c[s] * h_eff, acc, f_vals))
        # y_out in stage 7's association (DP's b row is its a row), so k7
        # is f(t + h, y_out) bit for bit; compensated accumulates the
        # increment dy on its own for the Kahan commit and tests y + dy.
        y_out = y
        dy = torch.zeros_like(y) if comp else None
        err_c = torch.zeros_like(y)
        for s in range(7):
            if b[s] != 0.0:
                if comp:
                    dy = dy + (h_eff * b[s]) * ks[s]
                else:
                    y_out = y_out + (h_eff * b[s]) * ks[s]
            if e[s] != 0.0:
                err_c = err_c + (h_eff * e[s]) * ks[s]
        if comp:
            y_out = y + dy
        tol = cfg.atol + cfg.rtol * torch.maximum(torch.abs(y), torch.abs(y_out))
        err = torch.amax(torch.abs(err_c / tol), dim=0)
        accept = err <= 1.0  # NaN rejects
        jump = torch.amax(torch.abs(ks[0] - ks[1]), dim=0) > cfg.slope_jump_thresh
        advance = act & accept & ~jump
        slope = act & accept & jump
        rejected = act & ~accept

        # Kahan-compensated commit time; the dense window's upper bound.
        kh = h_eff - t_c
        t1 = t + kh

        def qm_coeffs():
            qm = []
            for m in range(4):
                q = torch.zeros_like(y)
                for j in range(7):
                    if pm[j][m] != 0.0:
                        q = q + pm[j][m] * ks[j]
                qm.append(q)
            return qm

        fill_dense(dense, qt, t, t1, advance, h_eff, y, qm_coeffs)

        base_fac = cfg.safety * elementwise.pow(1.0 / (err + 1e-16), expo)
        if pi:
            # Lund-stabilised PI (rk45_pallas.py l.623-640): an advance is
            # credited with the last committed error; a rejection uses the
            # plain factor; clamped landings leave facold alone.
            raw_fac = base_fac * elementwise.pow(facold, cfg.pi_beta)
            facold = torch.where(advance & ~clamp, torch.clamp_min(err, 1e-4), facold)
        else:
            raw_fac = base_fac
        fac_acc = torch.clamp(raw_fac, cfg.min_scale, cfg.max_scale)
        fac_rej = torch.where(
            torch.isnan(base_fac), zero + cfg.nan_shrink, torch.clamp_max(base_fac, 1.0)
        )
        fac_rej = torch.clamp(fac_rej, cfg.min_scale, cfg.max_scale)
        h_slope = torch.maximum(h_eff * 0.5, h0 * cfg.min_step_fraction)
        # A clamped landing step never shrinks the carried h.
        h_adv = torch.where(clamp, torch.maximum(h_eff * fac_acc, h), h_eff * fac_acc)
        h_new = torch.where(advance, h_adv, torch.where(slope, h_slope, h_eff * fac_rej))
        reject_new = torch.where(accept, zi, reject + 1)

        if cfg.stiff_detect:
            fs1 = torch.where(
                act & (h_new < h_floor), fstreak + 1, torch.where(act, zi, fstreak)
            )
            stiff_new = (rejected & (reject_new > cfg.max_rejects)) | (
                act & (fs1 >= cfg.stiff_floor_streak)
            )
            fstreak = fs1
            # Hairer's |h*lambda| from the two t+h stages, tested every
            # stiff_test_every-th accepted step; slope cuts always trip.
            stnum = torch.amax(torch.abs(ks[6] - ks[5]), dim=0)
            stden = torch.amax(torch.abs(y_out - g6), dim=0)
            hlamb = torch.where(stden > 0, h_eff * stnum / stden, zero)
            n_acc_next = n_acc + advance.to(torch.int32)
            tested = advance & ((n_acc_next & (cfg.stiff_test_every - 1)) == 0)
            over = hlamb > cfg.stiff_hlamb
            trip = slope | (tested & over)
            calm = tested & ~over
            iasti1 = torch.where(trip, iasti + 1, iasti)
            nonsti = torch.where(trip, zi, torch.where(calm, nonsti + 1, nonsti))
            iasti = torch.where(calm & (nonsti >= cfg.stiff_forgive), zi, iasti1)
            stiff_new = stiff_new | (iasti >= cfg.stiff_streak)
        else:
            stiff_new = rejected & ((reject_new > cfg.max_rejects) | (h_new < h_floor))

        t_new = torch.where(advance, t1, t)
        if comp:
            # Kahan commit (rk45_pallas.py l.790-803): the low word folds
            # back into the increment.
            khs = dy - y_c
            y_kah = y + khs
            y_c = torch.where(advance, (y_kah - y) - khs, y_c)
            y_new = torch.where(advance, y_kah, y)
        else:
            y_new = torch.where(advance, y_out, y)
        if fsal:
            k0 = torch.where(advance, ks[6], k0)
            if forcings is not None:
                # k7 read the forcing of t; a step that crossed a sample
                # boundary starts on the next sample, so its k1 is
                # evaluated anew (rk45_pallas.py l.726-777).
                crossed = advance & forcing_index_changed(forcings.meta, t, t_new, snap)
                if bool(crossed.any()):
                    k0 = torch.where(crossed, rhs(t_new, y_new, gather(t_new)), k0)
        t_c = torch.where(advance, (t1 - t) - kh, t_c)
        if steps is not None:
            steps.append((t, h_eff, advance, t_new))
        t = t_new
        y = y_new
        stiff = stiff | stiff_new
        h = torch.where(act, h_new, h)
        reject = torch.where(act, reject_new, reject)
        n_acc = n_acc + advance.to(torch.int32)
        n_rej = n_rej + rejected.to(torch.int32)
        n_att = n_att + act.to(torch.int32)

    y_final, completed, dense = finish(y, t, tf, dense)
    return RK45Result(
        y_final=y_final,
        dense=dense,
        stiff=stiff | ~completed,
        failed=~completed & ~stiff,
        h0=h0,
        stats=RKStats(n_accepted=n_acc, n_rejected=n_rej, n_attempts=n_att),
    )
