"""B2, fused Radau IIA: the CUDA kernel's wrapper and its plain version.

``radau`` re-integrates the stiff subset from t0 with the 3-stage Radau IIA
method -- the work of the TPU kernel ``tiger_tpu/kernels/radau_pallas.py``
(``_make_kernel``'s ``kernel``, reached through ``pl.pallas_call`` at
l.987).  A CUDA tensor goes to the hand-written kernel ``csrc/radau.cu`` (or
the call raises): its float instances for float32, its double instances
for float64, one of each for every option set.  A CPU tensor goes to
``radau_plain``.  ``radau_launches`` counts the kernel's launches by
instance.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tiger_tpu_torch import elementwise
from tiger_tpu_torch.forcing import ZOH_SNAP, ForcingSet, gather_forcings_column, zoh_step_cap
from tiger_tpu_torch.kernels._common import (
    C_REAL,
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
    c_reals,
    launch,
    plain_params,
)
from tiger_tpu_torch.profiling import span
from tiger_tpu_torch.solver import tableau
from tiger_tpu_torch.solver.config import SolverConfig
from tiger_tpu_torch.solver.radau import RadauResult, RadauStats

#: float32 machine epsilon: the Newton tolerances use it in every dtype, as
#: the TPU kernel does (radau_pallas.py _F32_EPS).
_F32_EPS = float(np.finfo(np.float32).eps)
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _args_type(dtype):
    real = C_REAL[dtype]

    class RadauArgsC(ctypes.Structure):
        """Mirror of ``tt::RadauArgs<T>`` (csrc/radau.cu)."""

        _fields_ = [
            ("y0", c_ptr), ("h0", c_ptr), ("params", c_ptr), ("forc", c_ptr), ("qt", c_ptr),
            ("y_final", c_ptr), ("dense", c_ptr), ("failed", c_ptr), ("stats", c_ptr),
            ("n_sys", c_i64), ("n_q", c_i32), ("safe_pow", c_i32),
            ("t0", real), ("tf", real),
            ("rtol", real), ("atol", real), ("safety", real),
            ("min_scale", real), ("max_scale", real), ("expo", real),
            ("nan_shrink", real), ("h_freeze_hi", real),
            ("newton_tol", real), ("kappa", real), ("tol_eps", real),
            ("fd_eps", real),
            ("max_steps", c_i32), ("max_rejects", c_i32), ("newton_max_iter", c_i32),
            ("reject_unconverged", c_i32), ("fill_t0_queries", c_i32),
            ("err_mode", c_i32), ("predictor", c_i32), ("safety_newton", real),
            ("forcing", FORCING_META[dtype]),
            ("ra", (real * 3) * 3), ("rc", real * 3), ("rb", real * 3),
            ("re", real * 3), ("rw", (real * 3) * 3), ("ea", real * 3),
            ("inv_a", (real * 3) * 3),
            ("gam", real), ("alp", real), ("bet", real),
            ("v1", real * 3), ("v2r", real * 3), ("v2i", real * 3),
            ("p1", real * 3), ("p2r", real * 3), ("p2i", real * 3),
            ("model", c_i32), ("t_shift", real), ("doy0", real),
            ("factor_reuse", c_i32), ("refresh_sweeps", c_i32),
            ("reuse_lo", real), ("reuse_hi", real),
        ]

    return RadauArgsC


#: ``tt::RadauArgs<T>`` by solve dtype.
ARGS = {dtype: _args_type(dtype) for dtype in C_REAL}


def _kappa(cfg: SolverConfig) -> float:
    """RADAU5's scaled Newton exit threshold (radau_pallas.py l.532-535)."""
    return max(10.0 * _F32_EPS / cfg.rtol, min(0.03, float(np.sqrt(cfg.rtol))))


#: The error estimate of each ``radau_error_mode`` (radau_pallas.py
#: l.157-162, 439-490): its code in ``RadauArgs.err_mode`` and the step
#: controller's exponent.
ERR_MODES = {"embedded3": (0, 1.0 / 3.0), "reference": (1, 0.2), "radau5": (2, 0.25)}
#: The option sets B2 has an instance for, float and double: each error
#: mode, with and without the predictor, each with and without factor reuse.
INSTANCES = tuple((mode, pred, reuse) for mode in ERR_MODES for pred in (False, True)
                  for reuse in (False, True))


def _name(mode: str, pred: bool, reuse: bool) -> str:
    return mode + ("+predictor" if pred else "") + ("+reuse" if reuse else "")


def instance_name(config: SolverConfig, dtype: torch.dtype = torch.float32, prefix: str = "") -> str:
    """B2's instance for ``config`` in ``dtype`` for the model whose
    ``_common.KERNEL_MODELS`` prefix is ``prefix``: the error mode,
    '+predictor' with it, '+reuse' with factor reuse, '/f64' for the double
    instance (e.g. 'radau5+predictor/f64', 'm200/embedded3+reuse')."""
    return (prefix + _name(config.radau_error_mode, config.radau_predictor,
                           config.radau_factor_reuse)
            + ("/f64" if dtype == torch.float64 else ""))


#: Kernel launches by instance (``instance_name``) since import (or since a
#: caller set them to 0: ``kernels.reset_launch_counts``).
radau_launches = {
    prefix + _name(*inst) + suffix: 0
    for _, prefix, _ in KERNEL_MODELS.values() for suffix in ("", "/f64") for inst in INSTANCES
}


def newton_safety(cfg: SolverConfig) -> float:
    """RADAU5's safety numerator safety * (2M + 1), M = newton_max_iter: an
    attempt that took n sweeps grows h by at most it / (2M + n)."""
    return cfg.safety * (2.0 * cfg.newton_max_iter + 1.0)


def _embedded_weights(cfg: SolverConfig):
    """The embedded error weights: RADAU_E3, or the reference's RADAU_E
    (radau5 mode uses neither)."""
    return tableau.RADAU_E if cfg.radau_error_mode == "reference" else tableau.RADAU_E3


def _eig_constants():
    """(gamma, alpha, beta, v1, v2r, v2i, p1, p2r, p2i) from tableau._radau_eig."""
    v, p = tableau.RADAU_EIG_V, tableau.RADAU_EIG_P
    return (
        float(tableau.RADAU_EIG_GAMMA),
        float(tableau.RADAU_EIG_ALPHA),
        float(tableau.RADAU_EIG_BETA),
        v[:, 0].real.tolist(),
        v[:, 1].real.tolist(),
        v[:, 1].imag.tolist(),
        p[0].real.tolist(),
        p[1].real.tolist(),
        p[1].imag.tolist(),
    )


def radau(
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
) -> RadauResult:
    """B2 over ``y0[n, N]`` from t0 to tf; ``query_times`` sorted and unique.

    CPU tensors run ``radau_plain``; CUDA tensors launch the kernel on the
    current stream without synchronising (Model 204 or Model 200 in float32
    or float64; any other input raises).  ``t_shift`` as in
    ``kernels.rk45.rk45``.
    """
    if y0.device.type == "cpu":
        return radau_plain(model, y0, h0, t0, tf, query_times, params, forcings, config, t_shift)
    if y0.device.type != "cuda":
        raise ValueError(f"radau: no implementation for device {y0.device}")
    return _radau_cuda(model, y0, h0, t0, tf, query_times, params, forcings, config, t_shift)


def _radau_cuda(model, y0, h0, t0, tf, qt, params, forcings, cfg, t_shift=0.0) -> RadauResult:
    # The kernel's warp maxima read non-negative floats as unsigned integers.
    if not (cfg.rtol >= 0.0 and cfg.atol >= 0.0):
        raise ValueError(f"radau: the CUDA kernel needs rtol, atol >= 0, got {cfg.rtol}, {cfg.atol}")
    with span("tiger.b2.inputs"):
        y0_soa, p_block = kernel_inputs("radau", model, y0, h0, params, forcings, qt, t_shift)
    model_id, prefix, reads_params = kernel_model("radau", model)
    s_count, dev, dtype = y0.shape[0], y0.device, y0.dtype
    f64, real = dtype == torch.float64, C_REAL[dtype]
    q_total = 0 if qt is None else qt.shape[0]
    y_final = torch.empty((N_EQ, s_count), dtype=dtype, device=dev)
    dense = torch.empty((q_total, N_EQ, s_count), dtype=dtype, device=dev)
    failed = torch.empty((s_count,), dtype=torch.int32, device=dev)
    stats = torch.empty((5, s_count), dtype=torch.int32, device=dev)
    gam, alp, bet, v1, v2r, v2i, p1, p2r, p2i = _eig_constants()
    err_mode, expo = ERR_MODES[cfg.radau_error_mode]

    def reals(x):
        return c_reals(x, real)

    a = ARGS[dtype](
        y0=y0_soa.data_ptr(), h0=h0.data_ptr(), params=data_ptr(p_block),
        forc=data_ptr(None if forcings is None else forcings.data), qt=data_ptr(qt),
        y_final=y_final.data_ptr(), dense=dense.data_ptr(), failed=failed.data_ptr(),
        stats=stats.data_ptr(),
        n_sys=s_count, n_q=q_total, safe_pow=int(reads_params and model.safe_pow),
        t0=t0, tf=tf, rtol=cfg.rtol, atol=cfg.atol, safety=cfg.safety,
        min_scale=cfg.min_scale, max_scale=cfg.max_scale, expo=expo,
        nan_shrink=cfg.nan_shrink, h_freeze_hi=cfg.radau_h_freeze_hi,
        newton_tol=cfg.newton_tol, kappa=_kappa(cfg), tol_eps=8.0 * _F32_EPS,
        fd_eps=float(np.sqrt(np.finfo(_NP_DTYPE[dtype]).eps)),
        max_steps=cfg.max_steps, max_rejects=cfg.radau_max_rejects,
        newton_max_iter=cfg.newton_max_iter,
        reject_unconverged=int(cfg.newton_reject_unconverged),
        fill_t0_queries=int(cfg.fill_t0_queries), err_mode=err_mode,
        predictor=int(cfg.radau_predictor), model=model_id, safety_newton=newton_safety(cfg),
        t_shift=t_shift, doy0=getattr(model, "doy0", 1.0),
        forcing=forcing_meta_c(forcings, cfg, dtype),
        ra=reals(tableau.RADAU_A), rc=reals(tableau.RADAU_C),
        rb=reals(tableau.RADAU_B), re=reals(_embedded_weights(cfg)),
        rw=reals(tableau.RADAU_DENSE), ea=reals(tableau.RADAU_ERR_EA),
        inv_a=reals(tableau.RADAU_A_INV),
        gam=gam, alp=alp, bet=bet, v1=reals(v1), v2r=reals(v2r),
        v2i=reals(v2i), p1=reals(p1), p2r=reals(p2r), p2i=reals(p2i),
        factor_reuse=int(cfg.radau_factor_reuse), refresh_sweeps=cfg.radau_refresh_sweeps,
        reuse_lo=cfg.radau_reuse_lo, reuse_hi=cfg.radau_reuse_hi,
    )
    launch("tt_radau_launch", "tt_radau_args_size", a, f64, dev,
           f"radau_error_mode={cfg.radau_error_mode!r}, radau_predictor={cfg.radau_predictor}, "
           f"radau_factor_reuse={cfg.radau_factor_reuse} ({type(model).__name__})")
    with COUNT_LOCK:
        radau_launches[instance_name(cfg, dtype, prefix)] += 1
    with span("tiger.b2.outputs"):
        y_final, dense = y_final.t().contiguous(), dense.permute(2, 0, 1).contiguous()
    return RadauResult(
        y_final=y_final,
        dense=dense,
        failed=failed != 0,
        stats=RadauStats(*stats),
    )


def radau_plain(
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
) -> RadauResult:
    """B2's plain PyTorch version, in y0's dtype (float32 or float64).

    A batched while-loop with the TPU kernel's per-system masks (``act``,
    ``accept``, ``rejected``, Newton ``conv``) and ``torch.where`` commits.
    A system's stage slopes stop changing once its Newton iteration has
    converged, and the sweep loop ends when every active system has
    converged or ``newton_max_iter`` sweeps ran.
    """
    cfg = config
    dtype, dev = y0.dtype, y0.device
    s_count, n = y0.shape
    p = plain_params(model, params, dtype)
    qt = None if query_times is None else query_times.to(dtype).contiguous()
    snap = ZOH_SNAP if (cfg.forcing_step_align and forcings is not None) else 0.0
    ra, rb, re, rw, rc, ea, inv_a = (
        np.asarray(x).tolist() for x in (tableau.RADAU_A, tableau.RADAU_B, _embedded_weights(cfg),
                                         tableau.RADAU_DENSE, tableau.RADAU_C,
                                         tableau.RADAU_ERR_EA, tableau.RADAU_A_INV))
    radau5, pred = cfg.radau_error_mode == "radau5", cfg.radau_predictor
    expo = ERR_MODES[cfg.radau_error_mode][1]
    gam, alp, bet, v1, v2r, v2i, p1, p2r, p2i = _eig_constants()
    col = lambda v: torch.tensor(v, dtype=dtype, device=dev)[:, None, None]  # noqa: E731
    rc_t, ra_t = col(tableau.RADAU_C.tolist())[:, :, 0], torch.tensor(ra, dtype=dtype, device=dev)
    v1_t, v2r_t, v2i_t = col(v1), col(v2r), col(v2i)
    kappa = _kappa(cfg)
    fd_eps = float(np.sqrt(np.finfo(_NP_DTYPE[dtype]).eps))
    eye = torch.eye(n, dtype=torch.bool, device=dev)[:, :, None]

    shift = torch.tensor(float(t_shift), dtype=dtype, device=dev) if t_shift else None

    def rhs(t, y, f_vals):
        # y: [N, ...] with the system index last; extra middle dimensions
        # (stages, Jacobian columns) broadcast against the [S] params.
        if shift is not None:
            t = t + shift
        return torch.stack(model.rhs_tuple(t, y, p, f_vals))

    # State [N, S], stage slopes [3, N, S], factors [N, N, S]: every update
    # below is elementwise in the TPU kernel's order (sums over stages and
    # back-substitutions stay sequential), so it rounds as per-system
    # scalar code does.
    y = y0.t().contiguous()
    t = torch.full((s_count,), float(t0), dtype=dtype, device=dev)
    t_c = torch.zeros_like(t)
    h = h0.to(dtype).clone()
    zero = torch.zeros_like(t)
    zi = torch.zeros(s_count, dtype=torch.int32, device=dev)
    reject, n_acc, n_rej, n_att, n_swp, n_fct = zi, zi, zi, zi, zi, zi
    failed = torch.zeros(s_count, dtype=torch.bool, device=dev)
    dense = dense_init(qt, y, t0, cfg)
    reuse = cfg.radau_factor_reuse
    if reuse:
        # Each system's factors, the step they were built with, and its
        # refresh vote: every system votes before its first attempt.
        fact = (torch.zeros((n, n, s_count), dtype=dtype, device=dev), torch.zeros_like(y),
                torch.zeros((n, n, s_count), dtype=dtype, device=dev),
                torch.zeros((n, n, s_count), dtype=dtype, device=dev),
                torch.zeros_like(y), torch.zeros_like(y))
        h_fact = torch.zeros_like(t)
        refresh = torch.ones(s_count, dtype=torch.bool, device=dev)
    if pred:
        # The predictor's state (radau_pallas.py _Carry.pred): the last
        # attempt's stage slopes, its step, the theta offset of the next
        # step on its collocation polynomial, and whether they may seed.
        zp = torch.zeros((3, n, s_count), dtype=dtype, device=dev)
        h_prev = torch.ones_like(t)
        z_base = torch.zeros_like(t)
        have = torch.zeros(s_count, dtype=torch.bool, device=dev)

    while True:
        act = (t < tf) & ~failed & (n_att < cfg.max_steps)
        if not bool(act.any()):
            break
        h_eff = torch.where(t + h > tf, tf - t, h)
        if snap:
            h_eff = zoh_step_cap(forcings.meta, t, h_eff)
        f_vals = None
        if forcings is not None:
            f_vals = gather_forcings_column(forcings.data, forcings.meta, t, snap)
        f0 = rhs(t, y, f_vals)

        def factors():
            """The forward-difference Jacobian at (t, y), column j
            perturbing y[j]; then the real factor gamma I - h J and the
            complex factor (alpha + beta i) I - h J, each an unpivoted
            Doolittle LU in place: (mr, mr_inv, cre, cim, ci_re, ci_im)."""
            h_eps = fd_eps * torch.clamp_min(torch.abs(y), 1.0)  # [N, S]
            y_pert = torch.where(eye, (y + h_eps)[:, None], y[:, None])  # [i, j, S]
            jac = (rhs(t, y_pert, f_vals) - f0[:, None]) / h_eps[None]
            off = (-h_eff) * jac
            mr = torch.where(eye, gam - h_eff * jac, off)
            cre = torch.where(eye, alp - h_eff * jac, off)
            cim = torch.where(eye, zero + bet, zero)
            mr_inv = torch.empty_like(y)
            ci_re, ci_im = torch.empty_like(y), torch.empty_like(y)
            for k in range(n):
                mr_inv[k] = 1.0 / mr[k, k]
                m = mr[k + 1:, k] * mr_inv[k]
                mr[k + 1:, k] = m
                mr[k + 1:, k + 1:] = mr[k + 1:, k + 1:] - m[:, None] * mr[k, k + 1:]
            for k in range(n):
                inv_den = 1.0 / (cre[k, k] * cre[k, k] + cim[k, k] * cim[k, k])
                ci_re[k] = cre[k, k] * inv_den
                ci_im[k] = -cim[k, k] * inv_den
                m_re = cre[k + 1:, k] * ci_re[k] - cim[k + 1:, k] * ci_im[k]
                m_im = cre[k + 1:, k] * ci_im[k] + cim[k + 1:, k] * ci_re[k]
                cre[k + 1:, k], cim[k + 1:, k] = m_re, m_im
                re_k, im_k = cre[k, k + 1:], cim[k, k + 1:]
                cre[k + 1:, k + 1:] = cre[k + 1:, k + 1:] - (m_re[:, None] * re_k - m_im[:, None] * im_k)
                cim[k + 1:, k + 1:] = cim[k + 1:, k + 1:] - (m_re[:, None] * im_k + m_im[:, None] * re_k)
            return mr, mr_inv, cre, cim, ci_re, ci_im

        if reuse:
            # Factor reuse (radau_pallas.py l.359-392), per system: a system
            # refactors when it voted after its last attempt, or when this
            # attempt's step (after the tf clamp and the ZOH cap) left the
            # band [lo, hi] x the step its factors were built with.
            ratio = h_eff / h_fact
            fresh = act & (refresh | (ratio < cfg.radau_reuse_lo)
                           | (ratio > cfg.radau_reuse_hi) | torch.isnan(ratio))
            if bool(fresh.any()):
                new = factors()
                fact = tuple(torch.where(fresh, a, b) for a, b in zip(new, fact))
                h_fact = torch.where(fresh, h_eff, h_fact)
        else:
            fresh, fact, h_fact = act, factors(), h_eff
        mr, mr_inv, cre, cim, ci_re, ci_im = fact

        def real_solve(x):
            x = x.clone()
            for k in range(n):
                x[k + 1:] = x[k + 1:] - mr[k + 1:, k] * x[k]
            for k in reversed(range(n)):
                acc = x[k]
                for j in range(k + 1, n):
                    acc = acc - mr[k, j] * x[j]
                x[k] = acc * mr_inv[k]
            return x

        def cplx_solve(xr, xi):
            xr, xi = xr.clone(), xi.clone()
            for k in range(n):
                xr_k, xi_k = xr[k].clone(), xi[k].clone()
                xr[k + 1:] = xr[k + 1:] - (cre[k + 1:, k] * xr_k - cim[k + 1:, k] * xi_k)
                xi[k + 1:] = xi[k + 1:] - (cre[k + 1:, k] * xi_k + cim[k + 1:, k] * xr_k)
            for k in reversed(range(n)):
                ar, ai = xr[k], xi[k]
                for j in range(k + 1, n):
                    ar = ar - (cre[k, j] * xr[j] - cim[k, j] * xi[j])
                    ai = ai - (cre[k, j] * xi[j] + cim[k, j] * xr[j])
                xr[k], xi[k] = ar * ci_re[k] - ai * ci_im[k], ar * ci_im[k] + ai * ci_re[k]
            return xr, xi

        # Simplified Newton on the stage slopes z [3, N, S], from f(t, y),
        # or with the predictor from the stage values that the last
        # attempt's collocation polynomial extrapolates (radau_pallas.py
        # l.276-322): theta_i = base + c_i h/h_prev, Z0_i = (h_prev/h)
        # sum_j A^-1[i,j] (I(theta_j) - I(base)) z_prev.
        z = f0.expand(3, n, s_count).clone()
        if pred:
            ratio = h_eff / h_prev
            use = have & (ratio <= 2.0)
            base2 = z_base * z_base
            base3 = base2 * z_base
            i_th = [[None] * 3 for _ in range(3)]
            for i in range(3):
                th = z_base + rc[i] * ratio
                th2 = th * th
                th3 = th2 * th
                for s in range(3):
                    i_th[s][i] = (rw[s][0] * (th - z_base) + rw[s][1] * (th2 - base2)
                                  + rw[s][2] * (th3 - base3))
            scale = h_prev / h_eff
            for i in range(3):
                acc = None
                for j in range(3):
                    vjk = i_th[0][j] * zp[0] + i_th[1][j] * zp[1] + i_th[2][j] * zp[2]
                    term = inv_a[i][j] * vjk
                    acc = term if acc is None else acc + term
                z[i] = torch.where(use, scale * acc, z[i])
        conv = ~act
        sweeps = zi
        tol_y = cfg.atol + cfg.rtol * torch.abs(y)
        t_st = t + rc_t * h_eff  # [3, S] stage times
        for _ in range(cfg.newton_max_iter):
            if bool(conv.all()):
                break
            ys = y.expand(3, n, s_count)
            for j in range(3):
                ys = ys + (h_eff * ra_t[:, j : j + 1])[:, None] * z[j]
            bvec = rhs(t_st, ys.transpose(0, 1), f_vals).transpose(0, 1) - z
            w1 = real_solve(p1[0] * bvec[0] + p1[1] * bvec[1] + p1[2] * bvec[2])
            wr, wi = cplx_solve(
                p2r[0] * bvec[0] + p2r[1] * bvec[1] + p2r[2] * bvec[2],
                p2i[0] * bvec[0] + p2i[1] * bvec[1] + p2i[2] * bvec[2],
            )
            delta = v1_t * w1 + 2.0 * (v2r_t * wr - v2i_t * wi)
            upd = ~conv
            sweeps = sweeps + upd.to(torch.int32)
            z = torch.where(upd, z + delta, z)
            ad = torch.abs(delta)
            maxd = torch.amax(ad, dim=(0, 1))
            scaled = torch.amax(ad / tol_y, dim=(0, 1))
            zmag = torch.amax(torch.abs(z), dim=(0, 1))
            tol_eff = cfg.newton_tol + (8.0 * _F32_EPS) * zmag
            conv = conv | (maxd < tol_eff) | (h_eff * scaled < kappa) | torch.isnan(maxd)

        # Step update and the error: embedded (E3, or the reference's E),
        # or RADAU5's smoothed (mu/h I - J)^-1 (f0 + sum_s EA_s z_s) =
        # h M_r^-1 (...) on the Newton factor, with its correction at the
        # perturbed state y + e once the attempt before was rejected.
        y_out = y
        for s in range(3):
            y_out = y_out + (h_eff * rb[s]) * z[s]
        tol = cfg.atol + cfg.rtol * torch.maximum(torch.abs(y), torch.abs(y_out))
        if radau5:
            # h_fact: (mu/h I - J)^-1 = h M_r^-1 for the h the factor was
            # built with (h_eff unless reused factors are older).
            defect = f0 + ea[0] * z[0] + ea[1] * z[1] + ea[2] * z[2]
            e_vec = h_fact * real_solve(defect)
            err = torch.amax(torch.abs(e_vec / tol), dim=0)
            retry = act & (err > 1.0) & (reject > 0)
            if bool(retry.any()):
                f_p = rhs(t, y + e_vec, f_vals)
                e2 = h_fact * real_solve(f_p + defect - f0)
                err = torch.where(retry, torch.amax(torch.abs(e2 / tol), dim=0), err)
        else:
            err_c = torch.zeros_like(y)
            for s in range(3):
                err_c = err_c + (h_eff * re[s]) * z[s]
            err = torch.amax(torch.abs(err_c / tol), dim=0)
        newt_fail = ~conv if cfg.newton_reject_unconverged else torch.zeros_like(conv)
        accept = act & (err <= 1.0) & ~newt_fail
        rejected = act & ~accept

        kh = h_eff - t_c
        t1 = t + kh

        def qm_coeffs():
            qm = []
            for m in range(3):
                q = torch.zeros_like(y)
                for s in range(3):
                    q = q + rw[s][m] * z[s]
                qm.append(q)
            return qm

        fill_dense(dense, qt, t, t1, accept, h_eff, y, qm_coeffs)

        if radau5:
            # RADAU5's Newton-effort-aware safety: divided as one IEEE
            # division, as the kernel divides.
            safety = torch.full_like(t, newton_safety(cfg)) / (
                2.0 * cfg.newton_max_iter + sweeps.to(dtype))
        else:
            safety = cfg.safety
        raw_fac = safety * elementwise.pow(1.0 / (err + 1e-16), expo)
        fac_acc = torch.clamp(raw_fac, cfg.min_scale, cfg.max_scale)
        fac_rej = torch.where(
            torch.isnan(raw_fac), zero + cfg.nan_shrink, torch.clamp_max(raw_fac, 1.0)
        )
        fac_rej = torch.clamp(fac_rej, cfg.min_scale, cfg.max_scale)
        # Newton failure says nothing about the error: halve.
        fac_rej = torch.where(newt_fail, zero + 0.5, fac_rej)
        h_new = h_eff * torch.where(accept, fac_acc, fac_rej)
        if cfg.radau_h_freeze_hi > 1.0:
            freeze = accept & (fac_acc >= 1.0) & (fac_acc <= cfg.radau_h_freeze_hi)
            h_new = torch.where(freeze, h_eff, h_new)

        if pred:
            # Only a converged, finite Newton solution may seed the next
            # attempt (radau_pallas.py l.601-617).
            have_new = conv & torch.isfinite(z).all(dim=1).all(dim=0)
            zp = torch.where(act, z, zp)
            h_prev = torch.where(act, h_eff, h_prev)
            z_base = torch.where(accept, zero + 1.0, torch.where(act, zero, z_base))
            have = torch.where(act, have_new, have)

        reject_new = torch.where(accept, zi, reject + 1)
        failed = failed | (rejected & (reject_new > cfg.radau_max_rejects))
        t_c = torch.where(accept, (t1 - t) - kh, t_c)
        t = torch.where(accept, t1, t)
        y = torch.where(accept, y_out, y)
        h = torch.where(act, h_new, h)
        reject = torch.where(act, reject_new, reject)
        act_i = act.to(torch.int32)
        n_acc = n_acc + accept.to(torch.int32)
        n_rej = n_rej + rejected.to(torch.int32)
        n_att = n_att + act_i
        n_swp = n_swp + sweeps
        n_fct = n_fct + fresh.to(torch.int32)
        if reuse:
            # The next attempt's vote (l.771-786): this one needed
            # radau_refresh_sweeps sweeps or more, or its Newton failed.
            refresh = torch.where(act, (sweeps >= cfg.radau_refresh_sweeps) | newt_fail, refresh)

    y_final, completed, dense = finish(y, t, tf, dense)
    return RadauResult(
        y_final=y_final,
        dense=dense,
        failed=failed | ~completed,
        stats=RadauStats(n_acc, n_rej, n_att, n_swp, n_fct),
    )
