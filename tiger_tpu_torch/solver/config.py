"""Solver configuration: tolerances, step-control constants, compat switches.

The same frozen dataclass as ``tiger_tpu/solver/config.py`` (same fields,
defaults and validation), copied so the port imports no jax; the JAX
module's comments explain each field.  ``require_supported`` lists the
non-default options this package does not implement: every solver entry
point calls it, so such a value raises instead of being ignored.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # Tolerances / controller
    rtol: float = 1e-6
    atol: float = 1e-9
    safety: float = 0.9
    min_scale: float = 0.2
    max_scale: float = 10.0

    # Initial step: None => estimate ('per-system' | 'global-zero-y0').
    initial_step: float | None = None
    h0_mode: str = "per-system"

    # Event / stiffness detection
    slope_jump_thresh: float = 100.0
    min_step_fraction: float = 1e-6
    max_rejects: int = 12

    # Hairer's stability-boundary stiffness test and the h-collapse streak.
    stiff_detect: bool = True
    stiff_hlamb: float = 3.25
    stiff_streak: int = 15
    stiff_forgive: int = 6
    stiff_test_every: int = 64
    stiff_floor_streak: int = 64

    # Cap every step at the next ZOH forcing-sample boundary.
    forcing_step_align: bool = True

    # Step-shrink factor when the error norm is NaN.
    nan_shrink: float = 0.2

    # Radau: consecutive-rejection cap, Newton iteration, honest rejection.
    radau_max_rejects: int = 60
    newton_max_iter: int = 10
    newton_tol: float = 1e-8
    newton_reject_unconverged: bool = True
    radau_predictor: bool = False
    radau_h_freeze_hi: float = 1.0
    radau_factor_reuse: bool = False
    radau_reuse_lo: float = 0.25
    radau_reuse_hi: float = 4.0
    radau_refresh_sweeps: int = 5
    radau_error_mode: str = "embedded3"

    # Safety cap on attempted steps per system.
    max_steps: int = 1_000_000

    # Dense-output chunk width of the JAX vmap path (no effect here: each
    # system fills its own queries through a per-system cursor).
    dense_chunk: int = 8

    # TPU-kernel options (Mosaic/VMEM answers; see require_supported).
    dense_lockstep: bool = False
    forcing_dtype: str = "f32"

    # Step-size controller: 'i' (integral) or 'pi' (Lund-stabilized).
    controller: str = "i"
    pi_beta: float = 0.04

    fsal: bool = False
    compensated: bool = False

    # Dense rows for query times <= t0 are prefilled with y0.
    fill_t0_queries: bool = True

    @classmethod
    def reference_parity(cls, **overrides) -> "SolverConfig":
        """Every behavioral-parity switch set to the reference's value."""
        base = dict(
            h0_mode="global-zero-y0",
            fill_t0_queries=False,
            nan_shrink=1.0,
            max_rejects=5,
            radau_error_mode="reference",
            stiff_detect=False,
            radau_predictor=False,
            forcing_step_align=False,
        )
        base.update(overrides)
        return cls(**base)

    def __post_init__(self):
        if self.h0_mode not in ("per-system", "global-zero-y0"):
            raise ValueError(f"unknown h0_mode: {self.h0_mode}")
        if self.radau_error_mode not in ("radau5", "embedded3", "reference"):
            raise ValueError(f"unknown radau_error_mode: {self.radau_error_mode}")
        if self.dense_chunk < 1:
            raise ValueError("dense_chunk must be >= 1")
        if self.forcing_dtype not in ("f32", "bf16"):
            raise ValueError(f"forcing_dtype must be f32|bf16, got {self.forcing_dtype!r}")
        if self.controller not in ("i", "pi"):
            raise ValueError(f"controller must be i|pi, got {self.controller!r}")
        if not 0.0 <= self.pi_beta <= 0.2:
            raise ValueError(f"pi_beta must be in [0, 0.2], got {self.pi_beta}")
        if self.stiff_streak < 1 or self.stiff_forgive < 1:
            raise ValueError("stiff_streak and stiff_forgive must be >= 1")
        if self.stiff_floor_streak < 1:
            raise ValueError("stiff_floor_streak must be >= 1")
        if not 0.0 < self.radau_reuse_lo <= 1.0 <= self.radau_reuse_hi:
            raise ValueError(
                "radau_reuse_lo/hi must bracket 1.0 with lo > 0; got "
                f"[{self.radau_reuse_lo}, {self.radau_reuse_hi}]"
            )
        if self.radau_refresh_sweeps < 1:
            raise ValueError("radau_refresh_sweeps must be >= 1")
        if not 1.0 <= self.radau_h_freeze_hi <= 2.0:
            raise ValueError(
                f"radau_h_freeze_hi must be in [1, 2], got {self.radau_h_freeze_hi}"
            )
        if not self.stiff_hlamb > 0.0:
            raise ValueError(f"stiff_hlamb must be > 0, got {self.stiff_hlamb}")
        if self.compensated and self.fsal:
            raise ValueError(
                "compensated and fsal are mutually exclusive (FSAL's carry "
                "identity relies on the uncompensated b-row accumulation)"
            )
        e = self.stiff_test_every
        if e < 1 or (e & (e - 1)) != 0:
            raise ValueError(f"stiff_test_every must be a power of two, got {e}")


#: Non-default values the port does not implement, per solver.  The RK45
#: options (FSAL, Kahan-compensated y, the PI controller) and the Radau ones
#: (predictor, radau5/reference error modes) are later work; lockstep dense
#: fill, bf16 forcing and Radau factor reuse answer Mosaic/VMEM limits of the
#: TPU kernels and are not to be ported.
_UNSUPPORTED = {
    "rk45": (
        ("fsal", True),
        ("compensated", True),
        ("controller", "pi"),
        ("dense_lockstep", True),
        ("forcing_dtype", "bf16"),
    ),
    "radau": (
        ("radau_predictor", True),
        ("radau_factor_reuse", True),
        ("radau_error_mode", "radau5"),
        ("radau_error_mode", "reference"),
        ("forcing_dtype", "bf16"),
    ),
}


def require_supported(config: SolverConfig, solver: str) -> None:
    """Raise NotImplementedError for an option ``solver`` does not implement
    (``solver`` is 'rk45' or 'radau').

    Some fields are accepted and have no effect here, because nothing they
    steer exists in this package: ``dense_chunk`` (the JAX vmap path's
    dense-fill width; it changes no result there either), and ``pi_beta``,
    ``radau_reuse_lo``/``radau_reuse_hi`` and ``radau_refresh_sweeps``,
    which act only with ``controller='pi'`` or ``radau_factor_reuse``,
    both refused here.
    """
    for name, value in _UNSUPPORTED[solver]:
        if getattr(config, name) == value:
            raise NotImplementedError(
                f"SolverConfig.{name}={value!r} is not implemented by the "
                f"tiger_tpu_torch {solver} solver"
            )
