"""Butcher tableaus: Dormand-Prince 5(4) and 3-stage Radau IIA (order 5).

A numpy-only copy of ``tiger_tpu/solver/tableau.py``: importing that module
would pull in jax through ``tiger_tpu/__init__.py``.  The CUDA kernels receive
these constants (rounded to float32) as launch arguments, never as literals,
and ``tests/test_torch_core.py`` holds every array bit-equal to the JAX
package's.

Numerics match the reference exactly (parity targets depend on them):
  - DP45 coefficients: reference src/solver/rk45_step_dense.cuh:54-83
  - DP45 dense-output P-matrix (quartic interpolant): rk45_step_dense.cuh:193-243
  - Radau IIA coefficients: reference src/solver/radau_step_dense.cuh:58-77

The Radau dense-output coefficients here are *not* taken from the reference: its
``radau_dense`` (radau_step_dense.cuh:172-208) is fed a garbage stage array
(radau_kernel.cu:104 reinterprets the unused RK45 ``k_dummy``) and double-counts
the first interpolation coefficient, so its dense output is unusable. We instead
derive the correct collocation interpolant: with stage slopes Z_s = f(t + c_s h,
Y_s), the collocation polynomial satisfies p'(t + tau h) = sum_s l_s(tau) Z_s
where l_s are the Lagrange basis polynomials on the Radau nodes, hence

    p(t + theta h) = y_n + h * sum_s I_s(theta) Z_s,
    I_s(theta) = integral_0^theta l_s(tau) dtau  (a cubic in theta).

``RADAU_DENSE`` holds the monomial coefficients of I_s so that
I_s(theta) = sum_m RADAU_DENSE[s, m] * theta^(m+1).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Dormand-Prince 5(4)
# ---------------------------------------------------------------------------

#: Stage times c_s (fractions of h).
DP_C = np.array([0.0, 1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0])

#: Stage coupling matrix a[s][j] (strictly lower triangular, 7x6 used region).
DP_A = np.zeros((7, 7))
DP_A[1, 0] = 1.0 / 5.0
DP_A[2, :2] = [3.0 / 40.0, 9.0 / 40.0]
DP_A[3, :3] = [44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0]
DP_A[4, :4] = [19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0]
DP_A[5, :5] = [
    9017.0 / 3168.0,
    -355.0 / 33.0,
    46732.0 / 5247.0,
    49.0 / 176.0,
    -5103.0 / 18656.0,
]
# Row 6 equals the 5th-order weights b (FSAL structure; the reference does not
# exploit FSAL and neither do we, for parity: 7 RHS evals per attempted step).
DP_A[6, :6] = [
    35.0 / 384.0,
    0.0,
    500.0 / 1113.0,
    125.0 / 192.0,
    -2187.0 / 6784.0,
    11.0 / 84.0,
]

#: 5th-order solution weights.
DP_B = np.array(
    [35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0, 11.0 / 84.0, 0.0]
)

#: Embedded 4th-order weights.
DP_B_ALT = np.array(
    [
        5179.0 / 57600.0,
        0.0,
        7571.0 / 16695.0,
        393.0 / 640.0,
        -92097.0 / 339200.0,
        187.0 / 2100.0,
        1.0 / 40.0,
    ]
)

#: Error weights: y_err = h * sum_j DP_E[j] * k[j].
DP_E = DP_B - DP_B_ALT

#: Dense-output P-matrix: extra-correction coefficient of k[j] * theta^(m+1),
#: m = 0..3 (quartic interpolant).  y(t_n + theta h) = y_n + h * sum_m Q_m theta^(m+1)
#: with Q_m = sum_j DP_P[j, m] k[j].
DP_P = np.array(
    [
        [
            1.0,
            -8048581381.0 / 2820520608.0,
            8663915743.0 / 2820520608.0,
            -12715105075.0 / 11282082432.0,
        ],
        [0.0, 0.0, 0.0, 0.0],
        [
            0.0,
            131558114200.0 / 32700410799.0,
            -68118460800.0 / 10900136933.0,
            87487479700.0 / 32700410799.0,
        ],
        [
            0.0,
            -1754552775.0 / 470086768.0,
            14199869525.0 / 1410260304.0,
            -10690763975.0 / 1880347072.0,
        ],
        [
            0.0,
            127303824393.0 / 49829197408.0,
            -318862633887.0 / 49829197408.0,
            701980252875.0 / 199316789632.0,
        ],
        [
            0.0,
            -282668133.0 / 205662961.0,
            2019193451.0 / 616988883.0,
            -1453857185.0 / 822651844.0,
        ],
        [
            0.0,
            40617522.0 / 29380423.0,
            -110615467.0 / 29380423.0,
            69997945.0 / 29380423.0,
        ],
    ]
)

# ---------------------------------------------------------------------------
# 3-stage Radau IIA (order 5)
# ---------------------------------------------------------------------------

SQRT6 = np.sqrt(6.0)

RADAU_C = np.array([(4.0 - SQRT6) / 10.0, (4.0 + SQRT6) / 10.0, 1.0])

RADAU_A = np.array(
    [
        [
            (88.0 - 7.0 * SQRT6) / 360.0,
            (296.0 - 169.0 * SQRT6) / 1800.0,
            (-2.0 + 3.0 * SQRT6) / 225.0,
        ],
        [
            (296.0 + 169.0 * SQRT6) / 1800.0,
            (88.0 + 7.0 * SQRT6) / 360.0,
            (-2.0 - 3.0 * SQRT6) / 225.0,
        ],
        [(16.0 - SQRT6) / 36.0, (16.0 + SQRT6) / 36.0, 1.0 / 9.0],
    ]
)

RADAU_B = np.array([(16.0 - SQRT6) / 36.0, (16.0 + SQRT6) / 36.0, 1.0 / 9.0])

# NOTE: the reference's embedded weights (radau_step_dense.cuh:73-77) sum to
# 0.7111, not 1 — not a consistent quadrature, so the "embedded error" carries
# an O(h*f) term that overestimates the true local error.  This only drives
# step-size control (accepted solutions still use the order-5 RADAU_B), so we
# reproduce it for behavioral parity rather than silently retuning the stiff
# controller.
RADAU_B_ALT = np.array(
    [(226.0 - 60.0 * SQRT6) / 720.0, (226.0 + 60.0 * SQRT6) / 720.0, 1.0 / 12.0]
)

RADAU_E = RADAU_B - RADAU_B_ALT

# Consistent order-3 embedded error weights (the default, radau_error_mode
# 'embedded3').  The reference's b_alt above is not even a consistent
# quadrature (sum 0.711), so its "error" carries an O(h*f) term that forces
# h ~ tolerance/|f| — unusable over long spans (verified empirically: a stiff
# decay over t-span 50 needs ~14M Radau steps under the reference estimate).
# Instead take b_hat = b - v with v in the null space of the order-0/1
# conditions (sum v = 0, sum v*c = 0):
#     v = (c2 - c3, c3 - c1, c1 - c2)
# Then err = h * sum_s v_s Z_s = (h^3/2) f'' * sum_s v_s c_s^2 + O(h^4):
# a genuine order-2-embedded (local O(h^3)) estimate, controlled with
# exponent 1/3.
RADAU_E3 = np.array(
    [RADAU_C[1] - RADAU_C[2], RADAU_C[2] - RADAU_C[0], RADAU_C[0] - RADAU_C[1]]
)

assert abs(RADAU_E3.sum()) < 1e-15 and abs(RADAU_E3 @ RADAU_C) < 1e-15


def _radau_dense_coeffs() -> np.ndarray:
    """Monomial coefficients of the integrated Lagrange basis on the Radau nodes.

    Returns W with shape (3, 3): I_s(theta) = sum_m W[s, m] * theta^(m+1), where
    l_s is the degree-2 Lagrange polynomial with l_s(c_j) = delta_sj, and
    I_s = integral of l_s.  Exactness: I_s(1) == RADAU_B[s] (b-weights are the
    full-step quadrature of the collocation polynomial).
    """
    c = RADAU_C
    W = np.zeros((3, 3))
    for s in range(3):
        # Lagrange basis poly in monomial form: prod_{j!=s} (x - c_j) / (c_s - c_j)
        num = np.poly1d([1.0])
        for j in range(3):
            if j != s:
                num = num * np.poly1d([1.0, -c[j]]) / (c[s] - c[j])
        integ = np.polyint(num)  # degree-3 poly with zero constant term
        # integ.c is highest-power-first: [a3, a2, a1, a0]; a0 == 0
        coeffs = integ.c[::-1]  # [a0, a1, a2, a3]
        W[s, :] = coeffs[1:4]
    return W


#: Collocation dense-output coefficients (see module docstring).
RADAU_DENSE = _radau_dense_coeffs()

assert np.allclose(RADAU_DENSE.sum(axis=1), RADAU_B), "Radau dense must integrate to b"

#: RADAU5's smoothed embedded error estimate (H&W vol II IV.8, eq. 8.19;
#: SciPy scipy/integrate/_ivp/radau.py uses the identical constants):
#:     err_vec = (MU_REAL/h * I - J)^{-1} (f(t, y) + sum_s RADAU_ERR_EA[s] Z_s)
#: where Z_s are stage SLOPES (RADAU_ERR_EA = E @ A folds the reference
#: E-weights, stated for stage-value increments, onto slopes) and MU_REAL is
#: the real eigenvalue of A^{-1}.  The (mu/h I - J)^{-1} factor smooths the
#: estimate for stiff components (|err| ~ h/mu * |quadrature defect| in the
#: nonstiff limit, damped by 1/|h lambda| in the stiff limit), which is what
#: lets the controller run the method at its real order-5 economics instead
#: of the order-2 embedded difference's h ~ tol^(1/3).  Controlled with
#: exponent 1/4 and the Newton-effort-aware safety
#: 0.9*(2M+1)/(2M+n_iter) (both SciPy's).
RADAU_MU_REAL = 3.0 + 3.0 ** (2.0 / 3.0) - 3.0 ** (1.0 / 3.0)

RADAU_ERR_E = np.array([-13.0 - 7.0 * SQRT6, -13.0 + 7.0 * SQRT6, -1.0]) / 3.0

RADAU_ERR_EA = RADAU_ERR_E @ RADAU_A

def _radau_eig():
    """Eigen-decomposition of A^{-1} for the transformed Newton solve.

    RADAU5's real trick (H&W vol II IV.8 'the linear algebra'; decsol.f):
    the simplified-Newton matrix (I - h A (x) J) is similar to the
    block-diagonal (Lambda (x) I - h I (x) J) with Lambda = diag(gamma,
    alpha+beta*i, alpha-beta*i) the eigenvalues of A^{-1} — so one real and
    one complex n x n factorization replace the (3n)^2 one: 5x fewer
    factorization FLOPs at n=5 (the complex LU costs ~4x a real one).
    The constants here are derived numerically from RADAU_A rather than
    hard-coded (they are exact functions of the tableau):

      gamma  — the real eigenvalue of A^{-1} (== RADAU_MU_REAL);
      alpha, beta — the complex pair alpha +/- beta*i;
      V      — eigenvector matrix, column 0 real (the real eigenvector),
               column 1 the alpha+beta*i eigenvector (column 2 = conj is
               implicit and never stored);
      P      — Lambda @ V^{-1}: row 0 real, row 1 complex.  Per Newton
               sweep the transformed residual is u = (P (x) I) b and the
               update is dZ_s = V[s,0] w1 + 2 Re(V[s,1] w_c).

    Phase normalization is fixed (largest-|.| component of each eigenvector
    made real-positive) so the constants are deterministic across numpy
    versions.
    """
    lam, vec = np.linalg.eig(np.linalg.inv(RADAU_A))
    i_real = int(np.argmin(np.abs(lam.imag)))
    i_cplx = [i for i in range(3) if i != i_real and lam[i].imag > 0][0]
    gamma = float(lam[i_real].real)
    alpha = float(lam[i_cplx].real)
    beta = float(lam[i_cplx].imag)
    v1 = vec[:, i_real]
    v1 = (v1 / v1[np.argmax(np.abs(v1))]).real  # real eigenvector
    vc = vec[:, i_cplx]
    vc = vc / vc[np.argmax(np.abs(vc))]  # phase-fixed complex eigenvector
    v_mat = np.stack([v1.astype(complex), vc], axis=1)  # (3, 2)
    # Full V including the conjugate column, for the inverse only.
    v_full = np.stack([v1.astype(complex), vc, vc.conj()], axis=1)
    p_full = np.diag([gamma, alpha + 1j * beta, alpha - 1j * beta]) @ np.linalg.inv(
        v_full
    )
    assert np.max(np.abs(p_full[0].imag)) < 1e-12  # real eigen-row
    return gamma, alpha, beta, v_mat, p_full[:2]


#: See _radau_eig.  RADAU_EIG_GAMMA == RADAU_MU_REAL (the smoothed error
#: estimate's (mu/h I - J) IS the real Newton factor, so with the transformed
#: solve the 'radau5' error mode reuses the factorization for free).
(
    RADAU_EIG_GAMMA,
    RADAU_EIG_ALPHA,
    RADAU_EIG_BETA,
    RADAU_EIG_V,
    RADAU_EIG_P,
) = _radau_eig()

assert abs(RADAU_EIG_GAMMA - RADAU_MU_REAL) < 1e-12


#: Inverse of RADAU_A — maps stage-value increments to stage slopes:
#: Y = y + h*A@Z  <=>  Z = (1/h) * A^{-1} @ (Y - y).  Used by the Newton
#: predictor, which extrapolates the previous collocation polynomial in
#: VALUE space (well-conditioned; values are bounded by the trajectory) and
#: converts to the slope unknowns — extrapolating the slopes directly is
#: ill-conditioned for stiff systems (slope error ~ ||J|| * value error) and
#: was the round-3 regression.
RADAU_A_INV = np.linalg.inv(RADAU_A)
