// B2: fused 3-stage Radau IIA (order 5) over the stiff subset, in float32 or
// float64.
//
// Replaces the TPU kernel tiger_tpu/kernels/radau_pallas.py: _make_kernel's
// inner `kernel` (l.169-852), launched by pl.pallas_call in _pipeline
// (l.987).  Same per-system semantics: per attempt one forward-difference
// Jacobian at (t, y) with eps = sqrt(float32 eps); the simplified-Newton
// matrix solved in the eigenbasis of A^-1 (tableau._radau_eig) as one real
// and one complex 5x5 unpivoted Doolittle LU; masked Newton sweeps, at most
// newton_max_iter in all, converged by the absolute test OR RADAU5's
// kappa-scaled test (NaN counts as converged); the error estimate of
// radau_error_mode; unconverged steps rejected with h/2; collocation dense
// output; and radau_max_rejects consecutive rejections -> failed.  The TPU
// kernel's options are compile-time here, one instance per error mode with
// and without the predictor, each with and without factor reuse
// (radau_dispatch), so the default instance keeps its instructions:
//   - error modes (l.157-162, 439-490): 'embedded3' (E3, exponent 1/3) and
//     'reference' (the reference's E, 1/5) are the embedded difference;
//     'radau5' (1/4) is RADAU5's smoothed h M_r^-1 (f0 + sum_s EA_s z_s),
//     two triangular solves on the real factor every lane already holds,
//     and after a rejection, once more at the perturbed state y + e.  Its
//     controller scales the safety by (2M + 1) / (2M + sweeps);
//   - the predictor (l.276-322, 601-617): Newton starts from the stage
//     values the last attempt's collocation polynomial extrapolates.  The
//     last attempt's slopes are the warp's shared z, read before the new
//     start overwrites them; h_prev, the theta offset and whether the last
//     Newton converged to finite slopes are scalars alike on every lane;
//   - factor reuse (SolverConfig.radau_factor_reuse, l.359-392, 653-674,
//     771-786): the Jacobian and both LUs are kept (a copy in shared memory,
//     SharedReuse) and refreshed only when the system voted after its last
//     attempt (radau_refresh_sweeps sweeps or more, or Newton failed) or this
//     attempt's h_eff left [reuse_lo, reuse_hi] x the factored h.  The TPU
//     kernel's vote is its tile's: one lane's vote refactors 2,048; a warp
//     holds one system, so here each system votes for itself.  A reused
//     attempt skips lanes 1-5's perturbed right-hand sides and both LUs;
//     lane 0 still evaluates f(t, y), and radau5's error takes the factored
//     h (h M_r^-1 = (mu/h I - J)^-1 for the h the factor was built with).
//     A template bit, not a runtime flag: as a flag it cost the instances
//     without reuse 9-23 registers (float) and ~360 bytes of spill stores
//     (double) under ptxas, so each option set has an instance with reuse
//     and one without, and the latter keeps its code.
//
// What bounds it on the H100: latency.  The main path hands B2 ~131 stiff
// systems, and each needs ~3,100 attempts that depend on one another, so
// the wall is the slowest system's chain of attempts times the latency of
// one attempt; the arithmetic (~3,100 flops an attempt) and the bytes are
// a few hundredths of a millisecond.  A thread per system ran every
// operation of an attempt in series: ~15.5 right-hand sides (six for the
// Jacobian, three per Newton sweep), 25 Jacobian and 15 Newton divisions,
// both LUs and both solves.
//
// The design: one warp (one block of 32 threads) per system, so the 131
// systems spread over 131 SMs, and the work of an attempt that does not
// depend on itself spreads over the lanes:
//   - Jacobian: lane 0 evaluates f(t, y) and lanes 1-5 the five perturbed
//     right-hand sides, in one pass; lanes 0-24 then form one Jacobian
//     entry each, with its division;
//   - LU and solves: every lane factors both matrices and, in each sweep,
//     runs both solves, all in registers.  They are chains of dependent
//     pivots; splitting the LU's rows over lanes (a shuffle per pivot row)
//     measured slower than repeating it on every lane;
//   - Newton sweep: lanes 0-2 evaluate the three stage right-hand sides,
//     and lanes 0-14 update one stage slope each, with its division;
//   - error and dense output: one lane per component;
//   - the Newton norms and the error are one integer max-reduction each
//     (__reduce_max_sync on the bit patterns; see warp_jmax), where
//     butterflies of five shuffles made the costliest phase of a sweep.
// Scalars (t, h, h_eff, the Kahan term, the accept decision, counters) are
// computed alike on every lane, so control flow stays uniform.  Every
// operation of radau_plain happens, in its order, on some lane: sums
// are never re-associated, and only maxima (jnp.maximum, NaN kept) are
// reduced across lanes, which is exact in any order.  So with FMA
// contraction off (-fmad=false, as rk45.cu) the kernel agrees with
// radau_plain bit for bit.  The tableau and eigen-constants come from the
// kernel's parameter space (passed from tableau.py, never retyped here).
//
// The scalar is a template parameter as well: twelve float instances and
// the same twelve in double, which repeat the float code in double (the TPU
// kernel is float32 only and runs float64 through the vmap path,
// tiger_tpu/solver/radau.py radau_step; radau_dispatch).  The option sets
// call no libm function the default set does not, and double pow is
// contracted.cu's in all twelve.  A double warp maximum reduces the high
// words of the bit patterns, then the low words of the lanes that hold the
// highest high word (warp_jmax).  The file is compiled twice, as rk45.cu is:
// as it stands for the float instances and the entry points, and with
// -DTT_DOUBLE_INSTANCES, as relocatable device code, for the double ones.
//
// The model is a template parameter too (common.cuh Model204, Model200,
// ModelDummy).  Each right-hand side sees its time with the window's shift
// added (radau_pallas.py:194-195): the Jacobian's f and columns at t, the
// stage residuals at t + c_s h, radau5's second estimate at t.  Model 200's
// and DummyModel's instances are built in translation units of their own:
// the file compiled again with -DTT_MODEL_200 or -DTT_MODEL_DUMMY, in float
// and in double, as relocatable code.

#include <type_traits>

#include "common.cuh"

#ifdef TT_INSTANCE_TU
#undef TT_RADAU_PHASES  // the probes time Model 204's float instances
#endif

namespace tt {

constexpr int kWarp = 32;
constexpr unsigned kAllLanes = 0xffffffffu;

// One struct a scalar, its scalars and constants in T (a double instance
// gets tableau.py's float64 values, not floats widened).
template <class T>
struct RadauArgs {
  const T* y0;          // [5, S]
  const T* h0;          // [S]
  const T* params;      // [15, S], PARAM_FIELDS order
  const float* forc;    // [T_total, S] float32 in every instance; unused when forcing.n_forc == 0
  const T* qt;          // [Q] sorted, unique
  T* y_final;           // [5, S]; NaN where the system did not finish
  T* dense;             // [Q, 5, S]
  int32_t* failed;      // [S]
  int32_t* stats;       // [5, S]: accepted, rejected, attempted, sweeps, factorizations
  int64_t n_sys;
  int32_t n_q;
  int32_t safe_pow;
  T t0, tf;
  T rtol, atol, safety, min_scale, max_scale, expo, nan_shrink, h_freeze_hi;
  T newton_tol, kappa, tol_eps, fd_eps;
  int32_t max_steps, max_rejects, newton_max_iter, reject_unconverged;
  int32_t fill_t0_queries;
  int32_t err_mode;     // RadauErrMode: which instance the launcher starts,
  int32_t predictor;    // with the Newton predictor or not (and factor_reuse)
  T safety_newton;      // radau5: safety * (2 newton_max_iter + 1)
  ForcingMeta<T> forcing;
  T ra[3][3], rc[3], rb[3], re[3], rw[3][3];  // tableau.RADAU_*; re: E3 or E
  T ea[3], inv_a[3][3];                       // tableau.RADAU_ERR_EA, RADAU_A_INV
  T gam, alp, bet;                            // eigenvalues of A^-1
  T v1[3], v2r[3], v2i[3];                    // eigenvector columns
  T p1[3], p2r[3], p2i[3];                    // rows of Lambda V^-1
  // Last, so the fields above keep their offsets (and Model 204's
  // instances their code).
  int32_t model;  // KernelModel
  T t_shift;      // added to the time the rhs sees (not the forcing gather's)
  T doy0;         // Model 200: the day of year at t = 0
  // SolverConfig.radau_factor_reuse (which instance: with reuse or not) and
  // its knobs.
  int32_t factor_reuse, refresh_sweeps;
  T reuse_lo, reuse_hi;
};

// The two factors of (I - h A (x) J) in the eigenbasis of A^-1, in each
// lane's registers: every lane factors both matrices and runs both solves.
template <class T>
struct Factors {
  T mr[kNEq][kNEq], mr_inv[kNEq];      // gamma I - h J, unit-lower L + U
  T cre[kNEq][kNEq], cim[kNEq][kNEq];  // (alpha + beta i) I - h J
  T ci_re[kNEq], ci_im[kNEq];          // 1 / diag of the complex U

  __device__ __forceinline__ void real_solve(T (&x)[kNEq]) const {
#pragma unroll
    for (int k = 0; k < kNEq; ++k)
#pragma unroll
      for (int i = k + 1; i < kNEq; ++i) x[i] = x[i] - mr[i][k] * x[k];
#pragma unroll
    for (int k = kNEq - 1; k >= 0; --k) {
      T acc = x[k];
#pragma unroll
      for (int j = k + 1; j < kNEq; ++j) acc = acc - mr[k][j] * x[j];
      x[k] = acc * mr_inv[k];
    }
  }

  __device__ __forceinline__ void cplx_solve(T (&xr)[kNEq], T (&xi)[kNEq]) const {
#pragma unroll
    for (int k = 0; k < kNEq; ++k)
#pragma unroll
      for (int i = k + 1; i < kNEq; ++i) {
        xr[i] = xr[i] - (cre[i][k] * xr[k] - cim[i][k] * xi[k]);
        xi[i] = xi[i] - (cre[i][k] * xi[k] + cim[i][k] * xr[k]);
      }
#pragma unroll
    for (int k = kNEq - 1; k >= 0; --k) {
      T ar = xr[k], ai = xi[k];
#pragma unroll
      for (int j = k + 1; j < kNEq; ++j) {
        ar = ar - (cre[k][j] * xr[j] - cim[k][j] * xi[j]);
        ai = ai - (cre[k][j] * xi[j] + cim[k][j] * xr[j]);
      }
      xr[k] = ar * ci_re[k] - ai * ci_im[k];
      xi[k] = ar * ci_im[k] + ai * ci_re[k];
    }
  }
};

// What one lane hands another within an attempt.
template <class T>
struct Shared {
  T jf[kNEq + 1][kNEq];  // f(t, y), then f(t, y + h_eps[j] e_j) for j = 0..4
  T h_eps[kNEq];
  T mr[kNEq][kNEq], cre[kNEq][kNEq];  // gamma I - h J and Re((alpha + beta i) I - h J)
  T z[3][kNEq];                       // stage slopes
  T b[3][kNEq];                       // stage residuals f(stage) - z
};
// The instances with factor reuse also keep the system's last factors.
template <class T>
struct SharedReuse : Shared<T> {
  Factors<T> kept;
};

// x[i] for a lane-dependent i, by selects (an indexed register array would
// go to local memory).
template <int N, class T>
__device__ __forceinline__ T pick(const T (&x)[N], int i) {
  T v = x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = i == k ? x[k] : v;
  return v;
}

// Phase probes for `python -m tiger_tpu_torch.radau_phases`, compiled only
// with -DTT_RADAU_PHASES: lane 0 of each block adds its clock64() cycles per
// phase of the attempt loop into radau_phase_cycles, and the slowest
// block's total into its last slot.
constexpr int kPhases = 7;
#ifdef TT_RADAU_PHASES
__device__ unsigned long long radau_phase_cycles[kPhases + 1];
#define TT_PHASE_START                          \
  long long tt_clk = clock64(), tt_t0 = tt_clk; \
  unsigned long long tt_acc[kPhases] = {};
#define TT_PHASE(k)                         \
  {                                         \
    const long long tt_now = clock64();     \
    tt_acc[k] += tt_now - tt_clk;           \
    tt_clk = tt_now;                        \
  }
#define TT_PHASE_END                                                                 \
  if (lane == 0) {                                                                   \
    _Pragma("unroll") for (int k = 0; k < kPhases; ++k)                             \
        atomicAdd(&radau_phase_cycles[k], tt_acc[k]);                                \
    atomicMax(&radau_phase_cycles[kPhases], (unsigned long long)(tt_clk - tt_t0));  \
  }
#else
#define TT_PHASE_START
#define TT_PHASE(k)
#define TT_PHASE_END
#endif

// jnp.maximum over the warp of values that are +0 or more, or NaN: every
// lane gets the maximum, NaN if any lane holds NaN.  On such floats the bit
// patterns, read as unsigned integers, order as the values do, and every
// NaN's pattern lies above +inf's, so one integer max-reduction gives what
// the serial jmax chain gives (a maximum is exact in any order; fmaxf would
// drop the NaN).  B2 reduces absolute values and their ratios to tolerances,
// which the wrapper keeps from going negative (rtol, atol >= 0).
__device__ __forceinline__ float warp_jmax(float v) {
  return __uint_as_float(__reduce_max_sync(kAllLanes, __float_as_uint(v)));
}
// The same for doubles, whose bit patterns order as the values do too;
// __reduce_max_sync has no 64-bit form, so it takes the highest high word,
// then the highest low word among the lanes that hold it: exactly the
// 64-bit maximum.
__device__ __forceinline__ double warp_jmax(double v) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(v);
  const unsigned hi = (unsigned)(u >> 32), lo = (unsigned)u;
  const unsigned top = __reduce_max_sync(kAllLanes, hi);
  const unsigned low = __reduce_max_sync(kAllLanes, hi == top ? lo : 0u);
  return __longlong_as_double((long long)(((unsigned long long)top << 32) | low));
}

// SolverConfig.radau_error_mode (kernels/radau.py ERR_MODES).
enum RadauErrMode : int32_t { kEmbedded3 = 0, kReference = 1, kRadau5 = 2 };

// One system on the block's 32 lanes; every lane runs every loop trip.  SH:
// Shared<T>, or SharedReuse<T> with REUSE.
template <class T, class M, int ERR, bool PRED, bool REUSE, class SH>
__device__ __forceinline__ void radau_system(const RadauArgs<T>& a, int64_t s, SH& sh) {
  const int lane = threadIdx.x;
  const int64_t S = a.n_sys;
  M model;
  model.load(a.params, S, s, a.safe_pow, a.doy0);
  T y[kNEq];
#pragma unroll
  for (int i = 0; i < kNEq; ++i) y[i] = __ldg(a.y0 + i * S + s);
  const T t0 = a.t0, tf = a.tf;
  const int32_t n_forc = a.forcing.n_forc;

  // Each lane's roles; a lane past a role's range repeats an in-range
  // lane's work and never stores it.
  const int jc = lane <= kNEq ? lane : 0;                // 0: f(t,y); 1+j: column j
  const int ent = lane < kNEq * kNEq ? lane : 0;         // Jacobian entry (ei, ej)
  const int ei = ent / kNEq, ej = ent % kNEq;
  const int st = lane < 3 ? lane : 0;                    // Newton stage
  const bool upd_lane = lane < 3 * kNEq;
  const int upd = upd_lane ? lane : 0;                   // stage slope z[us][ui]
  const int us = upd / kNEq, ui = upd % kNEq;
  const int comp = lane < kNEq ? lane : 0;               // state component
  T ra_st[3];  // row st of the Radau A
#pragma unroll
  for (int j = 0; j < 3; ++j) ra_st[j] = st == 0 ? a.ra[0][j] : st == 1 ? a.ra[1][j] : a.ra[2][j];
  const T v1_us = pick(a.v1, us), v2r_us = pick(a.v2r, us), v2i_us = pick(a.v2i, us);
  T inv_a_us[3] = {};  // row us of A^-1 (the predictor)
  if constexpr (PRED) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      inv_a_us[j] = us == 0 ? a.inv_a[0][j] : us == 1 ? a.inv_a[1][j] : a.inv_a[2][j];
  }

  int q = 0;
  for (int e = lane; e < a.n_q * kNEq; e += kWarp) {
    const int qi = e / kNEq, i = e % kNEq;
    const bool pre = a.fill_t0_queries && __ldg(a.qt + qi) <= t0;
    a.dense[((int64_t)qi * kNEq + i) * S + s] = pre ? pick(y, i) : T(0);
  }
  while (q < a.n_q && __ldg(a.qt + q) <= t0) ++q;

  T t = t0, t_c = T(0), h = __ldg(a.h0 + s);
  int32_t reject = 0, failed = 0, n_acc = 0, n_rej = 0, n_att = 0, n_swp = 0;
  int32_t n_fct = 0;
  // The predictor's state: the last attempt's step, the theta offset of
  // the next step on its polynomial (1 after an accept, 0 after a reject),
  // and whether its slopes (in sh.z) may seed.
  T h_prev = T(1), z_base = T(0);
  bool have = false;
  // Factor reuse (radau_pallas.py l.359-392, 771-786), per system: the step
  // the factors in sh.kept were built with, and the refresh vote, cast
  // before the first attempt.  Without reuse every attempt factors afresh.
  T h_fact = T(0);
  bool refresh = true;

  TT_PHASE_START
  while (t < tf && !failed && n_att < a.max_steps) {
    T h_eff = t + h > tf ? tf - t : h;
    if (a.forcing.align) h_eff = zoh_step_cap(a.forcing, t, h_eff);
    T f[kMaxForcings];
    gather_forcings(a.forc, S, s, a.forcing, t, f);
    // Refactor on the vote, or when this step left [lo, hi] x h_fact.
    bool fresh = true;
    if constexpr (REUSE) {
      const T ratio = h_eff / h_fact;
      fresh = refresh || ratio < a.reuse_lo || ratio > a.reuse_hi || is_nan(ratio);
    }
    TT_PHASE(0)  // step start: h_eff, step cap, forcing gather

    // f(t, y) and, for fresh factors, the five forward-difference columns
    // in one pass.
    {
      const int j = jc - 1;  // the perturbed component; -1 on lane 0
      const T h_eps = a.fd_eps * jmax(T(1), fabs_t(pick(y, j)));
      T yp[kNEq], fp[kNEq];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) yp[i] = i == j ? y[i] + h_eps : y[i];
      if (fresh || j < 0) model.rhs(t + a.t_shift, yp, f, n_forc, fp);
      if (lane == 0 || (fresh && lane <= kNEq)) {
#pragma unroll
        for (int i = 0; i < kNEq; ++i) sh.jf[jc][i] = fp[i];
        if (j >= 0) sh.h_eps[j] = h_eps;
      }
    }
    __syncwarp();
    TT_PHASE(1)  // the six right-hand sides of f and the Jacobian

    // One Jacobian entry per lane, into both matrices' entry (ei, ej).
    T m_ent = T(0), c_ent = T(0);
    if (fresh) {
      const T jac = (sh.jf[ej + 1][ei] - sh.jf[0][ei]) / sh.h_eps[ej];
      m_ent = ei == ej ? a.gam - h_eff * jac : (-h_eff) * jac;
      c_ent = ei == ej ? a.alp - h_eff * jac : (-h_eff) * jac;
    }

    // Simplified Newton on the stage slopes Z, started at f(t, y): this
    // lane's slope z[us][ui] stays in a register, the shared copy feeds
    // the stage evaluations.
    T z_own = sh.jf[0][ui];
    if constexpr (PRED) {
      // Z0_i = (h_prev / h) sum_j A^-1[i][j] (I(theta_j) - I(base)) z_prev,
      // theta_j = base + c_j h / h_prev, in radau_plain's order.
      const T ratio = h_eff / h_prev;
      if (have && ratio <= T(2)) {
        const T base2 = z_base * z_base, base3 = base2 * z_base;
        T i_th[3][3];  // [stage][node]
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const T th = z_base + a.rc[i] * ratio;
          const T th2 = th * th, th3 = th2 * th;
#pragma unroll
          for (int sg = 0; sg < 3; ++sg)
            i_th[sg][i] = a.rw[sg][0] * (th - z_base) + a.rw[sg][1] * (th2 - base2) +
                          a.rw[sg][2] * (th3 - base3);
        }
        const T zp0 = sh.z[0][ui], zp1 = sh.z[1][ui], zp2 = sh.z[2][ui];
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T vjk = i_th[0][j] * zp0 + i_th[1][j] * zp1 + i_th[2][j] * zp2;
          const T term = inv_a_us[j] * vjk;
          acc = j == 0 ? term : acc + term;
        }
        z_own = (h_prev / h_eff) * acc;
      }
      __syncwarp();  // every lane has read the last slopes
    }
    if (upd_lane) sh.z[us][ui] = z_own;
    const T tol_own = a.atol + a.rtol * fabs_t(pick(y, ui));

    if (fresh && lane < kNEq * kNEq) {
      sh.mr[ei][ej] = m_ent;
      sh.cre[ei][ej] = c_ent;
    }
    __syncwarp();

    // Both unpivoted Doolittle LUs, on every lane (see the note at the top),
    // or the kept ones.
    Factors<T> fa;
    if constexpr (REUSE) {
      if (!fresh) fa = sh.kept;
    }
    if (fresh) {
#pragma unroll
      for (int i = 0; i < kNEq; ++i)
#pragma unroll
        for (int j = 0; j < kNEq; ++j) {
          fa.mr[i][j] = sh.mr[i][j];
          fa.cre[i][j] = sh.cre[i][j];
          fa.cim[i][j] = i == j ? a.bet : T(0);
        }
#pragma unroll
      for (int k = 0; k < kNEq; ++k) {
        fa.mr_inv[k] = T(1) / fa.mr[k][k];
#pragma unroll
        for (int i = k + 1; i < kNEq; ++i) {
          const T m = fa.mr[i][k] * fa.mr_inv[k];
          fa.mr[i][k] = m;
#pragma unroll
          for (int j = k + 1; j < kNEq; ++j) fa.mr[i][j] = fa.mr[i][j] - m * fa.mr[k][j];
        }
      }
#pragma unroll
      for (int k = 0; k < kNEq; ++k) {
        const T inv_den =
            T(1) / (fa.cre[k][k] * fa.cre[k][k] + fa.cim[k][k] * fa.cim[k][k]);
        fa.ci_re[k] = fa.cre[k][k] * inv_den;
        fa.ci_im[k] = -fa.cim[k][k] * inv_den;
#pragma unroll
        for (int i = k + 1; i < kNEq; ++i) {
          const T m_re = fa.cre[i][k] * fa.ci_re[k] - fa.cim[i][k] * fa.ci_im[k];
          const T m_im = fa.cre[i][k] * fa.ci_im[k] + fa.cim[i][k] * fa.ci_re[k];
          fa.cre[i][k] = m_re;
          fa.cim[i][k] = m_im;
#pragma unroll
          for (int j = k + 1; j < kNEq; ++j) {
            fa.cre[i][j] = fa.cre[i][j] - (m_re * fa.cre[k][j] - m_im * fa.cim[k][j]);
            fa.cim[i][j] = fa.cim[i][j] - (m_re * fa.cim[k][j] + m_im * fa.cre[k][j]);
          }
        }
      }
      if constexpr (REUSE) {
        h_fact = h_eff;
        // Kept for the attempts that reuse them; read after a later __syncwarp.
        if (lane == 0) sh.kept = fa;
      }
    }
    TT_PHASE(2)  // Jacobian entries and both LUs

    bool conv = false;
    int32_t sweeps = 0;
#pragma unroll 1
    for (int it = 0; it < a.newton_max_iter; ++it) {
      // Stage `st`'s residual f(t, y + h sum_j A[st][j] z_j) - z_st.
      {
        T ys[kNEq], fs[kNEq];
#pragma unroll
        for (int i = 0; i < kNEq; ++i) ys[i] = y[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T hw = h_eff * ra_st[j];
#pragma unroll
          for (int i = 0; i < kNEq; ++i) ys[i] = ys[i] + hw * sh.z[j][i];
        }
        model.rhs((t + a.rc[st] * h_eff) + a.t_shift, ys, f, n_forc, fs);
        if (lane < 3) {
#pragma unroll
          for (int i = 0; i < kNEq; ++i) sh.b[st][i] = fs[i] - sh.z[st][i];
        }
      }
      __syncwarp();
      TT_PHASE(3)  // sweep: the stage right-hand sides
      // u = (P (x) I) b; one real and one complex solve, on every lane.
      T w1[kNEq], wr[kNEq], wi[kNEq];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        const T b0 = sh.b[0][i], b1 = sh.b[1][i], b2 = sh.b[2][i];
        w1[i] = a.p1[0] * b0 + a.p1[1] * b1 + a.p1[2] * b2;
        wr[i] = a.p2r[0] * b0 + a.p2r[1] * b1 + a.p2r[2] * b2;
        wi[i] = a.p2i[0] * b0 + a.p2i[1] * b1 + a.p2i[2] * b2;
      }
      fa.real_solve(w1);
      fa.cplx_solve(wr, wi);
      ++sweeps;
      TT_PHASE(4)  // sweep: w and both solves
      // dZ = V w + conj, one entry per lane; the three norms by warp jmax.
      const T d = v1_us * pick(w1, ui) + T(2) * (v2r_us * pick(wr, ui) - v2i_us * pick(wi, ui));
      z_own = z_own + d;
      const T ad = fabs_t(d);
      const T maxd = warp_jmax(upd_lane ? ad : T(0));
      const T scaled = warp_jmax(upd_lane ? ad / tol_own : T(0));
      const T zmag = warp_jmax(upd_lane ? fabs_t(z_own) : T(0));
      if (upd_lane) sh.z[us][ui] = z_own;
      __syncwarp();
      const T tol_eff = a.newton_tol + a.tol_eps * zmag;
      TT_PHASE(5)  // sweep: slope updates and the three warp maxima
      if (maxd < tol_eff || h_eff * scaled < a.kappa || is_nan(maxd)) {
        conv = true;
        break;
      }
    }

    // Step update (every lane, for the whole state) and the embedded3
    // error (one component per lane).
    T y_out[kNEq];
#pragma unroll
    for (int i = 0; i < kNEq; ++i) {
      T yo = y[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) yo = yo + (h_eff * a.rb[j]) * sh.z[j][i];
      y_out[i] = yo;
    }
    T err;
    if constexpr (ERR == kRadau5) {
      const T tol = a.atol + a.rtol * jmax(fabs_t(pick(y, comp)), fabs_t(pick(y_out, comp)));
      // e = h M_r^-1 (f0 + sum_s EA_s z_s), every lane for the whole state.
      T defect[kNEq], e[kNEq];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        defect[i] = sh.jf[0][i] + a.ea[0] * sh.z[0][i] + a.ea[1] * sh.z[1][i] +
                    a.ea[2] * sh.z[2][i];
        e[i] = defect[i];
      }
      fa.real_solve(e);
      // (mu/h I - J)^-1 = h M_r^-1 for the h the factor was built with:
      // h_eff, or with reuse the factors' h_fact.
      const T h_m = REUSE ? h_fact : h_eff;
#pragma unroll
      for (int i = 0; i < kNEq; ++i) e[i] = h_m * e[i];
      err = warp_jmax(lane < kNEq ? fabs_t(pick(e, comp) / tol) : T(0));
      if (err > T(1) && reject > 0) {
        // After a rejection: the defect's f again at y + e.
        T yp[kNEq], fp[kNEq];
#pragma unroll
        for (int i = 0; i < kNEq; ++i) yp[i] = y[i] + e[i];
        model.rhs(t + a.t_shift, yp, f, n_forc, fp);
#pragma unroll
        for (int i = 0; i < kNEq; ++i) e[i] = fp[i] + defect[i] - sh.jf[0][i];
        fa.real_solve(e);
#pragma unroll
        for (int i = 0; i < kNEq; ++i) e[i] = h_m * e[i];
        err = warp_jmax(lane < kNEq ? fabs_t(pick(e, comp) / tol) : T(0));
      }
    } else {
      T ec = T(0);
#pragma unroll
      for (int j = 0; j < 3; ++j) ec = ec + (h_eff * a.re[j]) * sh.z[j][comp];
      const T tol = a.atol + a.rtol * jmax(fabs_t(pick(y, comp)), fabs_t(pick(y_out, comp)));
      err = warp_jmax(lane < kNEq ? fabs_t(ec / tol) : T(0));
    }
    const bool newt_fail = a.reject_unconverged && !conv;
    const bool accept = err <= T(1) && !newt_fail;

    const T kh = h_eff - t_c;
    const T t1 = t + kh;
    if (accept && q < a.n_q && __ldg(a.qt + q) <= t1) {
      T qm[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < 3; ++j) acc = acc + a.rw[j][m] * sh.z[j][comp];
        qm[m] = acc;
      }
      const T y_comp = pick(y, comp);
      T tq;
      while (q < a.n_q && (tq = __ldg(a.qt + q)) <= t1) {
        const T theta = (tq - t) / h_eff;
        const T th2 = theta * theta;
        const T poly = qm[0] * theta + qm[1] * th2 + qm[2] * th2 * theta;
        if (lane < kNEq) a.dense[((int64_t)q * kNEq + comp) * S + s] = y_comp + h_eff * poly;
        ++q;
      }
    }

    T safety = a.safety;
    if constexpr (ERR == kRadau5)
      safety = a.safety_newton / ((T)(2 * a.newton_max_iter) + (T)sweeps);
    const T raw_fac = safety * pow_t(T(1) / (err + T(1e-16)), a.expo);
    const T fac_acc = jclip(raw_fac, a.min_scale, a.max_scale);
    T fac_rej = jclip(is_nan(raw_fac) ? a.nan_shrink : jmin(raw_fac, T(1)),
                      a.min_scale, a.max_scale);
    if (newt_fail) fac_rej = T(0.5);  // Newton failure says nothing about the error
    T h_new = h_eff * (accept ? fac_acc : fac_rej);
    if (a.h_freeze_hi > T(1) && accept && fac_acc >= T(1) && fac_acc <= a.h_freeze_hi)
      h_new = h_eff;

    if constexpr (PRED) {
      // Only a converged Newton solution with finite slopes seeds the next
      // attempt.
      const bool finite = __all_sync(kAllLanes, !upd_lane || isfinite(z_own));
      have = conv && finite;
      h_prev = h_eff;
      z_base = accept ? T(1) : T(0);
    }
    const int32_t reject_new = accept ? 0 : reject + 1;
    if (!accept && reject_new > a.max_rejects) failed = 1;
    if (accept) {
      t_c = (t1 - t) - kh;
      t = t1;
#pragma unroll
      for (int i = 0; i < kNEq; ++i) y[i] = y_out[i];
    }
    h = h_new;
    reject = reject_new;
    n_acc += accept ? 1 : 0;
    n_rej += accept ? 0 : 1;
    n_swp += sweeps;
    n_fct += fresh ? 1 : 0;
    ++n_att;
    // The next attempt's vote: this one took radau_refresh_sweeps sweeps or
    // more, or its Newton failed.
    if constexpr (REUSE) refresh = sweeps >= a.refresh_sweeps || newt_fail;
    TT_PHASE(6)  // step update, error, dense output, controller
  }
  TT_PHASE_END

  const bool completed = t >= tf;
  if (lane < kNEq) a.y_final[comp * S + s] = completed ? pick(y, comp) : T(NAN);
  if (lane == 0) {
    a.failed[s] = (failed || !completed) ? 1 : 0;
    a.stats[s] = n_acc;
    a.stats[S + s] = n_rej;
    a.stats[2 * S + s] = n_att;
    a.stats[3 * S + s] = n_swp;
    a.stats[4 * S + s] = n_fct;
  }
}

// One block, one warp, per system.
template <class T, class M, int ERR, bool PRED, bool REUSE>
__global__ void __launch_bounds__(kWarp) radau_kernel(const RadauArgs<T> a) {
  __shared__ std::conditional_t<REUSE, SharedReuse<T>, Shared<T>> sh;
  radau_system<T, M, ERR, PRED, REUSE>(a, blockIdx.x, sh);
}

// Calls f(std::integral_constant<int, ERR>{}, std::bool_constant<PRED>{},
// std::bool_constant<REUSE>{}) for the instance of (err_mode, predictor,
// factor_reuse) in scalar T; false if it has none.  Both scalars and every
// model have the same twelve sets.
template <class T, class F>
inline bool radau_dispatch(int32_t err_mode, int32_t predictor, int32_t reuse, F&& f) {
  if (predictor != 0 && predictor != 1) return false;
  if (reuse != 0 && reuse != 1) return false;
  const auto with_reuse = [&](auto err, auto pred) {
    if (reuse) {
      f(err, pred, std::true_type{});
    } else {
      f(err, pred, std::false_type{});
    }
  };
  const auto with_pred = [&](auto err) {
    if (predictor) {
      with_reuse(err, std::true_type{});
    } else {
      with_reuse(err, std::false_type{});
    }
  };
  switch (err_mode) {
    case kEmbedded3: with_pred(std::integral_constant<int, kEmbedded3>{}); return true;
    case kReference: with_pred(std::integral_constant<int, kReference>{}); return true;
    case kRadau5: with_pred(std::integral_constant<int, kRadau5>{}); return true;
    default: return false;
  }
}

}  // namespace tt

// ---- launch ----

namespace tt {

template <class T, class M>
int radau_launch(const RadauArgs<T>* args, void* stream) {
  if (args->n_sys <= 0) return 0;
  const bool known = radau_dispatch<T>(args->err_mode, args->predictor, args->factor_reuse,
                                       [&](auto err, auto pred, auto reuse) {
    radau_kernel<T, M, decltype(err)::value, decltype(pred)::value, decltype(reuse)::value>
        <<<(unsigned)args->n_sys, kWarp, 0, (cudaStream_t)stream>>>(*args);
  });
  if (!known) return kNoInstance;
  return (int)cudaGetLastError();
}

// The host side of the instances built in this file's other translation
// units (-DTT_DOUBLE_INSTANCES, -DTT_MODEL_200, -DTT_MODEL_DUMMY, and each
// model with the first), called by the entry point of the first: Model 204
// in double, Model 200 and DummyModel in float and double.
int radau_launch_f64(const void* args, void* stream);
int radau_launch_m200(const void* args, void* stream);
int radau_launch_m200_f64(const void* args, void* stream);
int radau_launch_dummy(const void* args, void* stream);
int radau_launch_dummy_f64(const void* args, void* stream);

#ifdef TT_INSTANCE_TU
#ifdef TT_DOUBLE_INSTANCES
using TuReal = double;
#else
using TuReal = float;
#endif
#if defined(TT_MODEL_200)
using TuModel = Model200<TuReal>;
#elif defined(TT_MODEL_DUMMY)
using TuModel = ModelDummy<TuReal>;
#else
using TuModel = Model204<TuReal>;
#endif
#if defined(TT_MODEL_200) && defined(TT_DOUBLE_INSTANCES)
#define TT_TU(fn) fn##_m200_f64
#elif defined(TT_MODEL_200)
#define TT_TU(fn) fn##_m200
#elif defined(TT_MODEL_DUMMY) && defined(TT_DOUBLE_INSTANCES)
#define TT_TU(fn) fn##_dummy_f64
#elif defined(TT_MODEL_DUMMY)
#define TT_TU(fn) fn##_dummy
#else
#define TT_TU(fn) fn##_f64
#endif
int TT_TU(radau_launch)(const void* args, void* stream) {
  return radau_launch<TuReal, TuModel>(static_cast<const RadauArgs<TuReal>*>(args), stream);
}
#endif

}  // namespace tt

#ifndef TT_INSTANCE_TU
// In each entry point f64 picks the scalar: 0 float (RadauArgs<float>), 1
// double (RadauArgs<double>); the model is RadauArgs.model.
extern "C" int tt_radau_args_size(int32_t f64) {
  return f64 ? (int)sizeof(tt::RadauArgs<double>) : (int)sizeof(tt::RadauArgs<float>);
}

// Enqueues the instance of (model, f64, err_mode, predictor, factor_reuse)
// on `stream`;
// returns cudaGetLastError() (0 on success; kNoInstance for a set without one).
extern "C" int tt_radau_launch(const void* args, int32_t f64, void* stream) {
  const int32_t model = f64 ? static_cast<const tt::RadauArgs<double>*>(args)->model
                            : static_cast<const tt::RadauArgs<float>*>(args)->model;
  switch (model) {
    case tt::kModel204:
      return f64 ? tt::radau_launch_f64(args, stream)
                 : tt::radau_launch<float, tt::Model204<float>>(
                       static_cast<const tt::RadauArgs<float>*>(args), stream);
    case tt::kModel200:
      return f64 ? tt::radau_launch_m200_f64(args, stream) : tt::radau_launch_m200(args, stream);
    case tt::kModelDummy:
      return f64 ? tt::radau_launch_dummy_f64(args, stream) : tt::radau_launch_dummy(args, stream);
    default:
      return tt::kNoInstance;
  }
}
#endif

#ifdef TT_RADAU_PHASES
// Copies the phase counters (kPhases sums, then the slowest block's total)
// into `out` and clears them; returns the CUDA error code.
extern "C" int tt_radau_phase_cycles(unsigned long long* out) {
  static const unsigned long long zero[tt::kPhases + 1] = {};
  cudaError_t rc = cudaMemcpyFromSymbol(out, tt::radau_phase_cycles, sizeof(zero));
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(tt::radau_phase_cycles, zero, sizeof(zero));
  return (int)rc;
}
#endif
