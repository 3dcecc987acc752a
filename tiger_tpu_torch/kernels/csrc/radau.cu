// B2: fused 3-stage Radau IIA (order 5) over the stiff subset, float32.
//
// Replaces the TPU kernel tiger_tpu/kernels/radau_pallas.py: _make_kernel's
// inner `kernel` (l.169-852), launched by pl.pallas_call in _pipeline
// (l.987).  Same per-system semantics with the default options (embedded3
// error, no predictor, no factor reuse): per attempt one forward-difference
// Jacobian at (t, y) with eps = sqrt(float32 eps); the simplified-Newton
// matrix solved in the eigenbasis of A^-1 (tableau._radau_eig) as one real
// and one complex 5x5 unpivoted Doolittle LU; masked Newton sweeps, at most
// newton_max_iter in all, converged by the absolute test OR RADAU5's
// kappa-scaled test (NaN counts as converged); the embedded3 error;
// unconverged steps rejected with h/2; collocation dense output; and
// radau_max_rejects consecutive rejections -> failed.
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

#include "common.cuh"

namespace tt {

constexpr int kWarp = 32;
constexpr unsigned kAllLanes = 0xffffffffu;

struct RadauArgs {
  const float* y0;      // [5, S]
  const float* h0;      // [S]
  const float* params;  // [15, S], PARAM_FIELDS order
  const float* forc;    // [T_total, S]; unused when forcing.n_forc == 0
  const float* qt;      // [Q] sorted, unique
  float* y_final;       // [5, S]; NaN where the system did not finish
  float* dense;         // [Q, 5, S]
  int32_t* failed;      // [S]
  int32_t* stats;       // [5, S]: accepted, rejected, attempted, sweeps, factorizations
  int64_t n_sys;
  int32_t n_q;
  int32_t safe_pow;
  float t0, tf;
  float rtol, atol, safety, min_scale, max_scale, expo, nan_shrink, h_freeze_hi;
  float newton_tol, kappa, tol_eps, fd_eps;
  int32_t max_steps, max_rejects, newton_max_iter, reject_unconverged;
  int32_t fill_t0_queries;
  ForcingMeta forcing;
  float ra[3][3], rc[3], rb[3], re[3], rw[3][3];  // tableau.RADAU_*
  float gam, alp, bet;                            // eigenvalues of A^-1
  float v1[3], v2r[3], v2i[3];                    // eigenvector columns
  float p1[3], p2r[3], p2i[3];                    // rows of Lambda V^-1
};

// The two factors of (I - h A (x) J) in the eigenbasis of A^-1, in each
// lane's registers: every lane factors both matrices and runs both solves.
struct Factors {
  float mr[kNEq][kNEq], mr_inv[kNEq];      // gamma I - h J, unit-lower L + U
  float cre[kNEq][kNEq], cim[kNEq][kNEq];  // (alpha + beta i) I - h J
  float ci_re[kNEq], ci_im[kNEq];          // 1 / diag of the complex U

  __device__ __forceinline__ void real_solve(float (&x)[kNEq]) const {
#pragma unroll
    for (int k = 0; k < kNEq; ++k)
#pragma unroll
      for (int i = k + 1; i < kNEq; ++i) x[i] = x[i] - mr[i][k] * x[k];
#pragma unroll
    for (int k = kNEq - 1; k >= 0; --k) {
      float acc = x[k];
#pragma unroll
      for (int j = k + 1; j < kNEq; ++j) acc = acc - mr[k][j] * x[j];
      x[k] = acc * mr_inv[k];
    }
  }

  __device__ __forceinline__ void cplx_solve(float (&xr)[kNEq], float (&xi)[kNEq]) const {
#pragma unroll
    for (int k = 0; k < kNEq; ++k)
#pragma unroll
      for (int i = k + 1; i < kNEq; ++i) {
        xr[i] = xr[i] - (cre[i][k] * xr[k] - cim[i][k] * xi[k]);
        xi[i] = xi[i] - (cre[i][k] * xi[k] + cim[i][k] * xr[k]);
      }
#pragma unroll
    for (int k = kNEq - 1; k >= 0; --k) {
      float ar = xr[k], ai = xi[k];
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
struct Shared {
  float jf[kNEq + 1][kNEq];  // f(t, y), then f(t, y + h_eps[j] e_j) for j = 0..4
  float h_eps[kNEq];
  float mr[kNEq][kNEq], cre[kNEq][kNEq];  // gamma I - h J and Re((alpha + beta i) I - h J)
  float z[3][kNEq];                       // stage slopes
  float b[3][kNEq];                       // stage residuals f(stage) - z
};

// x[i] for a lane-dependent i, by selects (an indexed register array would
// go to local memory).
template <int N>
__device__ __forceinline__ float pick(const float (&x)[N], int i) {
  float v = x[0];
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

// One system on the block's 32 lanes; every lane runs every loop trip.
__device__ __forceinline__ void radau_system(const RadauArgs& a, int64_t s, Shared& sh) {
  const int lane = threadIdx.x;
  const int64_t S = a.n_sys;
  Model204 model;
  model.load(a.params, S, s, a.safe_pow);
  float y[kNEq];
#pragma unroll
  for (int i = 0; i < kNEq; ++i) y[i] = __ldg(a.y0 + i * S + s);
  const float t0 = a.t0, tf = a.tf;
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
  float ra_st[3];  // row st of the Radau A
#pragma unroll
  for (int j = 0; j < 3; ++j) ra_st[j] = st == 0 ? a.ra[0][j] : st == 1 ? a.ra[1][j] : a.ra[2][j];
  const float v1_us = pick(a.v1, us), v2r_us = pick(a.v2r, us), v2i_us = pick(a.v2i, us);

  int q = 0;
  for (int e = lane; e < a.n_q * kNEq; e += kWarp) {
    const int qi = e / kNEq, i = e % kNEq;
    const bool pre = a.fill_t0_queries && __ldg(a.qt + qi) <= t0;
    a.dense[((int64_t)qi * kNEq + i) * S + s] = pre ? pick(y, i) : 0.f;
  }
  while (q < a.n_q && __ldg(a.qt + q) <= t0) ++q;

  float t = t0, t_c = 0.f, h = __ldg(a.h0 + s);
  int32_t reject = 0, failed = 0, n_acc = 0, n_rej = 0, n_att = 0, n_swp = 0;
  int32_t n_fct = 0;

  TT_PHASE_START
  while (t < tf && !failed && n_att < a.max_steps) {
    float h_eff = t + h > tf ? tf - t : h;
    if (a.forcing.align) h_eff = zoh_step_cap(a.forcing, t, h_eff);
    float f[kMaxForcings];
    gather_forcings(a.forc, S, s, a.forcing, t, f);
    TT_PHASE(0)  // step start: h_eff, step cap, forcing gather

    // f(t, y) and the five forward-difference columns in one pass.
    {
      const int j = jc - 1;  // the perturbed component; -1 on lane 0
      const float h_eps = a.fd_eps * jmax(1.f, fabsf(pick(y, j)));
      float yp[kNEq], fp[kNEq];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) yp[i] = i == j ? y[i] + h_eps : y[i];
      model.rhs(yp, f, n_forc, fp);
      if (lane <= kNEq) {
#pragma unroll
        for (int i = 0; i < kNEq; ++i) sh.jf[jc][i] = fp[i];
        if (j >= 0) sh.h_eps[j] = h_eps;
      }
    }
    __syncwarp();
    TT_PHASE(1)  // the six right-hand sides of f and the Jacobian

    // One Jacobian entry per lane, into both matrices' entry (ei, ej).
    const float jac = (sh.jf[ej + 1][ei] - sh.jf[0][ei]) / sh.h_eps[ej];
    const float m_ent = ei == ej ? a.gam - h_eff * jac : (-h_eff) * jac;
    const float c_ent = ei == ej ? a.alp - h_eff * jac : (-h_eff) * jac;

    // Simplified Newton on the stage slopes Z, started at f(t, y): this
    // lane's slope z[us][ui] stays in a register, the shared copy feeds
    // the stage evaluations.
    float z_own = sh.jf[0][ui];
    if (upd_lane) sh.z[us][ui] = z_own;
    const float tol_own = a.atol + a.rtol * fabsf(pick(y, ui));

    if (lane < kNEq * kNEq) {
      sh.mr[ei][ej] = m_ent;
      sh.cre[ei][ej] = c_ent;
    }
    __syncwarp();

    // Both unpivoted Doolittle LUs, on every lane (see the note at the top).
    Factors fa;
#pragma unroll
    for (int i = 0; i < kNEq; ++i)
#pragma unroll
      for (int j = 0; j < kNEq; ++j) {
        fa.mr[i][j] = sh.mr[i][j];
        fa.cre[i][j] = sh.cre[i][j];
        fa.cim[i][j] = i == j ? a.bet : 0.f;
      }
#pragma unroll
    for (int k = 0; k < kNEq; ++k) {
      fa.mr_inv[k] = 1.f / fa.mr[k][k];
#pragma unroll
      for (int i = k + 1; i < kNEq; ++i) {
        const float m = fa.mr[i][k] * fa.mr_inv[k];
        fa.mr[i][k] = m;
#pragma unroll
        for (int j = k + 1; j < kNEq; ++j) fa.mr[i][j] = fa.mr[i][j] - m * fa.mr[k][j];
      }
    }
#pragma unroll
    for (int k = 0; k < kNEq; ++k) {
      const float inv_den =
          1.f / (fa.cre[k][k] * fa.cre[k][k] + fa.cim[k][k] * fa.cim[k][k]);
      fa.ci_re[k] = fa.cre[k][k] * inv_den;
      fa.ci_im[k] = -fa.cim[k][k] * inv_den;
#pragma unroll
      for (int i = k + 1; i < kNEq; ++i) {
        const float m_re = fa.cre[i][k] * fa.ci_re[k] - fa.cim[i][k] * fa.ci_im[k];
        const float m_im = fa.cre[i][k] * fa.ci_im[k] + fa.cim[i][k] * fa.ci_re[k];
        fa.cre[i][k] = m_re;
        fa.cim[i][k] = m_im;
#pragma unroll
        for (int j = k + 1; j < kNEq; ++j) {
          fa.cre[i][j] = fa.cre[i][j] - (m_re * fa.cre[k][j] - m_im * fa.cim[k][j]);
          fa.cim[i][j] = fa.cim[i][j] - (m_re * fa.cim[k][j] + m_im * fa.cre[k][j]);
        }
      }
    }
    TT_PHASE(2)  // Jacobian entries and both LUs

    bool conv = false;
    int32_t sweeps = 0;
#pragma unroll 1
    for (int it = 0; it < a.newton_max_iter; ++it) {
      // Stage `st`'s residual f(t, y + h sum_j A[st][j] z_j) - z_st.
      {
        float ys[kNEq], fs[kNEq];
#pragma unroll
        for (int i = 0; i < kNEq; ++i) ys[i] = y[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float hw = h_eff * ra_st[j];
#pragma unroll
          for (int i = 0; i < kNEq; ++i) ys[i] = ys[i] + hw * sh.z[j][i];
        }
        model.rhs(ys, f, n_forc, fs);
        if (lane < 3) {
#pragma unroll
          for (int i = 0; i < kNEq; ++i) sh.b[st][i] = fs[i] - sh.z[st][i];
        }
      }
      __syncwarp();
      TT_PHASE(3)  // sweep: the stage right-hand sides
      // u = (P (x) I) b; one real and one complex solve, on every lane.
      float w1[kNEq], wr[kNEq], wi[kNEq];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        const float b0 = sh.b[0][i], b1 = sh.b[1][i], b2 = sh.b[2][i];
        w1[i] = a.p1[0] * b0 + a.p1[1] * b1 + a.p1[2] * b2;
        wr[i] = a.p2r[0] * b0 + a.p2r[1] * b1 + a.p2r[2] * b2;
        wi[i] = a.p2i[0] * b0 + a.p2i[1] * b1 + a.p2i[2] * b2;
      }
      fa.real_solve(w1);
      fa.cplx_solve(wr, wi);
      ++sweeps;
      TT_PHASE(4)  // sweep: w and both solves
      // dZ = V w + conj, one entry per lane; the three norms by warp jmax.
      const float d = v1_us * pick(w1, ui) + 2.f * (v2r_us * pick(wr, ui) - v2i_us * pick(wi, ui));
      z_own = z_own + d;
      const float ad = fabsf(d);
      const float maxd = warp_jmax(upd_lane ? ad : 0.f);
      const float scaled = warp_jmax(upd_lane ? ad / tol_own : 0.f);
      const float zmag = warp_jmax(upd_lane ? fabsf(z_own) : 0.f);
      if (upd_lane) sh.z[us][ui] = z_own;
      __syncwarp();
      const float tol_eff = a.newton_tol + a.tol_eps * zmag;
      TT_PHASE(5)  // sweep: slope updates and the three warp maxima
      if (maxd < tol_eff || h_eff * scaled < a.kappa || is_nan(maxd)) {
        conv = true;
        break;
      }
    }

    // Step update (every lane, for the whole state) and the embedded3
    // error (one component per lane).
    float y_out[kNEq];
#pragma unroll
    for (int i = 0; i < kNEq; ++i) {
      float yo = y[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) yo = yo + (h_eff * a.rb[j]) * sh.z[j][i];
      y_out[i] = yo;
    }
    float ec = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) ec = ec + (h_eff * a.re[j]) * sh.z[j][comp];
    const float tol = a.atol + a.rtol * jmax(fabsf(pick(y, comp)), fabsf(pick(y_out, comp)));
    const float err = warp_jmax(lane < kNEq ? fabsf(ec / tol) : 0.f);
    const bool newt_fail = a.reject_unconverged && !conv;
    const bool accept = err <= 1.f && !newt_fail;

    const float kh = h_eff - t_c;
    const float t1 = t + kh;
    if (accept && q < a.n_q && __ldg(a.qt + q) <= t1) {
      float qm[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) acc = acc + a.rw[j][m] * sh.z[j][comp];
        qm[m] = acc;
      }
      const float y_comp = pick(y, comp);
      float tq;
      while (q < a.n_q && (tq = __ldg(a.qt + q)) <= t1) {
        const float theta = (tq - t) / h_eff;
        const float th2 = theta * theta;
        const float poly = qm[0] * theta + qm[1] * th2 + qm[2] * th2 * theta;
        if (lane < kNEq) a.dense[((int64_t)q * kNEq + comp) * S + s] = y_comp + h_eff * poly;
        ++q;
      }
    }

    const float raw_fac = a.safety * powf(1.f / (err + 1e-16f), a.expo);
    const float fac_acc = jclip(raw_fac, a.min_scale, a.max_scale);
    float fac_rej = jclip(is_nan(raw_fac) ? a.nan_shrink : jmin(raw_fac, 1.f),
                          a.min_scale, a.max_scale);
    if (newt_fail) fac_rej = 0.5f;  // Newton failure says nothing about the error
    float h_new = h_eff * (accept ? fac_acc : fac_rej);
    if (a.h_freeze_hi > 1.f && accept && fac_acc >= 1.f && fac_acc <= a.h_freeze_hi)
      h_new = h_eff;

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
    ++n_fct;
    ++n_att;
    TT_PHASE(6)  // step update, error, dense output, controller
  }
  TT_PHASE_END

  const bool completed = t >= tf;
  if (lane < kNEq) a.y_final[comp * S + s] = completed ? pick(y, comp) : NAN;
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
__global__ void __launch_bounds__(kWarp) radau_kernel(const RadauArgs a) {
  __shared__ Shared sh;
  radau_system(a, blockIdx.x, sh);
}

}  // namespace tt

// ---- launch ----

extern "C" int tt_radau_args_size() { return (int)sizeof(tt::RadauArgs); }

// Enqueues B2 on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tt_radau_launch(const tt::RadauArgs* args, void* stream) {
  if (args->n_sys <= 0) return 0;
  tt::radau_kernel<<<(unsigned)args->n_sys, tt::kWarp, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

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
