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
// Layout: one thread per system, as in rk45.cu (SoA inputs, [Q,5,S] dense,
// a per-thread query cursor).  A system stops sweeping as soon as its own
// Newton iteration converges; the TPU kernel's masked sweeps leave a
// converged system's stage slopes unchanged, so the results agree.
//
// What bounds it on the H100: registers and latency.  A thread holds the
// two LU factors (real 5x5, complex 5x5 as two planes), their inverse
// diagonals, 15 stage slopes, the residual and the state -- about 150
// floats, so at the 255-register ceiling some of it spills to local memory
// (L1-resident).  The main path flags ~131 systems, i.e. 5 warps: the card
// is almost idle and the wall is the slowest system's attempt count times
// the latency of one attempt.  This first design does nothing clever about
// that: 32-thread blocks put each warp on its own SM (its own L1 for the
// spills), the Newton loop stays rolled so the code fits the instruction
// cache, and the tableau and eigen-constants come from the kernel's
// parameter space (passed from tableau.py, never retyped here).  Like
// rk45.cu it is compiled without FMA contraction.

#include "common.cuh"

namespace tt {

constexpr int kRadauBlock = 32;

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

// The two factors of (I - h A (x) J) in the eigenbasis of A^-1.
struct Factors {
  float mr[kNEq][kNEq], mr_inv[kNEq];    // gamma I - h J, unit-lower L + U
  float cre[kNEq][kNEq], cim[kNEq][kNEq];  // (alpha + beta i) I - h J
  float ci_re[kNEq], ci_im[kNEq];        // 1 / diag of the complex U

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

__device__ __forceinline__ void radau_system(const RadauArgs& a, int64_t s) {
  const int64_t S = a.n_sys;
  Model204 model;
  model.load(a.params, S, s, a.safe_pow);
  float y[kNEq];
#pragma unroll
  for (int i = 0; i < kNEq; ++i) y[i] = __ldg(a.y0 + i * S + s);
  const float t0 = a.t0, tf = a.tf;
  const int32_t n_forc = a.forcing.n_forc;

  int q = 0;
  for (int qi = 0; qi < a.n_q; ++qi) {
    const bool pre = a.fill_t0_queries && __ldg(a.qt + qi) <= t0;
#pragma unroll
    for (int i = 0; i < kNEq; ++i)
      a.dense[((int64_t)qi * kNEq + i) * S + s] = pre ? y[i] : 0.f;
  }
  while (q < a.n_q && __ldg(a.qt + q) <= t0) ++q;

  float t = t0, t_c = 0.f, h = __ldg(a.h0 + s);
  int32_t reject = 0, failed = 0, n_acc = 0, n_rej = 0, n_att = 0, n_swp = 0;
  int32_t n_fct = 0;

  while (t < tf && !failed && n_att < a.max_steps) {
    float h_eff = t + h > tf ? tf - t : h;
    if (a.forcing.align) h_eff = zoh_step_cap(a.forcing, t, h_eff);
    float f[kMaxForcings];
    gather_forcings(a.forc, S, s, a.forcing, t, f);
    float f0[kNEq];
    model.rhs(y, f, n_forc, f0);

    // Forward-difference Jacobian, column by column, straight into both
    // factors; then the two unpivoted Doolittle LUs.
    Factors fa;
#pragma unroll
    for (int j = 0; j < kNEq; ++j) {
      const float h_eps = a.fd_eps * jmax(1.f, fabsf(y[j]));
      float yp[kNEq], fp[kNEq];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) yp[i] = i == j ? y[i] + h_eps : y[i];
      model.rhs(yp, f, n_forc, fp);
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        const float jac = (fp[i] - f0[i]) / h_eps;
        fa.mr[i][j] = i == j ? a.gam - h_eff * jac : (-h_eff) * jac;
        fa.cre[i][j] = i == j ? a.alp - h_eff * jac : (-h_eff) * jac;
        fa.cim[i][j] = i == j ? a.bet : 0.f;
      }
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

    // Simplified Newton on the stage slopes Z, started at f(t, y).
    float z[3][kNEq], tol_y[kNEq];
#pragma unroll
    for (int i = 0; i < kNEq; ++i) {
      z[0][i] = z[1][i] = z[2][i] = f0[i];
      tol_y[i] = a.atol + a.rtol * fabsf(y[i]);
    }
    bool conv = false;
    int32_t sweeps = 0;
#pragma unroll 1
    for (int it = 0; it < a.newton_max_iter; ++it) {
      float bvec[3][kNEq];
#pragma unroll
      for (int st = 0; st < 3; ++st) {
        float ys[kNEq], fs[kNEq];
#pragma unroll
        for (int i = 0; i < kNEq; ++i) ys[i] = y[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float hw = h_eff * a.ra[st][j];
#pragma unroll
          for (int i = 0; i < kNEq; ++i) ys[i] = ys[i] + hw * z[j][i];
        }
        model.rhs(ys, f, n_forc, fs);
#pragma unroll
        for (int i = 0; i < kNEq; ++i) bvec[st][i] = fs[i] - z[st][i];
      }
      // u = (P (x) I) b; one real and one complex solve; dZ = V w + conj.
      float w1[kNEq], wr[kNEq], wi[kNEq];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        w1[i] = a.p1[0] * bvec[0][i] + a.p1[1] * bvec[1][i] + a.p1[2] * bvec[2][i];
        wr[i] = a.p2r[0] * bvec[0][i] + a.p2r[1] * bvec[1][i] + a.p2r[2] * bvec[2][i];
        wi[i] = a.p2i[0] * bvec[0][i] + a.p2i[1] * bvec[1][i] + a.p2i[2] * bvec[2][i];
      }
      fa.real_solve(w1);
      fa.cplx_solve(wr, wi);
      ++sweeps;
      float maxd = 0.f, zmag = 0.f, scaled = 0.f;
#pragma unroll
      for (int st = 0; st < 3; ++st) {
#pragma unroll
        for (int i = 0; i < kNEq; ++i) {
          const float d = a.v1[st] * w1[i] + 2.f * (a.v2r[st] * wr[i] - a.v2i[st] * wi[i]);
          z[st][i] = z[st][i] + d;
          const float ad = fabsf(d);
          maxd = jmax(maxd, ad);
          scaled = jmax(scaled, ad / tol_y[i]);
          zmag = jmax(zmag, fabsf(z[st][i]));
        }
      }
      const float tol_eff = a.newton_tol + a.tol_eps * zmag;
      if (maxd < tol_eff || h_eff * scaled < a.kappa || is_nan(maxd)) {
        conv = true;
        break;
      }
    }

    // Step update and embedded3 error.
    float y_out[kNEq];
    float err = 0.f;
#pragma unroll
    for (int i = 0; i < kNEq; ++i) {
      float yo = y[i], ec = 0.f;
#pragma unroll
      for (int st = 0; st < 3; ++st) yo = yo + (h_eff * a.rb[st]) * z[st][i];
#pragma unroll
      for (int st = 0; st < 3; ++st) ec = ec + (h_eff * a.re[st]) * z[st][i];
      y_out[i] = yo;
      const float tol = a.atol + a.rtol * jmax(fabsf(y[i]), fabsf(yo));
      err = jmax(err, fabsf(ec / tol));
    }
    const bool newt_fail = a.reject_unconverged && !conv;
    const bool accept = err <= 1.f && !newt_fail;

    const float kh = h_eff - t_c;
    const float t1 = t + kh;
    if (accept && q < a.n_q && __ldg(a.qt + q) <= t1) {
      float qm[3][kNEq];
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int i = 0; i < kNEq; ++i) {
          float acc = 0.f;
#pragma unroll
          for (int st = 0; st < 3; ++st) acc = acc + a.rw[st][m] * z[st][i];
          qm[m][i] = acc;
        }
      float tq;
      while (q < a.n_q && (tq = __ldg(a.qt + q)) <= t1) {
        const float theta = (tq - t) / h_eff;
        const float th2 = theta * theta;
#pragma unroll
        for (int i = 0; i < kNEq; ++i) {
          const float poly = qm[0][i] * theta + qm[1][i] * th2 + qm[2][i] * th2 * theta;
          a.dense[((int64_t)q * kNEq + i) * S + s] = y[i] + h_eff * poly;
        }
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
  }

  const bool completed = t >= tf;
#pragma unroll
  for (int i = 0; i < kNEq; ++i) a.y_final[i * S + s] = completed ? y[i] : NAN;
  a.failed[s] = (failed || !completed) ? 1 : 0;
  a.stats[s] = n_acc;
  a.stats[S + s] = n_rej;
  a.stats[2 * S + s] = n_att;
  a.stats[3 * S + s] = n_swp;
  a.stats[4 * S + s] = n_fct;
}

__global__ void __launch_bounds__(kRadauBlock) radau_kernel(const RadauArgs a) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < a.n_sys) radau_system(a, s);
}

}  // namespace tt

// ---- launch ----

extern "C" int tt_radau_args_size() { return (int)sizeof(tt::RadauArgs); }

// Enqueues B2 on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tt_radau_launch(const tt::RadauArgs* args, void* stream) {
  if (args->n_sys <= 0) return 0;
  const int64_t blocks = (args->n_sys + tt::kRadauBlock - 1) / tt::kRadauBlock;
  tt::radau_kernel<<<(unsigned)blocks, tt::kRadauBlock, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
