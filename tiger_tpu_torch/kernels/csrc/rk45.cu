// B1: fused adaptive Dormand-Prince 5(4) over every system, float32.
//
// Replaces the TPU kernel tiger_tpu/kernels/rk45_pallas.py: _make_kernel's
// inner `kernel` (l.243-866), launched by pl.pallas_call in
// _pallas_pipeline (l.1051).  Same per-system semantics with the default
// options (no FSAL, no Kahan-compensated y, I controller): ZOH forcing frozen
// at step start, the step capped at the tf landing and then at the next
// forcing boundary, seven stages, the inf-norm embedded error, the
// slope-jump guard, the I controller with NaN shrink, Kahan-compensated t,
// the stiffness criteria (reject streak, h-floor streak, Hairer's |h*lambda|
// test every stiff_test_every accepted steps), quartic dense output into
// the queries in (t, t + h], and per-system counters.
//
// Layout: the original CUDA code's (rk45_kernel.cu:17-176), one thread per
// system.  Inputs are SoA with the system index innermost ([5,S] states,
// [15,S] params, [T,S] forcing) so a warp reads 32 neighbouring words; dense
// output is written as [Q,5,S] for the same reason.  Each thread walks its
// own query cursor, which the VMEM-resident TPU kernel could not express
// (it swept the tile's union query window instead).
//
// What bounds it on the H100: per-thread latency and occupancy.  Each
// attempt is a dependent chain of seven RHS evaluations with 35 stage
// values live in registers, a handful of loads (forcing samples) and almost
// no stores; the work is ~1 kFLOP per attempt against ~20 bytes of
// traffic, far from either roofline, and a warp runs as long as its slowest
// system.  This first design keeps all state in registers (no shared
// memory, no spills expected), launches 128-thread blocks so the 1,024
// blocks of the 131,072-system main path spread over all 132 SMs, and
// reads the Butcher tableau from the kernel's parameter space (passed from
// tableau.py, never retyped here).  It is compiled without FMA contraction
// (_build.py), so each operation rounds as the plain version's torch ops do
// and a system takes the plain version's step sequence.

#include "common.cuh"

namespace tt {

constexpr int kRk45Block = 128;

struct Rk45Args {
  const float* y0;      // [5, S]
  const float* h0;      // [S] initial step (also the slope-cut floor base)
  const float* params;  // [15, S], PARAM_FIELDS order
  const float* forc;    // [T_total, S]; unused when forcing.n_forc == 0
  const float* qt;      // [Q] sorted, unique
  float* y_final;       // [5, S]; NaN where the system did not finish
  float* dense;         // [Q, 5, S]
  int32_t* stiff;       // [S]
  int32_t* failed;      // [S]
  int32_t* stats;       // [3, S]: accepted, rejected, attempted
  int64_t n_sys;
  int32_t n_q;
  int32_t safe_pow;
  float t0, tf, h_floor;
  float rtol, atol, safety, min_scale, max_scale, expo;
  float slope_jump_thresh, min_step_fraction, nan_shrink, stiff_hlamb;
  int32_t max_rejects, max_steps, stiff_detect, stiff_streak, stiff_forgive;
  int32_t stiff_test_every, stiff_floor_streak, fill_t0_queries;
  ForcingMeta forcing;
  float a[7][7], c[7], b[7], e[7], p[7][4];  // tableau.DP_*
};

__device__ __forceinline__ void rk45_system(const Rk45Args& a, int64_t s) {
  const int64_t S = a.n_sys;
  Model204 model;
  model.load(a.params, S, s, a.safe_pow);
  float y[kNEq];
#pragma unroll
  for (int i = 0; i < kNEq; ++i) y[i] = __ldg(a.y0 + i * S + s);
  const float h0 = __ldg(a.h0 + s);
  const float t0 = a.t0, tf = a.tf;

  // Dense rows with qt <= t0 start as y0 (fill_t0_queries), the rest as 0;
  // the cursor q is the first query strictly past t.
  int q = 0;
  for (int qi = 0; qi < a.n_q; ++qi) {
    const bool pre = a.fill_t0_queries && __ldg(a.qt + qi) <= t0;
#pragma unroll
    for (int i = 0; i < kNEq; ++i)
      a.dense[((int64_t)qi * kNEq + i) * S + s] = pre ? y[i] : 0.f;
  }
  while (q < a.n_q && __ldg(a.qt + q) <= t0) ++q;

  float t = t0, t_c = 0.f, h = h0;
  int32_t reject = 0, stiff = 0, iasti = 0, nonsti = 0, fstreak = 0;
  int32_t n_acc = 0, n_rej = 0, n_att = 0;

  while (t < tf && !stiff && n_att < a.max_steps) {
    const bool clamp = t + h > tf;
    float h_eff = clamp ? tf - t : h;
    if (a.forcing.align) h_eff = zoh_step_cap(a.forcing, t, h_eff);
    float f[kMaxForcings];
    gather_forcings(a.forc, S, s, a.forcing, t, f);

    // Seven stages; forcing frozen at step start for all of them.
    float k[7][kNEq], g6[kNEq];
    model.rhs(y, f, a.forcing.n_forc, k[0]);
#pragma unroll
    for (int st = 1; st < 7; ++st) {
      float acc[kNEq];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) acc[i] = y[i];
#pragma unroll
      for (int j = 0; j < st; ++j) {
        if (a.a[st][j] != 0.f) {
          const float hw = h_eff * a.a[st][j];
#pragma unroll
          for (int i = 0; i < kNEq; ++i) acc[i] = acc[i] + hw * k[j][i];
        }
      }
      if (st == 5) {
#pragma unroll
        for (int i = 0; i < kNEq; ++i) g6[i] = acc[i];
      }
      model.rhs(acc, f, a.forcing.n_forc, k[st]);
    }

    // 5th-order update and embedded error, in the TPU kernel's order.
    float y_out[kNEq], err_c[kNEq];
#pragma unroll
    for (int i = 0; i < kNEq; ++i) {
      y_out[i] = y[i];
      err_c[i] = 0.f;
    }
#pragma unroll
    for (int st = 0; st < 7; ++st) {
      if (a.b[st] != 0.f) {
        const float hw = h_eff * a.b[st];
#pragma unroll
        for (int i = 0; i < kNEq; ++i) y_out[i] = y_out[i] + hw * k[st][i];
      }
      if (a.e[st] != 0.f) {
        const float hw = h_eff * a.e[st];
#pragma unroll
        for (int i = 0; i < kNEq; ++i) err_c[i] = err_c[i] + hw * k[st][i];
      }
    }
    float err = 0.f, jump_mag = 0.f;
#pragma unroll
    for (int i = 0; i < kNEq; ++i) {
      const float tol = a.atol + a.rtol * jmax(fabsf(y[i]), fabsf(y_out[i]));
      err = jmax(err, fabsf(err_c[i] / tol));
      jump_mag = jmax(jump_mag, fabsf(k[0][i] - k[1][i]));
    }
    const bool accept = err <= 1.f;  // NaN rejects
    const bool jump = jump_mag > a.slope_jump_thresh;
    const bool advance = accept && !jump;
    const bool slope = accept && jump;

    // Kahan-compensated commit time; also the dense window's upper bound.
    const float kh = h_eff - t_c;
    const float t1 = t + kh;

    if (advance && q < a.n_q && __ldg(a.qt + q) <= t1) {
      float qm[4][kNEq];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int i = 0; i < kNEq; ++i) qm[m][i] = 0.f;
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          if (a.p[j][m] != 0.f) {
#pragma unroll
            for (int i = 0; i < kNEq; ++i) qm[m][i] = qm[m][i] + a.p[j][m] * k[j][i];
          }
        }
      }
      float tq;
      while (q < a.n_q && (tq = __ldg(a.qt + q)) <= t1) {
        const float theta = (tq - t) / h_eff;
        const float th2 = theta * theta;
#pragma unroll
        for (int i = 0; i < kNEq; ++i) {
          const float poly = qm[0][i] * theta + qm[1][i] * th2 +
                             qm[2][i] * th2 * theta + qm[3][i] * th2 * th2;
          a.dense[((int64_t)q * kNEq + i) * S + s] = y[i] + h_eff * poly;
        }
        ++q;
      }
    }

    // I controller: clip on accept, capped at 1 (NaN -> nan_shrink) on reject.
    const float base_fac = a.safety * powf(1.f / (err + 1e-16f), a.expo);
    const float fac_acc = jclip(base_fac, a.min_scale, a.max_scale);
    const float fac_rej =
        jclip(is_nan(base_fac) ? a.nan_shrink : jmin(base_fac, 1.f), a.min_scale,
              a.max_scale);
    const float h_slope = jmax(h_eff * 0.5f, h0 * a.min_step_fraction);
    // A clamped landing step never shrinks the carried h.
    const float h_adv = clamp ? jmax(h_eff * fac_acc, h) : h_eff * fac_acc;
    const float h_new = advance ? h_adv : (slope ? h_slope : h_eff * fac_rej);
    const int32_t reject_new = accept ? 0 : reject + 1;

    bool stiff_new;
    if (a.stiff_detect) {
      fstreak = h_new < a.h_floor ? fstreak + 1 : 0;
      stiff_new = (!accept && reject_new > a.max_rejects) ||
                  fstreak >= a.stiff_floor_streak;
      // Hairer's |h*lambda| from the two t+h stages, tested every
      // stiff_test_every-th accepted step (post-increment count); slope
      // cuts trip without waiting for the cadence.
      float stnum = 0.f, stden = 0.f;
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        stnum = jmax(stnum, fabsf(k[6][i] - k[5][i]));
        stden = jmax(stden, fabsf(y_out[i] - g6[i]));
      }
      const float hlamb = stden > 0.f ? h_eff * stnum / stden : 0.f;
      const int32_t n_acc_next = n_acc + (advance ? 1 : 0);
      const bool tested = advance && (n_acc_next & (a.stiff_test_every - 1)) == 0;
      const bool over = hlamb > a.stiff_hlamb;
      const bool trip = slope || (tested && over);
      const bool calm = tested && !over;
      if (trip) {
        ++iasti;
        nonsti = 0;
      } else if (calm) {
        ++nonsti;
        if (nonsti >= a.stiff_forgive) iasti = 0;
      }
      stiff_new = stiff_new || iasti >= a.stiff_streak;
    } else {
      stiff_new = !accept && (reject_new > a.max_rejects || h_new < a.h_floor);
    }

    if (advance) {
      t_c = (t1 - t) - kh;
      t = t1;
#pragma unroll
      for (int i = 0; i < kNEq; ++i) y[i] = y_out[i];
    }
    stiff = stiff || stiff_new;
    h = h_new;
    reject = reject_new;
    n_acc += advance ? 1 : 0;
    n_rej += accept ? 0 : 1;
    ++n_att;
  }

  // Systems that did not reach tf report NaN; they go to the stiff phase
  // too, and count as failed only if no stiffness criterion tripped.
  const bool completed = t >= tf;
#pragma unroll
  for (int i = 0; i < kNEq; ++i) a.y_final[i * S + s] = completed ? y[i] : NAN;
  a.stiff[s] = (stiff || !completed) ? 1 : 0;
  a.failed[s] = (!completed && !stiff) ? 1 : 0;
  a.stats[s] = n_acc;
  a.stats[S + s] = n_rej;
  a.stats[2 * S + s] = n_att;
}

__global__ void __launch_bounds__(kRk45Block) rk45_kernel(const Rk45Args a) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < a.n_sys) rk45_system(a, s);
}

}  // namespace tt

// ---- launch ----

extern "C" int tt_rk45_args_size() { return (int)sizeof(tt::Rk45Args); }

// Enqueues B1 on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tt_rk45_launch(const tt::Rk45Args* args, void* stream) {
  if (args->n_sys <= 0) return 0;
  const int64_t blocks = (args->n_sys + tt::kRk45Block - 1) / tt::kRk45Block;
  tt::rk45_kernel<<<(unsigned)blocks, tt::kRk45Block, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
