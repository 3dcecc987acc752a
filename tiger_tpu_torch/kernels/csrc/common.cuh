// Device code shared by the hand-written Hopper kernels rk45.cu and radau.cu.
//
// One CUDA thread computes one attempt of one system, so everything here is
// scalar per-thread code: the zero-order-hold forcing gather and the step cap at
// the next forcing-sample boundary (tiger_tpu/kernels/rk45_pallas.py,
// _gather_forcings l.185-211 and _zoh_step_cap l.214-225), NaN-propagating
// min/max with jnp.maximum/minimum semantics, and the Model-204 right-hand
// side (tiger_tpu/models/model204.py, rhs_tuple over derived_params).
//
// Every struct here is mirrored field by field by a ctypes.Structure in
// tiger_tpu_torch/kernels/_common.py; the launchers export sizeof() so the
// loader can refuse a mismatched build.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tt {

constexpr int kNEq = 5;          // Model 204 state size
constexpr int kMaxForcings = 4;  // forcing blocks a launch may carry

// Rows of the [15, S] parameter block, in tiger_tpu_torch.models.PARAM_FIELDS
// order (the wrappers stack the params dict in that order).
enum Param204 {
  kC1, kInfil, kPerco, kHu, kLat, kSw, kSs, kNMann, kSlope, kL, kAh,
  kAlpha3, kAlpha4, kMeltF, kTempThr, kNParam204
};

// Packed-forcing description (forcing.ForcingMeta) plus the step-cap table:
// the distinct (n_steps, dt) pairs in sorted order, as _zoh_step_cap loops.
struct ForcingMeta {
  int32_t n_forc;
  int32_t offset[kMaxForcings];
  int32_t n_steps[kMaxForcings];
  float dt[kMaxForcings];  // minutes per sample
  int32_t n_cap;
  int32_t cap_n_steps[kMaxForcings];
  float cap_dt[kMaxForcings];
  float snap;     // index snap of the gather and the step cap: ZOH_SNAP when aligned, else 0
  int32_t align;  // SolverConfig.forcing_step_align with forcings present
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN (fmaxf and
// fminf would drop it, and a NaN error norm must reject, not accept).  On
// the card each is the one instruction of that rule (max.NaN.f32 /
// min.NaN.f32, sm_80 and later); it returns the canonical NaN where the
// selects of a host build return the operand's, and like fmaxf/fminf it
// puts -0 below +0.
__device__ __forceinline__ float jmax(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
#endif
}
__device__ __forceinline__ float jmin(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
#endif
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

// ZOH gather at the step-start time t: index = trunc(t/dt + snap) clamped
// to the record (rk45_pallas.py:202 truncates with astype(int32)).
__device__ __forceinline__ void gather_forcings(
    const float* __restrict__ forc, int64_t n_sys, int64_t s,
    const ForcingMeta& m, float t, float (&f)[kMaxForcings]) {
#pragma unroll
  for (int j = 0; j < kMaxForcings; ++j) {
    f[j] = 0.f;
    if (j < m.n_forc) {
      int idx = (int)(t / m.dt[j] + m.snap);
      idx = min(max(idx, 0), m.n_steps[j] - 1);
      f[j] = __ldg(forc + (int64_t)(m.offset[j] + idx) * n_sys + s);
    }
  }
}

// Clamp h so the step from t lands on (never across) the next sample
// boundary; no boundary past a record's last sample.  Called only when
// m.align is set, so m.snap is forcing.ZOH_SNAP here.
__device__ __forceinline__ float zoh_step_cap(const ForcingMeta& m, float t,
                                              float h) {
#pragma unroll
  for (int j = 0; j < kMaxForcings; ++j) {
    if (j < m.n_cap) {
      const float dt = m.cap_dt[j];
      const float k = floorf(t / dt + m.snap);
      float nb = (k + 1.f) * dt - t;
      if (k + 1.f >= (float)m.cap_n_steps[j]) nb = INFINITY;
      h = jmin(h, nb);
    }
  }
  return h;
}

// Model 204 over derived parameters (model204.py derived_params/rhs_tuple).
struct Model204 {
  float temp_thr, melt_f, hu, inv_hu, infil, manning_c, perco, inv_a3, inv_a4;
  int32_t safe_pow;

  __device__ __forceinline__ void load(const float* __restrict__ p,
                                       int64_t n_sys, int64_t s, int32_t safe) {
    auto at = [&](int k) { return __ldg(p + (int64_t)k * n_sys + s); };
    temp_thr = at(kTempThr);
    melt_f = at(kMeltF);
    hu = at(kHu);
    infil = at(kInfil);
    perco = at(kPerco);
    manning_c = sqrtf(at(kSlope)) / at(kNMann) * (at(kL) / at(kAh) * 60.f);
    inv_hu = 1.f / hu;
    const float a3 = at(kAlpha3), a4 = at(kAlpha4);
    inv_a3 = a3 >= 1.f ? 1.f / a3 : 0.f;
    inv_a4 = a4 >= 1.f ? 1.f / a4 : 0.f;
    safe_pow = safe;
  }

  __device__ __forceinline__ void rhs(const float (&y)[kNEq],
                                      const float (&f)[kMaxForcings],
                                      int32_t n_forc, float (&dy)[kNEq]) const {
    const float two_thirds = (float)(2.0 / 3.0);
    const float rain = n_forc > 0 ? f[0] : 0.f;
    const float temp = n_forc > 1 ? f[1] : 0.f;
    // 1) Snow
    const float snowmelt = temp >= temp_thr ? jmin(y[0], temp * melt_f) : 0.f;
    const float x1 = rain + snowmelt;
    dy[0] = rain - snowmelt;
    // 2) Static store
    const float x2 = jmax(0.f, x1 + y[1] - hu);
    const float d1 = x1 - x2;
    const float e_max = jmin(0.1f * temp, y[1]);
    dy[1] = d1 - (y[1] * inv_hu) * e_max;
    // 3) Surface store (Manning); _pow23 is exp2/log2, not pow
    const float x3 = jmin(x2, infil);
    const float d2 = x2 - x3;
    const float p23 =
        safe_pow ? exp2f(two_thirds * log2f(jmax(jmax(y[2], 0.f), 1e-30f)))
                 : powf(y[2], two_thirds);  // NaN for y[2] < 0, like pow
    const float w = jmin(1.f, p23 * manning_c);
    dy[2] = d2 - y[2] * w;
    // 4) Gravitational store and aquifer
    const float x4 = jmin(x3, perco);
    const float d3 = x3 - x4;
    dy[3] = d3 - y[3] * inv_a3;
    dy[4] = x4 - y[4] * inv_a4;
  }
};

}  // namespace tt
