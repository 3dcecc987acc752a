// Device code shared by the hand-written Hopper kernels rk45.cu and radau.cu.
//
// One CUDA thread computes one attempt of one system, so everything here is
// scalar per-thread code: the zero-order-hold forcing gather and the step cap at
// the next forcing-sample boundary (tiger_tpu/kernels/rk45_pallas.py,
// _gather_forcings l.185-211 and _zoh_step_cap l.214-225), NaN-propagating
// min/max with jnp.maximum/minimum semantics, and the right-hand sides of the
// models the kernels carry: Model 204 (tiger_tpu/models/model204.py),
// Model 200 (model200.py, with Hamon PET and the ET ramp of et.py), each
// rhs_tuple over derived_params, and DummyModel (dummy.py, the reference's
// 5-state linear test system).  A kernel is a template over its model, and
// the model's rhs takes the time of the evaluation with the window's shift
// already added (rk45_pallas.py:273-277); Model 204 and DummyModel ignore it.
// Each is a template over the scalar T of the solve, float or double: the
// double instances repeat the float ones' operations in double, as the plain
// versions do for a float64 tensor (constants written T(x) are the plain
// versions' Python numbers, rounded to T; the float32 forcing data widened).
//
// Every struct here is mirrored field by field by a ctypes.Structure in
// tiger_tpu_torch/kernels/_common.py; the launchers export sizeof() so the
// loader can refuse a mismatched build.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tt {

constexpr int kNEq = 5;          // state size of both models
constexpr int kMaxForcings = 4;  // forcing blocks a launch may carry
constexpr int kNoInstance = -1;  // a launcher's code for an option set without an instance

// The models the kernels carry (Rk45Args/RadauArgs.model;
// kernels._common.KERNEL_MODELS).  Each model's instances are built in
// translation units of their own (_build.py): TT_INSTANCE_TU marks every
// build of a kernel source but the first, which holds Model 204's float
// instances and the C entry points.
enum KernelModel : int32_t { kModel204 = 0, kModel200 = 1, kModelDummy = 2 };
#if defined(TT_DOUBLE_INSTANCES) || defined(TT_MODEL_200) || defined(TT_MODEL_DUMMY)
#define TT_INSTANCE_TU 1
#endif

// Rows of the [15, S] parameter block, in tiger_tpu_torch.models.PARAM_FIELDS
// order (the wrappers stack the params dict in that order).
enum Param204 {
  kC1, kInfil, kPerco, kHu, kLat, kSw, kSs, kNMann, kSlope, kL, kAh,
  kAlpha3, kAlpha4, kMeltF, kTempThr, kNParam204
};

// Packed-forcing description (forcing.ForcingMeta) plus the step-cap table:
// the distinct (n_steps, dt) pairs in sorted order, as _zoh_step_cap loops.
// Its times are in the solve's scalar: the plain versions divide a float64
// t by dt as a float64 tensor and add ZOH_SNAP as a double.
template <class T>
struct ForcingMeta {
  int32_t n_forc;
  int32_t offset[kMaxForcings];
  int32_t n_steps[kMaxForcings];
  T dt[kMaxForcings];  // minutes per sample
  int32_t n_cap;
  int32_t cap_n_steps[kMaxForcings];
  T cap_dt[kMaxForcings];
  T snap;         // index snap of the gather and the step cap: ZOH_SNAP when aligned, else 0
  int32_t align;  // SolverConfig.forcing_step_align with forcings present
};

template <class T>
__device__ __forceinline__ bool is_nan(T x) { return x != x; }

// The libm calls of the kernels, by scalar: the float instances keep the
// f-suffixed functions, the double ones take the double functions, which
// are the ones torch's CUDA kernels call for a float64 tensor.
__device__ __forceinline__ float fabs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_t(double x) { return fabs(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float floor_t(float x) { return floorf(x); }
__device__ __forceinline__ double floor_t(double x) { return floor(x); }
__device__ __forceinline__ float exp2_t(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2_t(double x) { return exp2(x); }
__device__ __forceinline__ float log2_t(float x) { return log2f(x); }
__device__ __forceinline__ double log2_t(double x) { return log2(x); }
__device__ __forceinline__ float pow_t(float x, float y) { return powf(x, y); }
// Double pow on the card is contracted.cu's, built with FMA contraction as
// torch's CUDA pow is (the host branch serves CPU rehearsals of the code;
// -DTT_POW_INLINE, for profile_solve --f64-pow only, inlines libdevice's
// pow under -fmad=false to measure what the call costs).
#if defined(__CUDA_ARCH__) && !defined(TT_POW_INLINE)
__device__ double pow_contracted(double x, double y);
#endif
__device__ __forceinline__ double pow_t(double x, double y) {
#if defined(__CUDA_ARCH__) && !defined(TT_POW_INLINE)
  return pow_contracted(x, y);
#else
  return pow(x, y);
#endif
}

// Model 200's libm calls, in float and double: libdevice's functions,
// inlined under the kernels' -fmad=false.  Unlike double pow (above), each
// rounds as torch's CUDA function of the same name does: chip_smoke phase
// 12a holds every one against torch's element by element (16M inputs a
// function, built with the Model 200 instances' flags).
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }
__device__ __forceinline__ float tan_t(float x) { return tanf(x); }
__device__ __forceinline__ double tan_t(double x) { return tan(x); }
__device__ __forceinline__ float atan_t(float x) { return atanf(x); }
__device__ __forceinline__ double atan_t(double x) { return atan(x); }
__device__ __forceinline__ float asin_t(float x) { return asinf(x); }
__device__ __forceinline__ double asin_t(double x) { return asin(x); }
__device__ __forceinline__ float acos_t(float x) { return acosf(x); }
__device__ __forceinline__ double acos_t(double x) { return acos(x); }

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
// The PTX ISA has max.NaN and min.NaN for f32 (and f16/bf16) only, so the
// double forms are the selects of the host branch above; torch's CUDA
// maximum/minimum are the same selects (NaN in the first operand first).
__device__ __forceinline__ double jmax(double a, double b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmax(a, b));
}
__device__ __forceinline__ double jmin(double a, double b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmin(a, b));
}
template <class T>
__device__ __forceinline__ T jclip(T x, T lo, T hi) {
  return jmin(jmax(x, lo), hi);
}

// A forcing sample as float: float32 data as it is, bfloat16 data widened
// (exactly: a bfloat16 is a float32's upper half).
__device__ __forceinline__ float forcing_value(float x) { return x; }
__device__ __forceinline__ float forcing_value(__nv_bfloat16 x) { return __bfloat162float(x); }

// ZOH gather at the step-start time t: index = trunc(t/dt + snap) clamped
// to the record (rk45_pallas.py:202 truncates with astype(int32)).  The
// forcing data is float32 in every instance, or in B1's float instances
// its bfloat16 copy (SolverConfig.forcing_dtype='bf16', rk45_pallas.py
// l.207 widens at the gather); a double instance widens the float32 sample
// it reads, as the plain version's .to(float64) does.
template <class T, class D>
__device__ __forceinline__ void gather_forcings(
    const D* __restrict__ forc, int64_t n_sys, int64_t s,
    const ForcingMeta<T>& m, T t, T (&f)[kMaxForcings]) {
#pragma unroll
  for (int j = 0; j < kMaxForcings; ++j) {
    f[j] = T(0);
    if (j < m.n_forc) {
      int idx = (int)(t / m.dt[j] + m.snap);
      idx = min(max(idx, 0), m.n_steps[j] - 1);
      f[j] = (T)forcing_value(__ldg(forc + (int64_t)(m.offset[j] + idx) * n_sys + s));
    }
  }
}

// Clamp h so the step from t lands on (never across) the next sample
// boundary; no boundary past a record's last sample.  Called only when
// m.align is set, so m.snap is forcing.ZOH_SNAP here.
template <class T>
__device__ __forceinline__ T zoh_step_cap(const ForcingMeta<T>& m, T t, T h) {
#pragma unroll
  for (int j = 0; j < kMaxForcings; ++j) {
    if (j < m.n_cap) {
      const T dt = m.cap_dt[j];
      const T k = floor_t(t / dt + m.snap);
      T nb = (k + T(1)) * dt - t;
      if (k + T(1) >= (T)m.cap_n_steps[j]) nb = T(INFINITY);
      h = jmin(h, nb);
    }
  }
  return h;
}

// Model 204's stores over derived parameters (model204.py derived_params
// and rhs_tuple): snow, static, surface (Manning), gravitational and aquifer.
// The static store's ET is the model's own: `et(temperature, h_static)`.
template <class T>
struct Stores {
  T temp_thr, melt_f, hu, inv_hu, infil, manning_c, perco, inv_a3, inv_a4;
  int32_t safe_pow;

  __device__ __forceinline__ void load_stores(const T* __restrict__ p, int64_t n_sys, int64_t s,
                                              int32_t safe) {
    auto at = [&](int k) { return __ldg(p + (int64_t)k * n_sys + s); };
    temp_thr = at(kTempThr);
    melt_f = at(kMeltF);
    hu = at(kHu);
    infil = at(kInfil);
    perco = at(kPerco);
    manning_c = sqrt_t(at(kSlope)) / at(kNMann) * (at(kL) / at(kAh) * T(60));
    inv_hu = T(1) / hu;
    const T a3 = at(kAlpha3), a4 = at(kAlpha4);
    inv_a3 = a3 >= T(1) ? T(1) / a3 : T(0);
    inv_a4 = a4 >= T(1) ? T(1) / a4 : T(0);
    safe_pow = safe;
  }

  template <class Et>
  __device__ __forceinline__ void stores_rhs(const T (&y)[kNEq], const T (&f)[kMaxForcings],
                                             int32_t n_forc, T (&dy)[kNEq], Et&& et) const {
    const T two_thirds = T(2.0 / 3.0);
    const T rain = n_forc > 0 ? f[0] : T(0);
    const T temp = n_forc > 1 ? f[1] : T(0);
    // 1) Snow
    const T snowmelt = temp >= temp_thr ? jmin(y[0], temp * melt_f) : T(0);
    const T x1 = rain + snowmelt;
    dy[0] = rain - snowmelt;
    // 2) Static store
    const T x2 = jmax(T(0), x1 + y[1] - hu);
    const T d1 = x1 - x2;
    dy[1] = d1 - et(temp, y[1]);
    // 3) Surface store (Manning); _pow23 is exp2/log2, not pow
    const T x3 = jmin(x2, infil);
    const T d2 = x2 - x3;
    const T p23 =
        safe_pow ? exp2_t(two_thirds * log2_t(jmax(jmax(y[2], T(0)), T(1e-30))))
                 : pow_t(y[2], two_thirds);  // NaN for y[2] < 0, like pow
    const T w = jmin(T(1), p23 * manning_c);
    dy[2] = d2 - y[2] * w;
    // 4) Gravitational store and aquifer
    const T x4 = jmin(x3, perco);
    const T d3 = x3 - x4;
    dy[3] = d3 - y[3] * inv_a3;
    dy[4] = x4 - y[4] * inv_a4;
  }
};

// Model 204: the linear ET stub s * min(0.1 T, h_static); t is not read.
template <class T>
struct Model204 : Stores<T> {
  static constexpr int32_t kId = kModel204;

  __device__ __forceinline__ void load(const T* __restrict__ p, int64_t n_sys, int64_t s,
                                       int32_t safe, T /*doy0*/) {
    this->load_stores(p, n_sys, s, safe);
  }

  __device__ __forceinline__ void rhs(T /*t*/, const T (&y)[kNEq], const T (&f)[kMaxForcings],
                                      int32_t n_forc, T (&dy)[kNEq]) const {
    this->stores_rhs(y, f, n_forc, dy, [&](T temp, T h_stat) {
      const T e_max = jmin(T(0.1) * temp, h_stat);
      return (h_stat * this->inv_hu) * e_max;
    });
  }
};

// Hamon potential ET [m/min] (et.py hamon_pet, exact trig; the Python
// numbers of tiger_tpu_torch/models/et.py, each rounded to T, in its order):
// temperature in degC, the latitude in degrees with its sine and cosine, and
// the day of year.
template <class T>
__device__ __forceinline__ T hamon_pet(T temp, T lat, T sin_lat, T cos_lat, T doy) {
  const T esat = T(6.108) * exp_t((T(17.26939) * temp) / (temp + T(237.3)));
  const T wt = T(216.7) * esat / (temp + T(273.3));
  const T theta = T(0.2163108) + T(2) * atan_t(T(0.9671396) * tan_t(T(0.00860) * (doy - T(186))));
  const T phi = asin_t(T(0.39795) * cos_t(theta));
  const T num = sin_lat * sin_t(phi) + T(0x1.dc8e2d2968a47p-7);  // et.SIN_REFRACTION
  const T den = cos_lat * cos_t(phi);
  const T arg = num / den;
  T d = (T(24) - T(24.0 / 3.141592653589793) * acos_t(arg)) * T(1.0 / 12.0);
  // acos out of [-1, 1]: polar day or night (et.py:58-65).
  const bool polar_day = (phi > T(0) && lat > T(0)) || (phi < T(0) && lat < T(0));
  if (fabs_t(arg) > T(1)) d = polar_day ? T(2) : T(0);
  const T pet = T(1.6169e-6) * d * d * wt * T(60) * T(1.0 / 1000.0);
  return temp > T(0) ? pet : T(0);
}

// Model 200 (model200.py): Hamon PET at doy = doy0 + t/1440 and the actual-ET
// ramp between sw and ss on s = h_static / Hu (et.py et_actual).
template <class T>
struct Model200 : Stores<T> {
  static constexpr int32_t kId = kModel200;
  T lat, sin_lat, cos_lat, sw, ss, doy0;

  __device__ __forceinline__ void load(const T* __restrict__ p, int64_t n_sys, int64_t s,
                                       int32_t safe, T day0) {
    this->load_stores(p, n_sys, s, safe);
    auto at = [&](int k) { return __ldg(p + (int64_t)k * n_sys + s); };
    lat = at(kLat);
    sw = at(kSw);
    ss = at(kSs);
    sin_lat = sin_t(lat * T(3.141592653589793 / 180.0));
    cos_lat = cos_t(lat * T(3.141592653589793 / 180.0));
    doy0 = day0;
  }

  __device__ __forceinline__ void rhs(T t, const T (&y)[kNEq], const T (&f)[kMaxForcings],
                                      int32_t n_forc, T (&dy)[kNEq]) const {
    const T doy = t * T(1.0 / 1440.0) + doy0;
    this->stores_rhs(y, f, n_forc, dy, [&](T temp, T h_stat) {
      const T pet = hamon_pet(temp, lat, sin_lat, cos_lat, doy);
      const T e_max = jmin(pet, h_stat);
      const T s = h_stat * this->inv_hu;
      const T ramp = e_max * (s - sw) / (ss - sw);
      return s > ss ? e_max : (s > sw ? ramp : T(0));
    });
  }
};

// DummyModel (dummy.py): five linear equations with constant coefficients.
// It reads no parameter row (the launch passes a null params pointer), no
// forcing and no time.  Each line is the Python expression's left-to-right
// order, every constant the Python number rounded to T, so the instances
// round as the plain versions' torch ops do (17 operations a rhs).
template <class T>
struct ModelDummy {
  static constexpr int32_t kId = kModelDummy;

  __device__ __forceinline__ void load(const T* __restrict__ /*p*/, int64_t /*n_sys*/,
                                       int64_t /*s*/, int32_t /*safe*/, T /*doy0*/) {}

  __device__ __forceinline__ void rhs(T /*t*/, const T (&y)[kNEq],
                                      const T (&/*f*/)[kMaxForcings], int32_t /*n_forc*/,
                                      T (&dy)[kNEq]) const {
    dy[0] = T(1.0) - T(0.5) * y[0];
    dy[1] = (((T(1.2) + T(0.5) * y[0]) - T(0.3) * y[1]) - T(0.4)) - T(0.6) * y[1];
    dy[2] = T(0.3) * y[1] - T(0.2);
    dy[3] = (T(0.6) * y[1] - T(0.4) * y[3]) - T(0.3);
    dy[4] = T(0.4) * y[3] - T(0.1);
  }
};

}  // namespace tt
