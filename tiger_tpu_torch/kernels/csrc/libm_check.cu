// Model 200's libm calls, one element a thread, for chip_smoke phase 12a,
// which holds each against torch's CUDA function of the same name on the
// same tensor.  Built with the flags of the Model 200 instances that call
// them (-fmad=false, relocatable code; _build.py), through the common.cuh
// overloads they call, so it computes what those instances compute.
#include "common.cuh"

namespace tt {

// csrc/common.cuh's libm call `fn` (kernels.libm.FUNCTIONS order) of x.
template <class T>
__device__ __forceinline__ T libm_eval(int fn, T x) {
  switch (fn) {
    case 0: return exp_t(x);
    case 1: return sin_t(x);
    case 2: return cos_t(x);
    case 3: return tan_t(x);
    case 4: return atan_t(x);
    case 5: return asin_t(x);
    case 6: return acos_t(x);
    default: return T(NAN);
  }
}
constexpr int kNLibm = 7;

template <class T>
__global__ void libm_kernel(int fn, const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = libm_eval(fn, x[i]);
}

template <class T>
int libm_launch(int32_t fn, const void* x, void* y, int64_t n, void* stream) {
  if (fn < 0 || fn >= kNLibm) return kNoInstance;
  if (n <= 0) return 0;
  libm_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      fn, static_cast<const T*>(x), static_cast<T*>(y), n);
  return (int)cudaGetLastError();
}

}  // namespace tt

// y[i] = libm call `fn` of x[i], float (f64 = 0) or double.
extern "C" int tt_libm_eval(int32_t fn, int32_t f64, const void* x, void* y, int64_t n,
                            void* stream) {
  return f64 ? tt::libm_launch<double>(fn, x, y, n, stream)
             : tt::libm_launch<float>(fn, x, y, n, stream);
}
