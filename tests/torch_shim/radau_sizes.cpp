// The size of B2's argument structs, for tests/test_torch_shim.py: the test
// writes everything above the launch section of csrc/radau.cu into
// radau_body.h and builds this file with g++ against the stand-in
// cuda_runtime.h beside it.  The warp intrinsics the body names are only
// declared: nothing here runs the kernel.
#include "cuda_runtime.h"

unsigned __reduce_max_sync(unsigned mask, unsigned value);
float __uint_as_float(unsigned x);
long long __double_as_longlong(double x);
double __longlong_as_double(long long x);
int __all_sync(unsigned mask, int pred);

#include "radau_body.h"

#include <cstddef>

// As in the kernel library, f64 picks the scalar: 0 float, 1 double.
extern "C" int tt_radau_args_size(int32_t f64) {
  return f64 ? (int)sizeof(tt::RadauArgs<double>) : (int)sizeof(tt::RadauArgs<float>);
}

// The offsets of the fields err_mode, model, t_shift, doy0, forcing,
// factor_reuse and reuse_hi, in that order, for the mirror test.
template <class A>
static void offsets_of(int64_t* out) {
  out[0] = offsetof(A, err_mode);
  out[1] = offsetof(A, model);
  out[2] = offsetof(A, t_shift);
  out[3] = offsetof(A, doy0);
  out[4] = offsetof(A, forcing);
  out[5] = offsetof(A, factor_reuse);
  out[6] = offsetof(A, reuse_hi);
}

extern "C" void tt_radau_args_offsets(int32_t f64, int64_t* out) {
  if (f64) {
    offsets_of<tt::RadauArgs<double>>(out);
  } else {
    offsets_of<tt::RadauArgs<float>>(out);
  }
}
