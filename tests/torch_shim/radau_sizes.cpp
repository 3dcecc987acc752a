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

// As in the kernel library, f64 picks the scalar: 0 float, 1 double.
extern "C" int tt_radau_args_size(int32_t f64) {
  return f64 ? (int)sizeof(tt::RadauArgs<double>) : (int)sizeof(tt::RadauArgs<float>);
}
