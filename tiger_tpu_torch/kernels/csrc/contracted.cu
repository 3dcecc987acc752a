// The one libm function the double instances must round as torch does, built
// apart from the kernels with nvcc's default FMA contraction.
//
// The kernels are compiled with -fmad=false so that their own arithmetic
// rounds as the plain versions' separate torch ops do.  That flag also
// reaches the libm code nvcc inlines into them, and double pow's inner
// sums then round otherwise than in torch's CUDA pow kernel, which is built
// with contraction: ~2 in a million pow(x, 0.2) and pow(x, 2/3) differ by an
// ulp (exp2, log2, sqrt and the divisions agree either way, as do the float
// functions).  An ulp in the step controller's factor moves a system's
// later steps by rounding.  So double pow is this function, compiled without
// -fmad=false and device-linked with the double instances, which are built
// as relocatable device code (_build.py); common.cuh's pow_t calls it.  The
// float instances are built as they always were and never call it.
#include <cuda_runtime.h>
#include <math.h>

namespace tt {

__device__ double pow_contracted(double x, double y) { return pow(x, y); }

}  // namespace tt
