// A stand-in for <cuda_runtime.h> that lets g++ compile the body of
// tiger_tpu_torch/kernels/csrc/rk45.cu (everything above its launch
// section) for the CPU: one std::thread plays one CUDA thread, a
// std::barrier plays __syncthreads, and the blocks of a launch run one
// after another (rk45_shim.cpp).  Only what that kernel uses is here.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <barrier>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
// `extern __shared__ T smem[]` becomes a plain extern array, which the
// launcher defines once: blocks run one at a time, so one buffer serves.
#define __shared__

using std::max;
using std::min;

namespace shim {
struct Dim3 {
  unsigned x = 0;
};
inline thread_local Dim3 thread_idx, block_idx;
inline Dim3 block_dim, grid_dim;
inline std::barrier<>* block_barrier = nullptr;
inline std::atomic<int> vote{0};
}  // namespace shim

#define threadIdx shim::thread_idx
#define blockIdx shim::block_idx
#define blockDim shim::block_dim
#define gridDim shim::grid_dim

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
}
inline void __syncthreads() { shim::block_barrier->arrive_and_wait(); }
// The rehearsal's blocks are smaller than a warp, so the warp is the block.
inline void __syncwarp() { __syncthreads(); }
inline int __syncthreads_count(int pred) {
  if (pred) shim::vote.fetch_add(1);
  __syncthreads();
  const int n = shim::vote.load();
  __syncthreads();
  if (threadIdx.x == 0) shim::vote.store(0);
  __syncthreads();
  return n;
}
inline int __syncthreads_or(int pred) { return __syncthreads_count(pred) != 0; }
// On the block's counter in shared memory.
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
