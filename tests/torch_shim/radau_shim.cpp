// CPU launcher of B2's warp body for tests/test_torch_shim.py.  The test
// writes everything above the launch section of csrc/radau.cu into
// radau_body.h and builds this file with g++ against the stand-in
// cuda_runtime.h beside it.  One system at a time runs on 32 std::threads,
// one a lane, and a std::barrier of 32 plays the warp: __syncwarp waits on
// it, and each warp reduction writes the lane's value into a slot, waits,
// reads all 32 slots, and waits again.  tt_radau_launch has the kernel
// library's interface and runs the instance of (args->model, f64,
// err_mode, predictor, factor_reuse), as the kernel library's launcher does.
#include "cuda_runtime.h"

#include <cmath>
#include <thread>
#include <vector>

namespace shim {
inline unsigned warp_slots[32];
inline int warp_votes[32];
}  // namespace shim

inline float __uint_as_float(unsigned x) {
  float f;
  memcpy(&f, &x, sizeof f);
  return f;
}
inline long long __double_as_longlong(double x) {
  long long u;
  memcpy(&u, &x, sizeof u);
  return u;
}
inline double __longlong_as_double(long long u) {
  double x;
  memcpy(&x, &u, sizeof x);
  return x;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  shim::warp_slots[threadIdx.x] = v;
  __syncwarp();
  unsigned m = 0;
  for (unsigned x : shim::warp_slots) m = x > m ? x : m;
  __syncwarp();
  return m;
}
inline int __all_sync(unsigned, int pred) {
  shim::warp_votes[threadIdx.x] = pred != 0;
  __syncwarp();
  int all = 1;
  for (int x : shim::warp_votes) all = all && x;
  __syncwarp();
  return all;
}
using std::isfinite;

#include "radau_body.h"

namespace tt {

template <class T, class M>
int launch_model(const RadauArgs<T>& a) {
  const bool known = radau_dispatch<T>(a.err_mode, a.predictor, a.factor_reuse,
                                       [&](auto err, auto pred, auto reuse) {
    constexpr bool kReuse = decltype(reuse)::value;
    for (int64_t s = 0; s < a.n_sys; ++s) {
      std::barrier<> warp(kWarp);
      shim::block_barrier = &warp;
      std::conditional_t<kReuse, SharedReuse<T>, Shared<T>> sh;
      std::vector<std::thread> lanes;
      for (unsigned lane = 0; lane < (unsigned)kWarp; ++lane)
        lanes.emplace_back([=, &a, &sh] {
          shim::thread_idx.x = lane;
          radau_system<T, M, decltype(err)::value, decltype(pred)::value, kReuse>(a, s, sh);
        });
      for (auto& th : lanes) th.join();
    }
  });
  return known ? 0 : kNoInstance;
}

template <class T>
int launch_as(const RadauArgs<T>& a) {
  switch (a.model) {
    case kModel204: return launch_model<T, Model204<T>>(a);
    case kModel200: return launch_model<T, Model200<T>>(a);
    case kModelDummy: return launch_model<T, ModelDummy<T>>(a);
    default: return kNoInstance;
  }
}
}  // namespace tt

// As in the kernel library, f64 picks the scalar: 0 float, 1 double.
extern "C" int tt_radau_args_size(int32_t f64) {
  return f64 ? (int)sizeof(tt::RadauArgs<double>) : (int)sizeof(tt::RadauArgs<float>);
}

extern "C" int tt_radau_launch(const void* args, int32_t f64, void*) {
  return f64 ? tt::launch_as(*static_cast<const tt::RadauArgs<double>*>(args))
             : tt::launch_as(*static_cast<const tt::RadauArgs<float>*>(args));
}
