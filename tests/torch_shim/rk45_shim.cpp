// CPU launcher of B1's kernel body for tests/test_torch_shim.py.  The test
// writes everything above the launch section of csrc/rk45.cu into
// rk45_body.h and builds this file with g++ against the stand-in
// cuda_runtime.h beside it.  Two entry points with the kernel library's
// interface: tt_rk45_launch runs rk45_kernel, TT_SHIM_BLOCKS blocks of
// kThreads std::threads each, one block after another; tt_rk45_serial runs
// each system alone from its start to its end through the same admit,
// attempt and finish functions, which is what the schedule must not change.
// Both run the instance of (f64, args->options), as the kernel library's
// launcher does.
#include "rk45_body.h"

#include <thread>
#include <vector>

#ifndef TT_SHIM_BLOCKS
#define TT_SHIM_BLOCKS 2
#endif

namespace tt {
// Large enough for every instance's pool.
unsigned long long smem[(std::max({Pool<float, kFsal | kPi>::kBytes, Pool<float, kComp | kPi>::kBytes,
                                   Pool<double, kFsal | kPi>::kBytes,
                                   Pool<double, kComp | kPi>::kBytes}) +
                         7) / 8];

template <class T>
int launch_as(const Rk45Args<T>& a) {
  shim::grid_dim.x = TT_SHIM_BLOCKS;
  shim::block_dim.x = kThreads<T>;
  const bool known = rk45_dispatch<T>(a.options, [&](auto opt) {
    constexpr int OPT = decltype(opt)::value;
    for (unsigned b = 0; b < TT_SHIM_BLOCKS; ++b) {
      std::barrier<> barrier(kThreads<T>);
      shim::block_barrier = &barrier;
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < (unsigned)kThreads<T>; ++t)
        threads.emplace_back([=, &a] {
          shim::thread_idx.x = t;
          shim::block_idx.x = b;
          rk45_kernel<T, OPT>(a);
        });
      for (auto& th : threads) th.join();
    }
  });
  return known ? 0 : kNoInstance;
}

template <class T>
int serial_as(const Rk45Args<T>& a) {
  const bool known = rk45_dispatch<T>(a.options, [&](auto opt) {
    constexpr int OPT = decltype(opt)::value;
    for (int64_t s = 0; s < a.n_sys; ++s) {
      Rk45State<T> st;
      Model204<T> model;
      T h0;
      rk45_admit<T, OPT>(a, s, st, h0);
      model.load(a.params, a.n_sys, s, a.safe_pow);
      while (rk45_live(a, st)) rk45_attempt<T, OPT>(a, model, h0, s, st);
      rk45_finish(a, s, st);
    }
  });
  return known ? 0 : 1;
}
}  // namespace tt

// As in the kernel library, f64 picks the scalar: 0 float, 1 double.
extern "C" int tt_rk45_args_size(int32_t f64) {
  return f64 ? (int)sizeof(tt::Rk45Args<double>) : (int)sizeof(tt::Rk45Args<float>);
}

extern "C" int tt_rk45_launch(const void* args, int32_t f64, void*) {
  return f64 ? tt::launch_as(*static_cast<const tt::Rk45Args<double>*>(args))
             : tt::launch_as(*static_cast<const tt::Rk45Args<float>*>(args));
}

extern "C" int tt_rk45_serial(const void* args, int32_t f64, void*) {
  return f64 ? tt::serial_as(*static_cast<const tt::Rk45Args<double>*>(args))
             : tt::serial_as(*static_cast<const tt::Rk45Args<float>*>(args));
}
