// CPU launcher of B1's kernel body for tests/test_torch_shim.py.  The test
// writes everything above the launch section of csrc/rk45.cu into
// rk45_body.h and builds this file with g++ against the stand-in
// cuda_runtime.h beside it.  Two entry points with the kernel library's
// interface: tt_rk45_launch runs rk45_kernel, TT_SHIM_BLOCKS blocks of
// kThreads std::threads each, one block after another; tt_rk45_serial runs
// each system alone from its start to its end through the same admit,
// attempt and finish functions, which is what the schedule must not change.
// Both run the instance of (args->model, f64, args->options), as the kernel
// library's launcher does; here every instance is in one translation unit.
#include "rk45_body.h"

#include <cstddef>
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

template <class T, class M>
int launch_model(const Rk45Args<T>& a) {
  constexpr int kLanes = kThreads<T, M>;
  shim::grid_dim.x = TT_SHIM_BLOCKS;
  shim::block_dim.x = kLanes;
  const bool known = rk45_dispatch<T>(a.options, [&](auto opt) {
    constexpr int OPT = decltype(opt)::value;
    for (unsigned b = 0; b < TT_SHIM_BLOCKS; ++b) {
      std::barrier<> barrier(kLanes);
      shim::block_barrier = &barrier;
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < (unsigned)kLanes; ++t)
        threads.emplace_back([=, &a] {
          shim::thread_idx.x = t;
          shim::block_idx.x = b;
          rk45_kernel<T, M, OPT>(a);
        });
      for (auto& th : threads) th.join();
    }
  });
  return known ? 0 : kNoInstance;
}

template <class T, class M>
int serial_model(const Rk45Args<T>& a) {
  const bool known = rk45_dispatch<T>(a.options, [&](auto opt) {
    constexpr int OPT = decltype(opt)::value;
    for (int64_t s = 0; s < a.n_sys; ++s) {
      Rk45State<T> st;
      M model;
      T h0;
      rk45_admit<T, M, OPT>(a, s, st, h0);
      model.load(a.params, a.n_sys, s, a.safe_pow, a.doy0);
      while (rk45_live(a, st)) rk45_attempt<T, M, OPT>(a, model, h0, s, st);
      rk45_finish(a, s, st);
    }
  });
  return known ? 0 : 1;
}

template <class T>
int launch_as(const Rk45Args<T>& a) {
  switch (a.model) {
    case kModel204: return launch_model<T, Model204<T>>(a);
    case kModel200: return launch_model<T, Model200<T>>(a);
    case kModelDummy: return launch_model<T, ModelDummy<T>>(a);
    default: return kNoInstance;
  }
}

template <class T>
int serial_as(const Rk45Args<T>& a) {
  switch (a.model) {
    case kModel204: return serial_model<T, Model204<T>>(a);
    case kModel200: return serial_model<T, Model200<T>>(a);
    case kModelDummy: return serial_model<T, ModelDummy<T>>(a);
    default: return kNoInstance;
  }
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

// The offsets of the fields options, model, t_shift, doy0, forcing,
// lockstep and forc_bf16, in that order, for the mirror test.
template <class A>
static void offsets_of(int64_t* out) {
  out[0] = offsetof(A, options);
  out[1] = offsetof(A, model);
  out[2] = offsetof(A, t_shift);
  out[3] = offsetof(A, doy0);
  out[4] = offsetof(A, forcing);
  out[5] = offsetof(A, lockstep);
  out[6] = offsetof(A, forc_bf16);
}

extern "C" void tt_rk45_args_offsets(int32_t f64, int64_t* out) {
  if (f64) {
    offsets_of<tt::Rk45Args<double>>(out);
  } else {
    offsets_of<tt::Rk45Args<float>>(out);
  }
}
