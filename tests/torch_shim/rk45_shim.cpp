// CPU launcher of B1's kernel body for tests/test_torch_shim.py.  The test
// writes everything above the launch section of csrc/rk45.cu into
// rk45_body.h and builds this file with g++ against the stand-in
// cuda_runtime.h beside it.  Two entry points with the kernel library's
// interface: tt_rk45_launch runs rk45_kernel, TT_SHIM_BLOCKS blocks of
// kThreads std::threads each, one block after another; tt_rk45_serial runs
// each system alone from its start to its end through the same admit,
// attempt and finish functions, which is what the schedule must not change.
#include "rk45_body.h"

#include <thread>
#include <vector>

#ifndef TT_SHIM_BLOCKS
#define TT_SHIM_BLOCKS 2
#endif

namespace tt {
unsigned long long smem[(kPoolBytes + 7) / 8];
}

extern "C" int tt_rk45_args_size() { return (int)sizeof(tt::Rk45Args); }

extern "C" int tt_rk45_launch(const tt::Rk45Args* args, void*) {
  shim::grid_dim.x = TT_SHIM_BLOCKS;
  shim::block_dim.x = tt::kThreads;
  for (unsigned b = 0; b < TT_SHIM_BLOCKS; ++b) {
    std::barrier<> barrier(tt::kThreads);
    shim::block_barrier = &barrier;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < (unsigned)tt::kThreads; ++t)
      threads.emplace_back([=] {
        shim::thread_idx.x = t;
        shim::block_idx.x = b;
        tt::rk45_kernel(*args);
      });
    for (auto& th : threads) th.join();
  }
  return 0;
}

extern "C" int tt_rk45_serial(const tt::Rk45Args* args, void*) {
  const tt::Rk45Args& a = *args;
  for (int64_t s = 0; s < a.n_sys; ++s) {
    tt::Rk45State st;
    tt::Model204 model;
    float h0;
    tt::rk45_admit(a, s, st, h0);
    model.load(a.params, a.n_sys, s, a.safe_pow);
    while (tt::rk45_live(a, st)) tt::rk45_attempt(a, model, h0, s, st);
    tt::rk45_finish(a, s, st);
  }
  return 0;
}
