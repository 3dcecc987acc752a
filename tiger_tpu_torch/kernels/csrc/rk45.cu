// B1: fused adaptive Dormand-Prince 5(4) over every system, float32.
//
// Replaces the TPU kernel tiger_tpu/kernels/rk45_pallas.py: _make_kernel's
// inner `kernel` (l.243-866), launched by pl.pallas_call in
// _pallas_pipeline (l.1051).  Same per-system semantics with the default
// options (no FSAL, no Kahan-compensated y, I controller): ZOH forcing frozen
// at step start, the step capped at the tf landing and then at the next
// forcing boundary, seven stages, the inf-norm embedded error, the
// slope-jump guard, the I controller with NaN shrink, Kahan-compensated t,
// the stiffness criteria (reject streak, h-floor streak, Hairer's |h*lambda|
// test every stiff_test_every accepted steps), quartic dense output into
// the queries in (t, t + h], and per-system counters.
//
// What bounds it on the H100: neither rate of the card.  An attempt is a
// dependent chain of seven right-hand sides, ~700 operations against ~20
// bytes, and the systems need very different numbers of attempts (a few
// hundred to a few thousand).  With a lane tied to one system for that
// system's whole life, a warp runs as long as the slowest of its 32 (under
// half of the lanes a warp ran did work), and the blocks that start when the
// first ones end finish a whole longest chain later.  What remains once the
// schedule is fixed is the longest chain itself, one warp trip through the
// attempt loop after another, and what a trip costs: its instructions, and
// the other warps of a full SM (a third more than alone).
//
// What the design does about it: who runs which system is decided anew
// every time slice.
//   - One persistent block per SM, one wave.  Each block owns a contiguous
//     share of the systems and never talks to another block: no atomics, so
//     the schedule and the time repeat from launch to launch.
//   - A system's state between attempts (Rk45State, h0 and its index) lives
//     in a pool of slots in shared memory, SoA over the slots; its Model204
//     fields are derived again from the parameter block at every slice
//     (keeping them in the pool measured no faster).  Freed slots admit the
//     next systems of the share, so any number of systems runs through a
//     pool of fixed size.
//   - A slice: the block sorts its slots by t (a bitonic network over
//     64-bit keys: ordered t above, slot below; free slots last), the
//     kThreads live systems furthest behind in t are loaded into registers,
//     one a lane, packed into the fewest warps, and each runs up to kSlice
//     attempts.  It is then stored back, or, if it ended, written out as its
//     result and its slot freed.  Warps past the live count skip the slice,
//     so the drain of the longest chains costs scheduler slots only for what is
//     alive, and while every live system runs and none ends the order is
//     kept and the sort skipped.  "Furthest behind first" needs no knowledge
//     of the future: the longest chain runs in every slice from the first.
//   - Fewer instructions a trip: the Butcher tableau is the constexpr
//     header that _build.py writes from solver/tableau.py (never retyped
//     here), so its zero tests fold at compile time, and jmax/jmin are one
//     instruction each (common.cuh).
// The attempt itself (rk45_attempt) is scalar code of one thread for one
// system, every operation in the plain version's order, so no schedule
// changes any system's result.  Inputs stay
// SoA with the system index innermost ([5,S] states, [15,S] params, [T,S]
// forcing, [Q,5,S] dense); each system walks its own query cursor.  The file
// is compiled without FMA contraction (_build.py), so each operation rounds
// as the plain version's torch ops do and B1 equals rk45_plain bit for bit.
//
// Compile-time shape (all overridable with -D, for tests and measurements):
// TT_RK45_THREADS lanes a block, TT_RK45_POOL slots (a power of two),
// TT_RK45_SLICE attempts a slice.  -DTT_RK45_PHASES adds per-warp probes
// (python -m tiger_tpu_torch.rk45_phases).

#include "common.cuh"
#include "rk45_tableau.cuh"  // TT_DP_TABLEAU, written by _build.py

#ifndef TT_RK45_THREADS
#define TT_RK45_THREADS 512
#endif
#ifndef TT_RK45_POOL
#define TT_RK45_POOL 1024
#endif
#ifndef TT_RK45_SLICE
#define TT_RK45_SLICE 64
#endif

namespace tt {

constexpr int kThreads = TT_RK45_THREADS;
constexpr int kPool = TT_RK45_POOL;
constexpr int kSlice = TT_RK45_SLICE;
static_assert(kPool > 0 && (kPool & (kPool - 1)) == 0, "the bitonic sort needs a power of two");
static_assert(kThreads % 32 == 0 || kThreads < 32, "whole warps, or (in a CPU rehearsal) a part of one");

struct DpTableau {
  float a[7][7], c[7], b[7], e[7], p[7][4];  // tableau.DP_*
};

struct Rk45Args {
  const float* y0;      // [5, S]
  const float* h0;      // [S] initial step (also the slope-cut floor base)
  const float* params;  // [15, S], PARAM_FIELDS order
  const float* forc;    // [T_total, S]; unused when forcing.n_forc == 0
  const float* qt;      // [Q] sorted, unique
  float* y_final;       // [5, S]; NaN where the system did not finish
  float* dense;         // [Q, 5, S]
  int32_t* stiff;       // [S]
  int32_t* failed;      // [S]
  int32_t* stats;       // [3, S]: accepted, rejected, attempted
  int64_t n_sys;
  int32_t n_q;
  int32_t safe_pow;
  float t0, tf, h_floor;
  float rtol, atol, safety, min_scale, max_scale, expo;
  float slope_jump_thresh, min_step_fraction, nan_shrink, stiff_hlamb;
  int32_t max_rejects, max_steps, stiff_detect, stiff_streak, stiff_forgive;
  int32_t stiff_test_every, stiff_floor_streak, fill_t0_queries;
  ForcingMeta forcing;
};

// Everything a system carries from one attempt to the next.  With h0 it is
// also what a windowed solve would carry from one query window to the next
// (rk45_pallas.py:850-865 writes the same fields).
struct Rk45State {
  float y[kNEq], t, t_c, h;  // t_c: Kahan compensation of t
  int32_t reject, iasti, nonsti, fstreak;  // reject streak, detector counters, h-floor streak
  int32_t n_acc, n_rej, n_att;
  int32_t q;      // query cursor: the first query strictly past t
  int32_t stiff;  // a stiffness criterion tripped: the system ends
};

__device__ __forceinline__ bool rk45_live(const Rk45Args& a, const Rk45State& st) {
  return st.t < a.tf && !st.stiff && st.n_att < a.max_steps;
}

// Start of system s: state from y0 and h0, and the dense rows with
// qt <= t0 as y0 (fill_t0_queries), the rest as 0.
__device__ __forceinline__ void rk45_admit(const Rk45Args& a, int64_t s, Rk45State& st,
                                           float& h0) {
  const int64_t S = a.n_sys;
#pragma unroll
  for (int i = 0; i < kNEq; ++i) st.y[i] = __ldg(a.y0 + i * S + s);
  h0 = __ldg(a.h0 + s);
  for (int qi = 0; qi < a.n_q; ++qi) {
    const bool pre = a.fill_t0_queries && __ldg(a.qt + qi) <= a.t0;
#pragma unroll
    for (int i = 0; i < kNEq; ++i)
      a.dense[((int64_t)qi * kNEq + i) * S + s] = pre ? st.y[i] : 0.f;
  }
  st.q = 0;
  while (st.q < a.n_q && __ldg(a.qt + st.q) <= a.t0) ++st.q;
  st.t = a.t0;
  st.t_c = 0.f;
  st.h = h0;
  st.reject = st.iasti = st.nonsti = st.fstreak = 0;
  st.n_acc = st.n_rej = st.n_att = 0;
  st.stiff = 0;
}

// One attempt of system s.  Returns whether it filled dense rows.
__device__ __forceinline__ bool rk45_attempt(const Rk45Args& a, const Model204& model,
                                             const float h0, const int64_t s, Rk45State& st) {
  constexpr DpTableau tb = TT_DP_TABLEAU;
  const int64_t S = a.n_sys;
  const float t = st.t, h = st.h, tf = a.tf;
  float(&y)[kNEq] = st.y;

  const bool clamp = t + h > tf;
  float h_eff = clamp ? tf - t : h;
  if (a.forcing.align) h_eff = zoh_step_cap(a.forcing, t, h_eff);
  float f[kMaxForcings];
  gather_forcings(a.forc, S, s, a.forcing, t, f);

  // Seven stages; forcing frozen at step start for all of them.
  float k[7][kNEq], g6[kNEq];
  model.rhs(y, f, a.forcing.n_forc, k[0]);
#pragma unroll
  for (int sg = 1; sg < 7; ++sg) {
    float acc[kNEq];
#pragma unroll
    for (int i = 0; i < kNEq; ++i) acc[i] = y[i];
#pragma unroll
    for (int j = 0; j < sg; ++j) {
      if (tb.a[sg][j] != 0.f) {
        const float hw = h_eff * tb.a[sg][j];
#pragma unroll
        for (int i = 0; i < kNEq; ++i) acc[i] = acc[i] + hw * k[j][i];
      }
    }
    if (sg == 5) {
#pragma unroll
      for (int i = 0; i < kNEq; ++i) g6[i] = acc[i];
    }
    model.rhs(acc, f, a.forcing.n_forc, k[sg]);
  }

  // 5th-order update and embedded error, in the TPU kernel's order.
  float y_out[kNEq], err_c[kNEq];
#pragma unroll
  for (int i = 0; i < kNEq; ++i) {
    y_out[i] = y[i];
    err_c[i] = 0.f;
  }
#pragma unroll
  for (int sg = 0; sg < 7; ++sg) {
    if (tb.b[sg] != 0.f) {
      const float hw = h_eff * tb.b[sg];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) y_out[i] = y_out[i] + hw * k[sg][i];
    }
    if (tb.e[sg] != 0.f) {
      const float hw = h_eff * tb.e[sg];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) err_c[i] = err_c[i] + hw * k[sg][i];
    }
  }
  float err = 0.f, jump_mag = 0.f;
#pragma unroll
  for (int i = 0; i < kNEq; ++i) {
    const float tol = a.atol + a.rtol * jmax(fabsf(y[i]), fabsf(y_out[i]));
    err = jmax(err, fabsf(err_c[i] / tol));
    jump_mag = jmax(jump_mag, fabsf(k[0][i] - k[1][i]));
  }
  const bool accept = err <= 1.f;  // NaN rejects
  const bool jump = jump_mag > a.slope_jump_thresh;
  const bool advance = accept && !jump;
  const bool slope = accept && jump;

  // Kahan-compensated commit time; also the dense window's upper bound.
  const float kh = h_eff - st.t_c;
  const float t1 = t + kh;

  const bool fill = advance && st.q < a.n_q && __ldg(a.qt + st.q) <= t1;
  if (fill) {
    float qm[4][kNEq];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int i = 0; i < kNEq; ++i) qm[m][i] = 0.f;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        if (tb.p[j][m] != 0.f) {
#pragma unroll
          for (int i = 0; i < kNEq; ++i) qm[m][i] = qm[m][i] + tb.p[j][m] * k[j][i];
        }
      }
    }
    float tq;
    while (st.q < a.n_q && (tq = __ldg(a.qt + st.q)) <= t1) {
      const float theta = (tq - t) / h_eff;
      const float th2 = theta * theta;
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        const float poly = qm[0][i] * theta + qm[1][i] * th2 +
                           qm[2][i] * th2 * theta + qm[3][i] * th2 * th2;
        a.dense[((int64_t)st.q * kNEq + i) * S + s] = y[i] + h_eff * poly;
      }
      ++st.q;
    }
  }

  // I controller: clip on accept, capped at 1 (NaN -> nan_shrink) on reject.
  const float base_fac = a.safety * powf(1.f / (err + 1e-16f), a.expo);
  const float fac_acc = jclip(base_fac, a.min_scale, a.max_scale);
  const float fac_rej =
      jclip(is_nan(base_fac) ? a.nan_shrink : jmin(base_fac, 1.f), a.min_scale,
            a.max_scale);
  const float h_slope = jmax(h_eff * 0.5f, h0 * a.min_step_fraction);
  // A clamped landing step never shrinks the carried h.
  const float h_adv = clamp ? jmax(h_eff * fac_acc, h) : h_eff * fac_acc;
  const float h_new = advance ? h_adv : (slope ? h_slope : h_eff * fac_rej);
  const int32_t reject_new = accept ? 0 : st.reject + 1;

  bool stiff_new;
  if (a.stiff_detect) {
    st.fstreak = h_new < a.h_floor ? st.fstreak + 1 : 0;
    stiff_new = (!accept && reject_new > a.max_rejects) ||
                st.fstreak >= a.stiff_floor_streak;
    // Hairer's |h*lambda| from the two t+h stages, tested every
    // stiff_test_every-th accepted step (post-increment count); slope
    // cuts trip without waiting for the cadence.
    float stnum = 0.f, stden = 0.f;
#pragma unroll
    for (int i = 0; i < kNEq; ++i) {
      stnum = jmax(stnum, fabsf(k[6][i] - k[5][i]));
      stden = jmax(stden, fabsf(y_out[i] - g6[i]));
    }
    const float hlamb = stden > 0.f ? h_eff * stnum / stden : 0.f;
    const int32_t n_acc_next = st.n_acc + (advance ? 1 : 0);
    const bool tested = advance && (n_acc_next & (a.stiff_test_every - 1)) == 0;
    const bool over = hlamb > a.stiff_hlamb;
    const bool trip = slope || (tested && over);
    const bool calm = tested && !over;
    if (trip) {
      ++st.iasti;
      st.nonsti = 0;
    } else if (calm) {
      ++st.nonsti;
      if (st.nonsti >= a.stiff_forgive) st.iasti = 0;
    }
    stiff_new = stiff_new || st.iasti >= a.stiff_streak;
  } else {
    stiff_new = !accept && (reject_new > a.max_rejects || h_new < a.h_floor);
  }

  if (advance) {
    st.t_c = (t1 - t) - kh;
    st.t = t1;
#pragma unroll
    for (int i = 0; i < kNEq; ++i) y[i] = y_out[i];
  }
  st.stiff = st.stiff || stiff_new;
  st.h = h_new;
  st.reject = reject_new;
  st.n_acc += advance ? 1 : 0;
  st.n_rej += accept ? 0 : 1;
  ++st.n_att;
  return fill;
}

// The result of system s once it is no longer live.  Systems that did not
// reach tf report NaN; they go to the stiff phase too, and count as failed
// only if no stiffness criterion tripped.
__device__ __forceinline__ void rk45_finish(const Rk45Args& a, int64_t s, const Rk45State& st) {
  const int64_t S = a.n_sys;
  const bool completed = st.t >= a.tf;
#pragma unroll
  for (int i = 0; i < kNEq; ++i) a.y_final[i * S + s] = completed ? st.y[i] : NAN;
  a.stiff[s] = (st.stiff || !completed) ? 1 : 0;
  a.failed[s] = (!completed && !st.stiff) ? 1 : 0;
  a.stats[s] = st.n_acc;
  a.stats[S + s] = st.n_rej;
  a.stats[2 * S + s] = st.n_att;
}

// ---- the pool ----
// Rows of the pool's float and int blocks; slot i of row r is block[r * kPool + i].
enum PoolF { pY = 0, pT = kNEq, pTc, pH, pH0, kPoolFloats };
enum PoolI { pReject, pIasti, pNonsti, pFstreak, pNAcc, pNRej, pNAtt, pQ, pSys, kPoolInts };
constexpr size_t kPoolBytes = (size_t)kPool * (8 + 4 * (kPoolFloats + kPoolInts));
constexpr unsigned long long kFreeKey = 0xFFFFFFFFull;  // above every live t

struct Pool {
  unsigned long long* key;  // [kPool] sort keys; after the sort, the slots in run order
  float* f;                 // [kPoolFloats, kPool]
  int32_t* i;               // [kPoolInts, kPool]; row pSys: the system's offset in the share, -1 free

  __device__ __forceinline__ void store(int slot, const Rk45State& st) const {
#pragma unroll
    for (int c = 0; c < kNEq; ++c) f[(pY + c) * kPool + slot] = st.y[c];
    f[pT * kPool + slot] = st.t;
    f[pTc * kPool + slot] = st.t_c;
    f[pH * kPool + slot] = st.h;
    i[pReject * kPool + slot] = st.reject;
    i[pIasti * kPool + slot] = st.iasti;
    i[pNonsti * kPool + slot] = st.nonsti;
    i[pFstreak * kPool + slot] = st.fstreak;
    i[pNAcc * kPool + slot] = st.n_acc;
    i[pNRej * kPool + slot] = st.n_rej;
    i[pNAtt * kPool + slot] = st.n_att;
    i[pQ * kPool + slot] = st.q;
  }
  __device__ __forceinline__ void load(int slot, Rk45State& st) const {
#pragma unroll
    for (int c = 0; c < kNEq; ++c) st.y[c] = f[(pY + c) * kPool + slot];
    st.t = f[pT * kPool + slot];
    st.t_c = f[pTc * kPool + slot];
    st.h = f[pH * kPool + slot];
    st.reject = i[pReject * kPool + slot];
    st.iasti = i[pIasti * kPool + slot];
    st.nonsti = i[pNonsti * kPool + slot];
    st.fstreak = i[pFstreak * kPool + slot];
    st.n_acc = i[pNAcc * kPool + slot];
    st.n_rej = i[pNRej * kPool + slot];
    st.n_att = i[pNAtt * kPool + slot];
    st.q = i[pQ * kPool + slot];
    st.stiff = 0;  // a stiff system ended in the slice that flagged it
  }
};

// Sort key of a slot: t mapped to an unsigned integer of the same order
// (negative t included), above the slot's number.
__device__ __forceinline__ unsigned long long slot_key(float t, int slot) {
  const unsigned u = __float_as_uint(t);
  const unsigned ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ordered << 32) | (unsigned)slot;
}

// Ascending bitonic sort of key[0, kPool) by the whole block.  Thread tid
// owns the elements tid + r * kThreads, so partners less than 32 apart
// belong to lanes of one warp: a stage needs the block's barrier only if it,
// or the stage after it, pairs elements 32 or more apart.
__device__ __forceinline__ void sort_keys(unsigned long long* key, int tid) {
  for (int k = 2; k <= kPool; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < kPool; i += kThreads) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long x = key[i], z = key[p];
          if ((x > z) == ((i & k) == 0)) {
            key[i] = z;
            key[p] = x;
          }
        }
      }
      if (j >= 32 || (j == 1 && k >= 32)) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
  if (kPool < 32) __syncthreads();  // else the last stage ended on the block's barrier
}

// -DTT_RK45_PHASES: every warp records its %globaltimer at start and end,
// its SM, its trips through the attempt loop (a trip costs the warp one
// attempt's instructions however few lanes are in it), the trips in which a
// lane filled dense rows, its lanes' attempts in sum and at most, and its
// cycles inside the run section and in all.
#ifdef TT_RK45_PHASES
constexpr int kProbeWarps = 8192, kProbeWords = 9;
__device__ unsigned long long rk45_probe[kProbeWarps * kProbeWords];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
__device__ __forceinline__ unsigned sm_id() {
  unsigned v;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(v));
  return v;
}
struct WarpProbe {
  unsigned long long ns0 = 0, run_cycles = 0;
  long long clk0 = 0;
  unsigned trips = 0, fill_trips = 0, attempts = 0;
  __device__ __forceinline__ void start() {
    ns0 = global_ns();
    clk0 = clock64();
  }
  // After an attempt, by every lane that made it.
  __device__ __forceinline__ void count(bool filled) {
    const unsigned m = __activemask();
    const unsigned any_fill = __ballot_sync(m, filled);
    if ((threadIdx.x & 31) == __ffs(m) - 1) {
      ++trips;
      fill_trips += any_fill != 0;
    }
    ++attempts;
  }
  // By all 32 lanes, once the warp's work is done.
  __device__ __forceinline__ void write() const {
    const unsigned full = 0xFFFFFFFFu;
    const unsigned tr = __reduce_add_sync(full, trips), ft = __reduce_add_sync(full, fill_trips);
    const unsigned at = __reduce_add_sync(full, attempts), mx = __reduce_max_sync(full, attempts);
    const unsigned long long w = ((unsigned long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if ((threadIdx.x & 31) == 0 && w < kProbeWarps) {
      unsigned long long* r = rk45_probe + w * kProbeWords;
      r[0] = ns0, r[1] = global_ns(), r[2] = sm_id(), r[3] = tr, r[4] = ft, r[5] = at, r[6] = mx;
      r[7] = run_cycles, r[8] = (unsigned long long)(clock64() - clk0);
    }
  }
};
#define TT_PROBE(x) x
#else
#define TT_PROBE(x)
#endif

__global__ void __launch_bounds__(kThreads, 1) rk45_kernel(const Rk45Args a) {
  extern __shared__ unsigned long long smem[];
  Pool pool;
  pool.key = smem;
  pool.f = reinterpret_cast<float*>(smem + kPool);
  pool.i = reinterpret_cast<int32_t*>(pool.f + (size_t)kPoolFloats * kPool);
  const int tid = threadIdx.x;
  TT_PROBE(WarpProbe probe; probe.start();)

  // This block's share of the systems, and the next one to admit.
  const int64_t lo = a.n_sys * blockIdx.x / gridDim.x;
  const int64_t hi = a.n_sys * (blockIdx.x + 1) / gridDim.x;
  int64_t next = lo;
  for (int i = tid; i < kPool; i += kThreads) pool.i[pSys * kPool + i] = -1;
  __syncthreads();

  int n_live = 0;
  bool reorder = true;
  for (;;) {
    // Order the slots: live ones by t, free ones last.  The order of the
    // slice before still holds if it ran every live system and none ended.
    if (reorder) {
      n_live = 0;
      for (int i0 = 0; i0 < kPool; i0 += kThreads) {
        const int i = i0 + tid;
        const bool live = i < kPool && pool.i[pSys * kPool + i] >= 0;
        if (i < kPool)
          pool.key[i] = live ? slot_key(pool.f[pT * kPool + i], i) : (kFreeKey << 32) | (unsigned)i;
        n_live += __syncthreads_count(live);
      }
      sort_keys(pool.key, tid);
    }

    // Admit the next systems of the share into the free slots.  They start
    // at t0, behind every live system, so they head the run order.
    const int n_admit = (int)min((int64_t)(kPool - n_live), hi - next);
    if (n_live + n_admit == 0) break;
    for (int j = tid; j < n_admit; j += kThreads) {
      const int slot = (int)(unsigned)pool.key[n_live + j];
      Rk45State st;
      float h0;
      rk45_admit(a, next + j, st, h0);
      pool.store(slot, st);
      pool.f[pH0 * kPool + slot] = h0;
      pool.i[pSys * kPool + slot] = (int32_t)(next + j - lo);
    }
    next += n_admit;
    if (n_admit > 0) __syncthreads();

    // Run: lane p takes the p-th system of the order, the new ones first.
    const int n_run = min(n_live + n_admit, kThreads);
    bool ended = false;
    if (tid < n_run) {
      TT_PROBE(const long long run0 = clock64();)
      const int slot = (int)(unsigned)(tid < n_admit ? pool.key[n_live + tid] : pool.key[tid - n_admit]);
      const int64_t s = lo + pool.i[pSys * kPool + slot];
      const float h0 = pool.f[pH0 * kPool + slot];
      Rk45State st;
      Model204 model;
      pool.load(slot, st);
      model.load(a.params, a.n_sys, s, a.safe_pow);
      bool live = rk45_live(a, st);
      for (int k = 0; k < kSlice && live; ++k) {
        const bool filled = rk45_attempt(a, model, h0, s, st);
        (void)filled;
        TT_PROBE(probe.count(filled);)
        live = rk45_live(a, st);
      }
      if (live) {
        pool.store(slot, st);
      } else {
        rk45_finish(a, s, st);
        pool.i[pSys * kPool + slot] = -1;
        ended = true;
      }
      TT_PROBE(probe.run_cycles += (unsigned long long)(clock64() - run0);)
    }
    reorder = __syncthreads_or(ended) || n_admit > 0 || n_live > kThreads;
  }
  TT_PROBE(probe.write();)
}

}  // namespace tt

// ---- launch ----

extern "C" int tt_rk45_args_size() { return (int)sizeof(tt::Rk45Args); }

// The launch geometry of n_sys systems on the current device: one block per
// SM, fewer where a block's share would fall under a warp of systems.
extern "C" int tt_rk45_geometry(int64_t n_sys, int32_t* out) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t want = n_sys / 32;
  out[0] = (int32_t)(want < 1 ? 1 : (want > sms ? sms : want));  // blocks
  out[1] = tt::kThreads;
  out[2] = tt::kPool;
  out[3] = tt::kSlice;
  out[4] = (int32_t)tt::kPoolBytes;  // dynamic shared memory a block
  return 0;
}

// Enqueues B1 on `stream`; returns the CUDA error code (0 on success).
extern "C" int tt_rk45_launch(const tt::Rk45Args* args, void* stream) {
  if (args->n_sys <= 0) return 0;
  int32_t geo[5];
  int rc = tt_rk45_geometry(args->n_sys, geo);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(tt::rk45_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)tt::kPoolBytes);
  if (rc != 0) return rc;
  tt::rk45_kernel<<<(unsigned)geo[0], tt::kThreads, tt::kPoolBytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

#ifdef TT_RK45_PHASES
// Copies the first n_warps warps' probe records into `out` (each launch
// overwrites the records of the warps it has).
extern "C" int tt_rk45_probe_read(unsigned long long* out, int n_warps) {
  if (n_warps > tt::kProbeWarps) n_warps = tt::kProbeWarps;
  const size_t bytes = (size_t)n_warps * tt::kProbeWords * sizeof(unsigned long long);
  return (int)cudaMemcpyFromSymbol(out, tt::rk45_probe, bytes);
}
#endif
