// B1: fused adaptive Dormand-Prince 5(4) over every system, in float32 or
// float64.
//
// Replaces the TPU kernel tiger_tpu/kernels/rk45_pallas.py: _make_kernel's
// inner `kernel` (l.243-866), launched by pl.pallas_call in
// _pallas_pipeline (l.1051).  Same per-system semantics: ZOH forcing frozen
// at step start, the step capped at the tf landing and then at the next
// forcing boundary, seven stages, the inf-norm embedded error, the
// slope-jump guard, the I controller with NaN shrink, Kahan-compensated t,
// the stiffness criteria (reject streak, h-floor streak, Hairer's |h*lambda|
// test every stiff_test_every accepted steps), quartic dense output into
// the queries in (t, t + h], and per-system counters.  The TPU kernel's
// options are compile-time here (Rk45Option, one instance per legal set:
// the I or PI controller, each plain, with FSAL or compensated), so the
// default instance keeps its instructions and its pool:
//   - FSAL (l.437-454, 726-777): k1 is carried from the last advance's k7
//     (y_out is accumulated in stage 7's association, so k7 = f(t + h,
//     y_out) bit for bit), and evaluated anew after a step that crossed a
//     forcing sample; its results equal the default instance's bit for bit;
//   - compensated (l.495-551, 790-803): dy accumulated on its own, the
//     error test on y + dy, and the state committed by TwoSum into y and
//     its Kahan low word y_c;
//   - PI (l.623-640): the Lund-stabilised factor base * facold^beta on an
//     advance, the plain factor on a rejection, facold carried.
// Each option state is one more row of the pool in the instances that use
// it (k0[5], y_c[5], facold).  Two more options are runtime flags of
// Rk45Args, uniform across a launch: lockstep (SolverConfig.dense_lockstep,
// l.345-351, 392-421), which caps each step at the next query the system
// has not reached (lockstep_barrier), and bf16 forcing
// (forcing_dtype='bf16', l.982, 1011-1015; float only), which reads the
// bfloat16 copy of the forcing the wrapper makes and widens each sample
// (rk45_gather).  Only the instances with the option bit kRuntime read
// them: read in every instance, they cost the default instance registers
// under ptxas and 2.5% of its time on the main path (profile_solve, parent
// against change on one H100), so each option set has an instance with the
// bit and one without, and the latter keeps its code.  The scalar is a template parameter too: six
// float instances and the same six in double (the TPU kernel is float32
// only and runs float64 through the vmap path, tiger_tpu/solver/rk45.py
// _rk45_system; rk45_dispatch).  A double system
// needs twice the registers of a float one (~180 against ~120), so a double
// block has TT_RK45_THREADS_F64 lanes (256: at most 255 registers a thread)
// and its pool rows of state are 8 bytes a slot.  The file is compiled twice
// (_build.py): as it stands, for the float instances and the entry points,
// and with -DTT_DOUBLE_INSTANCES, as relocatable device code, for the double
// instances, whose pow is contracted.cu's (common.cuh pow_t).  So the float
// instances keep the code and the build they had.
//
// The model is a template parameter too (common.cuh Model204, Model200,
// ModelDummy), and every stage passes its time to the rhs with the window's
// shift added, t + c_i h + t_shift (rk45_pallas.py:273-277): Model 200's
// Hamon PET reads the day of year.  The forcing gather stays unshifted.
// Each model's instances are built in translation units of their own: the
// file is compiled again with -DTT_MODEL_200 or -DTT_MODEL_DUMMY, in float
// and with -DTT_DOUBLE_INSTANCES in double, as relocatable code
// (_build.py), so Model 204's build is the one it had.  Model 200's float
// system needs more than the 128 registers a thread of a 512-lane block may
// have (its rhs calls exp, tan, atan, cos, asin, acos and sin), so its block
// has TT_RK45_THREADS_M200 lanes (256), as a double block has.  DummyModel
// holds no per-system field, and its float block keeps Model 204's
// TT_RK45_THREADS lanes (512).
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
//     share of the systems and never talks to another block: no atomics
//     across blocks, so each block's work repeats from launch to launch.
//   - A system's state between attempts (Rk45State, h0 and its index) lives
//     in a pool of slots in shared memory, SoA over the slots; its Model204
//     fields are derived again from the parameter block at every slice
//     (keeping them in the pool measured no faster).  Freed slots admit the
//     next systems of the share, so any number of systems runs through a
//     pool of fixed size.
//   - A slice: the block sorts its slots by t (a bitonic network over
//     64-bit keys: ordered t above, slot below; free slots last), the
//     kThreads live systems furthest behind in t are loaded into registers,
//     one a lane, packed into the fewest warps, and each lane spends up to
//     kSlice attempts.  It then stores its system back, or writes it out as
//     its result and frees its slot.  Warps past the live count skip the
//     slice, so the drain of the longest chains costs scheduler slots only
//     for what is alive, and while every live system runs and none ends the
//     order is kept and the sort skipped.  "Furthest behind first" needs no
//     knowledge of the future: the longest chain runs in every slice from
//     the first.
//   - Refills, where systems live less than a slice (short hot-started
//     windows): a lane whose system ends writes it out and at once takes
//     the next system no lane runs (the next of the slice's order, then the
//     next of the share, admitted into the slot it freed), claimed from a
//     counter in shared memory, so the slice costs its lanes' attempts and
//     not its slowest system's lifetime.  A slice refills where systems
//     ended in the slice before and work waits; elsewhere it runs the
//     plain loop, which long-lived systems run fastest.  Which lane runs
//     which system may vary from launch to launch; no result does.
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
// TT_RK45_THREADS lanes a block (TT_RK45_THREADS_F64 for double), TT_RK45_POOL
// slots (a power of two), TT_RK45_SLICE attempts a slice.  -DTT_RK45_PHASES adds per-warp probes
// (python -m tiger_tpu_torch.rk45_phases).

#include <type_traits>

#include "common.cuh"
#include "rk45_tableau.cuh"  // TT_DP_TABLEAU, written by _build.py

#ifndef TT_RK45_THREADS
#define TT_RK45_THREADS 512
#endif
#ifndef TT_RK45_THREADS_F64
#define TT_RK45_THREADS_F64 256
#endif
#ifndef TT_RK45_THREADS_M200
#define TT_RK45_THREADS_M200 256
#endif
#ifndef TT_RK45_POOL
#define TT_RK45_POOL 1024
#endif
#ifndef TT_RK45_SLICE
#define TT_RK45_SLICE 64
#endif

namespace tt {

// Lanes a block, by scalar and model.
template <class T, class M>
constexpr int kThreads = std::is_same<T, double>::value ? TT_RK45_THREADS_F64
                         : M::kId == kModel200       ? TT_RK45_THREADS_M200
                                                     : TT_RK45_THREADS;
constexpr int kPool = TT_RK45_POOL;
constexpr int kSlice = TT_RK45_SLICE;
static_assert(kPool > 0 && (kPool & (kPool - 1)) == 0, "the bitonic sort needs a power of two");
static_assert((TT_RK45_THREADS % 32 == 0 || TT_RK45_THREADS < 32) &&
                  (TT_RK45_THREADS_F64 % 32 == 0 || TT_RK45_THREADS_F64 < 32) &&
                  (TT_RK45_THREADS_M200 % 32 == 0 || TT_RK45_THREADS_M200 < 32),
              "whole warps, or (in a CPU rehearsal) a part of one");

template <class T>
struct DpTableau {
  T a[7][7], c[7], b[7], e[7], p[7][4];  // tableau.DP_*
};

// The tableau in T: tableau.DP_* rounded to float, or exactly its float64
// values (the initialisers are the header _build.py writes).
template <class T>
__host__ __device__ constexpr DpTableau<T> dp_tableau() {
  if constexpr (std::is_same<T, double>::value) {
    return DpTableau<T> TT_DP_TABLEAU_F64;
  } else {
    return DpTableau<T> TT_DP_TABLEAU;
  }
}

// One struct a scalar, its scalars in T: a double instance gets rtol 1e-6
// as the plain version's double 1e-6, not a float widened.  The float
// instances' struct is the one they always had.
template <class T>
struct Rk45Args {
  const T* y0;          // [5, S]
  const T* h0;          // [S] initial step (also the slope-cut floor base)
  const T* params;      // [15, S], PARAM_FIELDS order
  const float* forc;    // [T_total, S] float32 in every instance; unused when forcing.n_forc == 0
  const T* qt;          // [Q] sorted, unique
  T* y_final;           // [5, S]; NaN where the system did not finish
  T* dense;             // [Q, 5, S]
  int32_t* stiff;       // [S]
  int32_t* failed;      // [S]
  int32_t* stats;       // [3, S]: accepted, rejected, attempted
  int64_t n_sys;
  int32_t n_q;
  int32_t safe_pow;
  T t0, tf, h_floor;
  T rtol, atol, safety, min_scale, max_scale, expo;  // expo: 0.2, or 0.2 - 0.75 beta (PI)
  T slope_jump_thresh, min_step_fraction, nan_shrink, stiff_hlamb, pi_beta;
  int32_t max_rejects, max_steps, stiff_detect, stiff_streak, stiff_forgive;
  int32_t stiff_test_every, stiff_floor_streak, fill_t0_queries;
  int32_t options;  // Rk45Option bits: which instance the launcher starts
  ForcingMeta<T> forcing;
  // Last, so the fields above keep their offsets (and Model 204's
  // instances their code).
  int32_t model;  // KernelModel
  T t_shift;      // added to the time the rhs sees (not the forcing gather's)
  T doy0;         // Model 200: the day of year at t = 0
  // Runtime options, uniform across a launch, read by the kRuntime instances:
  int32_t lockstep;                // SolverConfig.dense_lockstep: cap at the next unreached query
  const __nv_bfloat16* forc_bf16;  // forcing_dtype='bf16' (float instances): forc rounded to
                                   // bfloat16, read in its place; null: read forc
};

// The TPU kernel's options (SolverConfig.fsal, .compensated, .controller;
// kRuntime: .dense_lockstep or .forcing_dtype, read from Rk45Args).  fsal
// and compensated exclude each other (SolverConfig.__post_init__), so twelve
// sets have an instance: {I, PI} x {plain, FSAL, compensated} x kRuntime.
enum Rk45Option : int32_t { kFsal = 1, kComp = 2, kPi = 4, kRuntime = 8 };
template <int OPT>
struct Rk45Opt {
  static constexpr bool fsal = (OPT & kFsal) != 0, comp = (OPT & kComp) != 0,
                        pi = (OPT & kPi) != 0, runtime = (OPT & kRuntime) != 0;
  static_assert(!(fsal && comp), "fsal and compensated exclude each other");
};

// Everything a system carries from one attempt to the next.  With h0 it is
// also what a windowed solve would carry from one query window to the next
// (rk45_pallas.py:850-865 writes the same fields).
template <class T>
struct Rk45State {
  T y[kNEq], t, t_c, h;  // t_c: Kahan compensation of t
  T k0[kNEq];   // FSAL: f(t, y), carried from the last advance
  T y_c[kNEq];  // compensated: the Kahan low word of y
  T facold;     // PI: the last committed error norm (1e-4 at the start)
  int32_t reject, iasti, nonsti, fstreak;  // reject streak, detector counters, h-floor streak
  int32_t n_acc, n_rej, n_att;
  int32_t q;      // query cursor: the first query strictly past t
  int32_t stiff;  // a stiffness criterion tripped: the system ends
};

template <class T>
__device__ __forceinline__ bool rk45_live(const Rk45Args<T>& a, const Rk45State<T>& st) {
  return st.t < a.tf && !st.stiff && st.n_att < a.max_steps;
}

// The forcing sample index of every forcing differs between times t and u.
template <class T>
__device__ __forceinline__ bool forcing_sample_changed(const ForcingMeta<T>& m, T t, T u) {
  bool changed = false;
#pragma unroll
  for (int j = 0; j < kMaxForcings; ++j) {
    if (j < m.n_forc) {
      const int it = min(max((int)(t / m.dt[j] + m.snap), 0), m.n_steps[j] - 1);
      const int iu = min(max((int)(u / m.dt[j] + m.snap), 0), m.n_steps[j] - 1);
      changed = changed || it != iu;
    }
  }
  return changed;
}

// ZOH gather of system s at t from the data the launch reads: the bfloat16
// copy where a float kRuntime launch has one, else the float32 data.
template <class T, int OPT>
__device__ __forceinline__ void rk45_gather(const Rk45Args<T>& a, int64_t s, T t,
                                            T (&f)[kMaxForcings]) {
  if constexpr (std::is_same<T, float>::value && Rk45Opt<OPT>::runtime) {
    if (a.forc_bf16 != nullptr) {
      gather_forcings(a.forc_bf16, a.n_sys, s, a.forcing, t, f);
      return;
    }
  }
  gather_forcings(a.forc, a.n_sys, s, a.forcing, t, f);
}

// Lockstep query crossing (rk45_pallas.py l.345-351, 392-421): the first
// query a system at t has not reached, within the TPU kernel's landing
// tolerance 4.8e-7 |tq| + 1e-6 (a Kahan commit may stop an ulp short of a
// query); tf + 1 once it has passed them all.  The TPU kernel carries this
// cursor from the first query past t0 and advances it as the system's t
// passes each query.  Here it is found from the dense cursor q, the first
// query past t: every query before q lies at or below t, so it was reached,
// and a cursor walked from q stops where the carried one does.  (The TPU
// kernel also idles a lane that arrived until its tile's others have; that
// changes no lane's steps.)
template <class T>
__device__ __forceinline__ T lockstep_barrier(const Rk45Args<T>& a, int q, T t) {
  for (; q < a.n_q; ++q) {
    const T tq = __ldg(a.qt + q);
    if (!(t >= tq - (T(4.8e-7) * fabs_t(tq) + T(1e-6)))) return tq;
  }
  return a.tf + T(1);
}

// Start of system s: state from y0 and h0, and the dense rows with
// qt <= t0 as y0 (fill_t0_queries), the rest as 0.  FSAL's first k1 is
// f(t0, y0) on the forcing at t0.
template <class T, class M, int OPT>
__device__ __forceinline__ void rk45_admit(const Rk45Args<T>& a, int64_t s, Rk45State<T>& st,
                                           T& h0) {
  using O = Rk45Opt<OPT>;
  const int64_t S = a.n_sys;
#pragma unroll
  for (int i = 0; i < kNEq; ++i) st.y[i] = __ldg(a.y0 + i * S + s);
  h0 = __ldg(a.h0 + s);
  for (int qi = 0; qi < a.n_q; ++qi) {
    const bool pre = a.fill_t0_queries && __ldg(a.qt + qi) <= a.t0;
#pragma unroll
    for (int i = 0; i < kNEq; ++i)
      a.dense[((int64_t)qi * kNEq + i) * S + s] = pre ? st.y[i] : T(0);
  }
  st.q = 0;
  while (st.q < a.n_q && __ldg(a.qt + st.q) <= a.t0) ++st.q;
  st.t = a.t0;
  st.t_c = T(0);
  st.h = h0;
  st.reject = st.iasti = st.nonsti = st.fstreak = 0;
  st.n_acc = st.n_rej = st.n_att = 0;
  st.stiff = 0;
  if constexpr (O::fsal) {
    M model;
    model.load(a.params, S, s, a.safe_pow, a.doy0);
    T f[kMaxForcings];
    rk45_gather<T, OPT>(a, s, st.t, f);
    model.rhs(st.t + a.t_shift, st.y, f, a.forcing.n_forc, st.k0);
  }
  if constexpr (O::comp) {
#pragma unroll
    for (int i = 0; i < kNEq; ++i) st.y_c[i] = T(0);
  }
  if constexpr (O::pi) st.facold = T(1e-4);
}

// One attempt of system s.  Returns whether it filled dense rows.
template <class T, class M, int OPT>
__device__ __forceinline__ bool rk45_attempt(const Rk45Args<T>& a, const M& model,
                                             const T h0, const int64_t s, Rk45State<T>& st) {
  using O = Rk45Opt<OPT>;
  constexpr DpTableau<T> tb = dp_tableau<T>();
  const int64_t S = a.n_sys;
  const T t = st.t, h = st.h, tf = a.tf;
  T(&y)[kNEq] = st.y;

  const bool clamp = t + h > tf;
  T h_eff = clamp ? tf - t : h;
  // Lockstep caps the step like the ZOH cap: the controller grows the next
  // h from the capped one, and a clamped landing stays clamped.
  if constexpr (O::runtime) {
    if (a.lockstep) h_eff = jmin(h_eff, jmax(lockstep_barrier(a, st.q, t) - t, T(0)));
  }
  if (a.forcing.align) h_eff = zoh_step_cap(a.forcing, t, h_eff);
  T f[kMaxForcings];
  rk45_gather<T, OPT>(a, s, t, f);

  // Seven stages at t + c_i h (plus the shift); forcing frozen at step
  // start for all of them.  FSAL takes k1 from the carry: the last
  // advance's k7, or for a rejected system the same (t, y)'s.
  T k[7][kNEq], g6[kNEq];
  if constexpr (O::fsal) {
#pragma unroll
    for (int i = 0; i < kNEq; ++i) k[0][i] = st.k0[i];
  } else {
    model.rhs(t + a.t_shift, y, f, a.forcing.n_forc, k[0]);
  }
#pragma unroll
  for (int sg = 1; sg < 7; ++sg) {
    T acc[kNEq];
#pragma unroll
    for (int i = 0; i < kNEq; ++i) acc[i] = y[i];
#pragma unroll
    for (int j = 0; j < sg; ++j) {
      if (tb.a[sg][j] != T(0)) {
        const T hw = h_eff * tb.a[sg][j];
#pragma unroll
        for (int i = 0; i < kNEq; ++i) acc[i] = acc[i] + hw * k[j][i];
      }
    }
    if (sg == 5) {
#pragma unroll
      for (int i = 0; i < kNEq; ++i) g6[i] = acc[i];
    }
    model.rhs((t + tb.c[sg] * h_eff) + a.t_shift, acc, f, a.forcing.n_forc, k[sg]);
  }

  // 5th-order update and embedded error, in the TPU kernel's order: y_out
  // in stage 7's association (so FSAL's k7 is f(t + h, y_out)), or, when
  // compensated, the increment dy on its own and y_out = y + dy.
  T y_out[kNEq], err_c[kNEq], dy[kNEq];
#pragma unroll
  for (int i = 0; i < kNEq; ++i) {
    y_out[i] = y[i];
    err_c[i] = T(0);
    dy[i] = T(0);
  }
#pragma unroll
  for (int sg = 0; sg < 7; ++sg) {
    if (tb.b[sg] != T(0)) {
      const T hw = h_eff * tb.b[sg];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        if constexpr (O::comp) {
          dy[i] = dy[i] + hw * k[sg][i];
        } else {
          y_out[i] = y_out[i] + hw * k[sg][i];
        }
      }
    }
    if (tb.e[sg] != T(0)) {
      const T hw = h_eff * tb.e[sg];
#pragma unroll
      for (int i = 0; i < kNEq; ++i) err_c[i] = err_c[i] + hw * k[sg][i];
    }
  }
  if constexpr (O::comp) {
#pragma unroll
    for (int i = 0; i < kNEq; ++i) y_out[i] = y[i] + dy[i];
  }
  T err = T(0), jump_mag = T(0);
#pragma unroll
  for (int i = 0; i < kNEq; ++i) {
    const T tol = a.atol + a.rtol * jmax(fabs_t(y[i]), fabs_t(y_out[i]));
    err = jmax(err, fabs_t(err_c[i] / tol));
    jump_mag = jmax(jump_mag, fabs_t(k[0][i] - k[1][i]));
  }
  const bool accept = err <= T(1);  // NaN rejects
  const bool jump = jump_mag > a.slope_jump_thresh;
  const bool advance = accept && !jump;
  const bool slope = accept && jump;

  // Kahan-compensated commit time; also the dense window's upper bound.
  const T kh = h_eff - st.t_c;
  const T t1 = t + kh;

  const bool fill = advance && st.q < a.n_q && __ldg(a.qt + st.q) <= t1;
  if (fill) {
    T qm[4][kNEq];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int i = 0; i < kNEq; ++i) qm[m][i] = T(0);
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        if (tb.p[j][m] != T(0)) {
#pragma unroll
          for (int i = 0; i < kNEq; ++i) qm[m][i] = qm[m][i] + tb.p[j][m] * k[j][i];
        }
      }
    }
    T tq;
    while (st.q < a.n_q && (tq = __ldg(a.qt + st.q)) <= t1) {
      const T theta = (tq - t) / h_eff;
      const T th2 = theta * theta;
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        const T poly = qm[0][i] * theta + qm[1][i] * th2 +
                           qm[2][i] * th2 * theta + qm[3][i] * th2 * th2;
        a.dense[((int64_t)st.q * kNEq + i) * S + s] = y[i] + h_eff * poly;
      }
      ++st.q;
    }
  }

  // I controller: clip on accept, capped at 1 (NaN -> nan_shrink) on reject.
  // PI: an advance takes base * facold^beta (through the same powf), and a
  // committed step that was not clamped at tf sets facold.
  const T base_fac = a.safety * pow_t(T(1) / (err + T(1e-16)), a.expo);
  T raw_fac = base_fac;
  if constexpr (O::pi) {
    raw_fac = base_fac * pow_t(st.facold, a.pi_beta);
    if (advance && !clamp) st.facold = jmax(err, T(1e-4));
  }
  const T fac_acc = jclip(raw_fac, a.min_scale, a.max_scale);
  const T fac_rej =
      jclip(is_nan(base_fac) ? a.nan_shrink : jmin(base_fac, T(1)), a.min_scale,
            a.max_scale);
  const T h_slope = jmax(h_eff * T(0.5), h0 * a.min_step_fraction);
  // A clamped landing step never shrinks the carried h.
  const T h_adv = clamp ? jmax(h_eff * fac_acc, h) : h_eff * fac_acc;
  const T h_new = advance ? h_adv : (slope ? h_slope : h_eff * fac_rej);
  const int32_t reject_new = accept ? 0 : st.reject + 1;

  bool stiff_new;
  if (a.stiff_detect) {
    st.fstreak = h_new < a.h_floor ? st.fstreak + 1 : 0;
    stiff_new = (!accept && reject_new > a.max_rejects) ||
                st.fstreak >= a.stiff_floor_streak;
    // Hairer's |h*lambda| from the two t+h stages, tested every
    // stiff_test_every-th accepted step (post-increment count); slope
    // cuts trip without waiting for the cadence.
    T stnum = T(0), stden = T(0);
#pragma unroll
    for (int i = 0; i < kNEq; ++i) {
      stnum = jmax(stnum, fabs_t(k[6][i] - k[5][i]));
      stden = jmax(stden, fabs_t(y_out[i] - g6[i]));
    }
    const T hlamb = stden > T(0) ? h_eff * stnum / stden : T(0);
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
    if constexpr (O::comp) {
      // TwoSum of y and dy less the carried low word.
#pragma unroll
      for (int i = 0; i < kNEq; ++i) {
        const T khs = dy[i] - st.y_c[i];
        const T y_kah = y[i] + khs;
        st.y_c[i] = (y_kah - y[i]) - khs;
        y[i] = y_kah;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kNEq; ++i) y[i] = y_out[i];
    }
    if constexpr (O::fsal) {
      // k7 read the forcing of t: past a sample boundary the next k1 is
      // evaluated on the new sample.
      if (forcing_sample_changed(a.forcing, t, t1)) {
        T f1[kMaxForcings];
        rk45_gather<T, OPT>(a, s, t1, f1);
        model.rhs(t1 + a.t_shift, y, f1, a.forcing.n_forc, st.k0);
      } else {
#pragma unroll
        for (int i = 0; i < kNEq; ++i) st.k0[i] = k[6][i];
      }
    }
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
template <class T>
__device__ __forceinline__ void rk45_finish(const Rk45Args<T>& a, int64_t s, const Rk45State<T>& st) {
  const int64_t S = a.n_sys;
  const bool completed = st.t >= a.tf;
#pragma unroll
  for (int i = 0; i < kNEq; ++i) a.y_final[i * S + s] = completed ? st.y[i] : T(NAN);
  a.stiff[s] = (st.stiff || !completed) ? 1 : 0;
  a.failed[s] = (!completed && !st.stiff) ? 1 : 0;
  a.stats[s] = st.n_acc;
  a.stats[S + s] = st.n_rej;
  a.stats[2 * S + s] = st.n_att;
}

// ---- the pool ----
// Rows of the pool's float and int blocks; slot i of row r is block[r * kPool + i].
// The option rows follow pH0 in the instances that carry them.
enum PoolF { pY = 0, pT = kNEq, pTc, pH, pH0, kPoolFloats };
enum PoolI { pReject, pIasti, pNonsti, pFstreak, pNAcc, pNRej, pNAtt, pQ, pSys, kPoolInts };
constexpr unsigned long long kFreeKey = 0xFFFFFFFFull;  // above every live t

template <class T, int OPT>
struct Pool {
  using O = Rk45Opt<OPT>;
  static constexpr int pK0 = kPoolFloats;                     // FSAL: k0[5]
  static constexpr int pYc = pK0 + (O::fsal ? kNEq : 0);      // compensated: y_c[5]
  static constexpr int pFacold = pYc + (O::comp ? kNEq : 0);  // PI: facold
  static constexpr int kFloats = pFacold + (O::pi ? 1 : 0);
  // The rows, then one counter (8 bytes, so the size stays a whole number of keys).
  static constexpr size_t kBytes = (size_t)kPool * (8 + sizeof(T) * kFloats + 4 * kPoolInts) + 8;

  unsigned long long* key;  // [kPool] sort keys; after the sort, the slots in run order
  T* f;                     // [kFloats, kPool]
  int32_t* i;               // [kPoolInts, kPool]; row pSys: the system's offset in the share, -1 free
  int32_t* taken;           // the systems lanes took in this slice after their first

  __device__ __forceinline__ void store(int slot, const Rk45State<T>& st) const {
#pragma unroll
    for (int c = 0; c < kNEq; ++c) f[(pY + c) * kPool + slot] = st.y[c];
    f[pT * kPool + slot] = st.t;
    f[pTc * kPool + slot] = st.t_c;
    f[pH * kPool + slot] = st.h;
    if constexpr (O::fsal) {
#pragma unroll
      for (int c = 0; c < kNEq; ++c) f[(pK0 + c) * kPool + slot] = st.k0[c];
    }
    if constexpr (O::comp) {
#pragma unroll
      for (int c = 0; c < kNEq; ++c) f[(pYc + c) * kPool + slot] = st.y_c[c];
    }
    if constexpr (O::pi) f[pFacold * kPool + slot] = st.facold;
    i[pReject * kPool + slot] = st.reject;
    i[pIasti * kPool + slot] = st.iasti;
    i[pNonsti * kPool + slot] = st.nonsti;
    i[pFstreak * kPool + slot] = st.fstreak;
    i[pNAcc * kPool + slot] = st.n_acc;
    i[pNRej * kPool + slot] = st.n_rej;
    i[pNAtt * kPool + slot] = st.n_att;
    i[pQ * kPool + slot] = st.q;
  }
  __device__ __forceinline__ void load(int slot, Rk45State<T>& st) const {
#pragma unroll
    for (int c = 0; c < kNEq; ++c) st.y[c] = f[(pY + c) * kPool + slot];
    st.t = f[pT * kPool + slot];
    st.t_c = f[pTc * kPool + slot];
    st.h = f[pH * kPool + slot];
    if constexpr (O::fsal) {
#pragma unroll
      for (int c = 0; c < kNEq; ++c) st.k0[c] = f[(pK0 + c) * kPool + slot];
    }
    if constexpr (O::comp) {
#pragma unroll
      for (int c = 0; c < kNEq; ++c) st.y_c[c] = f[(pYc + c) * kPool + slot];
    }
    if constexpr (O::pi) st.facold = f[pFacold * kPool + slot];
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
// A double t keys by its nearest float: the order only chooses who runs
// next (ties fall to the slot's number), and no schedule changes a result.
__device__ __forceinline__ unsigned long long slot_key(double t, int slot) {
  return slot_key((float)t, slot);
}

// Ascending bitonic sort of key[0, kPool) by the whole block of THREADS.
// Thread tid owns the elements tid + r * THREADS, so partners less than 32
// apart belong to lanes of one warp: a stage needs the block's barrier only
// if it, or the stage after it, pairs elements 32 or more apart.
template <int THREADS>
__device__ __forceinline__ void sort_keys(unsigned long long* key, int tid) {
  for (int k = 2; k <= kPool; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < kPool; i += THREADS) {
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
// lane filled dense rows, its lanes' attempts in sum and at most, its
// cycles inside the run section and in all, the systems its lanes took in
// a slice after their first (refills), the trips through the refill path
// (lanes that refill at once share one), and the cycles of its trips
// through the attempt and through the refill path.  Each translation unit
// keeps its own records (static: the relocatable units are linked
// together), read by the entry point through the unit of the last launch.
#ifdef TT_RK45_PHASES
constexpr int kProbeWarps = 8192, kProbeWords = 13;
static __device__ unsigned long long rk45_probe[kProbeWarps * kProbeWords];
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
  unsigned long long ns0 = 0, run_cycles = 0, attempt_cycles = 0, refill_cycles = 0;
  long long clk0 = 0;
  unsigned trips = 0, fill_trips = 0, attempts = 0, refills = 0, refill_trips = 0;
  __device__ __forceinline__ void start() {
    ns0 = global_ns();
    clk0 = clock64();
  }
  // After an attempt of `cycles`, by every lane that made it.
  __device__ __forceinline__ void count(bool filled, long long cycles) {
    const unsigned m = __activemask();
    const unsigned any_fill = __ballot_sync(m, filled);
    if ((threadIdx.x & 31) == __ffs(m) - 1) {
      ++trips;
      fill_trips += any_fill != 0;
      attempt_cycles += (unsigned long long)cycles;
    }
    ++attempts;
  }
  // After a refill of `cycles`, by every lane that took a system.
  __device__ __forceinline__ void refill(long long cycles) {
    const unsigned m = __activemask();
    if ((threadIdx.x & 31) == __ffs(m) - 1) {
      ++refill_trips;
      refill_cycles += (unsigned long long)cycles;
    }
    ++refills;
  }
  // By all 32 lanes, once the warp's work is done.
  __device__ __forceinline__ void write() const {
    const unsigned full = 0xFFFFFFFFu;
    const unsigned tr = __reduce_add_sync(full, trips), ft = __reduce_add_sync(full, fill_trips);
    const unsigned at = __reduce_add_sync(full, attempts), mx = __reduce_max_sync(full, attempts);
    const unsigned rf = __reduce_add_sync(full, refills), rt = __reduce_add_sync(full, refill_trips);
    unsigned long long ac = attempt_cycles, rc = refill_cycles;
    for (int d = 16; d > 0; d >>= 1) {
      ac += __shfl_down_sync(full, ac, d);
      rc += __shfl_down_sync(full, rc, d);
    }
    const unsigned long long w = ((unsigned long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if ((threadIdx.x & 31) == 0 && w < kProbeWarps) {
      unsigned long long* r = rk45_probe + w * kProbeWords;
      r[0] = ns0, r[1] = global_ns(), r[2] = sm_id(), r[3] = tr, r[4] = ft, r[5] = at, r[6] = mx;
      r[7] = run_cycles, r[8] = (unsigned long long)(clock64() - clk0), r[9] = rf, r[10] = rt;
      r[11] = ac, r[12] = rc;
    }
  }
};
#define TT_PROBE(x) x
#else
#define TT_PROBE(x)
#endif

template <class T, class M, int OPT>
__global__ void __launch_bounds__(kThreads<T, M>, 1) rk45_kernel(const Rk45Args<T> a) {
  constexpr int kLanes = kThreads<T, M>;
  extern __shared__ unsigned long long smem[];
  Pool<T, OPT> pool;
  pool.key = smem;
  pool.f = reinterpret_cast<T*>(smem + kPool);
  pool.i = reinterpret_cast<int32_t*>(pool.f + (size_t)Pool<T, OPT>::kFloats * kPool);
  pool.taken = pool.i + (size_t)kPoolInts * kPool;
  const int tid = threadIdx.x;
  TT_PROBE(WarpProbe probe; probe.start();)

  // This block's share of the systems, and the next one to admit.
  const int64_t lo = a.n_sys * blockIdx.x / gridDim.x;
  const int64_t hi = a.n_sys * (blockIdx.x + 1) / gridDim.x;
  int64_t next = lo;
  for (int i = tid; i < kPool; i += kLanes) pool.i[pSys * kPool + i] = -1;
  if (tid == 0) *pool.taken = 0;
  __syncthreads();

  int n_live = 0, n_ended = kLanes;  // lanes that saw a system end in the slice before
  bool reorder = true;
  for (;;) {
    // Order the slots: live ones by t, free ones last.  The order of the
    // slice before still holds if it ran every live system and none ended.
    if (reorder) {
      n_live = 0;
      for (int i0 = 0; i0 < kPool; i0 += kLanes) {
        const int i = i0 + tid;
        const bool live = i < kPool && pool.i[pSys * kPool + i] >= 0;
        if (i < kPool)
          pool.key[i] = live ? slot_key(pool.f[pT * kPool + i], i) : (kFreeKey << 32) | (unsigned)i;
        n_live += __syncthreads_count(live);
      }
      // Every lane has read the last slice's count; the sort ends on the
      // block's barrier, so no lane takes a system before this lands.
      if (tid == 0) *pool.taken = 0;
      sort_keys<kLanes>(pool.key, tid);
    }

    // Admit the next systems of the share into the free slots.  They start
    // at t0, behind every live system, so they head the run order.
    const int n_admit = (int)min((int64_t)(kPool - n_live), hi - next);
    if (n_live + n_admit == 0) break;
    for (int j = tid; j < n_admit; j += kLanes) {
      const int slot = (int)(unsigned)pool.key[n_live + j];
      Rk45State<T> st;
      T h0;
      rk45_admit<T, M, OPT>(a, next + j, st, h0);
      pool.store(slot, st);
      pool.f[pH0 * kPool + slot] = h0;
      pool.i[pSys * kPool + slot] = (int32_t)(next + j - lo);
    }
    next += n_admit;
    if (n_admit > 0) __syncthreads();

    // Run: the run order is the new systems, then the live ones by t, and
    // lane p takes its p-th system.  Two loops run it:
    //   - alone: each lane runs its system up to kSlice attempts, and a lane
    //     whose system ends waits for the slice's end;
    //   - refilled: a lane whose system ends with attempts left writes it
    //     out, frees its slot and takes at once the next system no lane
    //     runs (the next of the order, then, past its end, the next of the
    //     share, admitted into the slot it just freed), claimed from a
    //     counter in shared memory, until it has spent kSlice attempts in
    //     all.
    // A slice refills where lanes would otherwise idle while work waits:
    // systems wait beyond the lanes or in the share, and systems end inside
    // slices (a quarter of the lanes saw one end in the slice before; every
    // lane is taken to have before the first).  Elsewhere it runs them
    // alone: systems that outlive many slices, as in 2-day windows, run
    // that loop fastest (the refilled loop alone, no refill taken, costs
    // them 3-5% on the H100).
    const int n_order = n_live + n_admit;
    const int n_run = min(n_order, kLanes);
    const bool refill = (n_order > kLanes || next < hi) && 4 * n_ended >= kLanes;
    const auto order_slot = [&](int r) {
      return (int)(unsigned)(r < n_admit ? pool.key[n_live + r] : pool.key[r - n_admit]);
    };
    bool ended = false;
    if (tid < n_run && !refill) {
      TT_PROBE(const long long run0 = clock64();)
      const int slot = order_slot(tid);
      const int64_t s = lo + pool.i[pSys * kPool + slot];
      const T h0 = pool.f[pH0 * kPool + slot];
      Rk45State<T> st;
      M model;
      pool.load(slot, st);
      model.load(a.params, a.n_sys, s, a.safe_pow, a.doy0);
      bool live = rk45_live(a, st);
      for (int k = 0; k < kSlice && live; ++k) {
        TT_PROBE(const long long at0 = clock64();)
        const bool filled = rk45_attempt<T, M, OPT>(a, model, h0, s, st);
        (void)filled;
        TT_PROBE(probe.count(filled, clock64() - at0);)
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
    if (tid < n_run && refill) {
      TT_PROBE(const long long run0 = clock64();)
      int slot = order_slot(tid);
      int64_t s = lo + pool.i[pSys * kPool + slot];
      T h0 = pool.f[pH0 * kPool + slot];
      Rk45State<T> st;
      M model;
      pool.load(slot, st);
      model.load(a.params, a.n_sys, s, a.safe_pow, a.doy0);
      bool live = rk45_live(a, st);
      for (int k = 0; k < kSlice;) {
        // The refill, between attempts: the lanes that skip it meet the
        // others at the attempt.
        if (!live) {
          TT_PROBE(const long long rf0 = clock64();)
          rk45_finish(a, s, st);
          pool.i[pSys * kPool + slot] = -1;
          ended = true;
          const int r = n_run + atomicAdd(pool.taken, 1);
          if (r < n_order) {
            slot = order_slot(r);
            s = lo + pool.i[pSys * kPool + slot];
            h0 = pool.f[pH0 * kPool + slot];
            pool.load(slot, st);
          } else if (r - n_order < hi - next) {
            s = next + (r - n_order);
            rk45_admit<T, M, OPT>(a, s, st, h0);
            pool.f[pH0 * kPool + slot] = h0;
            pool.i[pSys * kPool + slot] = (int32_t)(s - lo);
          } else {
            slot = -1;  // the block's work is all taken
            break;
          }
          model.load(a.params, a.n_sys, s, a.safe_pow, a.doy0);
          live = rk45_live(a, st);
          TT_PROBE(probe.refill(clock64() - rf0);)
        }
        if (live) {
          TT_PROBE(const long long at0 = clock64();)
          const bool filled = rk45_attempt<T, M, OPT>(a, model, h0, s, st);
          (void)filled;
          TT_PROBE(probe.count(filled, clock64() - at0);)
          live = rk45_live(a, st);
          ++k;
        }
      }
      if (slot >= 0) {
        if (live) {
          pool.store(slot, st);
        } else {
          rk45_finish(a, s, st);
          pool.i[pSys * kPool + slot] = -1;
          ended = true;
        }
      }
      TT_PROBE(probe.run_cycles += (unsigned long long)(clock64() - run0);)
    }
    // Only a lane whose system ended takes another, so without an end the
    // count is 0 and the next slice may skip the reorder.
    n_ended = __syncthreads_count(ended);
    if (n_ended > 0) next += min((int64_t)max(n_run + *pool.taken - n_order, 0), hi - next);
    reorder = n_ended > 0 || n_admit > 0 || n_live > kLanes;
  }
  TT_PROBE(probe.write();)
}

// Calls f(std::integral_constant<int, OPT>{}) for the instance of the
// option set `options` in scalar T; false if it has none.  Both scalars
// and every model have the same twelve sets.
template <class T, class F>
inline bool rk45_dispatch(int32_t options, F&& f) {
  const auto with_runtime = [&](auto base) {
    constexpr int OPT = decltype(base)::value;
    if (options & kRuntime) {
      f(std::integral_constant<int, OPT | kRuntime>{});
    } else {
      f(base);
    }
  };
  switch (options & ~kRuntime) {
    case 0: with_runtime(std::integral_constant<int, 0>{}); return true;
    case kFsal: with_runtime(std::integral_constant<int, kFsal>{}); return true;
    case kComp: with_runtime(std::integral_constant<int, kComp>{}); return true;
    case kPi: with_runtime(std::integral_constant<int, kPi>{}); return true;
    case kFsal | kPi: with_runtime(std::integral_constant<int, kFsal | kPi>{}); return true;
    case kComp | kPi: with_runtime(std::integral_constant<int, kComp | kPi>{}); return true;
    default: return false;
  }
}

}  // namespace tt

// ---- launch ----

namespace tt {

// The launch geometry of n_sys systems on the current device for the
// instance of (T, M, options): one block per SM, fewer where a block's
// share would fall under a warp of systems.
template <class T, class M>
int rk45_geometry(int64_t n_sys, int32_t options, int32_t* out) {
  size_t pool_bytes = 0;
  if (!rk45_dispatch<T>(options, [&](auto opt) { pool_bytes = Pool<T, decltype(opt)::value>::kBytes; }))
    return kNoInstance;
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t want = n_sys / 32;
  out[0] = (int32_t)(want < 1 ? 1 : (want > sms ? sms : want));  // blocks
  out[1] = kThreads<T, M>;
  out[2] = kPool;
  out[3] = kSlice;
  out[4] = (int32_t)pool_bytes;  // dynamic shared memory a block
  return 0;
}

template <class T, class M>
int rk45_launch(const Rk45Args<T>* args, void* stream) {
  if (args->n_sys <= 0) return 0;
  int32_t geo[5];
  int rc = rk45_geometry<T, M>(args->n_sys, args->options, geo);
  if (rc != 0) return rc;
  rk45_dispatch<T>(args->options, [&](auto opt) {
    constexpr int OPT = decltype(opt)::value;
    constexpr size_t bytes = Pool<T, OPT>::kBytes;
    rc = (int)cudaFuncSetAttribute(rk45_kernel<T, M, OPT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc == 0)
      rk45_kernel<T, M, OPT><<<(unsigned)geo[0], kThreads<T, M>, bytes, (cudaStream_t)stream>>>(*args);
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The host side of the instances built in this file's other translation
// units (-DTT_DOUBLE_INSTANCES, -DTT_MODEL_200, -DTT_MODEL_DUMMY, and each
// model with the first), called by the entry points of the first: Model 204
// in double, Model 200 and DummyModel in float and double.
int rk45_geometry_f64(int64_t n_sys, int32_t options, int32_t* out);
int rk45_launch_f64(const void* args, void* stream);
int rk45_geometry_m200(int64_t n_sys, int32_t options, int32_t* out);
int rk45_launch_m200(const void* args, void* stream);
int rk45_geometry_m200_f64(int64_t n_sys, int32_t options, int32_t* out);
int rk45_launch_m200_f64(const void* args, void* stream);
int rk45_geometry_dummy(int64_t n_sys, int32_t options, int32_t* out);
int rk45_launch_dummy(const void* args, void* stream);
int rk45_geometry_dummy_f64(int64_t n_sys, int32_t options, int32_t* out);
int rk45_launch_dummy_f64(const void* args, void* stream);

#ifdef TT_RK45_PHASES
// Copies the first n_warps warps' probe records of this translation unit's
// instances into `out` (each launch overwrites the records of the warps it
// has).  Static, so each unit's copy reads its own records.
static int rk45_probe_copy(unsigned long long* out, int n_warps) {
  if (n_warps > kProbeWarps) n_warps = kProbeWarps;
  const size_t bytes = (size_t)n_warps * kProbeWords * sizeof(unsigned long long);
  return (int)cudaMemcpyFromSymbol(out, rk45_probe, bytes);
}
int rk45_probe_read_f64(unsigned long long* out, int n_warps);
int rk45_probe_read_m200(unsigned long long* out, int n_warps);
int rk45_probe_read_m200_f64(unsigned long long* out, int n_warps);
int rk45_probe_read_dummy(unsigned long long* out, int n_warps);
int rk45_probe_read_dummy_f64(unsigned long long* out, int n_warps);
#endif

#ifdef TT_INSTANCE_TU
#ifdef TT_DOUBLE_INSTANCES
using TuReal = double;
#else
using TuReal = float;
#endif
#if defined(TT_MODEL_200)
using TuModel = Model200<TuReal>;
#elif defined(TT_MODEL_DUMMY)
using TuModel = ModelDummy<TuReal>;
#else
using TuModel = Model204<TuReal>;
#endif
#if defined(TT_MODEL_200) && defined(TT_DOUBLE_INSTANCES)
#define TT_TU(fn) fn##_m200_f64
#elif defined(TT_MODEL_200)
#define TT_TU(fn) fn##_m200
#elif defined(TT_MODEL_DUMMY) && defined(TT_DOUBLE_INSTANCES)
#define TT_TU(fn) fn##_dummy_f64
#elif defined(TT_MODEL_DUMMY)
#define TT_TU(fn) fn##_dummy
#else
#define TT_TU(fn) fn##_f64
#endif
int TT_TU(rk45_geometry)(int64_t n_sys, int32_t options, int32_t* out) {
  return rk45_geometry<TuReal, TuModel>(n_sys, options, out);
}
int TT_TU(rk45_launch)(const void* args, void* stream) {
  return rk45_launch<TuReal, TuModel>(static_cast<const Rk45Args<TuReal>*>(args), stream);
}
#ifdef TT_RK45_PHASES
int TT_TU(rk45_probe_read)(unsigned long long* out, int n_warps) {
  return rk45_probe_copy(out, n_warps);
}
#endif
#endif

}  // namespace tt

#ifndef TT_INSTANCE_TU
// In each entry point f64 picks the scalar: 0 float (Rk45Args<float>), 1
// double (Rk45Args<double>); the model is Rk45Args.model (or `model`).
extern "C" int tt_rk45_args_size(int32_t f64) {
  return f64 ? (int)sizeof(tt::Rk45Args<double>) : (int)sizeof(tt::Rk45Args<float>);
}

extern "C" int tt_rk45_geometry(int64_t n_sys, int32_t options, int32_t f64, int32_t model,
                                int32_t* out) {
  switch (model) {
    case tt::kModel204:
      return f64 ? tt::rk45_geometry_f64(n_sys, options, out)
                 : tt::rk45_geometry<float, tt::Model204<float>>(n_sys, options, out);
    case tt::kModel200:
      return f64 ? tt::rk45_geometry_m200_f64(n_sys, options, out)
                 : tt::rk45_geometry_m200(n_sys, options, out);
    case tt::kModelDummy:
      return f64 ? tt::rk45_geometry_dummy_f64(n_sys, options, out)
                 : tt::rk45_geometry_dummy(n_sys, options, out);
    default:
      return tt::kNoInstance;
  }
}

#ifdef TT_RK45_PHASES
// The model and scalar of the last launch: whose probe records to read.
static int32_t probe_model = tt::kModel204, probe_f64 = 0;
#endif

// Enqueues the instance of (model, f64, options) on `stream`; returns the
// CUDA error code (0 on success; kNoInstance for a set without one).
extern "C" int tt_rk45_launch(const void* args, int32_t f64, void* stream) {
  const int32_t model = f64 ? static_cast<const tt::Rk45Args<double>*>(args)->model
                            : static_cast<const tt::Rk45Args<float>*>(args)->model;
  TT_PROBE(probe_model = model; probe_f64 = f64;)
  switch (model) {
    case tt::kModel204:
      return f64 ? tt::rk45_launch_f64(args, stream)
                 : tt::rk45_launch<float, tt::Model204<float>>(
                       static_cast<const tt::Rk45Args<float>*>(args), stream);
    case tt::kModel200:
      return f64 ? tt::rk45_launch_m200_f64(args, stream) : tt::rk45_launch_m200(args, stream);
    case tt::kModelDummy:
      return f64 ? tt::rk45_launch_dummy_f64(args, stream) : tt::rk45_launch_dummy(args, stream);
    default:
      return tt::kNoInstance;
  }
}

#ifdef TT_RK45_PHASES
// Copies the first n_warps warps' probe records of the last launch into
// `out`.
extern "C" int tt_rk45_probe_read(unsigned long long* out, int n_warps) {
  switch (probe_model) {
    case tt::kModel204:
      return probe_f64 ? tt::rk45_probe_read_f64(out, n_warps) : tt::rk45_probe_copy(out, n_warps);
    case tt::kModel200:
      return probe_f64 ? tt::rk45_probe_read_m200_f64(out, n_warps)
                       : tt::rk45_probe_read_m200(out, n_warps);
    default:
      return probe_f64 ? tt::rk45_probe_read_dummy_f64(out, n_warps)
                       : tt::rk45_probe_read_dummy(out, n_warps);
  }
}
#endif
#endif
