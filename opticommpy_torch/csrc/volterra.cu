// Decision-directed Volterra LMS equalizer (2nd or 3rd order) over a batch
// of independent real signals, hand-written for Hopper (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/volterra_pallas.py, `_kernel` (launched
// by `_volterra_run`, serving `volterra_pallas`).
//
// What bounds it on an H100: the recurrence.  Symbol k's decision sets the
// tap update that shapes symbol k+1's output, so each signal is a serial
// chain per symbol: the tap products, the tap sum over Q taps (13 + 49 +
// 125 = 187 at 13 / 7 / 5 taps, order 3), the slicer, the error and Q tap
// updates.  It reads n1 samples and a reference per symbol and writes two
// numbers; ~6 Q operations per symbol are far below the FP32 peak at the
// chain's pace.  The time is the latency of one symbol's step (and, where
// a lane issues more than that, its instructions) times the symbols.
//
// What held the first version back (one warp per signal, lane l holding
// flat taps l + 32 s; ~600 cycles per symbol at path H's 8 x 65,536): every
// symbol ran as a chain, also the decision-directed symbols after training,
// whose taps no longer change (94% of path H's); two true divisions on the
// chain (the slicer's and g / 7, ~58 cycles each); 24 feature shuffles per
// symbol in the chain's loop, order selects on every slot, two dead slots
// per lane at 187 taps; the window read from device memory one symbol
// ahead; the training / decision branches on every symbol.
//
// Design:
//   - One CTA of kWarps = 4 warps per signal.  The adapting ranges (training,
//     and decision-directed with fulltime) are a chain per symbol; they run
//     on a warp whose 32 lanes hold the flat taps grouped by order (h1's
//     lanes, then h2's, then h3's), so a lane's gain (g, g / 2 or g / 7) is
//     picked once per symbol, S slots a lane, S the least that fits (7 at
//     13 / 7 / 5, order 3: 27 lanes busy).  Each lane sums its products by a
//     tree and the lanes by a butterfly.  Every warp runs this chain on the
//     same inputs (no condition on the warp, so no divergence check before
//     each shuffle) and thread 0 writes the outputs.  The host builds the
//     layout (kernels/volterra.py, lane_layout): per lane and slot the
//     three window indices of the feature (n1 stands for 1.0, n1 + 1 for
//     0.0: a dead slot's feature is 0 and its tap stays 0) and its flat tap.
//   - Inputs staged ahead: a chunk's samples (with the next chunk's first
//     window) and references are copied with cp.async (stage.cuh) while the
//     previous chunk runs, then spread into one row per symbol, [the n1
//     window samples, 1.0, 0.0]; a lane keeps the shared addresses of its
//     features' operands in the next row and loads them first each step:
//     they do not depend on the chain.
//   - No division on the chain.  The slicer clip(rint((y - lo) / step), 0,
//     top) is a monotone step function of y, so it is the count of host
//     thresholds at or below y (kernels/volterra.py, slicer_thresholds: the
//     least float32 y of each level, found with the slicer's own float32
//     operations) and the level a tree of selects; more than 16 levels keep
//     the true division.  g / 7 is q0 = g * RN(1/7) corrected by one FMA on
//     its exact remainder (q0 itself where it is 0 or infinite), which
//     equals __fdiv_rn(g, 7) on every float32 input: chip_smoke.py checks
//     both replacements on all 2^32 inputs (volterra_exact_check).
//   - The decision-directed range without update (the taps fixed) is no
//     chain: at a compiled tap configuration (Cfg: 13 / 7 / 5 at orders 2
//     and 3, the equalizer of chip_smoke.py's path H) every thread takes
//     whole symbols, two at a time, each feature at a constant index of the
//     window in registers and the taps broadcast from shared memory, summed
//     in the layout's order; elsewhere each warp takes blocks of four
//     symbols in the lanes' layout.
//   - A chunk's training symbols and its decision-directed ones run in
//     separate loops, instantiated per rule (reference, slicer), so a
//     symbol's step has no branch on them; y and the error power of a chunk
//     are gathered in shared memory and written out with coalesced stores.
// The products and sums use the _rn intrinsics, so nvcc forms no FMA, and
// the plain version in opticommpy_torch/kernels/volterra.py sums the same
// products in the same tree order, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "stage.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;             // warps of a CTA (a CTA per signal)
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxLevels = 16;        // slicer levels decided by thresholds
constexpr int kMaxSlots = 32;         // the largest instance's slots
constexpr int kChunkMax = 256;        // most symbols per staged chunk
constexpr long long kBudget = 96 * 1024;  // staged bytes per CTA

struct VolterraArgs {
  int n_batch;
  const float* sig;  // (n_batch, sig_len)
  long long sig_len;
  int n_sym, sps;
  const float* ref;  // (n_batch, n_sym)
  int n1, n_q;
  const int* table;  // (kWarp, S, 4): a, b, c, flat tap (-1: none); then (kWarp,) order
  int n_levels;
  const float* thr;  // (kMaxLevels - 1,) thresholds, then (kMaxLevels,) levels
  float lo, step, top, mu;
  int n_train, fulltime;
  const float* h0;  // (n_batch, n_q)
  float *h_out, *y, *mse;
  int chunk;
};

// q0 = g * RN(1/7) and one FMA on its exact remainder: RN(g / 7).  Where
// q0 is 0 (a zero or tiny g; the correction would lose -0's sign) or
// infinite (the remainder would be NaN), q0 is already the quotient.
__device__ __forceinline__ float div7(float g) {
  const float r = __int_as_float(0x3e124925);  // RN(1/7)
  const float q0 = __fmul_rn(g, r);
  const float q = __fmaf_rn(__fmaf_rn(-q0, 7.0f, g), r, q0);
  return (q0 == 0.0f || fabsf(q0) == CUDART_INF_F) ? q0 : q;
}

// s[i] += s[i + H] for i < H and i + H < N (the live entries), then the
// level H / 2: the pairwise tree over N entries, every index a constant
template <int H, int N>
struct Tree {
  static __device__ __forceinline__ void levels(float* s) {
#pragma unroll
    for (int i = 0; i < H; ++i)
      if (i + H < N) s[i] = __fadd_rn(s[i], s[i + H]);
    Tree<H / 2, (N < H ? N : H)>::levels(s);
  }
};

template <int N>
struct Tree<0, N> {
  static __device__ __forceinline__ void levels(float*) {}
};

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// the tree's levels below kWarp across the lanes of a signal: lane j adds
// lane j ^ H's partial sum; both lanes of a pair add the same two numbers
template <int H>
struct Butterfly {
  static __device__ __forceinline__ float sum(float v) {
    return Butterfly<H / 2>::sum(__fadd_rn(v, __shfl_xor_sync(kFull, v, H)));
  }
};

template <>
struct Butterfly<0> {
  static __device__ __forceinline__ float sum(float v) { return v; }
};

// the level of the NL-level grid slicer: a tree of selects on the
// predicates y >= thr[i] (thresholds ascending, so p[i] implies p[i - 1])
template <int NL>
__device__ __forceinline__ float pick(float y, const float* thr, const float* lev) {
  bool p[NL - 1];
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) p[i] = y >= thr[i];
  float v[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) v[i] = lev[i];
#pragma unroll
  for (int w = 1; w < NL; w *= 2)  // v[i] covers levels i .. i + 2w - 1
#pragma unroll
    for (int i = 0; i + w < NL; i += 2 * w) v[i] = p[i + w - 1] ? v[i + w] : v[i];
  return v[0];
}

enum Decide { kRef, kPick4, kPick16, kDivide };

struct Step {  // the run-time constants of a symbol's step
  float lo, step, top, mu;
  float thr[kMaxLevels - 1], lev[kMaxLevels];
};

// The target of output y: the reference (training) or the slicer's level.
template <int DECIDE>
__device__ __forceinline__ float decide(float y, float r, const Step& c) {
  if (DECIDE == kRef) return r;
  if (DECIDE == kPick4) return pick<4>(y, c.thr, c.lev);
  if (DECIDE == kPick16) return pick<16>(y, c.thr, c.lev);
  float kq = rintf(__fdiv_rn(__fsub_rn(y, c.lo), c.step));
  kq = fminf(fmaxf(kq, 0.0f), c.top);
  return __fadd_rn(__fmul_rn(kq, c.step), c.lo);
}

// Slot s's feature at the row rw: (x[a] x[b]) x[c]
template <int S>
__device__ __forceinline__ float feature(const float* rw, const int* off, int s) {
  return __fmul_rn(__fmul_rn(rw[off[3 * s]], rw[off[3 * s + 1]]), rw[off[3 * s + 2]]);
}

// y = the taps' products with the features, summed by the lane's tree and
// the signal's butterfly
template <int S>
__device__ __forceinline__ float output(const float* h, const float* phi) {
  float p[S];
#pragma unroll
  for (int s = 0; s < S; ++s) p[s] = __fmul_rn(h[s], phi[s]);
  Tree<pow2_at_least(S) / 2, S>::levels(p);
  return Butterfly<kWarp / 2>::sum(p[0]);
}

// A shared-memory load at a 32-bit shared address.
__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// a if p else b, as a select (the compiler would branch around b's work)
__device__ __forceinline__ float select(bool p, float a, float b) {
  float v;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}\n"
      : "=f"(v)
      : "f"(a), "f"(b), "r"((unsigned)p));
  return v;
}

// Symbols kk0 .. kk1 - 1 of a chunk where the taps adapt.  adr[3 s + u] is
// the shared address of operand u of slot s's feature in the next symbol's
// row (each step adds `step`, a row's bytes), rb the references, ys / ms
// the outputs (written where `writer`).  phi holds symbol kk0's features on
// entry and kk1's on exit.  The next symbol's features are loaded first:
// they do not depend on this symbol's chain.
template <int S, int DECIDE>
__device__ __forceinline__ void run(float* h, float* phi, unsigned* adr, unsigned step,
                                    float gsel, const float* rb, float& r, float* ys, float* ms,
                                    int kk0, int kk1, const Step& c, bool writer) {
  for (int kk = kk0; kk < kk1; ++kk) {
    float pn[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      pn[s] = __fmul_rn(__fmul_rn(lds(adr[3 * s]), lds(adr[3 * s + 1])), lds(adr[3 * s + 2]));
#pragma unroll
    for (int i = 0; i < 3 * S; ++i) adr[i] += step;
    float rnext = 0.0f;
    if (DECIDE == kRef) rnext = rb[kk + 1];
    const float y = output<S>(h, phi);
    const float e = __fsub_rn(decide<DECIDE>(y, r, c), y);
    const float g = __fmul_rn(e, c.mu);
    // order 1: g; 2: g / 2; 3: g / 7 (gsel 1, 0.5 or 0)
    const float g12 = gsel == 1.0f ? g : __fmul_rn(0.5f, g);
    const float gq = select(gsel == 0.0f, div7(g), g12);
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = __fadd_rn(h[s], __fmul_rn(gq, phi[s]));
    if (writer) {
      ys[kk] = y;
      ms[kk] = __fmul_rn(e, e);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) phi[s] = pn[s];
    r = rnext;
  }
}

// Symbols kk0 .. kk1 - 1 with the taps fixed (decision-directed without
// update): no symbol depends on another, so kUnroll symbols go through the
// warp together and their latencies overlap.
constexpr int kUnroll = 4;

template <int S, int DECIDE, int U>
__device__ __forceinline__ void fixed_block(const float* h, const int* off, const float* rows,
                                            int rstride, float* ys, float* ms, int kk,
                                            const Step& c, bool writer) {
  float y[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float* rw = rows + (kk + u) * rstride;
    float phi[S];
#pragma unroll
    for (int s = 0; s < S; ++s) phi[s] = feature<S>(rw, off, s);
    y[u] = output<S>(h, phi);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float e = __fsub_rn(decide<DECIDE>(y[u], 0.0f, c), y[u]);
    if (writer) {
      ys[kk + u] = y[u];
      ms[kk + u] = __fmul_rn(e, e);
    }
  }
}

template <int S, int DECIDE>
__device__ __forceinline__ void run_fixed(const float* h, const int* off, const float* rows,
                                          int rstride, float* ys, float* ms, int kk0, int kk1,
                                          const Step& c, bool writer) {
  // warp wp takes blocks wp, wp + kWarps, ... of kUnroll symbols, then the
  // symbols after the last whole block one at a time, in the same turns
  const int wp = threadIdx.x / kWarp;
  const int full = kk0 + (kk1 - kk0) / kUnroll * kUnroll;
  for (int kk = kk0 + wp * kUnroll; kk < full; kk += kWarps * kUnroll)
    fixed_block<S, DECIDE, kUnroll>(h, off, rows, rstride, ys, ms, kk, c, writer);
  for (int kk = full + wp; kk < kk1; kk += kWarps)
    fixed_block<S, DECIDE, 1>(h, off, rows, rstride, ys, ms, kk, c, writer);
}

// Tap configurations compiled in (13 / 7 / 5 taps, the repository's bench
// equalizer, at orders 2 and 3): S is the layout's slots at 32 lanes.
// Cfg<0> is the run-time layout.
template <int CFG>
struct Cfg {
  static constexpr int N1 = 0, N2 = 0, N3 = 0, ORD = 0, S = 0;
};
template <>
struct Cfg<1> {
  static constexpr int N1 = 13, N2 = 7, N3 = 5, ORD = 3, S = 7;
};
template <>
struct Cfg<2> {
  static constexpr int N1 = 13, N2 = 7, N3 = 5, ORD = 2, S = 2;
};

// y of kV symbols at a compiled configuration, each all on one lane: the
// windows x[u] in registers, every feature at a constant index (an order-3
// feature is its pair product P[i][j] = x[i] x[j] times x[m], the same two
// roundings as (x[i] x[j]) x[m]), the taps hs[v * S + s] of lane v, slot s
// broadcast from shared memory (each load serves the kV symbols), and the
// sums in the layout's order: each lane's tree over its slots, then the
// tree over the lanes.  A dead slot's feature is 0.0, so it adds hs * 0.0,
// as the adapting loop does.
constexpr int kV = 2;

template <int CFG>
__device__ __forceinline__ void compiled_output(const float (*x)[Cfg<CFG>::N1], const float* hs,
                                                float* y) {
  using C = Cfg<CFG>;
  constexpr int S = C::S, N2 = C::N2, N3 = C::N3;
  constexpr int C1 = C::N1, C2 = N2 * N2, C3 = C::ORD == 3 ? N3 * N3 * N3 : 0;
  constexpr int L1 = (C1 + S - 1) / S, L2 = (C2 + S - 1) / S, L3 = (C3 + S - 1) / S;
  constexpr int T2 = (C::N1 - N2) / 2, T3 = (C::N1 - N3) / 2;
  float P[kV][N3 * N3];
#pragma unroll
  for (int u = 0; u < kV; ++u)
#pragma unroll
    for (int i = 0; i < N3; ++i)
#pragma unroll
      for (int j = 0; j < N3; ++j) P[u][i * N3 + j] = __fmul_rn(x[u][T3 + i], x[u][T3 + j]);
  float part[kV][kWarp];
#pragma unroll
  for (int v = 0; v < kWarp; ++v) {
    float p[kV][S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float hv = hs[v * S + s];
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        float f = 0.0f;
        if (v < L1) {
          const int t = v * S + s;
          if (t < C1) f = x[u][t];
        } else if (v < L1 + L2) {
          const int t = (v - L1) * S + s;
          if (t < C2) f = __fmul_rn(x[u][T2 + t / N2], x[u][T2 + t % N2]);
        } else if (v < L1 + L2 + L3) {
          const int t = (v - L1 - L2) * S + s;
          if (t < C3) f = __fmul_rn(P[u][t / N3], x[u][T3 + t % N3]);
        }
        p[u][s] = __fmul_rn(hv, f);
      }
    }
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      Tree<pow2_at_least(S) / 2, S>::levels(p[u]);
      part[u][v] = p[u][0];
    }
  }
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    Tree<kWarp / 2, kWarp>::levels(part[u]);
    y[u] = part[u][0];
  }
}

// The decision-directed range without update at a compiled configuration:
// the taps (in hs, written by warp 0) are fixed, so each thread
// takes whole symbols, kV at a time (kk, kk + kThreads, ...), reading each
// window's n1 samples from the symbol's row.
template <int CFG, int DECIDE>
__device__ __forceinline__ void run_compiled(const float* hs, const float* rows, int rstride,
                                             float* ys, float* ms, int kk0, int kk1,
                                             const Step& c) {
  using C = Cfg<CFG>;
  for (int kk = kk0 + (int)threadIdx.x; kk < kk1; kk += kV * kThreads) {
    float x[kV][C::N1], y[kV];
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      // a symbol past the range reads the range's last row and is not kept
      const float* rw = rows + min(kk + u * kThreads, kk1 - 1) * rstride;
#pragma unroll
      for (int t = 0; t < C::N1; ++t) x[u][t] = rw[t];
    }
    compiled_output<CFG>(x, hs, y);
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int k = kk + u * kThreads;
      const float e = __fsub_rn(decide<DECIDE>(y[u], 0.0f, c), y[u]);
      if (k < kk1) {
        ys[k] = y[u];
        ms[k] = __fmul_rn(e, e);
      }
    }
  }
}

// The staging area in shared memory: the samples of a chunk and the next
// chunk's first window (one slot, refilled once spread into rows), the
// references (two slots), y and the error power, the taps (for the fixed
// ranges); then the rows, chunk + 1 of them, each [window, 1.0, 0.0].
struct Layout {
  long long ws, rs, ys, hs, rows;  // floats
  long long bytes;
};

__host__ __device__ inline Layout layout(int chunk, int sps, int n1) {
  Layout l;
  l.ws = ((long long)chunk * sps + n1 + 3 + 3) / 4 * 4;
  l.rs = (chunk + 4 + 3) / 4 * 4;
  l.ys = (chunk + 3) / 4 * 4;
  l.hs = kWarp * kMaxSlots;
  l.rows = ((long long)(chunk + 1) * (n1 + 2) + 3) / 4 * 4;
  l.bytes = 4 * (l.ws + 2 * l.rs + 2 * l.ys + l.hs + l.rows);
  return l;
}

// One CTA per signal.  Every warp runs the adapting ranges (lane j holds
// the taps of slot row j of the layout): the same inputs give each warp the
// same taps, and with no condition on the warp the compiler puts no
// divergence check before each shuffle; thread 0 writes the outputs.  Every
// warp stages, spreads rows and runs the fixed-tap ranges.
template <int S, int CFG>
__global__ void __launch_bounds__(kThreads) volterra_kernel(const VolterraArgs a) {
  const int n_sym = a.n_sym, sps = a.sps, n1 = a.n1, n_train = a.n_train, chunk = a.chunk;
  const int w = n1 + 2;  // a row: the window, 1.0, 0.0
  const int tid = threadIdx.x, lane = tid % kWarp;
  const int b = blockIdx.x;
  const float* __restrict__ x = a.sig + (size_t)b * a.sig_len;
  const float* __restrict__ ref = a.ref + (size_t)b * n_sym;

  const Layout L = layout(chunk, sps, n1);
  extern __shared__ float4 smem4[];
  float* const wbuf = reinterpret_cast<float*>(smem4);  // [ws]
  float* const rring = wbuf + L.ws;                     // [2][rs]
  float* const ys = rring + 2 * L.rs;                   // [ys]
  float* const ms = ys + L.ys;                          // [ys]
  float* const hs = ms + L.ys;                          // [hs]
  float* const rows = hs + L.hs;                        // [(chunk + 1) * w]

  // this lane's slots: the offsets of their features' samples in a row,
  // their taps, and the lane's order
  const int* tl = a.table + (size_t)lane * S * 4;
  const int order = a.table[kWarp * S * 4 + lane];
  const float gsel = order == 1 ? 1.0f : (order == 2 ? 0.5f : 0.0f);
  int off[3 * S];
  float h[S], phi[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int u = 0; u < 3; ++u) off[3 * s + u] = tl[4 * s + u];
    const int q = tl[4 * s + 3];
    h[s] = q >= 0 ? a.h0[(size_t)b * a.n_q + q] : 0.0f;
  }
  Step c;
  c.lo = a.lo;
  c.step = a.step;
  c.top = a.top;
  c.mu = a.mu;
#pragma unroll
  for (int i = 0; i < kMaxLevels - 1; ++i) c.thr[i] = a.thr[i];
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) c.lev[i] = a.thr[kMaxLevels - 1 + i];

  const int n_chunks = (n_sym + chunk - 1) / chunk;
  // windows staged for chunk ci: its symbols and the next chunk's first
  auto n_win = [&](int ci) { return min(chunk + 1, n_sym - ci * chunk); };
  // every thread issues the copies (stage.cuh: the whole CTA calls with
  // the same arguments)
  auto issue = [&](int ci) {
    if (ci < n_chunks) {
      const int k0 = ci * chunk;
      stage::issue_values(wbuf, x + (size_t)k0 * sps, (n_win(ci) - 1) * sps + n1);
      if (k0 < n_train)
        stage::issue_values(rring + (ci & 1) * L.rs, ref + k0, min(chunk, n_sym - k0));
    }
    stage::commit();
  };
  // the spread: thread (lr, tt) writes entry tt of rows lr, lr + rpp, ...
  const int rpp = kThreads / w;
  const int lr = tid / w, tt = tid - lr * w;
  issue(0);

  float r = 0.0f;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int k0 = ci * chunk;
    const int cnt = min(chunk, n_sym - k0);
    stage::wait<0>();
    __syncthreads();  // chunk ci's samples and references visible to every thread
    const int nw = n_win(ci);
    const float* base = wbuf + stage::misalign_of(x + (size_t)k0 * sps);
    if (lr < rpp) {
#pragma unroll 4
      for (int k = lr; k < nw; k += rpp)
        rows[k * w + tt] = tt < n1 ? base[k * sps + tt] : (tt == n1 ? 1.0f : 0.0f);
    }
    __syncthreads();  // the rows are written; the sample slot is free
    issue(ci + 1);
    const float* rb = rring + (ci & 1) * L.rs + stage::misalign_of(ref + k0);
    // the chunk's training symbols, then the decision-directed ones
    const int kk_dd = min(max(n_train - k0, 0), cnt);
    const int rule = a.n_levels <= 4 ? kPick4 : (a.n_levels <= kMaxLevels ? kPick16 : kDivide);
    {  // every warp adapts, warp 0's thread 0 writing the outputs
      if (ci == 0) {  // later chunks' first features come from the last row
#pragma unroll
        for (int s = 0; s < S; ++s) phi[s] = feature<S>(rows, off, s);
      }
      unsigned adr[3 * S];  // row 1's operands
#pragma unroll
      for (int i = 0; i < 3 * S; ++i)
        adr[i] = (unsigned)__cvta_generic_to_shared(rows + w + off[i]);
      const unsigned step = 4u * w;
      if (kk_dd > 0) r = rb[0];
      const bool first = tid == 0;
      run<S, kRef>(h, phi, adr, step, gsel, rb, r, ys, ms, 0, kk_dd, c, first);
      if (kk_dd < cnt && a.fulltime) {
        if (rule == kPick4)
          run<S, kPick4>(h, phi, adr, step, gsel, rb, r, ys, ms, kk_dd, cnt, c, first);
        else if (rule == kPick16)
          run<S, kPick16>(h, phi, adr, step, gsel, rb, r, ys, ms, kk_dd, cnt, c, first);
        else
          run<S, kDivide>(h, phi, adr, step, gsel, rb, r, ys, ms, kk_dd, cnt, c, first);
      }
    }
    if (kk_dd < cnt && !a.fulltime) {
      if constexpr (CFG > 0) {
        if (tid < kWarp) {
#pragma unroll
          for (int s = 0; s < S; ++s) hs[lane * S + s] = h[s];
        }
        __syncthreads();  // hs written
        if (rule == kPick4)
          run_compiled<CFG, kPick4>(hs, rows, w, ys, ms, kk_dd, cnt, c);
        else if (rule == kPick16)
          run_compiled<CFG, kPick16>(hs, rows, w, ys, ms, kk_dd, cnt, c);
        else
          run_compiled<CFG, kDivide>(hs, rows, w, ys, ms, kk_dd, cnt, c);
      } else {
        const bool writer = lane == 0;
        if (rule == kPick4)
          run_fixed<S, kPick4>(h, off, rows, w, ys, ms, kk_dd, cnt, c, writer);
        else if (rule == kPick16)
          run_fixed<S, kPick16>(h, off, rows, w, ys, ms, kk_dd, cnt, c, writer);
        else
          run_fixed<S, kDivide>(h, off, rows, w, ys, ms, kk_dd, cnt, c, writer);
      }
    }
    __syncthreads();  // the chunk's outputs are staged
    for (int i = tid; i < cnt; i += kThreads) {
      a.y[(size_t)b * n_sym + k0 + i] = ys[i];
      a.mse[(size_t)b * n_sym + k0 + i] = ms[i];
    }
  }
  if (tid < kWarp) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int q = tl[4 * s + 3];
      if (q >= 0) a.h_out[(size_t)b * a.n_q + q] = h[s];
    }
  }
}

// Symbols per chunk: kChunkMax, halved while the staging area is over the
// budget or half a chunk still holds every symbol.
int chunk_symbols(int n_sym, int sps, int n1) {
  int chunk = kChunkMax;
  while (chunk > 1 && (layout(chunk, sps, n1).bytes > kBudget || chunk / 2 >= n_sym))
    chunk >>= 1;
  return chunk;
}

template <int S, int CFG = 0>
int launch(const VolterraArgs& a, cudaStream_t stream) {
  auto kernel = volterra_kernel<S, CFG>;
  const size_t smem = layout(a.chunk, a.sps, a.n1).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a.n_batch, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// every float32 bit pattern in [start, start + count): div7 against
// __fdiv_rn(x, 7), and the threshold slicer against the division slicer;
// bad[0], bad[1] count the inputs where they differ, bad[2 ..] keep up to
// kSamples of each (bit patterns, bad[2 + 2 kSamples] counting the kept)
constexpr int kSamples = 4;

__global__ void check_kernel(unsigned long long start, unsigned long long count,
                             const float* thr, int n_levels, float lo, float step, float top,
                             unsigned long long* bad) {
  unsigned long long n_div = 0, n_pick = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < count; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned bits = (unsigned)(start + i);
    const float x = __uint_as_float(bits);
    const float q = div7(x), ref = __fdiv_rn(x, 7.0f);
    if (__float_as_uint(q) != __float_as_uint(ref) && !(isnan(q) && isnan(ref))) {
      ++n_div;
      const unsigned long long k = atomicAdd(bad + 2 + 2 * kSamples, 1ull);
      if (k < kSamples) bad[2 + k] = bits;
    }
    float kq = rintf(__fdiv_rn(__fsub_rn(x, lo), step));
    kq = fminf(fmaxf(kq, 0.0f), top);
    const float t = __fadd_rn(__fmul_rn(kq, step), lo);
    const float u = n_levels <= 4 ? pick<4>(x, thr, thr + kMaxLevels - 1)
                                  : pick<16>(x, thr, thr + kMaxLevels - 1);
    if (__float_as_uint(t) != __float_as_uint(u)) {
      ++n_pick;
      const unsigned long long k = atomicAdd(bad + 3 + 2 * kSamples, 1ull);
      if (k < kSamples) bad[2 + kSamples + k] = bits;
    }
  }
  atomicAdd(bad, n_div);
  atomicAdd(bad + 1, n_pick);
}

}  // namespace

// One Volterra pass over n_batch real signals.  sig (n_batch, sig_len),
// ref (n_batch, n_sym), h0/h_out (n_batch, n_q) and y, mse (n_batch, n_sym)
// are float32; n1, n2, n3 taps at order 2 or 3; table (32 * slots * 4 +
// 32) int32 is the lane layout of kernel_table; thr (31,) float32 the
// slicer's 15 thresholds and 16 levels (n_levels <= 16; more levels divide:
// lo, step, top).  The PAM slicer is clip(rint((y - lo) / step), 0, top) *
// step + lo.  Launches on `stream` and returns cudaGetLastError().
extern "C" int volterra_launch(int n_batch, const void* sig, long long sig_len, int n_sym,
                               int sps, const void* ref, int n1, int n2, int n3, int order,
                               int n_q, int slots,
                               const void* table, int n_levels, const void* thr, float lo,
                               float step, float top, float mu, int n_train, int fulltime,
                               const void* h0, void* h_out, void* y, void* mse,
                               void* stream) {
  if (n_batch < 1 || n1 < 1 || n1 > 32 || n_q < 1 || sps < 1 || n_levels < 1 || n_sym < 0)
    return (int)cudaErrorInvalidValue;
  const VolterraArgs a{n_batch, (const float*)sig, sig_len, n_sym, sps, (const float*)ref,
                       n1, n_q, (const int*)table, n_levels, (const float*)thr, lo, step,
                       top, mu, n_train, fulltime, (const float*)h0, (float*)h_out,
                       (float*)y, (float*)mse, chunk_symbols(n_sym, sps, n1)};
  cudaStream_t s = (cudaStream_t)stream;
  auto is = [&](auto cfg) {  // a compiled configuration
    using C = decltype(cfg);
    return n1 == C::N1 && n2 == C::N2 && n3 == C::N3 && order == C::ORD && slots == C::S;
  };
  if (is(Cfg<1>{})) return launch<Cfg<1>::S, 1>(a, s);
  if (is(Cfg<2>{})) return launch<Cfg<2>::S, 2>(a, s);
  switch (slots) {
#define VOLTERRA_CASE(n) \
  case n:                \
    return launch<n>(a, s);
    VOLTERRA_CASE(1)
    VOLTERRA_CASE(2)
    VOLTERRA_CASE(3)
    VOLTERRA_CASE(4)
    VOLTERRA_CASE(5)
    VOLTERRA_CASE(6)
    VOLTERRA_CASE(7)
    VOLTERRA_CASE(8)
    VOLTERRA_CASE(10)
    VOLTERRA_CASE(13)
    VOLTERRA_CASE(16)
    VOLTERRA_CASE(24)
    VOLTERRA_CASE(32)
#undef VOLTERRA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The exactness checks over the float32 bit patterns [start, start +
// count): bad (12,) uint64, zeroed by the caller: bad[0] counts inputs where
// div7 differs from __fdiv_rn(x, 7), bad[1] those where the threshold slicer
// (thr as for volterra_launch) differs from the division slicer; bad[2 ..
// 5] and bad[6 .. 9] keep up to four of each.  Launches on `stream`.
extern "C" int volterra_exact_check(unsigned long long start, unsigned long long count,
                                    const void* thr, int n_levels, float lo, float step,
                                    float top, void* bad, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      start, count, (const float*)thr, n_levels, lo, step, top, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
