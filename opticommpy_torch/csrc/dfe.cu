// Decision-feedback / feedforward LMS equalizer (DFE / FFE) over a batch of
// independent signals, hand-written for Hopper (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/dfe_pallas.py, `_kernel` (launched by
// `_dfe_run`, serving `dfe_pallas` and `ffe_pallas`).
//
// What bounds it on an H100: the recurrence.  The decision on symbol k
// enters the feedback buffer and the tap update that equalize symbol k+1,
// so each signal is a serial chain per symbol: the tap products, the tap
// sums, the slicer (a true division), the error and the update.  It reads
// one window of nTapsFF samples and one reference per symbol and writes
// two numbers: far below the card's memory rate at the chain's pace, and
// its ~6 operations per tap are as far below the FP32 peak.  The time is
// the latency of one symbol's step times the number of symbols.
//
// What held the first version back (one thread per signal, ~940 cycles per
// symbol at 8 x 65,536 PAM4 symbols; probes in PERF.md): its tap sums
// went through local memory (the tree's level loop, h /= 2, did not unroll,
// so s[i + h] was indexed at run time: a 64-368 byte stack frame), and each
// symbol re-read its whole window and its reference from device memory one
// symbol ahead, every lane of the warp on its own row (~355 cycles of the
// 940).  With those gone a single lane still issued ~245 instructions per
// symbol, with branches on the rule, the slicer and the update (~530
// cycles): on one warp the issue of the step, not its arithmetic's
// latency, sets the time.
//
// Design:
//   - One warp per signal, so a batch of 132 links fills the 132 SMs;
//     8 lanes of it run the signal's chain, lane j holding taps j + 8 q of
//     each tap vector, and the whole warp stages and writes out.  (2 and 4
//     lanes were slower; PERF.md.)
//   - Each tap sum is the pairwise tree of the plain version (s[i] +=
//     s[i + h], h = P/2 ... 1, unrolled at compile time so it stays in
//     registers): the levels h >= 8 pair taps of one lane, the last three
//     pair lanes and run as a butterfly of shuffles, after which every lane
//     holds the same sum and decides the same symbol.  Splitting the taps
//     divides the products, updates and window loads a lane issues per
//     symbol by eight; the shuffles add 3 x ~24 cycles to the chain.  The
//     decision buffer shifts across the lanes with one shuffle per slot.
//   - A chunk's training symbols and its decision-directed ones run in
//     separate loops, instantiated per rule (reference, argmin, PAM or QAM
//     grid) and per update (always while training; fulltime or not after),
//     so a symbol's step has no branch on them.
//   - The grid slicer's quotient (y - lo) / step stays a true division
//     (~58 cycles on the chain): a reciprocal with one FMA correction was
//     ~7% faster at PAM4 (PERF.md), not enough to carry the check over every
//     float32 input that bit equality with the plain version would need.
//   - Inputs staged ahead of the recurrence: the windows and references of
//     a chunk of up to 1024 symbols are copied with cp.async into a
//     double-buffered ring in shared memory while the chain works on the
//     previous chunk (stage.cuh, issue_values: a float row starts 0-3
//     values above a 16-byte boundary, a complex64 row 0-1); each lane reads
//     its window values a symbol ahead.  References are staged only for
//     chunks that train.
//   - y and the error power of a chunk are gathered in shared memory (every
//     lane of the group writes the same values, so none waits) and written
//     out with coalesced stores after the chunk.
//   - Tap counts are template parameters, powers of two at least as large
//     as the configuration's, the extra taps zero; zero taps added first
//     leave each sum as the tree over the next power of two, so the plain
//     version in opticommpy_torch/kernels/dfe.py, which pads to the
//     smallest one, adds in the same order.
// All arithmetic uses the _rn intrinsics, so nvcc forms no FMA, and rintf
// rounds half to even like torch.round: the kernel equals its plain version
// bit for bit.  The real
// instance (CPLX = false) serves PAM on real signals, where every
// imaginary plane of the complex instance stays zero.

#include <cuda_runtime.h>

#include <type_traits>

#include "stage.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxTable = 1024;
constexpr int kLanes = 8;  // lanes per signal
constexpr int kChunkMax = 1024;  // most symbols per staged chunk
constexpr long long kBudget = 160 * 1024;  // staged bytes per CTA

struct Num {  // the complex instance's value; the real one uses .re only
  float re, im;
};

__device__ __forceinline__ Num num(float v) { return Num{v, 0.0f}; }
__device__ __forceinline__ Num num(float2 v) { return Num{v.x, v.y}; }
__device__ __forceinline__ void put(float* p, Num v) { *p = v.re; }
__device__ __forceinline__ void put(float2* p, Num v) {
  *p = make_float2(v.re, v.im);
}

// the nearest of the levels lo + k step, k = 0 .. top; rintf rounds half to
// even like torch.round
__device__ __forceinline__ float quantize(float x, float lo, float step, float top) {
  float k = rintf(__fdiv_rn(__fsub_rn(x, lo), step));
  k = fminf(fmaxf(k, 0.0f), top);
  return __fadd_rn(__fmul_rn(k, step), lo);
}

// s[i] += s[i + H] for i < H, then the level H / 2: one level per
// instantiation, so every index is a constant
template <int H>
struct Tree {
  static __device__ __forceinline__ void levels(float* s) {
#pragma unroll
    for (int i = 0; i < H; ++i) s[i] = __fadd_rn(s[i], s[i + H]);
    Tree<H / 2>::levels(s);
  }
};

template <>
struct Tree<0> {
  static __device__ __forceinline__ void levels(float*) {}
};

// The tree's levels below H across the lanes of a group: lane j adds lane
// j ^ H's partial sum (H, H / 2, ..., 1); the lower lane of each pair adds
// as the tree does and the upper one the same two terms swapped, so every
// lane ends with the same sum
template <int H>
struct Butterfly {
  static __device__ __forceinline__ float sum(float v, unsigned mask) {
    return Butterfly<H / 2>::sum(__fadd_rn(v, __shfl_xor_sync(mask, v, H)), mask);
  }
};

template <>
struct Butterfly<0> {
  static __device__ __forceinline__ float sum(float v, unsigned) { return v; }
};

template <bool CPLX>
__device__ __forceinline__ Num load(const void* base, size_t i) {
  if (CPLX) return num(reinterpret_cast<const float2*>(base)[i]);
  return num(reinterpret_cast<const float*>(base)[i]);
}

template <bool CPLX>
__device__ __forceinline__ void store(void* base, size_t i, Num v) {
  if (CPLX)
    reinterpret_cast<float2*>(base)[i] = make_float2(v.re, v.im);
  else
    reinterpret_cast<float*>(base)[i] = v.re;
}

// y = sum over the taps of t*x (re: t.re x.re - t.im x.im, im: t.re x.im +
// t.im x.re) as one pairwise tree over P = V * kLanes taps: this lane holds
// taps j + kLanes q, q < V, so the levels from kLanes up are a tree over its
// own V products and the rest a butterfly over the group
template <bool CPLX, int V>
__device__ __forceinline__ Num dot(const Num* t, const Num* x, unsigned mask) {
  float sr[V], si[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (CPLX) {
      sr[i] = __fsub_rn(__fmul_rn(t[i].re, x[i].re), __fmul_rn(t[i].im, x[i].im));
      si[i] = __fadd_rn(__fmul_rn(t[i].re, x[i].im), __fmul_rn(t[i].im, x[i].re));
    } else {
      sr[i] = __fmul_rn(t[i].re, x[i].re);
    }
  }
  Tree<V / 2>::levels(sr);
  Num out{Butterfly<kLanes / 2>::sum(sr[0], mask), 0.0f};
  if (CPLX) {
    Tree<V / 2>::levels(si);
    out.im = Butterfly<kLanes / 2>::sum(si[0], mask);
  }
  return out;
}

// t += mu * (e * conj(x)) over the V taps of this lane
template <bool CPLX, int V>
__device__ __forceinline__ void update(Num* t, const Num* x, Num e, float mu) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (CPLX) {
      const float gr = __fadd_rn(__fmul_rn(e.re, x[i].re), __fmul_rn(e.im, x[i].im));
      const float gi = __fsub_rn(__fmul_rn(e.im, x[i].re), __fmul_rn(e.re, x[i].im));
      t[i].re = __fadd_rn(t[i].re, __fmul_rn(mu, gr));
      t[i].im = __fadd_rn(t[i].im, __fmul_rn(mu, gi));
    } else {
      t[i].re = __fadd_rn(t[i].re, __fmul_rn(mu, __fmul_rn(e.re, x[i].re)));
    }
  }
}

struct DfeArgs {
  int n_batch;
  const void* sig;  // (n_batch, sig_len)
  long long sig_len;
  int n_sym, sps;
  const void* ref;  // (n_batch, n_sym)
  const float *c_re, *c_im;
  int m_const, slicer;  // slicer: 0 argmin, 1 PAM levels, 2 square-QAM grid
  float lo, step, top;
  int n_ff, n_fb;  // n_fb = 0: no feedback (the FFE)
  float mu;
  int n_train, fulltime;
  const void *f0, *b0;
  void *f_out, *b_out, *y;
  float* mse;
  int chunk;  // symbols per staged chunk
};

// The staging area in shared memory: two window slots, two reference
// slots, y and the error power of one chunk.  Slot sizes are values of
// `vsize` bytes, each a multiple of 16 bytes.
struct Layout {
  long long ws, rs, ys, ms;  // values per slot (ms: floats)
  long long bytes;
};

__host__ __device__ inline Layout layout(int chunk, int sps, int n_ff,
                                         int vsize) {
  const long long per = 16 / vsize;
  Layout l;
  l.ws = ((long long)(chunk - 1) * sps + n_ff + 2 * per - 2) / per * per;
  l.rs = (chunk + 2 * per - 2) / per * per;
  l.ys = (chunk + per - 1) / per * per;
  l.ms = (chunk + 3) / 4 * 4;
  l.bytes = vsize * (2 * l.ws + 2 * l.rs + l.ys) + 4 * l.ms;
  return l;
}

// How a range of symbols decides and whether it updates the taps: the
// reference (training, which always updates), or a slicer.  Each range
// runs its own loop, so a symbol's step has no branch on either.
enum Decide { kRef, kArgmin, kPam, kQam };

// One lane's share of a signal's state: taps j + G q of each tap vector,
// their window values and decision-buffer entries, and which are in use.
template <int V, int VB>
struct Lane {
  Num f[V], w[V], bt[VB], d[VB];
  bool fv[V], bv[VB];
};

struct Step {  // the run-time constants of a symbol's step
  int sps, m_const;
  float lo, step, top, mu;
  unsigned mask;
  const float2* table;
};

// Symbols kk0 .. kk1 - 1 of a chunk of cnt: window values from wb (this
// lane's first), references from rb, y and the error power into ys / ms.
template <bool CPLX, int V, int VB, int PFB, int DECIDE, bool UPDATE, typename T>
__device__ __forceinline__ void run(Lane<V, VB>& s, Num& r, const T* wb, const T* rb,
                                    T* ys, float* ms, int kk0, int kk1, int cnt,
                                    const Step& c) {
  constexpr int G = kLanes;
  const int lane = threadIdx.x;
  for (int kk = kk0; kk < kk1; ++kk) {
    // the next symbol's window (and reference), off the recurrence's chain
    const bool more = kk + 1 < cnt;
    Num wn[V];
#pragma unroll
    for (int q = 0; q < V; ++q)
      wn[q] = (more && s.fv[q]) ? num(wb[(kk + 1) * c.sps + G * q]) : Num{0.0f, 0.0f};
    Num rn{0.0f, 0.0f};
    if (DECIDE == kRef && kk + 1 < kk1) rn = num(rb[kk + 1]);

    Num y = dot<CPLX, V>(s.f, s.w, c.mask);
    if (PFB > 0) {
      const Num yb = dot<CPLX, VB>(s.bt, s.d, c.mask);
      y.re = __fadd_rn(y.re, yb.re);
      if (CPLX) y.im = __fadd_rn(y.im, yb.im);
    }
    Num t;
    if (DECIDE == kRef) {
      t = r;
    } else if (DECIDE == kArgmin) {
      float best = 0.0f;
      int best_i = 0;
      for (int m = 0; m < c.m_const; ++m) {
        const float dr = __fsub_rn(y.re, c.table[m].x);
        float dd = __fmul_rn(dr, dr);
        if (CPLX) {
          const float di = __fsub_rn(y.im, c.table[m].y);
          dd = __fadd_rn(dd, __fmul_rn(di, di));
        }
        if (m == 0 || dd < best) {
          best = dd;
          best_i = m;
        }
      }
      t = Num{c.table[best_i].x, CPLX ? c.table[best_i].y : 0.0f};
    } else {
      t.re = quantize(y.re, c.lo, c.step, c.top);
      t.im = (CPLX && DECIDE == kQam) ? quantize(y.im, c.lo, c.step, c.top) : 0.0f;
    }
    const Num e{__fsub_rn(t.re, y.re), CPLX ? __fsub_rn(t.im, y.im) : 0.0f};
    if (UPDATE) {
      update<CPLX, V>(s.f, s.w, e, c.mu);
      if (PFB > 0) update<CPLX, VB>(s.bt, s.d, e, c.mu);
    }
    if (PFB > 0) {
      // the target enters at index 0 and index i takes i - 1: from the
      // previous lane's same slot, or at lane 0 from lane G - 1's slot
      // below; entries from n_fb on stay zero
      Num from[VB];
      const int src = (lane + G - 1) & (G - 1);
#pragma unroll
      for (int q = 0; q < VB; ++q) {
        from[q].re = __shfl_sync(c.mask, s.d[q].re, src);
        from[q].im = CPLX ? __shfl_sync(c.mask, s.d[q].im, src) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < VB; ++q) {
        const Num in = lane > 0 ? from[q] : (q == 0 ? t : from[q > 0 ? q - 1 : 0]);
        s.d[q] = s.bv[q] ? in : Num{0.0f, 0.0f};
      }
    }
    // every lane holds the same y and e: each writes them, so no lane waits
    put(ys + kk, y);
    float m2 = __fmul_rn(e.re, e.re);
    if (CPLX) m2 = __fadd_rn(m2, __fmul_rn(e.im, e.im));
    ms[kk] = m2;
#pragma unroll
    for (int q = 0; q < V; ++q) s.w[q] = wn[q];
    r = rn;
  }
}

template <bool CPLX, int PFF, int PFB>
__global__ void __launch_bounds__(kWarp) dfe_kernel(const DfeArgs a) {
  using T = typename std::conditional<CPLX, float2, float>::type;
  constexpr int G = kLanes;
  constexpr int V = PFF / G;                 // feedforward taps per lane
  constexpr int VB = PFB > 0 ? PFB / G : 1;  // feedback taps per lane
  static_assert(PFF % G == 0 && PFB % G == 0, "tap counts: multiples of kLanes");
  const int n_sym = a.n_sym, sps = a.sps, n_ff = a.n_ff, n_fb = a.n_fb;
  const int n_train = a.n_train, chunk = a.chunk;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;  // the signal
  const T* __restrict__ sig = reinterpret_cast<const T*>(a.sig) + (size_t)b * a.sig_len;
  const T* __restrict__ ref = reinterpret_cast<const T*>(a.ref) + (size_t)b * n_sym;
  T* __restrict__ y_out = reinterpret_cast<T*>(a.y) + (size_t)b * n_sym;
  float* __restrict__ mse_out = a.mse + (size_t)b * n_sym;
  __shared__ float2 table[kMaxTable];
  if (a.slicer == 0)  // visible after the first chunk's barrier
    for (int i = lane; i < a.m_const; i += blockDim.x)
      table[i] = make_float2(a.c_re[i], a.c_im[i]);

  const Layout L = layout(chunk, sps, n_ff, sizeof(T));
  extern __shared__ float4 smem4[];
  T* const wring = reinterpret_cast<T*>(smem4);  // [2][ws]
  T* const rring = wring + 2 * L.ws;             // [2][rs]
  T* const ys = rring + 2 * L.rs;                // [ys]
  float* const ms = reinterpret_cast<float*>(ys + L.ys);

  // lanes 0 .. G - 1 run the chain, lane j holding taps j + G q
  const bool runs = lane < G;
  const Step c{sps, a.m_const, a.lo, a.step, a.top, a.mu, (1u << G) - 1u, table};
  Lane<V, VB> st;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    st.fv[q] = runs && lane + G * q < n_ff;
    st.f[q] = st.fv[q] ? load<CPLX>(a.f0, (size_t)b * n_ff + lane + G * q)
                       : Num{0.0f, 0.0f};
  }
#pragma unroll
  for (int q = 0; q < VB; ++q) {
    st.bv[q] = PFB > 0 && runs && lane + G * q < n_fb;
    st.bt[q] = st.bv[q] ? load<CPLX>(a.b0, (size_t)b * n_fb + lane + G * q)
                        : Num{0.0f, 0.0f};
    st.d[q] = Num{0.0f, 0.0f};
  }

  const int n_chunks = (n_sym + chunk - 1) / chunk;
  auto issue = [&](int ci) {
    if (ci < n_chunks) {
      const int k0 = ci * chunk;
      const int cnt = min(chunk, n_sym - k0);
      stage::issue_values(wring + (ci & 1) * L.ws, sig + (size_t)k0 * sps,
                          (cnt - 1) * sps + n_ff);
      if (k0 < n_train) stage::issue_values(rring + (ci & 1) * L.rs, ref + k0, cnt);
    }
    stage::commit();
  };
  issue(0);

  for (int ci = 0; ci < n_chunks; ++ci) {
    issue(ci + 1);
    stage::wait<1>();
    __syncthreads();  // chunk ci (and the table) visible to every lane
    const int k0 = ci * chunk;
    const int cnt = min(chunk, n_sym - k0);
    if (runs) {
      const T* wb = wring + (ci & 1) * L.ws + stage::misalign_of(sig + (size_t)k0 * sps) + lane;
      const T* rb = rring + (ci & 1) * L.rs + stage::misalign_of(ref + k0);
#pragma unroll
      for (int q = 0; q < V; ++q) st.w[q] = st.fv[q] ? num(wb[G * q]) : Num{0.0f, 0.0f};
      // the chunk's training symbols, then the decision-directed ones
      const int kk_dd = min(max(n_train - k0, 0), cnt);
      Num r = kk_dd > 0 ? num(rb[0]) : Num{0.0f, 0.0f};
      run<CPLX, V, VB, PFB, kRef, true>(st, r, wb, rb, ys, ms, 0, kk_dd, cnt, c);
      if (kk_dd < cnt) {
        // the real instance takes no QAM grid (dfe_launch refuses it)
        switch (a.slicer * 2 + (a.fulltime ? 1 : 0)) {
          case 0: run<CPLX, V, VB, PFB, kArgmin, false>(st, r, wb, rb, ys, ms, kk_dd, cnt, cnt, c); break;
          case 1: run<CPLX, V, VB, PFB, kArgmin, true>(st, r, wb, rb, ys, ms, kk_dd, cnt, cnt, c); break;
          case 2: run<CPLX, V, VB, PFB, kPam, false>(st, r, wb, rb, ys, ms, kk_dd, cnt, cnt, c); break;
          case 3: run<CPLX, V, VB, PFB, kPam, true>(st, r, wb, rb, ys, ms, kk_dd, cnt, cnt, c); break;
          case 4:
            if constexpr (CPLX) run<CPLX, V, VB, PFB, kQam, false>(st, r, wb, rb, ys, ms, kk_dd, cnt, cnt, c);
            break;
          default:
            if constexpr (CPLX) run<CPLX, V, VB, PFB, kQam, true>(st, r, wb, rb, ys, ms, kk_dd, cnt, cnt, c);
            break;
        }
      }
    }
    __syncthreads();  // the chunk's outputs are staged; its ring slot is free
    for (int i = lane; i < cnt; i += kWarp) {
      y_out[k0 + i] = ys[i];
      mse_out[k0 + i] = ms[i];
    }
  }
#pragma unroll
  for (int q = 0; q < V; ++q)
    if (st.fv[q]) store<CPLX>(a.f_out, (size_t)b * n_ff + lane + G * q, st.f[q]);
#pragma unroll
  for (int q = 0; q < VB; ++q)
    if (st.bv[q]) store<CPLX>(a.b_out, (size_t)b * n_fb + lane + G * q, st.bt[q]);
}

// Symbols per chunk: kChunkMax, halved while the staging area is over the
// budget or half a chunk still holds every symbol.
int chunk_symbols(int n_sym, int sps, int n_ff, int vsize) {
  int chunk = kChunkMax;
  while (chunk > 1 &&
         (layout(chunk, sps, n_ff, vsize).bytes > kBudget || chunk / 2 >= n_sym))
    chunk >>= 1;
  return chunk;
}

template <bool CPLX, int PFF, int PFB>
int launch(const DfeArgs& a, cudaStream_t stream) {
  auto kernel = dfe_kernel<CPLX, PFF, PFB>;
  const size_t smem = layout(a.chunk, a.sps, a.n_ff, CPLX ? 8 : 4).bytes;
  if (smem > 32 * 1024) {  // beside the 8 KB static table
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a.n_batch, kWarp, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool CPLX, int PFF>
int launch_fb(const DfeArgs& a, cudaStream_t stream) {
  if (a.n_fb == 0) return launch<CPLX, PFF, 0>(a, stream);
  if (a.n_fb <= 8) return launch<CPLX, PFF, 8>(a, stream);
  return launch<CPLX, PFF, 16>(a, stream);
}

template <bool CPLX>
int launch_ff(const DfeArgs& a, cudaStream_t stream) {
  if (a.n_ff <= 8) return launch_fb<CPLX, 8>(a, stream);
  if (a.n_ff <= 16) return launch_fb<CPLX, 16>(a, stream);
  return launch_fb<CPLX, 32>(a, stream);
}

}  // namespace

// One DFE pass (FFE with n_fb = 0) over n_batch signals.  cplx: sig
// (n_batch, sig_len), ref (n_batch, n_sym), f0/f_out (n_batch, n_ff),
// b0/b_out (n_batch, n_fb) and y (n_batch, n_sym) are complex64 if cplx,
// else float32; mse (n_batch, n_sym) float32.  slicer: 0 argmin over the
// m_const points (c_re, c_im), 1 PAM levels, 2 square-QAM grid (lo, step,
// top = levels - 1; complex only).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dfe_launch(int n_batch, int cplx, const void* sig,
                          long long sig_len, int n_sym, int sps,
                          const void* ref, const void* c_re, const void* c_im,
                          int m_const, int slicer, float lo, float step,
                          float top, int n_ff, int n_fb, float mu, int n_train,
                          int fulltime, const void* f0, const void* b0,
                          void* f_out, void* b_out, void* y, void* mse,
                          void* stream) {
  if (m_const < 1 || m_const > kMaxTable || n_ff < 1 || n_ff > 32 ||
      n_fb < 0 || n_fb > 16 || slicer < 0 || slicer > 2 || n_batch < 1 ||
      sps < 1 || (!cplx && slicer == 2))
    return (int)cudaErrorInvalidValue;
  const int chunk = chunk_symbols(n_sym, sps, n_ff, cplx ? 8 : 4);
  const DfeArgs a{n_batch, sig, sig_len, n_sym, sps, ref,
                  (const float*)c_re, (const float*)c_im, m_const, slicer,
                  lo, step, top, n_ff, n_fb, mu, n_train, fulltime, f0, b0,
                  f_out, b_out, y, (float*)mse, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  return cplx ? launch_ff<true>(a, s) : launch_ff<false>(a, s);
}
