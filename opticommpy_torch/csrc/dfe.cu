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
// the chain's latency times the number of symbols.
//
// Design: one thread per signal, its taps, decision buffer and window in
// registers (the tap counts are template parameters, powers of two at
// least as large as the configuration's, the extra taps zero), a loop over
// the symbols inside the kernel in place of the TPU's sequential grid (no
// padded tail), the window read straight from the padded signal
// (x[k*sps + t]) and the next symbol's window and reference loaded before
// the current symbol's chain.  Each tap sum is a pairwise tree (s[i] +=
// s[i + h], h = P/2 ... 1), which halves the depth of the chain against a
// sequential sum of 15 + 5 taps; zero taps added first leave the sum as
// the tree over the next power of two, so the plain version in
// opticommpy_torch/kernels/dfe.py, which pads to the smallest one, adds in
// the same order.  All arithmetic uses the _rn intrinsics, so nvcc forms no
// FMA, and rintf rounds half to even like torch.round: the kernel equals
// its plain version bit for bit.  A warp per signal with a butterfly
// reduction would shorten the sums further but spend 32 lanes on 20 taps
// and a shuffle per level; with one thread per signal the 8-132 signals of
// a serving batch ride the lanes of one to five warps.  The real instance
// (CPLX = false) serves PAM on real signals, where every imaginary plane of
// the complex instance stays zero.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxTable = 1024;

struct Num {  // the complex instance's value; the real one uses .re only
  float re, im;
};

__device__ __forceinline__ float quantize(float x, float lo, float step,
                                          float top) {
  float k = rintf(__fdiv_rn(__fsub_rn(x, lo), step));
  k = fminf(fmaxf(k, 0.0f), top);
  return __fadd_rn(__fmul_rn(k, step), lo);
}

template <int P>
__device__ __forceinline__ float tree(float* s) {
#pragma unroll
  for (int h = P / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int i = 0; i < h; ++i) s[i] = __fadd_rn(s[i], s[i + h]);
  }
  return s[0];
}

template <bool CPLX>
__device__ __forceinline__ Num load(const void* base, size_t i) {
  if (CPLX) {
    const float2 v = reinterpret_cast<const float2*>(base)[i];
    return Num{v.x, v.y};
  }
  return Num{reinterpret_cast<const float*>(base)[i], 0.0f};
}

template <bool CPLX>
__device__ __forceinline__ void store(void* base, size_t i, Num v) {
  if (CPLX)
    reinterpret_cast<float2*>(base)[i] = make_float2(v.re, v.im);
  else
    reinterpret_cast<float*>(base)[i] = v.re;
}

// y = sum over the P taps of t*x, as a tree (re: t.re x.re - t.im x.im,
// im: t.re x.im + t.im x.re)
template <bool CPLX, int P>
__device__ __forceinline__ Num dot(const Num* t, const Num* x) {
  float sr[P], si[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (CPLX) {
      sr[i] = __fsub_rn(__fmul_rn(t[i].re, x[i].re), __fmul_rn(t[i].im, x[i].im));
      si[i] = __fadd_rn(__fmul_rn(t[i].re, x[i].im), __fmul_rn(t[i].im, x[i].re));
    } else {
      sr[i] = __fmul_rn(t[i].re, x[i].re);
    }
  }
  Num out{tree<P>(sr), 0.0f};
  if (CPLX) out.im = tree<P>(si);
  return out;
}

// t += mu * (e * conj(x)) over the P taps
template <bool CPLX, int P>
__device__ __forceinline__ void update(Num* t, const Num* x, Num e, float mu) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
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
};

template <bool CPLX, int PFF, int PFB>
__global__ void __launch_bounds__(kWarp) dfe_kernel(const DfeArgs a) {
  constexpr int kFB = PFB > 0 ? PFB : 1;
  const int n_batch = a.n_batch, n_sym = a.n_sym, sps = a.sps;
  const int m_const = a.m_const, slicer = a.slicer, n_ff = a.n_ff, n_fb = a.n_fb;
  const int n_train = a.n_train, fulltime = a.fulltime;
  const float lo = a.lo, step = a.step, top = a.top, mu = a.mu;
  const void* __restrict__ sig = a.sig;
  const void* __restrict__ ref = a.ref;
  const float* __restrict__ c_re = a.c_re;
  const float* __restrict__ c_im = a.c_im;
  const long long sig_len = a.sig_len;
  __shared__ float2 table[kMaxTable];
  if (slicer == 0) {
    for (int i = threadIdx.x; i < m_const; i += blockDim.x)
      table[i] = make_float2(c_re[i], c_im[i]);
    __syncthreads();
  }
  const int b = blockIdx.x * kWarp + threadIdx.x;
  if (b >= n_batch) return;
  const size_t row = (size_t)b * sig_len;
  const size_t rrow = (size_t)b * n_sym;

  Num f[PFF], w[PFF], wn[PFF];
  Num bt[kFB], d[kFB];
#pragma unroll
  for (int i = 0; i < PFF; ++i) {
    f[i] = i < n_ff ? load<CPLX>(a.f0, (size_t)b * n_ff + i) : Num{0.0f, 0.0f};
    w[i] = (i < n_ff && n_sym > 0) ? load<CPLX>(sig, row + i) : Num{0.0f, 0.0f};
  }
#pragma unroll
  for (int j = 0; j < kFB; ++j) {
    bt[j] = (PFB > 0 && j < n_fb) ? load<CPLX>(a.b0, (size_t)b * n_fb + j)
                                  : Num{0.0f, 0.0f};
    d[j] = Num{0.0f, 0.0f};
  }
  Num r = n_sym > 0 ? load<CPLX>(ref, rrow) : Num{0.0f, 0.0f};

  for (int k = 0; k < n_sym; ++k) {
    // the next symbol's window and reference, off the recurrence's chain
    const bool more = k + 1 < n_sym;
    const size_t next = row + (size_t)(k + 1) * sps;
#pragma unroll
    for (int i = 0; i < PFF; ++i)
      wn[i] = (more && i < n_ff) ? load<CPLX>(sig, next + i) : Num{0.0f, 0.0f};
    const Num rn = more ? load<CPLX>(ref, rrow + k + 1) : Num{0.0f, 0.0f};

    Num y = dot<CPLX, PFF>(f, w);
    if (PFB > 0) {
      const Num yb = dot<CPLX, kFB>(bt, d);
      y.re = __fadd_rn(y.re, yb.re);
      if (CPLX) y.im = __fadd_rn(y.im, yb.im);
    }
    Num t;
    if (k < n_train) {
      t = r;
    } else if (slicer == 0) {
      float best = 0.0f;
      int best_i = 0;
      for (int m = 0; m < m_const; ++m) {
        const float dr = __fsub_rn(y.re, table[m].x);
        float dd = __fmul_rn(dr, dr);
        if (CPLX) {
          const float di = __fsub_rn(y.im, table[m].y);
          dd = __fadd_rn(dd, __fmul_rn(di, di));
        }
        if (m == 0 || dd < best) {
          best = dd;
          best_i = m;
        }
      }
      t = Num{table[best_i].x, CPLX ? table[best_i].y : 0.0f};
    } else {
      t.re = quantize(y.re, lo, step, top);
      t.im = (CPLX && slicer == 2) ? quantize(y.im, lo, step, top) : 0.0f;
    }
    const Num e{__fsub_rn(t.re, y.re), CPLX ? __fsub_rn(t.im, y.im) : 0.0f};
    if (fulltime || k < n_train) {
      update<CPLX, PFF>(f, w, e, mu);
      if (PFB > 0) update<CPLX, kFB>(bt, d, e, mu);
    }
    if (PFB > 0) {
      // newest target at index 0; entries from n_fb on stay zero
#pragma unroll
      for (int j = kFB - 1; j >= 1; --j) d[j] = j < n_fb ? d[j - 1] : Num{0.0f, 0.0f};
      d[0] = t;
    }
    store<CPLX>(a.y, rrow + k, y);
    float m2 = __fmul_rn(e.re, e.re);
    if (CPLX) m2 = __fadd_rn(m2, __fmul_rn(e.im, e.im));
    a.mse[rrow + k] = m2;
#pragma unroll
    for (int i = 0; i < PFF; ++i) w[i] = wn[i];
    r = rn;
  }
#pragma unroll
  for (int i = 0; i < PFF; ++i)
    if (i < n_ff) store<CPLX>(a.f_out, (size_t)b * n_ff + i, f[i]);
  if (PFB > 0) {
#pragma unroll
    for (int j = 0; j < kFB; ++j)
      if (j < n_fb) store<CPLX>(a.b_out, (size_t)b * n_fb + j, bt[j]);
  }
}

template <bool CPLX, int PFF, int PFB>
int launch(const DfeArgs& a, cudaStream_t stream) {
  const int blocks = (a.n_batch + kWarp - 1) / kWarp;
  dfe_kernel<CPLX, PFF, PFB><<<blocks, kWarp, 0, stream>>>(a);
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
// top = levels - 1).  Launches on `stream` and returns cudaGetLastError().
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
  const DfeArgs a{n_batch, sig, sig_len, n_sym, sps, ref,
                  (const float*)c_re, (const float*)c_im, m_const, slicer,
                  lo, step, top, n_ff, n_fb, mu, n_train, fulltime, f0, b0,
                  f_out, b_out, y, (float*)mse};
  cudaStream_t s = (cudaStream_t)stream;
  return cplx ? launch_ff<true>(a, s) : launch_ff<false>(a, s);
}
