// Decision-directed Volterra LMS equalizer (2nd or 3rd order) over a batch
// of independent real signals, hand-written for Hopper (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/volterra_pallas.py, `_kernel` (launched
// by `_volterra_run`, serving `volterra_pallas`).
//
// What bounds it on an H100: the recurrence.  Symbol k's decision sets the
// tap update that shapes symbol k+1's output, so each signal is a serial
// chain per symbol: the feature products, the tap sum over Q taps (13 + 49
// + 125 = 187 at 13 / 7 / 5 taps, order 3), the slicer (a true division),
// the error and Q tap updates.  It reads n1 samples and a reference per
// symbol and writes two numbers; ~5 Q operations per symbol are far below
// the FP32 peak at the chain's pace.  The time is the chain's latency
// times the number of symbols.
//
// Design: one warp per signal (one CTA each).  187 taps do not fit one
// thread's registers, so lane l owns the flat taps q = l + 32 s (s = 0 ..
// S-1, S a template parameter), h1's first, then h2 row-major, then h3.
// Lane t < n1 loads window sample x[k*sps + t] (the next symbol's ahead of
// the chain); every lane fetches its features' samples by warp shuffles
// and keeps its features for the update.  The lane sums its slots in slot
// order, the warp adds the 32 lane sums by a butterfly (all lanes end with
// the same bits: each level adds the same two numbers in either order),
// every lane slices and updates its own taps, and lane 0 writes y and the
// error power.  The _rn intrinsics keep nvcc from forming FMAs and rintf
// rounds half to even like torch.round, so the plain version in
// opticommpy_torch/kernels/volterra.py, which sums the same partials in
// the same order, equals the kernel bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

struct VolterraArgs {
  int n_batch;
  const float* sig;  // (n_batch, sig_len)
  long long sig_len;
  int n_sym, sps;
  const float* ref;  // (n_batch, n_sym)
  int n1, n_q;
  const int* table;  // (4, n_q): sample indices a, b, c and the order 1-3
  float lo, step, top, mu;
  int n_train, fulltime;
  const float* h0;  // (n_batch, n_q)
  float *h_out, *y, *mse;
};

template <int S>
__global__ void __launch_bounds__(kWarp) volterra_kernel(const VolterraArgs a) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* __restrict__ x = a.sig + (size_t)b * a.sig_len;
  const float* __restrict__ ref = a.ref + (size_t)b * a.n_sym;
  const int n_sym = a.n_sym, sps = a.sps, n1 = a.n1, n_q = a.n_q;

  float h[S], phi[S];
  int ia[S], ib[S], ic[S], kind[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = lane + kWarp * s;
    const bool on = q < n_q;
    ia[s] = on ? a.table[q] : 0;
    ib[s] = on ? a.table[n_q + q] : 0;
    ic[s] = on ? a.table[2 * n_q + q] : 0;
    kind[s] = on ? a.table[3 * n_q + q] : 0;
    h[s] = on ? a.h0[(size_t)b * n_q + q] : 0.0f;
  }
  float xv = (lane < n1 && n_sym > 0) ? x[lane] : 0.0f;
  float r = n_sym > 0 ? ref[0] : 0.0f;

  for (int k = 0; k < n_sym; ++k) {
    const bool more = k + 1 < n_sym;
    const float xn = (more && lane < n1) ? x[(size_t)(k + 1) * sps + lane] : 0.0f;
    const float rn = more ? ref[k + 1] : 0.0f;

    // features (index n1 stands for 1.0 in the table: a lower order skips it)
    float part = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float xa = __shfl_sync(kFull, xv, ia[s] < kWarp ? ia[s] : 0);
      const float xb = __shfl_sync(kFull, xv, ib[s] < kWarp ? ib[s] : 0);
      const float xc = __shfl_sync(kFull, xv, ic[s] < kWarp ? ic[s] : 0);
      float f = 0.0f;
      if (kind[s] == 1) f = xa;
      if (kind[s] == 2) f = __fmul_rn(xa, xb);
      if (kind[s] == 3) f = __fmul_rn(__fmul_rn(xa, xb), xc);
      phi[s] = f;
      const float p = __fmul_rn(h[s], f);
      part = s == 0 ? p : __fadd_rn(part, p);
    }
#pragma unroll
    for (int o = kWarp / 2; o >= 1; o /= 2)
      part = __fadd_rn(part, __shfl_xor_sync(kFull, part, o));
    const float y = part;

    float t;
    if (k < a.n_train) {
      t = r;
    } else {
      float kq = rintf(__fdiv_rn(__fsub_rn(y, a.lo), a.step));
      kq = fminf(fmaxf(kq, 0.0f), a.top);
      t = __fadd_rn(__fmul_rn(kq, a.step), a.lo);
    }
    const float e = __fsub_rn(t, y);
    if (a.fulltime || k < a.n_train) {
      const float g = __fmul_rn(e, a.mu);
      const float g2 = __fmul_rn(0.5f, g);
      const float g3 = __fdiv_rn(g, 7.0f);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float gq = kind[s] == 1 ? g : (kind[s] == 2 ? g2 : g3);
        if (kind[s] != 0) h[s] = __fadd_rn(h[s], __fmul_rn(gq, phi[s]));
      }
    }
    if (lane == 0) {
      a.y[(size_t)b * n_sym + k] = y;
      a.mse[(size_t)b * n_sym + k] = __fmul_rn(e, e);
    }
    xv = xn;
    r = rn;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = lane + kWarp * s;
    if (q < n_q) a.h_out[(size_t)b * n_q + q] = h[s];
  }
}

template <int S>
int launch(const VolterraArgs& a, cudaStream_t stream) {
  volterra_kernel<S><<<a.n_batch, kWarp, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One Volterra pass over n_batch real signals.  sig (n_batch, sig_len),
// ref (n_batch, n_sym), h0/h_out (n_batch, n_q) and y, mse (n_batch, n_sym)
// are float32; table (4, n_q) int32 holds each flat tap's sample indices
// a, b, c (n1 standing for 1.0) and its order.  The PAM slicer is
// clip(rint((y - lo) / step), 0, top) * step + lo.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int volterra_launch(int n_batch, const void* sig, long long sig_len,
                               int n_sym, int sps, const void* ref, int n1,
                               int n_q, const void* table, float lo,
                               float step, float top, float mu, int n_train,
                               int fulltime, const void* h0, void* h_out,
                               void* y, void* mse, void* stream) {
  if (n_batch < 1 || n1 < 1 || n1 > kWarp || n_q < 1 || n_q > 16 * kWarp ||
      sps < 1)
    return (int)cudaErrorInvalidValue;
  const VolterraArgs a{n_batch, (const float*)sig, sig_len, n_sym, sps,
                       (const float*)ref, n1, n_q, (const int*)table, lo,
                       step, top, mu, n_train, fulltime, (const float*)h0,
                       (float*)h_out, (float*)y, (float*)mse};
  cudaStream_t s = (cudaStream_t)stream;
  const int slots = (n_q + kWarp - 1) / kWarp;
  if (slots <= 1) return launch<1>(a, s);
  if (slots <= 2) return launch<2>(a, s);
  if (slots <= 4) return launch<4>(a, s);
  if (slots <= 8) return launch<8>(a, s);
  return launch<16>(a, s);
}
