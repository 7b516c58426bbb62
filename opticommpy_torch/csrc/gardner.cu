// Gardner clock recovery (timing-error detector, PI loop filter, cubic
// Farrow NCO with sample skip/stuff), hand-written for Hopper (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/gardner_pallas.py, `_kernel` (launched
// by `_gardner_pallas_1d`) together with that wrapper's second pass, which
// placed the kernel's iteration-indexed records at their output indices.
//
// What bounds it on an H100: nothing the card has in bulk.  Each mode is
// one serial recurrence with data-dependent control: iteration i+1 needs
// the NCO timing, the pointers and the output that iteration i produced,
// so a mode's loop runs on one thread at the latency of its dependent chain
// (~30 float operations, two data-dependent branches, a store and a few
// loads per output sample).  Its bytes (8 per input sample, 12 per output
// sample) and operations are far below what would bound it; the time is
// the chain's latency times the sample count.
//
// Design: one thread carries one mode's loop, and one launch covers all
// modes (the TPU wrapper launched once per mode).  Against the latency:
// - the 4-sample window x[m-2 .. m+1] lives in registers; m advances by 0
//   or 1 per iteration, so the window shifts by one register and the next
//   four input samples are already in flight (a register queue);
// - eo[n] is written at its data-dependent index directly, so the TPU's
//   record pass disappears.  The timing error reads eo[n-2 .. n] back: from
//   a register cache of the last four writes when one of them is that
//   index (the usual case), else from the output buffer, which holds the
//   last value written there or its initial zero.  That is the
//   lax.while_loop's semantics (the reference): an index the NCO stuffed
//   over keeps zero, or the value it held before a backstep;
// - the arithmetic uses the _rn intrinsics, so nvcc does not contract it
//   into FMAs: it rounds exactly as the plain PyTorch version in
//   opticommpy_torch/kernels/gardner.py, and a skip/stuff decision, which
//   shifts every later sample, cannot part the two.

#include <cuda_runtime.h>

namespace {

// the interpolator's coefficients, rounded from double as the JAX package
// rounds its Python constants
constexpr float kM6 = static_cast<float>(-1.0 / 6.0);
constexpr float kP6 = static_cast<float>(1.0 / 6.0);
constexpr float kP3 = static_cast<float>(1.0 / 3.0);

struct Cache {  // the last four (index, value) writes, newest first
  int i0 = -1, i1 = -1, i2 = -1, i3 = -1;
  float2 v0, v1, v2, v3;

  __device__ __forceinline__ void push(int i, float2 v) {
    i3 = i2; v3 = v2;
    i2 = i1; v2 = v1;
    i1 = i0; v1 = v0;
    i0 = i;  v0 = v;
  }
};

__device__ __forceinline__ float2 read_eo(const Cache& c, const float2* eo,
                                          int k, int modes) {
  if (k == c.i0) return c.v0;
  if (k == c.i1) return c.v1;
  if (k == c.i2) return c.v2;
  if (k == c.i3) return c.v3;
  return eo[(size_t)k * modes];
}

__device__ __forceinline__ float2 load_x(const float2* col, int i, int n_in,
                                         int modes) {
  return i < n_in ? col[(size_t)i * modes] : make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ float power(float2 v) {
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

__global__ void gardner_kernel(const float2* __restrict__ sig, int n_in,
                               int modes, int n_out, float kp, float ki,
                               int nyquist, int max_iters,
                               float2* __restrict__ eo_all,
                               float* __restrict__ tv_all,
                               int* __restrict__ n_final) {
  const int mode = blockIdx.x * blockDim.x + threadIdx.x;
  if (mode >= modes) return;
  const float2* col = sig + mode;
  float2* eo = eo_all + mode;
  float* tv = tv_all + mode;

  int n = 2, m = 2;
  float ip = 0.0f, t = 0.0f;
  float2 w0 = load_x(col, 0, n_in, modes), w1 = load_x(col, 1, n_in, modes);
  float2 w2 = load_x(col, 2, n_in, modes), w3 = load_x(col, 3, n_in, modes);
  float2 q0 = load_x(col, 4, n_in, modes), q1 = load_x(col, 5, n_in, modes);
  float2 q2 = load_x(col, 6, n_in, modes), q3 = load_x(col, 7, n_in, modes);
  Cache cache;

  for (int it = 0; it < max_iters; ++it) {
    if (!(n < n_out - 1 && m < n_in - 2)) break;
    // cubic Farrow interpolation at t from x[m-2 .. m+1]
    const float t2 = __fmul_rn(t, t);
    const float t3 = __fmul_rn(t2, t);
    const float c0 = __fadd_rn(__fmul_rn(kM6, t3), __fmul_rn(kP6, t));
    const float c1 =
        __fsub_rn(__fadd_rn(__fmul_rn(0.5f, t3), __fmul_rn(0.5f, t2)), t);
    const float c2 = __fadd_rn(
        __fadd_rn(__fsub_rn(__fmul_rn(-0.5f, t3), t2), __fmul_rn(0.5f, t)),
        1.0f);
    const float c3 = __fadd_rn(
        __fadd_rn(__fmul_rn(kP6, t3), __fmul_rn(0.5f, t2)), __fmul_rn(kP3, t));
    float2 val;
    val.x = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(w0.x, c0), __fmul_rn(w1.x, c1)),
                  __fmul_rn(w2.x, c2)),
        __fmul_rn(w3.x, c3));
    val.y = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(w0.y, c0), __fmul_rn(w1.y, c1)),
                  __fmul_rn(w2.y, c2)),
        __fmul_rn(w3.y, c3));
    if (n >= 0) eo[(size_t)n * modes] = val;
    cache.push(n, val);

    // timing error on eo[s .. s+2], s = clip(n - 2, 0, n_out - 3), even n
    if ((n & 1) == 0) {
      const int s = min(max(n - 2, 0), n_out - 3);
      const float2 e0 = read_eo(cache, eo, s, modes);
      const float2 e1 = read_eo(cache, eo, s + 1, modes);
      const float2 e2 = read_eo(cache, eo, s + 2, modes);
      float ted;
      if (nyquist) {
        ted = __fmul_rn(power(e1), __fsub_rn(power(e0), power(e2)));
      } else {
        ted = __fadd_rn(__fmul_rn(e1.x, __fsub_rn(e2.x, e0.x)),
                        __fmul_rn(e1.y, __fsub_rn(e2.y, e0.y)));
      }
      ip = __fadd_rn(__fmul_rn(ki, ted), ip);
      t = __fsub_rn(t, __fadd_rn(__fmul_rn(kp, ted), ip));
    }

    // NCO clock gap: skip (over) or stuff (under) a sample
    int dm = 1;
    if (t > 1.0f) {
      t = __fsub_rn(t, 1.0f);
      n -= 1;
      dm = 0;
    } else if (t < -1.0f) {
      t = __fadd_rn(t, 1.0f);
      n += 2;
    } else {
      n += 1;
    }
    tv[(size_t)min(max(n, 0), n_out - 1) * modes] = t;
    if (dm) {
      m += 1;
      w0 = w1; w1 = w2; w2 = w3; w3 = q0;
      q0 = q1; q1 = q2; q2 = q3;
      q3 = load_x(col, m + 5, n_in, modes);
    }
  }
  n_final[mode] = n;
}

}  // namespace

// Gardner clock recovery of every mode.  sig: (n_in, modes) complex64;
// eo: (n_out, modes) complex64 and tv: (n_out, modes) f32, both zeroed by
// the caller; n_final: (modes,) int32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int gardner_launch(const void* sig, int n_in, int modes, int n_out,
                              float kp, float ki, int nyquist, int max_iters,
                              void* eo, void* tv, void* n_final,
                              void* stream) {
  const int threads = 32;
  const int blocks = (modes + threads - 1) / threads;
  gardner_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)sig, n_in, modes, n_out, kp, ki, nyquist, max_iters,
      (float2*)eo, (float*)tv, (int*)n_final);
  return (int)cudaGetLastError();
}
