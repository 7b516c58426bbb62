// Decision-directed phase-locked loop (DD-PLL) carrier recovery with a
// pilot mask, hand-written for Hopper (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/ddpll_pallas.py, `_kernel` (launched by
// `_ddpll_run`).
//
// What bounds it on an H100: the recurrence.  The phase estimate of symbol
// k rotates symbol k+1 before its decision, so each column is a serial
// chain of ~25 dependent float operations per symbol (a sine and a cosine,
// the rotation, the decision, the phase detector, the loop filter).  It
// reads 20 bytes and writes 4 per (symbol, column): orders of magnitude
// below the card's memory rate at the chain's pace, and its operations are
// as far below the FP32 peak.  The time is the chain's latency times N.
//
// Design: one thread per column, neighbouring columns on neighbouring
// lanes, so that the symbols of one row are read in one coalesced request;
// a warp covers 32 columns (the 22 columns of 11 polmux signals fit one).
// The loads run kPrefetch symbols ahead of the recurrence in a register
// queue (the loop is unrolled by kPrefetch, so the queue stays in
// registers), which hides the device-memory latency behind the chain.  The
// constellation for the argmin slicer sits in shared memory; a square-QAM
// constellation takes the O(1) per-axis quantizer instead.  Sine and cosine
// are the full-precision sinf/cosf, and the other arithmetic uses the _rn
// intrinsics, so nvcc does not contract it into FMAs: each operation rounds
// as in the plain version, the reference rule in
// opticommpy_torch/dsp/carrier_recovery.py, which differs from the kernel
// only in its slicer (an argmin where the kernel quantizes a square-QAM
// grid) and in the float32 rounding of the loop coefficients.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPrefetch = 16;
constexpr int kMaxTable = 1024;

// clip(rint((x - lo) / step), 0, top) * step + lo; rintf rounds half to
// even like jnp.round (the same rule as bps.cu)
__device__ __forceinline__ float quantize(float x, float lo, float step,
                                          float top) {
  float k = rintf(__fdiv_rn(__fsub_rn(x, lo), step));
  k = fminf(fmaxf(k, 0.0f), top);
  return __fadd_rn(__fmul_rn(k, step), lo);
}

__global__ void __launch_bounds__(kWarp)
ddpll_kernel(const float2* __restrict__ x, const float2* __restrict__ ref,
             const float* __restrict__ pilot, int n, int n_cols,
             const float* __restrict__ c_re, const float* __restrict__ c_im,
             int m_const, int use_grid, float lo, float step, float top,
             float a0, float a1, float a2, float kv, float* __restrict__ out) {
  __shared__ float2 table[kMaxTable];
  if (!use_grid) {
    for (int i = threadIdx.x; i < m_const; i += blockDim.x)
      table[i] = make_float2(c_re[i], c_im[i]);
    __syncthreads();
  }
  const int col = blockIdx.x * kWarp + threadIdx.x;
  if (col >= n_cols) return;

  float2 qx[kPrefetch], qr[kPrefetch];
  float qp[kPrefetch];
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    if (j < n) {
      qx[j] = x[(size_t)j * n_cols + col];
      qr[j] = ref[(size_t)j * n_cols + col];
      qp[j] = pilot[j];
    }
  }

  float phi = 0.0f, u_f = 0.0f, u_d = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kPrefetch) {
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int k = k0 + j;
      if (k < n) {
        const float2 xv = qx[j];
        const float2 rv = qr[j];
        const float pv = qp[j];
        const int kn = k + kPrefetch;
        if (kn < n) {
          qx[j] = x[(size_t)kn * n_cols + col];
          qr[j] = ref[(size_t)kn * n_cols + col];
          qp[j] = pilot[kn];
        }
        const float c = cosf(phi);
        const float s = sinf(phi);
        const float eo_re = __fsub_rn(__fmul_rn(xv.x, c), __fmul_rn(xv.y, s));
        const float eo_im = __fadd_rn(__fmul_rn(xv.x, s), __fmul_rn(xv.y, c));
        float t_re, t_im;
        if (pv != 0.0f) {
          t_re = rv.x;
          t_im = rv.y;
        } else if (use_grid) {
          t_re = quantize(eo_re, lo, step, top);
          t_im = quantize(eo_im, lo, step, top);
        } else {
          float best = 0.0f;
          int best_i = 0;
          for (int m = 0; m < m_const; ++m) {
            const float dr = __fsub_rn(eo_re, table[m].x);
            const float di = __fsub_rn(eo_im, table[m].y);
            const float d = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
            if (m == 0 || d < best) {
              best = d;
              best_i = m;
            }
          }
          t_re = table[best_i].x;
          t_im = table[best_i].y;
        }
        const float u_d_new =
            __fsub_rn(__fmul_rn(eo_im, t_re), __fmul_rn(eo_re, t_im));
        u_f = __fadd_rn(__fadd_rn(__fmul_rn(a0, u_f), __fmul_rn(a1, u_d)),
                        __fmul_rn(a2, u_d_new));
        out[(size_t)k * n_cols + col] = phi;
        phi = __fsub_rn(phi, __fmul_rn(kv, u_f));
        u_d = u_d_new;
      }
    }
  }
}

}  // namespace

// DD-PLL phases of every column.  x, ref: (n, n_cols) complex64; pilot:
// (n,) f32, nonzero on pilot rows; c_*: (m_const,) f32; out: (n, n_cols)
// f32.  Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ddpll_launch(const void* x, const void* ref, const void* pilot,
                            int n, int n_cols, const void* c_re,
                            const void* c_im, int m_const, int use_grid,
                            float lo, float step, float top, float a0,
                            float a1, float a2, float kv, void* out,
                            void* stream) {
  if (m_const > kMaxTable || m_const < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_cols + kWarp - 1) / kWarp;
  ddpll_kernel<<<blocks, kWarp, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (const float2*)ref, (const float*)pilot, n, n_cols,
      (const float*)c_re, (const float*)c_im, m_const, use_grid, lo, step,
      top, a0, a1, a2, kv, (float*)out);
  return (int)cudaGetLastError();
}
