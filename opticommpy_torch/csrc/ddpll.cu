// Decision-directed phase-locked loop (DD-PLL) carrier recovery with a
// pilot mask, hand-written for Hopper (sm_90a): K7.
//
// Replaces: opticommpy_tpu/kernels/ddpll_pallas.py, `_kernel` (launched by
// `_ddpll_run`).
//
// What bounds it on an H100: the recurrence.  The phase estimate of symbol
// k rotates symbol k+1 before its decision, so each column is a serial
// chain per symbol: a sine and a cosine, the rotation, the decision (the
// slicer's true division), the phase detector, the loop filter and the
// phase update.  It reads 20 bytes and writes 4 per (symbol, column):
// orders of magnitude below the card's memory rate at the chain's pace, and
// its operations are as far below the FP32 peak.  The time is the step's
// latency times N.
//
// On one warp a step's time is set by its dependent chain and by the
// instruction stream around it (issue, branches, memory waits), not by
// its arithmetic.  What held the first version back (~785 cycles per
// symbol at path C's 65,536 x 22; PERF.md): the inputs came from device
// memory through a 16-deep register queue with two bound checks per step,
// sinf and cosf each ran their own range reduction, the pilot and the
// slicer were run-time branches in every step, and every symbol's phase was
// a store to device memory.
//
// Design: one warp per 16 columns, two lanes per column (the 22 columns of
// 11 polmux signals are two warps; the pilot mask is per row, so a warp
// never diverges).  Both lanes of a pair run the column's step; the grid
// slicer's two quantizers, each a true division whose slow-path check ptxas
// puts in a region of its own, would run one after the other on one lane:
// the even lane quantizes the real axis and the odd lane the imaginary one
// at once, and a shuffle swaps the decisions.
// - The warp copies the inputs with cp.async, a chunk of kChunk rows at a
//   time, into a two-slot ring in shared memory (x, the reference symbols
//   and the pilot mask), issuing chunk q + 1 before it runs chunk q, so the
//   step reads only shared memory and registers and has no bound check.
// - The slicer is a template parameter (the square-QAM grid quantizer or
//   the argmin over the constellation); the step computes the decision on
//   pilot rows too and selects the pilot's known symbol in its place, as
//   the TPU kernel does (ddpll_pallas.py:72-74), so it has no
//   data-dependent branch.
// - One sincosf gives the sine and the cosine: one range reduction and one
//   slow-path region in place of two.  It equals sinf and cosf on every
//   float32 input (checked on an H100, tools/bench_pll_lift_redesign.py).
// - Each step logs its phase in shared memory; the warp writes the chunk's
//   phases out after the chunk, a row per store.
// - The step loop is unrolled by 4, which took ~8% off the step on path C's
//   input against the loop not unrolled (PERF.md).
// The arithmetic uses the _rn intrinsics, so nvcc does not contract it into
// FMAs: each operation rounds as in the plain version `ddpll_plain` of
// opticommpy_torch/kernels/ddpll.py, and the kernel gives the first
// version's outputs bit for bit.

#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kLanes = 2;              // lanes per column
constexpr int kCols = kWarp / kLanes;  // columns per warp
constexpr int kChunk = 256;            // rows per staged chunk
constexpr int kMaxTable = 1024;

// shared memory: x and ref rings [2][kChunk][kCols] float2, the logged
// phases [kChunk][kCols], the pilot ring [2][kChunk], the constellation
constexpr size_t kRing = 2 * kChunk * kCols;
constexpr size_t kSmem = 2 * kRing * sizeof(float2) + kChunk * kCols * sizeof(float) +
                         2 * kChunk * sizeof(float) + kMaxTable * sizeof(float2);

// clip(rint((x - lo) / step), 0, top) * step + lo; rintf rounds half to
// even like jnp.round (the same rule as bps.cu)
__device__ __forceinline__ float quantize(float x, float lo, float step,
                                          float top) {
  float k = rintf(__fdiv_rn(__fsub_rn(x, lo), step));
  k = fminf(fmaxf(k, 0.0f), top);
  return __fadd_rn(__fmul_rn(k, step), lo);
}

template <bool GRID>
__global__ void __launch_bounds__(kWarp)
ddpll_kernel(const float2* __restrict__ x, const float2* __restrict__ ref,
             const float* __restrict__ pilot, int n, int n_cols,
             const float* __restrict__ c_re, const float* __restrict__ c_im,
             int m_const, float lo, float step, float top, float a0, float a1,
             float a2, float kv, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* sx = reinterpret_cast<float2*>(smem);
  float2* sr = sx + kRing;
  float* so = reinterpret_cast<float*>(sr + kRing);
  float* sp = so + kChunk * kCols;
  float2* table = reinterpret_cast<float2*>(sp + 2 * kChunk);
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const int wcols = min(kCols, n_cols - c0);  // live columns of this warp
  const int j = lane / kLanes;                // the column this lane steps
  if (!GRID)
    for (int i = lane; i < m_const; i += kWarp) table[i] = make_float2(c_re[i], c_im[i]);
  // a column past the last one steps on zeros
  for (size_t i = lane; i < kRing; i += kWarp)
    if ((int)(i % kCols) >= wcols) sx[i] = sr[i] = make_float2(0.0f, 0.0f);

  // chunk q of this warp's columns into ring slot q & 1, lane c copying
  // column c
  auto issue = [&](int q) {
    const int k0 = q * kChunk, len = min(kChunk, n - k0);
    const size_t slot = (size_t)(q & 1) * kChunk * kCols;
    if (lane < wcols) {
      for (int r = 0; r < len; ++r) {
        const size_t g = (size_t)(k0 + r) * n_cols + c0 + lane;
        stage::cp8(sx + slot + r * kCols + lane, x + g);
        stage::cp8(sr + slot + r * kCols + lane, ref + g);
      }
    }
    for (int r = lane; r < len; r += kWarp)
      stage::cp_value(sp + (q & 1) * kChunk + r, pilot + k0 + r);
    stage::commit();
  };

  const int n_chunks = (n + kChunk - 1) / kChunk;
  const bool odd = (lane & 1) != 0;
  float phi = 0.0f, u_f = 0.0f, u_d = 0.0f;
  issue(0);
  for (int q = 0; q < n_chunks; ++q) {
    if (q + 1 < n_chunks) {
      issue(q + 1);
      stage::wait<1>();
    } else {
      stage::wait<0>();
    }
    __syncwarp();  // chunk q (and the table, the zeroed columns) visible
    const int k0 = q * kChunk, len = min(kChunk, n - k0);
    const float2* cx = sx + (size_t)(q & 1) * kChunk * kCols + j;
    const float2* cr = sr + (size_t)(q & 1) * kChunk * kCols + j;
    const float* cp = sp + (q & 1) * kChunk;
#pragma unroll 4
    for (int r = 0; r < len; ++r) {
      const float2 xv = cx[r * kCols];
      const float2 rv = cr[r * kCols];
      const bool pil = cp[r] != 0.0f;
      so[r * kCols + j] = phi;  // both lanes of the pair write the same value
      float s, c;
      sincosf(phi, &s, &c);
      const float eo_re = __fsub_rn(__fmul_rn(xv.x, c), __fmul_rn(xv.y, s));
      const float eo_im = __fadd_rn(__fmul_rn(xv.x, s), __fmul_rn(xv.y, c));
      float d_re, d_im;
      if (GRID) {  // the even lane the real axis, the odd lane the imaginary
        const float own = quantize(odd ? eo_im : eo_re, lo, step, top);
        const float other = __shfl_xor_sync(0xffffffffu, own, 1);
        d_re = odd ? other : own;
        d_im = odd ? own : other;
      } else {  // the first nearest point: strict < keeps the lowest index
        float best = 0.0f;
        int best_i = 0;
        for (int m = 0; m < m_const; ++m) {
          const float dr = __fsub_rn(eo_re, table[m].x);
          const float di = __fsub_rn(eo_im, table[m].y);
          const float d = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
          const bool take = m == 0 || d < best;
          best = take ? d : best;
          best_i = take ? m : best_i;
        }
        d_re = table[best_i].x;
        d_im = table[best_i].y;
      }
      const float t_re = pil ? rv.x : d_re;
      const float t_im = pil ? rv.y : d_im;
      const float u_d_new =
          __fsub_rn(__fmul_rn(eo_im, t_re), __fmul_rn(eo_re, t_im));
      u_f = __fadd_rn(__fadd_rn(__fmul_rn(a0, u_f), __fmul_rn(a1, u_d)),
                      __fmul_rn(a2, u_d_new));
      phi = __fsub_rn(phi, __fmul_rn(kv, u_f));
      u_d = u_d_new;
    }
    __syncwarp();  // every lane done with slot q & 1 and the log
    if (lane < wcols)
      for (int r = 0; r < len; ++r)
        out[(size_t)(k0 + r) * n_cols + c0 + lane] = so[r * kCols + lane];
    __syncwarp();
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
  if (m_const > kMaxTable || m_const < 1 || n < 1 || n_cols < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = use_grid ? ddpll_kernel<true> : ddpll_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_cols + kCols - 1) / kCols;
  kernel<<<blocks, kWarp, kSmem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float2*)ref, (const float*)pilot, n, n_cols,
      (const float*)c_re, (const float*)c_im, m_const, lo, step, top, a0, a1,
      a2, kv, (float*)out);
  return (int)cudaGetLastError();
}
