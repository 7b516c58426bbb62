// Blind phase search (BPS) carrier-phase estimation, hand-written for Hopper
// (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/bps_pallas.py, `_bps_kernel` with its
// distance helper `_min_dist` (launched by `_bps_pallas_nd`).
//
// What bounds it on an H100: for every symbol and test phase the kernel does
// one complex rotation, one minimum constellation distance (O(1) per axis on
// a square-QAM grid, O(M) otherwise) and a window sum of 2*n_half+1 terms,
// i.e. ~(2*n_half+1) + 20 flops per (symbol, phase) against 8 bytes read
// and 4 written per symbol.  It is bound by FP32 throughput and shared-memory
// reads, never by device memory: the (N, B) distance tensor that the plain
// version writes to device memory stays on chip here.
//
// Design: one CTA owns a tile of `tile` output symbols of one mode.  The
// distances of the tile and its 2*n_half halo symbols go to shared memory,
// laid out [symbol][phase] so that the 32 lanes of a warp read 32
// consecutive phases without bank conflicts.  Symbols outside the signal
// are zero, as the TPU kernel's zero padding makes them.  Then each warp
// takes one output symbol at a time: every lane sums the window for its
// phases in the order j = 0 .. 2*n_half (plain f32 adds: no tensor cores,
// no cumulative-sum differences, which would lose eps*N), and a shuffle
// argmin keeps the lowest phase index on ties, as jnp.argmin does.  The
// arithmetic uses the _rn intrinsics, so nvcc does not contract it into
// FMAs and the kernel rounds exactly as the plain PyTorch version in
// opticommpy_torch/kernels/bps.py.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

// Nearest level of the uniform grid lo + k*step, k in [0, top]:
// clip(rint((x - lo) / step), 0, top) * step + lo; rintf rounds half to
// even like jnp.round.
__device__ __forceinline__ float quantize(float x, float lo, float step,
                                          float top) {
  float k = rintf(__fdiv_rn(__fsub_rn(x, lo), step));
  k = fminf(fmaxf(k, 0.0f), top);
  return __fadd_rn(__fmul_rn(k, step), lo);
}

__global__ void __launch_bounds__(kThreads)
bps_kernel(const float2* __restrict__ sig, int n, int modes,
           const float* __restrict__ rot_re, const float* __restrict__ rot_im,
           int n_phases, const float* __restrict__ c_re,
           const float* __restrict__ c_im, int m_const, int use_grid,
           float lo, float step, float top, int n_half, int tile,
           int* __restrict__ out) {
  extern __shared__ float dist[];  // [tile + 2*n_half][n_phases]
  const int mode = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int ext = tile + 2 * n_half;

  for (int i = threadIdx.x; i < ext * n_phases; i += blockDim.x) {
    const int j = i / n_phases;
    const int p = i - j * n_phases;
    const int s = t0 - n_half + j;
    float2 v = make_float2(0.0f, 0.0f);
    if (s >= 0 && s < n) v = sig[(size_t)s * modes + mode];
    const float rr = rot_re[p];
    const float ri = rot_im[p];
    const float z_re = __fsub_rn(__fmul_rn(v.x, rr), __fmul_rn(v.y, ri));
    const float z_im = __fadd_rn(__fmul_rn(v.x, ri), __fmul_rn(v.y, rr));
    float d;
    if (use_grid) {
      const float dr = __fsub_rn(z_re, quantize(z_re, lo, step, top));
      const float di = __fsub_rn(z_im, quantize(z_im, lo, step, top));
      d = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
    } else {
      d = CUDART_INF_F;
      for (int m = 0; m < m_const; ++m) {
        const float dr = __fsub_rn(z_re, c_re[m]);
        const float di = __fsub_rn(z_im, c_im[m]);
        d = fminf(d, __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di)));
      }
    }
    dist[i] = d;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int win = 2 * n_half + 1;
  for (int t = warp; t < tile && t0 + t < n; t += n_warps) {
    float best = CUDART_INF_F;
    int best_i = INT_MAX;
    for (int p = lane; p < n_phases; p += 32) {
      const float* col = dist + (size_t)t * n_phases + p;
      float acc = 0.0f;
      for (int j = 0; j < win; ++j) acc = __fadd_rn(acc, col[j * n_phases]);
      if (acc < best) {
        best = acc;
        best_i = p;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (ob < best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    if (lane == 0) {
      out[(size_t)(t0 + t) * modes + mode] = best_i == INT_MAX ? 0 : best_i;
    }
  }
}

}  // namespace

// Phase index per (symbol, mode).  sig: (n, modes) complex64; rot_*:
// (n_phases,) f32; c_*: (m_const,) f32; out: (n, modes) int32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int bps_launch(const void* sig, int n, int modes,
                          const void* rot_re, const void* rot_im,
                          int n_phases, const void* c_re, const void* c_im,
                          int m_const, int use_grid, float lo, float step,
                          float top, int n_half, int tile, void* out,
                          void* stream) {
  const size_t smem =
      (size_t)(tile + 2 * n_half) * (size_t)n_phases * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + tile - 1) / tile, modes);
  bps_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)sig, n, modes, (const float*)rot_re,
      (const float*)rot_im, n_phases, (const float*)c_re,
      (const float*)c_im, m_const, use_grid, lo, step, top, n_half, tile,
      (int*)out);
  return (int)cudaGetLastError();
}
