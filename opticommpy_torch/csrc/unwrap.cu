// Phase unwrapping with the derotation fused in, hand-written for Hopper
// (sm_90a): K15.
//
// Replaces: no Pallas kernel.  The JAX package unwraps the carrier phase
// with `jnp.unwrap` (dsp/carrier_recovery.py), which XLA fuses.  On an
// H100, in PyTorch ops, the float32 cumulative sum of the corrections
// along the rows of an (N, C) = (65,536, 22) array runs the 22 columns in
// parallel and the rows one after another: ~11.4 ms, where the data takes
// ~0.01 ms to move; the plain twin `unwrap_derotate_plain` with its
// integer scan laid along the inner dim takes ~0.37 ms of device time in
// 46 kernels.
//
// The function, per column of the (N, C) float32 phases phi with multiplier
// m and period P (kernels/unwrap.py):
//   x_i = m * phi_i; dd_i = x_i - x_{i-1}; the step's correction is today's
//   unwrap's, in its float32 operations: ddmod = remainder(dd + P/2, P) -
//   P/2, +P/2 where ddmod == -P/2 and dd > 0, and 0 where |dd| < P/2, else
//   ddmod - dd.  That correction is a whole number of periods: k_i =
//   rint(corr_i * (1/P)).  K_i = k_1 + ... + k_i (int32), and the output is
//   theta_i = phi_i + (P/m) K_i, formed in float64 (the product is exact)
//   and rounded once to float32.  With symbols y (complex64), also
//   y_i * exp(1j * theta_i).  A step whose correction is not finite (a NaN
//   or infinite phase) makes its row and every later row of the column NaN,
//   as the float32 cumulative sum does; the int32 turns stay exact while
//   steps stay below ~2^20 periods.
//
// What bounds it on an H100: bytes.  It reads the phases (4 bytes) and the
// symbols (8) and writes both (12) per element: 34.6 MB at (65,536, 22),
// 0.010 ms at 3.35 TB/s.  A few float operations per element; one sincosf.
//
// Design:
//   - Integer turns, not a float sum.  The scan adds int32 turn counts, so
//     it is exact and associative: any split of a column over CTAs gives
//     the same bits in every run (what utils/scan.cumsum does for float
//     sums), and each output has one rounding in place of a running sum's
//     65,536.
//   - Parallel along the column.  A CTA takes a chunk of rows of up to 32
//     columns; its threads are (segment, column) pairs, each segment
//     kRows rows of one column (22 columns: 11 segments of 32 rows, a chunk
//     of 352 rows, 187 CTAs).  A thread loads its kRows phases and the one
//     before them into registers; neighbouring threads read neighbouring
//     columns of a row.
//   - Two launches carry the turns between chunks.  The first computes
//     each chunk's turn total per column (and its count of non-finite
//     steps); the second adds the totals of the chunks before its own (the
//     column's segment threads share them), the segment totals before each
//     thread's own in shared memory, and then scans its segment, writing
//     the phases and, fused, the derotated symbols.  The phases are read
//     twice (5.8 MB more), nothing waits on another CTA, and there is no
//     flag to spin on: a look-back in one launch would save one launch gap
//     (~2 us) at the price of an inter-CTA wait.  An input of one chunk
//     skips the first launch.
//   - The arithmetic uses the _rn intrinsics, so nvcc contracts nothing
//     into an FMA and every operation rounds as in the plain twin
//     `unwrap_derotate_plain` (kernels/unwrap.py): the turns and the phases
//     agree bit for bit; fmodf is exact, as torch.remainder's fmod.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 32;      // rows of one column a thread scans
constexpr int kTile = 32;      // columns of a CTA at most
constexpr int kThreads = 256;  // threads of a CTA at most
constexpr int kMaxSegs = 32;   // segments of a chunk at most

struct Rule {
  float m, interval, period, inv_period;
  double step;  // phase per turn, P / m
};

struct Geometry {
  int tile, segs, chunk_rows, chunks, tiles;
};

Geometry geometry(int n, int cols) {
  Geometry g;
  g.tile = cols < kTile ? cols : kTile;
  g.segs = kThreads / g.tile < kMaxSegs ? kThreads / g.tile : kMaxSegs;
  g.chunk_rows = g.segs * kRows;
  g.chunks = (int)(((long long)n + g.chunk_rows - 1) / g.chunk_rows);
  g.tiles = (cols + g.tile - 1) / g.tile;
  return g;
}

// The whole periods of one step's correction; `bad` counts a correction
// that is not finite (then 0 turns).
__device__ __forceinline__ int turn(float prev, float cur, const Rule& r, int& bad) {
  const float dd = __fsub_rn(__fmul_rn(r.m, cur), __fmul_rn(r.m, prev));
  float mod = fmodf(__fadd_rn(dd, r.interval), r.period);
  if (mod < 0.0f) mod = __fadd_rn(mod, r.period);  // torch.remainder, period > 0
  float ddmod = __fsub_rn(mod, r.interval);
  if (ddmod == -r.interval && dd > 0.0f) ddmod = r.interval;
  const float corr = fabsf(dd) < r.interval ? 0.0f : __fsub_rn(ddmod, dd);
  const bool finite = fabsf(corr) < CUDART_INF_F;
  bad += !finite;
  return finite ? __float2int_rn(__fmul_rn(corr, r.inv_period)) : 0;
}

// v[j] = phi[row0 - 1 + j], j = 0 .. kRows (0 outside the array).
__device__ __forceinline__ void load_segment(const float* __restrict__ phi, int n, int cols,
                                             long long row0, int col, float (&v)[kRows + 1]) {
#pragma unroll
  for (int j = 0; j <= kRows; ++j) {
    const long long i = row0 - 1 + j;
    v[j] = (i >= 0 && i < n) ? __ldg(phi + i * cols + col) : 0.0f;
  }
}

// (turns, non-finite steps) of rows row0 .. row0 + kRows - 1.
__device__ __forceinline__ int2 segment_total(const float (&v)[kRows + 1], long long row0,
                                              int n, const Rule& r) {
  int k = 0, bad = 0;
#pragma unroll
  for (int j = 1; j <= kRows; ++j) {
    const long long i = row0 + j - 1;
    if (i >= 1 && i < n) k += turn(v[j - 1], v[j], r, bad);
  }
  return make_int2(k, bad);
}

// Launch 1: per chunk and column, the turns and non-finite steps of its rows.
__global__ void __launch_bounds__(kThreads)
    unwrap_totals_kernel(const float* __restrict__ phi, int n, int cols, int tile,
                         int chunk_rows, Rule r, int2* __restrict__ totals) {
  __shared__ int2 acc[kTile];
  const int t = threadIdx.x, cl = t % tile, s = t / tile;
  const int col = blockIdx.y * tile + cl;
  const long long row0 = (long long)blockIdx.x * chunk_rows + (long long)s * kRows;
  if (t < tile) acc[t] = make_int2(0, 0);
  __syncthreads();
  if (col < cols) {
    float v[kRows + 1];
    load_segment(phi, n, cols, row0, col, v);
    const int2 sum = segment_total(v, row0, n, r);
    if (sum.x) atomicAdd(&acc[cl].x, sum.x);  // integers: the order does not matter
    if (sum.y) atomicAdd(&acc[cl].y, sum.y);
  }
  __syncthreads();
  if (t < tile && col < cols) totals[(long long)blockIdx.x * cols + col] = acc[t];
}

// Launch 2: the carried turns, then the segment's scan, phases and symbols.
template <bool kRotate>
__global__ void __launch_bounds__(kThreads)
    unwrap_apply_kernel(const float* __restrict__ phi, const float2* __restrict__ y, int n,
                        int cols, int tile, int segs, int chunk_rows, Rule r,
                        const int2* __restrict__ totals, float* __restrict__ out,
                        float2* __restrict__ y_out) {
  __shared__ int2 seg_tot[kThreads];
  __shared__ int2 carry[kTile];
  const int t = threadIdx.x, cl = t % tile, s = t / tile;
  const int col = blockIdx.y * tile + cl;
  const long long row0 = (long long)blockIdx.x * chunk_rows + (long long)s * kRows;
  if (t < tile) carry[t] = make_int2(0, 0);
  float v[kRows + 1];
  int2 part = make_int2(0, 0);
  if (col < cols) {
    load_segment(phi, n, cols, row0, col, v);
    // the chunks before this one, shared among the column's segment threads
    for (int b = s; b < (int)blockIdx.x; b += segs) {
      const int2 x = totals[(long long)b * cols + col];
      part.x += x.x;
      part.y += x.y;
    }
    seg_tot[t] = segment_total(v, row0, n, r);
  }
  __syncthreads();
  if (col < cols) {
    if (part.x) atomicAdd(&carry[cl].x, part.x);
    if (part.y) atomicAdd(&carry[cl].y, part.y);
  }
  __syncthreads();
  if (col >= cols) return;
  int k = carry[cl].x, bad = carry[cl].y;
  for (int q = 0; q < s; ++q) {
    const int2 x = seg_tot[q * tile + cl];
    k += x.x;
    bad += x.y;
  }
#pragma unroll
  for (int j = 1; j <= kRows; ++j) {
    const long long i = row0 + j - 1;
    if (i < n) {
      if (i >= 1) k += turn(v[j - 1], v[j], r, bad);
      const float th =
          bad ? CUDART_NAN_F
              : __double2float_rn(__dadd_rn((double)v[j], __dmul_rn(r.step, (double)k)));
      const long long e = i * cols + col;
      out[e] = th;
      if (kRotate) {
        float sn, cs;
        sincosf(th, &sn, &cs);
        const float2 a = y[e];
        y_out[e] = make_float2(__fsub_rn(__fmul_rn(a.x, cs), __fmul_rn(a.y, sn)),
                               __fadd_rn(__fmul_rn(a.x, sn), __fmul_rn(a.y, cs)));
      }
    }
  }
}

}  // namespace

// int2 entries of the scratch the launch needs (the chunk totals); 0 when
// the input is one chunk.
extern "C" int unwrap_scratch_len(int n, int cols) {
  if (n < 1 || cols < 1) return 0;
  const Geometry g = geometry(n, cols);
  const long long len = g.chunks > 1 ? (long long)g.chunks * cols : 0;
  return len > INT_MAX ? -1 : (int)len;
}

// phi, out: (n, cols) float32; y, y_out: (n, cols) complex64 or both null;
// totals: unwrap_scratch_len int2 entries.
extern "C" int unwrap_launch(const void* phi, const void* y, int n, int cols, float m,
                             float interval, float period, float inv_period, double step,
                             void* totals, void* out, void* y_out, void* stream) {
  if (n < 1 || cols < 1 || !(period > 0.0f) || (y == nullptr) != (y_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(n, cols);
  if (g.tiles > 65535) return (int)cudaErrorInvalidValue;
  const Rule r{m, interval, period, inv_period, step};
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)phi;
  if (g.chunks > 1) {
    if (totals == nullptr) return (int)cudaErrorInvalidValue;
    unwrap_totals_kernel<<<dim3(g.chunks, g.tiles), g.segs * g.tile, 0, s>>>(
        p, n, cols, g.tile, g.chunk_rows, r, (int2*)totals);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(g.chunks, g.tiles);
  const int2* tot = (const int2*)totals;
  if (y != nullptr)
    unwrap_apply_kernel<true><<<grid, g.segs * g.tile, 0, s>>>(
        p, (const float2*)y, n, cols, g.tile, g.segs, g.chunk_rows, r, tot, (float*)out,
        (float2*)y_out);
  else
    unwrap_apply_kernel<false><<<grid, g.segs * g.tile, 0, s>>>(
        p, nullptr, n, cols, g.tile, g.segs, g.chunk_rows, r, tot, (float*)out, nullptr);
  return (int)cudaGetLastError();
}
