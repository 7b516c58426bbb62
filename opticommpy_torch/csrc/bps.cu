// Blind phase search (BPS) carrier-phase estimation, hand-written for Hopper
// (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/bps_pallas.py, `_bps_kernel` with its
// distance helper `_min_dist` (launched by `_bps_pallas_nd`).
//
// The function: each symbol is rotated by the B test phases k*(pi/2)/B; for
// each, the minimum squared distance to the constellation is taken (per
// axis on a square-QAM grid, as a min over the M points otherwise); the
// distances are summed over a window of w = 2*n_half+1 symbols, zero
// symbols beyond both ends; the argmin over the phases (lowest index on an
// exact tie) is the estimate.
//
// What bounds it on an H100: ~27 float operations per (symbol, phase) on
// the grid (~6M + 10 over M points) against 8 bytes read and 4-8 written
// per symbol: the rate of float32 instructions, never device memory.  The
// (N, B) distance tensor that the plain version builds never leaves the SM.
//
// Design:
//   - Window sums by block prefix and suffix sums (van Herk / Gil-Werman for
//     sums).  The zero-padded distance sequence (padded index q is symbol
//     q - n_half) is cut into blocks of w, counted from q = 0.  Within a
//     block, serial suffix sums S[i] = d[i] + S[i+1] and prefix sums P[i] =
//     P[i-1] + d[i]; the window that starts at q is S[q] at a block start
//     and S[q] + P[q + w - 1] otherwise.  About 3 adds per (symbol, phase)
//     in place of w, and no subtraction: every term is >= 0, so there is no
//     cancellation and no eps*N loss.  The plain version
//     (kernels/bps.py, _window_sums_plain) adds in exactly this order, so
//     the two agree bit for bit.
//   - A CTA is one run of output blocks [b0, b1) of one mode, one thread per
//     test phase.  It streams over the blocks X = b0 .. b1: a forward pass
//     over block X computes each distance once (into shared memory) and its
//     prefix sums, and completes the windows of block X - 1 in place of that
//     block's suffix sums; a reverse pass turns block X's distances into its
//     suffix sums; then every thread takes rows of block X - 1 and writes
//     their argmin.  Two slots of w x ld floats, used in turn, are all the
//     shared memory a run holds, so several runs share an SM; only block b0
//     is computed twice (by this run and the one before it).
//   - Layout [row][phase], row stride ld = 4 * (ceil(B/4) | 1) floats: the
//     passes read a row's consecutive phases across a warp, the argmin a
//     row per thread in 16-byte pieces, both without bank conflicts.
//     Columns B .. ld-1 hold +inf and never win.
//   - The argmin keeps four running minima (phase k % 4) with strict <,
//     merged by (value, index): the first minimum, as torch.argmin and
//     jnp.argmin take it.
//   - The symbols of the next block are copied to shared memory with
//     cp.async while the current one is processed.
//   - No division in the grid slicer.  clip(rint((x - lo) / step), 0, top)
//     is a monotone step function of x, so the level is that of the count of
//     host thresholds at or below x (kernels/bps.py, slicer_tables: the
//     least float32 x of each level, found with the slicer's own float32
//     operations): up to 4 levels a chain of selects in registers, more a
//     binary search over a table in shared memory.  bps_exact_check holds
//     both against the division on all 2^32 float32 inputs.
//   - The arithmetic uses the _rn intrinsics, so nvcc contracts nothing into
//     an FMA and the kernel rounds as the plain PyTorch version does.
//   - Instances (all run against the plain version by the gpu tests and
//     chip_smoke.py): Grid4 (square QAM up to 16 points), GridSearch (larger
//     square QAM), and for any other constellation, or one given as a
//     tensor, Points16 (up to 16 points, in registers) and Points (more, in
//     shared memory).

#include <atomic>
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "stage.cuh"

namespace {

enum Route { kGrid4 = 0, kGridSearch = 1, kPoints = 2 };
constexpr int kRegPoints = 16;  // kPoints up to this many: Points16 (its tree needs 16)

constexpr int kMaxDevices = 64;
constexpr int kMaxThreads = 512;

struct Args {
  const float2* sig;  // (n, modes)
  int n, modes;
  const float* rot_re;  // (n_phases,)
  const float* rot_im;
  int n_phases, ld;
  const float* tab0;  // grid: thresholds (n_tab,); points: (M,) float2
  const float* tab1;  // grid: levels (n_tab,)
  int n_tab;
  int n_half, w, n_blocks, run_blocks;
  int out_kind;  // 0: int64 phase index, 1: float32 phase
  const float* phases;
  void* out;  // (n, modes)
};

// ld for B phases: a multiple of 4 whose quarter is odd.
__host__ __device__ inline int row_stride(int n_phases) {
  return 4 * (((n_phases + 3) / 4) | 1);
}

// Level of x on a grid of up to 4 levels: thr[1..3] (+inf past the last),
// lev[0..3] (the last repeated), a chain of selects.
struct Grid4 {
  float t1, t2, t3, l0, l1, l2, l3;
  __device__ void load(const Args& a, float*) {
    t1 = a.tab0[1];
    t2 = a.tab0[2];
    t3 = a.tab0[3];
    l0 = a.tab1[0];
    l1 = a.tab1[1];
    l2 = a.tab1[2];
    l3 = a.tab1[3];
  }
  __device__ __forceinline__ float slice(float x) const {
    float q = l0;
    q = x >= t1 ? l1 : q;
    q = x >= t2 ? l2 : q;
    q = x >= t3 ? l3 : q;
    return q;
  }
  __device__ __forceinline__ float dist(float zr, float zi) const {
    const float dr = __fsub_rn(zr, slice(zr));
    const float di = __fsub_rn(zi, slice(zi));
    return __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
  }
};

// Level of x on a grid of n_tab (a power of 2) table entries: thr[1 ..
// n_tab-1] (+inf past the last level), lev[0 .. n_tab-1] (the last level
// repeated), by binary search in shared memory.
struct GridSearch {
  const float* thr;
  const float* lev;
  int n_tab;
  __device__ void load(const Args& a, float* tab) {
    for (int i = threadIdx.x; i < a.n_tab; i += blockDim.x) {
      tab[i] = a.tab0[i];
      tab[a.n_tab + i] = a.tab1[i];
    }
    thr = tab;
    lev = tab + a.n_tab;
    n_tab = a.n_tab;
  }
  __device__ __forceinline__ float slice(float x) const {
    int k = 0;
    for (int half = n_tab >> 1; half > 0; half >>= 1) k += x >= thr[k + half] ? half : 0;
    return lev[k];
  }
  __device__ __forceinline__ float dist(float zr, float zi) const {
    const float dr = __fsub_rn(zr, slice(zr));
    const float di = __fsub_rn(zi, slice(zi));
    return __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
  }
};

// Minimum over up to 16 points held in registers: the list is padded with
// its first point, which leaves every minimum as it is, and the minimum is
// taken as a tree (exact in any order).
struct Points16 {
  float cr[kRegPoints], ci[kRegPoints];
  __device__ void load(const Args& a, float*) {
    const float2* src = reinterpret_cast<const float2*>(a.tab0);
#pragma unroll
    for (int j = 0; j < kRegPoints; ++j) {
      const float2 c = src[j < a.n_tab ? j : 0];
      cr[j] = c.x;
      ci[j] = c.y;
    }
  }
  __device__ __forceinline__ float dist(float zr, float zi) const {
    float d[kRegPoints];
#pragma unroll
    for (int j = 0; j < kRegPoints; ++j) {
      const float dr = __fsub_rn(zr, cr[j]);
      const float di = __fsub_rn(zi, ci[j]);
      d[j] = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
    }
    // the levels written out: a loop over h >>= 1 is not unrolled, and its
    // indexing would put d in local memory
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = fminf(d[j], d[j + 8]);
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = fminf(d[j], d[j + 4]);
    d[0] = fminf(d[0], d[2]);
    d[1] = fminf(d[1], d[3]);
    return fminf(d[0], d[1]);
  }
};

// Minimum over the M points, in shared memory.
struct Points {
  const float2* pts;
  int m;
  __device__ void load(const Args& a, float* tab) {
    float2* t = reinterpret_cast<float2*>(tab);
    const float2* src = reinterpret_cast<const float2*>(a.tab0);
    for (int i = threadIdx.x; i < a.n_tab; i += blockDim.x) t[i] = src[i];
    pts = t;
    m = a.n_tab;
  }
  __device__ __forceinline__ float dist(float zr, float zi) const {
    float d = CUDART_INF_F;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float2 c = pts[j];
      const float dr = __fsub_rn(zr, c.x);
      const float di = __fsub_rn(zi, c.y);
      d = fminf(d, __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di)));
    }
    return d;
  }
};

// Copy block X's w symbols of `mode` to dst (zeros outside the signal).
__device__ __forceinline__ void stage_block(const Args& a, float2* dst, int X, int mode) {
  for (int i = threadIdx.x; i < a.w; i += blockDim.x) {
    const long long s = (long long)X * a.w + i - a.n_half;
    if (s >= 0 && s < a.n)
      stage::cp8(dst + i, a.sig + s * a.modes + mode);
    else
      dst[i] = make_float2(0.0f, 0.0f);
  }
  stage::commit();
}

// Thread p's forward pass over one block: its distances into nxt and, with
// COMBINE, the prefix sums added to the previous block's suffix sums in cur
// (its windows): symbol i completes the window of row i + 1, i < w - 1.
// Four symbols at a time (the loads first, then the chain), pointers
// stepping a row at a time.
template <bool COMBINE, typename D>
__device__ __forceinline__ void forward(const D& dist, const float2* __restrict__ sx, float rr,
                                        float ri, float* __restrict__ cur,
                                        float* __restrict__ nxt, int w, int ld, int p) {
  auto distance = [&](float2 v) {
    const float zr = __fsub_rn(__fmul_rn(v.x, rr), __fmul_rn(v.y, ri));
    const float zi = __fadd_rn(__fmul_rn(v.x, ri), __fmul_rn(v.y, rr));
    return dist.dist(zr, zi);
  };
  float* __restrict__ cp = cur + ld + p;  // row i + 1 of cur
  float* __restrict__ np = nxt + p;       // row i of nxt
  float pre = 0.0f;
  int i = 0;
  for (; i + 4 < w; i += 4, cp += 4 * ld, np += 4 * ld) {
    float d[4], c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d[j] = distance(sx[i + j]);
      if (COMBINE) c[j] = cp[j * ld];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      np[j * ld] = d[j];
      pre = __fadd_rn(pre, d[j]);
      if (COMBINE) cp[j * ld] = __fadd_rn(c[j], pre);
    }
  }
  for (; i < w; ++i, cp += ld, np += ld) {
    const float d = distance(sx[i]);
    *np = d;
    pre = __fadd_rn(pre, d);
    if (COMBINE && i + 1 < w) *cp = __fadd_rn(*cp, pre);
  }
}

// Thread p's reverse pass: the block's distances into its suffix sums,
// eight rows at a time (the loads first, then the chain).
__device__ __forceinline__ void reverse(float* __restrict__ blk, int w, int ld, int p) {
  float* __restrict__ bp = blk + (w - 1) * ld + p;  // row i
  float suf = 0.0f;
  int i = w - 1;
  for (; i >= 7; i -= 8, bp -= 8 * ld) {
    float d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = bp[-j * ld];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      suf = __fadd_rn(d[j], suf);
      bp[-j * ld] = suf;
    }
  }
  for (; i >= 0; --i, bp -= ld) {
    suf = __fadd_rn(*bp, suf);
    *bp = suf;
  }
}

// The argmin of each finished window row of block X - 1, held in cur.
__device__ __forceinline__ void argmin_rows(const Args& a, const float* cur, int X, int mode) {
  const int nq = (a.n_phases + 3) >> 2;
  for (int r = threadIdx.x; r < a.w; r += blockDim.x) {
    const long long t = (long long)(X - 1) * a.w + r;
    if (t >= a.n) break;
    const float4* row = reinterpret_cast<const float4*>(cur + r * a.ld);
    float4 v = row[0];
    float b0 = v.x, b1 = v.y, b2 = v.z, b3 = v.w;
    int i0 = 0, i1 = 1, i2 = 2, i3 = 3;
    for (int k = 1; k < nq; ++k) {
      v = row[k];
      if (v.x < b0) b0 = v.x, i0 = 4 * k;
      if (v.y < b1) b1 = v.y, i1 = 4 * k + 1;
      if (v.z < b2) b2 = v.z, i2 = 4 * k + 2;
      if (v.w < b3) b3 = v.w, i3 = 4 * k + 3;
    }
    if (b1 < b0 || (b1 == b0 && i1 < i0)) b0 = b1, i0 = i1;
    if (b3 < b2 || (b3 == b2 && i3 < i2)) b2 = b3, i2 = i3;
    if (b2 < b0 || (b2 == b0 && i2 < i0)) b0 = b2, i0 = i2;
    const long long o = t * a.modes + mode;
    if (a.out_kind == 0)
      static_cast<long long*>(a.out)[o] = i0;
    else
      static_cast<float*>(a.out)[o] = a.phases[i0];
  }
}

template <typename D>
__global__ void __launch_bounds__(kMaxThreads) bps_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int w = a.w, ld = a.ld, B = a.n_phases;
  float* slots = smem;  // two slots of [w][ld]
  float2* syms = reinterpret_cast<float2*>(slots + 2 * w * ld);  // two of [w]
  float* tab = reinterpret_cast<float*>(syms + 2 * w);
  const int mode = blockIdx.y;
  const int b0 = blockIdx.x * a.run_blocks;
  const int b1 = min(b0 + a.run_blocks, a.n_blocks);
  const int p = threadIdx.x;

  stage_block(a, syms + (b0 & 1) * w, b0, mode);
  D dist;
  dist.load(a, tab);
  for (int i = threadIdx.x; i < 2 * w * (ld - B); i += blockDim.x)
    slots[(i / (ld - B)) * ld + B + i % (ld - B)] = CUDART_INF_F;
  const float rr = p < B ? a.rot_re[p] : 0.0f;
  const float ri = p < B ? a.rot_im[p] : 0.0f;
  stage::wait<0>();
  __syncthreads();

  for (int X = b0; X <= b1; ++X) {
    if (X > b0) {
      stage::wait<0>();
      __syncthreads();  // block X's symbols are in; block X - 2's rows are written
    }
    if (X < b1) stage_block(a, syms + ((X + 1) & 1) * w, X + 1, mode);
    float* cur = slots + ((X - 1) & 1) * w * ld;  // suffix sums of block X - 1
    float* nxt = slots + (X & 1) * w * ld;
    if (p < B) {
      const float2* sx = syms + (X & 1) * w;
      if (X > b0)
        forward<true>(dist, sx, rr, ri, cur, nxt, w, ld, p);
      else
        forward<false>(dist, sx, rr, ri, cur, nxt, w, ld, p);
      if (X < b1) reverse(nxt, w, ld, p);
    }
    if (X > b0) {
      __syncthreads();
      argmin_rows(a, cur, X, mode);
    }
  }
}

// The threshold slicers against the division on the float32 bit patterns
// [start, start + count): bad[0] counts the inputs whose level differs,
// bad[1 .. 4] keep up to four of them (bad zeroed by the caller).
template <typename D>
__global__ void exact_check_kernel(unsigned long long start, unsigned long long count, Args a,
                                   float lo, float step, float top, unsigned long long* bad) {
  __shared__ float tab[512];
  D grid;
  grid.load(a, tab);
  __syncthreads();
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long u = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < count; u += stride) {
    const float x = __uint_as_float((unsigned)(start + u));
    const float k = fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(x, lo), step)), 0.0f), top);
    const float q = __fadd_rn(__fmul_rn(k, step), lo);
    if (__float_as_uint(q) != __float_as_uint(grid.slice(x))) {
      const unsigned long long i = atomicAdd(bad, 1ull);
      if (i < 4) bad[1 + i] = start + u;
    }
  }
}

struct DeviceInfo {
  std::atomic<int> ready{0};
  int sms = 0, smem_sm = 0, smem_optin = 0, reserved = 0;
};
DeviceInfo g_info[kMaxDevices];

// The device's limits, read once; the kernels' shared-memory attributes set
// once per device: the most a block may take, and all of the SM's unified
// L1 / shared memory as shared memory, so that the CTAs a run length counts
// on fit.
cudaError_t device_info(const DeviceInfo** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& info = g_info[dev];
  if (!info.ready.load(std::memory_order_acquire)) {
    int sms, smem_sm, optin, reserved;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      dev)) ||
        (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)))
      return err;
    const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    const cudaFuncAttribute carve = cudaFuncAttributePreferredSharedMemoryCarveout;
    if ((err = cudaFuncSetAttribute(bps_kernel<Grid4>, attr, optin)) ||
        (err = cudaFuncSetAttribute(bps_kernel<GridSearch>, attr, optin)) ||
        (err = cudaFuncSetAttribute(bps_kernel<Points>, attr, optin)) ||
        (err = cudaFuncSetAttribute(bps_kernel<Points16>, attr, optin)) ||
        (err = cudaFuncSetAttribute(bps_kernel<Grid4>, carve, cudaSharedmemCarveoutMaxShared)) ||
        (err = cudaFuncSetAttribute(bps_kernel<GridSearch>, carve,
                                    cudaSharedmemCarveoutMaxShared)) ||
        (err = cudaFuncSetAttribute(bps_kernel<Points>, carve, cudaSharedmemCarveoutMaxShared)) ||
        (err = cudaFuncSetAttribute(bps_kernel<Points16>, carve,
                                    cudaSharedmemCarveoutMaxShared)))
      return err;
    info.sms = sms;
    info.smem_sm = smem_sm;
    info.smem_optin = optin;
    info.reserved = reserved;
    info.ready.store(1, std::memory_order_release);
  }
  *out = &info;
  return cudaSuccess;
}

}  // namespace

// Shared memory (bytes) a CTA takes: two slots, two blocks of symbols, the
// route's table (n_tab entries); INT_MAX past it.
extern "C" int bps_smem_bytes(int n_half, int n_phases, int route, int n_tab) {
  const long long w = 2LL * n_half + 1;
  const long long tab = route == kGridSearch ? 2LL * n_tab * 4 : route == kPoints ? n_tab * 8LL : 0;
  const long long bytes = 2 * w * row_stride(n_phases) * 4 + 2 * w * 8 + tab;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// Phase estimates of sig (n, modes) complex64 into out (n, modes): int64
// indices (out_kind 0) or float32 phases[index] (out_kind 1).  rot_*:
// (n_phases,) f32.  route kGrid4 / kGridSearch: tab0 the thresholds, tab1
// the levels (n_tab each, kernels/bps.py slicer_tables); kPoints: tab0 the
// (n_tab,) complex64 constellation.  run_blocks: output blocks of w symbols
// per CTA, 0 to spread them over the card.  Launches on `stream`; returns a
// CUDA error code (0 on success).
extern "C" int bps_launch(const void* sig, int n, int modes, const void* rot_re,
                          const void* rot_im, int n_phases, int route, const void* tab0,
                          const void* tab1, int n_tab, int n_half, int run_blocks, int out_kind,
                          const void* phases, void* out, void* stream) {
  if (n_phases < 1 || n_phases > kMaxThreads || n_half < 0 || modes < 1 || n < 1 ||
      route < kGrid4 || route > kPoints || (route == kGrid4 && n_tab != 4) || n_tab < 1 ||
      (route == kGridSearch && (n_tab & (n_tab - 1))))
    return (int)cudaErrorInvalidValue;
  const DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return (int)err;
  const int smem = bps_smem_bytes(n_half, n_phases, route, n_tab);
  if (smem > info->smem_optin) return (int)cudaErrorInvalidValue;
  const int threads = (n_phases + 31) / 32 * 32;
  const int w = 2 * n_half + 1;
  const int n_blocks = (int)(((long long)n + w - 1) / w);
  if (run_blocks <= 0) {  // one wave of CTAs over the card
    int per_sm = (int)(info->smem_sm / (smem + info->reserved));
    per_sm = min(per_sm, min(2048 / threads, 32));
    const long long slots = (long long)info->sms * max(per_sm, 1);
    run_blocks = (int)max(1LL, ((long long)n_blocks * modes + slots - 1) / slots);
  }
  const Args a{(const float2*)sig, n, modes, (const float*)rot_re, (const float*)rot_im,
               n_phases, row_stride(n_phases), (const float*)tab0, (const float*)tab1, n_tab,
               n_half, w, n_blocks, run_blocks, out_kind, (const float*)phases, out};
  const dim3 grid((n_blocks + run_blocks - 1) / run_blocks, modes);
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kGrid4)
    bps_kernel<Grid4><<<grid, threads, smem, s>>>(a);
  else if (route == kGridSearch)
    bps_kernel<GridSearch><<<grid, threads, smem, s>>>(a);
  else if (n_tab <= kRegPoints)
    bps_kernel<Points16><<<grid, threads, smem, s>>>(a);
  else
    bps_kernel<Points><<<grid, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The exactness check of a grid slicer (route kGrid4 or kGridSearch, tables
// as for bps_launch, n_tab <= 256) against clip(rint((x - lo) / step), 0,
// top) * step + lo with a true division, on the float32 bit patterns
// [start, start + count).  bad: (5,) uint64, zeroed by the caller.
extern "C" int bps_exact_check(unsigned long long start, unsigned long long count, int route,
                               const void* thr, const void* lev, int n_tab, float lo,
                               float step, float top, void* bad, void* stream) {
  if ((route != kGrid4 && route != kGridSearch) || (route == kGrid4 && n_tab != 4) ||
      n_tab < 1 || n_tab > 256)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.tab0 = (const float*)thr;
  a.tab1 = (const float*)lev;
  a.n_tab = n_tab;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* b = (unsigned long long*)bad;
  if (route == kGrid4)
    exact_check_kernel<Grid4><<<132 * 8, 256, 0, s>>>(start, count, a, lo, step, top, b);
  else
    exact_check_kernel<GridSearch><<<132 * 8, 256, 0, s>>>(start, count, a, lo, step, top, b);
  return (int)cudaGetLastError();
}
