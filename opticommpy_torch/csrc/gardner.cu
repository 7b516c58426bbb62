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
// (~30 float operations and a data-dependent skip/stuff decision per
// output sample) and the issue of its ~150 instructions.  Its bytes (8 per
// input sample, 12 per output sample) and operations are far below what
// would bound it; the time is the step's latency times the sample count.
//
// What held the first version back (one thread per mode, both modes in one
// warp, ~600 cycles per input sample on path A's input; probes in
// PERF.md): the next input sample came from device memory, from a strided
// column, and the register queue that was to hold it four iterations ahead
// shifted by one register per step, so each step waited on the load issued
// one step before (~210 cycles of the 600); the two strided stores per
// step cost ~125 more.
//
// Design: one warp per mode, one launch for all modes (the TPU wrapper
// launched once per mode).  Lane 0 runs the mode's loop; the warp stages
// the input.
// - The mode's column is copied with cp.async, a chunk of 1024 samples at
//   a time (8 bytes a sample, so any number of interleaved modes), into a
//   two-slot ring in shared memory.  The loop runs in
//   segments: segment j reads chunk j and ends when the next sample it
//   needs lies in chunk j + 1, which was issued at the segment's start; the
//   warp then waits for it and issues chunk j + 2 into the slot of chunk j,
//   which nothing reads any more.  m advances 0 or 1 per iteration, so a
//   segment runs about 1024 iterations.
// - The 4-sample window x[m-2 .. m+1] lives in registers; the sample that
//   enters it when m advances, x[m+2], is read from the ring at the top of
//   the iteration, a whole step before it is needed.
// - Each step appends (eo value, t, n) to a log in shared memory; at the
//   end of a segment, or when the log is full, the warp writes the log's
//   steps out in order, 32 at a time, where of the lanes writing one index
//   the latest step's wins, so the loop issues no global store and the
//   TPU's record pass disappears.  The timing error reads eo[n-2 .. n]
//   back: from a register cache of the last four writes when one of them
//   is that index (the usual case), else from the newest logged write to
//   it, else from the output buffer, which holds the last value written
//   there or its initial zero.  That is the lax.while_loop's semantics
//   (the reference): an index the NCO stuffed over keeps zero, or the
//   value it held before a backstep;
// - the step has no data-dependent branch but that rare read-back: the
//   cache lookups, the timing error (computed on every step, kept on even
//   n), the skip/stuff decision and the window shift are selects.  A GPU
//   does not predict branches, and the first version's ~15 per step (the
//   lookups compiled to compare-and-branch chains) cost more than its
//   arithmetic.  The loop is not unrolled: unrolled by 2, 4 or 8 it ran
//   slower (PERF.md);
// - the arithmetic uses the _rn intrinsics, so nvcc does not contract it
//   into FMAs: it rounds exactly as the plain PyTorch version in
//   opticommpy_torch/kernels/gardner.py, and a skip/stuff decision, which
//   shifts every later sample, cannot part the two.

#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 1024;  // input samples per staged chunk, a power of two

// the interpolator's coefficients, rounded from double as the JAX package
// rounds its Python constants
constexpr float kM6 = static_cast<float>(-1.0 / 6.0);
constexpr float kP6 = static_cast<float>(1.0 / 6.0);
constexpr float kP3 = static_cast<float>(1.0 / 3.0);

struct Cache {  // the last four (index, value) writes, newest first
  int i0 = -1, i1 = -1, i2 = -1, i3 = -1;
  float2 v0 = {0.0f, 0.0f}, v1 = {0.0f, 0.0f}, v2 = {0.0f, 0.0f}, v3 = {0.0f, 0.0f};

  __device__ __forceinline__ void push(int i, float2 v) {
    i3 = i2; v3 = v2;
    i2 = i1; v2 = v1;
    i1 = i0; v1 = v0;
    i0 = i;  v0 = v;
  }
};

// eo[k] from the newest of the last four writes to k, without a branch;
// `miss` when none of them wrote k (then the output buffer holds it)
__device__ __forceinline__ float2 pick(const Cache& c, int k, bool& miss) {
  float2 v = c.v3;
  v = k == c.i2 ? c.v2 : v;
  v = k == c.i1 ? c.v1 : v;
  v = k == c.i0 ? c.v0 : v;
  miss = k != c.i0 && k != c.i1 && k != c.i2 && k != c.i3;
  return v;
}

__device__ __forceinline__ float power(float2 v) {
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

template <bool NYQUIST>
__global__ void __launch_bounds__(kWarp) gardner_kernel(
    const float2* __restrict__ sig, int n_in, int modes, int n_out, float kp,
    float ki, int max_iters, float2* __restrict__ eo_all,
    float* __restrict__ tv_all, int* __restrict__ n_final) {
  const int mode = blockIdx.x;
  const int lane = threadIdx.x;
  const float2* col = sig + mode;
  float2* eo = eo_all + mode;
  float* tv = tv_all + mode;
  __shared__ __align__(16) float2 ring[2 * kChunk];  // sample i at i % (2 kChunk)
  // the segment's steps in order: (eo value, t, n the value was written at)
  __shared__ float4 rec[kChunk];

  // chunk j of the column into its slot, 8 bytes a sample
  auto issue = [&](int j) {
    const int hi = min((j + 1) * kChunk, n_in);
    for (int i = j * kChunk + lane; i < hi; i += kWarp)
      stage::cp8(ring + (i & (2 * kChunk - 1)), col + (size_t)i * modes);
    stage::commit();
  };
  // eo[k] as the loop has written it: the newest of this segment's logged
  // writes to k, else the output buffer (earlier segments' writes, or zero)
  auto read_back = [&](int len, int k) {
    for (int i = len - 1; i >= 0; --i)
      if (__float_as_int(rec[i].w) == k) return make_float2(rec[i].x, rec[i].y);
    return eo[(size_t)k * modes];
  };
  // The logged steps' writes, in order: step i wrote eo[n_i] (n_i >= 0) and
  // tv[clip(n_{i+1})], n_{i+1} the next step's n or, after the last, n_end.
  // 32 steps at a time, one lane each; of the lanes writing one index the
  // highest, the latest step, writes it; the groups go out in order.
  auto replay = [&](int len, int n_end) {
    for (int g = 0; g < len; g += kWarp) {
      const int i = g + lane;
      const bool live = i < len;
      const float4 r = live ? rec[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int ne = __float_as_int(r.w);
      const int nt = min(max(i + 1 < len ? __float_as_int(rec[i + 1].w) : n_end, 0),
                         n_out - 1);
      const unsigned same_e = __match_any_sync(0xffffffffu, live && ne >= 0 ? ne : -1 - lane);
      if (live && ne >= 0 && (same_e >> lane) == 1u) eo[(size_t)ne * modes] = make_float2(r.x, r.y);
      const unsigned same_t = __match_any_sync(0xffffffffu, live ? nt : -1 - lane);
      if (live && (same_t >> lane) == 1u) tv[(size_t)nt * modes] = r.z;
      __syncwarp();  // this group's writes land before the next group's
    }
  };
  issue(0);
  issue(1);
  stage::wait<1>();
  __syncwarp();  // chunk 0 visible to lane 0

  // the loop's state, live in lane 0 across segments
  int n = 2, m = 2, it = 0;
  float ip = 0.0f, t = 0.0f;
  float2 w0 = ring[0], w1 = ring[1], w2 = ring[2], w3 = ring[3];  // n_in >= 5
  Cache cache;

  // segments: lane 0 steps while x[m+2] lies in chunk j and the log has
  // room; then the warp writes the log out and, where lane 0 needs chunk
  // j + 1, waits for it and brings chunk j + 2 into the slot of chunk j
  for (int j = 0;;) {
    int done = 0, len = 0;
    if (lane == 0) {
      // x[m + 2] must lie in chunk j: m < (j + 1) kChunk - 2
      const int m_end = min((j + 1) * kChunk, n_in) - 2;
#pragma unroll 1
      for (; it < max_iters && n < n_out - 1 && m < m_end && len < kChunk; ++it) {
        // the sample that enters the window if m advances, a step ahead
        const float2 nxt = ring[(m + 2) & (2 * kChunk - 1)];

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
        cache.push(n, val);

        // timing error on eo[s .. s+2], s = clip(n - 2, 0, n_out - 3), taken
        // on even n; computed on every step and kept by a select, so the
        // step has no data-dependent branch but the rare read-back
        const int s = min(max(n - 2, 0), n_out - 3);
        bool miss0, miss1, miss2;
        float2 e0 = pick(cache, s, miss0);
        float2 e1 = pick(cache, s + 1, miss1);
        float2 e2 = pick(cache, s + 2, miss2);
        const bool even = (n & 1) == 0;
        if (even && (miss0 || miss1 || miss2)) {  // an index the cache lost
          if (miss0) e0 = read_back(len, s);
          if (miss1) e1 = read_back(len, s + 1);
          if (miss2) e2 = read_back(len, s + 2);
        }
        float ted;
        if (NYQUIST) {
          ted = __fmul_rn(power(e1), __fsub_rn(power(e0), power(e2)));
        } else {
          ted = __fadd_rn(__fmul_rn(e1.x, __fsub_rn(e2.x, e0.x)),
                          __fmul_rn(e1.y, __fsub_rn(e2.y, e0.y)));
        }
        const float ip_ted = __fadd_rn(__fmul_rn(ki, ted), ip);
        const float t_ted = __fsub_rn(t, __fadd_rn(__fmul_rn(kp, ted), ip_ted));
        ip = even ? ip_ted : ip;
        t = even ? t_ted : t;

        // NCO clock gap: skip (over) or stuff (under) a sample
        const bool over = t > 1.0f;
        const bool under = t < -1.0f;
        const float t_dn = __fsub_rn(t, 1.0f);
        const float t_up = __fadd_rn(t, 1.0f);
        t = over ? t_dn : (under ? t_up : t);
        rec[len++] = make_float4(val.x, val.y, t, __int_as_float(n));
        n += over ? -1 : (under ? 2 : 1);
        // m advances unless the NCO skipped: the window shifts by one
        m += over ? 0 : 1;
        w0 = over ? w0 : w1;
        w1 = over ? w1 : w2;
        w2 = over ? w2 : w3;
        w3 = over ? w3 : nxt;
      }
      done = !(it < max_iters && n < n_out - 1 && m < n_in - 2);
    }
    const unsigned all = 0xffffffffu;
    done = __shfl_sync(all, done, 0);
    len = __shfl_sync(all, len, 0);
    __syncwarp();  // the log visible to every lane
    replay(len, __shfl_sync(all, n, 0));
    if (done) break;
    if (__shfl_sync(all, m + 2 >= (j + 1) * kChunk, 0)) {
      // lane 0 needs chunk j + 1: wait for it, then bring chunk j + 2 into
      // the slot of chunk j
      stage::wait<0>();
      __syncwarp();
      issue(j + 2);
      ++j;
    }
  }
  stage::wait<0>();  // no copy outlives the block
  if (lane == 0) n_final[mode] = n;
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
  auto kernel = nyquist ? gardner_kernel<true> : gardner_kernel<false>;
  kernel<<<modes, kWarp, 0, (cudaStream_t)stream>>>(
      (const float2*)sig, n_in, modes, n_out, kp, ki, max_iters, (float2*)eo,
      (float*)tv, (int*)n_final);
  return (int)cudaGetLastError();
}
