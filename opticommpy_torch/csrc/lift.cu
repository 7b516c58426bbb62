// One flooding min-sum / normalized min-sum iteration of a lifted-circulant
// LDPC decoder (IEEE 802.11n, AR4JA), hand-written for Hopper (sm_90a): K12.
//
// Replaces: opticommpy_tpu/kernels/lift_pallas.py, `_iter_body` and
// `_msa_group` (launched by `lift_iter_pallas`).
//
// Layout: planes of (L, B) with the codeword axis B contiguous.  X and X'
// (E, L, B) hold the check-aligned extrinsic totals in the message type
// (edge plane e = off + sl * ng + ig of check group ig of a degree bucket);
// llr and T (V, L, B) float32 the channel LLRs and the new totals in
// variable-bucket order; m (E, L, B) is scratch for the new messages.
//
// What bounds it on an H100: bytes.  An iteration must read X and the LLRs
// and write X' and T (at AR4JA 8192 R1/2, B = 1024, bfloat16: ~210 MB,
// 0.063 ms at 3.35 TB/s).  This three-phase design also writes the
// messages once and reads them twice, and reads every total once per edge:
// ~525 MB, part of it from the 50 MB L2.
//
// What held the first version back (one CTA of 8 x 32 threads per tile of
// 8 codewords, 1.34 ms at that shape, 5% of the bound; PERF.md): 128 CTAs,
// one on each of 128 SMs, each thread walking its rows through the three
// phases with an index load from device memory before every data load, in
// loops whose trip counts were run-time values, so few loads were in
// flight; and 2-byte loads used 16 of every 32-byte sector.
//
// Design: each phase is a launch whose (row, codeword-vector) items are
// spread over every warp of the card (a grid of as many 256-thread CTAs as
// the SMs hold at once, striding over the items); the launch order is the
// barrier the rolls across rows need.
// - A thread takes VW neighbouring codewords of one row: 16 bytes of
//   messages (8 bfloat16 or 4 float32), a 16-byte vector load or store,
//   neighbouring threads on neighbouring vectors.  Where B is not a
//   multiple of VW (or a pointer is not 16-byte aligned) the rows cannot be
//   read in 16-byte pieces, and the VW = 1 instance runs.
// - The tables (at most kMaxE edges, kMaxG planes) are copied into shared
//   memory once per CTA, so no index load from device memory precedes a
//   data load.
// - Phase 1 loads a check row's d values together into registers and keeps
//   them there between the two-minimum pass and the message pass, so X is
//   read once; its instances hold up to 8 or 24 values (DMAX), which covers
//   the shipped codes' check degrees (3 to 22).
// - Phases 2 and 3 issue the loads of four edges before they use them.
// Bits: every message, total and X' value is computed elementwise per
// (row, codeword) by the operations of the first version in its order (T
// summed from the channel LLR in the table's order with __fadd_rn, the
// rounding points of the TPU kernel), so any spread of the items gives the
// plain version's bits (opticommpy_torch/kernels/lift.py, lift_iter_plain).
// ok: phase 1 sets every codeword's flag and phase 3 clears the flag of a
// codeword with a check row of odd parity; the stores are all alike, so
// their order does not matter.  The TPU kernel needed L % 8 == 0 (its
// sublane tile); this one takes any L.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxE = 256;  // edge planes the shared tables hold
constexpr int kMaxG = 64;   // check or variable planes they hold
constexpr int kBatch = 4;   // edges whose loads phases 2 and 3 issue together

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VW codewords of one row: messages in their type, totals in float32
template <typename T, int VW>
struct alignas(sizeof(T) * VW) Msg {
  T v[VW];
};
template <int VW>
struct alignas(VW * 4 > 16 ? 16 : VW * 4) Tot {
  float v[VW];
};

// the item `it` of a phase over G planes of LN vectors: plane and vector
__device__ __forceinline__ void split(unsigned it, unsigned LN, int& g, int& f) {
  g = (int)(it / LN);
  f = (int)(it - (unsigned)g * LN);
}

// vector f of a plane rolled by sh rows (nvec vectors a row): out[l] = p[l - sh]
__device__ __forceinline__ int rolled(int f, int sh, int nvec, int LN) {
  const int r = f - sh * nvec;
  return r < 0 ? r + LN : r;
}

// Phase 1: per check row, the two smallest |x| and the sign parity, then
// each slot's leave-one-out message (NMSA scale, then the storage rounding).
template <typename T, int VW, int DMAX>
__global__ void __launch_bounds__(kThreads)
lift_check_kernel(const T* __restrict__ x, const int* __restrict__ cg_off,
                  const int* __restrict__ c_e, int C, int B, int LN,
                  int use_alpha, float alpha, T* __restrict__ m,
                  int* __restrict__ ok) {
  __shared__ int s_off[kMaxG + 1], s_e[kMaxE];
  if (cg_off[C] > kMaxE) __trap();
  for (int i = threadIdx.x; i <= C; i += kThreads) s_off[i] = cg_off[i];
  for (int i = threadIdx.x; i < cg_off[C]; i += kThreads) s_e[i] = c_e[i];
  __syncthreads();
  const unsigned gt = blockIdx.x * kThreads + threadIdx.x, gs = gridDim.x * kThreads;
  for (unsigned b = gt; b < (unsigned)B; b += gs) ok[b] = 1;
  using M = Msg<T, VW>;
  const M* xv = reinterpret_cast<const M*>(x);
  M* mv = reinterpret_cast<M*>(m);
  for (unsigned it = gt; it < (unsigned)C * LN; it += gs) {
    int c, f;
    split(it, LN, c, f);
    const int k0 = s_off[c], d = s_off[c + 1] - k0;
    M xs[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) xs[i] = xv[(size_t)s_e[k0 + i] * LN + f];
    float m1[VW], m2[VW];
    unsigned par = 0;  // bit u: the sign parity of codeword u
#pragma unroll
    for (int u = 0; u < VW; ++u) m1[u] = m2[u] = CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
#pragma unroll
        for (int u = 0; u < VW; ++u) {
          const float xf = to_f(xs[i].v[u]);
          const float mag = fabsf(xf);
          m2[u] = fminf(m2[u], fmaxf(m1[u], mag));
          m1[u] = fminf(m1[u], mag);
          par ^= (unsigned)(xf < 0.0f) << u;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        M o;
#pragma unroll
        for (int u = 0; u < VW; ++u) {
          const float xf = to_f(xs[i].v[u]);
          float om = fabsf(xf) == m1[u] ? m2[u] : m1[u];
          if (use_alpha) om = __fmul_rn(om, alpha);
          o.v[u] = from_f<T>((((par >> u) & 1u) ^ (unsigned)(xf < 0.0f)) ? -om : om);
        }
        mv[(size_t)s_e[k0 + i] * LN + f] = o;
      }
    }
  }
}

// Phase 2: per variable row, T = the channel LLR plus the plane's messages
// rolled back, added one by one in the TPU kernel's order (check bucket,
// group, slot; the order of the CSR table).
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
lift_var_kernel(const T* __restrict__ m, const float* __restrict__ llr,
                const int* __restrict__ vg_off, const int* __restrict__ v_e,
                const int* __restrict__ v_sh, int V, int nvec, int LN,
                float* __restrict__ t) {
  __shared__ int s_off[kMaxG + 1], s_e[kMaxE], s_sh[kMaxE];
  if (vg_off[V] > kMaxE) __trap();
  for (int i = threadIdx.x; i <= V; i += kThreads) s_off[i] = vg_off[i];
  for (int i = threadIdx.x; i < vg_off[V]; i += kThreads) {
    s_e[i] = v_e[i];
    s_sh[i] = v_sh[i];
  }
  __syncthreads();
  using M = Msg<T, VW>;
  using F = Tot<VW>;
  const M* mv = reinterpret_cast<const M*>(m);
  const F* lv = reinterpret_cast<const F*>(llr);
  F* tv = reinterpret_cast<F*>(t);
  const unsigned gt = blockIdx.x * kThreads + threadIdx.x, gs = gridDim.x * kThreads;
  for (unsigned it = gt; it < (unsigned)V * LN; it += gs) {
    int v, f;
    split(it, LN, v, f);
    const int k0 = s_off[v], k1 = s_off[v + 1];
    F acc = lv[(size_t)v * LN + f];
    for (int k = k0; k < k1; k += kBatch) {
      M ms[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (k + i < k1)
          ms[i] = mv[(size_t)s_e[k + i] * LN + rolled(f, s_sh[k + i], nvec, LN)];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (k + i < k1) {
#pragma unroll
          for (int u = 0; u < VW; ++u) acc.v[u] = __fadd_rn(acc.v[u], to_f(ms[i].v[u]));
        }
    }
    tv[(size_t)v * LN + f] = acc;
  }
}

// Phase 3: per check row, totm = the rolled total rounded to the message
// type, X' = totm - m rounded, and the parity of the signs of totm; a
// codeword with a row of odd parity loses its flag.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
lift_out_kernel(const float* __restrict__ t, const T* __restrict__ m,
                const int* __restrict__ cg_off, const int* __restrict__ c_e,
                const int* __restrict__ c_v, const int* __restrict__ c_sh,
                int C, int nvec, int LN, T* __restrict__ xo,
                int* __restrict__ ok) {
  __shared__ int s_off[kMaxG + 1], s_e[kMaxE], s_v[kMaxE], s_sh[kMaxE];
  if (cg_off[C] > kMaxE) __trap();
  for (int i = threadIdx.x; i <= C; i += kThreads) s_off[i] = cg_off[i];
  for (int i = threadIdx.x; i < cg_off[C]; i += kThreads) {
    s_e[i] = c_e[i];
    s_v[i] = c_v[i];
    s_sh[i] = c_sh[i];
  }
  __syncthreads();
  using M = Msg<T, VW>;
  using F = Tot<VW>;
  const M* mv = reinterpret_cast<const M*>(m);
  const F* tv = reinterpret_cast<const F*>(t);
  M* ov = reinterpret_cast<M*>(xo);
  const unsigned gt = blockIdx.x * kThreads + threadIdx.x, gs = gridDim.x * kThreads;
  for (unsigned it = gt; it < (unsigned)C * LN; it += gs) {
    int c, f;
    split(it, LN, c, f);
    const int k0 = s_off[c], k1 = s_off[c + 1];
    unsigned par = 0;
    for (int k = k0; k < k1; k += kBatch) {
      F ts[kBatch];
      M ms[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (k + i < k1) {
          ts[i] = tv[(size_t)s_v[k + i] * LN + rolled(f, s_sh[k + i], nvec, LN)];
          ms[i] = mv[(size_t)s_e[k + i] * LN + f];
        }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (k + i < k1) {
          M o;
#pragma unroll
          for (int u = 0; u < VW; ++u) {
            const float totm = to_f(from_f<T>(ts[i].v[u]));
            o.v[u] = from_f<T>(__fsub_rn(totm, to_f(ms[i].v[u])));
            par ^= (unsigned)(totm < 0.0f) << u;
          }
          ov[(size_t)s_e[k + i] * LN + f] = o;
        }
    }
    if (par) {
      const int b0 = (f % nvec) * VW;
#pragma unroll
      for (int u = 0; u < VW; ++u)
        if ((par >> u) & 1u) ok[b0 + u] = 0;
    }
  }
}

// CTAs that fill the card for `items` items: the SMs times the CTAs of
// kernel K one SM holds at once, fewer where the items need fewer
template <auto K>
int grid_for(long long items) {
  static int per_sm = 0;  // the same on every device of one architecture
  if (per_sm == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, K, kThreads, 0);
    per_sm = n > 0 ? n : 1;
  }
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (items + kThreads - 1) / kThreads;
  const long long full = (long long)sms * per_sm;
  return (int)(need < full ? (need > 0 ? need : 1) : full);
}

template <typename T, int VW, int DMAX>
int run(int L, int V, int C, int B, int use_alpha, float alpha, const void* x,
        const void* llr, const void* cg_off, const void* c_e, const void* c_v,
        const void* c_sh, const void* vg_off, const void* v_e,
        const void* v_sh, void* m, void* xo, void* t, void* ok,
        cudaStream_t s) {
  const int nvec = B / VW, LN = L * nvec;
  const int g1 = grid_for<lift_check_kernel<T, VW, DMAX>>((long long)C * LN);
  lift_check_kernel<T, VW, DMAX><<<g1, kThreads, 0, s>>>(
      (const T*)x, (const int*)cg_off, (const int*)c_e, C, B, LN, use_alpha,
      alpha, (T*)m, (int*)ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int g2 = grid_for<lift_var_kernel<T, VW>>((long long)V * LN);
  lift_var_kernel<T, VW><<<g2, kThreads, 0, s>>>(
      (const T*)m, (const float*)llr, (const int*)vg_off, (const int*)v_e,
      (const int*)v_sh, V, nvec, LN, (float*)t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int g3 = grid_for<lift_out_kernel<T, VW>>((long long)C * LN);
  lift_out_kernel<T, VW><<<g3, kThreads, 0, s>>>(
      (const float*)t, (const T*)m, (const int*)cg_off, (const int*)c_e,
      (const int*)c_v, (const int*)c_sh, C, nvec, LN, (T*)xo, (int*)ok);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// K12: one iteration (x, llr) -> (xo, t, ok).  x, xo, m (E, L, B) float32
// (msg_bf16 = 0) or bfloat16 (msg_bf16 = 1); llr, t (V, L, B) float32; ok
// (B,) int32.  cg_off (C+1,) with c_e, c_v, c_sh (E,): each check group's
// slots (edge plane, variable plane, roll); vg_off (V+1,) with v_e, v_sh
// (E,): each variable plane's edge planes and back-rolls in adding order.
// max_deg: the largest check degree (at most 24).  Launches on `stream`
// and returns the first CUDA error (0 on success).
extern "C" int lift_iter_launch(int msg_bf16, int L, int V, int C, int B,
                                int use_alpha, float alpha, const void* x,
                                const void* llr, const void* cg_off,
                                const void* c_e, const void* c_v,
                                const void* c_sh, const void* vg_off,
                                const void* v_e, const void* v_sh, void* m,
                                void* xo, void* t, void* ok, int max_deg,
                                void* stream) {
  if (L < 1 || V < 1 || C < 1 || B < 1 || V > kMaxG || C > kMaxG || max_deg < 1 ||
      max_deg > 24 || (long long)(C > V ? C : V) * L * B >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = aligned16(x) && aligned16(llr) && aligned16(m) && aligned16(xo) &&
                   aligned16(t);
  const bool narrow = max_deg <= 8;
#define LIFT_RUN(T, VW, DMAX)                                                    \
  run<T, VW, DMAX>(L, V, C, B, use_alpha, alpha, x, llr, cg_off, c_e, c_v, c_sh, \
                   vg_off, v_e, v_sh, m, xo, t, ok, s)
  if (msg_bf16) {
    if (vec && B % 8 == 0)
      return narrow ? LIFT_RUN(__nv_bfloat16, 8, 8) : LIFT_RUN(__nv_bfloat16, 8, 24);
    return narrow ? LIFT_RUN(__nv_bfloat16, 1, 8) : LIFT_RUN(__nv_bfloat16, 1, 24);
  }
  if (vec && B % 4 == 0)
    return narrow ? LIFT_RUN(float, 4, 8) : LIFT_RUN(float, 4, 24);
  return narrow ? LIFT_RUN(float, 1, 8) : LIFT_RUN(float, 1, 24);
#undef LIFT_RUN
}
