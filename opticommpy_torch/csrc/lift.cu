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
// What bounds it on an H100: bytes.  An iteration reads X and writes X' and
// the messages, reads every message again for the totals and every total
// once per edge for X'.  At AR4JA 8192 R1/2, B = 1024, bfloat16, that is
// 60 edge planes of 512 x 1024 values, ~63 MB each way, a few hundred MB in
// all, some of it served by the 50 MB L2.
//
// Design: one CTA per tile of 8 codewords, 8 x 32 threads (a warp reads 8
// neighbouring codewords of 4 rows: whole 32-byte sectors in float32).  The
// CTA runs the three phases of the iteration over all rows of its
// codewords, separated by __syncthreads, so no other CTA's data is ever
// needed and nothing is atomic in device memory:
//  1. per check group and row, the two smallest |x| and the sign parity,
//     then each slot's leave-one-out message (NMSA scale, then the storage
//     rounding), written to m;
//  2. per variable plane and row, T = the channel LLR plus the plane's
//     messages rolled back, added one by one with __fadd_rn in the order the
//     TPU kernel adds them (check bucket, group, slot; from a CSR table), so
//     T equals the plain version bit for bit;
//  3. per check group and row, totm = the rolled total rounded to the
//     message type, X' = totm - m rounded, and the parity of the signs of
//     totm; a codeword passes when no row of any group has odd parity (an
//     OR in shared memory, order-free).
// The TPU kernel needed L % 8 == 0 (its sublane tile); this one takes any L.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTB = 8;     // codewords per CTA
constexpr int kRows = 32;  // row lanes per CTA

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

template <typename T>
__global__ void __launch_bounds__(kTB* kRows)
lift_iter_kernel(const T* __restrict__ x, const float* __restrict__ llr,
                 const int* __restrict__ cg_off, const int* __restrict__ c_e,
                 const int* __restrict__ c_v, const int* __restrict__ c_sh,
                 const int* __restrict__ vg_off, const int* __restrict__ v_e,
                 const int* __restrict__ v_sh, int L, int V, int C, int B,
                 int use_alpha, float alpha, T* __restrict__ m,
                 T* __restrict__ xo, float* __restrict__ t,
                 int* __restrict__ ok) {
  __shared__ int s_bad[kTB];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * kTB + tx;
  const bool live = b < B;
  const size_t LB = (size_t)L * B;
  if (ty == 0) s_bad[tx] = 0;
  if (live) {  // 1: leave-one-out messages
    for (int c = 0; c < C; ++c) {
      const int k0 = cg_off[c], k1 = cg_off[c + 1];
      for (int l = ty; l < L; l += kRows) {
        const size_t lb = (size_t)l * B + b;
        float m1 = CUDART_INF_F, m2 = CUDART_INF_F;
        bool par = false;
        for (int k = k0; k < k1; ++k) {
          const float xv = to_f(x[c_e[k] * LB + lb]);
          const float mag = fabsf(xv);
          m2 = fminf(m2, fmaxf(m1, mag));
          m1 = fminf(m1, mag);
          par ^= xv < 0.0f;
        }
        for (int k = k0; k < k1; ++k) {
          const size_t at = c_e[k] * LB + lb;
          const float xv = to_f(x[at]);
          float om = fabsf(xv) == m1 ? m2 : m1;
          if (use_alpha) om = __fmul_rn(om, alpha);
          m[at] = from_f<T>((par ^ (xv < 0.0f)) ? -om : om);
        }
      }
    }
  }
  __syncthreads();
  if (live) {  // 2: the totals, in the TPU kernel's order
    for (int v = 0; v < V; ++v) {
      const int k0 = vg_off[v], k1 = vg_off[v + 1];
      for (int l = ty; l < L; l += kRows) {
        float acc = llr[v * LB + (size_t)l * B + b];
        for (int k = k0; k < k1; ++k) {
          int ll = l - v_sh[k];
          if (ll < 0) ll += L;
          acc = __fadd_rn(acc, to_f(m[v_e[k] * LB + (size_t)ll * B + b]));
        }
        t[v * LB + (size_t)l * B + b] = acc;
      }
    }
  }
  __syncthreads();
  bool bad = false;
  if (live) {  // 3: X' and the parity of every check row
    for (int c = 0; c < C; ++c) {
      const int k0 = cg_off[c], k1 = cg_off[c + 1];
      for (int l = ty; l < L; l += kRows) {
        const size_t lb = (size_t)l * B + b;
        bool par = false;
        for (int k = k0; k < k1; ++k) {
          int ll = l - c_sh[k];
          if (ll < 0) ll += L;
          const float totm =
              to_f(from_f<T>(t[c_v[k] * LB + (size_t)ll * B + b]));
          const size_t at = c_e[k] * LB + lb;
          xo[at] = from_f<T>(__fsub_rn(totm, to_f(m[at])));
          par ^= totm < 0.0f;
        }
        bad |= par;
      }
    }
  }
  if (bad) atomicOr(&s_bad[tx], 1);
  __syncthreads();
  if (ty == 0 && live) ok[b] = !s_bad[tx];
}

}  // namespace

// K12: one iteration (x, llr) -> (xo, t, ok).  x, xo, m (E, L, B) float32
// (msg_bf16 = 0) or bfloat16 (msg_bf16 = 1); llr, t (V, L, B) float32; ok
// (B,) int32.  cg_off (C+1,) with c_e, c_v, c_sh (E,): each check group's
// slots (edge plane, variable plane, roll); vg_off (V+1,) with v_e, v_sh
// (E,): each variable plane's edge planes and back-rolls in adding order.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int lift_iter_launch(int msg_bf16, int L, int V, int C, int B,
                                int use_alpha, float alpha, const void* x,
                                const void* llr, const void* cg_off,
                                const void* c_e, const void* c_v,
                                const void* c_sh, const void* vg_off,
                                const void* v_e, const void* v_sh, void* m,
                                void* xo, void* t, void* ok, void* stream) {
  if (L < 1 || V < 1 || C < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((B + kTB - 1) / kTB)), block(kTB, kRows);
  if (msg_bf16) {
    lift_iter_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)llr, (const int*)cg_off,
        (const int*)c_e, (const int*)c_v, (const int*)c_sh,
        (const int*)vg_off, (const int*)v_e, (const int*)v_sh, L, V, C, B,
        use_alpha, alpha, (__nv_bfloat16*)m, (__nv_bfloat16*)xo, (float*)t,
        (int*)ok);
  } else {
    lift_iter_kernel<float><<<grid, block, 0, s>>>(
        (const float*)x, (const float*)llr, (const int*)cg_off,
        (const int*)c_e, (const int*)c_v, (const int*)c_sh,
        (const int*)vg_off, (const int*)v_e, (const int*)v_sh, L, V, C, B,
        use_alpha, alpha, (float*)m, (float*)xo, (float*)t, (int*)ok);
  }
  return (int)cudaGetLastError();
}
