// Leave-one-out min-sum check update along the slot axis of a (D, rows)
// message tensor, hand-written for Hopper (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/ldpc_pallas.py, `_msa_body` (launched
// by `check_update_msa_pallas`).
//
// What bounds it on an H100: bytes.  Each element of the D slot planes is
// read once and written once (at DVB-S2 R4/5, B=512, bfloat16: 2 x 239 MB),
// against ~6 float operations per element; at 3.35 TB/s the bytes take
// ~20x longer than the operations at the FP32 rate.
//
// Design: one thread per (row, codeword) element of a slot plane, with the
// codeword axis contiguous, so that a warp reads 32 neighbouring elements
// of each slot in one coalesced request.  D is a template parameter (one
// instance per DVB-S2 rate), so the D magnitudes, signs and the suffix
// minima stay in registers: D loads, a suffix min chain, a prefix min
// chain fused with the D stores, and the XOR parity of the signs.  Math is
// float32 on values that are exact in the storage type (min and sign of
// bfloat16 inputs), the optional NMSA scale is one rounded float32
// multiply, and bfloat16 outputs round to nearest even: bit-identical to
// the plain version, opticommpy_torch/comm/fec_qc.py `_check_msa_slots`.
// A +inf input (the masked staircase slot of check 0) is neutral.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
msa_check_kernel(const T* __restrict__ x, long long n, int use_alpha,
                 float alpha, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float mag[D];
  bool neg[D];
  bool par = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float v = to_f(x[(long long)d * n + i]);
    mag[d] = fabsf(v);
    neg[d] = v < 0.0f;
    par ^= neg[d];
  }
  float suffix[D];  // suffix[d] = min(mag[d+1:])
  float acc = CUDART_INF_F;
#pragma unroll
  for (int d = D - 1; d >= 0; --d) {
    suffix[d] = acc;
    acc = fminf(acc, mag[d]);
  }
  acc = CUDART_INF_F;  // prefix: min(mag[:d])
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float om = fminf(acc, suffix[d]);
    acc = fminf(acc, mag[d]);
    if (use_alpha) om = __fmul_rn(om, alpha);
    out[(long long)d * n + i] = from_f<T>((par ^ neg[d]) ? -om : om);
  }
}

template <typename T, int D>
int launch(const void* x, long long n, int use_alpha, float alpha, void* out,
           cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  msa_check_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, n, use_alpha, alpha, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* x, long long n, int use_alpha, float alpha,
             void* out, cudaStream_t s) {
  switch (D) {
    case 4: return launch<T, 4>(x, n, use_alpha, alpha, out, s);
    case 5: return launch<T, 5>(x, n, use_alpha, alpha, out, s);
    case 6: return launch<T, 6>(x, n, use_alpha, alpha, out, s);
    case 7: return launch<T, 7>(x, n, use_alpha, alpha, out, s);
    case 10: return launch<T, 10>(x, n, use_alpha, alpha, out, s);
    case 11: return launch<T, 11>(x, n, use_alpha, alpha, out, s);
    case 14: return launch<T, 14>(x, n, use_alpha, alpha, out, s);
    case 18: return launch<T, 18>(x, n, use_alpha, alpha, out, s);
    case 22: return launch<T, 22>(x, n, use_alpha, alpha, out, s);
    case 27: return launch<T, 27>(x, n, use_alpha, alpha, out, s);
    case 30: return launch<T, 30>(x, n, use_alpha, alpha, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Check update of x (D, n) -> out (D, n), float32 (msg_bf16 = 0) or
// bfloat16 (msg_bf16 = 1), D one of the DVB-S2 slot counts; alpha scales
// the magnitudes when use_alpha is nonzero.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int ldpc_check_launch(int msg_bf16, int D, const void* x,
                                 long long n, int use_alpha, float alpha,
                                 void* out, void* stream) {
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return msg_bf16 ? dispatch<__nv_bfloat16>(D, x, n, use_alpha, alpha, out, s)
                  : dispatch<float>(D, x, n, use_alpha, alpha, out, s);
}
