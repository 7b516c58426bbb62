// Dependent-chain latencies of the operations the K6 and K13 steps are
// built from (csrc/gardner.cu, csrc/dfe.cu), on one warp of one SM: each
// case repeats one dependent operation n times between two clock64()
// reads and reports the SM cycles per repetition.  Driven by
// tools/bench_recurrence_redesign.py (--latency), built with nvcc for
// sm_90a beside the package's kernels.

#include <cuda_runtime.h>

namespace {

// the K13 slicer's quantizer, as csrc/dfe.cu computes it
__device__ __forceinline__ float quantize(float x, float lo, float step, float top) {
  float k = rintf(__fdiv_rn(__fsub_rn(x, lo), step));
  k = fminf(fmaxf(k, 0.0f), top);
  return __fadd_rn(__fmul_rn(k, step), lo);
}

enum Case {
  kFadd, kFmul, kFdiv, kRint, kQuantize, kShfl, kLds, kSelect, kBranch, kCases
};

__global__ void latency_kernel(int which, int n, float a, long long* cycles,
                               float* out) {
  __shared__ int chase[64];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) chase[i] = (i + 1) & 63;
  __syncthreads();
  float x = a + threadIdx.x * 1e-7f;
  int p = threadIdx.x & 63;
  const long long t0 = clock64();
  switch (which) {
    case kFadd:
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = __fadd_rn(x, a);
      break;
    case kFmul:
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = __fmul_rn(x, a);
      break;
    case kFdiv:
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = __fdiv_rn(x, a);
      break;
    case kRint:  // rintf and an add, less kFadd
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = __fadd_rn(rintf(x), 0.25f);
      break;
    case kQuantize:  // quantize and an add, less kFadd
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = __fadd_rn(quantize(x, -1.3f, 0.9f, 3.0f), a);
      break;
    case kShfl:
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = __shfl_xor_sync(0xffffffffu, x, 1);
      break;
    case kLds:
#pragma unroll 16
      for (int i = 0; i < n; ++i) p = chase[p];
      x += p;
      break;
    case kSelect:  // a compare and a select, less nothing
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = x > 1.0f ? __fmul_rn(x, 0.5f) : x;
      break;
    case kBranch:  // a data-dependent branch around an add, with an add
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        if (x > 1e30f) asm volatile("" ::: "memory");
        x = __fadd_rn(x, a);
      }
      break;
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

}  // namespace

// Runs case `which` (0 .. lat_cases() - 1) with n repetitions on one warp and
// writes the cycles of the timed loop to cycles[0]; out (32 floats) keeps the
// chain live.  Launches on `stream`; returns cudaGetLastError().
extern "C" int lat_launch(int which, int n, float a, void* cycles, void* out,
                          void* stream) {
  latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(which, n, a, (long long*)cycles,
                                                     (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int lat_cases() { return kCases; }
