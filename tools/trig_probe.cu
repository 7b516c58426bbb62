// The sine and cosine of the K7 step (csrc/ddpll.cu) on one warp of one
// SM: the dependent-chain latency of sinf, cosf, sincosf and the pair
// sinf + cosf, and a check of sincosf against sinf and cosf on every
// float32 input.  Driven by tools/bench_pll_lift_redesign.py, built with
// nvcc for sm_90a beside the package's kernels.

#include <cuda_runtime.h>

namespace {

enum Case { kFadd, kSin, kCos, kSincos, kSinCos, kCases };

__global__ void trig_latency_kernel(int which, int n, float a, long long* cycles,
                                    float* out) {
  float x = a + threadIdx.x * 1e-7f;
  const long long t0 = clock64();
  switch (which) {
    case kFadd:
#pragma unroll 16
      for (int i = 0; i < n; ++i) x = __fadd_rn(x, a);
      break;
    case kSin:
#pragma unroll 1
      for (int i = 0; i < n; ++i) x = sinf(x);
      break;
    case kCos:
#pragma unroll 1
      for (int i = 0; i < n; ++i) x = cosf(x);
      break;
    case kSincos:  // sincosf and the add that joins its two results
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        float s, c;
        sincosf(x, &s, &c);
        x = __fadd_rn(s, c);
      }
      break;
    case kSinCos:  // sinf and cosf of one argument, as K7's first version, and the add
#pragma unroll 1
      for (int i = 0; i < n; ++i) x = __fadd_rn(sinf(x), cosf(x));
      break;
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

// counts[0]: inputs where sincosf's sine differs in a bit from sinf's,
// counts[1]: the same for the cosine (two NaNs count as equal)
__global__ void sincos_check_kernel(unsigned long long start, unsigned long long count,
                                    unsigned long long* counts) {
  unsigned long long bad_s = 0, bad_c = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    const float x = __uint_as_float((unsigned)(start + i));
    float s, c;
    sincosf(x, &s, &c);
    const float s1 = sinf(x), c1 = cosf(x);
    bad_s += __float_as_uint(s) != __float_as_uint(s1) && !(isnan(s) && isnan(s1));
    bad_c += __float_as_uint(c) != __float_as_uint(c1) && !(isnan(c) && isnan(c1));
  }
  if (bad_s) atomicAdd(counts, bad_s);
  if (bad_c) atomicAdd(counts + 1, bad_c);
}

// sinf and cosf of the count float32 values whose bits start at `start`
__global__ void trig_eval_kernel(unsigned start, int count, float* out_sin, float* out_cos) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) {
    const float x = __uint_as_float(start + (unsigned)i);
    out_sin[i] = sinf(x);
    out_cos[i] = cosf(x);
  }
}

}  // namespace

// Runs case `which` (0 .. trig_cases() - 1) with n repetitions on one warp
// and writes the cycles of the timed loop to cycles[0]; out (32 floats)
// keeps the chain live.  Launches on `stream`; returns cudaGetLastError().
extern "C" int trig_latency_launch(int which, int n, float a, void* cycles, void* out,
                                   void* stream) {
  trig_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(which, n, a, (long long*)cycles,
                                                          (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int trig_cases() { return kCases; }

// Counts the inputs [start, start + count) (as float32 bits) where sincosf
// and sinf / cosf differ; counts (2,) uint64 zeroed by the caller.
extern "C" int sincos_check_launch(unsigned long long start, unsigned long long count,
                                   void* counts, void* stream) {
  sincos_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      start, count, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

extern "C" int trig_eval_launch(unsigned start, int count, void* out_sin, void* out_cos,
                                void* stream) {
  trig_eval_kernel<<<(count + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      start, count, (float*)out_sin, (float*)out_cos);
  return (int)cudaGetLastError();
}
