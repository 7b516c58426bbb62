// Chunked staging of a per-symbol recurrence's inputs into shared memory,
// shared by csrc/mimo_eq.cu, csrc/rls.cu, csrc/dfe.cu and csrc/gardner.cu.
//
// A recurrence reads, per symbol, a window of the padded signal and a
// reference; each signal's windows of symbols k0 ... k0 + n - 1 are one
// contiguous run of its row-major (rows, modes) signal.  The kernels copy
// such runs, a chunk of symbols at a time, into a double-buffered ring in
// shared memory with cp.async while the recurrence works on the previous
// chunk, so the dependent chain reads only shared memory and registers.
//
// cp.async moves 16 bytes best, from 16-byte aligned addresses, but a run of
// complex64 values starts on any 8-byte boundary (the start offset
// n_start * sps * modes, the signal b * rows * modes of a batch).  So a run
// is copied from the 16-byte boundary at or below its first value: the
// destination holds it at offset `misalign(src)` (0 or 1 values), the middle
// in 16-byte pieces and a ragged first or last value in an 8-byte piece; no
// byte outside the run is read.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stage {

__device__ __forceinline__ int misalign(const float2* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
}

__device__ __forceinline__ void cp8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

template <typename T>
__device__ __forceinline__ void cp16(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copy of src[0, n) to dst[misalign(src) + 0, n); dst is 16-byte
// aligned.  Every thread of the CTA calls it with the same arguments.
__device__ __forceinline__ void issue(float2* dst, const float2* src, int n) {
  const int mis = misalign(src);
  const float2* base = src - mis;  // 16-byte aligned
  const int total = mis + n;
  const int pieces = (total + 1) >> 1;
  for (int u = threadIdx.x; u < pieces; u += blockDim.x) {
    const int e = 2 * u;
    const bool lo_ok = e >= mis, hi_ok = e + 1 < total;
    if (lo_ok && hi_ok)
      cp16(dst + e, base + e);
    else if (lo_ok)
      cp8(dst + e, base + e);
    else if (hi_ok)
      cp8(dst + e + 1, base + e + 1);
  }
}

// The same for runs of float or float2 values (csrc/dfe.cu's real and
// complex instances): a float run starts on any 4-byte boundary, so it lies
// 0-3 values above the 16-byte boundary below it.
__device__ __forceinline__ void cp_value(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_value(float2* dst, const float2* src) {
  cp8(dst, src);
}

// Values of T between src and the 16-byte boundary at or below it.
template <typename T>
__device__ __forceinline__ int misalign_of(const T* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
}

// Issue the copy of src[0, n) to dst[misalign_of(src) + 0, n); dst is
// 16-byte aligned.  Every thread of the CTA calls it with the same arguments.
template <typename T>
__device__ __forceinline__ void issue_values(T* dst, const T* src, int n) {
  constexpr int kPer = 16 / sizeof(T);
  const int mis = misalign_of(src);
  const T* base = src - mis;
  const int total = mis + n;
  const int pieces = (total + kPer - 1) / kPer;
  for (int u = threadIdx.x; u < pieces; u += blockDim.x) {
    const int e = u * kPer;
    if (e >= mis && e + kPer <= total) {
      cp16(dst + e, base + e);
    } else {
      const int hi = min(e + kPer, total);
      for (int v = max(e, mis); v < hi; ++v) cp_value(dst + v, base + v);
    }
  }
}

// Values (float2) of one ring slot holding the windows of `chunk` symbols:
// (chunk - 1) * stride + width, one more for the misalignment, even so
// that the next slot starts 16-byte aligned.
__host__ __device__ inline long long window_slot(int chunk, int stride,
                                                 int width) {
  const long long n = (long long)(chunk - 1) * stride + width + 1;
  return (n + 1) & ~1LL;
}

// Values of one reference or output slot of `chunk` symbols.
__host__ __device__ inline long long symbol_slot(int chunk, int modes) {
  return ((long long)chunk * modes + 1 + 1) & ~1LL;
}

// Shared-memory budget of the staged inputs and outputs: two window slots,
// two reference slots and one output slot.
constexpr long long kBudget = 160 * 1024;

// Symbols per chunk: 256, halved until the ring fits the budget.
inline int chunk_symbols(int modes, int stride, int width) {
  int chunk = 256;
  while (chunk > 1 &&
         8 * (2 * window_slot(chunk, stride, width) +
              3 * symbol_slot(chunk, modes)) > kBudget)
    chunk >>= 1;
  return chunk;
}

}  // namespace stage
