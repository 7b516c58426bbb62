// One fused step of the quasi-cyclic DVB-S2 LDPC decoder, hand-written for
// Hopper (sm_90a): the check-column update (K9) and the variable totals
// (K10).
//
// Replaces: opticommpy_tpu/kernels/qc_pallas.py, `_check_body` (launched by
// `check_column_update`) and `_var_body` (launched by `var_totals_update`,
// one call per degree bucket).
//
// Layout: every tensor is planes of (Z=360, B) with the codeword axis B
// contiguous.  M (S+2, q, Z, B) holds the check-to-variable messages in check
// alignment (row z of plane (slot, a0) belongs to check q z + a0); T (G, Z, B)
// the variable totals of the info groups in degree-bucket order; Tp (q, Z, B)
// the parity totals.  The TPU rotated whole planes in vector registers; on
// the H100 a rotate is a gather, so only the index arithmetic carries the
// roll: the total of slot sl at row z of column a0 is
// T[pos[sl, a0]][(z - sh[sl, a0]) mod Z].
//
// What bounds them on an H100: bytes.  Per step at R4/5, B=512, bfloat16
// messages, K9 reads M and writes it anew (2 x 239 MB) and reads the
// totals, K10 reads the info slots of M (212 MB), the LLRs and the frozen
// totals and writes T, the frozen totals and their bfloat16 copy (~0.69 GB
// in all); each does ~10 float operations per byte-pair it moves.
//
// K9 design: one thread per (a0, z, b); a block is 32 codewords by 8 rows of
// one check column, so each warp reads 32 neighbouring codewords of one row.
// D = S + 2 is a template parameter (one instance per DVB-S2 rate): pass 1
// keeps the D values x = tot - M in registers (D <= 30 floats; the build log
// prints the kernel's registers and spills), together with the two smallest
// |x|, the XOR of the signs of x and the XOR of the signs of the totals;
// pass 2 writes the leave-one-out messages from registers.  At bfloat16 x
// rounds to bfloat16 and back before |x|, min and sign, as on the TPU.  The
// check side is exact whatever the order (min, sign, one subtraction, one
// multiply by alpha), so K9 is bit-identical to its plain version.  The
// per-codeword parity vote is the AND over rows and columns: reduced over
// the block's 8 rows in shared memory, then an atomicAnd into the
// codeword's flag (AND is order-free, so the result is deterministic).
//
// K10 design: one thread per (group, z, b), all degree buckets in one
// launch; a group's entries (slot, a0, back-roll) come from a CSR table in
// the order of qc_tables' ent_addr (a0 ascending, then slot) and are added
// to the channel LLR one by one with __fadd_rn.  The plain version adds in
// the same order, and there are no products to contract, so K10 is
// bit-identical to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kZ = 360;  // ETSI EN 302 307-1 group size
constexpr int kBX = 32;  // codewords per block
constexpr int kBY = 8;   // rows per block

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
__global__ void __launch_bounds__(kBX* kBY)
qc_check_kernel(const T* __restrict__ tot, const T* __restrict__ tp,
                const T* __restrict__ m, const int* __restrict__ pos,
                const int* __restrict__ sh, int q, int B, int use_alpha,
                float alpha, T* __restrict__ m_new, int* __restrict__ vote) {
  constexpr int S = D - 2;
  __shared__ int s_ok[kBY][kBX];
  const int b = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int a0 = blockIdx.z;
  int ok = 1;
  if (b < B && z < kZ) {
    const size_t plane = (size_t)kZ * B;
    const size_t zb = (size_t)z * B + b;
    float x[D];
    float m1 = CUDART_INF_F, m2 = CUDART_INF_F;
    bool parx = false, partot = false;
#pragma unroll
    for (int sl = 0; sl < D; ++sl) {
      float t;
      bool masked = false;
      if (sl < S) {  // info entry: the rolled total of its group
        int zz = z - sh[sl * q + a0];
        if (zz < 0) zz += kZ;
        t = to_f(tot[(size_t)pos[sl * q + a0] * plane + (size_t)zz * B + b]);
      } else if (sl == S) {  // accumulator self edge p_j -> c_j
        t = to_f(tp[(size_t)a0 * plane + zb]);
      } else if (a0 > 0) {  // staircase p_{j-1} -> c_j
        t = to_f(tp[(size_t)(a0 - 1) * plane + zb]);
      } else {  // column 0 reads column q-1 one row up; check 0 has no p_{-1}
        t = to_f(tp[(size_t)(q - 1) * plane + (size_t)(z == 0 ? kZ - 1 : z - 1) * B + b]);
        masked = z == 0;
      }
      const float mv = to_f(m[((size_t)sl * q + a0) * plane + zb]);
      float xv = to_f(from_f<T>(__fsub_rn(t, mv)));  // storage rounding
      bool tneg = t < 0.0f;
      if (masked) {
        xv = CUDART_INF_F;
        tneg = false;
      }
      x[sl] = xv;
      const float mag = fabsf(xv);
      m2 = fminf(m2, fmaxf(m1, mag));
      m1 = fminf(m1, mag);
      parx ^= xv < 0.0f;
      partot ^= tneg;
    }
    ok = !partot;
#pragma unroll
    for (int sl = 0; sl < D; ++sl) {
      float om = fabsf(x[sl]) == m1 ? m2 : m1;
      if (use_alpha) om = __fmul_rn(om, alpha);
      const bool flip = parx ^ (x[sl] < 0.0f);
      m_new[((size_t)sl * q + a0) * plane + zb] = from_f<T>(flip ? -om : om);
    }
  }
  s_ok[threadIdx.y][threadIdx.x] = ok;
  __syncthreads();
  if (threadIdx.y == 0 && b < B) {
    int all = 1;
#pragma unroll
    for (int y = 0; y < kBY; ++y) all &= s_ok[y][threadIdx.x];
    if (!all) atomicAnd(vote + b, 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBX* kBY)
qc_var_kernel(const T* __restrict__ m, const float* __restrict__ llr,
              const float* __restrict__ ft_old,
              const unsigned char* __restrict__ freeze,
              const int* __restrict__ grp_off, const int* __restrict__ ent,
              int q, int B, float* __restrict__ t_new,
              float* __restrict__ ft_new, T* __restrict__ t_copy) {
  const int b = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int g = blockIdx.z;
  if (b >= B || z >= kZ) return;
  const size_t plane = (size_t)kZ * B;
  const size_t idx = (size_t)g * plane + (size_t)z * B + b;
  float acc = llr[idx];
  const int e1 = grp_off[g + 1];
  for (int e = grp_off[g]; e < e1; ++e) {
    const int sl = ent[3 * e], a0 = ent[3 * e + 1];
    int zz = z - ent[3 * e + 2];
    if (zz < 0) zz += kZ;
    acc = __fadd_rn(acc, to_f(m[((size_t)sl * q + a0) * plane + (size_t)zz * B + b]));
  }
  t_new[idx] = acc;
  ft_new[idx] = freeze[b] ? ft_old[idx] : acc;
  if (t_copy != nullptr) t_copy[idx] = from_f<T>(acc);
}

dim3 grid_of(int B, int planes) {
  return dim3((unsigned)((B + kBX - 1) / kBX), (unsigned)((kZ + kBY - 1) / kBY),
              (unsigned)planes);
}

template <typename T, int D>
int launch_check(const void* tot, const void* tp, const void* m,
                 const void* pos, const void* sh, int q, int B, int use_alpha,
                 float alpha, void* m_new, void* vote, cudaStream_t s) {
  qc_check_kernel<T, D><<<grid_of(B, q), dim3(kBX, kBY), 0, s>>>(
      (const T*)tot, (const T*)tp, (const T*)m, (const int*)pos,
      (const int*)sh, q, B, use_alpha, alpha, (T*)m_new, (int*)vote);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_check(int D, const void* tot, const void* tp, const void* m,
                   const void* pos, const void* sh, int q, int B,
                   int use_alpha, float alpha, void* m_new, void* vote,
                   cudaStream_t s) {
#define QC_CHECK_CASE(d)                                                   \
  case d:                                                                  \
    return launch_check<T, d>(tot, tp, m, pos, sh, q, B, use_alpha, alpha, \
                              m_new, vote, s);
  switch (D) {
    QC_CHECK_CASE(4)
    QC_CHECK_CASE(5)
    QC_CHECK_CASE(6)
    QC_CHECK_CASE(7)
    QC_CHECK_CASE(10)
    QC_CHECK_CASE(11)
    QC_CHECK_CASE(14)
    QC_CHECK_CASE(18)
    QC_CHECK_CASE(22)
    QC_CHECK_CASE(27)
    QC_CHECK_CASE(30)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QC_CHECK_CASE
}

}  // namespace

// K9: new messages m_new (D, q, Z, B) from the totals tot (G, Z, B) and tp
// (q, Z, B) and the messages m (D, q, Z, B), all float32 (msg_bf16 = 0) or
// bfloat16 (msg_bf16 = 1); pos, sh (D-2, q) int32: the T plane and roll of
// each info slot of each column.  vote (B,) int32 must hold 1 on entry; it
// is cleared for every codeword whose totals fail a parity check.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int qc_check_launch(int msg_bf16, int D, const void* tot,
                               const void* tp, const void* m, const void* pos,
                               const void* sh, int q, int B, int use_alpha,
                               float alpha, void* m_new, void* vote,
                               void* stream) {
  if (q < 1 || q > 65535 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return msg_bf16
             ? dispatch_check<__nv_bfloat16>(D, tot, tp, m, pos, sh, q, B,
                                             use_alpha, alpha, m_new, vote, s)
             : dispatch_check<float>(D, tot, tp, m, pos, sh, q, B, use_alpha,
                                     alpha, m_new, vote, s);
}

// K10: totals t_new (G, Z, B) f32 = llr + the group's messages of m (slots
// 0..S-1 of (D, q, Z, B), rolled back), added in table order; ft_new =
// freeze[b] ? ft_old : t_new; t_copy (bfloat16, or null) = t_new in the
// message type.  grp_off (G+1,) and ent (E, 3) = (slot, a0, back-roll) give
// each group's entries.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int qc_var_launch(int msg_bf16, const void* m, const void* llr,
                             const void* ft_old, const void* freeze,
                             const void* grp_off, const void* ent, int q,
                             int G, int B, void* t_new, void* ft_new,
                             void* t_copy, void* stream) {
  if (G < 1 || G > 65535 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = grid_of(B, G), block(kBX, kBY);
  if (msg_bf16) {
    qc_var_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)m, (const float*)llr, (const float*)ft_old,
        (const unsigned char*)freeze, (const int*)grp_off, (const int*)ent, q,
        B, (float*)t_new, (float*)ft_new, (__nv_bfloat16*)t_copy);
  } else {
    if (t_copy != nullptr) return (int)cudaErrorInvalidValue;
    qc_var_kernel<float><<<grid, block, 0, s>>>(
        (const float*)m, (const float*)llr, (const float*)ft_old,
        (const unsigned char*)freeze, (const int*)grp_off, (const int*)ent, q,
        B, (float*)t_new, (float*)ft_new, nullptr);
  }
  return (int)cudaGetLastError();
}
