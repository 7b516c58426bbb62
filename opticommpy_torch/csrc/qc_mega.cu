// The whole quasi-cyclic DVB-S2 LDPC decode in one launch (K11), hand-written
// for Hopper (sm_90a): the flooding schedule and the layered (serial-C) one.
//
// Replaces: opticommpy_tpu/kernels/qc_mega.py, `_mega_body` (launched by
// `qc_decode_mega`).
//
// The TPU kernel held a 128-codeword tile's totals resident in ~100 MB of
// VMEM and streamed the messages; an H100 has at most 227 KB of shared
// memory per block.  What removes the problem is that codewords decode
// independently: one CTA owns one codeword for the whole decode, so it needs
// no grid-wide barrier and no atomics, and it stops on its own once its
// codeword has converged (early exit on the device; outputs are frozen
// either way, so the fixed loop and early exit give the same bits).
//
// Layout, codeword-major so that one CTA's data is contiguous: the channel
// LLRs llr_i (B, G, Z) in degree-bucket order and llr_p (B, q, Z); the
// messages m (B, q, D, Z), column j's D slots of Z rows together; the totals
// the check side reads tw (B, G, Z) and tpw (B, q, Z) (flooding: in the
// message type; layered: float32, updated in place); the frozen outputs ft
// (B, G, Z) and ftp (B, q, Z) float32.  The CTA's 384 threads own the Z = 360
// rows of a plane, so a rolled row read is contiguous apart from one wrap.
//
// What bounds it on an H100: bytes.  Per flooding step at R4/5 a codeword
// reads its totals once per slot (rolled) and reads and writes its messages
// (q x D x Z, 466 KB in bfloat16), then reads the info messages again for the
// variable totals; 512 codewords move ~0.6-1.2 GB per step, beyond the L2, so
// the kernel streams device memory.  D = S + 2 is a template parameter (one
// instance per DVB-S2 rate), so the D values of x stay in registers.
//
// Flooding (the fused route's step semantics, bit-identical to K9 + K10 and
// to their plain versions): per step, every check column from the previous
// totals in the message type (x = tot - M rounded to the message type, two
// smallest |x|, sign parities, leave-one-out messages written in place); the
// per-codeword vote of the step's input totals (__syncthreads_and), counted
// from step 1 on; then each group's total, the channel LLR plus its messages
// rolled back added in qc_tables' entry order with __fadd_rn (as K10), and
// the parity totals as (llr_p + M[S]) + staircase; frozen once done.  The
// last (phantom) step only votes.
//
// Layered: per sweep and check column, pass 1 reads the in-place float32
// totals (the vote sees mid-sweep totals), pass 2 writes the new messages
// and their deltas new - old (both rounded as stored) to shared memory;
// then thread z adds to row z of every plane its column's deltas in slot
// order.  Two slots of one column can meet the same group at two different
// rows, so a scatter by the check rows would race; the gather per target row
// adds in slot order, as the TPU's sequential grid does.  The sweep where the
// codeword's vote first holds freezes its end-of-sweep totals; frozen =
// done_before | (last & !ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kZ = 360;        // ETSI EN 302 307-1 group size
constexpr int kThreads = 384;  // 12 warps; thread z < kZ owns row z

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

struct MegaArgs {
  const float* llr_i;  // (B, G, Z)
  const float* llr_p;  // (B, q, Z)
  const int* pos;      // (S, q): T plane (bucket order) of each info slot
  const int* sh;       // (S, q): its roll
  const int* grp_off;  // (G + 1,): CSR offsets of each group's entries
  const int* ent;      // (E, 3): (slot, column, back-roll) per entry
  void* m;             // (B, q, D, Z) message type
  void* tw;            // (B, G, Z) totals read by the check side
  void* tpw;           // (B, q, Z)
  float* ft;           // (B, G, Z) frozen outputs
  float* ftp;          // (B, q, Z)
  int* done;           // (B,)
  int* n_iters;        // (B,)
  int q, G, K, use_alpha, early_exit;
  float alpha;
};

// The D edge values of row z of check column j: x = tot - m rounded to the
// message type (the staircase slot of check 0 masked to +inf), their two
// smallest magnitudes, the parity of their signs and of the totals' signs.
// tot_at(sl) gives slot sl's total; mv[sl] the old message.
template <typename T, int D, typename TotAt>
__device__ __forceinline__ void edge_values(TotAt tot_at, const float* mv,
                                            bool mask_stair, float* x,
                                            float& m1, float& m2, bool& parx,
                                            bool& partot) {
  m1 = CUDART_INF_F;
  m2 = CUDART_INF_F;
  parx = false;
  partot = false;
#pragma unroll
  for (int sl = 0; sl < D; ++sl) {
    const float t = tot_at(sl);
    float xv = to_f(from_f<T>(__fsub_rn(t, mv[sl])));  // storage rounding
    bool tneg = t < 0.0f;
    if (sl == D - 1 && mask_stair) {
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
}

// The leave-one-out min-sum message of slot value xv, in the message type.
template <typename T>
__device__ __forceinline__ T loo_message(float xv, float m1, float m2,
                                         bool parx, int use_alpha,
                                         float alpha) {
  float om = fabsf(xv) == m1 ? m2 : m1;
  if (use_alpha) om = __fmul_rn(om, alpha);
  return from_f<T>((parx ^ (xv < 0.0f)) ? -om : om);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) qc_mega_flood_kernel(MegaArgs a) {
  constexpr int S = D - 2;
  const int b = blockIdx.x;
  const int z = threadIdx.x;
  const bool row = z < kZ;
  const int q = a.q, G = a.G;
  const size_t gz = (size_t)G * kZ, qz = (size_t)q * kZ;
  const float* li = a.llr_i + b * gz;
  const float* lp = a.llr_p + b * qz;
  T* m = (T*)a.m + (size_t)b * q * D * kZ;
  T* tc = (T*)a.tw + b * gz;
  T* tpc = (T*)a.tpw + b * qz;
  float* ft = a.ft + b * gz;
  float* ftp = a.ftp + b * qz;
  if (row) {  // step 0 reads the channel LLRs; the outputs start from them
    for (int g = 0; g < G; ++g) {
      const float v = li[g * kZ + z];
      tc[g * kZ + z] = from_f<T>(v);
      ft[g * kZ + z] = v;
    }
    for (int c = 0; c < q; ++c) {
      const float v = lp[c * kZ + z];
      tpc[c * kZ + z] = from_f<T>(v);
      ftp[c * kZ + z] = v;
    }
  }
  __syncthreads();
  bool done = false;
  int n_iters = 0;
  for (int kk = 0; kk < a.K; ++kk) {
    const bool last = kk == a.K - 1;
    int ok = 1;
    if (row) {  // K9: every check column against the step's input totals
      for (int j = 0; j < q; ++j) {
        T* mj = m + (size_t)j * D * kZ;
        float mv[D], x[D];
#pragma unroll
        for (int sl = 0; sl < D; ++sl)
          mv[sl] = kk == 0 ? 0.0f : to_f(mj[sl * kZ + z]);
        auto tot_at = [&](int sl) -> float {
          if (sl < S) {
            int zz = z - a.sh[sl * q + j];
            if (zz < 0) zz += kZ;
            return to_f(tc[a.pos[sl * q + j] * kZ + zz]);
          }
          if (sl == S) return to_f(tpc[j * kZ + z]);
          if (j > 0) return to_f(tpc[(j - 1) * kZ + z]);
          return to_f(tpc[(q - 1) * kZ + (z == 0 ? kZ - 1 : z - 1)]);
        };
        float m1, m2;
        bool parx, partot;
        edge_values<T, D>(tot_at, mv, j == 0 && z == 0, x, m1, m2, parx,
                          partot);
        ok &= !partot;
        if (!last) {  // the phantom step's messages are never read
#pragma unroll
          for (int sl = 0; sl < D; ++sl)
            mj[sl * kZ + z] =
                loo_message<T>(x[sl], m1, m2, parx, a.use_alpha, a.alpha);
        }
      }
    }
    const int vote = __syncthreads_and(ok);
    if (kk > 0 && vote) done = true;
    if (!last && !done) ++n_iters;
    if (last || (done && a.early_exit)) break;  // outputs are final
    if (row) {  // K10 and the parity totals, frozen once done
      for (int g = 0; g < G; ++g) {
        float acc = li[g * kZ + z];
        const int e1 = a.grp_off[g + 1];
        for (int e = a.grp_off[g]; e < e1; ++e) {
          const int sl = a.ent[3 * e], c = a.ent[3 * e + 1];
          int zz = z - a.ent[3 * e + 2];
          if (zz < 0) zz += kZ;
          acc = __fadd_rn(acc, to_f(m[((size_t)c * D + sl) * kZ + zz]));
        }
        tc[g * kZ + z] = from_f<T>(acc);
        if (!done) ft[g * kZ + z] = acc;
      }
      for (int c = 0; c < q; ++c) {
        float tp = __fadd_rn(lp[c * kZ + z], to_f(m[((size_t)c * D + S) * kZ + z]));
        // staircase message of check column c + 1 (column 0 one row down
        // for c = q - 1; check 0's is masked and counts as 0)
        float sb;
        if (c < q - 1)
          sb = to_f(m[((size_t)(c + 1) * D + S + 1) * kZ + z]);
        else
          sb = z == kZ - 1 ? 0.0f : to_f(m[(size_t)(S + 1) * kZ + z + 1]);
        tp = __fadd_rn(tp, sb);
        tpc[c * kZ + z] = from_f<T>(tp);
        if (!done) ftp[c * kZ + z] = tp;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.done[b] = done;
    a.n_iters[b] = n_iters;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
qc_mega_layered_kernel(MegaArgs a) {
  constexpr int S = D - 2;
  __shared__ float s_delta[D * kZ];
  const int b = blockIdx.x;
  const int z = threadIdx.x;
  const bool row = z < kZ;
  const int q = a.q, G = a.G;
  const size_t gz = (size_t)G * kZ, qz = (size_t)q * kZ;
  T* m = (T*)a.m + (size_t)b * q * D * kZ;
  float* tt = (float*)a.tw + b * gz;
  float* tp = (float*)a.tpw + b * qz;
  float* ft = a.ft + b * gz;
  float* ftp = a.ftp + b * qz;
  if (row) {  // the channel LLRs land in the float32 totals
    for (int g = 0; g < G; ++g) tt[g * kZ + z] = a.llr_i[b * gz + g * kZ + z];
    for (int c = 0; c < q; ++c) tp[c * kZ + z] = a.llr_p[b * qz + c * kZ + z];
  }
  __syncthreads();
  bool done = false;
  int n_iters = 0;
  for (int k = 0; k < a.K; ++k) {
    const bool last = k == a.K - 1;
    int ok = 1;
    for (int j = 0; j < q; ++j) {
      const int jm1 = j == 0 ? q - 1 : j - 1;
      T* mj = m + (size_t)j * D * kZ;
      if (row) {  // pass 1 on the current totals; pass 2 to registers
        float mv[D], x[D];
#pragma unroll
        for (int sl = 0; sl < D; ++sl)
          mv[sl] = k == 0 ? 0.0f : to_f(mj[sl * kZ + z]);
        auto tot_at = [&](int sl) -> float {
          if (sl < S) {
            int zz = z - a.sh[sl * q + j];
            if (zz < 0) zz += kZ;
            return tt[a.pos[sl * q + j] * kZ + zz];
          }
          if (sl == S) return tp[j * kZ + z];
          if (j > 0) return tp[jm1 * kZ + z];
          return tp[(q - 1) * kZ + (z == 0 ? kZ - 1 : z - 1)];
        };
        float m1, m2;
        bool parx, partot;
        const bool mask = j == 0 && z == 0;
        edge_values<T, D>(tot_at, mv, mask, x, m1, m2, parx, partot);
        ok &= !partot;
#pragma unroll
        for (int sl = 0; sl < D; ++sl) {
          const T nm = loo_message<T>(x[sl], m1, m2, parx, a.use_alpha, a.alpha);
          mj[sl * kZ + z] = nm;
          // the delta of the masked staircase entry of check 0 is 0
          s_delta[sl * kZ + z] =
              (sl == S + 1 && mask) ? 0.0f : __fsub_rn(to_f(nm), mv[sl]);
        }
      }
      __syncthreads();
      if (row) {  // thread z adds row z's deltas, slot by slot
        for (int sl = 0; sl < S; ++sl) {
          int zz = z + a.sh[sl * q + j];
          if (zz >= kZ) zz -= kZ;
          float* t = tt + a.pos[sl * q + j] * kZ + z;
          *t = __fadd_rn(*t, s_delta[sl * kZ + zz]);
        }
        tp[j * kZ + z] = __fadd_rn(tp[j * kZ + z], s_delta[S * kZ + z]);
        // column j's staircase message reaches parity column j - 1; column
        // 0's reaches column q - 1 one row up
        const int zs = j > 0 ? z : (z == kZ - 1 ? 0 : z + 1);
        tp[jm1 * kZ + z] = __fadd_rn(tp[jm1 * kZ + z], s_delta[(S + 1) * kZ + zs]);
      }
      __syncthreads();
    }
    const int all_ok = __syncthreads_and(ok);
    const bool vote = k > 0 && all_ok;
    // the sweep where the vote first holds writes its end-of-sweep totals;
    // at the last sweep a codeword whose vote fails keeps the previous ones
    const bool frozen = k > 0 && (done || (last && !vote));
    done = done || vote;
    if (!last && !done) ++n_iters;
    if (!frozen && row) {
      for (int g = 0; g < G; ++g) ft[g * kZ + z] = tt[g * kZ + z];
      for (int c = 0; c < q; ++c) ftp[c * kZ + z] = tp[c * kZ + z];
    }
    if (done && a.early_exit) break;  // outputs are final
  }
  if (threadIdx.x == 0) {
    a.done[b] = done;
    a.n_iters[b] = n_iters;
  }
}

template <typename T, int D>
int launch_mega(int layered, const MegaArgs& a, int B, cudaStream_t s) {
  if (layered)
    qc_mega_layered_kernel<T, D><<<B, kThreads, 0, s>>>(a);
  else
    qc_mega_flood_kernel<T, D><<<B, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mega(int D, int layered, const MegaArgs& a, int B,
                  cudaStream_t s) {
#define QC_MEGA_CASE(d) \
  case d:               \
    return launch_mega<T, d>(layered, a, B, s);
  switch (D) {
    QC_MEGA_CASE(4)
    QC_MEGA_CASE(5)
    QC_MEGA_CASE(6)
    QC_MEGA_CASE(7)
    QC_MEGA_CASE(10)
    QC_MEGA_CASE(11)
    QC_MEGA_CASE(14)
    QC_MEGA_CASE(18)
    QC_MEGA_CASE(22)
    QC_MEGA_CASE(27)
    QC_MEGA_CASE(30)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QC_MEGA_CASE
}

}  // namespace

// K11: the whole decode of K steps (max_iter + 1), one CTA per codeword.
// msg_bf16: messages (and flooding's check-side totals) in bfloat16, else
// float32; layered: the serial-C schedule (tw, tpw float32), else flooding.
// llr_i (B, G, Z) and llr_p (B, q, Z) float32; pos, sh (D-2, q) int32;
// grp_off (G+1,) and ent (E, 3) = (slot, column, back-roll) int32, the
// entries of each bucket-order group; m (B, q, D, Z), tw (B, G, Z) and tpw
// (B, q, Z) are scratch.  Writes the frozen totals ft (B, G, Z) and ftp
// (B, q, Z) float32, done (B,) and n_iters (B,) int32.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int qc_mega_launch(int msg_bf16, int layered, int D, int q, int G,
                              int B, int K, int use_alpha, float alpha,
                              int early_exit, const void* llr_i,
                              const void* llr_p, const void* pos,
                              const void* sh, const void* grp_off,
                              const void* ent, void* m, void* tw, void* tpw,
                              void* ft, void* ftp, void* done, void* n_iters,
                              void* stream) {
  if (q < 2 || G < 1 || B < 1 || K < 1) return (int)cudaErrorInvalidValue;
  MegaArgs a;
  a.llr_i = (const float*)llr_i;
  a.llr_p = (const float*)llr_p;
  a.pos = (const int*)pos;
  a.sh = (const int*)sh;
  a.grp_off = (const int*)grp_off;
  a.ent = (const int*)ent;
  a.m = m;
  a.tw = tw;
  a.tpw = tpw;
  a.ft = (float*)ft;
  a.ftp = (float*)ftp;
  a.done = (int*)done;
  a.n_iters = (int*)n_iters;
  a.q = q;
  a.G = G;
  a.K = K;
  a.use_alpha = use_alpha;
  a.early_exit = early_exit;
  a.alpha = alpha;
  cudaStream_t s = (cudaStream_t)stream;
  return msg_bf16 ? dispatch_mega<__nv_bfloat16>(D, layered, a, B, s)
                  : dispatch_mega<float>(D, layered, a, B, s);
}
