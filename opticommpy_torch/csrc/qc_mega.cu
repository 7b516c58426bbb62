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
// rows of a plane.
//
// What bounds it on an H100: bytes.  Per flooding step at R4/5 a codeword
// reads and writes its messages (q x D x Z, 466 KB in bfloat16), reads them
// again for the variable totals and reads its totals and LLRs; 512
// codewords move ~0.6-1.2 GB per step, beyond the L2, so the kernel streams
// device memory.  D = S + 2 is a template parameter (one instance per
// DVB-S2 rate), so the D values of a row stay in registers.
//
// What held the first version back (11.9 ms at R4/5 bf16 early exit, B =
// 512, 21% of its bound): every access moved one 2- or 4-byte value per
// thread, the check side read its tables from device memory before the
// rolled totals, the variable side gathered entry by entry (a table load,
// then a dependent message load, one entry at a time), the layered sweep
// read-modify-wrote its totals slot after slot, and the outputs were
// written on every step.  Far too few bytes were in flight to stream.
//
// Design:
//   - The code's tables live in shared memory (packed: plane and roll of
//     each check slot; slot, column and back-roll of each group entry).
//   - Flooding streams whole planes into a ring of shared-memory slots with
//     bulk copies (cp.async.bulk, the TMA's one-dimensional form), each slot
//     completed by an mbarrier: a check item is a batch of check columns,
//     each its D message planes (one copy) and the S + 2 total planes it
//     reads; a variable item a batch of groups, each its entries' message
//     planes and its LLR plane; a parity item a batch of parity columns.
//     Thread 0 keeps up to slots - 1 items in flight ahead of the one the
//     CTA computes; the rolled reads are shared-memory reads.  Messages and
//     totals are written straight from registers (each warp 64-128
//     contiguous bytes), followed by a proxy fence before the next phase's
//     copies read them.  Batches (host-built, kernels/qc_mega.py) fill a
//     slot, so a rate with short columns still moves ~24 KB per item.
//   - Layered keeps the float32 totals in device memory (259 KB a codeword,
//     more than a block's shared memory) but streams each column's messages
//     into the ring ahead of the sweep, and adds a column's deltas to its
//     total rows with every load issued first: the slots run in the order
//     of their groups (host-built, stable), so two slots that meet one group
//     add to one register in slot order, loaded once and stored once.  It
//     writes the frozen outputs only at the sweep
//     where they freeze and at the last two sweeps, which is where the
//     freeze rule can make them final.
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

#include <cstdint>

namespace {

constexpr int kZ = 360;        // ETSI EN 302 307-1 group size
constexpr int kThreads = 384;  // 12 warps; thread z < kZ owns row z
constexpr int kMaxRing = 4;    // ring slots at most
constexpr int kBudget = 110 * 1024;  // shared memory aimed at per CTA (two per SM)
constexpr int kSmemMax = 227 * 1024;

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

// The tables (int32, host-built by kernels/qc_mega.py, mega_tables), in
// this order: the check slots' plane | roll << 16, (S, q) slot-major; the
// group entries' slot | column << 8 | back-roll << 16, (S q,) in group
// order; the groups' entry offsets (G + 1); the check, variable and parity
// batches' first column / group / column and one past the last (n_cb + 1,
// n_vb + 1, n_pb + 1); the check slots of each column in the order of their
// groups (stable, so a group's slots stay in slot order): slot | 0x100 on
// its group's first | 0x200 on its last, (S, q) position-major.
struct MegaArgs {
  const float* llr_i;  // (B, G, Z)
  const float* llr_p;  // (B, q, Z)
  const int* tab;
  void* m;             // (B, q, D, Z) message type
  void* tw;            // (B, G, Z) totals read by the check side
  void* tpw;           // (B, q, Z)
  float* ft;           // (B, G, Z) frozen outputs
  float* ftp;          // (B, q, Z)
  int* done;           // (B,)
  int* n_iters;        // (B,)
  int q, G, K, use_alpha, early_exit;
  float alpha;
  int n_tab, n_cb, n_vb, n_pb;
  int cap, ring;  // bytes per ring slot, ring slots
};

struct Tabs {  // the tables in shared memory
  const int *slot, *ent, *grp_off, *cb, *vb, *pb, *ord;
};

__device__ __forceinline__ Tabs tabs_at(const int* t, int S, int q, int G, int n_cb,
                                        int n_vb, int n_pb) {
  Tabs r;
  r.slot = t;
  r.ent = r.slot + S * q;
  r.grp_off = r.ent + S * q;
  r.cb = r.grp_off + G + 1;
  r.vb = r.cb + n_cb + 1;
  r.pb = r.vb + n_vb + 1;
  r.ord = r.pb + n_pb + 1;
  return r;
}

// --- bulk copies into the ring, completed by mbarriers -----------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* b, unsigned parity) {
  unsigned ok;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// generic-proxy writes to device memory before bulk copies read them
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// generic-proxy reads of a ring slot before a bulk copy overwrites it
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Items flow through `ring` slots of `cap` bytes: item i (counted over the
// whole decode) lands in slot i % ring and completes phase (i / ring) & 1 of
// that slot's barrier.  Only thread 0 issues.
struct Ring {
  char* buf;
  uint64_t* bar;
  int cap, ring;
  unsigned next;  // the decode's item count so far

  __device__ __forceinline__ char* slot(unsigned i) const { return buf + (i % ring) * cap; }

  // issue(k, dst, copy) calls copy(dst, src, bytes) for each plane of
  // phase item k and returns their bytes; work(k, src) computes the item.
  // Every thread calls.
  template <typename Issue, typename Work>
  __device__ __forceinline__ void phase(int n_items, Issue issue, Work work) {
    const unsigned base = next;
    const bool issuer = threadIdx.x == 0;
    auto put = [&](int k) {  // the item's bytes first, then its copies
      const unsigned i = base + k;
      uint64_t* b = bar + i % ring;
      fence_async_shared();
      bar_arrive_expect(b, issue(k, slot(i), [](char*, const void*, unsigned) {}));
      issue(k, slot(i), [&](char* dst, const void* src, unsigned bytes) {
        bulk_copy(dst, src, bytes, b);
      });
    };
    if (issuer)
      for (int k = 0; k < min(ring - 1, n_items); ++k) put(k);
    for (int k = 0; k < n_items; ++k) {
      if (issuer && k + ring - 1 < n_items) put(k + ring - 1);
      const unsigned i = base + k;
      bar_wait(bar + i % ring, (i / ring) & 1);
      work(k, slot(i));
      __syncthreads();  // the slot is free
    }
    next = base + n_items;
  }
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

__device__ __forceinline__ int roll(int z, int by) {  // (z - by) mod Z, 0 <= by < Z
  const int r = z - by;
  return r < 0 ? r + kZ : r;
}

// Copy the tables into shared memory and set up the ring's barriers.
__device__ __forceinline__ void stage_tables(const MegaArgs& a, int* st, uint64_t* bar) {
  for (int i = threadIdx.x; i < a.n_tab; i += blockDim.x) st[i] = a.tab[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.ring; ++i) bar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) qc_mega_flood_kernel(MegaArgs a) {
  constexpr int S = D - 2;
  constexpr unsigned PT = kZ * sizeof(T);   // a plane in the message type
  constexpr unsigned PF = kZ * sizeof(float);  // a float32 plane
  extern __shared__ __align__(128) unsigned char smem[];
  const int q = a.q, G = a.G;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* st = reinterpret_cast<int*>(smem + 8 * kMaxRing);
  char* ring_buf = reinterpret_cast<char*>(smem) + ((8 * kMaxRing + 4 * a.n_tab + 127) / 128) * 128;
  stage_tables(a, st, bar);
  const Tabs tb = tabs_at(st, S, q, G, a.n_cb, a.n_vb, a.n_pb);
  Ring ring{ring_buf, bar, a.cap, a.ring, 0u};

  const int b = blockIdx.x;
  const int z = threadIdx.x;
  const bool row = z < kZ;
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
  fence_async_global();
  __syncthreads();

  bool done = false;
  int n_iters = 0;
  for (int kk = 0; kk < a.K; ++kk) {
    const bool last = kk == a.K - 1;
    const bool msgs = kk > 0 && !last;  // step 0 has no messages; the last reads none
    int ok = 1;
    // K9: every check column against the step's input totals.  A column's
    // part of a slot: its D message planes, then its S info total planes,
    // its parity total and the previous column's.
    auto issue_check = [&](int k, char* dst, auto copy) -> unsigned {
      unsigned bytes = 0;
      for (int j = tb.cb[k]; j < tb.cb[k + 1]; ++j, dst += 2 * D * PT) {
        if (msgs) {
          copy(dst, m + (size_t)j * D * kZ, D * PT);
          bytes += D * PT;
        }
        for (int sl = 0; sl < S; ++sl)
          copy(dst + (D + sl) * PT, tc + (tb.slot[sl * q + j] & 0xffff) * kZ, PT);
        copy(dst + (D + S) * PT, tpc + j * kZ, PT);
        copy(dst + (D + S + 1) * PT, tpc + (j > 0 ? j - 1 : q - 1) * kZ, PT);
        bytes += D * PT;
      }
      return bytes;
    };
    auto work_check = [&](int k, const char* src) {
      if (!row) return;
      for (int j = tb.cb[k]; j < tb.cb[k + 1]; ++j, src += 2 * D * PT) {
        const T* mvs = reinterpret_cast<const T*>(src);
        const T* tot = mvs + D * kZ;
        float mv[D], x[D];
#pragma unroll
        for (int sl = 0; sl < D; ++sl) mv[sl] = msgs ? to_f(mvs[sl * kZ + z]) : 0.0f;
        auto tot_at = [&](int sl) -> float {
          if (sl < S) return to_f(tot[sl * kZ + roll(z, tb.slot[sl * q + j] >> 16)]);
          if (sl == S) return to_f(tot[S * kZ + z]);
          return to_f(tot[(S + 1) * kZ + (j > 0 ? z : roll(z, 1))]);
        };
        float m1, m2;
        bool parx, partot;
        edge_values<T, D>(tot_at, mv, j == 0 && z == 0, x, m1, m2, parx, partot);
        ok &= !partot;
        if (!last) {  // the phantom step's messages are never read
          T* mj = m + (size_t)j * D * kZ;
#pragma unroll
          for (int sl = 0; sl < D; ++sl)
            mj[sl * kZ + z] = loo_message<T>(x[sl], m1, m2, parx, a.use_alpha, a.alpha);
        }
      }
    };
    ring.phase(a.n_cb, issue_check, work_check);
    fence_async_global();
    const int vote = __syncthreads_and(ok);
    if (kk > 0 && vote) done = true;
    if (!last && !done) ++n_iters;
    if (last || (done && a.early_exit)) break;  // outputs are final
    // K10 and the parity totals, frozen once done: items 0 .. n_vb - 1 are
    // batches of groups (each group's entry planes, then its LLR plane),
    // the rest batches of parity columns (M[c][S], the staircase plane, the
    // LLR plane)
    auto issue_var = [&](int k, char* dst, auto copy) -> unsigned {
      unsigned bytes = 0;
      if (k < a.n_vb) {
        for (int g = tb.vb[k]; g < tb.vb[k + 1]; ++g) {
          for (int e = tb.grp_off[g]; e < tb.grp_off[g + 1]; ++e, dst += PT) {
            const int en = tb.ent[e];
            copy(dst, m + ((size_t)((en >> 8) & 0xff) * D + (en & 0xff)) * kZ, PT);
            bytes += PT;
          }
          copy(dst, li + (size_t)g * kZ, PF);
          dst += PF;
          bytes += PF;
        }
      } else {
        for (int c = tb.pb[k - a.n_vb]; c < tb.pb[k - a.n_vb + 1]; ++c, dst += 2 * PT + PF) {
          copy(dst, m + ((size_t)c * D + S) * kZ, PT);
          copy(dst + PT, m + ((size_t)(c < q - 1 ? c + 1 : 0) * D + S + 1) * kZ, PT);
          copy(dst + 2 * PT, lp + (size_t)c * kZ, PF);
          bytes += 2 * PT + PF;
        }
      }
      return bytes;
    };
    auto work_var = [&](int k, const char* src) {
      if (!row) return;
      if (k < a.n_vb) {
        for (int g = tb.vb[k]; g < tb.vb[k + 1]; ++g) {
          const int e0 = tb.grp_off[g], e1 = tb.grp_off[g + 1];
          const float* lg = reinterpret_cast<const float*>(src + (e1 - e0) * PT);
          float acc = lg[z];
          for (int e = e0; e < e1; ++e, src += PT)
            acc = __fadd_rn(acc, to_f(reinterpret_cast<const T*>(src)[roll(z, tb.ent[e] >> 16)]));
          src += PF;
          tc[g * kZ + z] = from_f<T>(acc);
          if (!done) ft[g * kZ + z] = acc;
        }
      } else {
        for (int c = tb.pb[k - a.n_vb]; c < tb.pb[k - a.n_vb + 1]; ++c, src += 2 * PT + PF) {
          const T* ms = reinterpret_cast<const T*>(src);
          const T* mb = reinterpret_cast<const T*>(src + PT);
          const float* lpc = reinterpret_cast<const float*>(src + 2 * PT);
          float tp = __fadd_rn(lpc[z], to_f(ms[z]));
          // staircase message of check column c + 1 (column 0 one row down
          // for c = q - 1; check 0's is masked and counts as 0)
          const float sb = c < q - 1 ? to_f(mb[z]) : (z == kZ - 1 ? 0.0f : to_f(mb[z + 1]));
          tp = __fadd_rn(tp, sb);
          tpc[c * kZ + z] = from_f<T>(tp);
          if (!done) ftp[c * kZ + z] = tp;
        }
      }
    };
    ring.phase(a.n_vb + a.n_pb, issue_var, work_var);
    fence_async_global();
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.done[b] = done;
    a.n_iters[b] = n_iters;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) qc_mega_layered_kernel(MegaArgs a) {
  constexpr int S = D - 2;
  constexpr unsigned PT = kZ * sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int q = a.q, G = a.G;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* st = reinterpret_cast<int*>(smem + 8 * kMaxRing);
  float* s_delta = reinterpret_cast<float*>(
      smem + ((8 * kMaxRing + 4 * a.n_tab + 127) / 128) * 128);  // [D][Z]
  char* ring_buf = reinterpret_cast<char*>(s_delta + D * kZ);
  stage_tables(a, st, bar);
  const Tabs tb = tabs_at(st, S, q, G, a.n_cb, a.n_vb, a.n_pb);
  Ring ring{ring_buf, bar, a.cap, a.ring, 0u};

  const int b = blockIdx.x;
  const int z = threadIdx.x;
  const bool row = z < kZ;
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
    // one item per column: its D message planes (none yet in sweep 0)
    auto issue = [&](int j, char* dst, auto copy) -> unsigned {
      if (k == 0) return 0u;
      copy(dst, m + (size_t)j * D * kZ, D * PT);
      return D * PT;
    };
    auto work = [&](int j, const char* src) {
      const int jm1 = j == 0 ? q - 1 : j - 1;
      T* mj = m + (size_t)j * D * kZ;
      if (row) {  // pass 1 on the current totals; pass 2 to registers
        const T* mvs = reinterpret_cast<const T*>(src);
        float mv[D], x[D];
#pragma unroll
        for (int sl = 0; sl < D; ++sl) mv[sl] = k == 0 ? 0.0f : to_f(mvs[sl * kZ + z]);
        auto tot_at = [&](int sl) -> float {
          if (sl < S) {
            const int pk = tb.slot[sl * q + j];
            return tt[(pk & 0xffff) * kZ + roll(z, pk >> 16)];
          }
          if (sl == S) return tp[j * kZ + z];
          if (j > 0) return tp[jm1 * kZ + z];
          return tp[(q - 1) * kZ + roll(z, 1)];
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
          s_delta[sl * kZ + z] = (sl == S + 1 && mask) ? 0.0f : __fsub_rn(to_f(nm), mv[sl]);
        }
      }
      __syncthreads();
      if (row) {  // thread z adds row z's deltas, slot by slot
        // column j's staircase message reaches parity column j - 1; column
        // 0's reaches column q - 1 one row up
        const int zs = j > 0 ? z : (z == kZ - 1 ? 0 : z + 1);
        // every group row loaded first; then the slots in group order, each
        // group's deltas added in slot order in one register
        float t[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const int o = tb.ord[i * q + j];
          t[i] = (o & 0x100) ? tt[(tb.slot[(o & 0xff) * q + j] & 0xffff) * kZ + z] : 0.0f;
        }
        const float t0 = tp[j * kZ + z], t1 = tp[jm1 * kZ + z];
        float v = 0.0f;
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const int o = tb.ord[i * q + j];
          const int sl = o & 0xff;
          const int pk = tb.slot[sl * q + j];
          int zz = z + (pk >> 16);
          if (zz >= kZ) zz -= kZ;
          v = __fadd_rn((o & 0x100) ? t[i] : v, s_delta[sl * kZ + zz]);
          if (o & 0x200) tt[(pk & 0xffff) * kZ + z] = v;
        }
        tp[j * kZ + z] = __fadd_rn(t0, s_delta[S * kZ + z]);
        tp[jm1 * kZ + z] = __fadd_rn(t1, s_delta[(S + 1) * kZ + zs]);
      }
    };
    ring.phase(q, issue, work);  // its last barrier orders the sweep's totals
    fence_async_global();        // the sweep's messages before the next sweep's copies
    const int all_ok = __syncthreads_and(ok);
    const bool vote = k > 0 && all_ok;
    // the sweep where the vote first holds writes its end-of-sweep totals;
    // at the last sweep a codeword whose vote fails keeps the previous ones.
    // Earlier unfrozen sweeps' totals would be overwritten by a later one,
    // so only the freezing sweep and the last two write them.
    const bool frozen = k > 0 && (done || (last && !vote));
    done = done || vote;
    if (!last && !done) ++n_iters;
    if (!frozen && row && (vote || k >= a.K - 2)) {
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

// Shared memory of a launch: barriers, tables, (layered: the deltas,) the
// ring.
__host__ inline int smem_bytes(int layered, int D, const MegaArgs& a) {
  const int head = ((8 * kMaxRing + 4 * a.n_tab + 127) / 128) * 128;
  return head + (layered ? D * kZ * 4 : 0) + a.ring * a.cap;
}

template <typename T, int D>
int launch_mega(int layered, MegaArgs a, int B, cudaStream_t s) {
  // as many slots as fit the budget, at least two (one copy in flight)
  a.ring = 0;
  a.ring = (kBudget - smem_bytes(layered, D, a)) / a.cap;
  a.ring = a.ring < 2 ? 2 : (a.ring > kMaxRing ? kMaxRing : a.ring);
  const int smem = smem_bytes(layered, D, a);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = layered ? qc_mega_layered_kernel<T, D> : qc_mega_flood_kernel<T, D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, s>>>(a);
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
// llr_i (B, G, Z) and llr_p (B, q, Z) float32; tab the n_tab int32 tables of
// MegaArgs with n_cb, n_vb and n_pb check, variable and parity batches, each
// of at most cap bytes of planes (cap a multiple of 16); m (B, q, D, Z), tw
// (B, G, Z) and tpw (B, q, Z) are scratch.  Writes the frozen totals ft (B,
// G, Z) and ftp (B, q, Z) float32, done (B,) and n_iters (B,) int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int qc_mega_launch(int msg_bf16, int layered, int D, int q, int G,
                              int B, int K, int use_alpha, float alpha,
                              int early_exit, const void* llr_i,
                              const void* llr_p, const void* tab, int n_tab,
                              int n_cb, int n_vb, int n_pb, int cap, void* m,
                              void* tw, void* tpw, void* ft, void* ftp,
                              void* done, void* n_iters, void* stream) {
  if (q < 2 || G < 1 || B < 1 || K < 1 || cap < 16 || cap % 16 || n_cb < 1 || n_vb < 1 ||
      n_pb < 1)
    return (int)cudaErrorInvalidValue;
  MegaArgs a;
  a.llr_i = (const float*)llr_i;
  a.llr_p = (const float*)llr_p;
  a.tab = (const int*)tab;
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
  a.n_tab = n_tab;
  a.n_cb = n_cb;
  a.n_vb = n_vb;
  a.n_pb = n_pb;
  a.cap = cap;
  a.ring = 0;
  cudaStream_t s = (cudaStream_t)stream;
  return msg_bf16 ? dispatch_mega<__nv_bfloat16>(D, layered, a, B, s)
                  : dispatch_mega<float>(D, layered, a, B, s);
}
