// RLS / DD-RLS adaptive MIMO equalizer recurrence, hand-written for Hopper
// (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/rls_pallas.py, `_kernel_batch` (launched
// by `_rls_run_windows`: B signals, data-aided rls or dd-rls with the
// quantized square-QAM slicer) and `_kernel` (launched by `_rls_run`: one
// signal, dd-rls with the argmin slicer over any constellation).  One
// source serves both; the slicer is a template parameter.
//
// Per symbol, per input mode m (x = the window column of mode m, T taps):
//   A = Sd_m conj(x);  B = x^T Sd_m;  C = x^T A
//   Sd_m' = (Sd_m - A B / (lam + C)) / lam;  Y_m = Sd_m' conj(x)
//   H[o, m, :] += e[o] * Y_m            (no step size: RLS is self-scaling)
// with e = ref - o (rls) or decision(o) - o (dd-rls), o = sum H x.
//
// What bounds it on an H100: a per-symbol recurrence -- Sd and H updated at
// symbol k filter symbol k+1 -- so one signal is one dependent chain.  At
// 2 modes and 15 taps a symbol is ~7 k flops on 450 complex Sd values, all
// resident on chip; the cost is the latency of the chain (three
// cross-thread exchanges per symbol), not FLOPs and not bandwidth.
//
// Design: one CTA per signal, a loop over symbols in place of the TPU's
// sequential grid (tail symbols are never visited, so they cannot rescale
// Sd).  Thread r = m * T + i owns row i of Sd_m in registers and the taps
// H[o][m][i] of every output mode.  Per symbol:
//   1. the window (contiguous in the padded signal) is in shared memory,
//      double-buffered, loaded one symbol ahead;
//   2. thread r forms A_i from its row, the column sum B_i from the shared
//      copy of Sd, and its filter products H[o][m][i] x_i; warp shuffles
//      and a shared-memory pass over warps give every thread o;
//   3. after one barrier every thread reads C_m from the shared A, updates
//      its Sd row (registers and shared copy), accumulates Y_i and updates
//      its taps.
// The Sd update keeps the JAX order (`(Sd - A B inv) / lam`, inv =
// (d_re/den, -d_im/den)) with round-to-nearest intrinsics, so nvcc cannot
// contract it into FMAs and it rounds as the plain PyTorch version does;
// only the order of the dot products' sums differs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxTable = 1024;  // constellation points of the argmin slicer
constexpr int kMaxThreads = 256;

enum Slicer { kRef = 0, kGrid = 1, kArgmin = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Nearest level of the uniform grid lo + k*step, k in [0, top]; rintf
// rounds half to even like jnp.round.
__device__ __forceinline__ float quantize(float x, float lo, float step,
                                          float top) {
  float k = rintf((x - lo) / step);
  k = fminf(fmaxf(k, 0.0f), top);
  return k * step + lo;
}

template <int MAXM, int TMAX, int SLICER>
__global__ void __launch_bounds__(kMaxThreads)
rls_kernel(const float2* __restrict__ sig_pad, long long sig_bstride,
           long long start_off, int stride, int n_sym, int modes, int taps,
           const float2* __restrict__ ref, const float* __restrict__ c_re,
           const float* __restrict__ c_im, int m_const, float lo, float step,
           float top, float lam, const float2* __restrict__ h0,
           const float2* __restrict__ sd0, float2* __restrict__ h_out,
           float2* __restrict__ sd_out, float2* __restrict__ y) {
  const int rows = modes * taps;  // = the window width
  const int n_warps = (blockDim.x + 31) / 32;
  extern __shared__ float2 smem[];
  float2* sd_s = smem;                     // [modes][taps][taps]
  float2* xs = sd_s + rows * taps;         // [2][modes][taps]
  float2* a_s = xs + 2 * rows;             // [modes][taps]
  float2* b_s = a_s + rows;                // [modes][taps]
  float2* red = b_s + rows;                // [n_warps][MAXM]
  float* s_cre = (float*)(red + n_warps * MAXM);
  float* s_cim = s_cre + m_const;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool active = tid < rows;
  const int m = active ? tid / taps : 0;
  const int i = active ? tid % taps : 0;
  // the window element this thread loads: flat lane tid = t * modes + mode
  const int ld_dst = active ? (tid % modes) * taps + tid / modes : 0;

  // signal blockIdx.x of a batch
  const size_t sb = (size_t)blockIdx.x;
  sig_pad += sb * sig_bstride;
  ref += sb * n_sym * modes;
  y += sb * n_sym * modes;
  h0 += sb * modes * rows;
  h_out += sb * modes * rows;
  sd0 += sb * rows * taps;
  sd_out += sb * rows * taps;

  if (SLICER == kArgmin)
    for (int c = tid; c < m_const; c += blockDim.x) {
      s_cre[c] = c_re[c];
      s_cim[c] = c_im[c];
    }

  float sr[TMAX], si[TMAX];
  float hr[MAXM], hi[MAXM];
#pragma unroll
  for (int j = 0; j < TMAX; ++j) {
    float2 v = make_float2(0.0f, 0.0f);
    if (active && j < taps) {
      v = sd0[(size_t)tid * taps + j];
      sd_s[tid * taps + j] = v;
    }
    sr[j] = v.x;
    si[j] = v.y;
  }
#pragma unroll
  for (int o = 0; o < MAXM; ++o) {
    float2 v = make_float2(0.0f, 0.0f);
    if (active && o < modes) v = h0[(size_t)o * rows + tid];  // H[o][m][i]
    hr[o] = v.x;
    hi[o] = v.y;
  }
  if (active && n_sym > 0) xs[ld_dst] = sig_pad[start_off + tid];

  for (int k = 0; k < n_sym; ++k) {
    const float2* x = xs + (k & 1) * rows + m * taps;  // x_m[0..taps)
    __syncthreads();  // window k and the Sd rows of symbol k-1 are visible
    float2 w_next = make_float2(0.0f, 0.0f);
    if (active && k + 1 < n_sym)
      w_next = sig_pad[start_off + (long long)(k + 1) * stride + tid];

    float p_re[MAXM], p_im[MAXM];
#pragma unroll
    for (int o = 0; o < MAXM; ++o) {
      p_re[o] = 0.0f;
      p_im[o] = 0.0f;
    }
    if (active) {
      const float2 xo = x[i];
#pragma unroll
      for (int o = 0; o < MAXM; ++o) {
        p_re[o] = hr[o] * xo.x - hi[o] * xo.y;
        p_im[o] = hr[o] * xo.y + hi[o] * xo.x;
      }
      // A_i = sum_j Sd[i][j] conj(x_j);  B_i = sum_r x_r Sd[r][i]
      float ar = 0.0f, ai = 0.0f, br = 0.0f, bi = 0.0f;
#pragma unroll
      for (int j = 0; j < TMAX; ++j) {
        if (j < taps) {
          const float2 xj = x[j];
          ar += sr[j] * xj.x + si[j] * xj.y;
          ai += si[j] * xj.x - sr[j] * xj.y;
          const float2 s = sd_s[(m * taps + j) * taps + i];
          br += xj.x * s.x - xj.y * s.y;
          bi += xj.x * s.y + xj.y * s.x;
        }
      }
      a_s[tid] = make_float2(ar, ai);
      b_s[tid] = make_float2(br, bi);
    }
#pragma unroll
    for (int o = 0; o < MAXM; ++o) {
      if (o < modes) {
        const float pr = warp_sum(p_re[o]);
        const float pi = warp_sum(p_im[o]);
        if (lane == 0) red[warp * MAXM + o] = make_float2(pr, pi);
      }
    }
    __syncthreads();  // A, B and the per-warp filter sums are visible

    if (active) {
      // filter outputs and the rule's error, per output mode
      float e_re[MAXM], e_im[MAXM];
#pragma unroll
      for (int o = 0; o < MAXM; ++o) {
        e_re[o] = 0.0f;
        e_im[o] = 0.0f;
        if (o >= modes) continue;
        float ore = 0.0f, oim = 0.0f;
        for (int w = 0; w < n_warps; ++w) {
          ore += red[w * MAXM + o].x;
          oim += red[w * MAXM + o].y;
        }
        float t_re, t_im;
        if (SLICER == kRef) {
          const float2 r = ref[(size_t)k * modes + o];
          t_re = r.x;
          t_im = r.y;
        } else if (SLICER == kGrid) {
          t_re = quantize(ore, lo, step, top);
          t_im = quantize(oim, lo, step, top);
        } else {
          float best = CUDART_INF_F;
          int bi = 0;
          for (int c = 0; c < m_const; ++c) {
            const float dr = ore - s_cre[c];
            const float di = oim - s_cim[c];
            const float d = dr * dr + di * di;
            if (d < best) {
              best = d;
              bi = c;
            }
          }
          t_re = s_cre[bi];
          t_im = s_cim[bi];
        }
        e_re[o] = t_re - ore;
        e_im[o] = t_im - oim;
        if (tid == o) y[(size_t)k * modes + o] = make_float2(ore, oim);
      }

      // C_m = x^T A, then 1 / (lam + C)
      float c_r = 0.0f, c_i = 0.0f;
      for (int j = 0; j < taps; ++j) {
        const float2 xj = x[j];
        const float2 aj = a_s[m * taps + j];
        c_r += xj.x * aj.x - xj.y * aj.y;
        c_i += xj.x * aj.y + xj.y * aj.x;
      }
      const float d_re = __fadd_rn(lam, c_r);
      const float d_im = c_i;
      const float den = __fadd_rn(__fmul_rn(d_re, d_re), __fmul_rn(d_im, d_im));
      const float inv_re = __fdiv_rn(d_re, den);
      const float inv_im = __fdiv_rn(-d_im, den);

      // Sd row i: (Sd - A_i B_j inv) / lam; Y_i = sum_j Sd'[i][j] conj(x_j)
      const float2 a = a_s[tid];
      float yr = 0.0f, yi = 0.0f;
#pragma unroll
      for (int j = 0; j < TMAX; ++j) {
        if (j < taps) {
          const float2 bj = b_s[m * taps + j];
          const float ab_re = __fsub_rn(__fmul_rn(a.x, bj.x), __fmul_rn(a.y, bj.y));
          const float ab_im = __fadd_rn(__fmul_rn(a.x, bj.y), __fmul_rn(a.y, bj.x));
          const float sub_re =
              __fsub_rn(__fmul_rn(ab_re, inv_re), __fmul_rn(ab_im, inv_im));
          const float sub_im =
              __fadd_rn(__fmul_rn(ab_re, inv_im), __fmul_rn(ab_im, inv_re));
          sr[j] = __fdiv_rn(__fsub_rn(sr[j], sub_re), lam);
          si[j] = __fdiv_rn(__fsub_rn(si[j], sub_im), lam);
          sd_s[tid * taps + j] = make_float2(sr[j], si[j]);
          const float2 xj = x[j];
          yr += sr[j] * xj.x + si[j] * xj.y;
          yi += si[j] * xj.x - sr[j] * xj.y;
        }
      }
      // H[o][m][i] += e[o] * Y_i
#pragma unroll
      for (int o = 0; o < MAXM; ++o) {
        if (o < modes) {
          hr[o] += e_re[o] * yr - e_im[o] * yi;
          hi[o] += e_re[o] * yi + e_im[o] * yr;
        }
      }
      if (k + 1 < n_sym) xs[((k + 1) & 1) * rows + ld_dst] = w_next;
    }
  }

  if (active) {
#pragma unroll
    for (int o = 0; o < MAXM; ++o)
      if (o < modes) h_out[(size_t)o * rows + tid] = make_float2(hr[o], hi[o]);
#pragma unroll
    for (int j = 0; j < TMAX; ++j)
      if (j < taps) sd_out[(size_t)tid * taps + j] = make_float2(sr[j], si[j]);
  }
}

template <int MAXM, int TMAX, int SLICER>
int launch(cudaStream_t stream, int n_batch, int threads, size_t smem,
           const float2* sig_pad, long long sig_bstride, long long start_off,
           int stride, int n_sym, int modes, int taps, const float2* ref,
           const float* c_re, const float* c_im, int m_const, float lo,
           float step, float top, float lam, const float2* h0,
           const float2* sd0, float2* h_out, float2* sd_out, float2* y) {
  auto kernel = rls_kernel<MAXM, TMAX, SLICER>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_batch, threads, smem, stream>>>(
      sig_pad, sig_bstride, start_off, stride, n_sym, modes, taps, ref, c_re,
      c_im, m_const, lo, step, top, lam, h0, sd0, h_out, sd_out, y);
  return (int)cudaGetLastError();
}

template <int MAXM, int TMAX>
int launch_slicer(int slicer, cudaStream_t s, int n_batch, int threads,
                  size_t smem, const float2* sp, long long sbs,
                  long long start_off, int stride, int n_sym, int modes,
                  int taps, const float2* rf, const float* cr,
                  const float* ci, int m_const, float lo, float step,
                  float top, float lam, const float2* h0, const float2* sd0,
                  float2* ho, float2* sdo, float2* yo) {
  if (slicer == kRef)
    return launch<MAXM, TMAX, kRef>(s, n_batch, threads, smem, sp, sbs,
                                    start_off, stride, n_sym, modes, taps, rf,
                                    cr, ci, m_const, lo, step, top, lam, h0,
                                    sd0, ho, sdo, yo);
  if (slicer == kGrid)
    return launch<MAXM, TMAX, kGrid>(s, n_batch, threads, smem, sp, sbs,
                                     start_off, stride, n_sym, modes, taps,
                                     rf, cr, ci, m_const, lo, step, top, lam,
                                     h0, sd0, ho, sdo, yo);
  return launch<MAXM, TMAX, kArgmin>(s, n_batch, threads, smem, sp, sbs,
                                     start_off, stride, n_sym, modes, taps,
                                     rf, cr, ci, m_const, lo, step, top, lam,
                                     h0, sd0, ho, sdo, yo);
}

}  // namespace

// One RLS training pass over n_sym symbols for n_batch signals, one CTA
// each.  sig_pad: (n_batch, rows, modes) complex64, sig_bstride = rows *
// modes; the window of symbol k of a signal is the modes * taps values
// starting at element start_off + k * stride (tap-major, mode-minor).
// ref, y: (n_batch, n_sym, modes); h0, h_out: (n_batch, modes, modes,
// taps) as H[out][in][tap]; sd0, sd_out: (n_batch, modes, taps, taps).
// slicer: 0 = data-aided (rls), 1 = quantized square QAM (grid lo + k *
// step, k in [0, top]), 2 = argmin over the m_const points c_re + j c_im.
// Returns cudaGetLastError() (0 on success).
extern "C" int rls_launch(int n_batch, const void* sig_pad,
                          long long sig_bstride, long long start_off,
                          int stride, int n_sym, int modes, int taps,
                          const void* ref, const void* c_re, const void* c_im,
                          int m_const, int slicer, float lo, float step,
                          float top, float lam, const void* h0,
                          const void* sd0, void* h_out, void* sd_out,
                          void* y, void* stream) {
  const int rows = modes * taps;
  if (n_batch < 1 || modes < 1 || taps < 1 || rows > kMaxThreads ||
      slicer < kRef || slicer > kArgmin || m_const > kMaxTable ||
      (slicer == kArgmin && m_const < 1))
    return (int)cudaErrorInvalidValue;
  const int threads = (rows + 31) / 32 * 32;
  auto s = (cudaStream_t)stream;
  auto sp = (const float2*)sig_pad;
  auto rf = (const float2*)ref;
  auto cr = (const float*)c_re;
  auto ci = (const float*)c_im;
  auto hp = (const float2*)h0;
  auto sdp = (const float2*)sd0;
  auto ho = (float2*)h_out;
  auto sdo = (float2*)sd_out;
  auto yo = (float2*)y;
  const int tables = slicer == kArgmin ? 2 * m_const : 0;
  auto smem_for = [&](int maxm) {
    return sizeof(float2) * ((size_t)rows * taps + 4 * rows +
                             (threads / 32) * maxm) +
           sizeof(float) * tables;
  };
  if (modes <= 2 && taps <= 16)
    return launch_slicer<2, 16>(slicer, s, n_batch, threads, smem_for(2), sp,
                                sig_bstride, start_off, stride, n_sym, modes,
                                taps, rf, cr, ci, m_const, lo, step, top, lam,
                                hp, sdp, ho, sdo, yo);
  if (modes <= 4 && taps <= 16)
    return launch_slicer<4, 16>(slicer, s, n_batch, threads, smem_for(4), sp,
                                sig_bstride, start_off, stride, n_sym, modes,
                                taps, rf, cr, ci, m_const, lo, step, top, lam,
                                hp, sdp, ho, sdo, yo);
  if (modes <= 8 && taps <= 32)
    return launch_slicer<8, 32>(slicer, s, n_batch, threads, smem_for(8), sp,
                                sig_bstride, start_off, stride, n_sym, modes,
                                taps, rf, cr, ci, m_const, lo, step, top, lam,
                                hp, sdp, ho, sdo, yo);
  return (int)cudaErrorInvalidValue;
}
