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
// resident on chip; the cost is the latency of the chain, not FLOPs and not
// bandwidth.  Two chains interleave: Sd's (A, B, C, the update, Y), which
// needs only Sd and the window, and the taps' (o, e, the update), which
// needs Y at its end.
//
// What held the first version back: one thread per Sd row, so at 2 x 15
// one warp per signal (3 of the SM's 4 schedulers idle) issuing 30 IEEE
// divisions, a C sum recomputed by every thread with a run-time trip
// count, serial 15-term sums, two barriers per symbol and the window read
// from device memory one symbol ahead.
//
// Design: one CTA per signal.  The tap count is padded to the template
// power of two TP (zero rows and columns of Sd stay zero, and zero window
// values add nothing).  Thread (m, rt, ct) owns the R x CC tile of Sd_m at
// rows rt R ..., columns ct CC ... in registers, with ct in the low lane
// bits; NT = (TP / R) (TP / CC) threads per mode.  At 2 x 15 (TP 16, 2 x 1
// tiles) that is 256 threads, two warps per SM sub-partition, each thread
// dividing only its own 2 entries by lam.  The tiles per instance were
// chosen by measurement (tools/bench_eq_redesign.py; PERF.md).  Per symbol:
//   1. from the staged window, the partial A (over the tile's columns), B
//      (over its rows) and filter products; butterflies reduce A over the
//      column tiles, B and the filter over the row tiles in the warp; C is
//      one more row-tile butterfly over x_i A_i;
//   2. the per-warp partials of B, C and the filter go to shared memory
//      (two slots, by symbol parity) behind the one barrier of the symbol;
//      every thread then sums its mode's B and C and all warps' filter
//      partials in one fixed order, so no two threads disagree;
//   3. each thread updates its tile of Sd, reduces Y over the column tiles
//      and adds e[o] Y to the taps H[o][m][i] of its rows that it owns (o =
//      ct + (TP / CC) u).
// Windows and references are staged ahead of the recurrence in shared
// memory and outputs leave per chunk (stage.cuh).  The Sd update keeps the
// JAX order (`(Sd - A B inv) / lam`, inv = (d_re/den, -d_im/den)) with
// round-to-nearest intrinsics and a true division by lam, so nvcc cannot
// contract it into FMAs and it rounds as the plain PyTorch version does;
// only the order of the dot products' sums differs.  B is computed, not
// taken as conj(A): Sd is Hermitian only up to rounding.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "stage.cuh"

// rows x columns of a thread's Sd tile, per padded tap count (and, at 32
// taps, per mode class); chosen by tools/bench_eq_redesign.py
#ifndef RLS_R8
#define RLS_R8 1
#endif
#ifndef RLS_CC8
#define RLS_CC8 1
#endif
#ifndef RLS_R16
#define RLS_R16 2
#endif
#ifndef RLS_CC16
#define RLS_CC16 1
#endif
#ifndef RLS_R32
#define RLS_R32 2  // up to 2 modes
#endif
#ifndef RLS_CC32
#define RLS_CC32 4
#endif
#ifndef RLS_R32_M8
#define RLS_R32_M8 4  // up to 8 modes
#endif
#ifndef RLS_CC32_M8
#define RLS_CC32_M8 4
#endif

namespace {

constexpr int kMaxTable = 1024;  // constellation points of the argmin slicer

enum Slicer { kRef = 0, kGrid = 1, kArgmin = 2 };

// Nearest level of the uniform grid lo + k*step, k in [0, top]; rintf
// rounds half to even like torch.round.
__device__ __forceinline__ float quantize(float x, float lo, float step,
                                          float top) {
  float k = rintf((x - lo) / step);
  k = fminf(fmaxf(k, 0.0f), top);
  return k * step + lo;
}

// butterfly over the lane bits [LO, HI): offsets LO, 2 LO, ..., HI / 2
template <int LO, int HI>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = LO; off < HI; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct RlsArgs {
  const float2* sig_pad;
  long long sig_bstride, start_off;
  int stride, n_sym, modes, taps, chunk;
  const float2* ref;
  const float* c_re;
  const float* c_im;
  int m_const;
  float lo, step, top, lam;
  const float2* h0;
  const float2* sd0;
  float2* h_out;
  float2* sd_out;
  float2* y;
};

template <int TP, int R, int CC>
struct Tiles {
  static constexpr int NCT = TP / CC;              // column tiles
  static constexpr int NRT = TP / R;               // row tiles
  static constexpr int NT = NCT * NRT;             // threads per mode
  static constexpr int LANES = NT < 32 ? NT : 32;  // a mode's lanes per warp
  static constexpr int NWM = NT < 32 ? 1 : NT / 32;  // warps per mode
};

template <int MAXM, int TP, int R, int CC>
struct Block {  // threads of a CTA: MAXM modes, padded to whole warps
  static constexpr int threads = (MAXM * Tiles<TP, R, CC>::NT + 31) / 32 * 32;
};

template <int MAXM, int TP, int R, int CC, int SLICER>
__global__ void __launch_bounds__(Block<MAXM, TP, R, CC>::threads)
rls_kernel(const RlsArgs a) {
  using Ti = Tiles<TP, R, CC>;
  constexpr int NCT = Ti::NCT, NT = Ti::NT, NWM = Ti::NWM;
  constexpr int NU = (MAXM + NCT - 1) / NCT;  // output modes per thread
  constexpr int MAXW = Block<MAXM, TP, R, CC>::threads / 32;
  const int modes = a.modes, taps = a.taps, chunk = a.chunk;
  const int width = modes * taps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  // thread (m, rt, ct); modes m >= `modes` pad the CTA to whole warps and
  // carry zeros (they write nothing)
  const int m = tid / NT;
  const int t = tid % NT;
  const int ct = t % NCT, rt = t / NCT;
  const int wm = t / 32;  // warp of the mode (NT > 32)
  const bool live = m < modes;

  const size_t sb = (size_t)blockIdx.x;
  const float2* sig = a.sig_pad + sb * a.sig_bstride + a.start_off;
  const float2* ref = a.ref + sb * a.n_sym * modes;
  float2* y = a.y + sb * a.n_sym * modes;
  const float2* h0 = a.h0 + sb * modes * width;
  float2* h_out = a.h_out + sb * modes * width;
  const float2* sd0 = a.sd0 + sb * width * taps;
  float2* sd_out = a.sd_out + sb * width * taps;

  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const long long wslot = stage::window_slot(chunk, a.stride, width);
  const long long sslot = stage::symbol_slot(chunk, modes);
  float2* wring = smem;               // [2][wslot]
  float2* rring = wring + 2 * wslot;  // [2][sslot]
  float2* ys = rring + 2 * sslot;     // [sslot]
  // per-symbol exchange, two slots by symbol parity:
  //   red_o[slot][warp][ct][u]: the warp's filter partial of output ct + NCT u
  //   red_bc[slot][mode][wm][ct][CC + 1]: the B columns and C of a mode's warp
  const int n_mt = (int)blockDim.x / NT;  // modes of the CTA, padding included
  float2* red_o = ys + sslot;
  const int o_slot = MAXW * NCT * NU;
  float2* red_bc = red_o + 2 * o_slot;
  const int bc_slot = n_mt * NWM * NCT * (CC + 1);
  float* s_cre = reinterpret_cast<float*>(red_bc + 2 * bc_slot);
  float* s_cim = s_cre + a.m_const;
  if (SLICER == kArgmin)
    for (int c = tid; c < a.m_const; c += blockDim.x) {
      s_cre[c] = a.c_re[c];
      s_cim[c] = a.c_im[c];
    }

  // Sd tile and taps in registers
  float sr[R][CC], si[R][CC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = rt * R + r;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int jj = ct * CC + c;
      float2 v = make_float2(0.0f, 0.0f);
      if (live && i < taps && jj < taps)
        v = sd0[((size_t)m * taps + i) * taps + jj];
      sr[r][c] = v.x;
      si[r][c] = v.y;
    }
  }
  float hr[NU][R], hi[NU][R];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int o = ct + NCT * u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = rt * R + r;
      float2 v = make_float2(0.0f, 0.0f);
      if (live && o < modes && i < taps)
        v = h0[((size_t)o * modes + m) * taps + i];
      hr[u][r] = v.x;
      hi[u][r] = v.y;
    }
  }

  const int n_chunks = (a.n_sym + chunk - 1) / chunk;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int k0 = c * chunk;
      const int cnt = min(chunk, a.n_sym - k0);
      stage::issue(wring + (c & 1) * wslot, sig + (long long)k0 * a.stride,
                   (cnt - 1) * a.stride + width);
      if (SLICER == kRef)
        stage::issue(rring + (c & 1) * sslot, ref + (size_t)k0 * modes,
                     cnt * modes);
    }
    stage::commit();
  };
  issue(0);

  for (int c = 0; c < n_chunks; ++c) {
    issue(c + 1);
    stage::wait<1>();
    __syncthreads();  // chunk c (and the table) visible to every thread
    const int k0 = c * chunk;
    const int cnt = min(chunk, a.n_sym - k0);
    const float2* wb = wring + (c & 1) * wslot +
                       stage::misalign(sig + (long long)k0 * a.stride);
    const float2* rb = rring + (c & 1) * sslot +
                       stage::misalign(ref + (size_t)k0 * modes);

    for (int kk = 0; kk < cnt; ++kk) {
      const int slot = kk & 1;
      // x_m at the tile's rows and columns (zero past the taps)
      const float2* x = wb + kk * a.stride + m;
      float2 xr[R], xc[CC];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = rt * R + r;
        xr[r] = live && i < taps ? x[i * modes] : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int jj = ct * CC + cc;
        xc[cc] = live && jj < taps ? x[jj * modes] : make_float2(0.0f, 0.0f);
      }

      // filter partials of this thread's outputs
      float p_re[NU], p_im[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        p_re[u] = 0.0f;
        p_im[u] = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          p_re[u] += hr[u][r] * xr[r].x - hi[u][r] * xr[r].y;
          p_im[u] += hr[u][r] * xr[r].y + hi[u][r] * xr[r].x;
        }
      }
      // A_i = sum_j Sd[i][j] conj(x_j) over the tile's columns
      float ar[R], ai[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ar[r] = 0.0f;
        ai[r] = 0.0f;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          ar[r] += sr[r][cc] * xc[cc].x + si[r][cc] * xc[cc].y;
          ai[r] += si[r][cc] * xc[cc].x - sr[r][cc] * xc[cc].y;
        }
      }
      // B_j = sum_i x_i Sd[i][j] over the tile's rows
      float br[CC], bi[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        br[cc] = 0.0f;
        bi[cc] = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          br[cc] += xr[r].x * sr[r][cc] - xr[r].y * si[r][cc];
          bi[cc] += xr[r].x * si[r][cc] + xr[r].y * sr[r][cc];
        }
      }
      // butterflies: A over the column tiles, B over the row tiles of the
      // mode in this warp, the filter over every lane above the column tile
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ar[r] = lane_sum<1, NCT>(ar[r]);
        ai[r] = lane_sum<1, NCT>(ai[r]);
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        br[cc] = lane_sum<NCT, Ti::LANES>(br[cc]);
        bi[cc] = lane_sum<NCT, Ti::LANES>(bi[cc]);
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        p_re[u] = lane_sum<NCT, 32>(p_re[u]);
        p_im[u] = lane_sum<NCT, 32>(p_im[u]);
      }
      // C = sum_i x_i A_i: the tile's rows, then the row tiles in the warp
      float cr = 0.0f, ci = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cr += xr[r].x * ar[r] - xr[r].y * ai[r];
        ci += xr[r].x * ai[r] + xr[r].y * ar[r];
      }
      cr = lane_sum<NCT, Ti::LANES>(cr);
      ci = lane_sum<NCT, Ti::LANES>(ci);

      if (lane < NCT) {
#pragma unroll
        for (int u = 0; u < NU; ++u)
          red_o[slot * o_slot + (warp * NCT + ct) * NU + u] =
              make_float2(p_re[u], p_im[u]);
      }
      if ((t % Ti::LANES) < NCT) {  // row tile 0 of the mode in this warp
        float2* dst =
            red_bc + slot * bc_slot + ((m * NWM + wm) * NCT + ct) * (CC + 1);
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) dst[cc] = make_float2(br[cc], bi[cc]);
        dst[CC] = make_float2(cr, ci);
      }
      __syncthreads();  // the symbol's partials are visible

      // filter outputs and the rule's error, per owned output mode
      float e_re[NU], e_im[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int o = ct + NCT * u;
        float ore = 0.0f, oim = 0.0f;
#pragma unroll
        for (int w = 0; w < MAXW; ++w) {
          if (w < n_warps) {
            const float2 v = red_o[slot * o_slot + (w * NCT + ct) * NU + u];
            ore += v.x;
            oim += v.y;
          }
        }
        e_re[u] = 0.0f;
        e_im[u] = 0.0f;
        if (o < modes) {
          float t_re, t_im;
          if (SLICER == kRef) {
            const float2 rv = rb[kk * modes + o];
            t_re = rv.x;
            t_im = rv.y;
          } else if (SLICER == kGrid) {
            t_re = quantize(ore, a.lo, a.step, a.top);
            t_im = quantize(oim, a.lo, a.step, a.top);
          } else {
            float best = CUDART_INF_F;
            int bix = 0;
            for (int q = 0; q < a.m_const; ++q) {
              const float dr = __fsub_rn(ore, s_cre[q]);
              const float di = __fsub_rn(oim, s_cim[q]);
              const float d = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
              if (d < best) {
                best = d;
                bix = q;
              }
            }
            t_re = s_cre[bix];
            t_im = s_cim[bix];
          }
          e_re[u] = t_re - ore;
          e_im[u] = t_im - oim;
          if (tid == ct) ys[kk * modes + o] = make_float2(ore, oim);
        }
      }

      // the mode's B columns and C, summed over its warps in order
      float bjr[CC], bji[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        bjr[cc] = 0.0f;
        bji[cc] = 0.0f;
      }
      float c_r = 0.0f, c_i = 0.0f;
#pragma unroll
      for (int w = 0; w < NWM; ++w) {
        const float2* src =
            red_bc + slot * bc_slot + ((m * NWM + w) * NCT + ct) * (CC + 1);
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          bjr[cc] += src[cc].x;
          bji[cc] += src[cc].y;
        }
        c_r += src[CC].x;
        c_i += src[CC].y;
      }
      // 1 / (lam + C)
      const float d_re = __fadd_rn(a.lam, c_r);
      const float d_im = c_i;
      const float den = __fadd_rn(__fmul_rn(d_re, d_re), __fmul_rn(d_im, d_im));
      const float inv_re = __fdiv_rn(d_re, den);
      const float inv_im = __fdiv_rn(-d_im, den);

      // Sd tile: (Sd - A_i B_j inv) / lam; Y_i = sum_j Sd'[i][j] conj(x_j)
      float yr[R], yi[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        yr[r] = 0.0f;
        yi[r] = 0.0f;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const float ab_re = __fsub_rn(__fmul_rn(ar[r], bjr[cc]),
                                        __fmul_rn(ai[r], bji[cc]));
          const float ab_im = __fadd_rn(__fmul_rn(ar[r], bji[cc]),
                                        __fmul_rn(ai[r], bjr[cc]));
          const float sub_re =
              __fsub_rn(__fmul_rn(ab_re, inv_re), __fmul_rn(ab_im, inv_im));
          const float sub_im =
              __fadd_rn(__fmul_rn(ab_re, inv_im), __fmul_rn(ab_im, inv_re));
          sr[r][cc] = __fdiv_rn(__fsub_rn(sr[r][cc], sub_re), a.lam);
          si[r][cc] = __fdiv_rn(__fsub_rn(si[r][cc], sub_im), a.lam);
          yr[r] += sr[r][cc] * xc[cc].x + si[r][cc] * xc[cc].y;
          yi[r] += si[r][cc] * xc[cc].x - sr[r][cc] * xc[cc].y;
        }
        yr[r] = lane_sum<1, NCT>(yr[r]);
        yi[r] = lane_sum<1, NCT>(yi[r]);
      }
      // H[o][m][i] += e[o] * Y_i
#pragma unroll
      for (int u = 0; u < NU; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          hr[u][r] += e_re[u] * yr[r] - e_im[u] * yi[r];
          hi[u][r] += e_re[u] * yi[r] + e_im[u] * yr[r];
        }
      }
    }

    __syncthreads();  // the chunk's outputs are in ys; its ring slot is free
    float2* yc = y + (size_t)k0 * modes;
    for (int e = tid; e < cnt * modes; e += blockDim.x) yc[e] = ys[e];
  }

  if (live) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int o = ct + NCT * u;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = rt * R + r;
        if (o < modes && i < taps)
          h_out[((size_t)o * modes + m) * taps + i] =
              make_float2(hr[u][r], hi[u][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = rt * R + r;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int jj = ct * CC + cc;
        if (i < taps && jj < taps)
          sd_out[((size_t)m * taps + i) * taps + jj] =
              make_float2(sr[r][cc], si[r][cc]);
      }
    }
  }
}

template <int MAXM, int TP, int R, int CC, int SLICER>
int launch(cudaStream_t stream, int n_batch, const RlsArgs& a) {
  using Ti = Tiles<TP, R, CC>;
  constexpr int NCT = Ti::NCT, NWM = Ti::NWM;
  constexpr int NU = (MAXM + NCT - 1) / NCT;
  constexpr int MAXW = Block<MAXM, TP, R, CC>::threads / 32;
  const int threads = (a.modes * Ti::NT + 31) / 32 * 32;
  const int n_mt = threads / Ti::NT;
  const size_t smem =
      sizeof(float2) *
          (2 * stage::window_slot(a.chunk, a.stride, a.modes * a.taps) +
           3 * stage::symbol_slot(a.chunk, a.modes) + 2 * MAXW * NCT * NU +
           2 * n_mt * NWM * NCT * (CC + 1)) +
      sizeof(float) * 2 * a.m_const;
  auto kernel = rls_kernel<MAXM, TP, R, CC, SLICER>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_batch, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MAXM, int TP, int R, int CC>
int launch_slicer(int slicer, cudaStream_t s, int n_batch, const RlsArgs& a) {
  if (slicer == kRef) return launch<MAXM, TP, R, CC, kRef>(s, n_batch, a);
  if (slicer == kGrid) return launch<MAXM, TP, R, CC, kGrid>(s, n_batch, a);
  return launch<MAXM, TP, R, CC, kArgmin>(s, n_batch, a);
}

template <int TP, int R2, int CC2, int R8, int CC8>
int launch_modes(int slicer, cudaStream_t s, int n_batch, const RlsArgs& a) {
  if (a.modes <= 2) return launch_slicer<2, TP, R2, CC2>(slicer, s, n_batch, a);
  return launch_slicer<8, TP, R8, CC8>(slicer, s, n_batch, a);
}

}  // namespace

// Symbols per staged chunk of an RLS pass (modes, taps, window stride).
extern "C" int rls_chunk(int modes, int taps, int stride) {
  return stage::chunk_symbols(modes, stride, modes * taps);
}

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
  if (n_batch < 1 || n_sym < 0 || modes < 1 || modes > 8 || taps < 1 ||
      taps > 32 || modes * taps > 256 || slicer < kRef || slicer > kArgmin ||
      m_const > kMaxTable || (slicer == kArgmin && m_const < 1))
    return (int)cudaErrorInvalidValue;
  RlsArgs a;
  a.sig_pad = (const float2*)sig_pad;
  a.sig_bstride = sig_bstride;
  a.start_off = start_off;
  a.stride = stride;
  a.n_sym = n_sym;
  a.modes = modes;
  a.taps = taps;
  a.chunk = stage::chunk_symbols(modes, stride, modes * taps);
  a.ref = (const float2*)ref;
  a.c_re = (const float*)c_re;
  a.c_im = (const float*)c_im;
  a.m_const = slicer == kArgmin ? m_const : 0;
  a.lo = lo;
  a.step = step;
  a.top = top;
  a.lam = lam;
  a.h0 = (const float2*)h0;
  a.sd0 = (const float2*)sd0;
  a.h_out = (float2*)h_out;
  a.sd_out = (float2*)sd_out;
  a.y = (float2*)y;
  auto s = (cudaStream_t)stream;
  if (taps <= 8)
    return launch_modes<8, RLS_R8, RLS_CC8, RLS_R8, RLS_CC8>(slicer, s,
                                                             n_batch, a);
  if (taps <= 16)
    return launch_modes<16, RLS_R16, RLS_CC16, RLS_R16, RLS_CC16>(
        slicer, s, n_batch, a);
  return launch_modes<32, RLS_R32, RLS_CC32, RLS_R32_M8, RLS_CC32_M8>(
      slicer, s, n_batch, a);
}
