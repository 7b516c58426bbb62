// N x N adaptive MIMO equalizer recurrence, hand-written for Hopper
// (sm_90a).
//
// Replaces: opticommpy_tpu/kernels/mimo_pallas.py, `_kernel` (launched by
// `_mimo_eq_run_windows`, one signal) and `_kernel_batch` (launched by
// `_mimo_eq_run_batch_windows`, B signals), with the update rules lms
// (data-aided for n_train symbols, then decision-directed), nlms, cma, rde
// and da-rde.
//
// What bounds it on an H100: a true per-symbol recurrence -- the taps
// updated at symbol k filter symbol k+1 -- so the time axis cannot be split
// across threads or CTAs.  At 2x2 modes and 15 taps one symbol is ~500
// flops on 30 complex window values and 24 bytes of input and output; the
// bytes and operation bounds are microseconds against milliseconds.  The
// time is the latency of one symbol's dependent chain (filter, reduction,
// error, tap update) times the number of symbols, and one signal keeps
// one SM busy.
//
// What held the first version back (one warp per signal, one lane per
// window value): each symbol's window and reference came from device
// memory one symbol ahead, so an L2 miss landed on the chain; every
// filter output was a 5-level butterfly over 32 lanes; the rule was a
// run-time switch over five rules; y was stored one value per symbol.
//
// Design:
//   - One CTA per signal, a loop over symbols in place of the TPU's
//     sequential grid.  The batched entry point launches the same kernel on
//     a grid of B CTAs; CTA b only moves its base pointers, so every signal
//     runs the single-signal instruction stream and K3 is bit-identical to
//     K2 per signal.
//   - Inputs staged ahead of the recurrence (stage.cuh): the windows and
//     references of a chunk of up to 256 symbols are copied with cp.async
//     into a double-buffered ring in shared memory while the recurrence
//     works on the previous chunk; the outputs of a chunk are gathered in
//     shared memory and written with coalesced stores.
//   - Output mode m is owned by a group of G lanes inside one warp; lane j
//     of the group holds the taps H[m][l] of window values l = j + G q,
//     q < V, in registers (G V >= width).  A filter output is a pairwise
//     tree over the lane's V products and a log2(G)-level butterfly inside
//     the group, in place of 5 levels over 32 lanes (at 2 x 15: G = 16,
//     V = 2, one warp; G per instance chosen by measurement,
//     tools/bench_eq_redesign.py and PERF.md).  The error of mode m
//     and its tap update need only that group's output, so the groups
//     never exchange anything; only nlms's per-input-mode window powers
//     take further butterflies, and they do not depend on the taps (off
//     the chain).
//   - The rule and the slicer are template parameters: no dead branches or
//     tables.  The grid slicer keeps its true division (x - lo) / step, as
//     the plain version's `_quantize` divides.
// With the strided layout the tree and the butterfly add in the same order
// for every G, so the splits differ in time only, not in a bit.
// Arithmetic is f32 with FMA in the filter and the update.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "stage.cuh"

#ifndef MIMO_EQ_G2
#define MIMO_EQ_G2 16  // lanes per output mode, modes <= 2 and width <= 32
#endif
#ifndef MIMO_EQ_G4
#define MIMO_EQ_G4 16  // modes <= 4 and width <= 64
#endif
#ifndef MIMO_EQ_G8
#define MIMO_EQ_G8 32  // modes <= 8 and width <= 256
#endif

namespace {

constexpr int kMaxTable = 1024;  // constellation points / rde radii

enum Alg { kLms = 0, kNlms = 1, kCma = 2, kRde = 3, kDaRde = 4 };
// template rule: the alg and, for lms / nlms, the slicer
enum Rule {
  kLmsGrid, kLmsArgmin, kNlmsGrid, kNlmsArgmin, kRuleCma, kRuleRde,
  kRuleDaRde
};

template <int RULE>
struct RuleTraits {
  static constexpr bool lms = RULE <= kNlmsArgmin;
  static constexpr bool nlms = RULE == kNlmsGrid || RULE == kNlmsArgmin;
  static constexpr bool grid = RULE == kLmsGrid || RULE == kNlmsGrid;
  static constexpr bool argmin = RULE == kLmsArgmin || RULE == kNlmsArgmin;
  static constexpr bool needs_ref = lms || RULE == kRuleDaRde;
};

// Nearest level of the uniform grid lo + k*step, k in [0, top]; rintf
// rounds half to even like torch.round.
__device__ __forceinline__ float quantize(float x, float lo, float step,
                                          float top) {
  float k = rintf((x - lo) / step);
  k = fminf(fmaxf(k, 0.0f), top);
  return k * step + lo;
}

template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

template <int V>
__device__ __forceinline__ float tree(float* s) {
#pragma unroll
  for (int h = V / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int i = 0; i < h; ++i) s[i] += s[i + h];
  }
  return s[0];
}

struct EqArgs {
  const float2* sig_pad;
  long long sig_bstride, start_off;
  int stride, n_sym, modes, width, chunk;
  const float2* ref;
  const float* c_re;
  const float* c_im;
  int m_const;
  const float* aux;
  int m_aux;
  float lo, step, top, mu;
  int n_train;
  const float2* h0;
  float2* h_out;
  float2* y;
};

template <int MAXM, int G, int V, int RULE>
__global__ void __launch_bounds__(MAXM * G) mimo_eq_kernel(const EqArgs a) {
  using T = RuleTraits<RULE>;
  const int modes = a.modes, width = a.width, chunk = a.chunk;
  const int tid = threadIdx.x;
  const int m = tid / G;  // the output mode this lane's group owns
  const int j = tid % G;
  // lanes present in this thread's warp (a CTA of fewer than 32 threads
  // fills part of one warp); groups never cross a warp
  const int warp_base = tid & ~31;
  const int in_warp = min(32, (int)blockDim.x - warp_base);
  const unsigned mask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;

  // signal blockIdx.x of a batch: (B, rows, modes) padded signals, (B,
  // n_sym, modes) references and outputs, (B, modes, width) taps
  const size_t sb = (size_t)blockIdx.x;
  const float2* sig = a.sig_pad + sb * a.sig_bstride + a.start_off;
  const float2* ref = a.ref + sb * a.n_sym * modes;
  float2* y = a.y + sb * a.n_sym * modes;
  const float2* h0 = a.h0 + sb * modes * width;
  float2* h_out = a.h_out + sb * modes * width;

  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const long long wslot = stage::window_slot(chunk, a.stride, width);
  const long long sslot = stage::symbol_slot(chunk, modes);
  float2* wring = smem;                 // [2][wslot]
  float2* rring = wring + 2 * wslot;    // [2][sslot]
  float2* ys = rring + 2 * sslot;       // [sslot]
  float* tab = reinterpret_cast<float*>(ys + sslot);
  float* s_cre = tab;                   // [m_const] (argmin slicer)
  float* s_cim = tab + a.m_const;
  float* s_aux = tab + 2 * a.m_const;   // [m_aux] (cma, rde)
  if (T::argmin)
    for (int c = tid; c < a.m_const; c += blockDim.x) {
      s_cre[c] = a.c_re[c];
      s_cim[c] = a.c_im[c];
    }
  if (RULE == kRuleCma || RULE == kRuleRde)
    for (int c = tid; c < a.m_aux; c += blockDim.x) s_aux[c] = a.aux[c];

  bool valid[V];
  int in_mode[V];
  float hr[V], hi[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int l = j + G * q;
    valid[q] = l < width;
    in_mode[q] = valid[q] ? l % modes : -1;
    float2 h = make_float2(0.0f, 0.0f);
    if (valid[q]) h = h0[(size_t)m * width + l];
    hr[q] = h.x;
    hi[q] = h.y;
  }

  const int n_chunks = (a.n_sym + chunk - 1) / chunk;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int k0 = c * chunk;
      const int cnt = min(chunk, a.n_sym - k0);
      stage::issue(wring + (c & 1) * wslot, sig + (long long)k0 * a.stride,
                   (cnt - 1) * a.stride + width);
      if (T::needs_ref)
        stage::issue(rring + (c & 1) * sslot, ref + (size_t)k0 * modes,
                     cnt * modes);
    }
    stage::commit();
  };
  issue(0);

  for (int c = 0; c < n_chunks; ++c) {
    issue(c + 1);
    stage::wait<1>();
    __syncthreads();  // chunk c (and the tables) visible to every thread
    const int k0 = c * chunk;
    const int cnt = min(chunk, a.n_sym - k0);
    const float2* wb = wring + (c & 1) * wslot +
                       stage::misalign(sig + (long long)k0 * a.stride);
    const float2* rb = rring + (c & 1) * sslot +
                       stage::misalign(ref + (size_t)k0 * modes);

    float2 w_next[V];
#pragma unroll
    for (int q = 0; q < V; ++q)
      w_next[q] = valid[q] ? wb[j + G * q] : make_float2(0.0f, 0.0f);

    for (int kk = 0; kk < cnt; ++kk) {
      float2 w[V];
#pragma unroll
      for (int q = 0; q < V; ++q) w[q] = w_next[q];
      if (kk + 1 < cnt) {
        const float2* wn = wb + (kk + 1) * a.stride;
#pragma unroll
        for (int q = 0; q < V; ++q)
          if (valid[q]) w_next[q] = wn[j + G * q];
      }
      const int k = k0 + kk;

      // filter output of mode m: a tree over the lane's products, then a
      // butterfly over the group
      float tr[V], ti[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        tr[q] = fmaf(hr[q], w[q].x, -hi[q] * w[q].y);
        ti[q] = fmaf(hr[q], w[q].y, hi[q] * w[q].x);
      }
      const float ore = group_sum<G>(tree<V>(tr), mask);
      const float oim = group_sum<G>(tree<V>(ti), mask);

      // gradient direction: the window, normalized per input mode for nlms
      // (window powers only: off the chain)
      float g_re[V], g_im[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        g_re[q] = w[q].x;
        g_im[q] = w[q].y;
      }
      if (T::nlms) {
        float p_mode[MAXM];
#pragma unroll
        for (int mm = 0; mm < MAXM; ++mm) {
          float part = 0.0f;
          if (mm < modes) {
#pragma unroll
            for (int q = 0; q < V; ++q)
              if (in_mode[q] == mm) part += w[q].x * w[q].x + w[q].y * w[q].y;
            part = group_sum<G>(part, mask);
          }
          p_mode[mm] = part;
        }
#pragma unroll
        for (int q = 0; q < V; ++q) {
          float p = 0.0f;
#pragma unroll
          for (int mm = 0; mm < MAXM; ++mm)
            if (in_mode[q] == mm) p = p_mode[mm];
          p = fmaxf(p, 1e-12f);  // zero windows: numerator is zero too
          g_re[q] = w[q].x / p;
          g_im[q] = w[q].y / p;
        }
      }

      // the rule's error
      const float p_out = ore * ore + oim * oim;
      float e_re, e_im;
      if (T::lms) {
        float t_re, t_im;
        if (k < a.n_train) {
          const float2 r = rb[kk * modes + m];
          t_re = r.x;
          t_im = r.y;
        } else if (T::grid) {
          t_re = quantize(ore, a.lo, a.step, a.top);
          t_im = quantize(oim, a.lo, a.step, a.top);
        } else {
          float best = CUDART_INF_F;
          int bi = 0;
          for (int cc = 0; cc < a.m_const; ++cc) {
            const float dr = __fsub_rn(ore, s_cre[cc]);
            const float di = __fsub_rn(oim, s_cim[cc]);
            const float d = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
            if (d < best) {
              best = d;
              bi = cc;
            }
          }
          t_re = s_cre[bi];
          t_im = s_cim[bi];
        }
        e_re = t_re - ore;
        e_im = t_im - oim;
      } else {
        float err;
        if (RULE == kRuleCma) {
          err = s_aux[0] - p_out;
        } else if (RULE == kRuleRde) {
          const float rad = sqrtf(p_out);
          float best = CUDART_INF_F;
          int bi = 0;
          for (int cc = 0; cc < a.m_aux; ++cc) {
            const float d = (rad - s_aux[cc]) * (rad - s_aux[cc]);
            if (d < best) {
              best = d;
              bi = cc;
            }
          }
          err = s_aux[bi] * s_aux[bi] - p_out;
        } else {  // da-rde: radius from the reference symbol
          const float2 r = rb[kk * modes + m];
          err = (r.x * r.x + r.y * r.y) - p_out;
        }
        e_re = err * ore;
        e_im = err * oim;
      }

      // rank-1 update H[m][l] += mu * e * conj(g[l])
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float upd_re = e_re * g_re[q] + e_im * g_im[q];
        const float upd_im = e_im * g_re[q] - e_re * g_im[q];
        hr[q] += a.mu * upd_re;
        hi[q] += a.mu * upd_im;
      }
      if (j == 0) ys[kk * modes + m] = make_float2(ore, oim);
    }

    __syncthreads();  // the chunk's outputs are in ys; its ring slot is free
    float2* yc = y + (size_t)k0 * modes;
    for (int e = tid; e < cnt * modes; e += blockDim.x) yc[e] = ys[e];
  }

#pragma unroll
  for (int q = 0; q < V; ++q)
    if (valid[q])
      h_out[(size_t)m * width + j + G * q] = make_float2(hr[q], hi[q]);
}

size_t smem_bytes(int chunk, int stride, int width, int modes, int m_const,
                  int m_aux) {
  return sizeof(float2) * (2 * stage::window_slot(chunk, stride, width) +
                           3 * stage::symbol_slot(chunk, modes)) +
         sizeof(float) * (2 * m_const + m_aux);
}

template <int MAXM, int G, int V, int RULE>
int launch(cudaStream_t stream, int n_batch, const EqArgs& a, size_t smem) {
  auto kernel = mimo_eq_kernel<MAXM, G, V, RULE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_batch, a.modes * G, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MAXM, int G, int V>
int launch_rule(int rule, cudaStream_t s, int n_batch, const EqArgs& a,
                size_t smem) {
  switch (rule) {
    case kLmsGrid: return launch<MAXM, G, V, kLmsGrid>(s, n_batch, a, smem);
    case kLmsArgmin: return launch<MAXM, G, V, kLmsArgmin>(s, n_batch, a, smem);
    case kNlmsGrid: return launch<MAXM, G, V, kNlmsGrid>(s, n_batch, a, smem);
    case kNlmsArgmin:
      return launch<MAXM, G, V, kNlmsArgmin>(s, n_batch, a, smem);
    case kRuleCma: return launch<MAXM, G, V, kRuleCma>(s, n_batch, a, smem);
    case kRuleRde: return launch<MAXM, G, V, kRuleRde>(s, n_batch, a, smem);
    default: return launch<MAXM, G, V, kRuleDaRde>(s, n_batch, a, smem);
  }
}

}  // namespace

// Symbols per staged chunk for a pass of `modes` modes, window `width` and
// window stride `stride` (values).
extern "C" int mimo_eq_chunk(int modes, int width, int stride) {
  return stage::chunk_symbols(modes, stride, width);
}

// One training pass over n_sym symbols for n_batch signals, one CTA each
// (n_batch = 1: the single-signal pass).  sig_pad: row-major (n_batch,
// rows, modes) complex64 with sig_bstride = rows * modes; within a signal
// the window of symbol k is the `width` = modes * taps values starting at
// element start_off + k * stride.  ref, y: (n_batch, n_sym, modes)
// complex64.  h0, h_out: (n_batch, modes, width) complex64 in the
// flattened tap-major/mode-minor layout.  Returns cudaGetLastError() (0 on
// success).
extern "C" int mimo_eq_launch(int n_batch, const void* sig_pad,
                              long long sig_bstride, long long start_off,
                              int stride, int n_sym, int modes, int width,
                              const void* ref, const void* c_re,
                              const void* c_im, int m_const, const void* aux,
                              int m_aux, int use_grid, float lo, float step,
                              float top, int alg, float mu, int n_train,
                              const void* h0, void* h_out, void* y,
                              void* stream) {
  if (m_const > kMaxTable || m_aux > kMaxTable || modes < 1 || alg < kLms ||
      alg > kDaRde || n_batch < 1 || n_sym < 0 || width < 1 ||
      (alg <= kNlms && !use_grid && m_const < 1) ||
      ((alg == kCma || alg == kRde) && m_aux < 1))
    return (int)cudaErrorInvalidValue;
  int rule;
  if (alg == kLms)
    rule = use_grid ? kLmsGrid : kLmsArgmin;
  else if (alg == kNlms)
    rule = use_grid ? kNlmsGrid : kNlmsArgmin;
  else
    rule = alg == kCma ? kRuleCma : (alg == kRde ? kRuleRde : kRuleDaRde);
  const int argmin = rule == kLmsArgmin || rule == kNlmsArgmin;
  const int blind = rule == kRuleCma || rule == kRuleRde;
  EqArgs a;
  a.sig_pad = (const float2*)sig_pad;
  a.sig_bstride = sig_bstride;
  a.start_off = start_off;
  a.stride = stride;
  a.n_sym = n_sym;
  a.modes = modes;
  a.width = width;
  a.chunk = stage::chunk_symbols(modes, stride, width);
  a.ref = (const float2*)ref;
  a.c_re = (const float*)c_re;
  a.c_im = (const float*)c_im;
  a.m_const = argmin ? m_const : 0;
  a.aux = (const float*)aux;
  a.m_aux = blind ? m_aux : 0;
  a.lo = lo;
  a.step = step;
  a.top = top;
  a.mu = mu;
  a.n_train = n_train;
  a.h0 = (const float2*)h0;
  a.h_out = (float2*)h_out;
  a.y = (float2*)y;
  const size_t smem =
      smem_bytes(a.chunk, stride, width, modes, a.m_const, a.m_aux);
  auto s = (cudaStream_t)stream;
  constexpr int G2 = MIMO_EQ_G2, G4 = MIMO_EQ_G4, G8 = MIMO_EQ_G8;
  if (modes <= 2 && width <= 32)
    return launch_rule<2, G2, 32 / G2>(rule, s, n_batch, a, smem);
  if (modes <= 4 && width <= 64)
    return launch_rule<4, G4, 64 / G4>(rule, s, n_batch, a, smem);
  if (modes <= 8 && width <= 256)
    return launch_rule<8, G8, 256 / G8>(rule, s, n_batch, a, smem);
  return (int)cudaErrorInvalidValue;
}
