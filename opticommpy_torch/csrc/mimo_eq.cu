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
// flops on 30 complex window values; the cost is the latency of the
// dependent chain (window load, dot product, cross-lane reduction, error,
// tap update), not FLOPs and not bandwidth, and one signal keeps one SM
// busy.
//
// Design: one CTA of one warp per signal, a loop over symbols in place of
// the TPU's sequential grid (so there is no tail padding to replicate).
// The batched entry point launches the same kernel on a grid of B CTAs;
// CTA b only moves its base pointers to signal b, so every signal runs the
// single-signal instruction stream and the batched outputs are
// bit-identical to single-signal launches.  The TPU packed the batch on
// the sublane axis to fill its vector registers; here the B recurrences run
// on B SMs side by side, and B up to the SM count costs the time of one.
// Lane l owns window lane l (and l + 32, ... for wider equalizers) in the
// TPU kernel's flattened tap-major/mode-minor layout l = t * modes + i, and
// keeps the taps H[o][l] of every output mode in registers for the whole
// run.  A window is a contiguous run of `width` complex values of the
// row-major padded signal, read straight from device memory (no
// pre-gathered window tensor); the next symbol's window and reference are
// loaded while the current symbol is processed.  Per symbol, butterfly
// shuffles give every lane the `modes` filter outputs, every lane
// evaluates the rule's error itself (no broadcast), and each lane applies
// the rank-1 update H[o][l] += mu * e[o] * conj(g[l]) to its own taps.
// Arithmetic is f32 with FMA.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxTable = 1024;  // constellation points / rde radii

enum Alg { kLms = 0, kNlms = 1, kCma = 2, kRde = 3, kDaRde = 4 };

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

template <int MAXM, int LPL>
__global__ void __launch_bounds__(32)
mimo_eq_kernel(const float2* __restrict__ sig_pad, long long sig_bstride,
               long long start_off, int stride, int n_sym, int modes, int width,
               const float2* __restrict__ ref, const float* __restrict__ c_re,
               const float* __restrict__ c_im, int m_const,
               const float* __restrict__ aux, int m_aux, int use_grid,
               float lo, float step, float top, int alg, float mu,
               int n_train, const float2* __restrict__ h0,
               float2* __restrict__ h_out, float2* __restrict__ y) {
  __shared__ float s_cre[kMaxTable];
  __shared__ float s_cim[kMaxTable];
  __shared__ float s_aux[kMaxTable];
  const int lane = threadIdx.x;
  // signal blockIdx.x of a batch: (B, rows, modes) padded signals, (B,
  // n_sym, modes) references and outputs, (B, modes, width) taps
  const size_t sig_b = (size_t)blockIdx.x;
  sig_pad += sig_b * sig_bstride;
  ref += sig_b * n_sym * modes;
  y += sig_b * n_sym * modes;
  h0 += sig_b * modes * width;
  h_out += sig_b * modes * width;
  for (int i = lane; i < m_const; i += 32) {
    s_cre[i] = c_re[i];
    s_cim[i] = c_im[i];
  }
  for (int i = lane; i < m_aux; i += 32) s_aux[i] = aux[i];
  __syncwarp();

  bool valid[LPL];
  int in_mode[LPL];
  float hr[MAXM][LPL], hi[MAXM][LPL];
#pragma unroll
  for (int q = 0; q < LPL; ++q) {
    const int l = lane + 32 * q;
    valid[q] = l < width;
    in_mode[q] = valid[q] ? l % modes : 0;
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      float2 h = make_float2(0.0f, 0.0f);
      if (m < modes && valid[q]) h = h0[(size_t)m * width + l];
      hr[m][q] = h.x;
      hi[m][q] = h.y;
    }
  }

  float2 w_next[LPL];
  float2 r_next[MAXM];
#pragma unroll
  for (int q = 0; q < LPL; ++q) {
    w_next[q] = make_float2(0.0f, 0.0f);
    if (valid[q] && n_sym > 0) w_next[q] = sig_pad[start_off + lane + 32 * q];
  }
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    r_next[m] = make_float2(0.0f, 0.0f);
    if (m < modes && n_sym > 0) r_next[m] = ref[m];
  }

  for (int k = 0; k < n_sym; ++k) {
    float2 w[LPL];
    float2 r[MAXM];
#pragma unroll
    for (int q = 0; q < LPL; ++q) w[q] = w_next[q];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) r[m] = r_next[m];
    if (k + 1 < n_sym) {
      const long long base = start_off + (long long)(k + 1) * stride;
#pragma unroll
      for (int q = 0; q < LPL; ++q)
        if (valid[q]) w_next[q] = sig_pad[base + lane + 32 * q];
#pragma unroll
      for (int m = 0; m < MAXM; ++m)
        if (m < modes) r_next[m] = ref[(size_t)(k + 1) * modes + m];
    }

    // filter outputs o[m] = sum_l H[m][l] * w[l]
    float o_re[MAXM], o_im[MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      float pr = 0.0f, pi = 0.0f;
      if (m < modes) {
#pragma unroll
        for (int q = 0; q < LPL; ++q) {
          pr += hr[m][q] * w[q].x - hi[m][q] * w[q].y;
          pi += hr[m][q] * w[q].y + hi[m][q] * w[q].x;
        }
        pr = warp_sum(pr);
        pi = warp_sum(pi);
      }
      o_re[m] = pr;
      o_im[m] = pi;
    }

    // the rule's error per output mode
    float e_re[MAXM], e_im[MAXM];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      e_re[m] = 0.0f;
      e_im[m] = 0.0f;
      if (m >= modes) continue;
      const float ore = o_re[m], oim = o_im[m];
      const float p_out = ore * ore + oim * oim;
      if (alg == kLms || alg == kNlms) {
        float t_re, t_im;
        if (k < n_train) {
          t_re = r[m].x;
          t_im = r[m].y;
        } else if (use_grid) {
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
        e_re[m] = t_re - ore;
        e_im[m] = t_im - oim;
      } else if (alg == kCma) {
        const float err = s_aux[0] - p_out;
        e_re[m] = err * ore;
        e_im[m] = err * oim;
      } else if (alg == kRde) {
        const float rad = sqrtf(p_out);
        float best = CUDART_INF_F;
        int bi = 0;
        for (int c = 0; c < m_aux; ++c) {
          const float d = (rad - s_aux[c]) * (rad - s_aux[c]);
          if (d < best) {
            best = d;
            bi = c;
          }
        }
        const float err = s_aux[bi] * s_aux[bi] - p_out;
        e_re[m] = err * ore;
        e_im[m] = err * oim;
      } else {  // da-rde: radius from the reference symbol
        const float err = (r[m].x * r[m].x + r[m].y * r[m].y) - p_out;
        e_re[m] = err * ore;
        e_im[m] = err * oim;
      }
    }

    // gradient direction: the window, normalized per input mode for nlms
    float g_re[LPL], g_im[LPL];
#pragma unroll
    for (int q = 0; q < LPL; ++q) {
      g_re[q] = w[q].x;
      g_im[q] = w[q].y;
    }
    if (alg == kNlms) {
      float p_mode[MAXM];
#pragma unroll
      for (int mm = 0; mm < MAXM; ++mm) {
        float part = 0.0f;
        if (mm < modes) {
#pragma unroll
          for (int q = 0; q < LPL; ++q)
            if (valid[q] && in_mode[q] == mm)
              part += w[q].x * w[q].x + w[q].y * w[q].y;
          part = warp_sum(part);
        }
        p_mode[mm] = part;
      }
#pragma unroll
      for (int q = 0; q < LPL; ++q) {
        float p = 0.0f;
#pragma unroll
        for (int mm = 0; mm < MAXM; ++mm)
          if (in_mode[q] == mm) p = p_mode[mm];
        p = fmaxf(p, 1e-12f);  // zero windows: numerator is zero too
        g_re[q] = w[q].x / p;
        g_im[q] = w[q].y / p;
      }
    }

    // rank-1 update H[m][l] += mu * e[m] * conj(g[l])
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= modes) continue;
#pragma unroll
      for (int q = 0; q < LPL; ++q) {
        const float upd_re = e_re[m] * g_re[q] + e_im[m] * g_im[q];
        const float upd_im = e_im[m] * g_re[q] - e_re[m] * g_im[q];
        hr[m][q] += mu * upd_re;
        hi[m][q] += mu * upd_im;
      }
    }

#pragma unroll
    for (int m = 0; m < MAXM; ++m)
      if (m < modes && lane == m)
        y[(size_t)k * modes + m] = make_float2(o_re[m], o_im[m]);
  }

#pragma unroll
  for (int q = 0; q < LPL; ++q) {
    if (!valid[q]) continue;
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
      if (m < modes)
        h_out[(size_t)m * width + lane + 32 * q] =
            make_float2(hr[m][q], hi[m][q]);
  }
}

template <int MAXM, int LPL>
void launch(cudaStream_t stream, int n_batch, const float2* sig_pad,
            long long sig_bstride, long long start_off, int stride,
            int n_sym, int modes, int width, const float2* ref,
            const float* c_re, const float* c_im, int m_const,
            const float* aux, int m_aux, int use_grid, float lo, float step,
            float top, int alg, float mu, int n_train, const float2* h0,
            float2* h_out, float2* y) {
  mimo_eq_kernel<MAXM, LPL><<<n_batch, 32, 0, stream>>>(
      sig_pad, sig_bstride, start_off, stride, n_sym, modes, width, ref,
      c_re, c_im, m_const, aux, m_aux, use_grid, lo, step, top, alg, mu,
      n_train, h0, h_out, y);
}

}  // namespace

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
      alg > kDaRde || n_batch < 1)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto sp = (const float2*)sig_pad;
  auto rf = (const float2*)ref;
  auto cr = (const float*)c_re;
  auto ci = (const float*)c_im;
  auto ax = (const float*)aux;
  auto hp = (const float2*)h0;
  auto ho = (float2*)h_out;
  auto yo = (float2*)y;
  if (modes <= 2 && width <= 32)
    launch<2, 1>(s, n_batch, sp, sig_bstride, start_off, stride, n_sym,
                 modes, width, rf, cr, ci, m_const, ax, m_aux, use_grid, lo,
                 step, top, alg, mu, n_train, hp, ho, yo);
  else if (modes <= 4 && width <= 64)
    launch<4, 2>(s, n_batch, sp, sig_bstride, start_off, stride, n_sym,
                 modes, width, rf, cr, ci, m_const, ax, m_aux, use_grid, lo,
                 step, top, alg, mu, n_train, hp, ho, yo);
  else if (modes <= 8 && width <= 256)
    launch<8, 8>(s, n_batch, sp, sig_bstride, start_off, stride, n_sym,
                 modes, width, rf, cr, ci, m_const, ax, m_aux, use_grid, lo,
                 step, top, alg, mu, n_train, hp, ho, yo);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
