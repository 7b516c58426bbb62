// The adaptive Manakov step's elementwise work, hand-written for Hopper
// (sm_90a): K16.
//
// Replaces: no Pallas kernel.  The JAX package's adaptive Manakov solver
// (models/channels.py, `manakov_ssf` with nlprMethod) leaves the step's
// elementwise work to XLA, which fuses it.  In PyTorch ops one trapezoidal
// pass on the (2, B, N) complex64 field is ~25 kernels (the phase rotation,
// its exponential, the products, two |.|^2 sums, the copy of the field),
// ~370 MB of device-memory traffic at (2, 1, 2^20), and the step's start
// ~200 MB more (models/channels.py, `_step_start`, `_trap_pass`,
// `convergence_condition`).
//
// The function (the field e = (ex, ey), each (B, N); c = (8/9) gamma):
//   power:    pch = |ex|^2 + |ey|^2; phi = c (pch + |ex|^2 + |ey|^2) / 2 and
//             its maximum; with a step, the step rule below.
//   step:     hz = min(max_rot / phi_max, span_end - z), z += hz,
//             status[1] = z < span_end (power's last block, or a launch of
//             its own after the caller has all-reduced phi_max).
//   lin:      lin_op = exp(lin_arg * hz / 2) (or the given lin_op); the
//             spectrum times lin_op times inv_n (the inverse FFT's 1/N, so
//             the caller's inverse FFT is unnormalized).
//   rotate:   e_hd * exp(j sign phi hz) with phi from the pass's estimate
//             e_conv and the start-of-step power pch.
//   converge: sum |e_fd - e_conv|^2 and sum |e_conv|^2, e_fd written over
//             e_conv where asked, and status[0] = sqrt(num) / sqrt(den).
// Each kernel has a complex64 (float) and a complex128 (double) instance:
// the field's precision.  |x|^2 is hypot(re, im) squared and every
// operation of the rule is rounded as the PyTorch ops round it on the card
// (the _rn intrinsics; the exponentials exp and sincos, as the complex exp;
// max_rot / phi_max as the reciprocal times max_rot), so the fields, steps
// and passes are the ops' bits in complex64; the sums alone differ in their
// last bits, taken in double.
//
// What bounds it on an H100: bytes.  A pass reads e_conv, e_hd and pch and
// writes the rotated field (56 MB at (2, 1, 2^20) complex64), reads and
// writes the spectrum with lin_op (40 MB), and reads e_fd and e_conv and
// writes the field (48 MB): ~144 MB, 43 us at 3.35 TB/s; a step's start
// ~72 MB more; twice that in complex128.  Tens of float operations an
// element (sincosf ~20).
//
// Design:
//   - One launch per stage, 16-byte vector loads (two complex64 values, or
//     one complex128, a thread and item) wherever the row length is even
//     and the buffers are 16-byte aligned, one complex64 value otherwise; a
//     thread covers both polarizations of its samples, so pch and e_hd are
//     read once.
//   - lin walks the samples and loops over the rows inside the thread:
//     lin_op is formed (exp, sincos) or read once for all rows.
//   - The reductions (the phase maximum, the two sums) take per-block
//     partials; the last block to finish (an atomic ticket after a memory
//     fence) combines them in block order, so two runs give the same bits,
//     forms the step size or the convergence number on the device, and
//     resets the ticket for the next launch.  Nothing waits on the host.
//   - No fast math: exp and sincos keep their full range reduction, which
//     the dispersion phase (tens of radians) needs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;     // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // blocks of a reducing launch: its partials
constexpr long long kBlockMaxOffset = 16;  // bytes: two tickets, padded
constexpr long long kPartialsOffset = kBlockMaxOffset + 8LL * kMaxBlocks;
constexpr long long kScratchBytes = kPartialsOffset + 16LL * kMaxBlocks;

// The arithmetic of one precision, each operation rounded to nearest.
template <typename R>
struct Num;

template <>
struct Num<float> {
  using C = float2;
  static __device__ __forceinline__ C make(float x, float y) { return make_float2(x, y); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float hypot(float a, float b) { return hypotf(a, b); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ void sincos(float a, float* s, float* c) { sincosf(a, s, c); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float nan() { return CUDART_NAN_F; }
};

template <>
struct Num<double> {
  using C = double2;
  static __device__ __forceinline__ C make(double x, double y) { return make_double2(x, y); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double rcp(double a) { return __drcp_rn(a); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double hypot(double a, double b) { return ::hypot(a, b); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ void sincos(double a, double* s, double* c) {
    ::sincos(a, s, c);
  }
  static __device__ __forceinline__ double min(double a, double b) { return fmin(a, b); }
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double nan() { return CUDART_NAN; }
};

// V complex values of precision R as one load or store (V = 2, complex64
// alone: 16 bytes).
template <typename R, int V>
struct Cplx {
  static_assert(V == 1 || sizeof(R) == 4, "two values an item in complex64 alone");
  using C = typename Num<R>::C;
  C v[V];
  __device__ __forceinline__ void load(const C* p, long long g) {
    if constexpr (V == 2) {
      const float4 q = reinterpret_cast<const float4*>(p)[g];
      v[0] = make_float2(q.x, q.y);
      v[1] = make_float2(q.z, q.w);
    } else {
      v[0] = p[g];
    }
  }
  __device__ __forceinline__ void store(C* p, long long g) const {
    if constexpr (V == 2)
      reinterpret_cast<float4*>(p)[g] = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
    else
      p[g] = v[0];
  }
};

// V real values of precision R as one load or store.
template <typename R, int V>
struct Real {
  static_assert(V == 1 || sizeof(R) == 4, "two values an item in float32 alone");
  R v[V];
  __device__ __forceinline__ void load(const R* p, long long g) {
    if constexpr (V == 2) {
      const float2 q = reinterpret_cast<const float2*>(p)[g];
      v[0] = q.x;
      v[1] = q.y;
    } else {
      v[0] = p[g];
    }
  }
  __device__ __forceinline__ void store(R* p, long long g) const {
    if constexpr (V == 2)
      reinterpret_cast<float2*>(p)[g] = make_float2(v[0], v[1]);
    else
      p[g] = v[0];
  }
};

// |x|^2 as abs(x) ** 2 forms it.
template <typename R, typename C>
__device__ __forceinline__ R sq_abs(C x) {
  const R a = Num<R>::hypot(x.x, x.y);
  return Num<R>::mul(a, a);
}

// The rotation per km, c (p + ax + ay) / 2 (nlin_phase_rot's rule).
template <typename R>
__device__ __forceinline__ R rot_rate(R p, R ax, R ay, R c) {
  using N = Num<R>;
  return N::mul(N::mul(c, N::add(N::add(p, ax), ay)), R(0.5));
}

template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  C r;
  r.x = a.x * b.x - a.y * b.y;
  r.y = a.x * b.y + a.y * b.x;
  return r;
}

// The larger of a and b, NaN where either is (torch.max's rule).
template <typename R>
__device__ __forceinline__ R nan_max(R a, R b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ long long first_item() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long item_stride() {
  return (long long)gridDim.x * blockDim.x;
}

// Whether this block is the last of the launch to finish; thread 0 has
// written the block's partial.  The ticket counts the blocks that arrived.
__device__ __forceinline__ bool arrive_last(unsigned* ticket) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// The block's maximum (thread 0's result).
template <typename R>
__device__ __forceinline__ R block_max(R x) {
  __shared__ R part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) x = nan_max(x, part[w]);
  __syncthreads();
  return x;
}

// The block's sums of both members, in a fixed order (thread 0's result).
__device__ __forceinline__ double2 block_sum(double2 x) {
  __shared__ double2 part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x.x += __shfl_xor_sync(0xffffffffu, x.x, o);
    x.y += __shfl_xor_sync(0xffffffffu, x.y, o);
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) {
      x.x += part[w].x;
      x.y += part[w].y;
    }
  __syncthreads();
  return x;
}

template <typename R>
struct Step {
  R* phi_max;         // the phase maximum (out of power, into step)
  R* z;               // the distance covered, advanced in place; null: no step
  const R* span_end;  // the span's length
  R max_rot;          // the largest rotation a step may take
  R* hz;              // the step size (out)
  R* status;          // [1]: whether another step follows (out)
};

// The step rule, from the phase maximum mx: the one place it is written
// for the card.
template <typename R>
__device__ __forceinline__ void take_step(R mx, const Step<R>& st) {
  using N = Num<R>;
  const R z = *st.z, end = *st.span_end;
  // max_rot / phi_max as PyTorch forms a number over a tensor: the
  // reciprocal, then the product
  const R cand = N::mul(N::rcp(mx), st.max_rot), room = N::sub(end, z);
  const R hz = (cand != cand || room != room) ? N::nan() : N::min(cand, room);
  const R z_next = N::add(z, hz);
  *st.hz = hz;
  *st.z = z_next;
  st.status[1] = z_next < end ? R(1) : R(0);
}

// Launch 1 of a step: pch, the maximum of the rotation and, with a step,
// its size.
template <typename R, int V>
__global__ void __launch_bounds__(kThreads)
    power_kernel(const typename Num<R>::C* __restrict__ e, long long m, R c,
                 R* __restrict__ pch, Step<R> st, unsigned* ticket, R* block_maxima) {
  const typename Num<R>::C* ey = e + m;
  R mx = -Num<R>::inf();
  for (long long g = first_item(); g < m / V; g += item_stride()) {
    Cplx<R, V> x, y;
    x.load(e, g);
    y.load(ey, g);
    Real<R, V> p;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const R ax = sq_abs<R>(x.v[k]), ay = sq_abs<R>(y.v[k]);
      p.v[k] = Num<R>::add(ax, ay);
      mx = nan_max(mx, rot_rate(p.v[k], ax, ay, c));
    }
    p.store(pch, g);
  }
  mx = block_max(mx);
  if (threadIdx.x == 0) block_maxima[blockIdx.x] = mx;
  if (!arrive_last(ticket)) return;
  mx = -Num<R>::inf();
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads)
    mx = nan_max(mx, __ldcg(block_maxima + b));
  mx = block_max(mx);
  if (threadIdx.x != 0) return;
  *ticket = 0u;
  *st.phi_max = mx;
  if (st.z != nullptr) take_step(mx, st);
}

// The step rule alone, from the phase maximum at st.phi_max.
template <typename R>
__global__ void step_kernel(Step<R> st) {
  take_step(*st.phi_max, st);
}

// The spectrum's rows times lin_op (formed from lin_arg and hz, or read)
// times inv_n.
template <typename R, int V>
__global__ void __launch_bounds__(kThreads)
    lin_kernel(typename Num<R>::C* spec, long long n, int rows,
               const typename Num<R>::C* __restrict__ lin_arg, const R* __restrict__ hz,
               typename Num<R>::C* lin_op, R inv_n) {
  using N = Num<R>;
  const R h = lin_arg != nullptr ? N::mul(*hz, R(0.5)) : R(0);
  for (long long g = first_item(); g < n / V; g += item_stride()) {
    Cplx<R, V> l;
    if (lin_arg != nullptr) {
      l.load(lin_arg, g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const R mag = N::exp(N::mul(l.v[k].x, h));
        R s, co;
        N::sincos(N::mul(l.v[k].y, h), &s, &co);
        l.v[k] = N::make(N::mul(mag, co), N::mul(mag, s));
      }
      l.store(lin_op, g);
    } else {
      l.load(lin_op, g);
    }
    for (int r = 0; r < rows; ++r) {
      typename N::C* row = spec + (long long)r * n;
      Cplx<R, V> s;
      s.load(row, g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const typename N::C p = cmul(s.v[k], l.v[k]);
        s.v[k] = N::make(N::mul(p.x, inv_n), N::mul(p.y, inv_n));
      }
      s.store(row, g);
    }
  }
}

// A trapezoidal pass's rotation: e_hd * exp(j sign phi hz).
template <typename R, int V>
__global__ void __launch_bounds__(kThreads)
    rotate_kernel(const typename Num<R>::C* __restrict__ e,
                  const typename Num<R>::C* __restrict__ e_hd, const R* __restrict__ pch,
                  long long m, R c, R sign, const R* __restrict__ hz_ptr, R hz_val,
                  typename Num<R>::C* __restrict__ out) {
  using N = Num<R>;
  const R hz = hz_ptr != nullptr ? *hz_ptr : hz_val;
  for (long long g = first_item(); g < m / V; g += item_stride()) {
    Cplx<R, V> x, y, hx, hy;
    Real<R, V> p;
    x.load(e, g);
    y.load(e + m, g);
    hx.load(e_hd, g);
    hy.load(e_hd + m, g);
    p.load(pch, g);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const R phi = rot_rate(p.v[k], sq_abs<R>(x.v[k]), sq_abs<R>(y.v[k]), c);
      R s, co;
      N::sincos(sign * N::mul(phi, hz), &s, &co);
      const typename N::C w = N::make(co, s);
      hx.v[k] = cmul(hx.v[k], w);
      hy.v[k] = cmul(hy.v[k], w);
    }
    hx.store(out, g);
    hy.store(out + m, g);
  }
}

// A pass's convergence sums; e_fd over e_conv where `write`.
template <typename R, int V>
__global__ void __launch_bounds__(kThreads)
    converge_kernel(const typename Num<R>::C* __restrict__ fd, typename Num<R>::C* conv,
                    long long total, int write, unsigned* ticket, double2* partials, R* sums,
                    R* status) {
  using N = Num<R>;
  double2 acc = make_double2(0.0, 0.0);
  for (long long g = first_item(); g < total / V; g += item_stride()) {
    Cplx<R, V> a, b;
    a.load(fd, g);
    b.load(conv, g);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const typename N::C d = N::make(N::sub(a.v[k].x, b.v[k].x), N::sub(a.v[k].y, b.v[k].y));
      acc.x += (double)sq_abs<R>(d);
      acc.y += (double)sq_abs<R>(b.v[k]);
    }
    if (write) a.store(conv, g);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  if (!arrive_last(ticket)) return;
  acc = make_double2(0.0, 0.0);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    const double2 q = __ldcg(partials + b);
    acc.x += q.x;
    acc.y += q.y;
  }
  acc = block_sum(acc);
  if (threadIdx.x != 0) return;
  *ticket = 0u;
  const R num = (R)acc.x, den = (R)acc.y;
  if (sums != nullptr) {
    sums[0] = num;
    sums[1] = den;
  }
  if (status != nullptr) status[0] = N::div(N::sqrt(num), N::sqrt(den));
}

int blocks(long long items, int cap) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

// Two complex64 values an item where the length is even and the buffers
// are 16-byte aligned.
bool pairs(long long len, const void* a, const void* b = nullptr, const void* c = nullptr,
           const void* d = nullptr, const void* e = nullptr) {
  const void* ps[] = {a, b, c, d, e};
  if (len % 2) return false;
  for (const void* p : ps)
    if (((unsigned long long)p) % 16) return false;
  return true;
}

template <typename R>
Step<R> make_step(void* phi_max, void* z, const void* span_end, double max_rot, void* hz,
                  void* status) {
  return Step<R>{(R*)phi_max, (R*)z, (const R*)span_end, (R)max_rot, (R*)hz, (R*)status};
}

template <typename R>
int power_launch(const void* e, long long m, double c, void* pch, void* scratch,
                 const Step<R>& st, cudaStream_t s) {
  using C = typename Num<R>::C;
  unsigned* ticket = (unsigned*)scratch;
  R* maxima = (R*)((char*)scratch + kBlockMaxOffset);
  const C* ep = (const C*)e;
  if constexpr (sizeof(R) == 4) {
    if (pairs(m, e, ep + m, pch)) {
      power_kernel<R, 2><<<blocks(m / 2, kMaxBlocks), kThreads, 0, s>>>(ep, m, (R)c, (R*)pch,
                                                                        st, ticket, maxima);
      return (int)cudaGetLastError();
    }
  }
  power_kernel<R, 1><<<blocks(m, kMaxBlocks), kThreads, 0, s>>>(ep, m, (R)c, (R*)pch, st,
                                                                ticket, maxima);
  return (int)cudaGetLastError();
}

template <typename R>
int lin_launch(void* spec, long long n, int rows, const void* lin_arg, const void* hz,
               void* lin_op, double inv_n, cudaStream_t s) {
  using C = typename Num<R>::C;
  C* sp = (C*)spec;
  const C* la = (const C*)lin_arg;
  if constexpr (sizeof(R) == 4) {
    if (pairs(n, spec, lin_op, lin_arg)) {
      lin_kernel<R, 2><<<blocks(n / 2, 1 << 30), kThreads, 0, s>>>(sp, n, rows, la, (const R*)hz,
                                                                   (C*)lin_op, (R)inv_n);
      return (int)cudaGetLastError();
    }
  }
  lin_kernel<R, 1><<<blocks(n, 1 << 30), kThreads, 0, s>>>(sp, n, rows, la, (const R*)hz,
                                                           (C*)lin_op, (R)inv_n);
  return (int)cudaGetLastError();
}

template <typename R>
int rotate_launch(const void* e, const void* e_hd, const void* pch, long long m, double c,
                  double sign, const void* hz_ptr, double hz_val, void* out, cudaStream_t s) {
  using C = typename Num<R>::C;
  const C *ep = (const C*)e, *hp = (const C*)e_hd;
  C* op = (C*)out;
  if constexpr (sizeof(R) == 4) {
    if (pairs(m, e, ep + m, e_hd, hp + m, pch) && pairs(m, out, op + m)) {
      rotate_kernel<R, 2><<<blocks(m / 2, 1 << 30), kThreads, 0, s>>>(
          ep, hp, (const R*)pch, m, (R)c, (R)sign, (const R*)hz_ptr, (R)hz_val, op);
      return (int)cudaGetLastError();
    }
  }
  rotate_kernel<R, 1><<<blocks(m, 1 << 30), kThreads, 0, s>>>(
      ep, hp, (const R*)pch, m, (R)c, (R)sign, (const R*)hz_ptr, (R)hz_val, op);
  return (int)cudaGetLastError();
}

template <typename R>
int converge_launch(const void* fd, void* conv, long long total, int write, void* scratch,
                    void* sums, void* status, cudaStream_t s) {
  using C = typename Num<R>::C;
  unsigned* ticket = (unsigned*)scratch + 1;
  double2* partials = (double2*)((char*)scratch + kPartialsOffset);
  const C* a = (const C*)fd;
  C* b = (C*)conv;
  if constexpr (sizeof(R) == 4) {
    if (pairs(total, fd, conv)) {
      converge_kernel<R, 2><<<blocks(total / 2, kMaxBlocks), kThreads, 0, s>>>(
          a, b, total, write, ticket, partials, (R*)sums, (R*)status);
      return (int)cudaGetLastError();
    }
  }
  converge_kernel<R, 1><<<blocks(total, kMaxBlocks), kThreads, 0, s>>>(
      a, b, total, write, ticket, partials, (R*)sums, (R*)status);
  return (int)cudaGetLastError();
}

}  // namespace

// Every launch takes f64: 0 for complex64 fields with float32 reals, 1 for
// complex128 with float64; the scalars come as doubles and are rounded to
// the field's precision.

// Bytes of the scratch the reducing launches share on a device: their
// tickets (zero before the first launch; each launch leaves them zero) and
// their partials.  Launches that share a scratch must not run at once.
extern "C" int ssfm_scratch_bytes() { return (int)kScratchBytes; }

// e: (2, m) complex (the polarizations, m = B * N); pch: (m,) real;
// phi_max, hz, z, span_end: real scalars; status: 2 reals.  z null: the
// maximum alone (hz, span_end, status unused).
extern "C" int ssfm_power_launch(int f64, const void* e, long long m, double c, void* pch,
                                 void* scratch, void* phi_max, void* z, const void* span_end,
                                 double max_rot, void* hz, void* status, void* stream) {
  if (m < 1 || scratch == nullptr || phi_max == nullptr ||
      (z != nullptr && (span_end == nullptr || hz == nullptr || status == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return power_launch(e, m, c, pch, scratch,
                        make_step<double>(phi_max, z, span_end, max_rot, hz, status), s);
  return power_launch(e, m, c, pch, scratch,
                      make_step<float>(phi_max, z, span_end, max_rot, hz, status), s);
}

// The step rule from the phase maximum at phi_max (one thread): for a
// maximum the caller has reduced across processes.
extern "C" int ssfm_step_launch(int f64, const void* phi_max, void* z, const void* span_end,
                                double max_rot, void* hz, void* status, void* stream) {
  if (phi_max == nullptr || z == nullptr || span_end == nullptr || hz == nullptr ||
      status == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  void* pm = const_cast<void*>(phi_max);
  if (f64)
    step_kernel<double><<<1, 1, 0, s>>>(make_step<double>(pm, z, span_end, max_rot, hz, status));
  else
    step_kernel<float><<<1, 1, 0, s>>>(make_step<float>(pm, z, span_end, max_rot, hz, status));
  return (int)cudaGetLastError();
}

// spec: (rows, n) complex, in place; lin_op: (n,) complex, written from
// lin_arg (n,) and the real scalar hz where lin_arg is given, read
// otherwise.
extern "C" int ssfm_lin_launch(int f64, void* spec, long long n, int rows, const void* lin_arg,
                               const void* hz, void* lin_op, double inv_n, void* stream) {
  if (n < 1 || rows < 1 || lin_op == nullptr || (lin_arg != nullptr && hz == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64) return lin_launch<double>(spec, n, rows, lin_arg, hz, lin_op, inv_n, s);
  return lin_launch<float>(spec, n, rows, lin_arg, hz, lin_op, inv_n, s);
}

// e, e_hd, out: (2, m) complex; pch: (m,) real; the step size is the real
// scalar at hz_ptr, or hz_val where hz_ptr is null.
extern "C" int ssfm_rotate_launch(int f64, const void* e, const void* e_hd, const void* pch,
                                  long long m, double c, double sign, const void* hz_ptr,
                                  double hz_val, void* out, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64) return rotate_launch<double>(e, e_hd, pch, m, c, sign, hz_ptr, hz_val, out, s);
  return rotate_launch<float>(e, e_hd, pch, m, c, sign, hz_ptr, hz_val, out, s);
}

// fd, conv: (total,) complex; sums: 2 reals (num, den) or null; status: 2
// reals whose [0] takes the convergence number, or null.
extern "C" int ssfm_converge_launch(int f64, const void* fd, void* conv, long long total,
                                    int write, void* scratch, void* sums, void* status,
                                    void* stream) {
  if (total < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64) return converge_launch<double>(fd, conv, total, write, scratch, sums, status, s);
  return converge_launch<float>(fd, conv, total, write, scratch, sums, status, s);
}
