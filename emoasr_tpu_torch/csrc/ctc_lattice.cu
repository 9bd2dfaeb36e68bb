// CTC alpha/beta lattice over blank-interleaved path emissions, for Hopper
// (sm_90a).
//
// Replaces: emoasr_tpu/ops/ctc_pallas.py::ctc_ll_from_path, kernels
// `_alpha_kernel` (forward) and `_beta_grad_kernel` (backward).
//
// Semantics: lp (T, B, S) f32 per-state emissions (any time and batch
// strides, states contiguous: a transposed view of a (B, T, S) tensor is
// read in place), allow2/init/final (B, S) {0,1} masks, xlens (B,).
// alpha[0] = init ? lp[0] : LOG_0; for t < xlen
// alpha[t][s] = lse3(alpha[t-1][s], alpha[t-1][s-1], allow2[s] ?
// alpha[t-1][s-2] : LOG_0) + lp[t][s]; past xlen the row is frozen, so the
// last alpha is the one at xlen - 1.  ll = logsumexp_s(final ? alpha_last :
// LOG_0).  The backward runs beta in reverse (beta excludes the emission at
// t) and emits grad[t][s] = g * exp(alpha + beta - ll) for t < xlen, 0 past
// xlen and for rows whose ll is below LOG_0 / 2 (no feasible alignment).
// LOG_0 = -1e10 is finite on purpose: three dead states give about
// LOG_0 + log 3, never -inf or NaN.
//
// What bounds it on this card: bytes are trivial (lp read once, alpha
// written once: a few MB); the limit is the chain of xlen - 1 dependent
// steps, and within a step the latency of one state's update and of the
// exchange of two boundary values between neighbouring threads.
//
// Design: one block per utterance, the states in registers: a thread holds
// SPL consecutive states, the chain's warps `warps` x 32 x SPL >= S (the
// geometry, one state a thread up to S = 576, is chosen in
// ops/ctc_lattice.py::launch_geometry).  A step needs s - 1 and s - 2
// (alpha) or s + 1 and s + 2 (beta) of the neighbouring thread: two shuffles
// in a warp; across warps the boundary threads publish theirs in shared
// memory (double-buffered) before one named barrier over the chain's warps,
// the step's only synchronisation.  The emissions (and in beta alpha[t])
// are loaded `depth` steps ahead into registers, off the chain; allow2 and
// final are bit masks loaded once; alpha and grad stores are
// fire-and-forget.  lse3 takes the largest term as exp(0) = 1 without
// computing it, the other two exponentials and the logarithm by the
// special function unit.  The backward's zero rows past xlen are written by
// two extra warps beside the chain, which never wait for them.
//
// Precision: alpha and beta grow by some -10 a step, so float32 carries
// would round at an ulp of some 1e-3 by T' = 6000 and the rounding would
// build up in the gradient's exponent alpha + beta - ll.  So both are carried
// (and alpha stored) in float64; the exponentials and the logarithm take
// float32 differences of at most a few units, where float32 is exact
// enough, and the exponent is formed in float64 before its exp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kLog0 = -1e10;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxSpl = 8;
constexpr int kMaxWarps = 32;
constexpr int kFillWarps = 2;  // the backward's warps beside the chain

// steps loaded ahead, and the threads a block may have, by states a thread
__host__ __device__ constexpr int depth(int spl) { return spl == 1 ? 8 : spl == 2 ? 4 : spl <= 4 ? 2 : 1; }
__host__ __device__ constexpr int max_threads(int spl) { return spl <= 2 ? 640 : 832; }

// exp and log(1 + x), x >= 0, by the special function unit (ex2 / lg2.approx,
// denormals flushed) on float32 differences; chip_smoke.py's lattice checks
// hold the results to LATTICE_TOL
__device__ __forceinline__ float exp_of(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float log1p_of(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(1.f + x));
  return y * 0.6931471805599453f;
}

// log(e^a + e^b + e^c) = m + log(1 + e^(lo - m) + e^(mid - m)), m the largest
// of the three as float32 orders them (which of two that round alike is
// taken does not matter: the sum is exact for any m); the differences,
// below 0 up to a rounding, in float32
__device__ __forceinline__ double lse3(double a, double b, double c) {
  const float fa = static_cast<float>(a), fb = static_cast<float>(b), fc = static_cast<float>(c);
  const bool ab = fa >= fb;
  const double hi = ab ? a : b, lo = ab ? b : a;
  const bool hc = (ab ? fa : fb) >= fc;
  const double m = hc ? hi : c, mid = hc ? c : hi;
  return m + static_cast<double>(log1p_of(exp_of(static_cast<float>(lo - m)) +
                                          exp_of(static_cast<float>(mid - m))));
}

// the chain's warps meet; barrier 0 (__syncthreads) stays free
__device__ __forceinline__ void chain_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ double block_reduce(double v, bool take_max, double* red) {
  // red: 32 doubles of shared memory
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_xor_sync(kFull, v, off);
    v = take_max ? fmax(v, o) : v + o;
  }
  __syncthreads();  // red may still be read from an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  double r = take_max ? -INFINITY : 0.0;
  for (int w = 0; w < n_warps; ++w) r = take_max ? fmax(r, red[w]) : r + red[w];
  return r;
}

// a thread's SPL values of one row (predicated: 0 past S)
template <typename V, int SPL>
__device__ __forceinline__ void load_states(V (&dst)[SPL], const V* __restrict__ src, uint32_t live) {
#pragma unroll
  for (int i = 0; i < SPL; ++i) dst[i] = (live >> i) & 1u ? __ldg(src + i) : V(0);
}

template <int SPL>
__global__ void __launch_bounds__(max_threads(SPL))
ctc_alpha_kernel(const float* __restrict__ lp, const float* __restrict__ allow2,
                 const float* __restrict__ init, const float* __restrict__ final_,
                 const int* __restrict__ xlens, double* __restrict__ alpha, float* __restrict__ ll,
                 double* __restrict__ ll64, int T, int B, int S, long long lp_st, long long lp_sb) {
  constexpr int D = depth(SPL);
  __shared__ double xch[2][kMaxWarps][2];  // a warp's last two states, by step parity
  __shared__ double red[32];
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wprev = warp > 0 ? warp - 1 : 0;
  const int b = blockIdx.x;
  const int xlen = min(max(xlens[b], 1), T);  // alpha[0] always exists
  const size_t row = static_cast<size_t>(b) * S;
  const size_t step = static_cast<size_t>(B) * S;
  const int s0 = threadIdx.x * SPL;

  double a[SPL];
  uint32_t live = 0, skip = 0, fin = 0;  // bit i: state s0 + i exists / allow2 / final
  const float* lp_s = lp + b * lp_sb + s0;
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int s = s0 + i;
    a[i] = kLog0;
    if (s < S) {
      live |= 1u << i;
      a[i] = init[row + s] > 0.5f ? static_cast<double>(lp_s[i]) : kLog0;
      skip |= static_cast<uint32_t>(s >= 2 && allow2[row + s] > 0.5f) << i;
      fin |= static_cast<uint32_t>(final_[row + s] > 0.5f) << i;
    }
  }
  double* out = alpha + row + s0;
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      if ((live >> i) & 1u) out[i] = a[i];
  };
  store();
  float pf[D][SPL];  // the emissions of the next D steps
  const float* next = lp_s + lp_st;  // the row the next load takes
#pragma unroll
  for (int d = 0; d < D; ++d, next += lp_st)
    if (1 + d < xlen) load_states(pf[d], next, live);

  auto publish = [&](int slot) {  // this warp's last two states, for the next warp
    if (lane == 31) xch[slot][warp][0] = a[SPL - 1];
    if (SPL >= 2) {
      if (lane == 31) xch[slot][warp][1] = a[SPL >= 2 ? SPL - 2 : 0];
    } else if (lane == 30) {
      xch[slot][warp][1] = a[0];
    }
  };
  publish(0);
  if (nwarps > 1) chain_barrier(nthreads);
  for (int t0 = 1; t0 < xlen; t0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int t = t0 + d;
      if (t >= xlen) break;
      const int slot = (t - 1) & 1;
      // states s0 - 1 and s0 - 2: from the thread before, or the warp before
      const double w1 = xch[slot][wprev][0], w2 = xch[slot][wprev][1];
      const double u1 = __shfl_up_sync(kFull, a[SPL - 1], 1);
      const double u2 = SPL >= 2 ? __shfl_up_sync(kFull, a[SPL >= 2 ? SPL - 2 : 0], 1)
                                 : __shfl_up_sync(kFull, a[0], 2);
      const double p1 = lane > 0 ? u1 : (warp > 0 ? w1 : kLog0);
      const double p2 = lane > (SPL >= 2 ? 0 : 1) ? u2 : (warp > 0 ? (lane == 0 ? w2 : w1) : kLog0);
      double na[SPL];
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const double x1 = i >= 1 ? a[i >= 1 ? i - 1 : 0] : p1;
        const double x2 = (skip >> i) & 1u ? (i >= 2 ? a[i >= 2 ? i - 2 : 0] : (i == 1 ? p1 : p2)) : kLog0;
        na[i] = lse3(a[i], x1, x2) + static_cast<double>(pf[d][i]);
      }
#pragma unroll
      for (int i = 0; i < SPL; ++i) a[i] = na[i];
      out += step;
      store();
      publish(t & 1);
      if (t + D < xlen) load_states(pf[d], next, live);
      next += lp_st;
      if (nwarps > 1) chain_barrier(nthreads);
    }
  }
  // ll = logsumexp over s of (final ? alpha_last : LOG_0)
  double m = -INFINITY;
#pragma unroll
  for (int i = 0; i < SPL; ++i)
    if ((live >> i) & 1u) m = fmax(m, (fin >> i) & 1u ? a[i] : kLog0);
  m = block_reduce(m, true, red);
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < SPL; ++i)
    if ((live >> i) & 1u) sum += exp(((fin >> i) & 1u ? a[i] : kLog0) - m);
  sum = block_reduce(sum, false, red);
  if (threadIdx.x == 0) {
    const double l = m + log(sum);
    ll64[b] = l;
    ll[b] = static_cast<float>(l);
  }
}

template <int SPL>
__global__ void __launch_bounds__(max_threads(SPL))
ctc_beta_grad_kernel(const float* __restrict__ lp, const float* __restrict__ allow2,
                     const float* __restrict__ final_, const int* __restrict__ xlens,
                     const double* __restrict__ alpha, const double* __restrict__ ll64,
                     const float* __restrict__ g, float* __restrict__ grad,
                     int T, int B, int S, long long lp_st, long long lp_sb, int chain_warps) {
  constexpr int D = depth(SPL);
  __shared__ double xch[2][kMaxWarps][2];  // a warp's first two d = beta + lp, by step parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int xlen = min(max(xlens[b], 0), T);
  const size_t row = static_cast<size_t>(b) * S;
  const size_t step = static_cast<size_t>(B) * S;
  float* grad_b = grad + b * lp_sb;  // grad has lp's layout
  const double ll_b = ll64[b];
  // rows without a feasible alignment get no gradient: exp(alpha + beta -
  // LOG_0) would overflow
  const float g_b = ll_b < 0.5 * kLog0 ? 0.f : g[b];
  const int t_live = g_b == 0.f ? 0 : xlen;  // rows [t_live, T) are zero
  const int chain_threads = chain_warps * 32;

  // the zero rows: the fill warps, or every thread where nothing is live
  const int fill_from = t_live == 0 ? 0 : chain_threads;
  if (static_cast<int>(threadIdx.x) >= fill_from) {
    const int nf = blockDim.x - fill_from, f = threadIdx.x - fill_from;
    for (int t = t_live; t < T; ++t)
      for (int s = f; s < S; s += nf) grad_b[t * lp_st + s] = 0.f;
    return;
  }

  const int wnext = warp + 1 < chain_warps ? warp + 1 : warp;
  const bool last_warp = warp + 1 >= chain_warps;
  const int s0 = threadIdx.x * SPL;
  double be[SPL];
  uint32_t live = 0, skip = 0;  // bit i: state s0 + i exists / the skip s0 + i -> s0 + i + 2
  // pointers at row xlen - 1: grad, alpha, and lp of the step after
  float* out = grad_b + (xlen - 1) * lp_st + s0;
  const double* al = alpha + (xlen - 1) * step + row + s0;
  {
    double a0[SPL];
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int s = s0 + i;
      be[i] = kLog0;
      if (s < S) {
        live |= 1u << i;
        be[i] = final_[row + s] > 0.5f ? 0.0 : kLog0;  // beta at xlen - 1
        skip |= static_cast<uint32_t>(s + 2 < S && allow2[row + s + 2] > 0.5f) << i;
      }
    }
    load_states(a0, al, live);
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      if ((live >> i) & 1u) out[i] = g_b * exp_of(static_cast<float>(a0[i] + be[i] - ll_b));
  }
  float pl[D][SPL];   // lp[t + 1] of the next D steps
  double pa[D][SPL];  // alpha[t] of the next D steps
  const float* next_lp = lp + b * lp_sb + (xlen - 1) * lp_st + s0;
  const double* next_al = al - step;
#pragma unroll
  for (int d = 0; d < D; ++d, next_lp -= lp_st, next_al -= step) {
    if (xlen - 2 - d >= 0) {
      load_states(pl[d], next_lp, live);
      load_states(pa[d], next_al, live);
    }
  }
  for (int t0 = xlen - 2; t0 >= 0; t0 -= D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int t = t0 - d;
      if (t < 0) break;
      const int slot = t & 1;
      double dd[SPL];  // beta[t + 1] + lp[t + 1]; LOG_0 past S
#pragma unroll
      for (int i = 0; i < SPL; ++i) dd[i] = (live >> i) & 1u ? be[i] + static_cast<double>(pl[d][i]) : kLog0;
      if (lane == 0) xch[slot][warp][0] = dd[0];
      if (SPL >= 2) {
        if (lane == 0) xch[slot][warp][1] = dd[SPL >= 2 ? 1 : 0];
      } else if (lane == 1) {
        xch[slot][warp][1] = dd[0];
      }
      if (chain_warps > 1) chain_barrier(chain_threads);
      // states s0 + SPL and s0 + SPL + 1: from the thread after, or the warp after
      const double w1 = xch[slot][wnext][0], w2 = xch[slot][wnext][1];
      const double u1 = __shfl_down_sync(kFull, dd[0], 1);
      const double u2 = SPL >= 2 ? __shfl_down_sync(kFull, dd[SPL >= 2 ? 1 : 0], 1)
                                 : __shfl_down_sync(kFull, dd[0], 2);
      const double n1 = lane < 31 ? u1 : (last_warp ? kLog0 : w1);
      const double n2 = lane < (SPL >= 2 ? 31 : 30) ? u2 : (last_warp ? kLog0 : (lane == 31 ? w2 : w1));
      out -= lp_st;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const double y1 = i + 1 < SPL ? dd[i + 1 < SPL ? i + 1 : 0] : n1;
        const double y2 = (skip >> i) & 1u
            ? (i + 2 < SPL ? dd[i + 2 < SPL ? i + 2 : 0] : (i + 2 == SPL ? n1 : n2)) : kLog0;
        be[i] = lse3(dd[i], y1, y2);
        if ((live >> i) & 1u) out[i] = g_b * exp_of(static_cast<float>(pa[d][i] + be[i] - ll_b));
      }
      if (t - D >= 0) {
        load_states(pl[d], next_lp, live);
        load_states(pa[d], next_al, live);
      }
      next_lp -= lp_st;
      next_al -= step;
    }
  }
}

template <int SPL>
int alpha_spl(const void* lp, const void* allow2, const void* init, const void* final_, const void* xlens,
              void* alpha, void* ll, void* ll64, int T, int B, int S, long long lp_st, long long lp_sb,
              int warps, cudaStream_t stream) {
  if (warps * 32 > max_threads(SPL)) return static_cast<int>(cudaErrorInvalidValue);
  ctc_alpha_kernel<SPL><<<B, warps * 32, 0, stream>>>(
      static_cast<const float*>(lp), static_cast<const float*>(allow2), static_cast<const float*>(init),
      static_cast<const float*>(final_), static_cast<const int*>(xlens), static_cast<double*>(alpha),
      static_cast<float*>(ll), static_cast<double*>(ll64), T, B, S, lp_st, lp_sb);
  return static_cast<int>(cudaGetLastError());
}

template <int SPL>
int beta_spl(const void* lp, const void* allow2, const void* final_, const void* xlens, const void* alpha,
             const void* ll64, const void* g, void* grad, int T, int B, int S, long long lp_st, long long lp_sb,
             int warps, cudaStream_t stream) {
  if ((warps + kFillWarps) * 32 > max_threads(SPL)) return static_cast<int>(cudaErrorInvalidValue);
  ctc_beta_grad_kernel<SPL><<<B, (warps + kFillWarps) * 32, 0, stream>>>(
      static_cast<const float*>(lp), static_cast<const float*>(allow2), static_cast<const float*>(final_),
      static_cast<const int*>(xlens), static_cast<const double*>(alpha), static_cast<const double*>(ll64),
      static_cast<const float*>(g), static_cast<float*>(grad), T, B, S, lp_st, lp_sb, warps);
  return static_cast<int>(cudaGetLastError());
}

bool geometry_ok(int T, int B, int S, int spl, int warps) {
  return T >= 1 && B >= 1 && S >= 1 && spl >= 1 && spl <= kMaxSpl && warps >= 1 &&
         warps + kFillWarps <= kMaxWarps && static_cast<long long>(warps) * 32 * spl >= S;
}

}  // namespace

extern "C" {

// alpha (T, B, S) float64, ll (B,) float32 and float64; `spl` states a
// thread, `warps` warps carrying the chain (ops/ctc_lattice.py::launch_geometry)
int emo_ctc_alpha_f32(const void* lp, const void* allow2, const void* init, const void* final_,
                      const void* xlens, void* alpha, void* ll, void* ll64, int T, int B, int S,
                      long long lp_st, long long lp_sb, int spl, int warps, void* stream) {
  if (!geometry_ok(T, B, S, spl, warps)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EMO_ALPHA(N) \
  case N: return alpha_spl<N>(lp, allow2, init, final_, xlens, alpha, ll, ll64, T, B, S, lp_st, lp_sb, warps, st);
  switch (spl) {
    EMO_ALPHA(1) EMO_ALPHA(2) EMO_ALPHA(3) EMO_ALPHA(4) EMO_ALPHA(5) EMO_ALPHA(6) EMO_ALPHA(7) EMO_ALPHA(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef EMO_ALPHA
}

int emo_ctc_beta_grad_f32(const void* lp, const void* allow2, const void* final_,
                          const void* xlens, const void* alpha, const void* ll64, const void* g,
                          void* grad, int T, int B, int S, long long lp_st, long long lp_sb,
                          int spl, int warps, void* stream) {
  if (!geometry_ok(T, B, S, spl, warps)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EMO_BETA(N) \
  case N: return beta_spl<N>(lp, allow2, final_, xlens, alpha, ll64, g, grad, T, B, S, lp_st, lp_sb, warps, st);
  switch (spl) {
    EMO_BETA(1) EMO_BETA(2) EMO_BETA(3) EMO_BETA(4) EMO_BETA(5) EMO_BETA(6) EMO_BETA(7) EMO_BETA(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef EMO_BETA
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
