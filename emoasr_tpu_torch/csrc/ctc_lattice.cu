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
// written once: a few MB); the limit is the chain of T - 1 dependent steps,
// each a block-wide barrier plus three expf and one logf per state.
//
// Design: one block per utterance, one thread per lattice state (strided
// when S exceeds the block), the alpha (beta) row double-buffered in shared
// memory so a step costs one barrier; the loop over T runs inside the
// kernel and only as far as xlen.  alpha rows at t >= xlen are not written
// (the backward never reads them); grad rows there are zero-filled.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog0 = -1e10f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ float block_reduce(float v, bool take_max, float* red) {
  // red: 32 floats of shared memory
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    v = take_max ? fmaxf(v, o) : v + o;
  }
  __syncthreads();  // red may still be read from an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  float r = take_max ? -INFINITY : 0.f;
  for (int w = 0; w < n_warps; ++w) r = take_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp, const float* __restrict__ allow2,
                                 const float* __restrict__ init, const float* __restrict__ final_,
                                 const int* __restrict__ xlens, float* __restrict__ alpha,
                                 float* __restrict__ ll, int T, int B, int S, long long lp_st,
                                 long long lp_sb) {
  extern __shared__ float smem[];
  float* buf0 = smem;
  float* buf1 = smem + S;
  float* red = smem + 2 * S;
  const int b = blockIdx.x;
  const int xlen = min(max(xlens[b], 1), T);  // alpha[0] always exists
  const size_t row = static_cast<size_t>(b) * S;
  const size_t step = static_cast<size_t>(B) * S;
  const float* lp_b = lp + b * lp_sb;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float a = init[row + s] > 0.5f ? lp_b[s] : kLog0;
    buf0[s] = a;
    alpha[row + s] = a;
  }
  __syncthreads();
  float* cur = buf0;
  float* nxt = buf1;
  for (int t = 1; t < xlen; ++t) {
    const size_t off = t * step + row;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float a0 = cur[s];
      const float a1 = s >= 1 ? cur[s - 1] : kLog0;
      const float a2 = (s >= 2 && allow2[row + s] > 0.5f) ? cur[s - 2] : kLog0;
      const float a = lse3(a0, a1, a2) + lp_b[t * lp_st + s];
      nxt[s] = a;
      alpha[off + s] = a;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // ll = logsumexp over s of (final ? alpha_last : LOG_0)
  float m = -INFINITY;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    m = fmaxf(m, final_[row + s] > 0.5f ? cur[s] : kLog0);
  m = block_reduce(m, true, red);
  float sum = 0.f;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    sum += expf((final_[row + s] > 0.5f ? cur[s] : kLog0) - m);
  sum = block_reduce(sum, false, red);
  if (threadIdx.x == 0) ll[b] = m + logf(sum);
}

__global__ void ctc_beta_grad_kernel(const float* __restrict__ lp, const float* __restrict__ allow2,
                                     const float* __restrict__ final_, const int* __restrict__ xlens,
                                     const float* __restrict__ alpha, const float* __restrict__ ll,
                                     const float* __restrict__ g, float* __restrict__ grad,
                                     int T, int B, int S, long long lp_st, long long lp_sb) {
  extern __shared__ float smem[];
  float* beta = smem;   // beta at t + 1, then at t
  float* dsh = smem + S;  // beta[t + 1] + lp[t + 1]
  const int b = blockIdx.x;
  const int xlen = min(max(xlens[b], 0), T);
  const size_t row = static_cast<size_t>(b) * S;
  const size_t step = static_cast<size_t>(B) * S;
  const float* lp_b = lp + b * lp_sb;
  float* grad_b = grad + b * lp_sb;  // grad has lp's layout
  const float ll_b = ll[b];
  // rows without a feasible alignment get no gradient: exp(alpha + beta -
  // LOG_0) would overflow
  const float g_b = ll_b < 0.5f * kLog0 ? 0.f : g[b];
  const int t_live = g_b == 0.f ? 0 : xlen;  // rows [t_live, T) are zero

  for (int t = t_live; t < T; ++t)
    for (int s = threadIdx.x; s < S; s += blockDim.x) grad_b[t * lp_st + s] = 0.f;
  if (t_live == 0) return;

  // t = xlen - 1: beta = final ? 0 : LOG_0
  {
    const size_t off = (xlen - 1) * step + row;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float be = final_[row + s] > 0.5f ? 0.f : kLog0;
      beta[s] = be;
      grad_b[(xlen - 1) * lp_st + s] = g_b * expf(alpha[off + s] + be - ll_b);
    }
  }
  __syncthreads();
  for (int t = xlen - 2; t >= 0; --t) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) dsh[s] = beta[s] + lp_b[(t + 1) * lp_st + s];
    __syncthreads();
    const size_t off = t * step + row;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float d0 = dsh[s];
      const float d1 = s + 1 < S ? dsh[s + 1] : kLog0;
      // the skip s -> s + 2 is gated by allow2 at its target
      const float d2 = (s + 2 < S && allow2[row + s + 2] > 0.5f) ? dsh[s + 2] : kLog0;
      const float be = lse3(d0, d1, d2);
      beta[s] = be;
      grad_b[t * lp_st + s] = g_b * expf(alpha[off + s] + be - ll_b);
    }
    __syncthreads();
  }
}

int block_threads(int S) {
  const int n = ((S + 31) / 32) * 32;
  return n < kMaxThreads ? n : kMaxThreads;
}

}  // namespace

extern "C" {

int emo_ctc_alpha_f32(const void* lp, const void* allow2, const void* init, const void* final_,
                      const void* xlens, void* alpha, void* ll, int T, int B, int S,
                      long long lp_st, long long lp_sb, void* stream) {
  if (T < 1 || B < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * static_cast<size_t>(S) + 32) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  ctc_alpha_kernel<<<B, block_threads(S), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(allow2),
      static_cast<const float*>(init), static_cast<const float*>(final_),
      static_cast<const int*>(xlens), static_cast<float*>(alpha), static_cast<float*>(ll),
      T, B, S, lp_st, lp_sb);
  return static_cast<int>(cudaGetLastError());
}

int emo_ctc_beta_grad_f32(const void* lp, const void* allow2, const void* final_,
                          const void* xlens, const void* alpha, const void* ll, const void* g,
                          void* grad, int T, int B, int S, long long lp_st, long long lp_sb,
                          void* stream) {
  if (T < 1 || B < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  ctc_beta_grad_kernel<<<B, block_threads(S), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(allow2),
      static_cast<const float*>(final_), static_cast<const int*>(xlens),
      static_cast<const float*>(alpha), static_cast<const float*>(ll),
      static_cast<const float*>(g), static_cast<float*>(grad), T, B, S, lp_st, lp_sb);
  return static_cast<int>(cudaGetLastError());
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
