// Fused CTC vocabulary head for Hopper (sm_90a): head product, streaming
// logsumexp and path-column extraction, never writing the (B, T, V) logits.
//
// Replaces: emoasr_tpu/ops/ctc_head_pallas.py::fused_ctc_head, kernels
// `_fwd_kernel`, `_grad_e_kernel` and `_grad_w_kernel`.
//
// Semantics: e (B, T, H), w (H, V) with strides (w_sk, w_sv), one of them 1
// (so the (V, H) weight of a linear layer is read in place, transposed, and
// d w is written in the same layout), bias (V,), z (B, S) int32 path labels.
//   forward : lse[b,t] = logsumexp_v(e[b,t] . w[:,v] + bias[v]),
//             xs[b,t,s] = e[b,t] . w[:,z[b,s]] + bias[z[b,s]]
//   backward: with p = exp(logits - lse) recomputed tile by tile,
//             d logits[b,t,v] = g_lse[b,t] p[b,t,v] + sum_{s: z[b,s]=v} g_xs[b,t,s]
//             d e = d logits . w^T,  d w = e^T . d logits,  d bias = sum_bt d logits
// z holds repeats (blank at every even s, eos padding), so the sum over s
// above really sums.  A label outside [0, V) selects nothing (xs = 0, no
// gradient), as a one-hot of it would.  Rows past an utterance's length are
// computed like any other; their cotangents are zero, so their gradients
// are exactly zero.
//
// Types: e, w and bias share one type, float32 or bfloat16.  Either way
// the values are staged in shared memory as f32 and every product
// accumulates in f32 (a product of two bf16 values is exact in f32): the
// forward is the TPU kernel's bf16 `e @ W` with f32 accumulation plus the
// f32 bias; grad-e is the f32 `d logits @ W^T` with W's values promoted;
// grad-w is `e.astype(f32)^T @ d logits`.  lse and xs are f32; d e, d w
// and d bias are rounded once, at the end, to the inputs' type.
//
// What bounds it on this card: operations.  Forward is 2 B T H V flops
// (36.8 GFLOP at (18,399,256)x(256,10000)) against ~10 MB of weights and
// ~15 MB of e/xs; each backward kernel recomputes the logits and does one
// more product of the same size.  This first version computes in f32 on
// the CUDA cores (no wgmma), also for bf16 inputs.
//
// Design.  The TPU kernels carry the running max/sum (and the dW
// accumulator) across a sequential grid; blocks here run in no order, so
// the sequential dimension is a loop inside the block:
//  * any H: the contraction runs over H in chunks of 256 rows, the most an
//    (H, 64) tile of e and one of w hold in shared memory.  With H <= 256
//    (one chunk) a block keeps its e tile (forward, grad-e) or its w tile
//    (grad-w) for the whole launch; above, both are staged chunk by chunk
//    for every tile of logits, from L2.
//  * forward and grad-e: one block owns 64 rows of one utterance and loops
//    over V in tiles of 64 columns (the ragged last tile is masked, w is
//    never padded), holding the running max/sum (forward) or the d e
//    accumulator of its 256-wide chunk of H (grad-e; the grid has one block
//    per chunk, each recomputing the whole logits) in registers.
//  * the path columns are taken directly, not by a one-hot product: after
//    the V loop the same block runs ceil(S/64) more tiles whose w columns
//    are gathered by z.  In grad-e those tiles multiply g_xs, so repeated
//    labels add up with no scatter.
//  * grad-w: one block owns one 256-row chunk of H of one 64-column tile
//    of d w (and the chunk-0 block d bias) and loops over all B T rows, so
//    no two blocks write the same output and the sum order is fixed
//    (deterministic, no atomics).  The chunks of a logits tile are staged
//    in an order that ends with the block's own, so its e rows are the ones
//    in shared memory when the d w product runs; grad-e likewise ends on
//    its own chunk of w.  The
//    g_xs terms whose label falls in the block's columns are added into the
//    d logits tile in shared memory, each (row, column) by one thread in
//    path order, before the e^T . d logits product.
//  * both products of a tile run on 4x4 (logits) and 4x16 (gradient)
//    register tiles per thread out of shared memory, every operand read
//    as 16-byte words: the logits product along the rows and columns (an
//    outer product per k), the gradient products along the contraction.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // rows of e per tile
constexpr int kBN = 64;       // vocabulary (or path) columns per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 logits each
constexpr int kHC = 256;      // hidden rows per shared-memory tile: one chunk of H
constexpr int kLD = 68;       // padded leading dimension, keeps 16 B alignment

constexpr size_t kTileFloats = static_cast<size_t>(kHC) * kLD;  // es or ws
constexpr size_t kGlFloats = static_cast<size_t>(kBN) * kLD;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename E> __device__ __forceinline__ E from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int chunks_of(int H) { return (H + kHC - 1) / kHC; }

// the i-th chunk staged for a block that owns chunk `own`: the order ends
// with `own`, so that its tile is the one left in shared memory
__device__ __forceinline__ int chunk_at(int i, int own, int n) { return (own + 1 + i) % n; }

// rows of the contraction in chunk h0 = c kHC
__device__ __forceinline__ int chunk_rows(int h0, int H) { return min(kHC, H - h0); }

// e[b, t0.., h0..] into es[k][row] (rows past T and h past H: 0)
template <typename E>
__device__ __forceinline__ void load_e_tile(float* es, const E* __restrict__ e, int b, int t0,
                                            int T, int H, int h0) {
  for (int i = threadIdx.x; i < kBM * kHC; i += kThreads) {
    const int r = i / kHC, k = i % kHC;
    const int t = t0 + r, h = h0 + k;
    es[k * kLD + r] =
        (t < T && h < H) ? to_float(e[(static_cast<size_t>(b) * T + t) * H + h]) : 0.f;
  }
}

// the strides of w (H, V), in elements; neighbouring threads read along
// the axis whose stride is 1
struct WLayout {
  long long sk, sv;
  __device__ __forceinline__ void split(int i, int& k, int& c) const {
    if (sv == 1) {
      k = i / kBN;
      c = i % kBN;
    } else {
      c = i / kHC;
      k = i % kHC;
    }
  }
  __device__ __forceinline__ size_t at(int k, int v) const {
    return static_cast<size_t>(k) * sk + static_cast<size_t>(v) * sv;
  }
};

// w[h0.., v0 .. v0+63] into ws[k][col] (columns past V and h past H: 0)
template <typename E>
__device__ __forceinline__ void load_w_tile(float* ws, const E* __restrict__ w, WLayout wl,
                                            int v0, int V, int H, int h0) {
  for (int i = threadIdx.x; i < kBN * kHC; i += kThreads) {
    int k, c;
    wl.split(i, k, c);
    const int v = v0 + c, h = h0 + k;
    ws[k * kLD + c] = (v < V && h < H) ? to_float(w[wl.at(h, v)]) : 0.f;
  }
}

// cols[c] = z[b][s0 + c] when that is a label in [0, V), else -1
__device__ __forceinline__ void load_path_cols(int* cols, const int* __restrict__ z, int b, int s0,
                                               int S, int V) {
  if (threadIdx.x < kBN) {
    const int s = s0 + threadIdx.x;
    int zc = s < S ? z[static_cast<size_t>(b) * S + s] : -1;
    if (zc < 0 || zc >= V) zc = -1;
    cols[threadIdx.x] = zc;
  }
}

// w[h0.., cols[c]] into ws[k][col]
template <typename E>
__device__ __forceinline__ void load_w_gather(float* ws, const E* __restrict__ w, WLayout wl,
                                              const int* cols, int H, int h0) {
  for (int i = threadIdx.x; i < kBN * kHC; i += kThreads) {
    int k, c;
    wl.split(i, k, c);
    const int v = cols[c], h = h0 + k;
    ws[k * kLD + c] = (v >= 0 && h < H) ? to_float(w[wl.at(h, v)]) : 0.f;
  }
}

__device__ __forceinline__ void zero_tile(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < kc} es[k][ty*4+i] * ws[k][tx*4+j]
__device__ __forceinline__ void logits_tile(const float* es, const float* ws, int kc, int ty,
                                            int tx, float acc[4][4]) {
#pragma unroll 4
  for (int k = 0; k < kc; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(es + k * kLD + ty * 4);
    const float4 b4 = *reinterpret_cast<const float4*>(ws + k * kLD + tx * 4);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// reductions over the 16 lanes that share a row group (same ty)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// ------------------------------------------------------------------ forward

template <typename E>
__global__ void __launch_bounds__(kThreads)
ctc_head_fwd_kernel(const E* __restrict__ e, const E* __restrict__ w,
                    const E* __restrict__ bias, const int* __restrict__ z,
                    float* __restrict__ lse, float* __restrict__ xs, int T, int H, int V, int S,
                    WLayout wl) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;
  float* ws = smem + kTileFloats;
  int* cols = reinterpret_cast<int*>(ws + kTileFloats);
  const int b = blockIdx.y, t0 = blockIdx.x * kBM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_ch = chunks_of(H);
  const bool resident = n_ch == 1;  // the e tile stays for the whole launch

  if (resident) load_e_tile(es, e, b, t0, T, H, 0);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int v0 = 0; v0 < V; v0 += kBN) {
    zero_tile(acc);
    for (int c = 0; c < n_ch; ++c) {
      const int h0 = c * kHC;
      __syncthreads();  // the previous tile is consumed (and es is written)
      if (!resident) load_e_tile(es, e, b, t0, T, H, h0);
      load_w_tile(ws, w, wl, v0, V, H, h0);
      __syncthreads();
      logits_tile(es, ws, chunk_rows(h0, H), ty, tx, acc);
    }
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx * 4 + j;
      bj[j] = v < V ? to_float(bias[v]) : -INFINITY;  // the ragged edge never wins
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += bj[j];
        tmax = fmaxf(tmax, acc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(tmax));  // finite: column v0 is valid
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(acc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(sum);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t < T) lse[static_cast<size_t>(b) * T + t] = m[i] + logf(l[i]);
    }
  }
  // path columns: tiles of w gathered by z
  for (int s0 = 0; s0 < S; s0 += kBN) {
    __syncthreads();
    load_path_cols(cols, z, b, s0, S, V);
    zero_tile(acc);
    for (int c = 0; c < n_ch; ++c) {
      const int h0 = c * kHC;
      __syncthreads();  // cols are written, the previous tile is consumed
      if (!resident) load_e_tile(es, e, b, t0, T, H, h0);
      load_w_gather(ws, w, wl, cols, H, h0);
      __syncthreads();
      logits_tile(es, ws, chunk_rows(h0, H), ty, tx, acc);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j, s = s0 + c;
      if (s >= S) continue;
      const int v = cols[c];
      const float bv = v >= 0 ? to_float(bias[v]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        if (t < T) xs[(static_cast<size_t>(b) * T + t) * S + s] = acc[i][j] + bv;
      }
    }
  }
}

// ------------------------------------------------------------------ grad e

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// acc2[i][jj] += sum_v gls[ty*4+i][v] * ws[tx + 16 jj][v]: both operands
// are read four v at a time along the contraction
__device__ __forceinline__ void grad_e_tile(const float* gls, const float* ws, int ty, int tx,
                                            float acc2[4][16]) {
  for (int v = 0; v < kBN; v += 4) {
    float4 g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = *reinterpret_cast<const float4*>(gls + (ty * 4 + i) * kLD + v);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float4 w4 = *reinterpret_cast<const float4*>(ws + (tx + 16 * jj) * kLD + v);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc2[i][jj] = dot4(g[i], w4, acc2[i][jj]);
    }
  }
}

// grid (T tiles, B, chunks of H): block z writes d e[:, :, chunk z]
template <typename E>
__global__ void __launch_bounds__(kThreads)
ctc_head_grad_e_kernel(const E* __restrict__ e, const E* __restrict__ w,
                       const E* __restrict__ bias, const int* __restrict__ z,
                       const float* __restrict__ lse, const float* __restrict__ g_lse,
                       const float* __restrict__ g_xs, E* __restrict__ g_e, int T, int H,
                       int V, int S, WLayout wl) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;
  float* ws = smem + kTileFloats;
  float* gls = ws + kTileFloats;  // d logits tile, gls[row][v]
  int* cols = reinterpret_cast<int*>(gls + kGlFloats);
  const int b = blockIdx.y, t0 = blockIdx.x * kBM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_ch = chunks_of(H), own = blockIdx.z, own_h0 = own * kHC;
  const bool resident = n_ch == 1;

  if (resident) load_e_tile(es, e, b, t0, T, H, 0);
  float lse_r[4], gl_r[4], acc[4][4], acc2[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    const size_t row = static_cast<size_t>(b) * T + t;
    lse_r[i] = t < T ? lse[row] : 0.f;
    gl_r[i] = t < T ? g_lse[row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) acc2[i][jj] = 0.f;
  }
  for (int v0 = 0; v0 < V; v0 += kBN) {
    zero_tile(acc);
    for (int i = 0; i < n_ch; ++i) {
      const int h0 = chunk_at(i, own, n_ch) * kHC;
      __syncthreads();  // the previous tiles (and gls) are consumed
      if (!resident) load_e_tile(es, e, b, t0, T, H, h0);
      load_w_tile(ws, w, wl, v0, V, H, h0);
      __syncthreads();
      logits_tile(es, ws, chunk_rows(h0, H), ty, tx, acc);
    }
    // ws now holds the block's own chunk of w
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bj[j] = v0 + tx * 4 + j < V ? to_float(bias[v0 + tx * 4 + j]) : -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 gl;  // exp(-inf) = 0 past the ragged edge
      gl.x = gl_r[i] * expf(acc[i][0] + bj[0] - lse_r[i]);
      gl.y = gl_r[i] * expf(acc[i][1] + bj[1] - lse_r[i]);
      gl.z = gl_r[i] * expf(acc[i][2] + bj[2] - lse_r[i]);
      gl.w = gl_r[i] * expf(acc[i][3] + bj[3] - lse_r[i]);
      *reinterpret_cast<float4*>(gls + (ty * 4 + i) * kLD + tx * 4) = gl;
    }
    __syncthreads();
    grad_e_tile(gls, ws, ty, tx, acc2);
  }
  // the path terms: d e += g_xs[:, s] * w[:, z[s]], repeats add up
  for (int s0 = 0; s0 < S; s0 += kBN) {
    __syncthreads();
    load_path_cols(cols, z, b, s0, S, V);
    __syncthreads();
    load_w_gather(ws, w, wl, cols, H, own_h0);
    for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int t = t0 + r, s = s0 + c;
      gls[r * kLD + c] = (t < T && s < S && cols[c] >= 0)
                             ? g_xs[(static_cast<size_t>(b) * T + t) * S + s]
                             : 0.f;
    }
    __syncthreads();
    grad_e_tile(gls, ws, ty, tx, acc2);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= T) continue;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int h = own_h0 + tx + 16 * jj;
      if (h < H) g_e[(static_cast<size_t>(b) * T + t) * H + h] = from_float<E>(acc2[i][jj]);
    }
  }
}

// ------------------------------------------------------------------ grad w

// grid (V tiles, chunks of H): block y writes d w[chunk y, its tile], and
// the chunk-0 block d bias of its tile
template <typename E>
__global__ void __launch_bounds__(kThreads)
ctc_head_grad_w_kernel(const E* __restrict__ e, const E* __restrict__ w,
                       const E* __restrict__ bias, const int* __restrict__ z,
                       const float* __restrict__ lse, const float* __restrict__ g_lse,
                       const float* __restrict__ g_xs, E* __restrict__ g_w,
                       E* __restrict__ g_b, int B, int T, int H, int V, int S, WLayout wl) {
  extern __shared__ __align__(16) float smem[];
  float* es = smem;
  float* ws = smem + kTileFloats;
  float* gls = ws + kTileFloats;  // d logits tile, gls[v][row]
  int* hit_s = reinterpret_cast<int*>(gls + kGlFloats);  // path positions in this tile
  int* hit_c = hit_s + S;                                // and their columns
  __shared__ int n_hits;
  const int v0 = blockIdx.x * kBN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int lane = threadIdx.x & 31;
  const int n_ch = chunks_of(H), own = blockIdx.y, own_h0 = own * kHC;
  const bool resident = n_ch == 1;  // the w tile stays for the whole launch

  if (resident) load_w_tile(ws, w, wl, v0, V, H, 0);
  // acc2[c*4+i][j]: h = own_h0 + ty*4 + i + 64 c, v = tx + 16 j
  float bj[4], acc[4][4], acc2[16][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = v0 + tx * 4 + j;
    bj[j] = v < V ? to_float(bias[v]) : -INFINITY;
  }
#pragma unroll
  for (int a = 0; a < 16; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc2[a][j] = 0.f;
  float db = 0.f;

  for (int b = 0; b < B; ++b) {
    // path positions of utterance b whose label lies in this block's
    // columns, in path order (warp 0, ballot compaction: deterministic)
    __syncthreads();  // the previous utterance's list is consumed
    if (threadIdx.x < 32) {
      int base = 0;
      for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        const int zc = s < S ? z[static_cast<size_t>(b) * S + s] : -1;
        const bool hit = zc >= v0 && zc < v0 + kBN && zc < V;
        const unsigned mask = __ballot_sync(0xFFFFFFFFu, hit);
        if (hit) {
          const int pos = base + __popc(mask & ((1u << lane) - 1u));
          hit_s[pos] = s;
          hit_c[pos] = zc - v0;
        }
        base += __popc(mask);
      }
      if (lane == 0) n_hits = base;
    }
    for (int t0 = 0; t0 < T; t0 += kBM) {
      zero_tile(acc);
      for (int i = 0; i < n_ch; ++i) {
        const int h0 = chunk_at(i, own, n_ch) * kHC;
        __syncthreads();  // the previous tile is consumed (and ws, hits are written)
        load_e_tile(es, e, b, t0, T, H, h0);
        if (!resident) load_w_tile(ws, w, wl, v0, V, H, h0);
        __syncthreads();
        logits_tile(es, ws, chunk_rows(h0, H), ty, tx, acc);
      }
      // es now holds the block's own chunk of e
      float lse_r[4], gl_r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        const size_t row = static_cast<size_t>(b) * T + t;
        lse_r[i] = t < T ? lse[row] : 0.f;
        gl_r[i] = t < T ? g_lse[row] : 0.f;  // rows past T: d logits = 0
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 gl;  // exp(-inf) = 0 past the ragged edge
        gl.x = gl_r[0] * expf(acc[0][j] + bj[j] - lse_r[0]);
        gl.y = gl_r[1] * expf(acc[1][j] + bj[j] - lse_r[1]);
        gl.z = gl_r[2] * expf(acc[2][j] + bj[j] - lse_r[2]);
        gl.w = gl_r[3] * expf(acc[3][j] + bj[j] - lse_r[3]);
        *reinterpret_cast<float4*>(gls + (tx * 4 + j) * kLD + ty * 4) = gl;
      }
      __syncthreads();
      // the path terms: thread (row r, quarter q) adds the hits whose
      // column is q mod 4, in path order; no two threads share an element
      {
        const int r = threadIdx.x % kBM, q = threadIdx.x / kBM;
        const int t = t0 + r;
        if (t < T) {
          const float* gx = g_xs + (static_cast<size_t>(b) * T + t) * S;
          const int n = n_hits;
          for (int hI = 0; hI < n; ++hI) {
            const int c = hit_c[hI];
            if ((c & 3) == q) gls[c * kLD + r] += gx[hit_s[hI]];
          }
        }
      }
      __syncthreads();
      // d w tile += e^T . d logits, both operands read four rows at a time
      for (int r = 0; r < kBM; r += 4) {
        float4 g[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = *reinterpret_cast<const float4*>(gls + (tx + 16 * j) * kLD + r);
#pragma unroll
        for (int a = 0; a < 16; ++a) {
          const int h = ty * 4 + (a & 3) + 64 * (a >> 2);
          const float4 e4 = *reinterpret_cast<const float4*>(es + h * kLD + r);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[a][j] = dot4(e4, g[j], acc2[a][j]);
        }
      }
      if (threadIdx.x < kBN)
        for (int r = 0; r < kBM; ++r) db += gls[threadIdx.x * kLD + r];
    }
  }
#pragma unroll
  for (int a = 0; a < 16; ++a) {
    const int h = own_h0 + ty * 4 + (a & 3) + 64 * (a >> 2);
    if (h >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx + 16 * j;
      if (v < V) g_w[wl.at(h, v)] = from_float<E>(acc2[a][j]);
    }
  }
  if (own == 0 && threadIdx.x < kBN && v0 + threadIdx.x < V) g_b[v0 + threadIdx.x] = from_float<E>(db);
}

bool bad_shape(int B, int T, int H, int V, int S, long long w_sk, long long w_sv) {
  return B < 1 || T < 1 || H < 1 || V < 1 || S < 1 || (w_sk != 1 && w_sv != 1);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename E>
int fwd(const void* e, const void* w, const void* bias, const void* z, void* lse, void* xs, int B,
        int T, int H, int V, int S, long long w_sk, long long w_sv, void* stream) {
  if (bad_shape(B, T, H, V, S, w_sk, w_sv)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * kTileFloats * sizeof(float) + kBN * sizeof(int);
  cudaError_t err = allow_smem(ctc_head_fwd_kernel<E>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBM - 1) / kBM, B);
  ctc_head_fwd_kernel<E><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(e), static_cast<const E*>(w), static_cast<const E*>(bias),
      static_cast<const int*>(z), static_cast<float*>(lse), static_cast<float*>(xs), T, H, V, S,
      WLayout{w_sk, w_sv});
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int grad_e(const void* e, const void* w, const void* bias, const void* z, const void* lse,
           const void* g_lse, const void* g_xs, void* g_e, int B, int T, int H, int V, int S,
           long long w_sk, long long w_sv, void* stream) {
  if (bad_shape(B, T, H, V, S, w_sk, w_sv)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * kTileFloats + kGlFloats) * sizeof(float) + kBN * sizeof(int);
  cudaError_t err = allow_smem(ctc_head_grad_e_kernel<E>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBM - 1) / kBM, B, chunks_of(H));
  ctc_head_grad_e_kernel<E><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(e), static_cast<const E*>(w), static_cast<const E*>(bias),
      static_cast<const int*>(z), static_cast<const float*>(lse),
      static_cast<const float*>(g_lse), static_cast<const float*>(g_xs), static_cast<E*>(g_e),
      T, H, V, S, WLayout{w_sk, w_sv});
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int grad_w(const void* e, const void* w, const void* bias, const void* z, const void* lse,
           const void* g_lse, const void* g_xs, void* g_w, void* g_b, int B, int T, int H, int V,
           int S, long long w_sk, long long w_sv, void* stream) {
  if (bad_shape(B, T, H, V, S, w_sk, w_sv)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (2 * kTileFloats + kGlFloats) * sizeof(float) + 2 * static_cast<size_t>(S) * sizeof(int);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(ctc_head_grad_w_kernel<E>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((V + kBN - 1) / kBN, chunks_of(H));
  ctc_head_grad_w_kernel<E><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(e), static_cast<const E*>(w), static_cast<const E*>(bias),
      static_cast<const int*>(z), static_cast<const float*>(lse),
      static_cast<const float*>(g_lse), static_cast<const float*>(g_xs), static_cast<E*>(g_w),
      static_cast<E*>(g_b), B, T, H, V, S, WLayout{w_sk, w_sv});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// e, w and bias of one type (f32 or bf16); lse, xs, g_lse and g_xs f32;
// g_e, g_w and g_b of the inputs' type
int emo_ctc_head_fwd_f32(const void* e, const void* w, const void* bias, const void* z,
                         void* lse, void* xs, int B, int T, int H, int V, int S,
                         long long w_sk, long long w_sv, void* stream) {
  return fwd<float>(e, w, bias, z, lse, xs, B, T, H, V, S, w_sk, w_sv, stream);
}

int emo_ctc_head_fwd_bf16(const void* e, const void* w, const void* bias, const void* z,
                          void* lse, void* xs, int B, int T, int H, int V, int S,
                          long long w_sk, long long w_sv, void* stream) {
  return fwd<__nv_bfloat16>(e, w, bias, z, lse, xs, B, T, H, V, S, w_sk, w_sv, stream);
}

int emo_ctc_head_grad_e_f32(const void* e, const void* w, const void* bias, const void* z,
                            const void* lse, const void* g_lse, const void* g_xs, void* g_e,
                            int B, int T, int H, int V, int S, long long w_sk, long long w_sv,
                            void* stream) {
  return grad_e<float>(e, w, bias, z, lse, g_lse, g_xs, g_e, B, T, H, V, S, w_sk, w_sv, stream);
}

int emo_ctc_head_grad_e_bf16(const void* e, const void* w, const void* bias, const void* z,
                             const void* lse, const void* g_lse, const void* g_xs, void* g_e,
                             int B, int T, int H, int V, int S, long long w_sk, long long w_sv,
                             void* stream) {
  return grad_e<__nv_bfloat16>(e, w, bias, z, lse, g_lse, g_xs, g_e, B, T, H, V, S, w_sk, w_sv,
                               stream);
}

int emo_ctc_head_grad_w_f32(const void* e, const void* w, const void* bias, const void* z,
                            const void* lse, const void* g_lse, const void* g_xs, void* g_w,
                            void* g_b, int B, int T, int H, int V, int S, long long w_sk,
                            long long w_sv, void* stream) {
  return grad_w<float>(e, w, bias, z, lse, g_lse, g_xs, g_w, g_b, B, T, H, V, S, w_sk, w_sv,
                       stream);
}

int emo_ctc_head_grad_w_bf16(const void* e, const void* w, const void* bias, const void* z,
                             const void* lse, const void* g_lse, const void* g_xs, void* g_w,
                             void* g_b, int B, int T, int H, int V, int S, long long w_sk,
                             long long w_sv, void* stream) {
  return grad_w<__nv_bfloat16>(e, w, bias, z, lse, g_lse, g_xs, g_w, g_b, B, T, H, V, S, w_sk,
                               w_sv, stream);
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
