// Fused CTC vocabulary head for Hopper (sm_90a): head product, streaming
// logsumexp and path-column extraction, never writing the (B, T, V) logits.
//
// Replaces: emoasr_tpu/ops/ctc_head_pallas.py::fused_ctc_head, kernels
// `_fwd_kernel`, `_grad_e_kernel` and `_grad_w_kernel`.
//
// Semantics: e (B, T, H), the weight w as nn.Linear keeps it, (V, H) with
// H contiguous, bias (V,), z (B, S) int32 path labels.
//   forward : lse[b,t] = logsumexp_v(e[b,t] . w[v] + bias[v]),
//             xs[b,t,s] = e[b,t] . w[z[b,s]] + bias[z[b,s]]
//   backward: with p = exp(logits - lse) recomputed tile by tile,
//             d logits[b,t,v] = g_lse[b,t] p[b,t,v] + sum_{s: z[b,s]=v} g_xs[b,t,s]
//             d e = d logits . w,  d w = d logits^T . e,  d bias = sum_bt d logits
// z holds repeats (blank at every even s, eos padding), so the sum over s
// above really sums.  A label outside [0, V) selects nothing (xs = 0, no
// gradient), as a one-hot of it would.  Rows past an utterance's length are
// computed like any other; their cotangents are zero, so their gradients
// are exactly zero.  H is a multiple of 8 and every row 16-byte aligned
// (the wrapper pads and copies where it is not).
//
// Types: e, w and bias share one type, float32 or bfloat16; lse and xs are
// f32; d e, d w and d bias are rounded once, at the end, to the inputs' type.
//
// What bounds it on this card: operations.  The forward is 2 B T H V
// products (36.8 GFLOP at (18,399,256)x(256,10000)) against ~5-10 MB of
// weights and ~15 MB of e and xs; each backward kernel recomputes the
// logits and does one more product of the same size.  So every product runs
// on the tensor cores (`mma.sync.m16n8k16`, bf16 operands, f32 sums:
// csrc/mma_bf16.cuh), which is the TPU kernel's own arithmetic in bf16:
//  * bf16 inputs: e and w are bf16 as they stand.  The backward's second
//    product has one f32 operand, d logits (`gl @ W.T` with W promoted,
//    :135-137; `e.astype(f32).T @ gl`, :186-188), so gl is split into
//    hi = bf16(gl) and lo = bf16(gl - hi), and two products add into one f32
//    accumulator (gl kept to ~2^-17 of itself before the final rounding).
//  * f32 inputs (TF32 is off by design): every f32 operand is split into
//    three bf16 terms (~24 bits), and the six leading cross products (terms
//    i + j <= 2) add into one f32 accumulator; the dropped ones are ~2^-24
//    of each product.  Six products at the bf16 rate still beat one on the
//    CUDA cores several times over.
// The operands reach the kernels as bf16 "planes": bf16 e and w as they
// stand, f32 e and w as their three terms, written by a first launch
// (split_kernel, ~26 MB at the L1 shape) so that every tile moves by
// cp.async and is read by `ldmatrix`.
//
// Design.  The TPU kernels carry the running max/sum (and the dW
// accumulator) across a sequential grid; blocks here run in no order, so
// the sequential dimension is a loop inside the block, with a two-stage
// `cp.async` pipeline that stages tile i+1 while tile i is multiplied:
//  * any H: the contraction runs over H in chunks of kHC columns (256 bf16,
//    128 f32).  With one chunk a block keeps its e tile (forward, grad-e) or
//    its w tile (grad-w) for the whole launch; above, both stream chunk by
//    chunk, from L2.
//  * forward and grad-e: one block owns 64 rows of one utterance, four
//    warps of 16 rows, and loops over its share of V in tiles of 64 (the
//    ragged last tile is masked, w is never padded), holding the running
//    max/sum (forward) or its chunk of d e (grad-e; the grid has one block
//    per chunk, each recomputing the whole logits) in registers.  126
//    blocks of four warps (the L1 shape) leave the tensor cores waiting on
//    latency, so V is split between NS blocks (some four blocks a SM), each
//    writing a partial (max, sum) or d e to an f32 scratch that a second
//    launch combines in split order.  The logits of
//    a tile are one warp's 16 x 64 accumulator; grad-e turns them into d
//    logits in place and feeds them, split, as the A operand of d e += gl w
//    (w read transposed by `ldmatrix.trans`): they never leave registers.
//  * the path columns are taken directly, not by a one-hot product: after
//    the V loop the same block runs ceil(S/64) more tiles whose w rows are
//    gathered by z.  In grad-e those tiles multiply g_xs, so repeated labels
//    add up with no scatter.
//  * grad-w: a block owns one 64-column tile of d w, one chunk of H, and one
//    of G groups of the B T rows (tiles of 64 rows of one utterance); it
//    computes the logits transposed (w rows as A), so that d logits^T is
//    again the A operand of d w += gl^T e.  The g_xs terms whose label falls
//    in the tile are added in registers, each element by the thread that
//    holds it, in path order.  Each group writes its partial d w (and d
//    bias) to an f32 scratch, and a second small launch sums the G partials
//    in a fixed order: G lifts the grid from 157 blocks (two waves on 132
//    SMs) to several waves of short blocks, without atomics.
// Sum orders are fixed: two launches give bit-identical outputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace emo_mma;

constexpr int kBM = 64;  // rows of e (forward, grad-e) or of w (grad-w) per tile
constexpr int kBN = 64;  // columns (vocabulary, path positions or rows of e) per tile
// eight warps: four groups of 16 rows, each by two halves of the 64
// columns; the halves' partial sums go to scratch slots of their own
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHalves = 2;
constexpr int kMaxSmem = 232448;
// H in ranges of 256: a block keeps the whole of its operand's rows in
// shared memory (the "resident" tile) when H <= kRange, and writes the d e
// or d w of one range of H columns (32 n8 tiles of accumulators a warp)
constexpr int kRange = 256;
constexpr int kLDR = kRange + 8;  // row stride of a resident tile

// bf16: one plane, streamed in chunks of 256; f32: three planes (the
// split), chunks of 128; d logits split into 2 (bf16) or 3 (f32) terms
template <typename E> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int kTerms = 1, kHC = 256, kGlTerms = 2;
};
template <> struct Cfg<float> {
  static constexpr int kTerms = 3, kHC = 128, kGlTerms = 3;
};
template <typename E> constexpr int kLD = Cfg<E>::kHC + 8;  // row stride of a chunk tile
template <typename E> constexpr int kPlane = kBM * kLD<E>;  // elements of a chunk tile's plane
template <typename E> constexpr int kTile = Cfg<E>::kTerms * kPlane<E>;
template <typename E> constexpr int kPlaneR = kBM * kLDR;
template <typename E> constexpr int kTileR = Cfg<E>::kTerms * kPlaneR<E>;
template <typename E> constexpr int kPerRange = kRange / Cfg<E>::kHC;  // chunks a range: 1 or 2
static_assert(kPerRange<bf16> == 1 && kPerRange<float> == 2, "a range is one or two chunks");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename E> __device__ __forceinline__ E from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
// columns of chunk `ch` rounded up to the 16 of a k-step (the rest zero)
__device__ __forceinline__ int chunk_width(int H, int ch, int hc) {
  return (min(hc, H - ch * hc) + 15) / 16 * 16;
}

// The operands as bf16 planes: plane p of an (n, H) row-major tensor at
// src + p * pstride (bf16 inputs: the tensor itself, one plane; f32: the
// three terms of its split, written by split_kernel).
struct Planes {
  const bf16* src;
  size_t pstride;
};

// a tile in shared memory: element (r, k) of plane t at p + t plane + r ld + k
struct View {
  const bf16* p;
  int ld, plane;
};

// rows r = 0..63 of an operand, columns of chunk `ch`, into dst (`ld`
// apart, planes `plane` apart) by cp.async: row_of(r) is the source row or
// -1 (zeros); columns past H are zeros
template <typename E, typename RowOf>
__device__ __forceinline__ void stage(bf16* dst, int ld, int plane, Planes x, int H, int ch, RowOf row_of) {
  const int h0 = ch * Cfg<E>::kHC, hc = min(Cfg<E>::kHC, H - h0), n = (hc + 15) / 16 * 2;  // 16-byte words
  const int dr = kThreads / n, dw = kThreads % n;
  int r = threadIdx.x / n, w = threadIdx.x % n;  // then stepped by kThreads without dividing
  while (r < kBM) {
    const int row = row_of(r);
    const bool ok = row >= 0 && w * 8 < hc;
    const size_t off = ok ? static_cast<size_t>(row) * H + h0 + w * 8 : 0;
#pragma unroll
    for (int p = 0; p < Cfg<E>::kTerms; ++p)
      cp_async16(dst + p * plane + r * ld + w * 8, x.src + p * x.pstride + off, ok);
    r += dr;
    w += dw;
    if (w >= n) {
      w -= n;
      ++r;
    }
  }
}

// a chunk tile, and the whole of a resident tile (H <= kRange)
template <typename E, typename RowOf>
__device__ __forceinline__ void stage_chunk(bf16* dst, Planes x, int H, int ch, RowOf row_of) {
  stage<E>(dst, kLD<E>, kPlane<E>, x, H, ch, row_of);
}
template <typename E, typename RowOf>
__device__ __forceinline__ void stage_resident(bf16* dst, Planes x, int H, RowOf row_of) {
  for (int ch = 0; ch < cdiv(H, Cfg<E>::kHC); ++ch)
    stage<E>(dst + ch * Cfg<E>::kHC, kLDR, kPlaneR<E>, x, H, ch, row_of);
}
template <typename E> __device__ __forceinline__ View chunk_view(const bf16* p) { return View{p, kLD<E>, kPlane<E>}; }
template <typename E> __device__ __forceinline__ View resident_view(const bf16* p, int ch) {
  return View{p + ch * Cfg<E>::kHC, kLDR, kPlaneR<E>};
}

// acc (the warp's 16 rows m0.. of tile a, x the 32 rows n0.. of tile b)
// += a b^T over `width` columns; TA and TB planes, the products with
// i + j <= 2
template <int TA, int TB>
__device__ __forceinline__ void product_nt(float acc[4][4], View a, View b, int width, int m0, int n0,
                                           int lane) {
#pragma unroll 2
  for (int k0 = 0; k0 < width; k0 += 16) {
    uint32_t af[TA][4];
#pragma unroll
    for (int i = 0; i < TA; ++i) load_a(af[i], a.p + i * a.plane, a.ld, m0, k0, lane);
#pragma unroll
    for (int j = 0; j < TB; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t bf[4];
        load_b(bf, b.p + j * b.plane, b.ld, n0 + 16 * n, k0, lane);
#pragma unroll
        for (int i = 0; i < TA; ++i)
          if (i + j <= 2) {
            mma(acc[2 * n], af[i], bf[0], bf[1]);
            mma(acc[2 * n + 1], af[i], bf[2], bf[3]);
          }
      }
  }
}

// acc2 (the warp's 16 rows x NT n8 tiles of columns) += f b, f the warp's
// 16 x 32 f32 tile in accumulator layout (split into TF bf16 terms) and b
// the 32 rows k0.. of a chunk tile (k) read transposed, its first `width`
// columns (n)
template <int TF, int TB, int NT>
__device__ __forceinline__ void product_fb(float acc2[NT][4], const float f[4][4], View b, int width, int k0,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    float t[8][TF];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split<TF>(f[2 * kk][i], t[i]);
      split<TF>(f[2 * kk + 1][i], t[4 + i]);
    }
    uint32_t af[TF][4];
#pragma unroll
    for (int i = 0; i < TF; ++i) {
      af[i][0] = pack(t[0][i], t[1][i]);
      af[i][1] = pack(t[2][i], t[3][i]);
      af[i][2] = pack(t[4][i], t[5][i]);
      af[i][3] = pack(t[6][i], t[7][i]);
    }
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      if (16 * n < width) {
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          uint32_t bf[4];
          load_b_trans(bf, b.p + j * b.plane, b.ld, 16 * n, k0 + 16 * kk, lane);
#pragma unroll
          for (int i = 0; i < TF; ++i)
            if (i + j <= 2) {
              mma(acc2[2 * n], af[i], bf[0], bf[1]);
              mma(acc2[2 * n + 1], af[i], bf[2], bf[3]);
            }
        }
      }
    }
  }
}

// the same into the columns of chunk k of a range (k < kPerRange)
template <typename E>
__device__ __forceinline__ void product_fb_range(float acc2[kRange / 8][4], int k, const float f[4][4], View b,
                                                 int width, int k0, int lane) {
  constexpr int NT = Cfg<E>::kHC / 8;
  if (k == 0)
    product_fb<Cfg<E>::kGlTerms, Cfg<E>::kTerms, NT>(acc2, f, b, width, k0, lane);
  else if constexpr (kPerRange<E> > 1)
    product_fb<Cfg<E>::kGlTerms, Cfg<E>::kTerms, NT>(acc2 + NT, f, b, width, k0, lane);
}

__device__ __forceinline__ void zero4(float acc[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
  return v + __shfl_xor_sync(0xFFFFFFFFu, v, 2);
}

// the label at path position s of utterance b, or -1 (past S, outside [0, V))
__device__ __forceinline__ int path_label(const int* __restrict__ z, int b, int s, int S, int V) {
  if (s >= S) return -1;
  const int zc = z[static_cast<size_t>(b) * S + s];
  return (zc >= 0 && zc < V) ? zc : -1;
}

// The V tiles [vt0, vt1) and the path tiles p = s, s + NS, ... of split s
// of NS (the forward and grad-e split the vocabulary between blocks, so
// that the grid holds some four blocks a SM; the partials are combined by a
// second launch in a fixed order).
struct Split {
  int vt0, vt1, n_pt;
  __device__ Split(int s, int NS, int n_vt, int n_st)
      : vt0(static_cast<int>(static_cast<long long>(s) * n_vt / NS)),
        vt1(static_cast<int>(static_cast<long long>(s + 1) * n_vt / NS)),
        n_pt(s < n_st ? (n_st - 1 - s) / NS + 1 : 0) {}
};

// The chunks of H a block visits for one tile when it writes range r: the
// logits take every chunk, in an order that ends with the range's first
// (so that its tile is the one in shared memory when the second product
// starts), then the range's other chunks come once more for the second
// product.  Stage q of a tile: chunk(q), a logits stage while q < n_ch.
struct Chunks {
  int n_ch, lo, nr;
  __device__ Chunks(int H, int hc, int r)
      : n_ch(cdiv(H, hc)), lo(r * (kRange / hc)), nr(min(cdiv(H, hc), (r + 1) * (kRange / hc)) - r * (kRange / hc)) {}
  __device__ int per_tile() const { return n_ch + nr - 1; }
  __device__ int chunk(int q) const { return q < n_ch ? (lo + 1 + q) % n_ch : lo + q - n_ch + 1; }
};

// ------------------------------------------------------------------ forward

// grid (T tiles, B, NS splits of V): the running max and sum of each row
// over the split's V tiles into part (NS, B T, 2), and xs of its path tiles
template <typename E>
__global__ void __launch_bounds__(kThreads)
ctc_head_fwd_kernel(Planes e, Planes w, const E* __restrict__ bias, const int* __restrict__ z,
                    float* __restrict__ part, float* __restrict__ xs, int T, int H, int V, int S) {
  constexpr int HC = Cfg<E>::kHC, TERMS = Cfg<E>::kTerms;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n_ch = cdiv(H, HC);
  const bool resident = H <= kRange;  // the e rows stay for the whole launch
  // resident: [e (kTileR)][w 0][w 1]; else [e 0][e 1][w 0][w 1]
  bf16* wbase = smem + (resident ? kTileR<E> : 2 * kTile<E>);
  auto ev = [&](int i, int ch) {
    return resident ? resident_view<E>(smem, ch) : chunk_view<E>(smem + (i & 1) * kTile<E>);
  };
  auto wb = [&](int i) { return wbase + (i & 1) * kTile<E>; };
  const int b = blockIdx.y, t0 = blockIdx.x * kBM, NS = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wr = warp & 3, hf = warp >> 2, col0 = 32 * hf;  // the warp's row group and column half
  const Split sp(blockIdx.z, NS, cdiv(V, kBN), cdiv(S, kBN));
  const int n_v = sp.vt1 - sp.vt0, n_stages = (n_v + sp.n_pt) * n_ch;
  auto e_row = [&](int r) { return t0 + r < T ? b * T + t0 + r : -1; };
  // stage i: chunk i % n_ch of the split's tile i / n_ch (V tiles, then path tiles)
  auto issue = [&](int i) {
    const int tile = i / n_ch, ch = i % n_ch;
    if (!resident) stage_chunk<E>(smem + (i & 1) * kTile<E>, e, H, ch, e_row);
    if (tile < n_v) {
      const int v0 = (sp.vt0 + tile) * kBN;
      stage_chunk<E>(wb(i), w, H, ch, [&](int r) { return v0 + r < V ? v0 + r : -1; });
    } else {
      const int s0 = (blockIdx.z + (tile - n_v) * NS) * kBN;
      stage_chunk<E>(wb(i), w, H, ch, [&](int r) { return path_label(z, b, s0 + r, S, V); });
    }
  };

  if (resident) stage_resident<E>(smem, e, H, e_row);
  issue(0);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[4][4];
  for (int i = 0; i < n_stages; ++i) {
    const int tile = i / n_ch, ch = i % n_ch;
    if (i + 1 < n_stages) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (ch == 0) zero4(acc);
    product_nt<TERMS, TERMS>(acc, ev(i, ch), chunk_view<E>(wb(i)), chunk_width(H, ch, HC), wr * 16, col0, lane);
    if (ch == n_ch - 1) {
      if (tile < n_v) {  // the running max and sum of each row
        const int v0 = (sp.vt0 + tile) * kBN;
        float bj[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int v = v0 + col0 + 8 * j + 2 * c + x;
            bj[j][x] = v < V ? to_float(bias[v]) : -INFINITY;  // the ragged edge never wins
          }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              acc[j][2 * hr + x] += bj[j][x];
              tmax = fmaxf(tmax, acc[j][2 * hr + x]);
            }
          // -inf while every column the warp's half has seen lies past V
          // (the ragged last tile): the sums stay 0, and the combine skips them
          const float m_new = fmaxf(m[hr], quad_max(tmax));
          const float at = m_new == -INFINITY ? 0.f : m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) sum += expf(acc[j][2 * hr] - at) + expf(acc[j][2 * hr + 1] - at);
          l[hr] = l[hr] * expf(m[hr] - at) + quad_sum(sum);
          m[hr] = m_new;
        }
      } else {  // the path columns
        const int s0 = (blockIdx.z + (tile - n_v) * NS) * kBN;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int s = s0 + col0 + 8 * j + 2 * c + x;
            if (s >= S) continue;
            const int v = path_label(z, b, s, S, V);
            const float bv = v >= 0 ? to_float(bias[v]) : 0.f;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int t = t0 + wr * 16 + g + 8 * hr;
              if (t < T) xs[(static_cast<size_t>(b) * T + t) * S + s] = acc[j][2 * hr + x] + bv;
            }
          }
      }
    }
    __syncthreads();  // buffer i & 1 is consumed
  }
  if (c == 0)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + wr * 16 + g + 8 * hr;
      if (t < T) {
        const size_t slot = static_cast<size_t>(blockIdx.z) * kHalves + hf;
        float* out = part + 2 * (slot * gridDim.y * T + static_cast<size_t>(b) * T + t);
        out[0] = m[hr];
        out[1] = l[hr];
      }
    }
}

// lse of each of the n rows from the NS splits' (max, sum), in split order
__global__ void lse_combine_kernel(const float* __restrict__ part, float* __restrict__ lse, int NS, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m = -INFINITY;
  for (int s = 0; s < NS; ++s) m = fmaxf(m, part[2 * (static_cast<size_t>(s) * n + i)]);
  float l = 0.f;
  for (int s = 0; s < NS; ++s) {  // a slot that saw no column of V holds (-inf, 0)
    const float* p = part + 2 * (static_cast<size_t>(s) * n + i);
    l += p[1] * expf(p[0] - m);
  }
  lse[i] = m + logf(l);
}

// ------------------------------------------------------------------ grad e

// grid (T tiles, B, NS splits x ranges of H): block (x, y, z) writes the
// partial d e of split z % NS, columns of range z / NS, into part (NS, B T, H)
template <typename E>
__global__ void __launch_bounds__(kThreads)
ctc_head_grad_e_kernel(Planes e, Planes w, const E* __restrict__ bias, const int* __restrict__ z,
                       const float* __restrict__ lse, const float* __restrict__ g_lse,
                       const float* __restrict__ g_xs, float* __restrict__ part, int NS, int T, int H, int V,
                       int S) {
  constexpr int HC = Cfg<E>::kHC, TERMS = Cfg<E>::kTerms, NR = kRange / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int split = blockIdx.z % NS, range = blockIdx.z / NS;
  const Chunks ck(H, HC, range);
  const bool resident = H <= kRange;
  bf16* wbase = smem + (resident ? kTileR<E> : 2 * kTile<E>);
  auto ev = [&](int i, int ch) {
    return resident ? resident_view<E>(smem, ch) : chunk_view<E>(smem + (i & 1) * kTile<E>);
  };
  auto wb = [&](int i) { return wbase + (i & 1) * kTile<E>; };
  const int b = blockIdx.y, t0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wr = warp & 3, hf = warp >> 2, col0 = 32 * hf;  // the warp's row group and column half
  const Split sp(split, NS, cdiv(V, kBN), cdiv(S, kBN));
  const int P = ck.per_tile(), n_logit = (sp.vt1 - sp.vt0) * P, n_stages = n_logit + sp.n_pt * ck.nr;
  auto e_row = [&](int r) { return t0 + r < T ? b * T + t0 + r : -1; };
  // stages: P per V tile (`Chunks`), then the range's chunks of each path
  // tile (w gathered by z; no e)
  auto issue = [&](int i) {
    if (i < n_logit) {
      const int v0 = (sp.vt0 + i / P) * kBN, q = i % P, ch = ck.chunk(q);
      if (!resident && q < ck.n_ch) stage_chunk<E>(smem + (i & 1) * kTile<E>, e, H, ch, e_row);
      stage_chunk<E>(wb(i), w, H, ch, [&](int r) { return v0 + r < V ? v0 + r : -1; });
    } else {
      const int j = i - n_logit, s0 = (split + (j / ck.nr) * NS) * kBN;
      stage_chunk<E>(wb(i), w, H, ck.lo + j % ck.nr, [&](int r) { return path_label(z, b, s0 + r, S, V); });
    }
  };

  float lse_r[2], gl_r[2], acc[4][4], acc2[NR][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = t0 + wr * 16 + g + 8 * hr;
    const size_t row = static_cast<size_t>(b) * T + t;
    lse_r[hr] = t < T ? lse[row] : 0.f;
    gl_r[hr] = t < T ? g_lse[row] : 0.f;  // rows past T: d logits = 0
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;

  if (resident) stage_resident<E>(smem, e, H, e_row);
  issue(0);
  cp_async_commit();
  for (int i = 0; i < n_stages; ++i) {
    if (i + 1 < n_stages) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const View wv = chunk_view<E>(wb(i));
    if (i < n_logit) {
      const int q = i % P, ch = ck.chunk(q);
      if (q < ck.n_ch) {
        if (q == 0) zero4(acc);
        product_nt<TERMS, TERMS>(acc, ev(i, ch), wv, chunk_width(H, ch, HC), wr * 16, col0, lane);
        if (q == ck.n_ch - 1) {  // d logits of the tile, in place
          const int v0 = (sp.vt0 + i / P) * kBN;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int v = v0 + col0 + 8 * j + 2 * c + x;
              const float bv = v < V ? to_float(bias[v]) : -INFINITY;  // exp(-inf) = 0 past the edge
#pragma unroll
              for (int hr = 0; hr < 2; ++hr)
                acc[j][2 * hr + x] = gl_r[hr] * expf(acc[j][2 * hr + x] + bv - lse_r[hr]);
            }
        }
      }
      if (q >= ck.n_ch - 1)  // d e[range] += gl w[tile, chunk]
        product_fb_range<E>(acc2, ch - ck.lo, acc, wv, chunk_width(H, ch, HC), col0, lane);
    } else {  // the path terms: d e += g_xs[:, s] w[z[s]], repeats add up
      const int j = i - n_logit, k = j % ck.nr, s0 = (split + (j / ck.nr) * NS) * kBN;
      if (k == 0) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int s = s0 + col0 + 8 * jj + 2 * c + x;
            const bool ok = path_label(z, b, s, S, V) >= 0;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int t = t0 + wr * 16 + g + 8 * hr;
              acc[jj][2 * hr + x] = (ok && t < T) ? g_xs[(static_cast<size_t>(b) * T + t) * S + s] : 0.f;
            }
          }
      }
      product_fb_range<E>(acc2, k, acc, wv, chunk_width(H, ck.lo + k, HC), col0, lane);
    }
    __syncthreads();
  }
  const int h0 = range * kRange;
  float* out = part + (static_cast<size_t>(split) * kHalves + hf) * gridDim.y * T * H;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int h = h0 + 8 * j + 2 * c;
    if (h >= H) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + wr * 16 + g + 8 * hr;
      if (t < T)
        *reinterpret_cast<float2*>(out + (static_cast<size_t>(b) * T + t) * H + h) =
            make_float2(acc2[j][2 * hr], acc2[j][2 * hr + 1]);
    }
  }
}

// ------------------------------------------------------------------ grad w

// The path terms of grad-w, summed ahead per label: first[b, s] is the
// first path position of z[b, s]'s label (-1 for a label outside [0, V)),
// and g_u[b, t, f] the sum of g_xs[b, t, s] over the positions s whose
// first position is f, in path order (zero elsewhere).  The blank sits at
// every even s, so without this the one tile that holds it would add some
// S / 2 terms an element, one after the other.
__global__ void path_first_kernel(const int* __restrict__ z, int* __restrict__ first, int S, int V) {
  const int b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int label = path_label(z, b, s, S, V);
    int f = -1;
    if (label >= 0)
      for (f = 0; z[static_cast<size_t>(b) * S + f] != label; ++f) {
      }
    first[static_cast<size_t>(b) * S + s] = f;
  }
}

__global__ void path_sum_kernel(const float* __restrict__ g_xs, const int* __restrict__ first,
                                float* __restrict__ g_u, int B, int T, int S) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B * T) return;
  const int* fb = first + static_cast<size_t>(row / T) * S;
  const float* gx = g_xs + static_cast<size_t>(row) * S;
  float* gu = g_u + static_cast<size_t>(row) * S;
  for (int s = 0; s < S; ++s) gu[s] = 0.f;
  for (int s = 0; s < S; ++s)
    if (fb[s] >= 0) gu[fb[s]] += gx[s];
}

// grid (V tiles, G groups of row tiles, ranges of H): block (x, y, z)
// writes the partial d w[tile x, range z] of row group y into part (G, V,
// H) f32, and the range-0 blocks the partial d bias into part_b (G, V)
template <typename E>
__global__ void __launch_bounds__(kThreads)
ctc_head_grad_w_kernel(Planes e, Planes w, const E* __restrict__ bias, const int* __restrict__ z,
                       const int* __restrict__ first,
                       const float* __restrict__ lse, const float* __restrict__ g_lse,
                       const float* __restrict__ g_u, float* __restrict__ part, float* __restrict__ part_b,
                       int B, int T, int H, int V, int S) {
  constexpr int HC = Cfg<E>::kHC, TERMS = Cfg<E>::kTerms, NR = kRange / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int range = blockIdx.z, group = blockIdx.y, G = gridDim.y;
  const Chunks ck(H, HC, range);
  const bool resident = H <= kRange;  // the w rows stay for the whole launch
  // resident: [w (kTileR)][e 0][e 1]; else [e 0][e 1][w 0][w 1]
  bf16* ebase = smem + (resident ? kTileR<E> : 0);
  auto eb = [&](int i) { return ebase + (i & 1) * kTile<E>; };
  auto wv = [&](int i, int ch) {
    return resident ? resident_view<E>(smem, ch) : chunk_view<E>(smem + (2 + (i & 1)) * kTile<E>);
  };
  int* hit_s = reinterpret_cast<int*>(smem + (resident ? kTileR<E> + 2 * kTile<E> : 4 * kTile<E>));
  int* hit_c = hit_s + S;  // the path labels that fall in the tile: first positions, columns
  __shared__ int n_hits;
  const int v0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wr = warp & 3, hf = warp >> 2, col0 = 32 * hf;  // the warp's row group and column half
  const int n_tt = cdiv(T, kBM), n_rt = B * n_tt;
  const int rt0 = static_cast<int>(static_cast<long long>(group) * n_rt / G);
  const int rt1 = static_cast<int>(static_cast<long long>(group + 1) * n_rt / G);
  const int P = ck.per_tile(), n_stages = (rt1 - rt0) * P;
  auto w_row = [&](int r) { return v0 + r < V ? v0 + r : -1; };
  // stage i: chunk ck.chunk(i % P) of row tile rt0 + i / P (its e, and
  // its w when w is not resident, for the logits stages)
  auto issue = [&](int i) {
    const int rt = rt0 + i / P, b = rt / n_tt, t0 = (rt % n_tt) * kBM, q = i % P, ch = ck.chunk(q);
    stage_chunk<E>(eb(i), e, H, ch, [&](int r) { return t0 + r < T ? b * T + t0 + r : -1; });
    if (!resident && q < ck.n_ch) stage_chunk<E>(smem + (2 + (i & 1)) * kTile<E>, w, H, ch, w_row);
  };

  float bias_v[2], db[2] = {0.f, 0.f}, acc[4][4], acc2[NR][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int v = v0 + wr * 16 + g + 8 * hr;
    bias_v[hr] = v < V ? to_float(bias[v]) : -INFINITY;  // exp(-inf) = 0 past the edge
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;

  if (n_stages > 0) {
    if (resident) stage_resident<E>(smem, w, H, w_row);
    issue(0);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    const int rt = rt0 + i / P, b = rt / n_tt, t0 = (rt % n_tt) * kBM, q = i % P, ch = ck.chunk(q);
    if (i + 1 < n_stages) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const View ev = chunk_view<E>(eb(i));
    if (q < ck.n_ch) {
      if (q == 0) zero4(acc);
      product_nt<TERMS, TERMS>(acc, wv(i, ch), ev, chunk_width(H, ch, HC), wr * 16, col0, lane);
    }
    if (q == ck.n_ch - 1) {
      if (rt == rt0 || rt % n_tt == 0) {
        // a new utterance: the first path positions of the labels that lie
        // in this tile, in path order (warp 0, ballot compaction:
        // deterministic); the previous list was last read before the
        // previous stage's barrier
        if (warp == 0) {
          int base = 0;
          for (int s0 = 0; s0 < S; s0 += 32) {
            const int s = s0 + lane;
            const bool lead = s < S && first[static_cast<size_t>(b) * S + s] == s;
            const int zc = lead ? z[static_cast<size_t>(b) * S + s] : -1;
            const bool hit = zc >= v0 && zc < v0 + kBN;
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
        __syncthreads();
      }
      // d logits^T of the tile: (v = the warp's rows, row of e = columns)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int t = t0 + col0 + 8 * j + 2 * c + x;
          const size_t row = static_cast<size_t>(b) * T + t;
          const float lr = t < T ? lse[row] : 0.f, gr = t < T ? g_lse[row] : 0.f;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) acc[j][2 * hr + x] = gr * expf(acc[j][2 * hr + x] + bias_v[hr] - lr);
        }
      // the path terms, summed ahead by label, each element by the thread that holds it
      const int n = n_hits;
      for (int k = 0; k < n; ++k) {
        const int col = hit_c[k];
        if ((col >> 4) != wr || (col & 7) != g) continue;
        const bool upper = (col >> 3) & 1;  // row g + 8 of the warp's 16
        const float* gu = g_u + static_cast<size_t>(b) * T * S + hit_s[k];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int t = t0 + col0 + 8 * j + 2 * c + x;
            const float add = t < T ? gu[static_cast<size_t>(t) * S] : 0.f;
            if (upper)
              acc[j][2 + x] += add;
            else
              acc[j][x] += add;
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int j = 0; j < 4; ++j) db[hr] += acc[j][2 * hr] + acc[j][2 * hr + 1];
    }
    if (q >= ck.n_ch - 1)  // d w[tile, range] += gl^T e[rows, chunk]
      product_fb_range<E>(acc2, ch - ck.lo, acc, ev, chunk_width(H, ch, HC), col0, lane);
    __syncthreads();
  }
  const int h0 = range * kRange;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int v = v0 + wr * 16 + g + 8 * hr;
    const float dbv = quad_sum(db[hr]);
    if (v >= V) continue;
    const size_t slot = static_cast<size_t>(group) * kHalves + hf;
    float* out = part + (slot * V + v) * H;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int h = h0 + 8 * j + 2 * c;
      if (h < H) *reinterpret_cast<float2*>(out + h) = make_float2(acc2[j][2 * hr], acc2[j][2 * hr + 1]);
    }
    if (range == 0 && c == 0) part_b[slot * V + v] = dbv;
  }
}

// out[i] = the sum of the G partials part[k n + i], in k order, rounded to E
template <typename E>
__global__ void sum_parts_kernel(const float* __restrict__ part, E* __restrict__ out, int G, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < G; ++k) s += part[k * n + i];
  out[i] = from_float<E>(s);
}

// the three bf16 terms of each of n f32 values (n % 4 == 0), plane p at
// out + p n
__global__ void split_kernel(const float* __restrict__ x, bf16* __restrict__ out, size_t n) {
  const size_t i = 4 * (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const float4 v = *reinterpret_cast<const float4*>(x + i);
  float t[4][3];
  split<3>(v.x, t[0]);
  split<3>(v.y, t[1]);
  split<3>(v.z, t[2]);
  split<3>(v.w, t[3]);
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<uint2*>(out + p * n + i) = make_uint2(pack(t[0][p], t[1][p]), pack(t[2][p], t[3][p]));
}

// dynamic shared memory of each kernel: kind 0 forward, 1 grad-e, 2 grad-w
template <typename E>
size_t smem_bytes(int kind, int H, int S) {
  const size_t tiles = (H <= kRange ? kTileR<E> + 2 * kTile<E> : 4 * kTile<E>) * sizeof(bf16);
  return kind < 2 ? tiles : tiles + 2 * static_cast<size_t>(S) * sizeof(int);
}

bool bad_shape(int B, int T, int H, int V, int S, int parts) {
  return B < 1 || T < 1 || H < 8 || H % 8 != 0 || V < 1 || S < 1 || parts < 1;
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

unsigned blocks_for(size_t n, int per_block) { return static_cast<unsigned>((n + per_block - 1) / per_block); }

// the operands as planes: bf16 as they stand; f32 split into `planes`
// (3 (B T H + V H) bf16) first
template <typename E>
cudaError_t operand_planes(const void* e, const void* w, void* planes, size_t NH, size_t VH,
                           cudaStream_t st, Planes& pe, Planes& pw) {
  if (Cfg<E>::kTerms == 1) {
    pe = Planes{static_cast<const bf16*>(e), NH};
    pw = Planes{static_cast<const bf16*>(w), VH};
    return cudaSuccess;
  }
  if (planes == nullptr) return cudaErrorInvalidValue;
  bf16* pl = static_cast<bf16*>(planes);
  split_kernel<<<blocks_for(NH / 4, 256), 256, 0, st>>>(static_cast<const float*>(e), pl, NH);
  split_kernel<<<blocks_for(VH / 4, 256), 256, 0, st>>>(static_cast<const float*>(w), pl + 3 * NH, VH);
  pe = Planes{pl, NH};
  pw = Planes{pl + 3 * NH, VH};
  return cudaGetLastError();
}

template <typename E>
int fwd(const void* e, const void* w, const void* bias, const void* z, void* lse, void* xs, void* part,
        void* planes, int NS, int B, int T, int H, int V, int S, void* stream) {
  if (bad_shape(B, T, H, V, S, NS) || NS > cdiv(V, kBN)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<E>(0, H, S), N = static_cast<size_t>(B) * T;
  cudaError_t err = prepare(ctc_head_fwd_kernel<E>, smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Planes pe, pw;
  if (err == cudaSuccess) err = operand_planes<E>(e, w, planes, N * H, static_cast<size_t>(V) * H, st, pe, pw);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(T, kBM), B, NS);
  ctc_head_fwd_kernel<E><<<grid, kThreads, smem, st>>>(pe, pw, static_cast<const E*>(bias),
                                                      static_cast<const int*>(z), static_cast<float*>(part),
                                                      static_cast<float*>(xs), T, H, V, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_combine_kernel<<<blocks_for(N, 256), 256, 0, st>>>(static_cast<const float*>(part), static_cast<float*>(lse),
                                                         NS * kHalves, static_cast<int>(N));
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int grad_e(const void* e, const void* w, const void* bias, const void* z, const void* lse,
           const void* g_lse, const void* g_xs, void* g_e, void* part, void* planes, int NS, int B, int T,
           int H, int V, int S, void* stream) {
  if (bad_shape(B, T, H, V, S, NS) || NS > cdiv(V, kBN)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<E>(1, H, S), NH = static_cast<size_t>(B) * T * H;
  cudaError_t err = prepare(ctc_head_grad_e_kernel<E>, smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Planes pe, pw;
  if (err == cudaSuccess) err = operand_planes<E>(e, w, planes, NH, static_cast<size_t>(V) * H, st, pe, pw);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(T, kBM), B, NS * cdiv(H, kRange));
  ctc_head_grad_e_kernel<E><<<grid, kThreads, smem, st>>>(
      pe, pw, static_cast<const E*>(bias), static_cast<const int*>(z), static_cast<const float*>(lse),
      static_cast<const float*>(g_lse), static_cast<const float*>(g_xs), static_cast<float*>(part), NS, T, H,
      V, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_parts_kernel<E><<<blocks_for(NH, 256), 256, 0, st>>>(static_cast<const float*>(part), static_cast<E*>(g_e),
                                                           NS * kHalves, NH);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int grad_w(const void* e, const void* w, const void* bias, const void* z, const void* lse,
           const void* g_lse, const void* g_xs, void* g_w, void* g_b, void* part, void* planes, int G, int B,
           int T, int H, int V, int S, void* stream) {
  if (bad_shape(B, T, H, V, S, G)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<E>(2, H, S), VH = static_cast<size_t>(V) * H, N = static_cast<size_t>(B) * T;
  cudaError_t err = prepare(ctc_head_grad_w_kernel<E>, smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Planes pe, pw;
  if (err == cudaSuccess) err = operand_planes<E>(e, w, planes, N * H, VH, st, pe, pw);
  if (err != cudaSuccess) return static_cast<int>(err);
  // scratch: the partials of d w and d bias, then g_u (B T S) and first (B S)
  float* part_w = static_cast<float*>(part);
  float* part_b = part_w + static_cast<size_t>(G) * kHalves * VH;
  float* g_u = part_b + static_cast<size_t>(G) * kHalves * V;
  int* first = reinterpret_cast<int*>(g_u + N * S);
  path_first_kernel<<<B, 256, 0, st>>>(static_cast<const int*>(z), first, S, V);
  path_sum_kernel<<<blocks_for(N, 128), 128, 0, st>>>(static_cast<const float*>(g_xs), first, g_u, B, T, S);
  const dim3 grid(cdiv(V, kBN), G, cdiv(H, kRange));
  ctc_head_grad_w_kernel<E><<<grid, kThreads, smem, st>>>(
      pe, pw, static_cast<const E*>(bias), static_cast<const int*>(z), first, static_cast<const float*>(lse),
      static_cast<const float*>(g_lse), g_u, part_w, part_b, B, T, H, V, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_parts_kernel<E><<<blocks_for(VH, 256), 256, 0, st>>>(part_w, static_cast<E*>(g_w), G * kHalves, VH);
  sum_parts_kernel<E><<<blocks_for(V, 256), 256, 0, st>>>(part_b, static_cast<E*>(g_b), G * kHalves,
                                                          static_cast<size_t>(V));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// e (B, T, H), w (V, H) and bias of one type (f32 or bf16); lse, xs, g_lse
// and g_xs f32; g_e, g_w (V, H) and g_b of the inputs' type.  `part` is an
// f32 scratch: 2 NS B T 2 (forward), 2 NS B T H (grad-e), 2 G (V H + V) +
// B T S + B S (grad-w), the 2 for the two column halves of a block;
// `planes` a bf16 scratch of 3 (B T H + V H) for f32 inputs (null for bf16)
int emo_ctc_head_fwd_f32(const void* e, const void* w, const void* bias, const void* z, void* lse, void* xs,
                         void* part, void* planes, int NS, int B, int T, int H, int V, int S, void* stream) {
  return fwd<float>(e, w, bias, z, lse, xs, part, planes, NS, B, T, H, V, S, stream);
}

int emo_ctc_head_fwd_bf16(const void* e, const void* w, const void* bias, const void* z, void* lse, void* xs,
                          void* part, void* planes, int NS, int B, int T, int H, int V, int S, void* stream) {
  return fwd<bf16>(e, w, bias, z, lse, xs, part, planes, NS, B, T, H, V, S, stream);
}

int emo_ctc_head_grad_e_f32(const void* e, const void* w, const void* bias, const void* z, const void* lse,
                            const void* g_lse, const void* g_xs, void* g_e, void* part, void* planes, int NS,
                            int B, int T, int H, int V, int S, void* stream) {
  return grad_e<float>(e, w, bias, z, lse, g_lse, g_xs, g_e, part, planes, NS, B, T, H, V, S, stream);
}

int emo_ctc_head_grad_e_bf16(const void* e, const void* w, const void* bias, const void* z, const void* lse,
                             const void* g_lse, const void* g_xs, void* g_e, void* part, void* planes, int NS,
                             int B, int T, int H, int V, int S, void* stream) {
  return grad_e<bf16>(e, w, bias, z, lse, g_lse, g_xs, g_e, part, planes, NS, B, T, H, V, S, stream);
}

int emo_ctc_head_grad_w_f32(const void* e, const void* w, const void* bias, const void* z, const void* lse,
                            const void* g_lse, const void* g_xs, void* g_w, void* g_b, void* part, void* planes,
                            int G, int B, int T, int H, int V, int S, void* stream) {
  return grad_w<float>(e, w, bias, z, lse, g_lse, g_xs, g_w, g_b, part, planes, G, B, T, H, V, S, stream);
}

int emo_ctc_head_grad_w_bf16(const void* e, const void* w, const void* bias, const void* z, const void* lse,
                             const void* g_lse, const void* g_xs, void* g_w, void* g_b, void* part, void* planes,
                             int G, int B, int T, int H, int V, int S, void* stream) {
  return grad_w<bf16>(e, w, bias, z, lse, g_lse, g_xs, g_w, g_b, part, planes, G, B, T, H, V, S, stream);
}

// the dynamic shared memory of kernel `kind` (0 forward, 1 grad-e, 2
// grad-w) in bf16 (`bf16_in` != 0) or f32, for holding the wrapper's own
// account of it against the kernels'
int emo_ctc_head_smem_bytes(int kind, int bf16_in, int H, int S) {
  return static_cast<int>(bf16_in ? smem_bytes<bf16>(kind, H, S) : smem_bytes<float>(kind, H, S));
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
