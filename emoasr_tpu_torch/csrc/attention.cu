// Fused masked self-attention, forward and backward with dropout, for
// Hopper (sm_90a).
//
// Replaces: emoasr_tpu/ops/attention_pallas.py::fused_self_attention,
// kernels `_fwd_kernel` and `_bwd_kernel` with `_drop_mask` and the
// `has_bias` branches: the encoder self-attention of every Transformer and
// Conformer layer when `enc_fused_attn` is on, in decoding and in training.
//
// Semantics (models/layers.py::MultiHeadAttention._attend): per (b, h),
// S = (Q K^T + bias) * scale (`bias` optional, (B, H, T, T), the Conformer's
// shifted relative-position term, read in its own dtype, f32 or bf16), keys
// at or beyond lens[b] filled with -1e9 before an
// f32 softmax and zeroed after it, P cast to v.dtype, O = P V accumulated in
// f32, written in v.dtype.  The -1e9 fill gives a masked key the weight
// exp(-1e9 - max) = 0 in f32, so skipping masked keys is the same function;
// lens[b] == 0 (every key masked, then zeroed) gives an all-zero output row.
// Padded query rows are computed like any other row.
//
// Two designs share these semantics.  The f32 launchers compute on the CUDA
// cores (below, first); the bf16 launchers on the tensor cores (namespace
// tc, after them).
//
// What bounds it on this card: at the encoder shapes (T ~ 400, d_k = 64)
// the score matrix per (b, h) is small and the work is ~4 T^2 d_k FLOPs
// (forward; ~10 T^2 d_k backward) against 4 T d_k elements moved, so the
// product work bounds it, and with a score bias the bias's T^2 bytes.
//
// f32 (CUDA cores): one block per (query tile of 16 rows, head, batch);
// four warps, four query rows each.  The Q tile, and K/V tiles of 32 keys,
// are staged in shared memory as f32, read straight from the (B, T, H, D)
// layout with no transpose.  Lane j scores key j of the tile against the
// warp's four query rows at once, reading 16-byte words; the softmax is
// online (flash-style), one pass: rounding P to f32 is the identity.  The
// lanes leave their four probabilities in shared memory and every lane
// accumulates output dims lane, lane + 32, lane + 64, lane + 96.
// Dropout (f32): the keep bit of element (b, h, query, key) is one word of
// a Philox4x32-10 block keyed by the call's 64-bit seed and counted by
// (query / 4, key, b * H + h, 0), word query % 4 (a warp owns four aligned
// query rows and a lane one key).  An element is kept where its word >=
// rate * 2^32 and then scaled by 1 / (1 - rate); it is applied to the
// normalised, masked P, and the row sum that normalises P counts dropped
// elements too.  `emo_attention_keep_mask` writes the same bits out as
// bytes, for holding the kernels against the plain version.
// Backward (f32): P is recomputed from the row statistic lse = max + log
// sum that the forward saves, (B, H, T) f32.  With Pd the dropped, scaled P:
//   dV = Pd^T dO,  dPd = dO V^T,  dP = keep ? dPd / (1 - rate) : 0,
//   dS = P (dP - delta) scale,  delta = rowsum(dP P) = dO . O,
//   dQ = dS K,  dK = dS^T Q,
// zero at keys >= lens (so dK and dV are zero there) and everywhere when
// lens == 0.  dQ sums over keys and dK/dV over queries, so there are two
// passes, each with the forward's geometry and a fixed sum order (no
// atomics): the first by query block writes dQ and delta, the second by key
// block dK and dV.  With a bias, d bias = dS (after the scale) is written by
// the first pass from the tile it already holds, zero at masked keys.
//
// bf16 (tensor cores, namespace tc): every product of the TPU kernel is a
// bf16 x bf16 product summed in f32 (q k^T :90-92, p.astype(v) @ v
// :106-107, pd^T dO :148-150, dO v^T :154-156, dS k and dS^T q :172-177 with
// dS rounded at :166), which is what `mma.sync.m16n8k16` computes
// (csrc/mma_bf16.cuh).  FlashAttention-2's shape, deterministic:
//  * forward: one block per (64 queries, head, batch), four warps of 16
//    rows; K/V tiles of 64 keys come by cp.async into padded shared memory,
//    double-buffered, read by ldmatrix; only tiles below lens[b] are
//    visited.  JAX rounds the *normalised* P (:107), so a first sweep finds
//    each row's max and sum (Q K^T, + bias, * scale, on the tensor cores)
//    and a second recomputes the scores, forms P in f32, drops and scales
//    it, rounds it to bf16 and feeds it from the accumulator registers
//    straight into the P V product as its A operand.
//  * backward, two passes without atomics.  Pass 1 by query tile: P from
//    the saved lse, dPd = dO V^T; delta = rowsum(dP P) in f32 takes a sweep
//    of its own over the keys (one Q K^T and one dO V^T a tile: O was formed
//    from the rounded Pd, so dO . O is another number, and the other lever,
//    an unrounded f32 copy of O from the forward, would double the
//    forward's P V products and its output bytes); the second sweep rounds
//    dS, writes d bias from its fragment and adds dQ += dS K.  Pass 2 by key
//    tile: each warp scores 16 queries against the block's 64 keys, writes
//    the rounded Pd and dS to shared memory, and the warps then take 16 keys
//    each for dV += Pd^T dO and dK += dS^T Q (ldmatrix.trans on both).
//  * the bias (B, H, T, T), f32 or bf16, is read in the score fragment's
//    layout straight from device memory (rows T elements apart have no
//    alignment for cp.async when T is odd); it and d bias bound the bias
//    variants by their bytes.
//  * dropout (bf16): a thread holds rows r and r + 8 and columns 2c, 2c + 1
//    of each n8 tile of a score accumulator, so one Philox4x32-10 block,
//    counter (8 (query / 16) + query % 8, key / 2, b * H + h, 1), gives the
//    four words of queries (q, q + 8) at keys (2k, 2k + 1): x, y, z, w in
//    the accumulator's order.  So one seed draws other bits in bf16 than in
//    f32; `emo_attention_keep_mask_bf16` exports this map.
//  * any T, any lens (0 included), D <= 128 with D % 8 == 0 (zero-padded
//    to a multiple of 16 in shared memory; two instances, D <= 64 and
//    D <= 128); padded query rows are computed and never written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kDMax = 128;
constexpr int kDChunks = kDMax / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// Philox4x32-10 (Salmon et al., SC'11): counter (c0..c3), key (k0, k1)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// the four dropout words of queries 4 * qgroup .. 4 * qgroup + 3 at `key`
__device__ __forceinline__ uint4 dropout_words(uint32_t seed_lo, uint32_t seed_hi, int bh,
                                               int qgroup, int key) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(qgroup), static_cast<uint32_t>(key),
                                  static_cast<uint32_t>(bh), 0u),
                       seed_lo, seed_hi);
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// bias element `idx`, read in the bias's own dtype: kind 1 f32, 2 bf16
enum { kBiasNone = 0, kBiasF32 = 1, kBiasBF16 = 2 };
__device__ __forceinline__ float load_bias(const void* __restrict__ bias, int kind, size_t idx) {
  return kind == kBiasF32 ? static_cast<const float*>(bias)[idx]
                          : __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[idx]);
}

// d bias element `idx`, written in the bias's dtype
__device__ __forceinline__ void store_bias(void* __restrict__ d_bias, int kind, size_t idx, float x) {
  if (kind == kBiasF32)
    static_cast<float*>(d_bias)[idx] = x;
  else
    static_cast<__nv_bfloat16*>(d_bias)[idx] = __float2bfloat16(x);
}

// Shared-memory geometry, common to the three kernels.  A block holds 16
// "owner" rows (four per warp) and visits the other side in tiles of 32
// "lane" rows (one per lane).  Depth is padded to DP, a multiple of four
// (zero-filled), so every product reads 16-byte words; owner rows lie DP
// apart (read by row, broadcast to the warp) and lane rows LK = DP + 4 apart
// (each lane reads its own row: with this stride eight lanes' 16-byte words
// fall on 32 different banks).
struct Geo {
  int D, DP, LK;
  __host__ __device__ explicit Geo(int d) : D(d), DP((d + 3) / 4 * 4), LK((d + 3) / 4 * 4 + 4) {}
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// out[i] = own[i] . mine for the warp's four owner rows (DP apart)
__device__ __forceinline__ void dots(const float* own, const float* mine, int DP,
                                     float out[kRowsPerWarp]) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) out[i] = 0.f;
  for (int d = 0; d < DP; d += 4) {
    const float4 m = *reinterpret_cast<const float4*>(mine + d);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      out[i] = dot4(*reinterpret_cast<const float4*>(own + i * DP + d), m, out[i]);
  }
}

// acc[i][c] += sum_j w[j].{x,y,z,w}[i] * rows[j][lane + 32 c]: `w` holds the
// warp's weights of the tile's 32 lane rows, one float4 (four owner rows)
// per lane row, in shared memory
__device__ __forceinline__ void accumulate(const float4* w, const float* rows, int stride, int D,
                                           int lane, float acc[kRowsPerWarp][kDChunks]) {
  for (int j = 0; j < kBK; ++j) {
    const float4 wj = w[j];
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        const float x = rows[j * stride + d];
        acc[0][c] = fmaf(wj.x, x, acc[0][c]);
        acc[1][c] = fmaf(wj.y, x, acc[1][c]);
        acc[2][c] = fmaf(wj.z, x, acc[2][c]);
        acc[3][c] = fmaf(wj.w, x, acc[3][c]);
      }
    }
  }
}

// rows t0.. of `src` (one head of a (B, T, H, D) tensor) into `dst`, `n`
// rows `stride` apart, zero where t >= limit or d >= D.  float32 rows whose
// depth is a multiple of four (and whose storage is 16-byte aligned) move
// as 16-byte words; the (row, word) of a thread's next element follows from
// its last one without a division.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, size_t base,
                                          size_t row_stride, int t0, int limit, int n, int stride,
                                          Geo g) {
  if (g.D == g.DP && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int words = g.DP / 4;  // per row
    const int step_r = kThreads / words, step_w = kThreads % words;
    int r = threadIdx.x / words, w = threadIdx.x % words;
    while (r < n) {
      const int t = t0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < limit)
        x = *reinterpret_cast<const float4*>(src + base + t * row_stride + 4 * w);
      *reinterpret_cast<float4*>(dst + r * stride + 4 * w) = x;
      r += step_r;
      w += step_w;
      if (w >= words) {
        w -= words;
        ++r;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < n * g.DP; i += kThreads) {
    const int r = i / g.DP, d = i % g.DP, t = t0 + r;
    dst[r * stride + d] = (t < limit && d < g.D) ? src[base + t * row_stride + d] : 0.f;
  }
}

__host__ __device__ inline size_t fwd_smem_floats(Geo g) {
  return static_cast<size_t>(kBQ) * g.DP + static_cast<size_t>(kBK) * (g.LK + g.DP) + kWarps * kBK * 4;
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ lens,
                     float* __restrict__ out, float* __restrict__ lse_out,
                     const void* __restrict__ bias, int bias_kind, int T_len, int H, int D,
                     float scale, uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
                     float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const Geo g(D);
  float* qs = smem;                  // [kBQ][DP] owner rows: queries
  float* ks = qs + kBQ * g.DP;       // [kBK][LK] lane rows: keys
  float* vs = ks + kBK * g.LK;       // [kBK][DP] values, read by (key, d)
  float4* ps = reinterpret_cast<float4*>(vs + kBK * g.DP);  // [kWarps][kBK]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row_stride = static_cast<size_t>(H) * D;  // between time steps
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const int len = min(max(lens[b], 0), T_len);
  // bias rows of the warp's four queries: element (b, h, t, key) at
  // bias_row + i * T_len + key
  const size_t bias_row =
      ((static_cast<size_t>(b) * H + h) * T_len + q0 + warp * kRowsPerWarp) * T_len;
  const int rows_ok = min(max(T_len - (q0 + warp * kRowsPerWarp), 0), kRowsPerWarp);

  if (len == 0) {
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
      const int t = q0 + i / D;
      if (t < T_len) out[base + t * row_stride + i % D] = (0.f);
    }
    if (lse_out != nullptr)
      for (int r = threadIdx.x; r < kBQ; r += kThreads)
        if (q0 + r < T_len) lse_out[(static_cast<size_t>(b) * H + h) * T_len + q0 + r] = 0.f;
    return;
  }

  load_rows(qs, q, base, row_stride, q0, T_len, kBQ, g.DP, g);
  const float* qs_w = qs + warp * kRowsPerWarp * g.DP;
  float4* ps_w = ps + warp * kBK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDChunks];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) acc[i][c] = 0.f;
  }

  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    load_rows(ks, k, base, row_stride, k0, len, kBK, g.LK, g);
    if (with_v) load_rows(vs, v, base, row_stride, k0, len, kBK, g.DP, g);
    __syncthreads();
  };

  // s[i] += bias[b, h, query i, key k0 + lane], before the scale
  auto add_bias = [&](float s[kRowsPerWarp], int k0, bool key_ok) {
    if (bias_kind == kBiasNone || !key_ok) return;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      if (i < rows_ok) s[i] += load_bias(bias, bias_kind, bias_row + static_cast<size_t>(i) * T_len + k0 + lane);
  };

  for (int k0 = 0; k0 < len; k0 += kBK) {
    load_tile(k0, true);
    const bool key_ok = k0 + lane < len;
    uint4 words = make_uint4(~0u, ~0u, ~0u, ~0u);
    if (threshold != 0u)
      words = dropout_words(seed_lo, seed_hi, b * H + h, (q0 >> 2) + warp, k0 + lane);
    float s[kRowsPerWarp], p[kRowsPerWarp];
    dots(qs_w, ks + lane * g.LK, g.DP, s);
    add_bias(s, k0, key_ok);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float sc = key_ok ? s[i] * scale : -INFINITY;
      const bool keep = word_of(words, i) >= threshold;
      // online softmax: rescale what is accumulated when the max grows
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float alpha = expf(m[i] - m_new);
      const float e = key_ok ? expf(sc - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(e);  // the row sum counts dropped keys
      m[i] = m_new;
      p[i] = keep ? e * inv_keep : 0.f;
#pragma unroll
      for (int c = 0; c < kDChunks; ++c) acc[i][c] *= alpha;
    }
    ps_w[lane] = make_float4(p[0], p[1], p[2], p[3]);
    __syncwarp();
    accumulate(ps_w, vs, g.DP, D, lane, acc);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = q0 + warp * kRowsPerWarp + i;
    if (t >= T_len) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[base + t * row_stride + d] = (acc[i][c] * inv);
    }
    if (lse_out != nullptr && lane == 0)
      lse_out[(static_cast<size_t>(b) * H + h) * T_len + t] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------- backward

// pass 1: 16 owner rows of q and dO, 32 lane rows of k and v, the warps'
// weights; pass 2: 16 owner rows of k and v, 32 lane rows of q and dO, two
// sets of weights, two per-lane statistics
__host__ __device__ inline size_t bwd_smem_floats(Geo g) {
  return 2 * static_cast<size_t>(kBQ) * g.DP + 2 * static_cast<size_t>(kBK) * g.LK
         + 2 * kWarps * kBK * 4 + 2 * kBK;
}

// pass 1, by query block: dQ and delta = rowsum(dP P)
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ d_o, const int* __restrict__ lens,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ delta, const void* __restrict__ bias, int bias_kind,
                        void* __restrict__ d_bias, int T_len, int H, int D, float scale,
                        uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const Geo g(D);
  float* qs = smem;                 // [kBQ][DP]
  float* dos = qs + kBQ * g.DP;     // [kBQ][DP]
  float* ks = dos + kBQ * g.DP;     // [kBK][LK]
  float* vs = ks + kBK * g.LK;      // [kBK][LK]
  float4* ws = reinterpret_cast<float4*>(vs + kBK * g.LK);  // [kWarps][kBK]: dS
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const size_t stat = (static_cast<size_t>(b) * H + h) * T_len;
  const int len = min(max(lens[b], 0), T_len);
  const size_t bias_row = (stat + q0 + warp * kRowsPerWarp) * T_len;
  const int rows_ok = min(max(T_len - (q0 + warp * kRowsPerWarp), 0), kRowsPerWarp);

  // d bias is zero at the keys no tile visits: from the first tile boundary
  // at or beyond len (all keys when len == 0) to T
  if (d_bias != nullptr)
    for (int i = 0; i < rows_ok; ++i)
      for (int key = (len + kBK - 1) / kBK * kBK + lane; key < T_len; key += 32)
        store_bias(d_bias, bias_kind, bias_row + static_cast<size_t>(i) * T_len + key, 0.f);

  if (len == 0) {
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
      const int t = q0 + i / D;
      if (t < T_len) dq[base + t * row_stride + i % D] = (0.f);
    }
    for (int r = threadIdx.x; r < kBQ; r += kThreads)
      if (q0 + r < T_len) delta[stat + q0 + r] = 0.f;
    return;
  }

  load_rows(qs, q, base, row_stride, q0, T_len, kBQ, g.DP, g);
  load_rows(dos, d_o, base, row_stride, q0, T_len, kBQ, g.DP, g);
  __syncthreads();
  const float* qs_w = qs + warp * kRowsPerWarp * g.DP;
  const float* dos_w = dos + warp * kRowsPerWarp * g.DP;
  float4* ws_w = ws + warp * kBK;

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][kDChunks];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = q0 + warp * kRowsPerWarp + i;
    lse_r[i] = t < T_len ? lse[stat + t] : 0.f;
    delta_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) acc[i][c] = 0.f;
  }

  auto load_kv = [&](int k0) {
    __syncthreads();  // the previous tile is consumed
    load_rows(ks, k, base, row_stride, k0, len, kBK, g.LK, g);
    load_rows(vs, v, base, row_stride, k0, len, kBK, g.LK, g);
    __syncthreads();
  };
  // p and dP of the warp's four rows against key k0 + lane
  auto probs = [&](int k0, float p[kRowsPerWarp], float dp[kRowsPerWarp]) {
    const bool key_ok = k0 + lane < len;
    uint4 words = make_uint4(~0u, ~0u, ~0u, ~0u);
    if (threshold != 0u)
      words = dropout_words(seed_lo, seed_hi, b * H + h, (q0 >> 2) + warp, k0 + lane);
    float s[kRowsPerWarp], dpd[kRowsPerWarp];
    dots(qs_w, ks + lane * g.LK, g.DP, s);
    dots(dos_w, vs + lane * g.LK, g.DP, dpd);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const size_t at = bias_row + static_cast<size_t>(i) * T_len + k0 + lane;
      if (bias_kind != kBiasNone && key_ok && i < rows_ok) s[i] += load_bias(bias, bias_kind, at);
      p[i] = key_ok ? expf(s[i] * scale - lse_r[i]) : 0.f;
      dp[i] = word_of(words, i) >= threshold ? dpd[i] * inv_keep : 0.f;
    }
  };

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {  // delta = rowsum(dP P) = dO . O
    const int t = q0 + warp * kRowsPerWarp + i;
    float part = 0.f;
    if (t < T_len)
      for (int d = lane; d < D; d += 32)
        part = fmaf(dos_w[i * g.DP + d], o[base + t * row_stride + d], part);
    delta_r[i] = warp_sum(part);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = q0 + warp * kRowsPerWarp + i;
    if (lane == 0 && t < T_len) delta[stat + t] = delta_r[i];
  }

  for (int k0 = 0; k0 < len; k0 += kBK) {
    load_kv(k0);
    float p[kRowsPerWarp], dp[kRowsPerWarp], ds[kRowsPerWarp];
    probs(k0, p, dp);
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      ds[i] = p[i] * (dp[i] - delta_r[i]) * scale;
      if (d_bias != nullptr && i < rows_ok && key < T_len)
        store_bias(d_bias, bias_kind, bias_row + static_cast<size_t>(i) * T_len + key, ds[i]);
    }
    ws_w[lane] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    __syncwarp();
    accumulate(ws_w, ks, g.LK, D, lane, acc);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = q0 + warp * kRowsPerWarp + i;
    if (t >= T_len) continue;
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[base + t * row_stride + d] = (acc[i][c]);
    }
  }
}

// pass 2, by key block: dK and dV
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_o,
                         const int* __restrict__ lens, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, const void* __restrict__ bias, int bias_kind,
                         int T_len, int H, int D, float scale,
                         uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const Geo g(D);
  float* ks = smem;                  // [kBQ][DP]: the block's own keys
  float* vs = ks + kBQ * g.DP;       // [kBQ][DP]
  float* qs = vs + kBQ * g.DP;       // [kBK][LK]: a tile of queries
  float* dos = qs + kBK * g.LK;      // [kBK][LK]
  float4* wp = reinterpret_cast<float4*>(dos + kBK * g.LK);  // [kWarps][kBK]: Pd
  float4* wd = wp + kWarps * kBK;                            // [kWarps][kBK]: dS
  float* lse_s = reinterpret_cast<float*>(wd + kWarps * kBK);  // [kBK]
  float* delta_s = lse_s + kBK;                                // [kBK]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const size_t stat = (static_cast<size_t>(b) * H + h) * T_len;
  const int len = min(max(lens[b], 0), T_len);

  if (k0 >= len) {  // every key of the block is masked (or lens == 0)
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
      const int t = k0 + i / D;
      if (t < T_len) {
        dk[base + t * row_stride + i % D] = (0.f);
        dv[base + t * row_stride + i % D] = (0.f);
      }
    }
    return;
  }

  load_rows(ks, k, base, row_stride, k0, len, kBQ, g.DP, g);
  load_rows(vs, v, base, row_stride, k0, len, kBQ, g.DP, g);
  const float* ks_w = ks + warp * kRowsPerWarp * g.DP;
  const float* vs_w = vs + warp * kRowsPerWarp * g.DP;
  float4* wp_w = wp + warp * kBK;
  float4* wd_w = wd + warp * kBK;

  float acc_k[kRowsPerWarp][kDChunks], acc_v[kRowsPerWarp][kDChunks];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and ks, vs are written)
    load_rows(qs, q, base, row_stride, t0, T_len, kBK, g.LK, g);
    load_rows(dos, d_o, base, row_stride, t0, T_len, kBK, g.LK, g);
    if (threadIdx.x < kBK) {
      const int t = t0 + threadIdx.x;
      lse_s[threadIdx.x] = t < T_len ? lse[stat + t] : 0.f;
      delta_s[threadIdx.x] = t < T_len ? delta[stat + t] : 0.f;
    }
    __syncthreads();
    const int tq = t0 + lane;
    const bool q_ok = tq < T_len;
    float s[kRowsPerWarp], dpd[kRowsPerWarp], pd[kRowsPerWarp], ds[kRowsPerWarp];
    dots(ks_w, qs + lane * g.LK, g.DP, s);
    dots(vs_w, dos + lane * g.LK, g.DP, dpd);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int key = k0 + warp * kRowsPerWarp + i;
      bool keep = true;
      if (threshold != 0u)
        keep = word_of(dropout_words(seed_lo, seed_hi, b * H + h, tq >> 2, key), tq & 3) >= threshold;
      if (bias_kind != kBiasNone && q_ok && key < len)
        s[i] += load_bias(bias, bias_kind, (stat + tq) * T_len + key);
      const float p = (q_ok && key < len) ? expf(s[i] * scale - lse_s[lane]) : 0.f;
      pd[i] = keep ? p * inv_keep : 0.f;
      ds[i] = p * ((keep ? dpd[i] * inv_keep : 0.f) - delta_s[lane]) * scale;
    }
    wp_w[lane] = make_float4(pd[0], pd[1], pd[2], pd[3]);
    wd_w[lane] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    __syncwarp();
    accumulate(wp_w, dos, g.LK, D, lane, acc_v);
    accumulate(wd_w, qs, g.LK, D, lane, acc_k);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = k0 + warp * kRowsPerWarp + i;
    if (t >= T_len) continue;
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[base + t * row_stride + d] = (acc_k[i][c]);
        dv[base + t * row_stride + d] = (acc_v[i][c]);
      }
    }
  }
}

// the keep bits of the dropout, one byte per (b, h, query, key)
__global__ void attention_keep_mask_kernel(uint8_t* __restrict__ out, int BH, int T_len,
                                           uint32_t seed_lo, uint32_t seed_hi,
                                           uint32_t threshold) {
  const int groups = (T_len + 3) / 4;
  const size_t n = static_cast<size_t>(BH) * groups * T_len;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int key = static_cast<int>(idx % T_len);
  const int g = static_cast<int>((idx / T_len) % groups);
  const int bh = static_cast<int>(idx / T_len / groups);
  const uint4 words = dropout_words(seed_lo, seed_hi, bh, g, key);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tq = 4 * g + i;
    if (tq < T_len)
      out[(static_cast<size_t>(bh) * T_len + tq) * T_len + key] = word_of(words, i) >= threshold;
  }
}

int launch(const void* q, const void* k, const void* v, const void* lens, void* out, void* lse,
           const void* bias, int bias_kind, int B, int T_len, int H, int D, float scale,
           uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, void* stream) {
  if (D > kDMax || D < 1 || bias_kind < kBiasNone || bias_kind > kBiasBF16
      || (bias_kind != kBiasNone && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem_floats(Geo(D)) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  attention_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<float*>(out), static_cast<float*>(lse), bias,
      bias_kind, T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
               const void* lens, const void* lse, void* dq, void* dk, void* dv, void* delta,
               const void* bias, int bias_kind, void* d_bias, int B, int T_len, int H, int D,
               float scale, uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
               float inv_keep, void* stream) {
  if (D > kDMax || D < 1 || bias_kind < kBiasNone || bias_kind > kBiasBF16
      || (bias_kind != kBiasNone && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem_floats(Geo(D)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  attention_bwd_dq_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(d_o), static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<float*>(dq), static_cast<float*>(delta), bias,
      bias_kind, d_bias, T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_o), static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), bias,
      bias_kind, T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- bf16 on the tensor cores

namespace tc {

using emo_mma::bf16;

constexpr int kBQ = 64;  // query (or key) rows per block: four warps of 16
constexpr int kBK = 64;  // keys (or queries) per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdP = kBK + 8;  // row stride of the Pd and dS tiles

// depth padded to a k-step of 16 (zeros), and the row stride of a tile
__host__ __device__ inline int depth_pad(int D) { return (D + 15) / 16 * 16; }
__host__ __device__ inline int row_ld(int D) { return depth_pad(D) + 8; }

// rows t0 .. t0+63 of one head (element (t, d) at src[base + t row_stride +
// d]) into dst, `ld` apart, by cp.async; zeros where t >= limit and in the
// depth's padding (D % 8 == 0, so a 16-byte word is all data or all pad)
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, size_t base,
                                          size_t row_stride, int t0, int limit, int D, int ld) {
  const int n = depth_pad(D) / 8;
  for (int i = threadIdx.x; i < kBQ * n; i += kThreads) {
    const int r = i / n, w = i % n, t = t0 + r;
    const bool ok = t < limit && w * 8 < D;
    emo_mma::cp_async16(dst + r * ld + w * 8,
                        ok ? src + base + static_cast<size_t>(t) * row_stride + w * 8 : src, ok);
  }
}

// the keep words of the four elements a thread holds in one n8 tile of a
// score accumulator: queries 16 q16 + j and + 8, keys 2 kp and 2 kp + 1, in
// the accumulator's order; Philox counter (8 q16 + j, kp, b H + h, 1)
__device__ __forceinline__ uint4 keep_words(uint32_t seed_lo, uint32_t seed_hi, int bh, int q16, int j,
                                            int kp) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(8 * q16 + j), static_cast<uint32_t>(kp),
                                  static_cast<uint32_t>(bh), 1u),
                       seed_lo, seed_hi);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
  return v + __shfl_xor_sync(0xFFFFFFFFu, v, 2);
}
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// s = a[m0 .. m0+15] b[0 .. 63]^T over the depth (nk k-steps of 16): the
// warp's 16 rows against the tile's 64
template <int KD>
__device__ __forceinline__ void scores(float s[8][4], const bf16* a, const bf16* b, int ld, int nk, int m0,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    if (kk < nk) {
      uint32_t af[4];
      emo_mma::load_a(af, a, ld, m0, 16 * kk, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t bf[4];
        emo_mma::load_b(bf, b, ld, 16 * n, 16 * kk, lane);
        emo_mma::mma(s[2 * n], af, bf[0], bf[1]);
        emo_mma::mma(s[2 * n + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc (16 rows x the depth) += p x: p the warp's 16 x 64 tile in registers
// (rounded to bf16 here), x the tile's 64 rows (k) of depth (n), read
// transposed
template <int KD>
__device__ __forceinline__ void times_rows(float acc[2 * KD][4], const float p[8][4], const bf16* x, int ld,
                                           int nk, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4];
    emo_mma::pack_a(af, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (n < nk) {
        uint32_t bf[4];
        emo_mma::load_b_trans(bf, x, ld, 16 * n, 16 * kk, lane);
        emo_mma::mma(acc[2 * n], af, bf[0], bf[1]);
        emo_mma::mma(acc[2 * n + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc (the warp's 16 keys m0.. x the depth) += t^T x: t a 64 x 64 tile of
// queries by keys in shared memory (kLdP apart), x the tile's 64 rows
// (queries) of depth
template <int KD>
__device__ __forceinline__ void times_rows_t(float acc[2 * KD][4], const bf16* t, const bf16* x, int ld,
                                             int nk, int m0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4];
    emo_mma::load_a_trans(af, t, kLdP, m0, 16 * kk, lane);
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (n < nk) {
        uint32_t bf[4];
        emo_mma::load_b_trans(bf, x, ld, 16 * n, 16 * kk, lane);
        emo_mma::mma(acc[2 * n], af, bf[0], bf[1]);
        emo_mma::mma(acc[2 * n + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// s = (s + bias) * scale at keys below len, -inf at the others; the
// thread's rows are q and q + 8, its keys k0 + 8 j + 2 c (+ 1)
__device__ __forceinline__ void finish_scores(float s[8][4], const void* __restrict__ bias, int bias_kind,
                                              size_t head, int T_len, int q, int k0, int len, float scale,
                                              int c) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 8 * j + 2 * c + (i & 1), t = q + 8 * (i >> 1);
      float v = s[j][i];
      if (bias_kind != kBiasNone && key < len && t < T_len)
        v += load_bias(bias, bias_kind, (head * T_len + t) * T_len + key);
      s[j][i] = key < len ? v * scale : -INFINITY;
    }
}

// p = exp(s - lse) (0 past len) in s, kf = the dropout factor (0 or
// 1 / (1 - rate)) of each element, and dP = dPd kf in dp, rounded as a
// product of its own (so that an FMA cannot fold it into dP - delta, which
// then would not cancel where P = 1)
__device__ __forceinline__ void probs(float s[8][4], float dp[8][4], float kf[8][4], const float lse_r[2], int bh,
                                      int q16, int g, int c, int k0, uint32_t seed_lo, uint32_t seed_hi,
                                      uint32_t threshold, float inv_keep) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint4 words = make_uint4(~0u, ~0u, ~0u, ~0u);
    if (threshold != 0u) words = keep_words(seed_lo, seed_hi, bh, q16, g, (k0 + 8 * j) / 2 + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = expf(s[j][i] - lse_r[i >> 1]);
      kf[j][i] = word_of(words, i) >= threshold ? inv_keep : 0.f;
      dp[j][i] = __fmul_rn(dp[j][i], kf[j][i]);
    }
  }
}

template <int KD>
__device__ __forceinline__ void zero_acc(float acc[2 * KD][4]) {
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// rows q and q + 8 of acc into out (element (t, d) at out[base + t
// row_stride + d]), below T
template <int KD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float acc[2 * KD][4], size_t base,
                                           size_t row_stride, int q, int T_len, int D, int c) {
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) {
    if (8 * j >= D) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = q + 8 * hr;
      if (t < T_len)
        *reinterpret_cast<__nv_bfloat162*>(out + base + static_cast<size_t>(t) * row_stride + 8 * j + 2 * c) =
            __floats2bfloat162_rn(acc[j][2 * hr], acc[j][2 * hr + 1]);
    }
  }
}

// zeros into rows t0 .. t0 + n - 1 (below T) of one head
__device__ __forceinline__ void zero_rows(bf16* __restrict__ out, size_t base, size_t row_stride, int t0, int n,
                                          int T_len, int D) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int t = t0 + i / D;
    if (t < T_len) out[base + static_cast<size_t>(t) * row_stride + i % D] = __float2bfloat16(0.f);
  }
}

// forward: grid (query tiles of 64, H, B)
template <int KD>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const int* __restrict__ lens, bf16* __restrict__ out, float* __restrict__ lse_out,
           const void* __restrict__ bias, int bias_kind, int T_len, int H, int D, float scale,
           uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_ld(D), nk = depth_pad(D) / 16, tile = kBQ * ld;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + tile;      // two tiles
  bf16* vs = ks + 2 * tile;  // two tiles
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int len = min(max(lens[b], 0), T_len);
  const int m0 = warp * 16, qrow = q0 + m0 + g;

  if (len == 0) {
    zero_rows(out, base, row_stride, q0, kBQ, T_len, D);
    if (lse_out != nullptr)
      for (int r = threadIdx.x; r < kBQ; r += kThreads)
        if (q0 + r < T_len) lse_out[head * T_len + q0 + r] = 0.f;
    return;
  }
  const int n_kt = (len + kBK - 1) / kBK;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, s[8][4];

  // first sweep: each row's max and sum, so that P is normalised before it
  // is rounded to bf16, as JAX rounds it
  load_rows(qs, q, base, row_stride, q0, T_len, D, ld);
  load_rows(ks, k, base, row_stride, 0, len, D, ld);
  emo_mma::cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_rows(ks + ((kt + 1) & 1) * tile, k, base, row_stride, (kt + 1) * kBK, len, D, ld);
    emo_mma::cp_async_commit();
    emo_mma::cp_async_wait<1>();
    __syncthreads();
    scores<KD>(s, qs, ks + (kt & 1) * tile, ld, nk, m0, lane);
    finish_scores(s, bias, bias_kind, head, T_len, qrow, kt * kBK, len, scale, c);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(tmax));  // finite: key kt kBK is below len
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(s[j][2 * hr] - m_new) + expf(s[j][2 * hr + 1] - m_new);
      l[hr] = l[hr] * expf(m[hr] - m_new) + quad_sum(sum);
      m[hr] = m_new;
    }
    __syncthreads();  // buffer kt & 1 is consumed
  }

  // second sweep: P = exp(s - m) / l, dropped and scaled, rounded, times V
  float acc[2 * KD][4];
  zero_acc<KD>(acc);
  load_rows(ks, k, base, row_stride, 0, len, D, ld);
  load_rows(vs, v, base, row_stride, 0, len, D, ld);
  emo_mma::cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) & 1;
      load_rows(ks + nb * tile, k, base, row_stride, (kt + 1) * kBK, len, D, ld);
      load_rows(vs + nb * tile, v, base, row_stride, (kt + 1) * kBK, len, D, ld);
    }
    emo_mma::cp_async_commit();
    emo_mma::cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * kBK;
    scores<KD>(s, qs, ks + (kt & 1) * tile, ld, nk, m0, lane);
    finish_scores(s, bias, bias_kind, head, T_len, qrow, k0, len, scale, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint4 words = make_uint4(~0u, ~0u, ~0u, ~0u);
      if (threshold != 0u)
        words = keep_words(seed_lo, seed_hi, static_cast<int>(head), (q0 + m0) >> 4, g, (k0 + 8 * j) / 2 + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[j][i] - m[i >> 1]) / l[i >> 1] * inv_keep;  // exp(-inf) = 0 past len
        s[j][i] = word_of(words, i) >= threshold ? p : 0.f;
      }
    }
    times_rows<KD>(acc, s, vs + (kt & 1) * tile, ld, nk, lane);
    __syncthreads();
  }
  store_rows<KD>(out, acc, base, row_stride, qrow, T_len, D, c);
  if (lse_out != nullptr && c == 0)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (qrow + 8 * hr < T_len) lse_out[head * T_len + qrow + 8 * hr] = m[hr] + logf(l[hr]);
}

// backward pass 1, by query tile: delta = rowsum(dP P), dQ and d bias;
// grid (query tiles of 64, H, B)
template <int KD>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ d_o, const int* __restrict__ lens, const float* __restrict__ lse,
              bf16* __restrict__ dq, float* __restrict__ delta, const void* __restrict__ bias, int bias_kind,
              void* __restrict__ d_bias, int T_len, int H, int D, float scale, uint32_t seed_lo,
              uint32_t seed_hi, uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_ld(D), nk = depth_pad(D) / 16, tile = kBQ * ld;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + tile;
  bf16* ks = dos + tile;     // two tiles
  bf16* vs = ks + 2 * tile;  // two tiles
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int len = min(max(lens[b], 0), T_len);
  const int m0 = warp * 16, qrow = q0 + m0 + g, q16 = (q0 + m0) >> 4;
  const int n_kt = (len + kBK - 1) / kBK;

  // d bias is zero at the keys no tile visits: from n_kt kBK (0 when len
  // == 0) to T
  if (d_bias != nullptr) {
    const int k_from = n_kt * kBK, width = max(T_len - k_from, 0);
    for (int i = threadIdx.x; i < kBQ * width; i += kThreads) {
      const int t = q0 + i / width, key = k_from + i % width;
      if (t < T_len) store_bias(d_bias, bias_kind, (head * T_len + t) * T_len + key, 0.f);
    }
  }
  if (len == 0) {
    zero_rows(dq, base, row_stride, q0, kBQ, T_len, D);
    for (int r = threadIdx.x; r < kBQ; r += kThreads)
      if (q0 + r < T_len) delta[head * T_len + q0 + r] = 0.f;
    return;
  }
  float lse_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) lse_r[hr] = qrow + 8 * hr < T_len ? lse[head * T_len + qrow + 8 * hr] : 0.f;

  load_rows(qs, q, base, row_stride, q0, T_len, D, ld);
  load_rows(dos, d_o, base, row_stride, q0, T_len, D, ld);
  float s[8][4], dp[8][4], kf[8][4], delta_r[2] = {0.f, 0.f}, acc[2 * KD][4];
  zero_acc<KD>(acc);
  // sweep 0 sums delta over the keys (O was formed from the rounded Pd, so
  // dO . O is not the same number); sweep 1 forms dS, d bias and dQ
  for (int sweep = 0; sweep < 2; ++sweep) {
    load_rows(ks, k, base, row_stride, 0, len, D, ld);
    load_rows(vs, v, base, row_stride, 0, len, D, ld);
    emo_mma::cp_async_commit();
    float part[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_kt; ++kt) {
      if (kt + 1 < n_kt) {
        const int nb = (kt + 1) & 1;
        load_rows(ks + nb * tile, k, base, row_stride, (kt + 1) * kBK, len, D, ld);
        load_rows(vs + nb * tile, v, base, row_stride, (kt + 1) * kBK, len, D, ld);
      }
      emo_mma::cp_async_commit();
      emo_mma::cp_async_wait<1>();
      __syncthreads();
      const int k0 = kt * kBK;
      const bf16* kb = ks + (kt & 1) * tile;
      scores<KD>(s, qs, kb, ld, nk, m0, lane);
      finish_scores(s, bias, bias_kind, head, T_len, qrow, k0, len, scale, c);
      scores<KD>(dp, dos, vs + (kt & 1) * tile, ld, nk, m0, lane);  // dPd = dO V^T
      probs(s, dp, kf, lse_r, static_cast<int>(head), q16, g, c, k0, seed_lo, seed_hi, threshold, inv_keep);
      if (sweep == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[i >> 1] = fmaf(dp[j][i], s[j][i], part[i >> 1]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ds = round_bf16(s[j][i] * (dp[j][i] - delta_r[i >> 1]) * scale);
            s[j][i] = ds;
            const int t = qrow + 8 * (i >> 1), key = k0 + 8 * j + 2 * c + (i & 1);
            if (d_bias != nullptr && t < T_len && key < T_len)
              store_bias(d_bias, bias_kind, (head * T_len + t) * T_len + key, ds);
          }
        times_rows<KD>(acc, s, kb, ld, nk, lane);  // dQ += dS K
      }
      __syncthreads();
    }
    if (sweep == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        delta_r[hr] = quad_sum(part[hr]);
        if (c == 0 && qrow + 8 * hr < T_len) delta[head * T_len + qrow + 8 * hr] = delta_r[hr];
      }
    }
  }
  store_rows<KD>(dq, acc, base, row_stride, qrow, T_len, D, c);
}

// backward pass 2, by key tile: dK = dS^T Q and dV = Pd^T dO; grid (key
// tiles of 64, H, B)
template <int KD>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ d_o, const int* __restrict__ lens, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
               const void* __restrict__ bias, int bias_kind, int T_len, int H, int D, float scale,
               uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_ld(D), nk = depth_pad(D) / 16, tile = kBQ * ld;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // the block's own keys
  bf16* vs = ks + tile;
  bf16* qs = vs + tile;          // two tiles of queries
  bf16* dos = qs + 2 * tile;     // two tiles
  bf16* pds = dos + 2 * tile;    // Pd, [query][key], kLdP apart
  bf16* dss = pds + kBQ * kLdP;  // dS, the same
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int len = min(max(lens[b], 0), T_len);
  const int m0 = warp * 16;

  if (k0 >= len) {  // every key of the block is masked (or lens == 0)
    zero_rows(dk, base, row_stride, k0, kBK, T_len, D);
    zero_rows(dv, base, row_stride, k0, kBK, T_len, D);
    return;
  }
  const int n_qt = (T_len + kBQ - 1) / kBQ;
  load_rows(ks, k, base, row_stride, k0, len, D, ld);
  load_rows(vs, v, base, row_stride, k0, len, D, ld);
  load_rows(qs, q, base, row_stride, 0, T_len, D, ld);
  load_rows(dos, d_o, base, row_stride, 0, T_len, D, ld);
  emo_mma::cp_async_commit();
  float s[8][4], dp[8][4], kf[8][4], acc_k[2 * KD][4], acc_v[2 * KD][4];
  zero_acc<KD>(acc_k);
  zero_acc<KD>(acc_v);
  for (int qt = 0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) {
      const int nb = (qt + 1) & 1;
      load_rows(qs + nb * tile, q, base, row_stride, (qt + 1) * kBQ, T_len, D, ld);
      load_rows(dos + nb * tile, d_o, base, row_stride, (qt + 1) * kBQ, T_len, D, ld);
    }
    emo_mma::cp_async_commit();
    emo_mma::cp_async_wait<1>();
    __syncthreads();
    const int t0 = qt * kBQ, qrow = t0 + m0 + g;
    const bf16* qb = qs + (qt & 1) * tile;
    const bf16* dob = dos + (qt & 1) * tile;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bool ok = qrow + 8 * hr < T_len;
      lse_r[hr] = ok ? lse[head * T_len + qrow + 8 * hr] : 0.f;
      delta_r[hr] = ok ? delta[head * T_len + qrow + 8 * hr] : 0.f;
    }
    // the warp's 16 queries against the block's 64 keys, as in pass 1
    scores<KD>(s, qb, ks, ld, nk, m0, lane);
    finish_scores(s, bias, bias_kind, head, T_len, qrow, k0, len, scale, c);
    scores<KD>(dp, dob, vs, ld, nk, m0, lane);
    probs(s, dp, kf, lse_r, static_cast<int>(head), (t0 + m0) >> 4, g, c, k0, seed_lo, seed_hi, threshold,
          inv_keep);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float pd[2], ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int i = 2 * hr + x;
          const float p = qrow + 8 * hr < T_len ? s[j][i] : 0.f;  // padded query rows add nothing
          pd[x] = p * kf[j][i];
          ds[x] = p * (dp[j][i] - delta_r[hr]) * scale;
        }
        const int at = (m0 + g + 8 * hr) * kLdP + 8 * j + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(pds + at) = __floats2bfloat162_rn(pd[0], pd[1]);
        *reinterpret_cast<__nv_bfloat162*>(dss + at) = __floats2bfloat162_rn(ds[0], ds[1]);
      }
    __syncthreads();
    // the warp's 16 keys: dV += Pd^T dO, dK += dS^T Q
    times_rows_t<KD>(acc_v, pds, dob, ld, nk, m0, lane);
    times_rows_t<KD>(acc_k, dss, qb, ld, nk, m0, lane);
    __syncthreads();
  }
  store_rows<KD>(dk, acc_k, base, row_stride, k0 + m0 + g, T_len, D, c);
  store_rows<KD>(dv, acc_v, base, row_stride, k0 + m0 + g, T_len, D, c);
}

// the keep bits of the bf16 launchers' dropout, one byte per (b, h, query,
// key): one thread per Philox block, four elements
__global__ void keep_mask_kernel(uint8_t* __restrict__ out, int BH, int T_len, uint32_t seed_lo,
                                 uint32_t seed_hi, uint32_t threshold) {
  const int groups = (T_len + 15) / 16 * 8, pairs = (T_len + 1) / 2;
  const size_t n = static_cast<size_t>(BH) * groups * pairs;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int kp = static_cast<int>(idx % pairs);
  const int grp = static_cast<int>((idx / pairs) % groups);
  const int bh = static_cast<int>(idx / pairs / groups);
  const uint4 words = keep_words(seed_lo, seed_hi, bh, grp / 8, grp % 8, kp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = (grp / 8) * 16 + grp % 8 + 8 * (i >> 1), key = 2 * kp + (i & 1);
    if (t < T_len && key < T_len)
      out[(static_cast<size_t>(bh) * T_len + t) * T_len + key] = word_of(words, i) >= threshold;
  }
}

inline size_t fwd_smem(int D) { return 5 * static_cast<size_t>(kBQ) * row_ld(D) * sizeof(bf16); }
inline size_t dq_smem(int D) { return 6 * static_cast<size_t>(kBQ) * row_ld(D) * sizeof(bf16); }
inline size_t dkv_smem(int D) {
  return (6 * static_cast<size_t>(kBQ) * row_ld(D) + 2 * static_cast<size_t>(kBQ) * kLdP) * sizeof(bf16);
}

template <int KD>
int launch_fwd(const void* q, const void* k, const void* v, const void* lens, void* out, void* lse,
               const void* bias, int bias_kind, int B, int T_len, int H, int D, float scale,
               uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, void* stream) {
  const size_t smem = fwd_smem(D);
  const cudaError_t err = cudaFuncSetAttribute(fwd_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  fwd_kernel<KD><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lens), static_cast<bf16*>(out), static_cast<float*>(lse), bias, bias_kind,
      T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <int KD>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_o, const void* lens,
               const void* lse, void* dq, void* dk, void* dv, void* delta, const void* bias, int bias_kind,
               void* d_bias, int B, int T_len, int H, int D, float scale, uint32_t seed_lo,
               uint32_t seed_hi, uint32_t threshold, float inv_keep, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_smem(D)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkv_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkv_smem(D)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bwd_dq_kernel<KD><<<grid, kThreads, dq_smem(D), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), static_cast<float*>(delta), bias, bias_kind, d_bias, T_len, H, D, scale,
      seed_lo, seed_hi, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_kernel<KD><<<grid, kThreads, dkv_smem(D), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), bias, bias_kind,
      T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int D, int bias_kind, const void* bias) {
  return D < 8 || D > kDMax || D % 8 != 0 || bias_kind < kBiasNone || bias_kind > kBiasBF16
         || (bias_kind != kBiasNone && bias == nullptr);
}

}  // namespace tc

}  // namespace

extern "C" {

// `lse` may be null (decoding); threshold 0 means no dropout; `bias` is
// (B, H, T, T) contiguous of `bias_kind` (0 none, 1 f32, 2 bf16)
int emo_attention_fwd_f32(const void* q, const void* k, const void* v, const void* lens,
                          void* out, void* lse, const void* bias, int bias_kind, int B, int T,
                          int H, int D, float scale, uint32_t seed_lo, uint32_t seed_hi,
                          uint32_t threshold, float inv_keep, void* stream) {
  return launch(q, k, v, lens, out, lse, bias, bias_kind, B, T, H, D, scale, seed_lo,
                       seed_hi, threshold, inv_keep, stream);
}

int emo_attention_fwd_bf16(const void* q, const void* k, const void* v, const void* lens,
                           void* out, void* lse, const void* bias, int bias_kind, int B, int T,
                           int H, int D, float scale, uint32_t seed_lo, uint32_t seed_hi,
                           uint32_t threshold, float inv_keep, void* stream) {
  if (tc::bad_args(D, bias_kind, bias)) return static_cast<int>(cudaErrorInvalidValue);
  return (D <= 64 ? tc::launch_fwd<4> : tc::launch_fwd<8>)(q, k, v, lens, out, lse, bias, bias_kind, B, T,
                                                            H, D, scale, seed_lo, seed_hi, threshold,
                                                            inv_keep, stream);
}

// both backward passes; `delta` is (B, H, T) f32 scratch; `d_bias` is
// (B, H, T, T) in the bias's dtype, or null (no bias, or a bias that needs
// no gradient); `o` is read in f32 only (bf16 sums delta from dP P)
int emo_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                          const void* d_o, const void* lens, const void* lse, void* dq, void* dk,
                          void* dv, void* delta, const void* bias, int bias_kind, void* d_bias,
                          int B, int T, int H, int D, float scale,
                          uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
                          float inv_keep, void* stream) {
  return launch_bwd(q, k, v, o, d_o, lens, lse, dq, dk, dv, delta, bias, bias_kind,
                           d_bias, B, T, H, D, scale, seed_lo, seed_hi, threshold, inv_keep,
                           stream);
}

int emo_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                           const void* d_o, const void* lens, const void* lse, void* dq,
                           void* dk, void* dv, void* delta, const void* bias, int bias_kind,
                           void* d_bias, int B, int T, int H, int D, float scale,
                           uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
                           float inv_keep, void* stream) {
  if (tc::bad_args(D, bias_kind, bias)) return static_cast<int>(cudaErrorInvalidValue);
  return (D <= 64 ? tc::launch_bwd<4> : tc::launch_bwd<8>)(q, k, v, d_o, lens, lse, dq, dk, dv, delta,
                                                            bias, bias_kind, d_bias, B, T, H, D, scale,
                                                            seed_lo, seed_hi, threshold, inv_keep,
                                                            stream);
}

int emo_attention_keep_mask(void* out, int B, int T, int H, uint32_t seed_lo, uint32_t seed_hi,
                            uint32_t threshold, void* stream) {
  const size_t n = static_cast<size_t>(B) * H * ((T + 3) / 4) * T;
  if (n == 0) return 0;
  const int threads = 256;
  attention_keep_mask_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), B * H, T, seed_lo, seed_hi, threshold);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 launchers' keep bits (another map of the same seed: see the note)
int emo_attention_keep_mask_bf16(void* out, int B, int T, int H, uint32_t seed_lo, uint32_t seed_hi,
                                 uint32_t threshold, void* stream) {
  const size_t n = static_cast<size_t>(B) * H * ((T + 15) / 16 * 8) * ((T + 1) / 2);
  if (n == 0) return 0;
  const int threads = 256;
  tc::keep_mask_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(static_cast<uint8_t*>(out), B * H, T, seed_lo,
                                                              seed_hi, threshold);
  return static_cast<int>(cudaGetLastError());
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
