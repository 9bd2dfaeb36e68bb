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
// What bounds it on this card: at the encoder shapes (T ~ 400, d_k = 64) the
// score matrix per (b, h) is small and the work is ~4 T^2 d_k FLOPs against
// 4 T d_k elements moved, so the product work, not memory, bounds it.  This
// first version computes on the CUDA cores in f32 (no wgmma yet).
//
// Design: one block per (query tile of 16 rows, head, batch); four warps,
// four query rows each.  The Q tile, and K/V tiles of 32 keys, are staged in
// shared memory as f32, read straight from the (B, T, H, D) layout with no
// transpose.  Lane j scores key j of the tile against the warp's four query
// rows at once, reading 16-byte words (its key row once, the query rows
// broadcast); the softmax is online (flash-style): a running max and sum
// per row, rescaling the f32 accumulators when the max grows.  Only key
// tiles below lens[b] are visited.  The lanes then leave their four
// probabilities in shared memory as one 16-byte word each, and every lane
// accumulates output dims lane, lane + 32, lane + 64, lane + 96 from the
// tile's 32 (weights, V row) pairs.
// Rounding: as in the TPU kernel, the normalised probability is rounded to
// v.dtype before it multiplies V.  For f32 that rounding is the identity,
// so f32 takes one pass with the online softmax and divides by the row sum
// at the end.  bf16 takes two passes over the keys: the first finds each
// row's max and sum, the second forms the normalised P, rounds it to bf16
// and accumulates P V, so that it rounds the same numbers JAX does (twice
// the score work, on a path that is not the f32 default).
//
// Dropout: the keep bit of element (b, h, query, key) is one word of a
// Philox4x32-10 block keyed by the call's 64-bit seed and counted by
// (query / 4, key, b * H + h), word query % 4, so every tiling, forward or
// backward, draws the same bit for the same element.  An element is kept
// where its word >= rate * 2^32 and then scaled by 1 / (1 - rate); it is
// applied to the normalised, masked P before the cast to v.dtype, and the
// row sum that normalises P counts dropped elements too.  A warp owns four
// aligned query rows and a lane one key, so one Philox block serves a
// lane's four elements.  `emo_attention_keep_mask` writes the same bits out
// as bytes, for holding the kernels against the plain version.
//
// Backward: P is recomputed from the row statistic lse = max + log
// sum that the forward saves, (B, H, T) f32.  With Pd the dropped, scaled P:
//   dV = Pd^T dO,  dPd = dO V^T,  dP = keep ? dPd / (1 - rate) : 0,
//   dS = P (dP - delta) scale,  delta = rowsum(dP P),
//   dQ = dS K,  dK = dS^T Q,
// zero at keys >= lens (so dK and dV are zero there) and everywhere when
// lens == 0.  dQ sums over keys and dK/dV over queries, so there are two
// passes, each with the forward's geometry and a fixed sum order (no
// atomics): the first by query block (16 rows; lanes are keys) writes dQ and
// delta, the second by key block (16 keys; lanes are queries) writes dK and
// dV.  About 2.5 times the forward's product work plus the two recomputed
// score products; the product work bounds it.
// Rounding in bf16, as the TPU kernel rounds: P stays f32; Pd is rounded to
// v's type before dV = Pd^T dO, and dS (after the scale) to q's type before
// dQ, dK and d bias; every product accumulates in f32, and dQ, dK, dV are
// written in the inputs' type.  In f32 delta = rowsum(dP P) is taken as
// dO . O, the same number; in bf16 O was rounded (and formed from the
// rounded Pd), so the first pass sums dP P itself over an extra sweep of
// the keys, as the TPU kernel does.
//
// With a bias the score tile is the largest operand by far (T^2 against
// T d_k elements per head), so the forward is bound by the bytes of the bias
// and the backward by those of the bias and of d bias.  The bias is read
// straight from device memory, a lane per key (rows are T elements apart and
// need no alignment); the second backward pass reads it a lane per query,
// four consecutive keys each.  d bias = dS, after the multiplication by
// `scale`, is written by the first backward pass from the tile it already
// holds, in the bias's own type, zero at masked keys.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kDMax = 128;
constexpr int kDChunks = kDMax / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round an f32 value to T's precision and back (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

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
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, size_t base,
                                          size_t row_stride, int t0, int limit, int n, int stride,
                                          Geo g) {
  if (std::is_same<T, float>::value && g.D == g.DP
      && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int words = g.DP / 4;  // per row
    const int step_r = kThreads / words, step_w = kThreads % words;
    int r = threadIdx.x / words, w = threadIdx.x % words;
    while (r < n) {
      const int t = t0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < limit)
        x = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(src) + base + t * row_stride + 4 * w);
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
    dst[r * stride + d] = (t < limit && d < g.D) ? to_float(src[base + t * row_stride + d]) : 0.f;
  }
}

__host__ __device__ inline size_t fwd_smem_floats(Geo g) {
  return static_cast<size_t>(kBQ) * g.DP + static_cast<size_t>(kBK) * (g.LK + g.DP) + kWarps * kBK * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lens,
                     T* __restrict__ out, float* __restrict__ lse_out,
                     const void* __restrict__ bias, int bias_kind, int T_len, int H, int D,
                     float scale, uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
                     float inv_keep) {
  // f32 rounds P to f32 (no-op), so it takes the one-pass online softmax;
  // a half type takes two passes (see the note at the top)
  constexpr bool kNormFirst = !std::is_same<T, float>::value;
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
      if (t < T_len) out[base + t * row_stride + i % D] = from_float<T>(0.f);
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

  if (kNormFirst) {
    // first pass: each row's max and sum, so the probabilities can be
    // normalised before rounding to T
    for (int k0 = 0; k0 < len; k0 += kBK) {
      load_tile(k0, false);
      const bool key_ok = k0 + lane < len;
      float s[kRowsPerWarp];
      dots(qs_w, ks + lane * g.LK, g.DP, s);
      add_bias(s, k0, key_ok);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float sc = key_ok ? s[i] * scale : -INFINITY;
        const float m_new = fmaxf(m[i], warp_max(sc));
        l[i] = l[i] * expf(m[i] - m_new) + warp_sum(key_ok ? expf(sc - m_new) : 0.f);
        m[i] = m_new;
      }
    }
  }

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
      if (kNormFirst) {
        p[i] = (key_ok && keep) ? round_to<T>(expf(sc - m[i]) / l[i] * inv_keep) : 0.f;
      } else {
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
    const float inv = kNormFirst ? 1.f : 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kDChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[base + t * row_stride + d] = from_float<T>(acc[i][c] * inv);
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ d_o, const int* __restrict__ lens,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        float* __restrict__ delta, const void* __restrict__ bias, int bias_kind,
                        void* __restrict__ d_bias, int T_len, int H, int D, float scale,
                        uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep) {
  // f32: delta = dO . O; a half type sums dP P over the keys (see the top)
  constexpr bool kSumDelta = !std::is_same<T, float>::value;
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
      if (t < T_len) dq[base + t * row_stride + i % D] = from_float<T>(0.f);
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

  if (kSumDelta) {
    float part[kRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < len; k0 += kBK) {
      load_kv(k0);
      float p[kRowsPerWarp], dp[kRowsPerWarp];
      probs(k0, p, dp);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) part[i] = fmaf(dp[i], p[i], part[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) delta_r[i] = warp_sum(part[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int t = q0 + warp * kRowsPerWarp + i;
      float part = 0.f;
      if (t < T_len)
        for (int d = lane; d < D; d += 32)
          part = fmaf(dos_w[i * g.DP + d], to_float(o[base + t * row_stride + d]), part);
      delta_r[i] = warp_sum(part);
    }
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
      ds[i] = round_to<T>(p[i] * (dp[i] - delta_r[i]) * scale);
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
      if (d < D) dq[base + t * row_stride + d] = from_float<T>(acc[i][c]);
    }
  }
}

// pass 2, by key block: dK and dV
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ d_o,
                         const int* __restrict__ lens, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, const void* __restrict__ bias, int bias_kind,
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
        dk[base + t * row_stride + i % D] = from_float<T>(0.f);
        dv[base + t * row_stride + i % D] = from_float<T>(0.f);
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
      pd[i] = round_to<T>(keep ? p * inv_keep : 0.f);
      ds[i] = round_to<T>(p * ((keep ? dpd[i] * inv_keep : 0.f) - delta_s[lane]) * scale);
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
        dk[base + t * row_stride + d] = from_float<T>(acc_k[i][c]);
        dv[base + t * row_stride + d] = from_float<T>(acc_v[i][c]);
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens, void* out, void* lse,
           const void* bias, int bias_kind, int B, int T_len, int H, int D, float scale,
           uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, void* stream) {
  if (D > kDMax || D < 1 || bias_kind < kBiasNone || bias_kind > kBiasBF16
      || (bias_kind != kBiasNone && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem_floats(Geo(D)) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  attention_fwd_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lens), static_cast<T*>(out), static_cast<float*>(lse), bias,
      bias_kind, T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
               const void* lens, const void* lse, void* dq, void* dk, void* dv, void* delta,
               const void* bias, int bias_kind, void* d_bias, int B, int T_len, int H, int D,
               float scale, uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
               float inv_keep, void* stream) {
  if (D > kDMax || D < 1 || bias_kind < kBiasNone || bias_kind > kBiasBF16
      || (bias_kind != kBiasNone && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem_floats(Geo(D)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  attention_bwd_dq_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(d_o), static_cast<const int*>(lens),
      static_cast<const float*>(lse), static_cast<T*>(dq), static_cast<float*>(delta), bias,
      bias_kind, d_bias, T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(d_o), static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), bias,
      bias_kind, T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `lse` may be null (decoding); threshold 0 means no dropout; `bias` is
// (B, H, T, T) contiguous of `bias_kind` (0 none, 1 f32, 2 bf16)
int emo_attention_fwd_f32(const void* q, const void* k, const void* v, const void* lens,
                          void* out, void* lse, const void* bias, int bias_kind, int B, int T,
                          int H, int D, float scale, uint32_t seed_lo, uint32_t seed_hi,
                          uint32_t threshold, float inv_keep, void* stream) {
  return launch<float>(q, k, v, lens, out, lse, bias, bias_kind, B, T, H, D, scale, seed_lo,
                       seed_hi, threshold, inv_keep, stream);
}

int emo_attention_fwd_bf16(const void* q, const void* k, const void* v, const void* lens,
                           void* out, void* lse, const void* bias, int bias_kind, int B, int T,
                           int H, int D, float scale, uint32_t seed_lo, uint32_t seed_hi,
                           uint32_t threshold, float inv_keep, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lens, out, lse, bias, bias_kind, B, T, H, D, scale,
                               seed_lo, seed_hi, threshold, inv_keep, stream);
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
  return launch_bwd<float>(q, k, v, o, d_o, lens, lse, dq, dk, dv, delta, bias, bias_kind,
                           d_bias, B, T, H, D, scale, seed_lo, seed_hi, threshold, inv_keep,
                           stream);
}

int emo_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                           const void* d_o, const void* lens, const void* lse, void* dq,
                           void* dk, void* dv, void* delta, const void* bias, int bias_kind,
                           void* d_bias, int B, int T, int H, int D, float scale,
                           uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
                           float inv_keep, void* stream) {
  return launch_bwd<__nv_bfloat16>(q, k, v, o, d_o, lens, lse, dq, dk, dv, delta, bias,
                                   bias_kind, d_bias, B, T, H, D, scale, seed_lo, seed_hi,
                                   threshold, inv_keep, stream);
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

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
