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
// Dropout: the keep bit of (b, h, query, key) is one word of a
// Philox4x32-10 block keyed by the call's 64-bit seed; an element is kept
// where its word >= rate * 2^32 and then scaled by 1 / (1 - rate), applied
// to the normalised, masked P (the row sum that normalises P counts dropped
// elements too).  Backward: P is recomputed from the row statistic lse =
// max + log sum that the forward saves, (B, H, T) f32.  With Pd the
// dropped, scaled P:
//   dV = Pd^T dO,  dPd = dO V^T,  dP = keep ? dPd / (1 - rate) : 0,
//   dS = P (dP - delta) scale,  delta = rowsum(dP P),
//   dQ = dS K,  dK = dS^T Q,  d bias = dS (after the scale),
// zero at keys >= lens (so dK, dV and d bias are zero there) and everywhere
// when lens == 0.
//
// What bounds it on this card: at the encoder shapes (T ~ 400, d_k = 64)
// the score matrix per (b, h) is small and the work is ~4 T^2 d_k FLOPs
// (forward; ~10 T^2 d_k backward) against 4 T d_k elements moved, so the
// product work bounds it, and with a score bias the bias's T^2 elements.
// So every product runs on the tensor cores (`mma.sync.m16n8k16`, bf16
// operands, f32 sums; csrc/mma_bf16.cuh), in one design with two
// arithmetics:
//  * bf16: each product of the TPU kernel is a bf16 x bf16 product summed
//    in f32 (q k^T :90-92, p.astype(v) @ v :106-107, pd^T dO :148-150, dO v^T
//    :154-156, dS k and dS^T q :172-177 with dS rounded at :166): the
//    operands as they stand, P and dS rounded where JAX rounds them.
//  * f32 (TF32 stays off): every operand of those products, the f32 P, Pd
//    and dS included, is split into three bf16 terms (x to ~2^-24 of
//    itself) and the six leading cross products (terms i + j <= 2) add into
//    one f32 sum.  tests/test_torch_kernel_arith.py (`_emulate_k4`) decided
//    the count on the CPU: with two terms and three products the forward
//    misses its 1e-5 (2-3e-5 from the plain version) and the backward keeps
//    its 1e-4 by less than half; three terms leave ~1e-6 in both.  The
//    TF32 route (3xTF32: two terms, three products at half the bf16 rate)
//    costs as many bf16-equivalent products, so it was not taken.
//
// Design, FlashAttention-2's shape, deterministic (no atomics, fixed sum
// orders: two launches give bit-identical outputs):
//  * forward: one block per (64 queries, head, batch), four warps of 16
//    rows; K/V tiles of 64 keys; only tiles below lens[b] are visited.
//    bf16: tiles by double-buffered cp.async.  JAX rounds the *normalised*
//    P (:107), so a first sweep finds each row's max and sum (Q K^T, + bias,
//    * scale) and a second recomputes the scores, forms P in f32, drops and
//    scales it, rounds it to bf16 and feeds it from the accumulator
//    registers straight into the P V product as its A operand.  f32: P is
//    not rounded, so one sweep with an online softmax; P is split in
//    registers into the A terms of P V, and the output is rescaled once at
//    the end.
//  * backward, two passes.  Pass 1 by query tile: P from lse, dPd = dO V^T,
//    dS, d bias from dS's fragment, dQ += dS K.  bf16: delta takes a sweep
//    of its own over the keys (O was formed from the rounded Pd, so dO . O
//    is another number); f32: delta = dO . O from the forward's f32 output
//    before the sweep.  Pass 2 by key tile.  bf16: each warp scores 16
//    queries against the block's 64 keys, writes the rounded Pd and dS to
//    shared memory, and the warps then take 16 keys each for dV += Pd^T dO
//    and dK += dS^T Q (ldmatrix.trans).  f32: each warp scores its 16 keys
//    against the tile's 64 queries (S^T = K Q^T), so Pd^T and dS^T come out
//    in its accumulators and enter dV and dK from the registers; the
//    dropout bits reach that transposed fragment through a bit mask (see
//    bwd_dkv_f32_kernel).
//  * f32 operands (D <= 64; the instance every shipped config takes).  A
//    tile that several warps read is held as the three bf16 planes of its
//    split (Planes) and read by ldmatrix, so that each element is split
//    once, not once a warp: the forward's block splits its Q and, a tile
//    ahead in registers, K and V; the backward's streamed tiles (K, V in
//    pass 1, Q, dO in pass 2) come from a scratch of planes that a first
//    launch writes (split_kernel).  A block's own tiles that only one warp
//    reads as its A operand (the backward's Q and dO in pass 1, K and V in
//    pass 2) stay f32 rows, split in registers (RowsA32): a third less room
//    than planes, which lets two blocks share an SM beside the bias tile.
//    For 64 < D <= 128 three planes would not fit: f32 rows (Rows32), split
//    as the fragments are read, by ldmatrix on the f32 words (an 8 x 8 b16
//    matrix is 8 rows of four floats: thread (g, c) receives depths c,
//    4 + c, 8 + c, 12 + c of its rows, at k = 2c, 2c + 1, 2c + 8, 2c + 9 of
//    the mma, a permutation of the depth within each k-step that both
//    operands share) or, where k runs along the rows, by scalar reads.  One
//    copy of each streamed tile: a second, to overlap its copy with the
//    products, costs the second block an SM, which measured slower.
//    tools/k4_parts.py times the planes and the f32 rows against each
//    other.  f32 rows move by 16-byte cp.async where D % 4 == 0 and the
//    tensor is 16-byte aligned, else by 4-byte copies.
//  * the bias (B, H, T, T): the bf16 launchers read it in the score
//    fragment's layout from device memory; the f32 launchers stage each
//    64 x 64 tile by cp.async, 16-byte words where a row's keys are
//    aligned (each staged row shifted to match) and 4-byte copies at its
//    ends; a bf16 bias read and widened by the threads.  d bias is written
//    from the dS fragment in the bias's dtype.
//  * dropout, one map for both dtypes: a thread holds rows r and r + 8 and
//    columns 2c, 2c + 1 of each n8 tile of a score accumulator, so one
//    Philox4x32-10 block, counter (8 (query / 16) + query % 8, key / 2,
//    b key_stride + h + key_offset, 1), gives the four words of queries
//    (q, q + 8) at keys (2k, 2k + 1): x, y, z, w in the accumulator's
//    order.  key_stride = H and key_offset = 0 key row b, head h as
//    themselves; a rank that holds rows b0.. and heads h0.. of a batch of
//    Hg heads passes key_stride = Hg and key_offset = b0 Hg + h0, and draws
//    the bits that the whole batch draws there.
//    `emo_attention_keep_mask` exports the map.
//  * any T, any lens (0 included), D <= 128 (bf16: D % 8 == 0), zero-padded
//    to a multiple of 16 in shared memory; two instances, D <= 64 and
//    D <= 128; padded query rows are computed and never written.  The f32
//    launchers' shared memory and scratch are accounted by the wrapper
//    (ops/attention.py::launch_geometry; `emo_attention_smem_bytes` mirrors
//    them), and a launcher refuses a kernel that does not fit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

namespace tc {

using emo_mma::bf16;

constexpr int kBQ = 64;  // query (or key) rows per block: four warps of 16
constexpr int kBK = 64;  // keys (or queries) per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDMax = 128;
constexpr int kLdP = kBK + 8;  // row stride of the Pd and dS tiles (bf16)
constexpr int kLdB = kBK + 8;  // row stride of a staged bias tile (f32)
constexpr int kTerms = 3;      // bf16 terms of a split f32 operand
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
// depth padded to a k-step of 16 (zeros), and the row stride of a tile:
// bf16 an odd multiple of 16 bytes (ldmatrix), f32 4 floats past a multiple
// of 32 (ldmatrix on the f32 words, and the scalar reads along rows)
__host__ __device__ inline int depth_pad(int D) { return cdiv(D, 16) * 16; }
__host__ __device__ inline int row_ld(int D) { return depth_pad(D) + 8; }
__host__ __device__ inline int row_ld_f32(int D) { return cdiv(D, 32) * 32 + 4; }

// bias element `idx`, read in the bias's own dtype: kind 1 f32, 2 bf16
enum { kBiasNone = 0, kBiasF32 = 1, kBiasBF16 = 2 };
__device__ __forceinline__ float load_bias(const void* __restrict__ bias, int kind, size_t idx) {
  return kind == kBiasF32 ? static_cast<const float*>(bias)[idx]
                          : __bfloat162float(static_cast<const bf16*>(bias)[idx]);
}

// d bias element `idx`, written in the bias's dtype
__device__ __forceinline__ void store_bias(void* __restrict__ d_bias, int kind, size_t idx, float x) {
  if (kind == kBiasF32)
    static_cast<float*>(d_bias)[idx] = x;
  else
    static_cast<bf16*>(d_bias)[idx] = __float2bfloat16(x);
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

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
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

// whether rows of `p`, D elements apart, move as 16-byte words
template <typename E>
__device__ __forceinline__ bool words16(const E* p, int D) {
  return D % (16 / sizeof(E)) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rows t0 .. t0+63 of one head (element (t, d) at src[base + t row_stride +
// d]) into dst, `ld` apart, by cp.async; zeros where t >= limit and in the
// depth's padding.  By 16-byte words where `vec` (a word is all data or all
// pad: D is a multiple of the word), else by 4-byte copies (f32 only)
template <typename E>
__device__ __forceinline__ void load_rows(E* dst, const E* __restrict__ src, size_t base, size_t row_stride,
                                          int t0, int limit, int D, int ld, bool vec = true) {
  const int dp = depth_pad(D);
  if (vec) {
    constexpr int kW = 16 / sizeof(E);
    const int n = dp / kW;
    for (int i = threadIdx.x; i < kBQ * n; i += kThreads) {
      const int r = i / n, w = i % n, t = t0 + r;
      const bool ok = t < limit && w * kW < D;
      emo_mma::cp_async16(dst + r * ld + w * kW, ok ? src + base + static_cast<size_t>(t) * row_stride + w * kW : src,
                          ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBQ * dp; i += kThreads) {
      const int r = i / dp, d = i % dp, t = t0 + r;
      const bool ok = t < limit && d < D;
      emo_mma::cp_async4(dst + r * ld + d, ok ? src + base + static_cast<size_t>(t) * row_stride + d : src, ok);
    }
  }
}

// floats by which the f32 bias element `at` lies past a 16-byte boundary:
// a staged row starts that far into its row of the tile, so that its
// 16-byte words land aligned
__device__ __forceinline__ int bias_shift(const void* bias, int kind, size_t at) {
  return kind == kBiasF32 ? static_cast<int>(((reinterpret_cast<uintptr_t>(bias) >> 2) + at) & 3) : 0;
}

// the 64 x 64 tile of the score bias at queries r0.., keys k0.. into dst
// (f32, rows kLdB apart, row r shifted by its bias_shift), zeros at queries
// >= T and keys >= klimit.  An f32 bias moves by cp.async: 16-byte words
// where a row's keys are 16-byte aligned, 4-byte copies at its ends (two
// threads a row); a bf16 one is read and widened by the threads
__device__ __forceinline__ void load_bias_tile(float* dst, const void* __restrict__ bias, int kind, size_t head,
                                               int T_len, int r0, int k0, int klimit) {
  if (kind == kBiasF32) {
    const float* b = static_cast<const float*>(bias);
    const int r = threadIdx.x >> 1, t = r0 + r;
    const size_t at = (head * T_len + t) * T_len + k0;
    const int sh = bias_shift(bias, kind, at), c1 = (4 - sh) & 3, nw = (kBK - c1) / 4;
    float* row = dst + r * kLdB + sh;
    const float* src = b + at;
    auto copy1 = [&](int col) {
      const bool ok = t < T_len && k0 + col < klimit;
      emo_mma::cp_async4(row + col, ok ? src + col : b, ok);
    };
    // items: c1 leading elements, nw words, then the kBK - c1 - 4 nw last elements
    for (int i = threadIdx.x & 1; i < kBK - 3 * nw; i += 2) {
      if (i < c1) {
        copy1(i);
      } else if (i < c1 + nw) {
        const int col = c1 + 4 * (i - c1);
        if (t < T_len && k0 + col + 3 < T_len) {
          const bool ok = k0 + col < klimit;
          emo_mma::cp_async16(row + col, ok ? src + col : b, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) copy1(col + e);
        }
      } else {
        copy1(c1 + 4 * nw + (i - c1 - nw));
      }
    }
  } else {
    const bf16* b = static_cast<const bf16*>(bias);
    for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, x = i % kBK, t = r0 + r, key = k0 + x;
      dst[r * kLdB + x] = t < T_len && key < klimit ? __bfloat162float(b[(head * T_len + t) * T_len + key]) : 0.f;
    }
  }
}

// s = (s + bias) * scale at keys below len, -inf at the others; the
// thread's rows are g and g + 8 (half hr = 0, 1) of its warp, its keys
// k0 + col with col = 8 j + 2 c (+ 1); bias_at(hr, col) gives the bias
template <class BiasAt>
__device__ __forceinline__ void finish_scores(float s[8][4], BiasAt bias_at, int k0, int len, float scale, int c) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 8 * j + 2 * c + (i & 1);
      s[j][i] = k0 + col < len ? (s[j][i] + bias_at(i >> 1, col)) * scale : -INFINITY;
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

__device__ __forceinline__ void store_pair(bf16* p, float x, float y, int d, int D) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);  // D % 8 == 0: both below D
}
__device__ __forceinline__ void store_pair(float* p, float x, float y, int d, int D) {
  if (d < D) p[0] = x;
  if (d + 1 < D) p[1] = y;
}

// rows q and q + 8 of acc into out (element (t, d) at out[base + t
// row_stride + d]), below T
template <int KD, typename E>
__device__ __forceinline__ void store_rows(E* __restrict__ out, const float acc[2 * KD][4], size_t base,
                                           size_t row_stride, int q, int T_len, int D, int c) {
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) {
    if (8 * j >= D) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = q + 8 * hr;
      if (t < T_len)
        store_pair(out + base + static_cast<size_t>(t) * row_stride + 8 * j + 2 * c, acc[j][2 * hr],
                   acc[j][2 * hr + 1], 8 * j + 2 * c, D);
    }
  }
}

// zeros into rows t0 .. t0 + n - 1 (below T) of one head
template <typename E>
__device__ __forceinline__ void zero_rows(E* __restrict__ out, size_t base, size_t row_stride, int t0, int n,
                                          int T_len, int D) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int t = t0 + i / D;
    if (t < T_len) out[base + static_cast<size_t>(t) * row_stride + i % D] = E(0.f);
  }
}

// ---------------------------------------------------------------- bf16

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

// the bias of the thread's rows q, q + 8 at keys k0 + col, from device memory
struct GlobalBias {
  const void* bias;
  int kind, T_len, q, k0, len;
  size_t head;
  __device__ __forceinline__ float operator()(int hr, int col) const {
    const int t = q + 8 * hr, key = k0 + col;
    return kind != kBiasNone && key < len && t < T_len ? load_bias(bias, kind, (head * T_len + t) * T_len + key)
                                                       : 0.f;
  }
};

// forward: grid (query tiles of 64, H, B)
template <int KD>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const int* __restrict__ lens, bf16* __restrict__ out, float* __restrict__ lse_out,
           const void* __restrict__ bias, int bias_kind, int T_len, int H, int D, float scale,
           uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride,
           int key_offset) {
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
  const int dkey = b * key_stride + h + key_offset;  // the dropout bits' (row, head)
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
    finish_scores(s, GlobalBias{bias, bias_kind, T_len, qrow, kt * kBK, len, head}, kt * kBK, len, scale, c);
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
    finish_scores(s, GlobalBias{bias, bias_kind, T_len, qrow, k0, len, head}, k0, len, scale, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint4 words = make_uint4(~0u, ~0u, ~0u, ~0u);
      if (threshold != 0u)
        words = keep_words(seed_lo, seed_hi, dkey, (q0 + m0) >> 4, g, (k0 + 8 * j) / 2 + c);
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
              uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride,
              int key_offset) {
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
  const int dkey = b * key_stride + h + key_offset;  // the dropout bits' (row, head)
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
      finish_scores(s, GlobalBias{bias, bias_kind, T_len, qrow, k0, len, head}, k0, len, scale, c);
      scores<KD>(dp, dos, vs + (kt & 1) * tile, ld, nk, m0, lane);  // dPd = dO V^T
      probs(s, dp, kf, lse_r, dkey, q16, g, c, k0, seed_lo, seed_hi, threshold, inv_keep);
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
               uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride,
               int key_offset) {
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
  const int dkey = b * key_stride + h + key_offset;  // the dropout bits' (row, head)
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
    finish_scores(s, GlobalBias{bias, bias_kind, T_len, qrow, k0, len, head}, k0, len, scale, c);
    scores<KD>(dp, dob, vs, ld, nk, m0, lane);
    probs(s, dp, kf, lse_r, dkey, (t0 + m0) >> 4, g, c, k0, seed_lo, seed_hi, threshold,
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

// ---------------------------------------------------------------- f32

// c += the leading cross products (terms i + j < kTerms) of a's and b's
// bf16 terms.  The tensor cores truncate each sum to its largest addend's
// precision, so the k-step's products gather in a sum of their own, the
// smallest first, which is then added to c once, rounded to nearest: c
// sees one rounding a k-step instead of a truncation a product
__device__ __forceinline__ void mma_split(float c[4], const uint32_t a[kTerms][4], const uint32_t b[kTerms][2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int order = kTerms - 1; order >= 0; --order)
#pragma unroll
    for (int i = 0; i <= order; ++i) emo_mma::mma(t, a[i], b[order - i][0], b[order - i][1]);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += t[r];
}

__device__ __forceinline__ float as_float(uint32_t x) { return __uint_as_float(x); }

// the A fragment terms of rows m0..m0+15, depth k0..k0+15 of a row-major
// f32 tile: two ldmatrix.x4 of its words give thread (g, c) depths c, 4 + c
// (first) and 8 + c, 12 + c (second) of rows g and g + 8, at k = 2c, 2c + 1,
// 2c + 8, 2c + 9 of the mma (the permutation load_b_f32 repeats)
__device__ __forceinline__ void load_a_f32(uint32_t a[kTerms][4], const float* s, int ld, int m0, int k0,
                                           int lane) {
  const int mi = lane >> 3;
  const float* p = s + (m0 + (lane & 7) + 8 * (mi & 1)) * ld + k0 + 4 * (mi >> 1);
  uint32_t x[4], y[4], t[4][kTerms];
  emo_mma::ldmatrix_x4(x, reinterpret_cast<const bf16*>(p));
  emo_mma::ldmatrix_x4(y, reinterpret_cast<const bf16*>(p + 8));
  emo_mma::split_pack<kTerms>(as_float(x[0]), as_float(x[2]), t[0]);
  emo_mma::split_pack<kTerms>(as_float(x[1]), as_float(x[3]), t[1]);
  emo_mma::split_pack<kTerms>(as_float(y[0]), as_float(y[2]), t[2]);
  emo_mma::split_pack<kTerms>(as_float(y[1]), as_float(y[3]), t[3]);
#pragma unroll
  for (int i = 0; i < kTerms; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = t[r][i];
}

// the B fragment terms of the n8 tile n0.. (rows of a [n][k] f32 tile),
// depth k0..k0+15, in load_a_f32's permutation: one ldmatrix.x4
__device__ __forceinline__ void load_b_f32(uint32_t b[kTerms][2], const float* s, int ld, int n0, int k0,
                                           int lane) {
  uint32_t x[4], t[2][kTerms];
  emo_mma::ldmatrix_x4(x, reinterpret_cast<const bf16*>(s + (n0 + (lane & 7)) * ld + k0 + 4 * (lane >> 3)));
  emo_mma::split_pack<kTerms>(as_float(x[0]), as_float(x[1]), t[0]);
  emo_mma::split_pack<kTerms>(as_float(x[2]), as_float(x[3]), t[1]);
#pragma unroll
  for (int i = 0; i < kTerms; ++i) b[i][0] = t[0][i], b[i][1] = t[1][i];
}

// the B fragment terms of the n8 tile n0.. of a [k][n] f32 tile (k along
// the rows), k0..k0+15 in the mma's own order: four scalar reads, rows 2c
// apart by ld = 4 (mod 32) floats, so the warp's 32 reads hit 32 banks
__device__ __forceinline__ void load_b_f32_trans(uint32_t b[kTerms][2], const float* s, int ld, int n0, int k0,
                                                 int lane) {
  const float* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  uint32_t t[2][kTerms];
  emo_mma::split_pack<kTerms>(p[0], p[ld], t[0]);
  emo_mma::split_pack<kTerms>(p[8 * ld], p[9 * ld], t[1]);
#pragma unroll
  for (int i = 0; i < kTerms; ++i) b[i][0] = t[0][i], b[i][1] = t[1][i];
}

// the A fragment terms of k-step kk made of accumulator tiles c0 = 2kk and
// c1 = 2kk + 1 (as emo_mma::pack_a, split instead of rounded)
__device__ __forceinline__ void split_a(uint32_t a[kTerms][4], const float c0[4], const float c1[4]) {
  uint32_t t[4][kTerms];
  emo_mma::split_pack<kTerms>(c0[0], c0[1], t[0]);
  emo_mma::split_pack<kTerms>(c0[2], c0[3], t[1]);
  emo_mma::split_pack<kTerms>(c1[0], c1[1], t[2]);
  emo_mma::split_pack<kTerms>(c1[2], c1[3], t[3]);
#pragma unroll
  for (int i = 0; i < kTerms; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = t[r][i];
}

// The ways an f32 launcher holds an operand's tile of 64 rows: each gives
// the A fragment terms of 16 rows (a) and, but RowsA32, the B fragment
// terms of two n8 tiles with k along the depth (b) or along the rows (bt),
// with one order of k within a k-step that a and b share.
//  * Planes (D <= 64): the three bf16 planes of the operand's split, rows
//    row_ld apart, read by ldmatrix; copied by cp.async from the backward's
//    scratch (split_kernel: (B, H, T, Dp) each, zeros past D), or written
//    by the forward's block (split_rows).
//  * RowsA32 (D <= 64, the backward's own tiles, below) and Rows32
//    (D <= 128): the f32 rows, split in registers as the fragments are read.
struct Src {
  const float* x;      // the f32 tensor, (B, T, H, D)
  const bf16* planes;  // its split (Planes): three planes, pstride apart
};

struct Planes {
  static constexpr bool kSplit = true;
  __host__ __device__ static int ld(int D) { return row_ld(D); }
  __host__ __device__ static size_t tile_bytes(int D) {
    return static_cast<size_t>(kTerms) * kBQ * row_ld(D) * sizeof(bf16);
  }
  __device__ static void load(unsigned char* dst, const Src& s, size_t pstride, size_t head, size_t base,
                              size_t row_stride, int T_len, int D, int t0, int limit) {
    const int dp = depth_pad(D), ld = row_ld(D);
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
      load_rows(reinterpret_cast<bf16*>(dst) + i * kBQ * ld, s.planes + i * pstride, head * T_len * dp,
                static_cast<size_t>(dp), t0, limit, dp, ld);
  }
  __device__ static const bf16* plane(const unsigned char* t, int ld, int i) {
    return reinterpret_cast<const bf16*>(t) + i * kBQ * ld;
  }
  __device__ static void a(uint32_t af[kTerms][4], const unsigned char* t, int ld, int m0, int k0, int lane) {
#pragma unroll
    for (int i = 0; i < kTerms; ++i) emo_mma::load_a(af[i], plane(t, ld, i), ld, m0, k0, lane);
  }
  __device__ static void b(uint32_t bf[2][kTerms][2], const unsigned char* t, int ld, int n0, int k0, int lane) {
#pragma unroll
    for (int i = 0; i < kTerms; ++i) {
      uint32_t x[4];
      emo_mma::load_b(x, plane(t, ld, i), ld, n0, k0, lane);
      bf[0][i][0] = x[0], bf[0][i][1] = x[1], bf[1][i][0] = x[2], bf[1][i][1] = x[3];
    }
  }
  __device__ static void bt(uint32_t bf[2][kTerms][2], const unsigned char* t, int ld, int n0, int k0, int lane) {
#pragma unroll
    for (int i = 0; i < kTerms; ++i) {
      uint32_t x[4];
      emo_mma::load_b_trans(x, plane(t, ld, i), ld, n0, k0, lane);
      bf[0][i][0] = x[0], bf[0][i][1] = x[1], bf[1][i][0] = x[2], bf[1][i][1] = x[3];
    }
  }
};

struct Rows32 {
  static constexpr bool kSplit = false;
  __host__ __device__ static int ld(int D) { return row_ld_f32(D); }
  __host__ __device__ static size_t tile_bytes(int D) { return static_cast<size_t>(kBQ) * row_ld_f32(D) * sizeof(float); }
  __device__ static void load(unsigned char* dst, const Src& s, size_t pstride, size_t head, size_t base,
                              size_t row_stride, int T_len, int D, int t0, int limit) {
    load_rows(reinterpret_cast<float*>(dst), s.x, base, row_stride, t0, limit, D, row_ld_f32(D), words16(s.x, D));
  }
  __device__ static const float* rows(const unsigned char* t) { return reinterpret_cast<const float*>(t); }
  __device__ static void a(uint32_t af[kTerms][4], const unsigned char* t, int ld, int m0, int k0, int lane) {
    load_a_f32(af, rows(t), ld, m0, k0, lane);
  }
  __device__ static void b(uint32_t bf[2][kTerms][2], const unsigned char* t, int ld, int n0, int k0, int lane) {
    load_b_f32(bf[0], rows(t), ld, n0, k0, lane);
    load_b_f32(bf[1], rows(t), ld, n0 + 8, k0, lane);
  }
  __device__ static void bt(uint32_t bf[2][kTerms][2], const unsigned char* t, int ld, int n0, int k0, int lane) {
    load_b_f32_trans(bf[0], rows(t), ld, n0, k0, lane);
    load_b_f32_trans(bf[1], rows(t), ld, n0 + 8, k0, lane);
  }
};

// A block's own tiles of f32 rows that are read only as the A operand (the
// backward at D <= 64: Q and dO in pass 1, K and V in pass 2), in place of
// their planes: a third less room, so that two blocks share an SM with the
// bias tile beside them; split in registers in the mma's own order of k,
// as Planes gives it (each warp its own rows: nothing is split twice), by
// 8-byte reads (rows 8 floats past a multiple of 32 apart: no bank
// conflicts)
struct RowsA32 {
  __host__ __device__ static int ld(int D) { return cdiv(D, 32) * 32 + 8; }
  __host__ __device__ static size_t tile_bytes(int D) { return static_cast<size_t>(kBQ) * ld(D) * sizeof(float); }
  __device__ static void load(unsigned char* dst, const Src& s, size_t pstride, size_t head, size_t base,
                              size_t row_stride, int T_len, int D, int t0, int limit) {
    load_rows(reinterpret_cast<float*>(dst), s.x, base, row_stride, t0, limit, D, ld(D), words16(s.x, D));
  }
  __device__ static void a(uint32_t af[kTerms][4], const unsigned char* t, int ld, int m0, int k0, int lane) {
    const float* p = reinterpret_cast<const float*>(t) + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    const float2 x[4] = {*reinterpret_cast<const float2*>(p), *reinterpret_cast<const float2*>(p + 8 * ld),
                         *reinterpret_cast<const float2*>(p + 8), *reinterpret_cast<const float2*>(p + 8 * ld + 8)};
    uint32_t terms[4][kTerms];
#pragma unroll
    for (int r = 0; r < 4; ++r) emo_mma::split_pack<kTerms>(x[r].x, x[r].y, terms[r]);
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) af[i][r] = terms[r][i];
  }
};

// s = a[m0 .. m0+15] b[0 .. 63]^T over the depth (nk k-steps of 16), both
// operands split (a read as OpA holds it, b as OpB)
template <int KD, class OpA, class OpB>
__device__ __forceinline__ void scores_split(float s[8][4], const unsigned char* a, int lda, const unsigned char* b,
                                             int ldb, int nk, int m0, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    if (kk < nk) {
      uint32_t af[kTerms][4];
      OpA::a(af, a, lda, m0, 16 * kk, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t bf[2][kTerms][2];
        OpB::b(bf, b, ldb, 16 * n, 16 * kk, lane);
        mma_split(s[2 * n], af, bf[0]);
        mma_split(s[2 * n + 1], af, bf[1]);
      }
    }
  }
}

// acc (16 rows x the depth) += p x: p the warp's 16 x 64 tile in registers,
// x the tile's 64 rows (k) of depth (n), both split
template <int KD, class Op>
__device__ __forceinline__ void times_rows_split(float acc[2 * KD][4], const float p[8][4], const unsigned char* x,
                                                 int ld, int nk, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[kTerms][4];
    split_a(af, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (n < nk) {
        uint32_t bf[2][kTerms][2];
        Op::bt(bf, x, ld, 16 * n, 16 * kk, lane);
        mma_split(acc[2 * n], af, bf[0]);
        mma_split(acc[2 * n + 1], af, bf[1]);
      }
    }
  }
}

// the bias of the thread's rows (g, g + 8 of its warp) in a staged tile
struct StagedBias {
  const float* rows[2];  // rows g and g + 8, at their shifts
  bool on;
  __device__ __forceinline__ float operator()(int hr, int col) const { return on ? rows[hr][col] : 0.f; }
};

// the StagedBias of tile rows `row`, `row` + 8 (bias rows r0 +
// row.., keys k0..); without a bias it points at `any`, memory that is
// there, and is never read
__device__ __forceinline__ StagedBias staged_bias(const float* bs, int row, const void* bias, int kind, size_t head,
                                                  int T_len, int r0, int k0, const void* any) {
  if (kind == kBiasNone) return StagedBias{{static_cast<const float*>(any), static_cast<const float*>(any)}, false};
  const float* base = bs + row * kLdB;
  const size_t at = (head * T_len + r0 + row) * T_len + k0;
  return StagedBias{{base + bias_shift(bias, kind, at), base + 8 * kLdB + bias_shift(bias, kind, at + 8 * T_len)},
                    true};
}

// Shared memory of the f32 kernels: tiles of 64 rows (Op), the block's own
// (Q; pass 1 also dO; pass 2 K and V) and the streamed ones (K and V; pass
// 2 Q and dO), the bias tile (f32, kLdB apart) and, in pass 2, the
// streamed queries' lse and delta and a warp's 64 x 16 keep bits; one
// copy of each streamed tile (the source note says why)
enum { kFwd = 0, kDq = 1, kDkv = 2 };
template <class Op, class Own = Op>
__host__ __device__ inline size_t f32_smem(int kind, int D, bool with_bias) {
  const size_t tile = Op::tile_bytes(D);
  const size_t bias_tile = with_bias ? static_cast<size_t>(kBQ) * kLdB * sizeof(float) : 0;
  const size_t own = kind == kFwd ? tile : 2 * Own::tile_bytes(D);
  const size_t stats = kind == kDkv ? 2 * kBQ * sizeof(float) : 0;
  const size_t masks = kind == kDkv ? static_cast<size_t>(kWarps) * kBQ * sizeof(uint16_t) : 0;
  return own + 2 * tile + bias_tile + stats + masks;
}

// the operands of one launch, as Src by index (q, k, v, dO)
struct Operands {
  const float* x[4];
  const bf16* planes;  // operand i's three planes from planes + 3 i pstride
  size_t pstride;
  __device__ Src operator[](int i) const { return Src{x[i], planes == nullptr ? nullptr : planes + 3 * i * pstride}; }
};

// the three bf16 terms of each f32 operand (blockIdx.y: q, k, v, dO) into
// its planes, (B, H, T, Dp) each, zero past D: four elements a thread (a
// 16-byte read where `vec`), indices in `Index` (32 bits where they fit)
template <typename Index>
__global__ void split_kernel(Operands ops, bf16* __restrict__ out, int B, int T_len, int H, int D, bool vec) {
  const int quads = depth_pad(D) / 4;
  const Index n = static_cast<Index>(B) * H * T_len * quads;
  const Index idx = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int d = 4 * static_cast<int>(idx % quads);
  const Index row = idx / quads;  // (b H + h) T + t
  const int t = static_cast<int>(row % T_len), bh = static_cast<int>(row / T_len);
  const float* x = ops.x[blockIdx.y] + ((static_cast<size_t>(bh / H) * T_len + t) * H + bh % H) * D + d;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec && d < D) {
    v = *reinterpret_cast<const float4*>(x);
  } else if (d < D) {
    v.x = x[0];
    v.y = d + 1 < D ? x[1] : 0.f;
    v.z = d + 2 < D ? x[2] : 0.f;
    v.w = d + 3 < D ? x[3] : 0.f;
  }
  uint32_t lo[kTerms], hi[kTerms];
  emo_mma::split_pack<kTerms>(v.x, v.y, lo);
  emo_mma::split_pack<kTerms>(v.z, v.w, hi);
  bf16* dst = out + 3 * blockIdx.y * ops.pstride + static_cast<size_t>(row) * (4 * quads) + d;
#pragma unroll
  for (int i = 0; i < kTerms; ++i) *reinterpret_cast<uint2*>(dst + i * ops.pstride) = make_uint2(lo[i], hi[i]);
}

// the online softmax of one tile of scores in s (-inf past len): the row
// max m and sum l move on, the accumulated output is rescaled, and s turns
// into exp(s - m), dropped and scaled (the row sum counts dropped keys)
template <int KD>
__device__ __forceinline__ void softmax_step(float s[8][4], float m[2], float l[2], float acc[2 * KD][4], int bh,
                                             int q16, int g, int c, int k0, uint32_t seed_lo, uint32_t seed_hi,
                                             uint32_t threshold, float inv_keep) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
    const float m_new = fmaxf(m[hr], quad_max(tmax));  // finite: key k0 is below len
    const float alpha = expf(m[hr] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][2 * hr] = expf(s[j][2 * hr] - m_new);  // 0 past len
      s[j][2 * hr + 1] = expf(s[j][2 * hr + 1] - m_new);
      sum += s[j][2 * hr] + s[j][2 * hr + 1];
    }
    l[hr] = l[hr] * alpha + quad_sum(sum);
    m[hr] = m_new;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) acc[n][2 * hr] *= alpha, acc[n][2 * hr + 1] *= alpha;
  }
  if (threshold != 0u) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 words = keep_words(seed_lo, seed_hi, bh, q16, g, (k0 + 8 * j) / 2 + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = word_of(words, i) >= threshold ? s[j][i] * inv_keep : 0.f;
    }
  }
}

// the output rows q, q + 8 (acc over the row sums) and their lse
template <int KD>
__device__ __forceinline__ void finish_rows(float* __restrict__ out, float* __restrict__ lse_out, float acc[2 * KD][4],
                                            const float m[2], const float l[2], size_t base, size_t row_stride,
                                            size_t head, int q, int T_len, int D, int c) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float inv = 1.f / l[hr];
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) acc[n][2 * hr] *= inv, acc[n][2 * hr + 1] *= inv;
  }
  store_rows<KD>(out, acc, base, row_stride, q, T_len, D, c);
  if (lse_out != nullptr && c == 0)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (q + 8 * hr < T_len) lse_out[head * T_len + q + 8 * hr] = m[hr] + logf(l[hr]);
}

// A thread's share of a tile of 64 rows of an f32 operand with D <= 64, in
// registers: kQuads quads of four depths (zeros past D and past `limit`),
// fetched a tile ahead and then split by `split_rows` into the tile's
// three bf16 planes
constexpr int kQuads = kBQ * 64 / 4 / kThreads;

__device__ __forceinline__ void fetch_rows(float4 reg[kQuads], const float* __restrict__ x, size_t base,
                                           size_t row_stride, int t0, int limit, int D, bool vec) {
  const int quads = depth_pad(D) / 4;
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / quads, d = 4 * (idx % quads), t = t0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < kBQ && t < limit && d < D) {
      const float* p = x + base + static_cast<size_t>(t) * row_stride + d;
      if (vec) {
        v = *reinterpret_cast<const float4*>(p);
      } else {
        v.x = p[0];
        v.y = d + 1 < D ? p[1] : 0.f;
        v.z = d + 2 < D ? p[2] : 0.f;
        v.w = d + 3 < D ? p[3] : 0.f;
      }
    }
    reg[i] = v;
  }
}

__device__ __forceinline__ void split_rows(unsigned char* tile, const float4 reg[kQuads], int D) {
  const int quads = depth_pad(D) / 4, ld = row_ld(D);
  bf16* p = reinterpret_cast<bf16*>(tile);
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / quads, d = 4 * (idx % quads);
    if (r < kBQ) {
      uint32_t lo[kTerms], hi[kTerms];
      emo_mma::split_pack<kTerms>(reg[i].x, reg[i].y, lo);
      emo_mma::split_pack<kTerms>(reg[i].z, reg[i].w, hi);
#pragma unroll
      for (int term = 0; term < kTerms; ++term)
        *reinterpret_cast<uint2*>(p + (term * kBQ + r) * ld + d) = make_uint2(lo[term], hi[term]);
    }
  }
}

// forward, the D <= 64 instance: each block splits every element of Q,
// and of each tile of K and V, once into the three bf16 planes its four
// warps read (Planes), the next tile's K and V waiting in registers while
// this one is multiplied; one copy of the bias tile, so that two blocks
// share an SM.  grid (query tiles of 64, H, B)
template <int KD>
__global__ void __launch_bounds__(kThreads)
fwd_f32_split_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const int* __restrict__ lens, float* __restrict__ out, float* __restrict__ lse_out,
                     const void* __restrict__ bias, int bias_kind, int T_len, int H, int D, float scale,
                     uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride,
                     int key_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_ld(D), nk = depth_pad(D) / 16;
  const size_t tile = Planes::tile_bytes(D);
  const bool with_bias = bias_kind != kBiasNone;
  unsigned char* qs = smem_raw;
  unsigned char* ks = qs + tile;
  unsigned char* vs = ks + tile;
  float* bs = reinterpret_cast<float*>(vs + tile);  // the bias tile
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int dkey = b * key_stride + h + key_offset;  // the dropout bits' (row, head)
  const int len = min(max(lens[b], 0), T_len);
  const int m0 = warp * 16, qrow = q0 + m0 + g;

  if (len == 0) {
    zero_rows(out, base, row_stride, q0, kBQ, T_len, D);
    if (lse_out != nullptr)
      for (int r = threadIdx.x; r < kBQ; r += kThreads)
        if (q0 + r < T_len) lse_out[head * T_len + q0 + r] = 0.f;
    return;
  }
  const int n_kt = cdiv(len, kBK);
  const bool vk = words16(k, D), vv = words16(v, D);
  float4 rk[kQuads], rv[kQuads];
  fetch_rows(rk, q, base, row_stride, q0, T_len, D, words16(q, D));
  split_rows(qs, rk, D);
  fetch_rows(rk, k, base, row_stride, 0, len, D, vk);
  fetch_rows(rv, v, base, row_stride, 0, len, D, vv);
  if (with_bias) load_bias_tile(bs, bias, bias_kind, head, T_len, q0, 0, len);
  emo_mma::cp_async_commit();
  split_rows(ks, rk, D);
  split_rows(vs, rv, D);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, s[8][4], acc[2 * KD][4];
  zero_acc<KD>(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (kt + 1 < n_kt) {  // in flight while this tile is multiplied
      fetch_rows(rk, k, base, row_stride, k0 + kBK, len, D, vk);
      fetch_rows(rv, v, base, row_stride, k0 + kBK, len, D, vv);
    }
    emo_mma::cp_async_wait<0>();
    __syncthreads();
    scores_split<KD, Planes, Planes>(s, qs, ld, ks, ld, nk, m0, lane);
    finish_scores(s, staged_bias(bs, m0 + g, bias, bias_kind, head, T_len, q0, k0, qs), k0, len, scale, c);
    softmax_step<KD>(s, m, l, acc, dkey, (q0 + m0) >> 4, g, c, k0, seed_lo, seed_hi, threshold,
                     inv_keep);
    times_rows_split<KD, Planes>(acc, s, vs, ld, nk, lane);
    __syncthreads();  // the planes and the bias tile are consumed
    if (kt + 1 < n_kt) {
      split_rows(ks, rk, D);
      split_rows(vs, rv, D);
      if (with_bias) load_bias_tile(bs, bias, bias_kind, head, T_len, q0, k0 + kBK, len);
      emo_mma::cp_async_commit();
    }
  }
  finish_rows<KD>(out, lse_out, acc, m, l, base, row_stride, head, qrow, T_len, D, c);
}

// forward, the D <= 128 instance (Rows32): grid (query tiles of 64, H, B)
template <int KD>
__global__ void __launch_bounds__(kThreads)
fwd_f32_kernel(Operands ops, const int* __restrict__ lens, float* __restrict__ out, float* __restrict__ lse_out,
               const void* __restrict__ bias, int bias_kind, int T_len, int H, int D, float scale,
               uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride,
               int key_offset) {
  using Op = Rows32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = Op::ld(D), nk = depth_pad(D) / 16;
  const size_t tile = Op::tile_bytes(D);
  const bool with_bias = bias_kind != kBiasNone;
  unsigned char* qs = smem_raw;
  unsigned char* ks = qs + tile;
  unsigned char* vs = ks + tile;
  float* bs = reinterpret_cast<float*>(vs + tile);  // the bias tile
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int dkey = b * key_stride + h + key_offset;  // the dropout bits' (row, head)
  const int len = min(max(lens[b], 0), T_len);
  const int m0 = warp * 16, qrow = q0 + m0 + g;

  if (len == 0) {
    zero_rows(out, base, row_stride, q0, kBQ, T_len, D);
    if (lse_out != nullptr)
      for (int r = threadIdx.x; r < kBQ; r += kThreads)
        if (q0 + r < T_len) lse_out[head * T_len + q0 + r] = 0.f;
    return;
  }
  const int n_kt = cdiv(len, kBK);
  auto load = [&](unsigned char* dst, int i, int t0, int limit) {
    Op::load(dst, ops[i], ops.pstride, head, base, row_stride, T_len, D, t0, limit);
  };
  load(qs, 0, q0, T_len);

  // one sweep, online softmax: P is not rounded, so exp(s - running max)
  // enters P V unnormalised and the output is divided by the row sum once
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, s[8][4], acc[2 * KD][4];
  zero_acc<KD>(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    load(ks, 1, k0, len);
    load(vs, 2, k0, len);
    if (with_bias) load_bias_tile(bs, bias, bias_kind, head, T_len, q0, k0, len);
    emo_mma::cp_async_commit();
    emo_mma::cp_async_wait<0>();
    __syncthreads();
    scores_split<KD, Op, Op>(s, qs, ld, ks, ld, nk, m0, lane);
    finish_scores(s, staged_bias(bs, m0 + g, bias, bias_kind, head, T_len, q0, k0, qs), k0, len, scale, c);
    softmax_step<KD>(s, m, l, acc, dkey, (q0 + m0) >> 4, g, c, k0, seed_lo, seed_hi, threshold,
                     inv_keep);
    times_rows_split<KD, Op>(acc, s, vs, ld, nk, lane);
    __syncthreads();  // the tiles are consumed
  }
  finish_rows<KD>(out, lse_out, acc, m, l, base, row_stride, head, qrow, T_len, D, c);
}

// backward pass 1, by query tile: delta = dO . O, dQ and d bias; the
// block's Q and dO held as Own, the streamed K and V as Op.  grid (query
// tiles of 64, H, B)
template <int KD, class Op, class Own>
__global__ void __launch_bounds__(kThreads)
bwd_dq_f32_kernel(Operands ops, const float* __restrict__ o, const int* __restrict__ lens,
                  const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta,
                  const void* __restrict__ bias, int bias_kind, void* __restrict__ d_bias, int T_len, int H, int D,
                  float scale, uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride,
                  int key_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = Op::ld(D), ldo = Own::ld(D), nk = depth_pad(D) / 16;
  const size_t tile = Op::tile_bytes(D);
  const bool with_bias = bias_kind != kBiasNone;
  unsigned char* qs = smem_raw;
  unsigned char* dos = qs + Own::tile_bytes(D);
  unsigned char* ks = dos + Own::tile_bytes(D);
  unsigned char* vs = ks + tile;
  float* bs = reinterpret_cast<float*>(vs + tile);  // the bias tile
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int dkey = b * key_stride + h + key_offset;  // the dropout bits' (row, head)
  const int len = min(max(lens[b], 0), T_len);
  const int m0 = warp * 16, qrow = q0 + m0 + g, q16 = (q0 + m0) >> 4;
  const int n_kt = cdiv(len, kBK);

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
  auto load = [&](unsigned char* dst, int i, int t0, int limit) {
    Op::load(dst, ops[i], ops.pstride, head, base, row_stride, T_len, D, t0, limit);
  };
  Own::load(qs, ops[0], ops.pstride, head, base, row_stride, T_len, D, q0, T_len);
  Own::load(dos, ops[3], ops.pstride, head, base, row_stride, T_len, D, q0, T_len);
  // delta = rowsum(dP P) = dO . O, from the f32 dO and the forward's f32
  // output: the quad of row g sums depths c, c + 4, ... in a fixed order
  const float* d_o = ops.x[3];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = qrow + 8 * hr;
    float part = 0.f;
    if (t < T_len) {
      const size_t at = base + static_cast<size_t>(t) * row_stride;
      for (int d = c; d < D; d += 4) part = fmaf(d_o[at + d], o[at + d], part);
    }
    delta_r[hr] = quad_sum(part);
    lse_r[hr] = t < T_len ? lse[head * T_len + t] : 0.f;
    if (c == 0 && t < T_len) delta[head * T_len + t] = delta_r[hr];
  }

  float s[8][4], dp[8][4], kf[8][4], acc[2 * KD][4];
  zero_acc<KD>(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    load(ks, 1, k0, len);
    load(vs, 2, k0, len);
    if (with_bias) load_bias_tile(bs, bias, bias_kind, head, T_len, q0, k0, len);
    emo_mma::cp_async_commit();
    emo_mma::cp_async_wait<0>();
    __syncthreads();
    scores_split<KD, Own, Op>(s, qs, ldo, ks, ld, nk, m0, lane);
    finish_scores(s, staged_bias(bs, m0 + g, bias, bias_kind, head, T_len, q0, k0, qs), k0, len, scale, c);
    scores_split<KD, Own, Op>(dp, dos, ldo, vs, ld, nk, m0, lane);  // dPd = dO V^T
    probs(s, dp, kf, lse_r, dkey, q16, g, c, k0, seed_lo, seed_hi, threshold, inv_keep);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = s[j][i] * (dp[j][i] - delta_r[i >> 1]) * scale;
        s[j][i] = ds;
        const int t = qrow + 8 * (i >> 1), key = k0 + 8 * j + 2 * c + (i & 1);
        if (d_bias != nullptr && t < T_len && key < T_len)
          store_bias(d_bias, bias_kind, (head * T_len + t) * T_len + key, ds);
      }
    times_rows_split<KD, Op>(acc, s, ks, ld, nk, lane);  // dQ += dS K
    __syncthreads();  // the tiles are consumed
  }
  store_rows<KD>(dq, acc, base, row_stride, qrow, T_len, D, c);
}

// backward pass 2, by key tile: dK = dS^T Q and dV = Pd^T dO.  Each warp
// owns 16 of the block's 64 keys and forms their rows of P^T, Pd^T and dS^T
// (keys by a tile's 64 queries) in its accumulators, which enter the dV and
// dK products as their A operand from the registers.  A thread's dropout
// bits there come from Philox blocks that cover other elements (the map is
// the forward's: queries (q, q + 8) by keys (2k, 2k + 1)), so each warp
// draws the blocks of its keys in the forward's arrangement and passes the
// bits through a 64 x 16 bit mask in shared memory.  The block's K and V
// are held as Own, the streamed Q and dO as Op.  grid (key tiles of 64, H,
// B)
template <int KD, class Op, class Own>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_f32_kernel(Operands ops, const int* __restrict__ lens, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                   const void* __restrict__ bias, int bias_kind, int T_len, int H, int D, float scale,
                   uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride,
                   int key_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = Op::ld(D), ldo = Own::ld(D), nk = depth_pad(D) / 16;
  const size_t tile = Op::tile_bytes(D);
  const bool with_bias = bias_kind != kBiasNone;
  unsigned char* ks = smem_raw;  // the block's own keys
  unsigned char* vs = ks + Own::tile_bytes(D);
  unsigned char* qs = vs + Own::tile_bytes(D);  // a tile of queries
  unsigned char* dos = qs + tile;
  float* bs = reinterpret_cast<float*>(dos + tile);               // the bias tile, [query][key]
  float* lse_s = bs + (with_bias ? kBQ * kLdB : 0);               // the tile's queries' lse
  float* delta_s = lse_s + kBQ;                                   // and delta
  uint16_t* masks = reinterpret_cast<uint16_t*>(delta_s + kBQ);  // a warp's keep bits, [query][key]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row_stride + static_cast<size_t>(h) * D;
  const size_t head = static_cast<size_t>(b) * H + h;
  const int dkey = b * key_stride + h + key_offset;  // the dropout bits' (row, head)
  const int len = min(max(lens[b], 0), T_len);
  const int m0 = warp * 16, key0 = k0 + m0 + g;  // the thread's keys key0, key0 + 8

  if (k0 >= len) {  // every key of the block is masked (or lens == 0)
    zero_rows(dk, base, row_stride, k0, kBK, T_len, D);
    zero_rows(dv, base, row_stride, k0, kBK, T_len, D);
    return;
  }
  const int n_qt = cdiv(T_len, kBQ);
  auto load = [&](unsigned char* dst, int i, int t0, int limit) {
    Op::load(dst, ops[i], ops.pstride, head, base, row_stride, T_len, D, t0, limit);
  };
  Own::load(ks, ops[1], ops.pstride, head, base, row_stride, T_len, D, k0, len);
  Own::load(vs, ops[2], ops.pstride, head, base, row_stride, T_len, D, k0, len);
  float s[8][4], dp[8][4], acc_k[2 * KD][4], acc_v[2 * KD][4];
  zero_acc<KD>(acc_k);
  zero_acc<KD>(acc_v);
  uint16_t* wmask = masks + warp * kBQ;
  // the bias at query row qc of the tile starts (s0 + qc T) mod 4 floats
  // into its row (load_bias_tile; 0 for a bf16 bias)
  const int t_mod = bias_kind == kBiasF32 ? T_len & 3 : 0;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int t0 = qt * kBQ;
    load(qs, 0, t0, T_len);
    load(dos, 3, t0, T_len);
    if (with_bias) load_bias_tile(bs, bias, bias_kind, head, T_len, t0, k0, len);
    {
      const int x = threadIdx.x & (kBQ - 1), t = t0 + x;  // threads 0-63 lse, 64-127 delta
      const float* src = threadIdx.x < kBQ ? lse : delta;
      emo_mma::cp_async4(lse_s + threadIdx.x, t < T_len ? src + head * T_len + t : src, t < T_len);
    }
    emo_mma::cp_async_commit();
    emo_mma::cp_async_wait<0>();
    __syncthreads();
    const int s0 = with_bias ? bias_shift(bias, bias_kind, (head * T_len + t0) * T_len + k0) : 0;
    // the warp's 16 keys against the tile's 64 queries: S^T, dPd^T
    scores_split<KD, Own, Op>(s, ks, ldo, qs, ld, nk, m0, lane);
    scores_split<KD, Own, Op>(dp, vs, ldo, dos, ld, nk, m0, lane);
    if (threshold != 0u) {  // lane l: queries qa = 16 (l / 8) + l % 8 and qa + 8, the warp's 8 key pairs
      const int qa = 16 * (lane >> 3) + (lane & 7);
      uint32_t ma = 0, mb = 0;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint4 w = keep_words(seed_lo, seed_hi, dkey, (t0 >> 4) + (lane >> 3), lane & 7,
                                   (k0 + m0) / 2 + p);
        ma |= (static_cast<uint32_t>(w.x >= threshold) | static_cast<uint32_t>(w.y >= threshold) << 1) << (2 * p);
        mb |= (static_cast<uint32_t>(w.z >= threshold) | static_cast<uint32_t>(w.w >= threshold) << 1) << (2 * p);
      }
      wmask[qa] = static_cast<uint16_t>(ma);
      wmask[qa + 8] = static_cast<uint16_t>(mb);
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * c;  // the thread's queries t0 + col, + 1
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
      const uint32_t bits = threshold != 0u ? *reinterpret_cast<const uint32_t*>(wmask + col) : ~0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = col + (i & 1), key = key0 + 8 * (i >> 1);
        float sc = s[j][i];
        if (with_bias) sc += bs[qc * kLdB + ((s0 + qc * t_mod) & 3) + m0 + g + 8 * (i >> 1)];
        sc = key < len ? sc * scale : -INFINITY;
        const float p = t0 + qc < T_len ? expf(sc - ((i & 1) ? ls.y : ls.x)) : 0.f;  // padded queries add nothing
        const float kf = (bits >> ((i & 1) * 16 + g + 8 * (i >> 1))) & 1u ? inv_keep : 0.f;
        // dP kept apart by its own rounding (see `probs`)
        dp[j][i] = p * (__fmul_rn(dp[j][i], kf) - ((i & 1) ? dl.y : dl.x)) * scale;  // dS^T
        s[j][i] = p * kf;                                                             // Pd^T
      }
    }
    times_rows_split<KD, Op>(acc_v, s, dos, ld, nk, lane);  // dV += Pd^T dO
    times_rows_split<KD, Op>(acc_k, dp, qs, ld, nk, lane);  // dK += dS^T Q
    __syncthreads();  // the tiles and the masks are consumed
  }
  store_rows<KD>(dk, acc_k, base, row_stride, k0 + m0 + g, T_len, D, c);
  store_rows<KD>(dv, acc_v, base, row_stride, k0 + m0 + g, T_len, D, c);
}

// the keep bits of the dropout, one byte per (b, h, query, key): one thread
// per Philox block, four elements
__global__ void keep_mask_kernel(uint8_t* __restrict__ out, int BH, int T_len, uint32_t seed_lo,
                                 uint32_t seed_hi, uint32_t threshold, int H, int key_stride, int key_offset) {
  const int groups = (T_len + 15) / 16 * 8, pairs = (T_len + 1) / 2;
  const size_t n = static_cast<size_t>(BH) * groups * pairs;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int kp = static_cast<int>(idx % pairs);
  const int grp = static_cast<int>((idx / pairs) % groups);
  const int bh = static_cast<int>(idx / pairs / groups);
  const uint4 words = keep_words(seed_lo, seed_hi, bh / H * key_stride + bh % H + key_offset, grp / 8, grp % 8, kp);
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
               uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride,
               int key_offset, void* stream) {
  const size_t smem = fwd_smem(D);
  const cudaError_t err = cudaFuncSetAttribute(fwd_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  fwd_kernel<KD><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lens), static_cast<bf16*>(out), static_cast<float*>(lse), bias, bias_kind,
      T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep, key_stride, key_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int KD>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_o, const void* lens,
               const void* lse, void* dq, void* dk, void* dv, void* delta, const void* bias, int bias_kind,
               void* d_bias, int B, int T_len, int H, int D, float scale, uint32_t seed_lo,
               uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride, int key_offset, void* stream) {
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
      seed_lo, seed_hi, threshold, inv_keep, key_stride, key_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_kernel<KD><<<grid, kThreads, dkv_smem(D), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), bias, bias_kind,
      T_len, H, D, scale, seed_lo, seed_hi, threshold, inv_keep, key_stride, key_offset);
  return static_cast<int>(cudaGetLastError());
}

// the f32 launchers: a kernel whose shared memory does not fit is refused
template <class Op, class Own = Op, typename Kern>
cudaError_t set_smem(Kern kernel, int kind, int D, bool with_bias, size_t* smem) {
  *smem = f32_smem<Op, Own>(kind, D, with_bias);
  if (*smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
}

// Planes: the first launch, the split of the first n operands into
// `planes` (3 n planes of B H T Dp bf16, the wrapper's scratch)
template <class Op>
cudaError_t split_operands(Operands& ops, void* planes, int n, int B, int T_len, int H, int D, cudaStream_t st) {
  if (!Op::kSplit) return cudaSuccess;
  if (planes == nullptr) return cudaErrorInvalidValue;
  ops.planes = static_cast<const bf16*>(planes);
  ops.pstride = static_cast<size_t>(B) * H * T_len * depth_pad(D);
  const size_t quads = ops.pstride / 4;
  bool vec = D % 4 == 0;
  for (int i = 0; i < n; ++i) vec = vec && (reinterpret_cast<uintptr_t>(ops.x[i]) & 15) == 0;
  const dim3 grid(static_cast<unsigned>((quads + 255) / 256), n);
  const bool wide = quads >= (size_t(1) << 32);
  if (!wide) split_kernel<uint32_t><<<grid, 256, 0, st>>>(ops, static_cast<bf16*>(planes), B, T_len, H, D, vec);
  if (wide) split_kernel<size_t><<<grid, 256, 0, st>>>(ops, static_cast<bf16*>(planes), B, T_len, H, D, vec);
  return cudaGetLastError();
}

template <int KD>
int launch_fwd_f32(Operands ops, const void* lens, void* out, void* lse, const void* bias, int bias_kind, int B,
                   int T_len, int H, int D, float scale, uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
                   float inv_keep, int key_stride, int key_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem;
  const cudaError_t err = set_smem<Rows32>(fwd_f32_kernel<KD>, kFwd, D, bias_kind != kBiasNone, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(T_len, kBQ), H, B);
  fwd_f32_kernel<KD><<<grid, kThreads, smem, st>>>(
      ops, static_cast<const int*>(lens), static_cast<float*>(out), static_cast<float*>(lse), bias, bias_kind, T_len,
      H, D, scale, seed_lo, seed_hi, threshold, inv_keep, key_stride, key_offset);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_f32_split(const void* q, const void* k, const void* v, const void* lens, void* out, void* lse,
                         const void* bias, int bias_kind, int B, int T_len, int H, int D, float scale,
                         uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep, int key_stride,
                         int key_offset, void* stream) {
  size_t smem;
  const cudaError_t err = set_smem<Planes>(fwd_f32_split_kernel<4>, kFwd, D, bias_kind != kBiasNone, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(T_len, kBQ), H, B);
  fwd_f32_split_kernel<4><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<float*>(out), static_cast<float*>(lse), bias, bias_kind, T_len, H, D,
      scale, seed_lo, seed_hi, threshold, inv_keep, key_stride, key_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int KD, class Op, class Own>
int launch_bwd_f32(Operands ops, void* planes, const void* o, const void* lens, const void* lse, void* dq, void* dk,
                   void* dv, void* delta, const void* bias, int bias_kind, void* d_bias, int B, int T_len, int H, int D,
                   float scale, uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold, float inv_keep,
                   int key_stride, int key_offset, void* stream) {
  const bool with_bias = bias_kind != kBiasNone;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem_dq, smem_dkv;
  cudaError_t err = set_smem<Op, Own>(bwd_dq_f32_kernel<KD, Op, Own>, kDq, D, with_bias, &smem_dq);
  if (err == cudaSuccess) err = set_smem<Op, Own>(bwd_dkv_f32_kernel<KD, Op, Own>, kDkv, D, with_bias, &smem_dkv);
  if (err == cudaSuccess) err = split_operands<Op>(ops, planes, 4, B, T_len, H, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(T_len, kBQ), H, B);
  bwd_dq_f32_kernel<KD, Op, Own><<<grid, kThreads, smem_dq, st>>>(
      ops, static_cast<const float*>(o), static_cast<const int*>(lens), static_cast<const float*>(lse),
      static_cast<float*>(dq), static_cast<float*>(delta), bias, bias_kind, d_bias, T_len, H, D, scale, seed_lo,
      seed_hi, threshold, inv_keep, key_stride, key_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_f32_kernel<KD, Op, Own><<<grid, kThreads, smem_dkv, st>>>(
      ops, static_cast<const int*>(lens), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), bias, bias_kind, T_len, H, D, scale, seed_lo, seed_hi,
      threshold, inv_keep, key_stride, key_offset);
  return static_cast<int>(cudaGetLastError());
}

// the instances: for D <= 64 Planes (the forward's split by the block, the
// backward's streamed tiles by a first launch) and RowsA32 (the backward's
// own tiles), for D <= 128 Rows32
inline size_t f32_smem_of(int kind, int D, bool with_bias) {
  if (D > 64) return f32_smem<Rows32>(kind, D, with_bias);
  return kind == kFwd ? f32_smem<Planes>(kind, D, with_bias) : f32_smem<Planes, RowsA32>(kind, D, with_bias);
}

bool bad_args(int D, int bias_kind, const void* bias, bool bf16) {
  return D < 1 || D > kDMax || (bf16 && D % 8 != 0) || bias_kind < kBiasNone || bias_kind > kBiasBF16
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
                          uint32_t threshold, float inv_keep, int key_stride, int key_offset, void* stream) {
  if (tc::bad_args(D, bias_kind, bias, false)) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return tc::launch_fwd_f32_split(q, k, v, lens, out, lse, bias, bias_kind, B, T, H, D, scale, seed_lo, seed_hi,
                                    threshold, inv_keep, key_stride, key_offset, stream);
  const tc::Operands ops{{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                          nullptr},
                         nullptr, 0};
  return tc::launch_fwd_f32<8>(ops, lens, out, lse, bias, bias_kind, B, T, H, D, scale, seed_lo, seed_hi,
                                           threshold, inv_keep, key_stride, key_offset, stream);
}

int emo_attention_fwd_bf16(const void* q, const void* k, const void* v, const void* lens,
                           void* out, void* lse, const void* bias, int bias_kind, int B, int T,
                           int H, int D, float scale, uint32_t seed_lo, uint32_t seed_hi,
                           uint32_t threshold, float inv_keep, int key_stride, int key_offset, void* stream) {
  if (tc::bad_args(D, bias_kind, bias, true)) return static_cast<int>(cudaErrorInvalidValue);
  return (D <= 64 ? tc::launch_fwd<4> : tc::launch_fwd<8>)(q, k, v, lens, out, lse, bias, bias_kind, B, T,
                                                            H, D, scale, seed_lo, seed_hi, threshold,
                                                            inv_keep, key_stride, key_offset, stream);
}

// both backward passes; `delta` is (B, H, T) f32 scratch; `d_bias` is
// (B, H, T, T) in the bias's dtype, or null (no bias, or a bias that needs
// no gradient); `o` is the forward's f32 output (delta = dO . O);
// `planes` a bf16 scratch of 12 B H T Dp elements where D <= 64 (Dp = D
// rounded up to 16), else unused (ops/attention.py::launch_geometry)
int emo_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                          const void* d_o, const void* lens, const void* lse, void* dq, void* dk,
                          void* dv, void* delta, void* planes, const void* bias, int bias_kind, void* d_bias,
                          int B, int T, int H, int D, float scale,
                          uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
                          float inv_keep, int key_stride, int key_offset, void* stream) {
  if (tc::bad_args(D, bias_kind, bias, false)) return static_cast<int>(cudaErrorInvalidValue);
  const tc::Operands ops{{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                          static_cast<const float*>(d_o)},
                         nullptr, 0};
  return (D <= 64 ? tc::launch_bwd_f32<4, tc::Planes, tc::RowsA32> : tc::launch_bwd_f32<8, tc::Rows32, tc::Rows32>)(
      ops, planes, o, lens, lse, dq, dk, dv, delta, bias, bias_kind, d_bias, B, T, H, D, scale, seed_lo, seed_hi,
      threshold, inv_keep, key_stride, key_offset, stream);
}

// as the f32 launcher, without `planes`; `o` is not read (bf16 sums delta
// from dP P)
int emo_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                           const void* d_o, const void* lens, const void* lse, void* dq,
                           void* dk, void* dv, void* delta, const void* bias, int bias_kind,
                           void* d_bias, int B, int T, int H, int D, float scale,
                           uint32_t seed_lo, uint32_t seed_hi, uint32_t threshold,
                           float inv_keep, int key_stride, int key_offset, void* stream) {
  if (tc::bad_args(D, bias_kind, bias, true)) return static_cast<int>(cudaErrorInvalidValue);
  return (D <= 64 ? tc::launch_bwd<4> : tc::launch_bwd<8>)(q, k, v, d_o, lens, lse, dq, dk, dv, delta,
                                                            bias, bias_kind, d_bias, B, T, H, D, scale,
                                                            seed_lo, seed_hi, threshold, inv_keep,
                                                            key_stride, key_offset, stream);
}

// dynamic shared memory of an f32 kernel: kind 0 forward, 1 backward pass
// 1, 2 backward pass 2
int emo_attention_smem_bytes(int kind, int D, int with_bias) {
  return static_cast<int>(tc::f32_smem_of(kind, D, with_bias != 0));
}

// the launchers' keep bits for `seed`, one map for both dtypes
int emo_attention_keep_mask(void* out, int B, int T, int H, uint32_t seed_lo, uint32_t seed_hi,
                            uint32_t threshold, int key_stride, int key_offset, void* stream) {
  const size_t n = static_cast<size_t>(B) * H * ((T + 15) / 16 * 8) * ((T + 1) / 2);
  if (n == 0) return 0;
  const int threads = 256;
  tc::keep_mask_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(static_cast<uint8_t*>(out), B * H, T, seed_lo,
                                                              seed_hi, threshold, H, key_stride, key_offset);
  return static_cast<int>(cudaGetLastError());
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
