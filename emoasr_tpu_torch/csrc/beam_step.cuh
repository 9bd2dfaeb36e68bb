// What the fused layer steps of beam decoding share (csrc/decoder_step.cu,
// K5, and csrc/lm_step.cu, K6).
//
// Row groups: the N = Bu W beam rows, in (utterance, beam) order, go in
// groups of WP (4, 12 or 16) consecutive rows, ceil(N / WP) groups, so that
// a group may hold the rows of several utterances or part of one (a row's utterance is its row index
// over W); a thread-block cluster of C blocks (C up to 8, as many as the
// card keeps at once for the launch) owns a group.  Every block keeps the
// group's rows of each activation in its own shared memory; a phase splits
// its work over the cluster's blocks, each block writes what it computed
// into its own shared memory and copies it, 16 bytes a thread and store,
// into the same place of every other block's (distributed shared memory),
// and a cluster barrier ends the phase.  Beam rows do not interact within a
// layer step, and no sum below depends on where in a group a row lands.
//
// The dense products run on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 sums; csrc/mma_bf16.cuh): the group's rows are one m16 A
// tile, read by ldmatrix from bf16 planes in shared memory that the phase
// before the product writes (WP rows a plane; the tile's rows beyond WP read
// a row of zeros after the planes).  A float32 operand is split into two
// bf16 terms (hi = bf16(x), lo = bf16(x - hi)) and the three
// leading cross products are summed (hi hi + lo hi + hi lo, each into an
// accumulator of its own, added in that order); a bf16 operand is one term
// and one product.  The weights arrive already split and laid out in the
// order of the B fragments (ops/decoder_step.py::pack_fragments): for each
// group of 16 output columns and k-step of 16, per term, 32 lanes x 16
// bytes, so a warp streams them from L2 by coalesced 16-byte loads straight
// into registers, several k-steps ahead.  K is cut into slices(K) fixed
// slices, each summed from zero and the slices added in order, so that all
// eight warps have work when a block owns few columns, and a column's sum
// does not depend on the cluster's size.  Sum orders are fixed (no atomics).
// Everything is templated on the storage type E (float or bf16) of the
// activations, caches, encoder K/V and the weights' bias and LayerNorm
// vectors; every sum is float32.
//
// The kernels' build hashes this header with each source that includes it
// (ops/cuda_lib.py), so an edit here rebuilds both.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace beam_step {

using emo_mma::bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;
constexpr float kLnEps = 1e-12f;
constexpr int kRows = 16;       // an m16 tile: the most rows a group has
constexpr int kGroup = 16;      // output columns of one work item: two n8 tiles
constexpr int kMaxSlices = 4;   // slices of K (see slices)

// The storage type E of the activations (in shared memory), the caches, the
// encoder K/V and the outputs: float or __nv_bfloat16.  Every sum is taken
// in float32; a value is rounded to E where the TPU kernel rounds it to its
// activation dtype (round_to, or the store of from_float).
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename E> __device__ __forceinline__ E from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's and XLA's casts
}

// x rounded to E's precision, as float (the identity for float)
template <typename E>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<E>(x)); }

// bf16 terms of an E operand of the products: two for float32, one for bf16
template <typename E> struct Terms { static constexpr int N = 2; };
template <> struct Terms<__nv_bfloat16> { static constexpr int N = 1; };

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

// the two bf16 values of a 32-bit word (the lower address in the low half),
// widened exactly to float
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xFFFF0000u); }

// A 16-byte word of E values (four floats or eight bf16): its float32 dot
// product with another, in element order, and its values as floats
template <typename E> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using T = float4;
  __device__ static __forceinline__ float dot(const float4& a, const float4& b, float acc) {
    return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
  }
  __device__ static __forceinline__ void unpack(const float4& v, float o[4]) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using T = uint4;
  __device__ static __forceinline__ float dot2(unsigned a, unsigned b, float acc) {
    return fmaf(bf16_hi(a), bf16_hi(b), fmaf(bf16_lo(a), bf16_lo(b), acc));
  }
  __device__ static __forceinline__ float dot(const uint4& a, const uint4& b, float acc) {
    return dot2(a.w, b.w, dot2(a.z, b.z, dot2(a.y, b.y, dot2(a.x, b.x, acc))));
  }
  __device__ static __forceinline__ void unpack(const uint4& v, float o[8]) {
    o[0] = bf16_lo(v.x); o[1] = bf16_hi(v.x); o[2] = bf16_lo(v.y); o[3] = bf16_hi(v.y);
    o[4] = bf16_lo(v.z); o[5] = bf16_hi(v.z); o[6] = bf16_lo(v.w); o[7] = bf16_hi(v.w);
  }
};

// two E values (a pair of columns) stored at once
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- the A planes: WP rows of bf16 a plane, one plane per term, then a row of zeros ----

// The products cut K into slices(K) slices of equal length, K padded with
// zeros to ksteps_padded(K) k-steps of 16 (the packed weights are padded the
// same way); an A plane of K columns has rows of plane_ld(K) bf16 (a multiple
// of 8, and an odd multiple of 16 bytes, so that ldmatrix's eight rows fall on
// 32 banks).  ops/decoder_step.py mirrors these.
__host__ __device__ inline int ksteps(int K) { return (K + 15) / 16; }
__host__ __device__ inline int slices(int K) {
  const int s = ksteps(K) / 4;
  return s < 1 ? 1 : s > kMaxSlices ? kMaxSlices : s;
}
__host__ __device__ inline int ksteps_padded(int K) { return (ksteps(K) + slices(K) - 1) / slices(K) * slices(K); }
__host__ __device__ inline int plane_ld(int K) { return 16 * ksteps_padded(K) + 8; }
__host__ __device__ inline int planes_bytes(int K, int terms, int WP) { return (terms * WP + 1) * plane_ld(K) * 2; }

// The columns K .. ld - 1 of `rows` plane rows of ld, and the zero row after
// them, set to 0 (what the products read beyond K)
__device__ __forceinline__ void zero_padding(bf16* planes, int rows, int K, int ld) {
  const int pad = ld - K;
  for (int i = threadIdx.x; i < rows * pad + ld; i += kThreads)
    planes[i < rows * pad ? (i / pad) * ld + K + i % pad : rows * ld + i - rows * pad] = __float2bfloat16(0.f);
}

// NV values v (already rounded to E) into the planes at dst (the first term's
// plane; the second `plane` elements on), NV bf16 a term
template <int NV>
__device__ __forceinline__ void store_words(bf16* dst, const uint32_t* w) {
  if constexpr (NV == 2) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else if constexpr (NV == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}
template <typename E, int NV>
__device__ __forceinline__ void put_planes(bf16* dst, int plane, const float* v) {
  uint32_t hi[NV / 2], lo[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = emo_mma::pack(v[2 * i] - __low2float(h), v[2 * i + 1] - __high2float(h));
  }
  store_words<NV>(dst, hi);
  if (Terms<E>::N == 2) store_words<NV>(dst + plane, lo);
}

// two E values as floats, from shared or device memory
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// out[w] = LayerNorm(x[w]) for the rows w = first, first + step, ... < rows,
// a warp per row (flax semantics: f32 statistics, eps inside the square
// root, the output rounded to E), into the E rows `out` and / or the A planes
// `planes` (rows of ld, `plane` elements a term); x and out may be the same
// buffer.  A lane takes the column pairs 2 lane + 64 k, the first kLnPairs of
// them (D <= 512) with their scale and bias in registers (`v`, which
// ln_vectors reads ahead of time, before a barrier), the rest as they come.
constexpr int kLnPairs = 8;
struct LnVecs {
  float2 s[kLnPairs], b[kLnPairs];
};
template <typename E>
__device__ __forceinline__ LnVecs ln_vectors(const E* __restrict__ scale, const E* __restrict__ bias, int D) {
  const int lane = threadIdx.x & 31;
  LnVecs v;
#pragma unroll
  for (int k = 0; k < kLnPairs; ++k) {
    const int d = 2 * lane + 64 * k;
    v.s[k] = d < D ? ld2(scale + d) : make_float2(0.f, 0.f);
    v.b[k] = d < D ? ld2(bias + d) : make_float2(0.f, 0.f);
  }
  return v;
}
template <typename E>
__device__ __forceinline__ void layer_norm(const LnVecs& vecs, const E* x, E* out, bf16* planes, int ld, int plane,
                                           const E* __restrict__ scale, const E* __restrict__ bias, int D,
                                           int rows, int first, int step) {
  const int lane = threadIdx.x & 31;
  for (int w = first; w < rows; w += step) {
    const E* xr = x + w * D;
    float2 xv[kLnPairs];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kLnPairs; ++k) {
      const int d = 2 * lane + 64 * k;
      xv[k] = d < D ? ld2(xr + d) : make_float2(0.f, 0.f);
      s += xv[k].x + xv[k].y;
    }
    for (int d = 2 * lane + 64 * kLnPairs; d < D; d += 64) s += to_float(xr[d]) + to_float(xr[d + 1]);
    const float mean = warp_sum(s) / D;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kLnPairs; ++k)
      if (2 * lane + 64 * k < D) v += (xv[k].x - mean) * (xv[k].x - mean) + (xv[k].y - mean) * (xv[k].y - mean);
    for (int d = 2 * lane + 64 * kLnPairs; d < D; d += 64) {
      const float c0 = to_float(xr[d]) - mean, c1 = to_float(xr[d + 1]) - mean;
      v += c0 * c0 + c1 * c1;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int d = 2 * lane, k = 0; d < D; d += 64, ++k) {  // D is even
      float2 xd, sd, bd;
      if (k < kLnPairs) {
#pragma unroll
        for (int j = 0; j < kLnPairs; ++j)  // the registers of pair k (a static index)
          if (j == k) xd = xv[j], sd = vecs.s[j], bd = vecs.b[j];
      } else {
        xd = ld2(xr + d), sd = ld2(scale + d), bd = ld2(bias + d);
      }
      float y[2] = {round_to<E>((xd.x - mean) * rstd * sd.x + bd.x), round_to<E>((xd.y - mean) * rstd * sd.y + bd.y)};
      if (planes != nullptr) put_planes<E, 2>(planes + w * ld + d, plane, y);
      if (out != nullptr) store2(out + w * D + d, y[0], y[1]);
    }
  }
}

// XLA's float32 erf (ErfImpl32: clamp to [-4, 4], a ratio of an odd and an
// even polynomial), the polynomial the TPU LM-step kernel inlines (K6's gelu)
__device__ __forceinline__ float erf_f32(float x) {
  x = fminf(fmaxf(x, -4.0f), 4.0f);
  const float x2 = x * x;
  float p = -2.72614225801306e-10f;
  p = p * x2 + 2.77068142495902e-08f;
  p = p * x2 + -2.10102402082508e-06f;
  p = p * x2 + -5.69250639462346e-05f;
  p = p * x2 + -7.34990630326855e-04f;
  p = p * x2 + -2.95459980854025e-03f;
  p = p * x2 + -1.60960333262415e-02f;
  p = p * x;
  float q = -1.45660718464996e-05f;
  q = q * x2 + -2.13374055278905e-04f;
  q = q * x2 + -1.68282697438203e-03f;
  q = q * x2 + -7.37332916720468e-03f;
  q = q * x2 + -1.42647390514189e-02f;
  return p / q;
}

// The rows a cluster owns: rows r0 .. r0 + n - 1 of the N = Bu W, row r of
// utterance r / W.  Beam rows do not interact within a layer step: each
// reads its own cache rows, or its ancestors' (l < pos, which no launch
// writes: the caller writes k_new, v_new at pos after the step), and its
// utterance's encoder K/V; a cluster writes only its own rows of y, k_new and
// v_new.  So the groups run independently, and a row's sums do not depend on
// the group it lands in.
struct RowGroup {
  int r0, n;
  __device__ RowGroup(int cluster_id, int N, int WP) : r0(cluster_id * WP), n(min(WP, N - cluster_id * WP)) {}
};

// The groups of kGroup output columns that block `rank` of `csize` owns
__device__ __forceinline__ void owned(int N, int rank, int csize, int& g0, int& g1) {
  const int groups = (N + kGroup - 1) / kGroup;
  const int per = (groups + csize - 1) / csize;
  g0 = min(rank * per, groups);
  g1 = min(g0 + per, groups);
}

enum { kPlain = 0, kRelu = 1, kResidual = 2, kGelu = 3 };

// Copy `rows` rows of `wpr` words of type Word (uint4: 16 bytes, or uint2:
// 8), word wd of row r at byte offset off(r, wd) of `base`, from this
// block's shared memory into every other block's of the cluster, the same
// place: a thread loads a word once and stores it into each peer
template <typename Word = uint4, typename Off>
__device__ __forceinline__ void share_rows(cg::cluster_group& cluster, unsigned char* base, int rows, int wpr,
                                           Off off) {
  const int csize = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  if (csize == 1 || wpr < 1) return;
  const int step = max(kThreads / wpr, 1), w0 = threadIdx.x % wpr;
  for (int r = threadIdx.x / wpr; r < rows; r += step)
    for (int wd = w0; wd < wpr; wd += kThreads) {
      const int o = off(r, wd);
      const Word v = *reinterpret_cast<const Word*>(base + o);
      for (int peer = 1; peer < csize; ++peer)
        *reinterpret_cast<Word*>(cluster.map_shared_rank(base, (rank + peer) % csize) + o) = v;
    }
}

// out = x wt^T + bias for this block's groups of kGroup output columns:
// x the A planes xa (WP rows of K, Terms<E> planes, a row of zeros), wt the
// packed B fragments wf of the (N, K) weight (ops/decoder_step.py::
// pack_fragments).  A work item is (a group of 16 columns, a slice of K),
// the items of a pass (at most 8 column groups) dealt to the warps in turn;
// each warp streams its items' k-steps as one sequence, PF k-steps of B in
// registers ahead (16 of one bf16 term or 8 of two: 64 KB in flight a
// block).  An item's 16 x 16 partial sums go to `scratch` (its
// `scratch_bytes` set how many column groups a pass takes), and the
// epilogue (a thread per column group and lane, its bias read before the
// products) adds each column's slices in order.  The value of (row w,
// column n) is rounded to E (the TPU kernel's dense rounds once, after its
// f32 bias); then `mode`: relu, gelu (rounded again), or plus resid[w, n]
// and rounded again (the residual add is an add in E).  Column n is column
// n % part of output part n / part (the fused Q, K, V: part D): it goes to
// out (E rows of `part`, WP rows a part, the parts one after another) and /
// or the A planes out_planes (rows of plane_ld(N); one part) of this block,
// which then copies its columns into every block of the cluster as 16-byte
// words (the planes as 8-byte words where the block's columns end 4 past a
// multiple of 8, as a float32 N may); and, for the group's Wg real rows and
// the parts from `gfirst` on, to gout + (part index - gfirst) gstride +
// w part + n % part in device memory.
// The m16 tile's rows beyond WP read the zero row.  One instance per (WP,
// E), not inlined: the products of a layer share it.
template <int WP, typename E>
__device__ __noinline__ void dense(int mode, const bf16* xa, int K, const uint4* __restrict__ wf,
                                   const E* __restrict__ bias, int N, int part, float* scratch, int scratch_bytes,
                                   E* out, bf16* out_planes, const E* resid, E* __restrict__ gout, size_t gstride,
                                   int gfirst, int Wg) {
  constexpr int T = Terms<E>::N;
  constexpr int NP = T == 1 ? 1 : 3;  // products a k-step: hi hi [+ lo hi + hi lo]
  constexpr int PF = 16 / T;          // k-steps of B in flight a warp
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = slices(K), ksp = ksteps_padded(K), Ls = ksp / S, lda = 16 * ksp + 8, plane_a = WP * lda;
  const int ldo = plane_ld(N), plane_o = WP * ldo;
  // this lane's row of the A tile for ldmatrix (rows beyond WP: the zero row)
  const int ar = lane & 15;
  const bf16* arow = (ar < WP ? xa + ar * lda : xa + T * plane_a) + ((lane >> 4) << 3);
  const int aplane = ar < WP ? plane_a : 0;
  int g0, g1;
  owned(N, rank, csize, g0, g1);
  const int per_pass = max(1, min(min(kWarps, g1 - g0), scratch_bytes / (S * kRows * kGroup * 4)));
  for (int c0 = g0; c0 < g1; c0 += per_pass) {
    const int ncg = min(per_pass, g1 - c0), items = ncg * S;
    // the epilogue's bias (this thread's column pairs), read before the products
    const int eg = c0 + (threadIdx.x >> 5), ec = 2 * (lane & 3);
    float eb[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if ((threadIdx.x >> 5) < ncg) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = eg * kGroup + 8 * j + ec;
        if (n < N) eb[j][0] = to_float(bias[n]), eb[j][1] = to_float(bias[n + 1]);
      }
    }
    const int mine = items > warp ? (items - warp + kWarps - 1) / kWarps : 0;
    const int total = mine * Ls;  // this warp's k-steps, its items (warp, warp + kWarps, ...) one after another
    // B of item it, k-step 0 (its group it / S, its slice it % S)
    const auto item_b = [&](int it) {
      return wf + (static_cast<size_t>(c0 + it / S) * ksp + (it % S) * Ls) * T * 32 + lane;
    };
    int lit = warp, lk = 0;  // the loads' stream position: item, k-step
    const uint4* lb = item_b(lit);
    const auto load = [&](uint4* r) {
#pragma unroll
      for (int t = 0; t < T; ++t) r[t] = __ldg(lb + 32 * t);
      if (++lk == Ls) {
        lk = 0;
        lit += kWarps;
        lb = item_b(lit);
      } else {
        lb += T * 32;
      }
    };
    uint4 ring[PF][T];
#pragma unroll
    for (int i = 0; i < PF; ++i)
      if (i < total) load(ring[i]);
    float acc[NP][2][4];
    int it = warp, kl = 0, kb = 16 * (it % S) * Ls;  // the products' stream position; the item's first k
    for (int q0 = 0; q0 < total; q0 += PF) {
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int q = q0 + i;
        if (q < total) {
          if (kl == 0) {
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
          }
          const int k0 = kb + 16 * kl;
          uint32_t a[T][4];
#pragma unroll
          for (int t = 0; t < T; ++t) emo_mma::ldmatrix_x4(a[t], arow + t * aplane + k0);
          emo_mma::mma(acc[0][0], a[0], ring[i][0].x, ring[i][0].y);
          emo_mma::mma(acc[0][1], a[0], ring[i][0].z, ring[i][0].w);
          if constexpr (T == 2) {
            emo_mma::mma(acc[1][0], a[1], ring[i][0].x, ring[i][0].y);
            emo_mma::mma(acc[1][1], a[1], ring[i][0].z, ring[i][0].w);
            emo_mma::mma(acc[2][0], a[0], ring[i][1].x, ring[i][1].y);
            emo_mma::mma(acc[2][1], a[0], ring[i][1].z, ring[i][1].w);
          }
          if (q + PF < total) load(ring[i]);
          if (kl == Ls - 1) {  // the item's partial, in the C fragments' order: [group][slice][lane][8]
            float v[8];
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float x = acc[0][j][e];
                if constexpr (NP == 3) x = (x + acc[1][j][e]) + acc[2][j][e];
                v[4 * j + e] = x;
              }
            float4* dst = reinterpret_cast<float4*>(scratch + it * 256 + lane * 8);
            dst[0] = make_float4(v[0], v[1], v[2], v[3]);
            dst[1] = make_float4(v[4], v[5], v[6], v[7]);
          }
          if (++kl == Ls) {
            kl = 0;
            it += kWarps;
            kb = 16 * (it % S) * Ls;
          }
        }
      }
    }
    __syncthreads();
    if ((threadIdx.x >> 5) < ncg) {  // epilogue: a warp per column group of the pass, its lanes' 8 values
      const int cl = threadIdx.x >> 5, g = lane >> 2;
      const float4* src_p = reinterpret_cast<const float4*>(scratch + cl * S * 256 + lane * 8);
      float4 s0 = src_p[0], s1 = src_p[1];
      for (int s = 1; s < S; ++s) {
        const float4 t0 = src_p[64 * s], t1 = src_p[64 * s + 1];
        s0.x += t0.x; s0.y += t0.y; s0.z += t0.z; s0.w += t0.w;
        s1.x += t1.x; s1.y += t1.y; s1.z += t1.z; s1.w += t1.w;
      }
      const float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = eg * kGroup + 8 * j + ec;
        if (n >= N) continue;  // N is even: n < N means n + 1 < N
        const int pi = n / part, pc = n % part;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int w = g + 8 * h;
          if (w >= WP) continue;  // the tile's padding rows
          float y[2] = {round_to<E>(v[4 * j + 2 * h] + eb[j][0]), round_to<E>(v[4 * j + 2 * h + 1] + eb[j][1])};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (mode == kRelu) y[i] = fmaxf(y[i], 0.f);
            if (mode == kGelu) y[i] = round_to<E>(0.5f * y[i] * (1.0f + erf_f32(y[i] * 0.7071067811865476f)));
            if (mode == kResidual) y[i] = round_to<E>(y[i] + to_float(resid[w * N + n + i]));
          }
          if (out_planes != nullptr) put_planes<E, 2>(out_planes + w * ldo + n, plane_o, y);
          if (out != nullptr) store2(out + (pi * WP + w) * part + pc, y[0], y[1]);
          if (gout != nullptr && pi >= gfirst && w < Wg)
            store2(gout + (pi - gfirst) * gstride + w * part + pc, y[0], y[1]);
        }
      }
    }
    __syncthreads();  // the next pass, or the next product, reuses the scratch
  }
  // this block's columns into every block: 16-byte words of E rows or of the planes' rows
  const int n0 = g0 * kGroup, n1 = min(g1 * kGroup, N);
  if (n1 <= n0) return;
  if (out != nullptr) {
    constexpr int NVE = 16 / static_cast<int>(sizeof(E));
    share_rows(cluster, reinterpret_cast<unsigned char*>(out), WP, (n1 - n0) / NVE, [&](int r, int wd) {
      const int n = n0 + NVE * wd;
      return static_cast<int>(((n / part * WP + r) * part + n % part) * sizeof(E));
    });
  }
  // the planes' rows in 16-byte words (8 columns), or in 8-byte words (4 columns) where a float32 N ends
  // halfway through a word
  if (out_planes != nullptr && (n1 - n0) % 8 == 0)
    share_rows(cluster, reinterpret_cast<unsigned char*>(out_planes), T * WP, (n1 - n0) / 8,
               [&](int r, int wd) { return (r * ldo + n0 + 8 * wd) * 2; });
  else if (out_planes != nullptr)
    share_rows<uint2>(cluster, reinterpret_cast<unsigned char*>(out_planes), T * WP, (n1 - n0) / 4,
                      [&](int r, int wd) { return (r * ldo + n0 + 4 * wd) * 2; });
}

// Self-attention of one new position per row over the pre-write caches, a
// warp of the cluster per (row, head): the columns l < pos plus the new
// column (k_new, v_new) as an explicit extra term of one softmax (the one
// the dense route takes after writing the cache at `pos` and masking
// l <= pos; a masked key's weight exp(-1e9 - max) is 0 in f32, so masked
// keys are skipped).  Scores f32 from the E queries and keys; the
// probabilities rounded to E before the AV product and each head's output
// rounded to E (the TPU kernel's roundings).  A column's key and value rows
// are read by P lanes, 16 bytes each (P the power of two at or above the
// head's 16-byte words), 32 / P columns at once; a score's P partial sums
// and an output's column groups are added by shuffles in a fixed tree.
// qs, kn, vn: (WP, D) in shared memory, complete in every block; the output
// goes to the A planes att (rows of ld, `plane` elements a term) of this
// block, and the warp copies it into every other block's, 8 bytes a lane and
// store.  Caches: rows of row
// r at (r L + l), or, INDIRECT, of slot u W + anc[r, l] (u = r / W), any of
// the utterance's W slots.  scratch: kWarps x 2 lp floats (lp >= L).  d_k is
// a multiple of Vec<E>::N.  Not inlined: its registers are its own.
template <bool INDIRECT, typename E>
__device__ __noinline__ void cached_attention(cg::cluster_group& cluster, const E* qs, const E* kn,
                                                 const E* vn, bf16* att, int ld, int plane, float* scratch, int lp,
                                                 const int* __restrict__ pos, const int* __restrict__ anc,
                                                 const E* __restrict__ cache_k,
                                                 const E* __restrict__ cache_v, const RowGroup& rg, int W,
                                                 int L, int D, int H) {
  using V = Vec<E>;
  using VT = typename V::T;
  constexpr int NV = V::N;
  constexpr int kBatch = 16;  // cache columns a lane loads at once
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = rank * kWarps + warp, wtotal = csize * kWarps;  // warp of the cluster
  const int dk = D / H, nw = dk / NV;
  int P = 1;
  while (P < nw && P < 32) P <<= 1;
  const int cpw = 32 / P, cl = lane / P, dq = lane % P;  // columns at once; this lane's column and word
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  float* sc = scratch + warp * (2 * lp);        // this warp's scores,
  int* rows = reinterpret_cast<int*>(sc + lp);  // and the cache row of every column
  for (int item = wg; item < rg.n * H; item += wtotal) {
    const int w = item / H, hh = item % H;
    const int r = rg.r0 + w, u = r / W;
    const int np = min(max(pos[r], 0), L);  // past columns
    for (int l = lane; l < np; l += 32) {
      int row = r;
      if (INDIRECT) row = u * W + min(max(anc[static_cast<size_t>(r) * L + l], 0), W - 1);
      rows[l] = row * L + l;
    }
    __syncwarp();
    const E* qh = qs + w * D + hh * dk;
    const VT qw = dq < nw ? *reinterpret_cast<const VT*>(qh + NV * dq) : VT{};
    float m = -INFINITY;
    for (int l0 = 0; l0 < np; l0 += kBatch * cpw) {  // kBatch columns a lane, their loads issued at once
      VT kv[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int l = l0 + b * cpw + cl;
        kv[b] = l < np && dq < nw
                    ? __ldg(reinterpret_cast<const VT*>(cache_k + static_cast<size_t>(rows[l]) * D + hh * dk) + dq)
                    : VT{};
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int l = l0 + b * cpw + cl;
        float a = V::dot(qw, kv[b], 0.f);
        if (l < np)  // the words past the first, where d_k holds more than 32 of them
          for (int j = dq + P; j < nw; j += P)
            a = V::dot(*reinterpret_cast<const VT*>(qh + NV * j),
                       __ldg(reinterpret_cast<const VT*>(cache_k + static_cast<size_t>(rows[l]) * D + hh * dk) + j), a);
        for (int off = P / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xFFFFFFFFu, a, off);
        if (l < np) {
          if (dq == 0) sc[l] = a * scale;
          m = fmaxf(m, a * scale);
        }
      }
    }
    float sn = 0.f;  // the new column
    for (int j = lane; j < nw; j += 32)
      sn = V::dot(*reinterpret_cast<const VT*>(qh + NV * j), *reinterpret_cast<const VT*>(kn + w * D + hh * dk + NV * j), sn);
    sn = warp_sum(sn) * scale;
    m = fmaxf(warp_max(m), sn);
    __syncwarp();
    float den = 0.f;
    for (int l = lane; l < np; l += 32) {
      const float e = expf(sc[l] - m);
      sc[l] = e;
      den += e;
    }
    const float en = expf(sn - m);
    den = warp_sum(den) + en;
    for (int l = lane; l < np; l += 32) sc[l] = round_to<E>(sc[l] / den);
    __syncwarp();
    const float pn = round_to<E>(en / den);
    for (int j0 = 0; j0 < nw; j0 += P) {  // a lane per 16-byte word of the output, cpw columns at once
      const int j = j0 + dq;
      float o[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) o[e] = 0.f;
      if (j < nw) {
        for (int l0 = cl; l0 < np; l0 += kBatch * cpw) {  // kBatch columns a lane, their loads issued at once
          VT vv[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int l = l0 + b * cpw;
            vv[b] = l < np ? __ldg(reinterpret_cast<const VT*>(cache_v + static_cast<size_t>(rows[l]) * D + hh * dk) + j)
                           : VT{};
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int l = l0 + b * cpw;
            if (l < np) {
              const float pl = sc[l];
              float v[NV];
              V::unpack(vv[b], v);
#pragma unroll
              for (int e = 0; e < NV; ++e) o[e] = fmaf(pl, v[e], o[e]);
            }
          }
        }
      }
      for (int off = 16; off >= P; off >>= 1)
#pragma unroll
        for (int e = 0; e < NV; ++e) o[e] += __shfl_xor_sync(0xFFFFFFFFu, o[e], off);
      if (cl == 0 && j < nw) {
        float vnew[NV];
        V::unpack(*reinterpret_cast<const VT*>(vn + w * D + hh * dk + NV * j), vnew);
#pragma unroll
        for (int e = 0; e < NV; ++e) o[e] = round_to<E>(o[e] + pn * vnew[e]);
        put_planes<E, NV>(att + w * ld + hh * dk + NV * j, plane, o);
      }
    }
    __syncwarp();
    for (int t = 0; t < Terms<E>::N; ++t)  // the head's columns of row w, a plane a term, into the other blocks
      for (int wd = lane; wd < dk / 4; wd += 32) {
        const int at = t * plane + w * ld + hh * dk + 4 * wd;
        const uint2 v = *reinterpret_cast<const uint2*>(att + at);
        for (int peer = 1; peer < csize; ++peer)
          *reinterpret_cast<uint2*>(cluster.map_shared_rank(att, (rank + peer) % csize) + at) = v;
      }
  }
}

// Launch `kernel(p)` on `clusters` clusters of `cluster` blocks of kThreads
// threads with `smem` bytes of dynamic shared memory; returns the
// cudaError_t.
template <typename Params>
int launch_clusters(void (*kernel)(const Params), const Params& p, int clusters, int cluster, size_t smem,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// row groups of N rows in groups of WP
inline int row_groups(int N, int WP) { return (N + WP - 1) / WP; }

// How many clusters of `cluster` blocks of `kernel` with `smem` bytes of
// dynamic shared memory the card holds at once (cudaOccupancyMaxActiveClusters),
// or -1 on an error
template <typename Params>
int max_clusters(void (*kernel)(const Params), int cluster, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace beam_step
