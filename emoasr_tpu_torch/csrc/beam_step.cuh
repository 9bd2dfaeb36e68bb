// What the fused layer steps of beam decoding share (csrc/decoder_step.cu,
// K5, and csrc/lm_step.cu, K6): a thread-block cluster of C blocks (C in 1,
// 2, 4, 8) owns one row group of one utterance, at most WP (4, 12 or 16) of
// its W beam rows (`RowGroup`: an utterance of W > WP rows takes ceil(W /
// WP) clusters); every block keeps the group's rows (padded to WP) of each
// activation in its own shared memory; a phase splits
// its work over the cluster's blocks and each block writes what it computed
// into the same place of every block's shared memory (distributed shared
// memory) before a cluster barrier ends the phase.  The weights stream from
// L2 in nn.Linear's (out, in) layout.  Sum orders are fixed (no atomics).
// Everything is templated on the storage type E (float or bf16) of the
// activations, caches, encoder K/V and weights; the sums are float32.
//
// The kernels' build hashes this header with each source that includes it
// (ops/cuda_lib.py), so an edit here rebuilds both.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace beam_step {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;
constexpr float kLnEps = 1e-12f;

// The storage type E of the activations (in shared memory), the caches, the
// encoder K/V, the weights and the outputs: float or __nv_bfloat16.  Every
// sum is taken in float32; a value is rounded to E where the TPU kernel
// rounds it to its activation dtype (round_to, or the store of from_float).
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

// one element of device memory through the read-only path
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

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

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// the two bf16 values of a 32-bit word (the lower address in the low half),
// widened exactly to float
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xFFFF0000u); }
__device__ __forceinline__ float dot2(unsigned a, unsigned b, float acc) {
  return fmaf(bf16_hi(a), bf16_hi(b), fmaf(bf16_lo(a), bf16_lo(b), acc));
}

// A 16-byte word of E values (four floats or eight bf16) and the float32
// dot product of two such words, in element order
template <typename E> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using T = float4;
  __device__ static __forceinline__ float dot(const float4& a, const float4& b, float acc) {
    return dot4(a, b, acc);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using T = uint4;
  __device__ static __forceinline__ float dot(const uint4& a, const uint4& b, float acc) {
    return dot2(a.w, b.w, dot2(a.z, b.z, dot2(a.y, b.y, dot2(a.x, b.x, acc))));
  }
};

// out[w] = LayerNorm(x[w]) for the rows w = first, first + step, ... < rows,
// a warp per row (flax semantics: f32 statistics, eps inside the square
// root, the output rounded to E); x and out may be the same buffer
template <typename E>
__device__ __forceinline__ void layer_norm(const E* x, E* out, const E* __restrict__ scale,
                                           const E* __restrict__ bias, int D, int rows, int first,
                                           int step) {
  const int lane = threadIdx.x & 31;
  for (int w = first; w < rows; w += step) {
    const E* xr = x + w * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += to_float(xr[d]);
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = to_float(xr[d]) - mean;
      v += c * c;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int d = lane; d < D; d += 32)
      out[w * D + d] = from_float<E>((to_float(xr[d]) - mean) * rstd * to_float(scale[d]) + to_float(bias[d]));
  }
}

enum { kPlain = 0, kRelu = 1, kResidual = 2 };
constexpr int kGroup = 16;  // output columns a warp takes at a time

// The beam rows a cluster owns: utterance u, rows w0 .. w0 + n - 1 of its W
// (groups of WP rows, the last one shorter).  Beam rows do not interact
// within a layer step: each reads its own cache rows, or its ancestors'
// (l < pos, which no launch writes: the caller writes k_new, v_new at pos
// after the step), and the utterance's encoder K/V; a cluster writes only
// its own rows of y, k_new and v_new.  So the groups run independently, and
// a row's sums do not depend on the group it lands in.
struct RowGroup {
  int u, w0, n;
  __device__ RowGroup(int cluster_id, int W, int WP) {
    const int groups = (W + WP - 1) / WP;
    u = cluster_id / groups;
    w0 = (cluster_id % groups) * WP;
    n = min(WP, W - w0);
  }
  // the group's first row of the (Bu W) rows
  __device__ size_t row0(int W) const { return static_cast<size_t>(u) * W + w0; }
};

// The groups of kGroup output columns that block `rank` of `csize` owns
__device__ __forceinline__ void owned(int N, int rank, int csize, int& g0, int& g1) {
  const int groups = (N + kGroup - 1) / kGroup;
  const int per = (groups + csize - 1) / csize;
  g0 = min(rank * per, groups);
  g1 = min(g0 + per, groups);
}

// x (WP, K) in shared memory times wt (N, K) rows in device memory, plus
// bias, for the groups [g0, g1) of output columns, a warp per group: eight
// lanes share a column's K, each lane holds four columns.  The value of
// (row w, column n) is rounded to E (the TPU kernel's dense rounds once,
// after its f32 bias); then relu (kRelu), or plus resid[w, n] and rounded
// again (kResidual: the residual add is an add in E); it goes to out[w, n]
// in this block's shared memory (when out is not null) and, for the W real
// rows, to gout[w, n] in device memory (when gout is not null).  K is a
// multiple of Vec<E>::N and wt is 16-byte aligned.  What limits the loop is
// the shared-memory port: every 16-byte word of x a lane reads feeds
// sixteen (f32) or thirty-two (bf16) multiply-adds, and a block has eight
// warps only, so that a thread may hold its 4 WP accumulators in registers.
// One instance per WP (not inlined): the products of a layer share it.
template <int WP, typename E>
__device__ __noinline__ void dense(const E* x, int K, const E* __restrict__ wt,
                                   const E* __restrict__ bias, int N, int g0, int g1,
                                   E* out, int mode, const E* resid,
                                   E* __restrict__ gout, int W) {
  using V = Vec<E>;
  using VT = typename V::T;
  constexpr int R = kGroup / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kl = lane & 7, no = lane >> 3;
  const int KV = K / V::N;
  for (int g = g0 + warp; g < g1; g += kWarps) {
    const VT* wrow[R];
    int n[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      n[r] = g * kGroup + r * 4 + no;
      wrow[r] = reinterpret_cast<const VT*>(wt + static_cast<size_t>(n[r] < N ? n[r] : 0) * K);
    }
    float acc[R][WP];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int w = 0; w < WP; ++w) acc[r][w] = 0.f;
#pragma unroll 2
    for (int kv = kl; kv < KV; kv += 8) {
      VT wv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) wv[r] = __ldg(wrow[r] + kv);
#pragma unroll
      for (int w = 0; w < WP; ++w) {
        const VT xv = *reinterpret_cast<const VT*>(x + w * K + V::N * kv);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][w] = V::dot(xv, wv[r], acc[r][w]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int w = 0; w < WP; ++w) {
        acc[r][w] += __shfl_xor_sync(0xFFFFFFFFu, acc[r][w], 1);
        acc[r][w] += __shfl_xor_sync(0xFFFFFFFFu, acc[r][w], 2);
        acc[r][w] += __shfl_xor_sync(0xFFFFFFFFu, acc[r][w], 4);
      }
      if (n[r] < N) {
        const float b = to_float(bias[n[r]]);
#pragma unroll
        for (int w = 0; w < WP; ++w)
          if ((w & 7) == kl) {  // the eight lanes of a column take a row each
            float v = round_to<E>(acc[r][w] + b);
            if (mode == kRelu) v = fmaxf(v, 0.f);
            if (mode == kResidual) v = round_to<E>(v + to_float(resid[w * N + n[r]]));
            const E e = from_float<E>(v);
            if (out != nullptr) out[w * N + n[r]] = e;
            if (gout != nullptr && w < W) gout[static_cast<size_t>(w) * N + n[r]] = e;
          }
      }
    }
  }
}

// Copy the columns of buf (WP, N) that this block owns into the same place
// of every other block's shared memory, 16 bytes a thread and store (N is a
// multiple of the E values a 16-byte word holds).
template <int WP, typename E>
__device__ __forceinline__ void share(cg::cluster_group& cluster, E* buf, int N, int rank, int csize) {
  constexpr int NV = 16 / static_cast<int>(sizeof(E));
  int g0, g1;
  owned(N, rank, csize, g0, g1);
  const int c0 = g0 * kGroup, words = (min(g1 * kGroup, N) - c0) / NV;
  if (words <= 0) return;
  for (int peer = 1; peer < csize; ++peer) {
    E* dst = cluster.map_shared_rank(buf, (rank + peer) % csize);
    for (int i = threadIdx.x; i < WP * words; i += kThreads) {
      const int at = (i / words) * N + c0 + NV * (i % words);
      *reinterpret_cast<uint4*>(dst + at) = *reinterpret_cast<const uint4*>(buf + at);
    }
  }
}

// buf[idx] = v (rounded to E) in every block's shared memory
template <typename E>
__device__ __forceinline__ void bcast(cg::cluster_group& cluster, E* buf, int idx, float v, int csize) {
  const E e = from_float<E>(v);
  for (int r = 0; r < csize; ++r) cluster.map_shared_rank(buf, r)[idx] = e;
}

// Self-attention of one new position per row over the pre-write caches, a
// warp of the cluster per (beam, head): the columns l < pos plus the new
// column (k_new, v_new) as an explicit extra term of one softmax (the one
// the dense route takes after writing the cache at `pos` and masking
// l <= pos; a masked key's weight exp(-1e9 - max) is 0 in f32, so masked
// keys are skipped).  Scores f32 from the E queries and keys; the
// probabilities rounded to E before the AV product and each head's output
// rounded to E (the TPU kernel's roundings).  qs, kn, vn, att: (WP, D) in
// shared memory, qs/kn/vn complete in every block; the output goes to att
// in every block.  The rows are those of group `rg` (row w of the buffers is
// beam rg.w0 + w of utterance rg.u).  Caches: (N, L, D) rows of beam w at
// row (u W + w) L + l, or, INDIRECT, the slot anc[u, w, l] in place of w,
// any of the utterance's W slots.  scratch: kWarps x 2 lp floats (lp >= L).
// d_k is a multiple of Vec<E>::N.
template <bool INDIRECT, typename E>
__device__ __forceinline__ void cached_attention(cg::cluster_group& cluster, const E* qs, const E* kn,
                                                 const E* vn, E* att, float* scratch, int lp,
                                                 const int* __restrict__ pos, const int* __restrict__ anc,
                                                 const E* __restrict__ cache_k,
                                                 const E* __restrict__ cache_v, const RowGroup& rg, int W,
                                                 int L, int D, int H) {
  using V = Vec<E>;
  using VT = typename V::T;
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = rank * kWarps + warp, wtotal = csize * kWarps;  // warp of the cluster
  const int dk = D / H;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  float* sc = scratch + warp * (2 * lp);        // this warp's scores,
  int* rows = reinterpret_cast<int*>(sc + lp);  // and the cache row of every column
  const int u = rg.u;
  for (int item = wg; item < rg.n * H; item += wtotal) {
    const int w = item / H, hh = item % H;
    const int r = static_cast<int>(rg.row0(W)) + w;
    const int np = min(max(pos[r], 0), L);  // past columns
    const E* qh = qs + w * D + hh * dk;
    float m = -INFINITY;
    for (int l0 = 0; l0 < np; l0 += 32) {  // a lane per column
      const int l = l0 + lane;
      if (l < np) {
        int row = r;
        if (INDIRECT) row = u * W + min(max(anc[static_cast<size_t>(r) * L + l], 0), W - 1);
        row = row * L + l;
        rows[l] = row;
        const VT* kr = reinterpret_cast<const VT*>(cache_k + static_cast<size_t>(row) * D + hh * dk);
        float a = 0.f;
        for (int dv = 0; dv < dk / V::N; ++dv)
          a = V::dot(*reinterpret_cast<const VT*>(qh + V::N * dv), __ldg(kr + dv), a);
        sc[l] = a * scale;
        m = fmaxf(m, a * scale);
      }
    }
    float sn = 0.f;  // the new column
    for (int d = lane; d < dk; d += 32) sn = fmaf(to_float(qh[d]), to_float(kn[w * D + hh * dk + d]), sn);
    sn = warp_sum(sn) * scale;
    m = fmaxf(warp_max(m), sn);
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
    for (int d0 = 0; d0 < dk; d0 += 64) {  // a lane per pair of output dims
      const int da = d0 + lane, db = d0 + 32 + lane;
      const E* va = cache_v + hh * dk + (da < dk ? da : 0);
      const E* vb = cache_v + hh * dk + (db < dk ? db : 0);
      float oa = 0.f, ob = 0.f;
#pragma unroll 4
      for (int l = 0; l < np; ++l) {
        const size_t at = static_cast<size_t>(rows[l]) * D;
        const float pl = sc[l];
        oa = fmaf(pl, ldg(va + at), oa);
        ob = fmaf(pl, ldg(vb + at), ob);
      }
      if (da < dk) bcast(cluster, att, w * D + hh * dk + da, oa + pn * to_float(vn[w * D + hh * dk + da]), csize);
      if (db < dk) bcast(cluster, att, w * D + hh * dk + db, ob + pn * to_float(vn[w * D + hh * dk + db]), csize);
    }
    __syncwarp();
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

// the row padding WP of a row group of W rows: 4, 12 or 16 (W above 16
// takes groups of 16; the wrapper picks a narrower group where a block's
// shared memory needs it)
inline int padded_width(int W) { return W <= 4 ? 4 : W <= 12 ? 12 : 16; }

// clusters of an utterance of W rows in groups of WP rows
inline int row_groups(int W, int WP) { return (W + WP - 1) / WP; }

}  // namespace beam_step
