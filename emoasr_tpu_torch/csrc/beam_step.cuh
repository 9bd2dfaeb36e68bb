// What the fused layer steps of beam decoding share (csrc/decoder_step.cu,
// K5, and csrc/lm_step.cu, K6): a thread-block cluster of C blocks (C in 1,
// 2, 4, 8) owns one utterance; every block keeps the utterance's W rows
// (padded to WP) of each activation in its own shared memory; a phase splits
// its work over the cluster's blocks and each block writes what it computed
// into the same place of every block's shared memory (distributed shared
// memory) before a cluster barrier ends the phase.  The weights stream from
// L2 in nn.Linear's (out, in) layout.  Sum orders are fixed (no atomics).
//
// The kernels' build hashes this header with each source that includes it
// (ops/cuda_lib.py), so an edit here rebuilds both.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace beam_step {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxW = 16;
constexpr int kMaxCluster = 8;
constexpr float kLnEps = 1e-12f;

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

// out[w] = LayerNorm(x[w]) for the rows w = first, first + step, ... < rows,
// a warp per row (flax semantics: f32 statistics, eps inside the square
// root); x and out may be the same buffer
__device__ __forceinline__ void layer_norm(const float* x, float* out, const float* __restrict__ scale,
                                           const float* __restrict__ bias, int D, int rows, int first,
                                           int step) {
  const int lane = threadIdx.x & 31;
  for (int w = first; w < rows; w += step) {
    const float* xr = x + w * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += xr[d];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) v += (xr[d] - mean) * (xr[d] - mean);
    const float rstd = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int d = lane; d < D; d += 32) out[w * D + d] = (xr[d] - mean) * rstd * scale[d] + bias[d];
  }
}

enum { kPlain = 0, kRelu = 1, kResidual = 2 };
constexpr int kGroup = 16;  // output columns a warp takes at a time

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
// (row w, column n), after relu (kRelu) or plus resid[w, n] (kResidual),
// goes to out[w, n] in this block's shared memory
// (when out is not null) and, for the W real rows, to gout[w, n] in device
// memory (when gout is not null).  K is a multiple of four and wt is 16-byte
// aligned.  What limits the loop is the shared-memory port: every 16-byte
// word of x a lane reads feeds sixteen multiply-adds, and a block has eight
// warps only, so that a thread may hold its 4 WP accumulators in registers.
// One instance per WP (not inlined): the products of a layer share it.
template <int WP>
__device__ __noinline__ void dense(const float* x, int K, const float* __restrict__ wt,
                                   const float* __restrict__ bias, int N, int g0, int g1,
                                   float* out, int mode, const float* resid,
                                   float* __restrict__ gout, int W) {
  constexpr int R = kGroup / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kl = lane & 7, no = lane >> 3;
  const int K4 = K >> 2;
  for (int g = g0 + warp; g < g1; g += kWarps) {
    const float4* wrow[R];
    int n[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      n[r] = g * kGroup + r * 4 + no;
      wrow[r] = reinterpret_cast<const float4*>(wt + static_cast<size_t>(n[r] < N ? n[r] : 0) * K);
    }
    float acc[R][WP];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int w = 0; w < WP; ++w) acc[r][w] = 0.f;
#pragma unroll 2
    for (int k4 = kl; k4 < K4; k4 += 8) {
      float4 wv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) wv[r] = __ldg(wrow[r] + k4);
#pragma unroll
      for (int w = 0; w < WP; ++w) {
        const float4 xv = *reinterpret_cast<const float4*>(x + w * K + 4 * k4);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][w] = dot4(xv, wv[r], acc[r][w]);
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
        const float b = bias[n[r]];
#pragma unroll
        for (int w = 0; w < WP; ++w)
          if ((w & 7) == kl) {  // the eight lanes of a column take a row each
            float v = acc[r][w] + b;
            if (mode == kRelu) v = fmaxf(v, 0.f);
            if (mode == kResidual) v += resid[w * N + n[r]];
            if (out != nullptr) out[w * N + n[r]] = v;
            if (gout != nullptr && w < W) gout[static_cast<size_t>(w) * N + n[r]] = v;
          }
      }
    }
  }
}

// Copy the columns of buf (WP, N) that this block owns into the same place
// of every other block's shared memory, 16 bytes a thread and store.
template <int WP>
__device__ __forceinline__ void share(cg::cluster_group& cluster, float* buf, int N, int rank,
                                      int csize) {
  int g0, g1;
  owned(N, rank, csize, g0, g1);
  const int c0 = g0 * kGroup, words = (min(g1 * kGroup, N) - c0) / 4;  // N is a multiple of four
  if (words <= 0) return;
  for (int peer = 1; peer < csize; ++peer) {
    float* dst = cluster.map_shared_rank(buf, (rank + peer) % csize);
    for (int i = threadIdx.x; i < WP * words; i += kThreads) {
      const int at = (i / words) * N + c0 + 4 * (i % words);
      *reinterpret_cast<float4*>(dst + at) = *reinterpret_cast<const float4*>(buf + at);
    }
  }
}

// buf[idx] = v in every block's shared memory
__device__ __forceinline__ void bcast(cg::cluster_group& cluster, float* buf, int idx, float v, int csize) {
  for (int r = 0; r < csize; ++r) cluster.map_shared_rank(buf, r)[idx] = v;
}

// Self-attention of one new position per row over the pre-write caches, a
// warp of the cluster per (beam, head): the columns l < pos plus the new
// column (k_new, v_new) as an explicit extra term of one softmax (the one
// the dense route takes after writing the cache at `pos` and masking
// l <= pos; a masked key's weight exp(-1e9 - max) is 0 in f32, so masked
// keys are skipped).  qs, kn, vn, att: (WP, D) in shared memory, qs/kn/vn
// complete in every block; the output goes to att in every block.  Caches:
// (N, L, D) rows of beam w at row (u W + w) L + l, or, INDIRECT, the slot
// anc[u, w, l] in place of w.  scratch: kWarps x 2 lp floats (lp >= L).
template <bool INDIRECT>
__device__ __forceinline__ void cached_attention(cg::cluster_group& cluster, const float* qs, const float* kn,
                                                 const float* vn, float* att, float* scratch, int lp,
                                                 const int* __restrict__ pos, const int* __restrict__ anc,
                                                 const float* __restrict__ cache_k,
                                                 const float* __restrict__ cache_v, int u, int W, int L, int D,
                                                 int H) {
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = rank * kWarps + warp, wtotal = csize * kWarps;  // warp of the cluster
  const int dk = D / H;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  float* sc = scratch + warp * (2 * lp);        // this warp's scores,
  int* rows = reinterpret_cast<int*>(sc + lp);  // and the cache row of every column
  for (int item = wg; item < W * H; item += wtotal) {
    const int w = item / H, hh = item % H;
    const int r = u * W + w;
    const int np = min(max(pos[r], 0), L);  // past columns
    const float* qh = qs + w * D + hh * dk;
    float m = -INFINITY;
    for (int l0 = 0; l0 < np; l0 += 32) {  // a lane per column
      const int l = l0 + lane;
      if (l < np) {
        int row = r;
        if (INDIRECT) row = u * W + min(max(anc[static_cast<size_t>(r) * L + l], 0), W - 1);
        row = row * L + l;
        rows[l] = row;
        const float4* kr = reinterpret_cast<const float4*>(cache_k + static_cast<size_t>(row) * D + hh * dk);
        float a = 0.f;
        for (int d4 = 0; d4 < dk / 4; ++d4)
          a = dot4(*reinterpret_cast<const float4*>(qh + 4 * d4), __ldg(kr + d4), a);
        sc[l] = a * scale;
        m = fmaxf(m, a * scale);
      }
    }
    float sn = 0.f;  // the new column
    for (int d = lane; d < dk; d += 32) sn = fmaf(qh[d], kn[w * D + hh * dk + d], sn);
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
    for (int l = lane; l < np; l += 32) sc[l] = sc[l] / den;
    __syncwarp();
    for (int d0 = 0; d0 < dk; d0 += 64) {  // a lane per pair of output dims
      const int da = d0 + lane, db = d0 + 32 + lane;
      const float* va = cache_v + hh * dk + (da < dk ? da : 0);
      const float* vb = cache_v + hh * dk + (db < dk ? db : 0);
      float oa = 0.f, ob = 0.f;
#pragma unroll 4
      for (int l = 0; l < np; ++l) {
        const size_t at = static_cast<size_t>(rows[l]) * D;
        const float pl = sc[l];
        oa = fmaf(pl, __ldg(va + at), oa);
        ob = fmaf(pl, __ldg(vb + at), ob);
      }
      const float pn = en / den;
      if (da < dk) bcast(cluster, att, w * D + hh * dk + da, oa + pn * vn[w * D + hh * dk + da], csize);
      if (db < dk) bcast(cluster, att, w * D + hh * dk + db, ob + pn * vn[w * D + hh * dk + db], csize);
    }
    __syncwarp();
  }
}

// Launch `kernel(p)` on Bu clusters of `cluster` blocks of kThreads threads
// with `smem` bytes of dynamic shared memory; returns the cudaError_t.
template <typename Params>
int launch_clusters(void (*kernel)(const Params), const Params& p, int Bu, int cluster, size_t smem,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(Bu * cluster));
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

// the row padding WP of a beam width W: 4, 12 or 16
inline int padded_width(int W) { return W <= 4 ? 4 : W <= 12 ? 12 : 16; }

}  // namespace beam_step
