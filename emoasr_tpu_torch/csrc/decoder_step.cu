// One fused step of a pre-norm Transformer decoder layer for beam decoding,
// for Hopper (sm_90a): direct caches and ancestor-indirect caches.
//
// Replaces: emoasr_tpu/ops/decoder_step_pallas.py::fused_decoder_layer_step
// (`_kernel`) and ::fused_decoder_layer_step_indirect (`_kernel_indirect`).
//
// What one launch computes, for N = Bu * W rows (Bu utterances, W beams each):
//
//   LN1 -> Q/K/V projections -> cached self-attention -> out projection -> +res
//   -> LN2 -> query projection -> cross-attention over the utterance's encoder
//   K/V -> out projection -> +res -> LN3 -> FF (relu) -> +res
//
// and returns y, k_new, v_new; the caller writes k_new/v_new into the caches
// at `pos`.  Semantics (models/layers.py::TransformerDecoderLayer.decode_step):
// LayerNorm eps 1e-12 with f32 statistics; scores in f32; the self-attention
// attends the cache columns l < pos plus the freshly projected column as an
// explicit extra term of one softmax (the same softmax the dense path takes
// after writing the cache at `pos` and masking l <= pos); -1e9 fill and
// post-softmax zeroing give a masked key the weight exp(-1e9 - max) = 0 in
// f32, so masked keys are skipped; the W beams of an utterance attend as W
// queries over one read of that utterance's encoder K/V, masked by `elens`
// (elens == 0: the cross-attention term is zero).  float32 only, so the
// rounding of the probabilities to the activation dtype is the identity.
//
// Indirect variant: the caches stay in physical slot order (Bu, W, L, H, dk)
// and anc[u, w, l] names the slot that holds beam w's column l.  The TPU
// kernel sums W masked contractions because it cannot gather; here each
// (w, l) reads cache[u, anc[u, w, l], l] directly: the same numbers, one
// nonzero term.  Everything after the address of a cache row is shared.
//
// What bounds it on this card: at the decode shapes (Bu = 18, W = 10,
// D = 256, F = 2048, T = 399, pos ~ 64) the step reads 5.8 MB of weights,
// ~15 MB of encoder K/V and ~24 MB of live cache for ~0.6 GFLOP, so bytes
// bound it.  This version computes on the CUDA cores in f32.
//
// Design: rows of different utterances are independent, so one thread-block
// CLUSTER of C blocks (C in 1, 2, 4, 8) owns one utterance.  Every block of
// the cluster keeps the utterance's W rows (padded to WP) of every activation
// in its own shared memory.  Each phase splits its work over the cluster's
// blocks (dense products by ranges of output columns, self-attention by
// (beam, head), cross-attention by head); a block writes what it computed
// into the same place of every block's shared memory (distributed shared
// memory; the dense products write their own copy first and then push their
// columns as 16-byte words, because single 4-byte remote stores from a few
// lanes cost some hundred cycles each), and a cluster barrier ends the phase.
// With C = 1 this is one block per utterance.  The weights do not fit in shared
// memory and are streamed from L2: a dense product reads the PyTorch layout
// (out, in), eight lanes per output row (16-byte words, 128 contiguous bytes
// per row and load), sixteen rows per warp, four per lane, and three shuffles
// per accumulator reduce the eight partial sums; what limits the products is
// the shared-memory port that feeds them the activations, not the
// multiply-adds, hence four rows per lane and eight warps per block.  The loops over the
// cache stop at `pos`, not at L.  Sum orders are fixed (no atomics).
//
// The source builds into two libraries, one per variant, so that nvcc
// compiles them side by side: EMO_DECODER_STEP_INDIRECT=0 exports
// emo_decoder_step_f32, =1 exports emo_decoder_step_indirect_f32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef EMO_DECODER_STEP_INDIRECT
#error "define EMO_DECODER_STEP_INDIRECT as 0 (direct caches) or 1 (ancestor-indirect caches)"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxW = 16;
constexpr int kMaxCluster = 8;
constexpr float kLnEps = 1e-12f;

// the weights, in the order of ops/decoder_step.py::WEIGHT_NAMES
enum {
  LN1_S, LN1_B, WQ, BQ, WK, BK, WV, BV, WO, BO, LN2_S, LN2_B, CWQ, CBQ, CWO, CBO,
  LN3_S, LN3_B, W1, B1, W2, B2, kNumWeights
};

struct Params {
  const float* h;        // (N, D)
  const float* cache_k;  // (N, L, D), or (Bu, W, L, D) in slot order
  const float* cache_v;
  const int* pos;        // (N,)
  const int* anc;        // (Bu, W, L); indirect only
  const float* cross_k;  // (Bu, T, D)
  const float* cross_v;
  const int* elens;      // (Bu,)
  const float* w[kNumWeights];  // 2-D weights as (out, in) rows
  float* y;              // (N, D)
  float* k_new;          // (N, D)
  float* v_new;          // (N, D)
  int W, L, T, D, F, H;
};

// shared memory, in floats: five (WP, D) activations and one scratch region
// that holds, in turn, the warps' self-attention scores, one head's
// cross-attention scores with the partial outputs, and the FF hidden layer
struct Layout {
  int act, lp, tp, slices, scratch, total;
  __host__ __device__ Layout(int WP, int D, int F, int H, int L, int T) {
    const int dk = D / H;
    act = WP * D;
    lp = (L + 4) / 4 * 4;
    tp = (T + 3) / 4 * 4;
    const int chunks = (dk + 31) / 32;
    slices = kWarps / chunks > 0 ? kWarps / chunks : 1;
    const int self_attn = kWarps * 2 * lp;  // scores and cache rows
    const int cross = WP * tp + slices * WP * dk;
    scratch = WP * F;
    if (self_attn > scratch) scratch = self_attn;
    if (cross > scratch) scratch = cross;
    total = 5 * act + scratch;
  }
};

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

// out[w] = LayerNorm(x[w]) for the WP rows, a warp per row (flax semantics:
// f32 statistics, eps inside the square root)
template <int WP>
__device__ __forceinline__ void layer_norm(const float* x, float* out,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w < WP; w += kWarps) {
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
// goes to out[w, n] in this block's shared memory (when out is not null) and,
// for the W real rows, to gout[w, n] in device memory (when gout is not
// null).  K is a multiple of four and wt is 16-byte aligned.  What limits
// the loop is the shared-memory port: every 16-byte word of x a lane reads
// feeds sixteen multiply-adds, and a block has eight warps only, so that a
// thread may hold its 4 WP accumulators in registers.  One instance per WP
// (not inlined): the eight products of the layer share it.
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

template <int WP, bool INDIRECT>
__global__ void __launch_bounds__(kThreads, 1) decoder_step_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int u = blockIdx.x / csize;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = rank * kWarps + warp, wtotal = csize * kWarps;  // warp of the cluster
  const int W = p.W, L = p.L, T = p.T, D = p.D, F = p.F, H = p.H;
  const int dk = D / H;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  const Layout lay(WP, D, F, H, L, T);
  float* xs = smem;              // residual stream
  float* hn = xs + lay.act;      // LayerNorm output, then attention output
  float* qs = hn + lay.act;      // queries (self, then cross)
  float* kn = qs + lay.act;      // k_new
  float* vn = kn + lay.act;      // v_new
  float* scratch = vn + lay.act;
  float* att = hn;

  // store into the same place of every block's shared memory
  auto bcast = [&](float* buf, int idx, float v) {
    for (int r = 0; r < csize; ++r) cluster.map_shared_rank(buf, r)[idx] = v;
  };

  for (int i = threadIdx.x; i < WP * D; i += kThreads)
    xs[i] = i < W * D ? p.h[static_cast<size_t>(u) * W * D + i] : 0.f;
  __syncthreads();

  // ---- self-attention (cached, one new position per row) ----
  layer_norm<WP>(xs, hn, p.w[LN1_S], p.w[LN1_B], D);
  cluster.sync();  // every block of the cluster runs before any remote store
  int gd0, gd1, gf0, gf1;  // the output groups this block owns, of D and of F columns
  owned(D, rank, csize, gd0, gd1);
  owned(F, rank, csize, gf0, gf1);
  const size_t row0 = static_cast<size_t>(u) * W * D;  // the utterance's rows in device memory
  dense<WP>(hn, D, p.w[WQ], p.w[BQ], D, gd0, gd1, qs, kPlain, nullptr, nullptr, W);
  dense<WP>(hn, D, p.w[WK], p.w[BK], D, gd0, gd1, kn, kPlain, nullptr, p.k_new + row0, W);
  dense<WP>(hn, D, p.w[WV], p.w[BV], D, gd0, gd1, vn, kPlain, nullptr, p.v_new + row0, W);
  __syncthreads();
  share<WP>(cluster, qs, D, rank, csize);
  share<WP>(cluster, kn, D, rank, csize);
  share<WP>(cluster, vn, D, rank, csize);
  cluster.sync();

  {
    float* sc = scratch + warp * (2 * lay.lp);  // this warp's scores,
    int* rows = reinterpret_cast<int*>(sc + lay.lp);  // and the cache row of every column
    for (int item = wg; item < W * H; item += wtotal) {
      const int w = item / H, hh = item % H;
      const int r = u * W + w;
      const int np = min(max(p.pos[r], 0), L);  // past columns
      const float* qh = qs + w * D + hh * dk;
      float m = -INFINITY;
      for (int l0 = 0; l0 < np; l0 += 32) {  // a lane per column
        const int l = l0 + lane;
        if (l < np) {
          int row = r;
          if (INDIRECT) row = u * W + min(max(p.anc[static_cast<size_t>(r) * L + l], 0), W - 1);
          row = row * L + l;
          rows[l] = row;
          const float4* kr = reinterpret_cast<const float4*>(
              p.cache_k + static_cast<size_t>(row) * D + hh * dk);
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
        const float* va = p.cache_v + hh * dk + (da < dk ? da : 0);
        const float* vb = p.cache_v + hh * dk + (db < dk ? db : 0);
        float oa = 0.f, ob = 0.f;
#pragma unroll 4
        for (int l = 0; l < np; ++l) {
          const size_t at = static_cast<size_t>(rows[l]) * D;
          const float pl = sc[l];
          oa = fmaf(pl, __ldg(va + at), oa);
          ob = fmaf(pl, __ldg(vb + at), ob);
        }
        const float pn = en / den;
        if (da < dk) bcast(att, w * D + hh * dk + da, oa + pn * vn[w * D + hh * dk + da]);
        if (db < dk) bcast(att, w * D + hh * dk + db, ob + pn * vn[w * D + hh * dk + db]);
      }
      __syncwarp();
    }
  }
  cluster.sync();
  dense<WP>(att, D, p.w[WO], p.w[BO], D, gd0, gd1, xs, kResidual, xs, nullptr, W);
  __syncthreads();
  share<WP>(cluster, xs, D, rank, csize);
  cluster.sync();

  // ---- cross-attention: the W beams share one read of the encoder K/V ----
  layer_norm<WP>(xs, hn, p.w[LN2_S], p.w[LN2_B], D);
  __syncthreads();
  dense<WP>(hn, D, p.w[CWQ], p.w[CBQ], D, gd0, gd1, qs, kPlain, nullptr, nullptr, W);
  __syncthreads();
  share<WP>(cluster, qs, D, rank, csize);
  cluster.sync();
  {
    const int elen = min(max(p.elens[u], 0), T);
    float* scx = scratch;                  // (WP, tp): one head's scores
    float* part = scratch + WP * lay.tp;   // (slices, WP, dk): partial outputs
    const int chunks = (dk + 31) / 32;
    const int per = (elen + lay.slices - 1) / lay.slices;
    for (int hh = rank; hh < H; hh += csize) {  // a head per block
      for (int t0 = warp * 32; t0 < elen; t0 += kWarps * 32) {  // a lane per frame
        const int t = t0 + lane;
        if (t < elen) {
          const float4* kr = reinterpret_cast<const float4*>(
              p.cross_k + (static_cast<size_t>(u) * T + t) * D + hh * dk);
          float acc[WP];
#pragma unroll
          for (int w = 0; w < WP; ++w) acc[w] = 0.f;
          for (int d4 = 0; d4 < dk / 4; ++d4) {
            const float4 kv = __ldg(kr + d4);
#pragma unroll
            for (int w = 0; w < WP; ++w)
              acc[w] = dot4(*reinterpret_cast<const float4*>(qs + w * D + hh * dk + 4 * d4), kv, acc[w]);
          }
#pragma unroll
          for (int w = 0; w < WP; ++w) scx[w * lay.tp + t] = acc[w] * scale;
        }
      }
      __syncthreads();
      for (int w = warp; w < W; w += kWarps) {  // softmax, a warp per beam
        float* row = scx + w * lay.tp;
        float m = -INFINITY;
        for (int t = lane; t < elen; t += 32) m = fmaxf(m, row[t]);
        m = warp_max(m);
        float den = 0.f;
        for (int t = lane; t < elen; t += 32) {
          const float e = expf(row[t] - m);
          row[t] = e;
          den += e;
        }
        den = warp_sum(den);
        for (int t = lane; t < elen; t += 32) row[t] = row[t] / den;
      }
      __syncthreads();
      // P V: a warp per (chunk of 32 output dims, slice of the frames)
      for (int item = warp; item < chunks * lay.slices; item += kWarps) {
        const int d = (item % chunks) * 32 + lane, s = item / chunks;
        const int ta = s * per, tb = min(elen, ta + per);
        if (d < dk) {
          float acc[WP];
#pragma unroll
          for (int w = 0; w < WP; ++w) acc[w] = 0.f;
          const float* vc = p.cross_v + static_cast<size_t>(u) * T * D + hh * dk + d;
          for (int t = ta; t < tb; ++t) {
            const float v = __ldg(vc + static_cast<size_t>(t) * D);
#pragma unroll
            for (int w = 0; w < WP; ++w) acc[w] = fmaf(scx[w * lay.tp + t], v, acc[w]);
          }
#pragma unroll
          for (int w = 0; w < WP; ++w) part[(s * WP + w) * dk + d] = acc[w];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < W * dk; i += kThreads) {
        const int w = i / dk, d = i % dk;
        float o = 0.f;
        for (int s = 0; s < lay.slices; ++s) o += part[(s * WP + w) * dk + d];
        bcast(att, w * D + hh * dk + d, o);
      }
      __syncthreads();  // the next head reuses the scratch
    }
  }
  cluster.sync();
  dense<WP>(att, D, p.w[CWO], p.w[CBO], D, gd0, gd1, xs, kResidual, xs, nullptr, W);
  __syncthreads();
  share<WP>(cluster, xs, D, rank, csize);
  cluster.sync();

  // ---- feed-forward ----
  layer_norm<WP>(xs, hn, p.w[LN3_S], p.w[LN3_B], D);
  __syncthreads();
  float* ff = scratch;  // (WP, F)
  dense<WP>(hn, D, p.w[W1], p.w[B1], F, gf0, gf1, ff, kRelu, nullptr, nullptr, W);
  __syncthreads();
  share<WP>(cluster, ff, F, rank, csize);
  cluster.sync();
  dense<WP>(ff, F, p.w[W2], p.w[B2], D, gd0, gd1, nullptr, kResidual, xs, p.y + row0, W);
  __syncthreads();
}

template <int WP, bool INDIRECT>
int launch_wp(const Params& p, int Bu, int cluster, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Layout(WP, p.D, p.F, p.H, p.L, p.T).total) * sizeof(float);
  auto kernel = decoder_step_kernel<WP, INDIRECT>;
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

template <bool INDIRECT>
int launch(const void* h, const void* cache_k, const void* cache_v, const void* pos,
           const void* anc, const void* cross_k, const void* cross_v, const void* elens,
           const void* const* weights, void* y, void* k_new, void* v_new, int Bu, int W, int L,
           int T, int D, int F, int H, int cluster, void* stream) {
  if (Bu < 1 || W < 1 || W > kMaxW || H < 1 || D % H != 0 || (D / H) % 4 != 0 || F % 4 != 0
      || L < 1 || T < 1 || cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.h = static_cast<const float*>(h);
  p.cache_k = static_cast<const float*>(cache_k);
  p.cache_v = static_cast<const float*>(cache_v);
  p.pos = static_cast<const int*>(pos);
  p.anc = static_cast<const int*>(anc);
  p.cross_k = static_cast<const float*>(cross_k);
  p.cross_v = static_cast<const float*>(cross_v);
  p.elens = static_cast<const int*>(elens);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = static_cast<const float*>(weights[i]);
  p.y = static_cast<float*>(y);
  p.k_new = static_cast<float*>(k_new);
  p.v_new = static_cast<float*>(v_new);
  p.W = W; p.L = L; p.T = T; p.D = D; p.F = F; p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W <= 4) return launch_wp<4, INDIRECT>(p, Bu, cluster, st);
  if (W <= 12) return launch_wp<12, INDIRECT>(p, Bu, cluster, st);
  return launch_wp<16, INDIRECT>(p, Bu, cluster, st);
}

}  // namespace

extern "C" {

// shared memory one block needs, in bytes (the wrapper holds it against the
// card's limit before it launches)
int emo_decoder_step_smem_bytes(int W, int L, int T, int D, int F, int H) {
  const int WP = W <= 4 ? 4 : W <= 12 ? 12 : 16;
  return static_cast<int>(Layout(WP, D, F, H, L, T).total * sizeof(float));
}

// `weights`: host array of the 22 device pointers in WEIGHT_NAMES order, the
// 2-D ones as contiguous (out, in) rows; `cluster`: blocks per utterance
#if EMO_DECODER_STEP_INDIRECT
int emo_decoder_step_indirect_f32(const void* h, const void* cache_k, const void* cache_v,
                                  const void* pos, const void* anc, const void* cross_k,
                                  const void* cross_v, const void* elens,
                                  const void* const* weights, void* y, void* k_new, void* v_new,
                                  int Bu, int W, int L, int T, int D, int F, int H, int cluster,
                                  void* stream) {
  return launch<true>(h, cache_k, cache_v, pos, anc, cross_k, cross_v, elens, weights, y, k_new,
                      v_new, Bu, W, L, T, D, F, H, cluster, stream);
}
#else
int emo_decoder_step_f32(const void* h, const void* cache_k, const void* cache_v,
                         const void* pos, const void* cross_k, const void* cross_v,
                         const void* elens, const void* const* weights, void* y, void* k_new,
                         void* v_new, int Bu, int W, int L, int T, int D, int F, int H,
                         int cluster, void* stream) {
  return launch<false>(h, cache_k, cache_v, pos, nullptr, cross_k, cross_v, elens, weights, y,
                       k_new, v_new, Bu, W, L, T, D, F, H, cluster, stream);
}
#endif

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
