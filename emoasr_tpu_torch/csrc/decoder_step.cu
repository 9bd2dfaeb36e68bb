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
// (elens == 0: the cross-attention term is zero).
//
// Types: h, the caches, the encoder K/V, the weights and the outputs share
// one storage type, float32 or bfloat16 (the TPU kernel's activation dtype
// `adt`), and so do the activations in shared memory.  Every sum is f32;
// the TPU kernel's rounding points are kept: every dense product rounds
// once to adt after adding its f32 bias, LayerNorm statistics are f32 and
// its output is rounded, the scores are f32 from the adt queries and keys,
// p_past / p_new and the cross-attention's p are rounded before their AV
// products, each head's output is rounded, and every residual add is an
// add in adt (x = h + dense(.), x = x + dense(.), y = x + ff).  In float32
// each rounding is the identity.
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
// bound it; in bf16 each of those byte counts halves.  This version
// computes on the CUDA cores in f32 (bf16 values widen exactly).
//
// Design (its helpers shared with csrc/lm_step.cu, K6, in csrc/beam_step.cuh):
// beam rows are independent within a layer step (each reads its own or its
// ancestors' cache columns l < pos, which no launch writes, and the
// utterance's encoder K/V), so one thread-block CLUSTER of C blocks (C in
// 1, 2, 4, 8) owns one row group: up to WP (4, 12 or 16, the wrapper's
// choice) of an utterance's W rows, ceil(W / WP) clusters an utterance.
// Every block of the cluster keeps the group's rows (padded to WP) of every
// activation in its own shared memory.  Each phase splits its work over the cluster's
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
// emo_decoder_step_{f32,bf16}, =1 exports emo_decoder_step_indirect_{f32,bf16}.

#include "beam_step.cuh"

#ifndef EMO_DECODER_STEP_INDIRECT
#error "define EMO_DECODER_STEP_INDIRECT as 0 (direct caches) or 1 (ancestor-indirect caches)"
#endif

namespace {

using namespace beam_step;

// the weights, in the order of ops/decoder_step.py::WEIGHT_NAMES
enum {
  LN1_S, LN1_B, WQ, BQ, WK, BK, WV, BV, WO, BO, LN2_S, LN2_B, CWQ, CBQ, CWO, CBO,
  LN3_S, LN3_B, W1, B1, W2, B2, kNumWeights
};

template <typename E>
struct Params {
  const E* h;            // (N, D)
  const E* cache_k;      // (N, L, D), or (Bu, W, L, D) in slot order
  const E* cache_v;
  const int* pos;        // (N,)
  const int* anc;        // (Bu, W, L); indirect only
  const E* cross_k;      // (Bu, T, D)
  const E* cross_v;
  const int* elens;      // (Bu,)
  const E* w[kNumWeights];  // 2-D weights as (out, in) rows
  E* y;                  // (N, D)
  E* k_new;              // (N, D)
  E* v_new;              // (N, D)
  int W, L, T, D, F, H;
};

// shared memory, in bytes: five (WP, D) activations of es bytes an element,
// and one scratch region that holds, in turn, the warps' self-attention
// scores (f32), one head's cross-attention scores with the partial outputs
// (f32), and the FF hidden layer (WP, F) of es-byte elements
struct Layout {
  int act, lp, tp, slices, scratch, total;
  __host__ __device__ Layout(int WP, int D, int F, int H, int L, int T, int es) {
    const int dk = D / H;
    act = WP * D * es;
    lp = (L + 4) / 4 * 4;
    tp = (T + 3) / 4 * 4;
    const int chunks = (dk + 31) / 32;
    slices = kWarps / chunks > 0 ? kWarps / chunks : 1;
    const int self_attn = kWarps * 2 * lp * 4;  // scores and cache rows
    const int cross = (WP * tp + slices * WP * dk) * 4;
    scratch = WP * F * es;
    if (self_attn > scratch) scratch = self_attn;
    if (cross > scratch) scratch = cross;
    total = 5 * act + scratch;
  }
};

template <int WP, bool INDIRECT, typename E>
__global__ void __launch_bounds__(kThreads, 1) decoder_step_kernel(const Params<E> p) {
  using V = Vec<E>;
  using VT = typename V::T;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = p.W, L = p.L, T = p.T, D = p.D, F = p.F, H = p.H;
  const RowGroup rg(blockIdx.x / csize, W, WP);
  const int u = rg.u, Wg = rg.n;  // the utterance, and the group's rows
  const size_t row0 = rg.row0(W) * D;  // the group's rows in device memory
  const int dk = D / H;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  const Layout lay(WP, D, F, H, L, T, sizeof(E));
  E* xs = reinterpret_cast<E*>(smem);  // residual stream
  E* hn = xs + WP * D;                 // LayerNorm output, then attention output
  E* qs = hn + WP * D;                 // queries (self, then cross)
  E* kn = qs + WP * D;                 // k_new
  E* vn = kn + WP * D;                 // v_new
  float* scratch = reinterpret_cast<float*>(smem + 5 * lay.act);
  E* att = hn;

  for (int i = threadIdx.x; i < WP * D; i += kThreads)
    xs[i] = i < Wg * D ? p.h[row0 + i] : from_float<E>(0.f);
  __syncthreads();

  // ---- self-attention (cached, one new position per row) ----
  layer_norm(xs, hn, p.w[LN1_S], p.w[LN1_B], D, WP, warp, kWarps);
  cluster.sync();  // every block of the cluster runs before any remote store
  int gd0, gd1, gf0, gf1;  // the output groups this block owns, of D and of F columns
  owned(D, rank, csize, gd0, gd1);
  owned(F, rank, csize, gf0, gf1);
  dense<WP, E>(hn, D, p.w[WQ], p.w[BQ], D, gd0, gd1, qs, kPlain, nullptr, nullptr, Wg);
  dense<WP, E>(hn, D, p.w[WK], p.w[BK], D, gd0, gd1, kn, kPlain, nullptr, p.k_new + row0, Wg);
  dense<WP, E>(hn, D, p.w[WV], p.w[BV], D, gd0, gd1, vn, kPlain, nullptr, p.v_new + row0, Wg);
  __syncthreads();
  share<WP>(cluster, qs, D, rank, csize);
  share<WP>(cluster, kn, D, rank, csize);
  share<WP>(cluster, vn, D, rank, csize);
  cluster.sync();

  cached_attention<INDIRECT>(cluster, qs, kn, vn, att, scratch, lay.lp, p.pos, p.anc, p.cache_k, p.cache_v,
                             rg, W, L, D, H);
  cluster.sync();
  dense<WP, E>(att, D, p.w[WO], p.w[BO], D, gd0, gd1, xs, kResidual, xs, nullptr, Wg);
  __syncthreads();
  share<WP>(cluster, xs, D, rank, csize);
  cluster.sync();

  // ---- cross-attention: the W beams share one read of the encoder K/V ----
  layer_norm(xs, hn, p.w[LN2_S], p.w[LN2_B], D, WP, warp, kWarps);
  __syncthreads();
  dense<WP, E>(hn, D, p.w[CWQ], p.w[CBQ], D, gd0, gd1, qs, kPlain, nullptr, nullptr, Wg);
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
          const VT* kr = reinterpret_cast<const VT*>(
              p.cross_k + (static_cast<size_t>(u) * T + t) * D + hh * dk);
          float acc[WP];
#pragma unroll
          for (int w = 0; w < WP; ++w) acc[w] = 0.f;
          for (int dv = 0; dv < dk / V::N; ++dv) {
            const VT kv = __ldg(kr + dv);
#pragma unroll
            for (int w = 0; w < WP; ++w)
              acc[w] = V::dot(*reinterpret_cast<const VT*>(qs + w * D + hh * dk + V::N * dv), kv, acc[w]);
          }
#pragma unroll
          for (int w = 0; w < WP; ++w) scx[w * lay.tp + t] = acc[w] * scale;
        }
      }
      __syncthreads();
      for (int w = warp; w < Wg; w += kWarps) {  // softmax, a warp per beam; p rounded to E
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
        for (int t = lane; t < elen; t += 32) row[t] = round_to<E>(row[t] / den);
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
          const E* vc = p.cross_v + static_cast<size_t>(u) * T * D + hh * dk + d;
          for (int t = ta; t < tb; ++t) {
            const float v = ldg(vc + static_cast<size_t>(t) * D);
#pragma unroll
            for (int w = 0; w < WP; ++w) acc[w] = fmaf(scx[w * lay.tp + t], v, acc[w]);
          }
#pragma unroll
          for (int w = 0; w < WP; ++w) part[(s * WP + w) * dk + d] = acc[w];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < Wg * dk; i += kThreads) {  // the head's output, rounded to E
        const int w = i / dk, d = i % dk;
        float o = 0.f;
        for (int s = 0; s < lay.slices; ++s) o += part[(s * WP + w) * dk + d];
        bcast(cluster, att, w * D + hh * dk + d, o, csize);
      }
      __syncthreads();  // the next head reuses the scratch
    }
  }
  cluster.sync();
  dense<WP, E>(att, D, p.w[CWO], p.w[CBO], D, gd0, gd1, xs, kResidual, xs, nullptr, Wg);
  __syncthreads();
  share<WP>(cluster, xs, D, rank, csize);
  cluster.sync();

  // ---- feed-forward ----
  layer_norm(xs, hn, p.w[LN3_S], p.w[LN3_B], D, WP, warp, kWarps);
  __syncthreads();
  E* ff = reinterpret_cast<E*>(scratch);  // (WP, F)
  dense<WP, E>(hn, D, p.w[W1], p.w[B1], F, gf0, gf1, ff, kRelu, nullptr, nullptr, Wg);
  __syncthreads();
  share<WP>(cluster, ff, F, rank, csize);
  cluster.sync();
  dense<WP, E>(ff, F, p.w[W2], p.w[B2], D, gd0, gd1, nullptr, kResidual, xs, p.y + row0, Wg);
  __syncthreads();
}

template <int WP, bool INDIRECT, typename E>
int launch_wp(const Params<E>& p, int Bu, int cluster, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Layout(WP, p.D, p.F, p.H, p.L, p.T, sizeof(E)).total);
  return launch_clusters(decoder_step_kernel<WP, INDIRECT, E>, p, Bu * row_groups(p.W, WP), cluster, smem,
                         stream);
}

template <bool INDIRECT, typename E>
int launch(const void* h, const void* cache_k, const void* cache_v, const void* pos,
           const void* anc, const void* cross_k, const void* cross_v, const void* elens,
           const void* const* weights, void* y, void* k_new, void* v_new, int Bu, int W, int L,
           int T, int D, int F, int H, int group, int cluster, void* stream) {
  constexpr int NV = Vec<E>::N;
  if (Bu < 1 || W < 1 || (group != 4 && group != 12 && group != 16) || group > padded_width(W) || H < 1
      || D % H != 0 || (D / H) % NV != 0 || F % NV != 0 || L < 1 || T < 1 || cluster < 1
      || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<E> p;
  p.h = static_cast<const E*>(h);
  p.cache_k = static_cast<const E*>(cache_k);
  p.cache_v = static_cast<const E*>(cache_v);
  p.pos = static_cast<const int*>(pos);
  p.anc = static_cast<const int*>(anc);
  p.cross_k = static_cast<const E*>(cross_k);
  p.cross_v = static_cast<const E*>(cross_v);
  p.elens = static_cast<const int*>(elens);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = static_cast<const E*>(weights[i]);
  p.y = static_cast<E*>(y);
  p.k_new = static_cast<E*>(k_new);
  p.v_new = static_cast<E*>(v_new);
  p.W = W; p.L = L; p.T = T; p.D = D; p.F = F; p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group == 4) return launch_wp<4, INDIRECT, E>(p, Bu, cluster, st);
  if (group == 12) return launch_wp<12, INDIRECT, E>(p, Bu, cluster, st);
  return launch_wp<16, INDIRECT, E>(p, Bu, cluster, st);
}

}  // namespace

extern "C" {

// shared memory one block needs, in bytes, for row groups of up to W rows
// and elements of `es` bytes (the wrapper picks the widest group that the
// card's limit takes)
int emo_decoder_step_smem_bytes(int W, int L, int T, int D, int F, int H, int es) {
  return Layout(padded_width(W), D, F, H, L, T, es).total;
}

// `weights`: host array of the 22 device pointers in WEIGHT_NAMES order, the
// 2-D ones as contiguous (out, in) rows, all of the activations' type;
// `group`: the rows of a row group (4, 12 or 16, at most W rounded up to
// one of them); `cluster`: blocks per row group
#if EMO_DECODER_STEP_INDIRECT
#define EMO_STEP_ARGS                                                                            \
  const void *h, const void *cache_k, const void *cache_v, const void *pos, const void *anc,     \
      const void *cross_k, const void *cross_v, const void *elens, const void *const *weights,   \
      void *y, void *k_new, void *v_new, int Bu, int W, int L, int T, int D, int F, int H,        \
      int group, int cluster, void *stream
#define EMO_STEP_CALL(E)                                                                         \
  launch<true, E>(h, cache_k, cache_v, pos, anc, cross_k, cross_v, elens, weights, y, k_new,     \
                  v_new, Bu, W, L, T, D, F, H, group, cluster, stream)
int emo_decoder_step_indirect_f32(EMO_STEP_ARGS) { return EMO_STEP_CALL(float); }
int emo_decoder_step_indirect_bf16(EMO_STEP_ARGS) { return EMO_STEP_CALL(__nv_bfloat16); }
#else
#define EMO_STEP_ARGS                                                                            \
  const void *h, const void *cache_k, const void *cache_v, const void *pos,                      \
      const void *cross_k, const void *cross_v, const void *elens, const void *const *weights,   \
      void *y, void *k_new, void *v_new, int Bu, int W, int L, int T, int D, int F, int H,        \
      int group, int cluster, void *stream
#define EMO_STEP_CALL(E)                                                                         \
  launch<false, E>(h, cache_k, cache_v, pos, nullptr, cross_k, cross_v, elens, weights, y,       \
                   k_new, v_new, Bu, W, L, T, D, F, H, group, cluster, stream)
int emo_decoder_step_f32(EMO_STEP_ARGS) { return EMO_STEP_CALL(float); }
int emo_decoder_step_bf16(EMO_STEP_ARGS) { return EMO_STEP_CALL(__nv_bfloat16); }
#endif

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
