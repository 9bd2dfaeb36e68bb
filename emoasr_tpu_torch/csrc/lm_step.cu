// One fused step of a post-norm Transformer-LM (BERT) layer for beam
// decoding with ancestor-indirect caches, for Hopper (sm_90a).
//
// Replaces: emoasr_tpu/ops/lm_step_pallas.py::fused_bert_layer_step_indirect
// (`_kernel`).
//
// What one launch computes, for N = Bu * W rows (Bu utterances, W beams each):
//
//   Q/K/V projections -> causal self-attention over the cache -> out projection
//   -> LN(x + .) -> FF (exact gelu) -> LN(x + .)
//
// and returns y, k_new, v_new; the caller writes k_new/v_new into the caches
// at `pos`.  Semantics (models/lm/bert.py::BertLayer.step_indirect):
// LayerNorm eps 1e-12 with f32 statistics; scores in f32; the attention takes
// the cache columns l < pos plus the freshly projected column as an explicit
// extra term of one softmax (the same softmax the dense path takes after
// writing the cache at `pos` and masking l <= pos); the caches stay in
// physical slot order (Bu, W, L, H, dk) and anc[u, w, l] names the slot that
// holds beam w's column l, read in place (the TPU kernel sums W masked
// contractions because it cannot gather: the same numbers, one nonzero
// term).  gelu is 0.5 x (1 + erf(x / sqrt 2)) with XLA's float32 erf
// polynomial (clamp to [-4, 4], a ratio of an odd and an even polynomial),
// the polynomial the TPU kernel inlines.
//
// Types: h, the caches, the weights and the outputs share one storage type,
// float32 or bfloat16 (the TPU kernel's `adt`), and so do the activations in
// shared memory.  Every sum is f32; the TPU kernel's rounding points are
// kept: every dense product rounds once to adt after its f32 bias, the
// probabilities and each head's output are rounded, each residual add
// (h + dense(.), x + dense(.)) is an add in adt before its LayerNorm (f32
// statistics, output rounded), and dense(x, wi) is rounded, widened to f32
// for the gelu (erf_f32 stays f32) and the gelu's output rounded again.
//
// What bounds it on this card: at the L3-3 shapes (Bu = 18, W = 10, D = 512,
// F = 2048, pos ~ 64) the step reads 12.6 MB of weights and ~47 MB of live
// cache for ~1.1 GFLOP; bytes and operations weigh about the same (in bf16
// the bytes halve).  This version computes on the CUDA cores in f32 (bf16
// values widen exactly).
//
// Design: that of csrc/decoder_step.cu (K5), with the helpers the two share
// in csrc/beam_step.cuh.  One thread-block CLUSTER of C blocks (C in 1, 2, 4,
// 8) owns one row group of an utterance (up to WP = 4, 12 or 16 of its W
// rows, ceil(W / WP) clusters an utterance: the rows do not interact within
// a layer step); every block keeps the group's rows (padded to WP) of the
// activations in its shared memory; the dense products split their output
// columns over the cluster, the attention its (beam, head) items, and a
// block writes what it computed into every block's shared memory
// (distributed shared memory) before a cluster barrier ends the phase.  The
// weights stream from L2 in nn.Linear's (out, in) layout.  What differs
// from K5: post-norm (a LayerNorm after each residual, which every block
// computes for itself on its full copy of the rows), gelu in place of relu,
// no cross-attention, and the shared memory.  At D = 512 and F = 2048, K5's
// layout (five (WP, D) rows and the (WP, F) hidden layer beside them) would
// need 216 KB at WP = 12 and 288 KB at WP = 16 in f32.  Here only two (WP,
// D) buffers live through the whole step (the residual stream and the
// attention output); the queries, the new keys and values and the attention
// scratch are dead once the attention is done, and the FF hidden layer
// reuses their room: 144 KB at WP = 12 and 192 KB at WP = 16 in f32, half
// the activations' share of that in bf16.  The loops over the cache stop at `pos`.  Sum orders
// are fixed (no atomics).

#include "beam_step.cuh"

namespace {

using namespace beam_step;

// XLA's float32 erf (ErfImpl32: clamp to [-4, 4], a ratio of an odd and an
// even polynomial), the polynomial the TPU LM-step kernel inlines
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

// the weights, in the order of ops/lm_step.py::WEIGHT_NAMES
enum {
  WQ, BQ, WK, BK, WV, BV, WO, BO, LN1_S, LN1_B, WI, BI, WO2, BO2, LN2_S, LN2_B, kNumWeights
};

template <typename E>
struct Params {
  const E* h;            // (N, D)
  const E* cache_k;      // (Bu, W, L, D) in slot order
  const E* cache_v;
  const int* pos;        // (N,)
  const int* anc;        // (Bu, W, L)
  const E* w[kNumWeights];  // 2-D weights as (out, in) rows
  E* y;                  // (N, D)
  E* k_new;              // (N, D)
  E* v_new;              // (N, D)
  int W, L, D, F, H;
};

// shared memory, in bytes: the residual stream and the attention output,
// (WP, D) elements of es bytes each, then one region that holds the queries,
// the new keys and values and the warps' attention scratch (f32) during the
// attention, and the FF hidden layer (WP, F) after it
struct Layout {
  int act, lp, region, total;
  __host__ __device__ Layout(int WP, int D, int F, int L, int es) {
    act = WP * D * es;
    lp = (L + 4) / 4 * 4;
    const int attention = 3 * act + kWarps * 2 * lp * 4;  // q, k_new, v_new; scores and cache rows
    region = WP * F * es > attention ? WP * F * es : attention;
    total = 2 * act + region;
  }
};

template <int WP, typename E>
__global__ void __launch_bounds__(kThreads, 1) lm_step_kernel(const Params<E> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int wg = rank * kWarps + warp, wtotal = csize * kWarps;  // warp of the cluster
  const int W = p.W, L = p.L, D = p.D, F = p.F, H = p.H;
  const RowGroup rg(blockIdx.x / csize, W, WP);
  const int Wg = rg.n;                 // the group's rows
  const size_t row0 = rg.row0(W) * D;  // the group's rows in device memory
  const Layout lay(WP, D, F, L, sizeof(E));
  E* xs = reinterpret_cast<E*>(smem);  // residual stream
  E* att = xs + WP * D;                // attention output, then the second residual sum
  E* qs = att + WP * D;                // queries       } the attention's room,
  E* kn = qs + WP * D;                 // k_new         } then the FF hidden
  E* vn = kn + WP * D;                 // v_new         } layer (WP, F)
  float* scratch = reinterpret_cast<float*>(smem + 5 * lay.act);
  E* ff = qs;

  for (int i = threadIdx.x; i < WP * D; i += kThreads) {
    xs[i] = i < Wg * D ? p.h[row0 + i] : from_float<E>(0.f);
    att[i] = from_float<E>(0.f);
  }
  __syncthreads();
  cluster.sync();  // every block of the cluster runs before any remote store

  // ---- Q/K/V projections ----
  int gd0, gd1, gf0, gf1;  // the output groups this block owns, of D and of F columns
  owned(D, rank, csize, gd0, gd1);
  owned(F, rank, csize, gf0, gf1);
  dense<WP, E>(xs, D, p.w[WQ], p.w[BQ], D, gd0, gd1, qs, kPlain, nullptr, nullptr, Wg);
  dense<WP, E>(xs, D, p.w[WK], p.w[BK], D, gd0, gd1, kn, kPlain, nullptr, p.k_new + row0, Wg);
  dense<WP, E>(xs, D, p.w[WV], p.w[BV], D, gd0, gd1, vn, kPlain, nullptr, p.v_new + row0, Wg);
  __syncthreads();
  share<WP>(cluster, qs, D, rank, csize);
  share<WP>(cluster, kn, D, rank, csize);
  share<WP>(cluster, vn, D, rank, csize);
  cluster.sync();

  // ---- self-attention over the ancestor-indirect cache: a warp per (beam, head) ----
  cached_attention<true>(cluster, qs, kn, vn, att, scratch, lay.lp, p.pos, p.anc, p.cache_k, p.cache_v, rg, W,
                         L, D, H);
  cluster.sync();

  // ---- out projection, residual, LayerNorm ----
  dense<WP, E>(att, D, p.w[WO], p.w[BO], D, gd0, gd1, xs, kResidual, xs, nullptr, Wg);
  __syncthreads();
  share<WP>(cluster, xs, D, rank, csize);
  cluster.sync();
  layer_norm(xs, xs, p.w[LN1_S], p.w[LN1_B], D, Wg, warp, kWarps);  // every block, its own copy
  __syncthreads();

  // ---- feed-forward (gelu), residual, LayerNorm ----
  dense<WP, E>(xs, D, p.w[WI], p.w[BI], F, gf0, gf1, ff, kPlain, nullptr, nullptr, Wg);
  __syncthreads();
  {  // exact gelu in f32 on the columns this block owns, rounded to E (a pass
     // of its own keeps the polynomial out of the products' epilogue, which
     // K5 shares)
    const int c0 = gf0 * kGroup, n = min(gf1 * kGroup, F) - c0;
    for (int i = threadIdx.x; i < WP * n; i += kThreads) {
      E& e = ff[(i / n) * F + c0 + i % n];
      const float v = to_float(e);
      e = from_float<E>(0.5f * v * (1.0f + erf_f32(v * 0.7071067811865476f)));
    }
  }
  __syncthreads();
  share<WP>(cluster, ff, F, rank, csize);
  cluster.sync();
  dense<WP, E>(ff, F, p.w[WO2], p.w[BO2], D, gd0, gd1, att, kResidual, xs, nullptr, Wg);
  __syncthreads();
  share<WP>(cluster, att, D, rank, csize);
  cluster.sync();
  layer_norm(att, p.y + row0, p.w[LN2_S], p.w[LN2_B], D, Wg, wg, wtotal);  // a row per warp of the cluster
}

template <int WP, typename E>
int launch_wp(const Params<E>& p, int Bu, int cluster, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Layout(WP, p.D, p.F, p.L, sizeof(E)).total);
  return launch_clusters(lm_step_kernel<WP, E>, p, Bu * row_groups(p.W, WP), cluster, smem, stream);
}

template <typename E>
int launch(const void* h, const void* cache_k, const void* cache_v, const void* pos, const void* anc,
           const void* const* weights, void* y, void* k_new, void* v_new, int Bu, int W, int L, int D,
           int F, int H, int group, int cluster, void* stream) {
  constexpr int NV = Vec<E>::N;
  if (Bu < 1 || W < 1 || (group != 4 && group != 12 && group != 16) || group > padded_width(W) || H < 1
      || D % H != 0 || (D / H) % NV != 0 || F % NV != 0 || L < 1 || cluster < 1
      || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<E> p;
  p.h = static_cast<const E*>(h);
  p.cache_k = static_cast<const E*>(cache_k);
  p.cache_v = static_cast<const E*>(cache_v);
  p.pos = static_cast<const int*>(pos);
  p.anc = static_cast<const int*>(anc);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = static_cast<const E*>(weights[i]);
  p.y = static_cast<E*>(y);
  p.k_new = static_cast<E*>(k_new);
  p.v_new = static_cast<E*>(v_new);
  p.W = W; p.L = L; p.D = D; p.F = F; p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group == 4) return launch_wp<4, E>(p, Bu, cluster, st);
  if (group == 12) return launch_wp<12, E>(p, Bu, cluster, st);
  return launch_wp<16, E>(p, Bu, cluster, st);
}

}  // namespace

extern "C" {

// shared memory one block needs, in bytes, for row groups of up to W rows
// and elements of `es` bytes (the wrapper picks the widest group that the
// card's limit takes)
int emo_lm_step_smem_bytes(int W, int L, int D, int F, int es) {
  return Layout(padded_width(W), D, F, L, es).total;
}

// `weights`: host array of the 16 device pointers in WEIGHT_NAMES order, the
// 2-D ones as contiguous (out, in) rows, all of the activations' type;
// `group`: the rows of a row group (4, 12 or 16, at most W rounded up to
// one of them); `cluster`: blocks per row group
int emo_lm_step_indirect_f32(const void* h, const void* cache_k, const void* cache_v,
                             const void* pos, const void* anc, const void* const* weights, void* y,
                             void* k_new, void* v_new, int Bu, int W, int L, int D, int F, int H,
                             int group, int cluster, void* stream) {
  return launch<float>(h, cache_k, cache_v, pos, anc, weights, y, k_new, v_new, Bu, W, L, D, F, H,
                       group, cluster, stream);
}

int emo_lm_step_indirect_bf16(const void* h, const void* cache_k, const void* cache_v,
                              const void* pos, const void* anc, const void* const* weights, void* y,
                              void* k_new, void* v_new, int Bu, int W, int L, int D, int F, int H,
                              int group, int cluster, void* stream) {
  return launch<__nv_bfloat16>(h, cache_k, cache_v, pos, anc, weights, y, k_new, v_new, Bu, W, L,
                               D, F, H, group, cluster, stream);
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
