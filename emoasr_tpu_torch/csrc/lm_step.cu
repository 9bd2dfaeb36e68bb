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
// Types: h, the caches, the bias and LayerNorm vectors and the outputs share
// one storage type, float32 or bfloat16 (the TPU kernel's `adt`), and so do
// the activations in shared memory; the weight matrices come as bf16 terms
// of that type (two for float32, one for bf16;
// ops/decoder_step.py::pack_fragments).  Every sum is f32; the TPU kernel's
// rounding points are kept: every dense product rounds once to adt after its
// f32 bias, the probabilities and each head's output are rounded, each
// residual add (h + dense(.), x + dense(.)) is an add in adt before its
// LayerNorm (f32 statistics, output rounded), and dense(x, wi) is rounded,
// widened to f32 for the gelu (erf_f32 stays f32) and the gelu's output
// rounded again.  In float32 a product's operands are split into two bf16
// terms each (three products, csrc/beam_step.cuh).
//
// What bounds it on this card: at the L3-3 shapes (Bu = 18, W = 10, D = 512,
// F = 2048, pos ~ 64) the step reads 12.6 MB of weights and ~47 MB of live
// cache for ~1.1 GFLOP; bytes and operations weigh about the same (in bf16
// the bytes halve); what holds it is latency, some eight phases in series.
//
// Design: that of csrc/decoder_step.cu (K5), with the helpers the two share
// in csrc/beam_step.cuh: row groups of up to WP consecutive rows, a
// thread-block cluster a group, the dense products on the tensor cores over
// each block's share of the output columns, the self-attention a warp of the
// cluster per (row, head), and a block writes what it computed into every
// block's shared memory (distributed shared memory) before a cluster barrier
// ends the phase.  What differs from K5: post-norm (a LayerNorm after each
// residual, which every block computes for itself on its full copy of the
// rows), gelu in place of relu (in the FF product's epilogue), no
// cross-attention, and the shared memory: only the residual stream (WP, D)
// and the A planes of D columns live through the whole step (the planes'
// room holds FF2's output at the end); the queries, the new keys and values
// and the attention scratch are dead once the attention is done, and the FF
// hidden layer's A planes reuse their room; the products' partial sums have
// a room of their own.  The loops over the cache stop at `pos`.  Sum orders
// are fixed (no atomics).

#include "beam_step.cuh"

namespace {

using namespace beam_step;

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
  const void* w[kNumWeights];  // vectors of E; matrices as packed bf16 fragments
  E* y;                  // (N, D)
  E* k_new;              // (N, D)
  E* v_new;              // (N, D)
  int N, W, L, D, F, H;
};

constexpr int kPartBytes = 16384;  // the products' partial sums

// shared memory, in bytes: the residual stream (WP, D) of es-byte elements;
// the A planes of D columns and their zero row (FF2's output rows at the
// end); the products' partial sums; and one region that holds the queries,
// the new keys and values and the warps' attention scratch (f32) during the
// attention, the out product's partial sums, and the FF hidden layer's A
// planes after it
struct Layout {
  int act, pa, lp, region, total;
  __host__ __device__ Layout(int WP, int D, int F, int L, int es) {
    const int terms = es == 4 ? 2 : 1;
    act = WP * D * es;
    pa = planes_bytes(D, terms, WP) > act ? planes_bytes(D, terms, WP) : act;
    lp = (L + 4) / 4 * 4;
    const int attention = 3 * act + kWarps * 2 * lp * 4;  // q, k_new, v_new; scores and cache rows
    region = planes_bytes(F, terms, WP) > attention ? planes_bytes(F, terms, WP) : attention;
    total = act + pa + kPartBytes + region;
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
  const RowGroup rg(blockIdx.x / csize, p.N, WP);
  const int Wg = rg.n;                                     // the group's rows
  const size_t row0 = static_cast<size_t>(rg.r0) * D;      // the group's rows in device memory
  const Layout lay(WP, D, F, L, sizeof(E));
  E* xs = reinterpret_cast<E*>(smem);                      // residual stream
  bf16* pa = reinterpret_cast<bf16*>(smem + lay.act);      // A planes: h, the attention output, LN1's output
  E* out2 = reinterpret_cast<E*>(pa);                      // then FF2's output rows
  float* parts = reinterpret_cast<float*>(smem + lay.act + lay.pa);
  unsigned char* region = smem + lay.act + lay.pa + kPartBytes;
  E* qs = reinterpret_cast<E*>(region);                    // queries       } the attention's room,
  E* kn = qs + WP * D;                                     // k_new         } then the FF hidden
  E* vn = kn + WP * D;                                     // v_new         } layer's A planes
  float* scratch = reinterpret_cast<float*>(region + 3 * lay.act);
  bf16* pf = reinterpret_cast<bf16*>(region);
  const int lda = plane_ld(D), ldf = plane_ld(F), plane_a = WP * lda, plane_f = WP * ldf;
  const auto wt = [&](int i) { return reinterpret_cast<const uint4*>(p.w[i]); };
  const auto vec = [&](int i) { return reinterpret_cast<const E*>(p.w[i]); };

  for (int i = threadIdx.x; i < lay.pa / 16; i += kThreads) reinterpret_cast<uint4*>(pa)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < WP * D / 2; i += kThreads) {  // the rows, and their A planes
    const int w = (2 * i) / D, d = (2 * i) % D;
    float v[2] = {0.f, 0.f};
    if (w < Wg) {
      v[0] = to_float(p.h[row0 + 2 * i]);
      v[1] = to_float(p.h[row0 + 2 * i + 1]);
    }
    store2(xs + 2 * i, v[0], v[1]);
    put_planes<E, 2>(pa + w * lda + d, plane_a, v);
  }
  cluster.sync();  // every block of the cluster runs before any remote store

  // ---- Q/K/V projections ----
  // as one product (the packed (3 D, D) weight), its partial sums in the region's room beyond q, k_new, v_new
  // where that is the larger; parts 1 and 2 also to device memory
  const bool tail = lay.region - 3 * lay.act > kPartBytes;
  dense<WP, E>(kPlain, pa, D, wt(WQ), vec(BQ), 3 * D, D, tail ? scratch : parts,
               tail ? lay.region - 3 * lay.act : kPartBytes, qs, nullptr, nullptr, p.k_new + row0, p.v_new - p.k_new,
               1, Wg);
  cluster.sync();

  // ---- self-attention over the ancestor-indirect cache: a warp per (row, head) ----
  cached_attention<true>(cluster, qs, kn, vn, pa, lda, plane_a, scratch, lay.lp, p.pos, p.anc, p.cache_k, p.cache_v, rg,
                         W, L, D, H);
  cluster.sync();

  // ---- out projection, residual, LayerNorm ----
  dense<WP, E>(kResidual, pa, D, wt(WO), vec(BO), D, D, reinterpret_cast<float*>(region), lay.region, xs, nullptr, xs,
               nullptr, 0, 0, Wg);  // the attention's room is free
  LnVecs ln = ln_vectors(vec(LN1_S), vec(LN1_B), D);  // the LayerNorm's vectors read before the barrier
  cluster.sync();
  layer_norm(ln, xs, xs, pa, lda, plane_a, vec(LN1_S), vec(LN1_B), D, WP, warp, kWarps);  // every block, its own copy
  zero_padding(pf, Terms<E>::N * WP, F, ldf);
  __syncthreads();

  // ---- feed-forward (gelu), residual, LayerNorm ----
  dense<WP, E>(kGelu, pa, D, wt(WI), vec(BI), F, F, parts, kPartBytes, nullptr, pf, nullptr, nullptr, 0, 0, Wg);
  cluster.sync();
  dense<WP, E>(kResidual, pf, F, wt(WO2), vec(BO2), D, D, parts, kPartBytes, out2, nullptr, xs, nullptr, 0, 0, Wg);
  ln = ln_vectors(vec(LN2_S), vec(LN2_B), D);
  cluster.sync();
  layer_norm(ln, out2, p.y + row0, static_cast<bf16*>(nullptr), 0, 0, vec(LN2_S), vec(LN2_B), D, Wg, wg,
             wtotal);  // a row per warp of the cluster
}

template <int WP, typename E>
int launch_wp(const Params<E>& p, int cluster, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Layout(WP, p.D, p.F, p.L, sizeof(E)).total);
  return launch_clusters(lm_step_kernel<WP, E>, p, row_groups(p.N, WP), cluster, smem, stream);
}

template <int WP, typename E>
int max_clusters_wp(int cluster, int L, int D, int F) {
  return max_clusters(lm_step_kernel<WP, E>, cluster, static_cast<size_t>(Layout(WP, D, F, L, sizeof(E)).total));
}

template <typename E>
int max_clusters_of(int group, int cluster, int L, int D, int F) {
  if (group == 4) return max_clusters_wp<4, E>(cluster, L, D, F);
  if (group == 12) return max_clusters_wp<12, E>(cluster, L, D, F);
  return max_clusters_wp<16, E>(cluster, L, D, F);
}

template <typename E>
int launch(const void* h, const void* cache_k, const void* cache_v, const void* pos, const void* anc,
           const void* const* weights, void* y, void* k_new, void* v_new, int Bu, int W, int L, int D,
           int F, int H, int group, int cluster, void* stream) {
  constexpr int NV = Vec<E>::N;
  if (Bu < 1 || W < 1 || (group != 4 && group != 12 && group != 16) || H < 1 || D % H != 0 || (D / H) % NV != 0 || F % NV != 0 || L < 1 || cluster < 1
      || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<E> p;
  p.h = static_cast<const E*>(h);
  p.cache_k = static_cast<const E*>(cache_k);
  p.cache_v = static_cast<const E*>(cache_v);
  p.pos = static_cast<const int*>(pos);
  p.anc = static_cast<const int*>(anc);
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = weights[i];
  p.y = static_cast<E*>(y);
  p.k_new = static_cast<E*>(k_new);
  p.v_new = static_cast<E*>(v_new);
  p.N = Bu * W; p.W = W; p.L = L; p.D = D; p.F = F; p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group == 4) return launch_wp<4, E>(p, cluster, st);
  if (group == 12) return launch_wp<12, E>(p, cluster, st);
  return launch_wp<16, E>(p, cluster, st);
}

}  // namespace

extern "C" {

// shared memory one block needs, in bytes, for row groups of `group` rows
// and elements of `es` bytes (ops/decoder_step.py::smem_bytes mirrors it)
int emo_lm_step_smem_bytes(int group, int L, int D, int F, int es) {
  return Layout(group, D, F, L, es).total;
}

// clusters of `cluster` blocks the card holds at once for row groups of
// `group` rows and elements of `es` bytes (or -1)
int emo_lm_step_max_clusters(int group, int cluster, int L, int D, int F, int es) {
  return es == 4 ? max_clusters_of<float>(group, cluster, L, D, F) : max_clusters_of<__nv_bfloat16>(group, cluster, L, D, F);
}

// `weights`: host array of the 16 device pointers in WEIGHT_NAMES order: the
// vectors in the activations' type, the matrices as
// ops/decoder_step.py::pack_fragments lays them out; `group`: the rows of a
// row group (4, 12 or 16); `cluster`: blocks per row group
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
