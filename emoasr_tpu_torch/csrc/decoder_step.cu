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
// Types: h, the caches, the encoder K/V, the bias and LayerNorm vectors and
// the outputs share one storage type, float32 or bfloat16 (the TPU kernel's
// activation dtype `adt`), and so do the activations in shared memory; the
// weight matrices come as bf16 terms of that type (two for float32, one for
// bf16; ops/decoder_step.py::pack_fragments).  Every sum is f32; the TPU
// kernel's rounding points are kept: every dense product rounds once to adt
// after adding its f32 bias, LayerNorm statistics are f32 and its output is
// rounded, the scores are f32 from the adt queries and keys, p_past / p_new
// and the cross-attention's p are rounded before their AV products, each
// head's output is rounded, and every residual add is an add in adt
// (x = h + dense(.), x = x + dense(.), y = x + ff).  In float32 each rounding
// is the identity, and a product's operands are split into two bf16 terms
// each (three products, csrc/beam_step.cuh).
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
// bound it (in bf16 each of those byte counts halves); what holds it is
// latency (some ten phases in series, each a few round trips to L2 or
// device memory and a cluster barrier, with eight warps an SM) and the
// weights' stream from L2, which every row group reads again
// (tools/k5_parts.py takes it apart).
//
// Design (its helpers shared with csrc/lm_step.cu, K6, in csrc/beam_step.cuh):
// the N rows go in groups of up to WP consecutive rows (several utterances'
// when W < WP), a thread-block CLUSTER of C blocks a group, every block with
// the group's rows of every activation in its shared memory.  The dense
// products run on the tensor cores, each block over its share of the output
// columns, the weights streamed from L2 in fragment order (Q, K and V as
// one product); the self-attention takes a warp of the cluster per (row,
// head), the cross-attention a block per (utterance of the group, head),
// its scores and P V product on the tensor cores too; what a phase computes
// goes to every block's shared memory before a cluster barrier.  The loops
// over the cache stop at `pos`, not at L.  Sum orders are fixed (no
// atomics).
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
  const void* w[kNumWeights];  // vectors of E; matrices as packed bf16 fragments
  E* y;                  // (N, D)
  E* k_new;              // (N, D)
  E* v_new;              // (N, D)
  int N, W, L, T, D, F, H;
};

// The cross-attention's shared memory (in the region), in bytes: the scores
// of a window of tw frames (kRows rows of tp, f32); the A planes of p over
// the window (kRows rows of ldp); the A planes of the item's queries (kRows
// rows of ldk); and the B planes of a chunk of tc frames of one head's keys
// or values (tc rows of ldk).  A window holds all of T' up to 512 frames in
// float32 and 1024 in bf16, a chunk up to 256 and 512, so that the room
// does not grow with T' beyond them.  Every row of bf16 planes is a
// multiple of 16 elements plus 8 (an odd multiple of 16 bytes).
struct CrossLayout {
  int dkp, ldk, tw, tp, ldp, tc, scores, p, q, kv, total;
  __host__ __device__ CrossLayout(int dk, int T, int es) {
    const int terms = es == 4 ? 2 : 1, most = es == 4 ? 256 : 512, t16 = (T + 15) / 16 * 16, t4 = (T + 3) / 4 * 4;
    dkp = (dk + 15) / 16 * 16;
    ldk = dkp + 8;
    tw = t16 < 2 * most ? t16 : 2 * most;
    tp = t4 < tw ? t4 : tw;
    ldp = tw + 8;
    tc = tw < most ? tw : most;
    scores = kRows * tp * 4;
    p = terms * kRows * ldp * 2;
    q = terms * kRows * ldk * 2;
    kv = terms * tc * ldk * 2;
    total = scores + p + q + kv;
  }
};

// shared memory, in bytes: the residual stream (WP, D); q, k_new, v_new (WP,
// D) each, which the FF products take for their partial sums; the A planes
// of D columns (a row of zeros after them); and one region that holds, in
// turn, the D-wide products' partial sums, the warps' self-attention scores
// and cache rows, the cross-attention's (CrossLayout), and the FF hidden
// layer's A planes
struct Layout {
  int act, qkv, pa, lp, region, total;
  __host__ __device__ Layout(int WP, int D, int F, int H, int L, int T, int es) {
    const int terms = es == 4 ? 2 : 1;
    act = WP * D * es;
    qkv = 3 * act > slices(F) * 1024 ? 3 * act : slices(F) * 1024;
    pa = planes_bytes(D, terms, WP);
    lp = (L + 4) / 4 * 4;
    const int parts = slices(D) * 1024;
    const int self_attn = kWarps * 2 * lp * 4;
    const int cross = CrossLayout(D / H, T, es).total;
    region = planes_bytes(F, terms, WP);
    if (parts > region) region = parts;
    if (self_attn > region) region = self_attn;
    if (cross > region) region = cross;
    total = act + qkv + pa + region;
  }
};

// The cross-attention of the group's rows, a block per (utterance of the
// group, head): that utterance's rows (at most 16, one m16 tile) attend as
// queries over its encoder K/V, frames t < elens[u], both products on the
// tensor cores (the queries, keys, p and values as bf16 terms: two for
// float32, one for bf16; three products or one, as the dense products).
// The frames go in windows of tw (CrossLayout: one window up to 512 frames
// in float32, 1024 in bf16), a window's keys, then its values, staged into
// shared memory in chunks of tc frames, 16 bytes a thread (bf16: cp.async;
// float32: four loads a thread at once, each word split into its planes);
// the scores take the warps' n8 tiles of a chunk's frames, the P V product
// a warp per n8 tile of the head's dimensions, summing the frames in order.
// A first pass takes each window's scores and keeps a row's running max
// and sum of exp(s - max) (the sum rescaled where a window raises the max;
// with one window, the max and the sum over all frames); then p = exp(s -
// max) / sum, rounded to E (and split), goes into the planes a window at a
// time, each window's scores taken again where there is more than one, and
// the P V product sums the windows in order.  Scores f32, each head's
// output rounded to E.  qs: (WP, D) in shared memory, complete in every
// block; the output goes to the A planes att (rows of ld, `plane` elements
// a term) of this block, which copies it into every other block's.
// scratch: the region, laid out by CrossLayout.  Not inlined: its registers
// are its own.
template <typename E>
__device__ __noinline__ void cross_attention(cg::cluster_group& cluster, const E* qs, bf16* att, int ld,
                                                int plane, float* scratch, const E* __restrict__ cross_k,
                                                const E* __restrict__ cross_v, const int* __restrict__ elens,
                                                const RowGroup& rg, int W, int T, int D, int H) {
  constexpr int TE = Terms<E>::N;
  constexpr int NP = TE == 1 ? 1 : 3;
  const int csize = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const int dk = D / H;
  const CrossLayout cl(dk, T, sizeof(E));
  const int ldk = cl.ldk, ldp = cl.ldp, tc = cl.tc, tw = cl.tw;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  unsigned char* base = reinterpret_cast<unsigned char*>(scratch);
  float* scx = scratch;                                          // (kRows, tp) scores of a window
  bf16* pp = reinterpret_cast<bf16*>(base + cl.scores);          // p's planes over a window
  bf16* qp = reinterpret_cast<bf16*>(base + cl.scores + cl.p);   // the queries' planes
  bf16* kv = reinterpret_cast<bf16*>(base + cl.scores + cl.p + cl.q);  // a chunk's key or value planes
  const int plane_p = kRows * ldp, plane_q = kRows * ldk, plane_kv = tc * ldk;
  for (int i = threadIdx.x; i < cl.kv / 16; i += kThreads)  // the planes' padding columns stay 0
    reinterpret_cast<uint4*>(kv)[i] = make_uint4(0, 0, 0, 0);
  // stage frames c0 .. c0 + tc - 1 of a head's keys or values (rows D apart; frames past n as zeros) into kv;
  // ends with a block barrier
  const int wpr = dk * static_cast<int>(sizeof(E)) / 16, step = kThreads / wpr, w0 = threadIdx.x % wpr;
  const int r0 = threadIdx.x < step * wpr ? threadIdx.x / wpr : tc;
  const auto stage = [&](const E* src, int n) {
    if constexpr (TE == 1) {
      for (int r = r0; r < tc; r += step)
        emo_mma::cp_async16(kv + r * ldk + 8 * w0,
                            reinterpret_cast<const unsigned char*>(src + static_cast<size_t>(r < n ? r : 0) * D) +
                                16 * w0,
                            r < n);
      emo_mma::cp_async_commit();
      emo_mma::cp_async_wait<0>();
    } else {
      constexpr int kLoads = 4;
      for (int r1 = r0; r1 < tc; r1 += kLoads * step) {
        float4 x[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int r = r1 + i * step;
          x[i] = r < n ? __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * D) + w0)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int r = r1 + i * step;
          if (r < tc) put_planes<E, 4>(kv + r * ldk + 4 * w0, plane_kv, &x[i].x);
        }
      }
    }
    __syncthreads();
  };
  const int u0 = rg.r0 / W, nseg = (rg.r0 + rg.n - 1) / W - u0 + 1;
  for (int item = rank; item < nseg * H; item += csize) {
    const int u = u0 + item / H, hh = item % H;
    const int wa = max(u * W - rg.r0, 0), ns = min((u + 1) * W - rg.r0, rg.n) - wa;  // rows wa .. wa + ns - 1
    const int elen = min(max(elens[u], 0), T), elen16 = (elen + 15) / 16 * 16, nwin = (elen + tw - 1) / tw;
    const E* kb = cross_k + static_cast<size_t>(u) * T * D + hh * dk;
    const E* vb = cross_v + static_cast<size_t>(u) * T * D + hh * dk;
    for (int i = threadIdx.x; i < kRows * cl.dkp / 2; i += kThreads) {  // the queries' planes, zeros past ns, dk
      const int r = i / (cl.dkp / 2), d = 2 * (i % (cl.dkp / 2));
      float v[2] = {0.f, 0.f};
      if (r < ns && d < dk) {
        v[0] = to_float(qs[(wa + r) * D + hh * dk + d]);
        v[1] = to_float(qs[(wa + r) * D + hh * dk + d + 1]);
      }
      put_planes<E, 2>(qp + r * ldk + d, plane_q, v);
    }
    // the scores of the window's frames f0 .. f0 + tw - 1 (< elen) into scx, column t - f0: a warp per pair of
    // n8 tiles of a chunk's frames
    const auto scores = [&](int f0) {
      const int fend = min(f0 + tw, elen);
      for (int c0 = f0; c0 < fend; c0 += tc) {
        stage(kb + static_cast<size_t>(c0) * D, fend - c0);
        for (int j2 = warp; 16 * j2 < tc && c0 + 16 * j2 < fend; j2 += kWarps) {
          float acc[NP][2][4] = {};
          for (int k0 = 0; k0 < cl.dkp; k0 += 16) {
            uint32_t a[TE][4], b[TE][4];
#pragma unroll
            for (int t = 0; t < TE; ++t) {
              emo_mma::load_a(a[t], qp + t * plane_q, ldk, 0, k0, lane);
              emo_mma::load_b(b[t], kv + t * plane_kv, ldk, 16 * j2, k0, lane);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              emo_mma::mma(acc[0][j], a[0], b[0][2 * j], b[0][2 * j + 1]);
              if constexpr (TE == 2) {
                emo_mma::mma(acc[1][j], a[1], b[0][2 * j], b[0][2 * j + 1]);
                emo_mma::mma(acc[2][j], a[0], b[1][2 * j], b[1][2 * j + 1]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = g + 8 * (e >> 1), t = c0 + 16 * j2 + 8 * j + 2 * c + (e & 1);
              float x = acc[0][j][e];
              if constexpr (NP == 3) x = (x + acc[1][j][e]) + acc[2][j][e];
              if (r < ns && t < fend) scx[r * cl.tp + t - f0] = x * scale;
            }
        }
        __syncthreads();  // the next chunk reuses the planes
      }
    };
    // a row's running max and sum, a warp per pair of rows (warp, warp + kWarps), in that warp's registers
    float rm[2] = {-INFINITY, -INFINITY}, rden[2] = {0.f, 0.f};
    for (int f0 = 0; f0 < elen; f0 += tw) {  // (the next window's staging barrier orders these reads first)
      scores(f0);
      const int n = min(tw, elen - f0);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int i = warp + s * kWarps;
        if (i >= ns) continue;
        const float* row = scx + i * cl.tp;
        float m = -INFINITY, den = 0.f;
        for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
        m = fmaxf(warp_max(m), rm[s]);
        for (int t = lane; t < n; t += 32) den += expf(row[t] - m);
        rden[s] = rden[s] * expf(rm[s] - m) + warp_sum(den);  // exp(-inf) = 0 before the first window
        rm[s] = m;
      }
    }
    // p of the window's frames f0 .. into its planes, rounded to E; zeros past elen and ns
    const auto probs = [&](int f0) {
      const int fend16 = min(f0 + tw, elen16);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int i = warp + s * kWarps;
        const float* row = scx + i * cl.tp;
        for (int t = f0 + 2 * lane; t < fend16; t += 64) {
          float v[2];
#pragma unroll
          for (int x = 0; x < 2; ++x)
            v[x] = i < ns && t + x < elen ? round_to<E>(expf(row[t + x - f0] - rm[s]) / rden[s]) : 0.f;
          put_planes<E, 2>(pp + i * ldp + t - f0, plane_p, v);
        }
      }
    };
    if (nwin == 1) probs(0);  // the window's scores are still in scx
    __syncthreads();
    // P V: warp w takes the n8 tiles w and w + kWarps of the head's dimensions in a pass (d_k above 128: more
    // passes, the values staged again)
    for (int t0 = 0; t0 < cl.dkp / 8; t0 += 2 * kWarps) {
    float o[2][NP][4] = {};
    for (int f0 = 0; f0 < elen; f0 += tw) {
      if (nwin > 1) {  // the window's scores again (the same sums), then its p
        scores(f0);
        probs(f0);
      }
      const int fend = min(f0 + tw, elen), fend16 = min(f0 + tw, elen16);
      for (int c0 = f0; c0 < fend; c0 += tc) {
        stage(vb + static_cast<size_t>(c0) * D, fend - c0);
        const int kend = min(tc, fend16 - c0);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int tile = t0 + warp + s * kWarps;
          if (8 * tile >= cl.dkp) continue;
          for (int k0 = 0; k0 < kend; k0 += 16) {
            uint32_t a[TE][4], b[TE][4];
#pragma unroll
            for (int t = 0; t < TE; ++t) {
              emo_mma::load_a(a[t], pp + t * plane_p, ldp, 0, c0 - f0 + k0, lane);
              emo_mma::load_b_trans(b[t], kv + t * plane_kv, ldk, 16 * (tile >> 1), k0, lane);
            }
            const int h = 2 * (tile & 1);
            emo_mma::mma(o[s][0], a[0], b[0][h], b[0][h + 1]);
            if constexpr (TE == 2) {
              emo_mma::mma(o[s][1], a[1], b[0][h], b[0][h + 1]);
              emo_mma::mma(o[s][2], a[0], b[1][h], b[1][h + 1]);
            }
          }
        }
        __syncthreads();  // the next chunk reuses the planes
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // the head's output, rounded to E, into this block's planes
      const int tile = t0 + warp + s * kWarps, d = 8 * tile + 2 * c;
      if (d >= dk) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r >= ns) continue;
        float y[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float v = o[s][0][2 * h + x];
          if constexpr (NP == 3) v = (v + o[s][1][2 * h + x]) + o[s][2][2 * h + x];
          y[x] = round_to<E>(v);
        }
        put_planes<E, 2>(att + (wa + r) * ld + hh * dk + d, plane, y);
      }
    }
    }
    __syncthreads();
    // and into the other blocks': 16-byte words, or 8-byte words where d_k is 4 more than a multiple of 8
    const auto at = [&](int r, int d) { return ((r / ns) * plane + (wa + r % ns) * ld + hh * dk + d) * 2; };
    if (dk % 8 == 0)
      share_rows(cluster, reinterpret_cast<unsigned char*>(att), TE * ns, dk / 8,
                 [&](int r, int wd) { return at(r, 8 * wd); });
    else
      share_rows<uint2>(cluster, reinterpret_cast<unsigned char*>(att), TE * ns, dk / 4,
                        [&](int r, int wd) { return at(r, 4 * wd); });
  }
}

template <int WP, bool INDIRECT, typename E>
__global__ void __launch_bounds__(kThreads, 1) decoder_step_kernel(const Params<E> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int warp = threadIdx.x >> 5;
  const int W = p.W, L = p.L, T = p.T, D = p.D, F = p.F, H = p.H;
  const RowGroup rg(blockIdx.x / csize, p.N, WP);
  const int Wg = rg.n;                                     // the group's rows
  const size_t row0 = static_cast<size_t>(rg.r0) * D;      // the group's rows in device memory
  const Layout lay(WP, D, F, H, L, T, sizeof(E));
  E* xs = reinterpret_cast<E*>(smem);                      // residual stream
  E* qs = reinterpret_cast<E*>(smem + lay.act);            // queries (self, then cross)
  E* kn = qs + WP * D;                                     // k_new
  E* vn = kn + WP * D;                                     // v_new
  float* ff_parts = reinterpret_cast<float*>(qs);          // the FF products' partial sums
  bf16* pa = reinterpret_cast<bf16*>(smem + lay.act + lay.qkv);  // A planes: LN outputs, attention outputs
  unsigned char* region = smem + lay.act + lay.qkv + lay.pa;
  float* scratch = reinterpret_cast<float*>(region);
  bf16* pf = reinterpret_cast<bf16*>(region);              // the FF hidden layer's A planes
  const int lda = plane_ld(D), ldf = plane_ld(F), plane_a = WP * lda, plane_f = WP * ldf;
  const auto wt = [&](int i) { return reinterpret_cast<const uint4*>(p.w[i]); };
  const auto vec = [&](int i) { return reinterpret_cast<const E*>(p.w[i]); };

  LnVecs ln = ln_vectors(vec(LN1_S), vec(LN1_B), D);  // each LayerNorm's vectors read before the barrier ahead
  for (int i = threadIdx.x; i < WP * D; i += kThreads)
    xs[i] = i < Wg * D ? p.h[row0 + i] : from_float<E>(0.f);
  for (int i = threadIdx.x; i < lay.pa / 16; i += kThreads) reinterpret_cast<uint4*>(pa)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // ---- self-attention (cached, one new position per row) ----
  layer_norm(ln, xs, static_cast<E*>(nullptr), pa, lda, plane_a, vec(LN1_S), vec(LN1_B), D, WP, warp, kWarps);
  cluster.sync();  // every block of the cluster runs before any remote store
  // q, k_new, v_new as one product (the packed (3 D, D) weight): parts 1 and 2 also to device memory
  dense<WP, E>(kPlain, pa, D, wt(WQ), vec(BQ), 3 * D, D, scratch, lay.region, qs, nullptr, nullptr, p.k_new + row0,
               p.v_new - p.k_new, 1, Wg);
  cluster.sync();
  cached_attention<INDIRECT>(cluster, qs, kn, vn, pa, lda, plane_a, scratch, lay.lp, p.pos, p.anc, p.cache_k, p.cache_v,
                             rg, W, L, D, H);
  cluster.sync();
  dense<WP, E>(kResidual, pa, D, wt(WO), vec(BO), D, D, scratch, lay.region, xs, nullptr, xs, nullptr, 0, 0, Wg);
  ln = ln_vectors(vec(LN2_S), vec(LN2_B), D);
  cluster.sync();

  // ---- cross-attention: an utterance's rows share one read of its encoder K/V ----
  layer_norm(ln, xs, static_cast<E*>(nullptr), pa, lda, plane_a, vec(LN2_S), vec(LN2_B), D, WP, warp, kWarps);
  __syncthreads();
  dense<WP, E>(kPlain, pa, D, wt(CWQ), vec(CBQ), D, D, scratch, lay.region, qs, nullptr, nullptr, nullptr, 0, 0, Wg);
  cluster.sync();
  cross_attention(cluster, qs, pa, lda, plane_a, scratch, p.cross_k, p.cross_v, p.elens, rg, W, T, D, H);
  cluster.sync();
  dense<WP, E>(kResidual, pa, D, wt(CWO), vec(CBO), D, D, scratch, lay.region, xs, nullptr, xs, nullptr, 0, 0, Wg);
  ln = ln_vectors(vec(LN3_S), vec(LN3_B), D);
  cluster.sync();

  // ---- feed-forward ----
  layer_norm(ln, xs, static_cast<E*>(nullptr), pa, lda, plane_a, vec(LN3_S), vec(LN3_B), D, WP, warp, kWarps);
  zero_padding(pf, Terms<E>::N * WP, F, ldf);
  __syncthreads();
  dense<WP, E>(kRelu, pa, D, wt(W1), vec(B1), F, F, ff_parts, lay.qkv, nullptr, pf, nullptr, nullptr, 0, 0, Wg);
  cluster.sync();
  dense<WP, E>(kResidual, pf, F, wt(W2), vec(B2), D, D, ff_parts, lay.qkv, nullptr, nullptr, xs, p.y + row0, 0, 0,
               Wg);
}

template <int WP, bool INDIRECT, typename E>
int launch_wp(const Params<E>& p, int cluster, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Layout(WP, p.D, p.F, p.H, p.L, p.T, sizeof(E)).total);
  return launch_clusters(decoder_step_kernel<WP, INDIRECT, E>, p, row_groups(p.N, WP), cluster, smem, stream);
}

template <int WP, typename E>
int max_clusters_wp(int cluster, int L, int T, int D, int F, int H) {
  const size_t smem = static_cast<size_t>(Layout(WP, D, F, H, L, T, sizeof(E)).total);
  return max_clusters(decoder_step_kernel<WP, EMO_DECODER_STEP_INDIRECT != 0, E>, cluster, smem);
}

template <typename E>
int max_clusters_of(int group, int cluster, int L, int T, int D, int F, int H) {
  if (group == 4) return max_clusters_wp<4, E>(cluster, L, T, D, F, H);
  if (group == 12) return max_clusters_wp<12, E>(cluster, L, T, D, F, H);
  return max_clusters_wp<16, E>(cluster, L, T, D, F, H);
}

template <bool INDIRECT, typename E>
int launch(const void* h, const void* cache_k, const void* cache_v, const void* pos,
           const void* anc, const void* cross_k, const void* cross_v, const void* elens,
           const void* const* weights, void* y, void* k_new, void* v_new, int Bu, int W, int L,
           int T, int D, int F, int H, int group, int cluster, void* stream) {
  constexpr int NV = Vec<E>::N;
  if (Bu < 1 || W < 1 || (group != 4 && group != 12 && group != 16) || H < 1 || D % H != 0
      || (D / H) % NV != 0 || F % NV != 0 || L < 1 || T < 1 || cluster < 1 || cluster > kMaxCluster)
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
  for (int i = 0; i < kNumWeights; ++i) p.w[i] = weights[i];
  p.y = static_cast<E*>(y);
  p.k_new = static_cast<E*>(k_new);
  p.v_new = static_cast<E*>(v_new);
  p.N = Bu * W; p.W = W; p.L = L; p.T = T; p.D = D; p.F = F; p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group == 4) return launch_wp<4, INDIRECT, E>(p, cluster, st);
  if (group == 12) return launch_wp<12, INDIRECT, E>(p, cluster, st);
  return launch_wp<16, INDIRECT, E>(p, cluster, st);
}

}  // namespace

extern "C" {

// shared memory one block needs, in bytes, for row groups of `group` rows
// and elements of `es` bytes (ops/decoder_step.py::smem_bytes mirrors it)
int emo_decoder_step_smem_bytes(int group, int L, int T, int D, int F, int H, int es) {
  return Layout(group, D, F, H, L, T, es).total;
}

// clusters of `cluster` blocks the card holds at once for row groups of
// `group` rows and elements of `es` bytes (or -1)
int emo_decoder_step_max_clusters(int group, int cluster, int L, int T, int D, int F, int H, int es) {
  return es == 4 ? max_clusters_of<float>(group, cluster, L, T, D, F, H)
                 : max_clusters_of<__nv_bfloat16>(group, cluster, L, T, D, F, H);
}

// `weights`: host array of the 22 device pointers in WEIGHT_NAMES order: the
// vectors in the activations' type, the matrices as
// ops/decoder_step.py::pack_fragments lays them out; `group`: the rows of a
// row group (4, 12 or 16); `cluster`: blocks per row group
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
