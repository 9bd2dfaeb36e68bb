// Fused RNN-T joint for Hopper (sm_90a): for every (t, u) cell of the
// lattice, the joint network's output layer streamed over the vocabulary
// with a streaming logsumexp, keeping only the blank and the label
// log-probabilities; the (B, T, U+1, V) joint output is never written.
//
// Replaces: emoasr_tpu/ops/rnnt_pallas.py::fused_joint_gather_fwd, kernel
// `_kernel` (its backward is the chunked plain path, as the JAX custom VJP
// hands it to `ops/rnnt.py::rnnt_gathered_from_joint`).
//
// Semantics: he (B, T, J) = W_enc e + b_enc, hd (B, U1, J) = W_dec d + b_dec
// (U1 = U + 1), the output weight w, bias (V,), labels (B, U) int32.  For
// each cell (t, u):
//   z = tanh(he[b, t] + hd[b, u]);  logits = z . w + bias;
//   lse = logsumexp_v logits;
//   lp_blank[b, t, u] = logits[blank] - lse           (B, T, U1)
//   lp_label[b, t, u] = logits[labels[b, u]] - lse    (B, T, U), u < U only
// A label outside [0, V) selects nothing: its logit counts as 0.
//
// Vocabulary-split launch (emo_rnnt_joint_shard_*; a model rank's block of
// V columns from v0 of the whole vocabulary, parallel/vocab.py): w and bias
// are the block, the blank and the labels are ids of the whole vocabulary
// and select column id - v0 where that lies in [0, V), nothing elsewhere.
// The kernel then writes, per cell, the block's float32 lse to lse_out and
// the selected blank and label logits themselves (0 where the block does
// not own the column) to lp_blank / lp_label; the wrapper combines the
// ranks' blocks.  The arithmetic is the same: v0 = 0 without lse_out is
// the whole-vocabulary launch, bit for bit.
//
// Types: he and hd share one type, float32 or bfloat16 (the wrapper casts
// hd and w to he's, as the TPU kernel does); bias is f32; lse and both
// outputs are f32.  bf16: z is formed in bf16 (the sum rounded, then the
// tanh rounded), w is bf16, and each product of bf16 values is exact in f32
// and accumulates in f32: the TPU kernel's own arithmetic (bf16 operands,
// `preferred_element_type=jnp.float32`, rnnt_pallas.py:85-88).  f32 (TF32
// stays off): z and w are each split into two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi) (x to ~2^-17 of itself), and the three leading cross
// products z_hi w_hi, z_lo w_hi and z_hi w_lo add into one f32 sum; the
// dropped z_lo w_lo and the split's residues are ~2^-17 of each product
// (tests/test_torch_kernel_arith.py holds this on the CPU against the
// plain version and the JAX kernel; one term misses the tolerance).
//
// What bounds it on this card: operations.  2 B T U1 J V products (949
// GFLOP at the largest L4 training bucket, (18, 399, 129) x (512, 1000))
// against ~24 MB of inputs and outputs, so every product runs on the
// tensor cores (`mma.sync.m16n8k16`, bf16 operands, f32 sums;
// csrc/mma_bf16.cuh): one product per k-step in bf16, three in f32.
//
// Design.  The TPU kernel keeps a z tile and a (J, Vc) tile of W in VMEM
// and carries the running max/sum across a sequential V grid axis; blocks
// here run in no order, so the V axis is a loop inside the block:
//  * one block owns BM consecutive cells (t, u) of one utterance in
//    row-major (t, u) order (the ragged end of the utterance is masked, U1
//    is not padded) and builds their z once, as TERMS bf16 planes (1 in
//    bf16, hi and lo in f32) of BM rows in shared memory, in the A-operand
//    layout for `ldmatrix` (rows Jp + 8 apart, Jp = J rounded up to 64, the
//    columns past J zero; see mma_bf16.cuh for the padding).  A warp builds
//    four rows at a time, so that eight 16-byte loads are in flight before
//    their tanh;
//  * it then streams W, as TERMS bf16 planes in nn.Linear's (V, J) layout,
//    through a ring of `stages` (2-4) `cp.async` stages of 256 vocabulary
//    rows by BK joint columns (64 in bf16, 32 in f32, 16 at 16 cells), read
//    as the B operand (`load_b`), so that the copies of the next stages
//    overlap the products of this one.  The f32 planes are written by a
//    first launch of the same launcher (split_w_kernel); the bf16 weight is
//    read in place;
//  * warps: one or two rows of warps (16 MT cells each: MT = 4 at 128
//    cells) by four warp columns of 64 vocabulary columns.  Each warp keeps
//    its cells' 16 MT x 64 logits of a V tile in registers (a 64 x 64 warp
//    tile reads 128 bytes of shared memory a product), adds the bias, and
//    folds them into a running (max, sum) per cell and warp column (quad
//    shuffles within the C fragment); the one thread holding the blank's or
//    the label's column writes that logit to shared memory.  After the last
//    V tile the four warp columns' (max, sum) are combined in a fixed order;
//  * BM (128, 64, 32 or 16 cells; f32 at most 64) and the number of stages
//    are chosen from J by the wrapper (`ops/rnnt_joint.py::launch_geometry`,
//    which the CPU tests hold to the 232,448 bytes a block may take) and
//    checked here: the widest z tile that fits with two stages, then as
//    many stages as fit.  Every cell's sums run in the same k order and over
//    the same column partition whatever BM and BK are, so the outputs do
//    not depend on them, and without atomics two launches give
//    bit-identical outputs (chip_smoke.py checks both).
// Where the time goes (tools/k7_parts.py times the kernel beside variants
// of this source without each part; PERF.md): in bf16, z's build (the tanh
// of every cell's J sums, with no product beside it: one block of 128
// cells a SM) and mma.sync's rate; in f32, W's two planes streamed from L2
// for every 64 cells.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using namespace emo_mma;

constexpr int kWN = 4;         // warp columns of 64 vocabulary columns
constexpr int kBN = 64 * kWN;  // vocabulary columns of a V tile
constexpr int kMinStages = 2, kMaxStages = 4;
constexpr int kMaxJ = 2794;  // the widest joint the kernel has taken since its port
constexpr size_t kMaxSmem = 232448;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// J rounded up to a whole number of ring stages (of 64, 32 or 16 columns)
__host__ __device__ constexpr int padded_j(int J) { return cdiv(J, 64) * 64; }
// row stride of the z planes: padded_j + 8 bf16, an odd multiple of 16 bytes
__host__ __device__ constexpr int z_ld(int J) { return padded_j(J) + 8; }

template <typename E> struct Terms;
template <> struct Terms<bf16> { static constexpr int value = 1; };
template <> struct Terms<float> { static constexpr int value = 2; };

// joint columns of a ring stage: 64 in bf16, 32 in f32 (whose two planes of
// z and of W take twice the room), 16 at 16 cells a block (the widest z
// tiles, beside which no wider ring fits)
__host__ __device__ constexpr int chunk_of(int terms, int bm) { return bm == 16 ? 16 : terms == 1 ? 64 : 32; }
// elements of one plane of a ring stage: kBN rows, chunk + 8 apart (an odd
// multiple of 16 bytes)
__host__ __device__ constexpr int stage_plane(int terms, int bm) { return kBN * (chunk_of(terms, bm) + 8); }

// BM cells a block: WM rows of warps of MT m16 tiles (16 MT cells), by kWN
// warp columns; a warp holds 16 MT x 64 logits of a V tile
template <typename E, int BM> struct Geo {
  static constexpr int TERMS = Terms<E>::value;
  static constexpr int WM = BM >= 64 ? 2 : 1;
  static constexpr int MT = BM / (16 * WM);
  static constexpr int kThreads = 32 * kWN * WM;
  static constexpr int BK = chunk_of(TERMS, BM), LDW = BK + 8, kStagePlane = stage_plane(TERMS, BM);
};

// dynamic shared memory of a block: the z planes, the ring, the warp
// columns' (max, sum) and each cell's blank and label logit
__host__ __device__ inline size_t smem_bytes(int terms, int bm, int stages, int J) {
  return sizeof(bf16) * (static_cast<size_t>(terms) * bm * z_ld(J) + static_cast<size_t>(stages) * terms * stage_plane(terms, bm)) +
         sizeof(float) * (2 * kWN + 2) * bm;
}

// z of one element, in E's precision: bf16 rounds the sum and the tanh
template <typename E>
__device__ __forceinline__ float z_of(float e, float d) {
  if (std::is_same<E, float>::value) return tanhf(e + d);
  return __bfloat162float(__float2bfloat16(tanhf(__bfloat162float(__float2bfloat16(e + d)))));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// eight consecutive values as floats (16-byte aligned)
__device__ __forceinline__ void load8(const bf16* p, float x[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
  return v + __shfl_xor_sync(0xFFFFFFFFu, v, 2);
}

// wait until at most n (0..2) committed cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// the z of the block's BM cells (m0.., of M = T U1) into TERMS planes (BM,
// ldz): rows past the utterance's end and columns past J are 0.  A warp
// takes four rows at a time, a lane eight columns of each (by 16-byte words
// where `vec`: J % 8 == 0 and he, hd 16-byte aligned), so that eight loads
// are in flight before their tanh.
template <typename E, int BM>
__device__ __forceinline__ void build_z(bf16* zs, int ldz, const E* __restrict__ he, const E* __restrict__ hd,
                                        int b, int T, int U1, int J, int m0, int M, bool vec) {
  constexpr int TERMS = Terms<E>::value, NW = Geo<E, BM>::kThreads / 32, R = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, Jp = padded_j(J);
  const size_t zplane = static_cast<size_t>(BM) * ldz;
  for (int r0 = warp; r0 < BM; r0 += R * NW) {
    const E* er[R];
    const E* dr[R];
    bool valid[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int m = m0 + r0 + q * NW, t = m / U1;
      valid[q] = r0 + q * NW < BM && m < M;
      er[q] = he + (valid[q] ? (static_cast<size_t>(b) * T + t) * J : 0);
      dr[q] = hd + (valid[q] ? (static_cast<size_t>(b) * U1 + (m - t * U1)) * J : 0);
    }
    for (int k = 8 * lane; k < Jp; k += 256) {
      float e[R][8], d[R][8];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!valid[q] || k >= J) continue;
        if (vec) {
          load8(er[q] + k, e[q]);
          load8(dr[q] + k, d[q]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            e[q][i] = k + i < J ? to_float(er[q][k + i]) : 0.f;
            d[q][i] = k + i < J ? to_float(dr[q][k + i]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (r0 + q * NW >= BM) continue;
        float t[8][TERMS];
#pragma unroll
        for (int i = 0; i < 8; ++i) split<TERMS>(valid[q] && k + i < J ? z_of<E>(e[q][i], d[q][i]) : 0.f, t[i]);
        bf16* dst = zs + static_cast<size_t>(r0 + q * NW) * ldz + k;
#pragma unroll
        for (int p = 0; p < TERMS; ++p)
          *reinterpret_cast<uint4*>(dst + p * zplane) =
              make_uint4(pack(t[0][p], t[1][p]), pack(t[2][p], t[3][p]), pack(t[4][p], t[5][p]), pack(t[6][p], t[7][p]));
      }
    }
  }
}

// grid (cdiv(T U1, BM), B).  w: TERMS bf16 planes (V, ldw), w_plane apart,
// the columns from J to the next multiple of 8 zero.
template <typename E, int BM>
__global__ void __launch_bounds__(Geo<E, BM>::kThreads)
rnnt_joint_kernel(const E* __restrict__ he, const E* __restrict__ hd, const bf16* __restrict__ w,
                  size_t w_plane, int ldw, const float* __restrict__ bias, const int* __restrict__ labels,
                  float* __restrict__ lpb, float* __restrict__ lpl, int T, int U1, int J, int V, int blank,
                  int v0, float* __restrict__ lse_out, int stages, bool vec) {
  using G = Geo<E, BM>;
  constexpr int TERMS = G::TERMS, MT = G::MT, NTHR = G::kThreads, kBK = G::BK, kLDW = G::LDW;
  constexpr int kStagePlane = G::kStagePlane;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldz = z_ld(J);
  const size_t zplane = static_cast<size_t>(BM) * ldz;
  bf16* zs = reinterpret_cast<bf16*>(smem_raw);                                  // TERMS x (BM, ldz)
  bf16* ring = zs + TERMS * zplane;                                              // stages x TERMS x (kBN, kLDW)
  float* part_m = reinterpret_cast<float*>(ring + static_cast<size_t>(stages) * TERMS * kStagePlane);  // (kWN, BM)
  float* part_l = part_m + kWN * BM;                                             // (kWN, BM)
  float* blank_s = part_l + kWN * BM;                                            // (BM)
  float* label_s = blank_s + BM;                                                 // (BM)

  const int b = blockIdx.y, U = U1 - 1, M = T * U1, m0 = blockIdx.x * BM;  // M < 2^31: the launcher checks
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wn = warp % kWN, row0 = (warp / kWN) * 16 * MT, col0 = 64 * wn;
  const int n_kc = padded_j(J) / kBK, n_it = cdiv(V, kBN) * n_kc;

  // stage i is k chunk i % n_kc of V tile i / n_kc, in ring slot i % stages:
  // `copy_next` copies the next one (one commit group each, empty past the end,
  // so that the waits count right)
  int is_i = 0, is_v0 = 0, is_kc = 0, is_slot = 0;
  auto copy_next = [&]() {
    if (is_i < n_it) {
      const int k0 = is_kc * kBK;
      bf16* dst = ring + static_cast<size_t>(is_slot) * TERMS * kStagePlane;
      for (int x = threadIdx.x; x < kBN * (kBK / 8); x += NTHR) {
        const int n = x / (kBK / 8), k = k0 + 8 * (x % (kBK / 8));
        const bool ok = is_v0 + n < V && k < J;
        const size_t off = ok ? static_cast<size_t>(is_v0 + n) * ldw + k : 0;
#pragma unroll
        for (int p = 0; p < TERMS; ++p)
          cp_async16(dst + p * kStagePlane + n * kLDW + (k - k0), w + p * w_plane + off, ok);
      }
      if (++is_kc == n_kc) {
        is_kc = 0;
        is_v0 += kBN;
      }
      if (++is_slot == stages) is_slot = 0;
    }
    ++is_i;
    cp_async_commit();
  };

  for (int s = 0; s < stages - 1; ++s) copy_next();
  build_z<E, BM>(zs, ldz, he, hd, b, T, U1, J, m0, M, vec);
  if (threadIdx.x < BM) blank_s[threadIdx.x] = label_s[threadIdx.x] = 0.f;

  // the label column of each of the thread's cells (rows g and g + 8 of each
  // m16 tile), -1 for none: u = U, past the end, or outside [v0, v0 + V)
  int lab[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + row0 + 16 * mt + g + 8 * hr;
      int l = -1;
      if (m < M && m % U1 < U) {
        l = labels[static_cast<size_t>(b) * U + m % U1] - v0;
        if (l < 0 || l >= V) l = -1;
      }
      lab[mt][hr] = l;
    }

  float acc[MT][8][4], run_m[MT][2], run_l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      run_m[mt][hr] = -INFINITY;
      run_l[mt][hr] = 0.f;
    }

  for (int i = 0, kc = 0, v0 = 0, slot = 0; i < n_it; ++i) {
    cp_async_wait_n(stages - 2);
    __syncthreads();  // stage i has landed for all, and slot (i - 1) % stages is consumed
    copy_next();      // stage i + stages - 1
    const int k0 = kc * kBK;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    }
    const bf16* st = ring + static_cast<size_t>(slot) * TERMS * kStagePlane;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[TERMS][MT][4];
#pragma unroll
      for (int p = 0; p < TERMS; ++p)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) load_a(af[p][mt], zs + p * zplane, ldz, row0 + 16 * mt, k0 + kk, lane);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2)
#pragma unroll
        for (int q = 0; q < TERMS; ++q) {
          uint32_t bq[4];
          load_b(bq, st + q * kStagePlane, kLDW, col0 + 16 * n2, kk, lane);
#pragma unroll
          for (int p = 0; p < TERMS; ++p)
            if (p + q < TERMS)  // bf16: the one product; f32: hi hi, lo hi, hi lo
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma(acc[mt][2 * n2], af[p][mt], bq[0], bq[1]);
                mma(acc[mt][2 * n2 + 1], af[p][mt], bq[2], bq[3]);
              }
        }
    }
    if (kc == n_kc - 1) {
      // the V tile's logits: bias, the running (max, sum) of each cell over
      // the warp's 64 columns (-inf past V never wins), blank and label
      const int vlo = v0 + col0;
      float bj[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int v = vlo + 8 * j + 2 * c + x;
          bj[j][x] = v < V ? bias[v] : -INFINITY;
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              acc[mt][j][2 * hr + x] += bj[j][x];
              tmax = fmaxf(tmax, acc[mt][j][2 * hr + x]);
            }
          // -inf while every column the warp has seen lies past V: the sum stays 0
          const float m_new = fmaxf(run_m[mt][hr], quad_max(tmax));
          const float at = m_new == -INFINITY ? 0.f : m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) sum += __expf(acc[mt][j][2 * hr] - at) + __expf(acc[mt][j][2 * hr + 1] - at);
          run_l[mt][hr] = run_l[mt][hr] * __expf(run_m[mt][hr] - at) + quad_sum(sum);
          run_m[mt][hr] = m_new;
          const int r = row0 + 16 * mt + g + 8 * hr;
          const int db = blank - vlo, dl = lab[mt][hr] - vlo;
          if (static_cast<unsigned>(db) < 64u) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int x = 0; x < 2; ++x)
                if (8 * j + 2 * c + x == db) blank_s[r] = acc[mt][j][2 * hr + x];
          }
          if (static_cast<unsigned>(dl) < 64u) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int x = 0; x < 2; ++x)
                if (8 * j + 2 * c + x == dl) label_s[r] = acc[mt][j][2 * hr + x];
          }
        }
    }
    if (++kc == n_kc) {
      kc = 0;
      v0 += kBN;
    }
    if (++slot == stages) slot = 0;
  }
  cp_async_wait<0>();
  if (c == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row0 + 16 * mt + g + 8 * hr;
        part_m[wn * BM + r] = run_m[mt][hr];
        part_l[wn * BM + r] = run_l[mt][hr];
      }
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    const int m = m0 + r;
    if (m < M) {
      // warp column 0 holds vocabulary column 0, so mx is finite
      float mx = part_m[r], l = 0.f;
#pragma unroll
      for (int q = 1; q < kWN; ++q) mx = fmaxf(mx, part_m[q * BM + r]);
#pragma unroll
      for (int q = 0; q < kWN; ++q) l += part_l[q * BM + r] * expf(part_m[q * BM + r] - mx);
      const float lse = mx + logf(l);
      const int t = m / U1, u = m - t * U1;
      if (lse_out != nullptr) {  // a block of the vocabulary: its lse and the owned logits
        lse_out[static_cast<size_t>(b) * M + m] = lse;
        lpb[static_cast<size_t>(b) * M + m] = blank_s[r];
        if (u < U) lpl[(static_cast<size_t>(b) * T + t) * U + u] = label_s[r];
      } else {
        lpb[static_cast<size_t>(b) * M + m] = blank_s[r] - lse;
        if (u < U) lpl[(static_cast<size_t>(b) * T + t) * U + u] = label_s[r] - lse;
      }
    }
  }
}

// the two bf16 terms of an f32 weight w (element (k, v) at k sk + v sv) as
// planes (V, J8), V J8 apart, the columns from J to J8 zero
__global__ void split_w_kernel(const float* __restrict__ w, long long sk, long long sv, bf16* __restrict__ out,
                               int V, int J, int J8) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x, n = static_cast<size_t>(V) * J8;
  if (i >= n) return;
  const int v = static_cast<int>(i / J8), k = static_cast<int>(i % J8);
  float t[2];
  split<2>(k < J ? w[k * sk + v * sv] : 0.f, t);
  out[i] = __float2bfloat16(t[0]);
  out[n + i] = __float2bfloat16(t[1]);
}

template <typename E, int BM>
cudaError_t launch_bm(const E* he, const E* hd, const bf16* w, size_t w_plane, int ldw, const float* bias,
                      const int* labels, float* lpb, float* lpl, int B, int T, int U1, int J, int V, int blank,
                      int v0, float* lse_out, int stages, bool vec, cudaStream_t st) {
  const size_t smem = smem_bytes(Terms<E>::value, BM, stages, J);
  cudaError_t err = cudaFuncSetAttribute(rnnt_joint_kernel<E, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(cdiv(T * U1, BM)), B);
  rnnt_joint_kernel<E, BM><<<grid, Geo<E, BM>::kThreads, smem, st>>>(he, hd, w, w_plane, ldw, bias, labels, lpb, lpl,
                                                                 T, U1, J, V, blank, v0, lse_out, stages, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename E>
int launch(const void* he_, const void* hd_, const void* w, const void* bias_, const void* labels_, void* lpb_,
           void* lpl_, void* planes, int B, int T, int U1, int J, int V, int blank, int v0, void* lse_,
           long long w_sk, long long w_sv, int bm, int stages, void* stream) {
  constexpr int TERMS = Terms<E>::value;
  // the whole vocabulary holds the blank; a block (lse_ given) may not
  const bool blank_bad = lse_ == nullptr ? (v0 != 0 || blank < 0 || blank >= V) : (v0 < 0 || blank < 0);
  const bool bad = B < 1 || T < 1 || U1 < 1 || J < 1 || J > kMaxJ || V < 1 || blank_bad ||
                   static_cast<long long>(T) * U1 > (1LL << 31) - 256 || stages < kMinStages || stages > kMaxStages ||
                   (bm != 64 && bm != 32 && bm != 16 && (bm != 128 || TERMS != 1)) ||
                   smem_bytes(TERMS, bm, stages, J) > kMaxSmem;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* wp;
  size_t w_plane = 0;
  int ldw;
  if (TERMS == 1) {  // read in place: rows of the (V, J) weight, w_sv apart, 16-byte words
    if (w_sk != 1 || w_sv % 8 != 0 || w_sv < J || !aligned16(w)) return static_cast<int>(cudaErrorInvalidValue);
    wp = static_cast<const bf16*>(w);
    ldw = static_cast<int>(w_sv);
  } else {  // the planes of the split, (V, J8) each, by a first launch
    if (planes == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    ldw = cdiv(J, 8) * 8;
    w_plane = static_cast<size_t>(V) * ldw;
    split_w_kernel<<<static_cast<unsigned>((w_plane + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(w), w_sk, w_sv, static_cast<bf16*>(planes), V, J, ldw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    wp = static_cast<const bf16*>(planes);
  }
  const E* he = static_cast<const E*>(he_);
  const E* hd = static_cast<const E*>(hd_);
  const bool vec = J % 8 == 0 && aligned16(he) && aligned16(hd);
  const float* bias = static_cast<const float*>(bias_);
  const int* labels = static_cast<const int*>(labels_);
  float* lpb = static_cast<float*>(lpb_);
  float* lpl = static_cast<float*>(lpl_);
  float* lse_out = static_cast<float*>(lse_);
  const int blank_col = blank - v0 < V ? blank - v0 : -1;  // negative: not in this block
  cudaError_t err;
  if constexpr (TERMS == 1) {  // f32 takes at most 64 cells: 128 would hold twice the registers
    if (bm == 128)
      return static_cast<int>(
          launch_bm<E, 128>(he, hd, wp, w_plane, ldw, bias, labels, lpb, lpl, B, T, U1, J, V, blank_col, v0,
                            lse_out, stages, vec, st));
  }
  if (bm == 64)
    err = launch_bm<E, 64>(he, hd, wp, w_plane, ldw, bias, labels, lpb, lpl, B, T, U1, J, V, blank_col, v0,
                            lse_out, stages, vec, st);
  else if (bm == 32)
    err = launch_bm<E, 32>(he, hd, wp, w_plane, ldw, bias, labels, lpb, lpl, B, T, U1, J, V, blank_col, v0,
                            lse_out, stages, vec, st);
  else
    err = launch_bm<E, 16>(he, hd, wp, w_plane, ldw, bias, labels, lpb, lpl, B, T, U1, J, V, blank_col, v0,
                            lse_out, stages, vec, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// he, hd of one type (f32 or bf16), bias f32, labels int32; lpb and lpl
// f32.  w (J, V) at strides (w_sk, w_sv): bf16 in nn.Linear's layout, w_sk
// = 1 and rows w_sv (a multiple of 8) apart, 16-byte aligned; f32 any
// strides, split into `planes`, a bf16 scratch of 2 V J8 (J8 = J rounded
// up to 8; null in bf16).  bm cells a block and `stages` ring stages as
// `ops/rnnt_joint.py::launch_geometry` gives them.
int emo_rnnt_joint_f32(const void* he, const void* hd, const void* w, const void* bias, const void* labels,
                       void* lpb, void* lpl, void* planes, int B, int T, int U1, int J, int V, int blank,
                       long long w_sk, long long w_sv, int bm, int stages, void* stream) {
  return launch<float>(he, hd, w, bias, labels, lpb, lpl, planes, B, T, U1, J, V, blank, 0, nullptr, w_sk, w_sv,
                       bm, stages, stream);
}

int emo_rnnt_joint_bf16(const void* he, const void* hd, const void* w, const void* bias, const void* labels,
                        void* lpb, void* lpl, void* planes, int B, int T, int U1, int J, int V, int blank,
                        long long w_sk, long long w_sv, int bm, int stages, void* stream) {
  return launch<bf16>(he, hd, w, bias, labels, lpb, lpl, planes, B, T, U1, J, V, blank, 0, nullptr, w_sk, w_sv,
                      bm, stages, stream);
}

// A model rank's block of V columns from column v0 of the whole vocabulary
// (w, bias: the block; blank, labels: ids of the whole vocabulary): lse
// (B, T, U1) f32 gets the block's log-sum-exp, lpb and lpl the owned blank
// and label logits (0 elsewhere), not log-probabilities.
int emo_rnnt_joint_shard_f32(const void* he, const void* hd, const void* w, const void* bias, const void* labels,
                             void* lpb, void* lpl, void* planes, int B, int T, int U1, int J, int V, int blank,
                             int v0, void* lse, long long w_sk, long long w_sv, int bm, int stages, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(he, hd, w, bias, labels, lpb, lpl, planes, B, T, U1, J, V, blank, v0, lse, w_sk, w_sv, bm,
                       stages, stream);
}

int emo_rnnt_joint_shard_bf16(const void* he, const void* hd, const void* w, const void* bias, const void* labels,
                              void* lpb, void* lpl, void* planes, int B, int T, int U1, int J, int V, int blank,
                              int v0, void* lse, long long w_sk, long long w_sv, int bm, int stages, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<bf16>(he, hd, w, bias, labels, lpb, lpl, planes, B, T, U1, J, V, blank, v0, lse, w_sk, w_sv, bm,
                      stages, stream);
}

// the dynamic shared memory of a block of bm cells with `stages` stages at
// joint width J, with TERMS = terms (1 bf16, 2 f32), for holding the
// wrapper's own account of it against the kernel's
int emo_rnnt_joint_smem_bytes(int terms, int bm, int stages, int J) {
  return static_cast<int>(smem_bytes(terms, bm, stages, J));
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
