// The whole LSTM recurrence in one launch for Hopper (sm_90a): forward
// from the input projections, and the exact reverse recurrence backward,
// its products on the tensor cores.
//
// Replaces: emoasr_tpu/ops/lstm_pallas.py::lstm_scan_pallas, kernels
// `_fwd_kernel` and `_bwd_kernel`.
//
// Semantics (torch gate order i, f, g, o; xp (B, T, 4H) = x W_ih^T + b_ih +
// b_hh; w (4H, H) = W_hh; h0, c0 (B, H)):
//   forward : pre_t = xp[:, t] + h_{t-1} w^T; i, f, o = sigmoid, g = tanh;
//             c_t = f c_{t-1} + i g; h_t = o tanh(c_t); ys[:, t] = h_t.
//             Residuals: gates (T, B, 4H) after the activations, hcprev
//             (T, B, 2H) = [h_{t-1}, c_{t-1}]; and (h_T, c_T).
//   backward: from the residuals, d ys (B, T, H), d h_T, d c_T: d xp
//             (B, T, 4H) = d pre, d w = sum_t sum_b d pre_t^T h_{t-1}
//             (float32, a fixed order, no atomics), d h0, d c0.
//
// Types, as in the TPU kernel: xp, h0, c0, the outputs ys, hT, cT and the
// residuals gates and hcprev are of one storage type, float32 or bfloat16;
// w is float32 (the wrapper casts it) and the carried h and c are float32.
// The forward upcasts xp and rounds what it stores; its carry is never
// rounded (h_{t-1} for the next step comes from an f32 buffer, not from
// ys).  The backward reads dys, d h_T, d c_T and the rounded residuals in
// the storage type and recomputes from those, carries d h and d c in f32,
// sums d w in f32 from the unrounded d pre and rounds d xp, d h0 and d c0.
//
// Arithmetic: every product h_{t-1} w^T, d pre_t w and d pre^T h_{t-1} runs
// on the tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums).  A
// float32 operand is split into two bf16 terms, x = x0 + x1 (+ ~2^-17 x),
// and the three leading cross products x0 w0 + x0 w1 + x1 w0 are kept (the
// emulation in tests/test_torch_kernel_arith.py holds this within the f32
// tolerances over T = 129 dependent steps; one term misses them).  A w_hh
// that arrives as bf16 is its own single term (`w_terms` 1): its products
// with the zero second term are skipped, which gives the same sums exactly.
// Each k-step's products gather in a sum of their own, added to the
// accumulator once (the tensor cores truncate a sum to its largest addend).
//
// What bounds it on this card: the T dependent steps.  At the prediction
// network's largest training shape (B 18, T 129, H 512) the forward's
// products are 0.5 GFLOP and its bytes ~40 MB; a step waits for the whole
// previous h, so the floor is T times (a grid-wide barrier + the fetch of
// h_{t-1} from L2 + one block's products and cell update).
//
// Design.  One cooperative launch, one block of 256 threads an SM, all
// co-resident (the launcher checks it and refuses otherwise):
//  * A block owns U hidden units (forward: U = 4 up to H = 512, one m16
//    tile's worth of gate rows, faster there than 8 on an H100, and 8 above;
//    backward: 8, so that its N = 8 columns fill an n8 tile) with all four of
//    their gates, so that the cell update stays in the block.  The products
//    take the batch as their M dimension (tiles of 16 or 32 rows), the
//    block's columns as N (forward: the 4U gate rows of w; backward: the U
//    columns of w) and split K (H forward, 4H backward, each padded to a
//    multiple of 128 per gate, Hp) over the 8 warps.
//  * w_hh is split once per launch into B fragments: its first term stays
//    in registers (at most 64 a thread), its second in shared memory, laid
//    out so that a lane reads its two words of a fragment as one 8-byte
//    load.
//  * Each step, each warp copies its own K slice of the broadcast operand
//    (h_{t-1}, f32 (B, Hp), forward; d pre_t, (B, 4Hp) words, backward)
//    from L2 with 16-byte cp.async into a ring of its own (`stages` slots;
//    where the ring holds the whole slice, all at once and waited for
//    once).  The backward's cells store d pre_t already split into its two
//    bf16 terms (a word pair per two columns, the same bytes as f32), so no
//    block splits it again; the forward's warps split h_{t-1} as they build
//    their A fragments (a value is read by one warp of a block only), which
//    costs the forward no measurable time (tools/k8_parts.py, `no_split`).
//    The warps' f32 partial sums meet in shared memory, added in warp order.
//  * The cell update runs on all threads at once, a thread a (batch row,
//    unit) cell; the forward prefetches its xp before the step's barrier,
//    the backward its gates, c_{t-1} and dys.
//  * One grid barrier a step: a release add on one counter, an acquire
//    load spin by one thread a block.
//  * Backward: each step's split d pre goes to a (T, B, 4Hp) scratch, which
//    is also the broadcast buffer; after the recurrence a second kernel,
//    `lstm_dw_kernel`, forms d w_hh = sum over (t, b) of d pre^T h_{t-1} on
//    the tensor cores, 64 x 64 tiles of d w, (t, b) in order: the serial loop
//    carries no d w.
// The launch geometry (units, ring stages, shared memory) is chosen by the
// wrapper (ops/lstm_scan.py::launch_geometry) and mirrored here
// (`fwd_plan`, `bwd_plan`, exported as emo_lstm_smem_bytes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace emo_mma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxH = 1024;     // Hp <= 1024: at most 8 k-steps a warp forward, 32 backward
constexpr int kPad = 8;         // floats after each staged row: conflict-free 8-byte fragment loads
constexpr int kMaxStages = 8;
constexpr size_t kSmemMax = 232448;  // what one block may use on sm_90
constexpr int kBwdUnits = 8;
constexpr int kFwdChunk = 1;    // k-steps a ring slot holds, forward
constexpr int kBwdChunk = 4;    // and backward

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename S> __device__ __forceinline__ S from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr long long kBarrierTimeout = 20000000000LL;  // clock cycles, some 10 s

// The grid barrier (all blocks co-resident): every block adds one to *bar
// with release semantics once all its threads' stores are done, and waits
// until the k-th barrier's k x gridDim.x arrivals with an acquire load.  A
// wait past kBarrierTimeout traps (a launch failure the wrapper raises)
// rather than hanging the card.
__device__ __forceinline__ void grid_arrive(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
}

__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned target) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
      if (clock64() - start > kBarrierTimeout) __trap();
    } while (v < target);
  }
  __syncthreads();
}

// wait until at most n (< kMaxStages) committed cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// ------------------------------------------------------------- geometry

__host__ __device__ inline int padded_h(int H) { return (H + 127) / 128 * 128; }
__host__ __device__ inline int tile_rows(int B) { return B <= 16 ? 16 : 32; }  // the batch tile
__host__ __device__ inline int staged_rows(int B) { return B < tile_rows(B) ? B : tile_rows(B); }

// Shared memory of a block, in bytes, in this order: the second term of its
// w fragments (w_terms 2), the warps' partial sums (tile rows x (N + 8)
// floats each), the block's cells (two floats each: c and h forward, d h
// and d c backward) and the warps' rings (`stages` slots of the staged rows
// x (16 chunk + 8) floats).
struct SmemPlan {
  size_t w1, part, cells, slot_floats, slots, total;
  __host__ __device__ SmemPlan(int B, int ksteps, int N, int U, int chunk, int stages, int w_terms) {
    w1 = w_terms == 2 ? static_cast<size_t>(kWarps) * ksteps * (N / 8) * 32 * 8 : 0;
    part = static_cast<size_t>(kWarps) * tile_rows(B) * (N + 8) * 4;
    cells = 2 * static_cast<size_t>(B) * U * 4;
    slot_floats = static_cast<size_t>(staged_rows(B)) * (16 * chunk + kPad);
    slots = static_cast<size_t>(kWarps) * stages * slot_floats * 4;
    total = w1 + part + cells + slots;
  }
};

__host__ __device__ inline SmemPlan fwd_plan(int B, int H, int U, int stages, int w_terms) {
  return SmemPlan(B, padded_h(H) / 128, 4 * U, U, kFwdChunk, stages, w_terms);
}
__host__ __device__ inline SmemPlan bwd_plan(int B, int H, int stages, int w_terms) {
  return SmemPlan(B, padded_h(H) / 32, kBwdUnits, kBwdUnits, kBwdChunk, stages, w_terms);
}

// ------------------------------------------------------------- the products

// Copy rows [0, nb) x columns [c0, c0 + 16 CK) of x (row stride ldx floats,
// 16-byte aligned) into a ring slot, 16 bytes a lane at a time.
template <int CK>
__device__ __forceinline__ void stage(float* slot, const float* x, int ldx, int nb, int c0, int lane) {
  constexpr int V = 4 * CK, LD = 16 * CK + kPad;
  for (int i = lane; i < nb * V; i += 32) {
    const int r = i / V, v = i % V;
    cp_async16(slot + r * LD + 4 * v, x + static_cast<size_t>(r) * ldx + c0 + 4 * v, true);
  }
}

// The A fragment (rows m0.., columns 16 kk.. of a slot) as two bf16 terms,
// a[0] the leading one; rows >= nb are zero.  PLANES: the slot holds each
// pair of columns already split, as the word pair {first terms, second
// terms} (the backward's d pre); else f32 values, split here.
template <bool PLANES>
__device__ __forceinline__ void load_a(uint32_t a[2][4], const float* s, int ld, int m0, int kk, int nb,
                                       int lane) {
  const int g = lane >> 2, c = lane & 3;
  const int r0 = m0 + g, r1 = r0 + 8, k0 = 16 * kk + 2 * c;
  float2 v[4];
  v[0] = v[1] = v[2] = v[3] = make_float2(0.f, 0.f);
  if (r0 < nb) {
    v[0] = *reinterpret_cast<const float2*>(s + r0 * ld + k0);
    v[2] = *reinterpret_cast<const float2*>(s + r0 * ld + k0 + 8);
  }
  if (r1 < nb) {
    v[1] = *reinterpret_cast<const float2*>(s + r1 * ld + k0);
    v[3] = *reinterpret_cast<const float2*>(s + r1 * ld + k0 + 8);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (PLANES) {
      a[0][q] = __float_as_uint(v[q].x);
      a[1][q] = __float_as_uint(v[q].y);
    } else {
      uint32_t t[2];
      split_pack<2>(v[q].x, v[q].y, t);
      a[0][q] = t[0];
      a[1][q] = t[1];
    }
  }
}

// acc[mt][nt] += one k-step's products: the A fragments of the slot's
// columns 16 kk.. (two terms, see load_a) times the w fragments wk (first
// terms) and w1k (second terms, shared memory; null for a w_hh of one
// term).  The three products start from zero, independent of each other,
// and their sum (the small ones first) is added to the accumulator once.
template <int NT, bool PLANES>
__device__ __forceinline__ void kstep(float (&acc)[2][NT][4], const uint32_t (&wk)[NT][2], const uint2* w1k,
                                      const float* s, int ld, int kk, int nb, int lane) {
  const int mts = (nb + 15) / 16;
  uint32_t a[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    if (mt < mts) load_a<PLANES>(a[mt], s, ld, 16 * mt, kk, nb, lane);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint2 lo = w1k != nullptr ? w1k[nt * 32 + lane] : make_uint2(0u, 0u);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt < mts) {
        float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
        mma(p0, a[mt][1], wk[nt][0], wk[nt][1]);
        if (w1k != nullptr) mma(p1, a[mt][0], lo.x, lo.y);
        mma(p2, a[mt][0], wk[nt][0], wk[nt][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] += (p0[q] + p1[q]) + p2[q];
      }
    }
  }
}

// acc[mt][nt] += (rows of x) . (the warp's w fragments) over the warp's
// k-steps [kbase / 16, kbase / 16 + ks): x (nb rows, stride ldx) streams
// through the warp's ring (nst slots of slot_floats) CK k-steps a slot.
// Where the ring holds the whole slice, every copy is issued at once and
// waited for once; else slot by slot.  w0: the fragments' first terms
// (registers), w1: their second terms (shared memory, k-step major, or
// null for a w_hh of one term); PLANES as in load_a.
template <int KMAX, int CK, int NT, bool PLANES>
__device__ __forceinline__ void warp_product(float (&acc)[2][NT][4], const uint32_t (&w0)[KMAX][NT][2],
                                             const uint2* w1, float* slots, int nst, int slot_floats,
                                             const float* x, int ldx, int nb, int kbase, int ks, int lane) {
  constexpr int LD = 16 * CK + kPad;
  const int nch = ks / CK;
  auto w1k = [&](int k) { return w1 != nullptr ? w1 + k * NT * 32 : nullptr; };
  if (nst >= nch) {  // warp-uniform
    for (int i = 0; i < nch; ++i) stage<CK>(slots + i * slot_floats, x, ldx, nb, kbase + 16 * CK * i, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int i = 0; i < KMAX / CK; ++i)
      if (i < nch)
#pragma unroll
        for (int kk = 0; kk < CK; ++kk)
          kstep<NT, PLANES>(acc, w0[i * CK + kk], w1k(i * CK + kk), slots + i * slot_floats, LD, kk, nb, lane);
    __syncwarp();  // the slots are free for the next tile's copies
    return;
  }
  for (int i = 0; i < nst - 1; ++i) {
    stage<CK>(slots + i * slot_floats, x, ldx, nb, kbase + 16 * CK * i, lane);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < KMAX / CK; ++i) {
    if (i < nch) {  // warp-uniform
      const int nx = i + nst - 1;  // the slot consumed at step i - 1
      if (nx < nch) stage<CK>(slots + (nx % nst) * slot_floats, x, ldx, nb, kbase + 16 * CK * nx, lane);
      cp_async_commit();
      cp_async_wait_n(nst - 1);
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < CK; ++kk)
        kstep<NT, PLANES>(acc, w0[i * CK + kk], w1k(i * CK + kk), slots + (i % nst) * slot_floats, LD, kk, nb,
                          lane);
      __syncwarp();  // the slot is free for the copy of step i + nst
    }
  }
}

// A B fragment's two words of w values (k, n) for k = k0 + 2c (+1) and
// k0 + 2c + 8 (+9), split into two terms: the first packed into w0, the
// second into *w1 (when w1 is not null)
template <typename Fn>
__device__ __forceinline__ void w_fragment(uint32_t w0[2], uint2* w1, int k0, int lane, Fn value) {
  const int c = lane & 3;
  uint32_t t0[2], t1[2];
  split_pack<2>(value(k0 + 2 * c), value(k0 + 2 * c + 1), t0);
  split_pack<2>(value(k0 + 2 * c + 8), value(k0 + 2 * c + 9), t1);
  w0[0] = t0[0];
  w0[1] = t1[0];
  if (w1 != nullptr) *w1 = make_uint2(t0[1], t1[1]);
}


// this warp's partial sums (the tile's rows x N columns, stride N + 8) into
// its region of part
template <int NT>
__device__ __forceinline__ void store_partials(float* part, const float (&acc)[2][NT][4], int nb, int lane) {
  constexpr int LDP = 8 * NT + 8;
  const int g = lane >> 2, c = lane & 3, mts = (nb + 15) / 16;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt < mts) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = 16 * mt + g, n = 8 * nt + 2 * c;
        *reinterpret_cast<float2*>(part + m * LDP + n) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(part + (m + 8) * LDP + n) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

// ------------------------------------------------------------------ forward

// xp[b, t, g H + j] for the four gates g, as float
template <typename S>
__device__ __forceinline__ void load_xp(float x[4], const S* __restrict__ xp, int b, int t, int T, int H, int j) {
  const S* p = xp + (static_cast<size_t>(b) * T + t) * 4 * H + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) x[g] = to_float(p[static_cast<size_t>(g) * H]);
}

// What a cell's forward step stores besides h_t: its gates, [h, c]_{t-1},
// h_t and c_t (ys, and h_T, c_T at the last step), for batch row b
struct CellOut {
  float g[4], hp, cp, hn, cn;
  int b;
};

template <typename S>
__device__ __forceinline__ void store_cell(const CellOut& o, S* __restrict__ ys, S* __restrict__ gates,
                                           S* __restrict__ hcprev, S* __restrict__ hT, S* __restrict__ cT, int t,
                                           int B, int T, int H, int j) {
  ys[(static_cast<size_t>(o.b) * T + t) * H + j] = from_float<S>(o.hn);
  S* gr = gates + (static_cast<size_t>(t) * B + o.b) * 4 * H + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) gr[static_cast<size_t>(g) * H] = from_float<S>(o.g[g]);
  S* hc = hcprev + (static_cast<size_t>(t) * B + o.b) * 2 * H + j;
  hc[0] = from_float<S>(o.hp);
  hc[H] = from_float<S>(o.cp);
  if (t == T - 1) {
    hT[static_cast<size_t>(o.b) * H + j] = from_float<S>(o.hn);
    cT[static_cast<size_t>(o.b) * H + j] = from_float<S>(o.cn);
  }
}

// U units a block (4 or 8): N = 4U gate rows (row g U + u of the block is
// row g H + j0 + u of w), NT = U / 2 n8 tiles; KMAX k-steps a warp at most
// (Hp = 128 KMAX).  hbuf (2, B, Hp) f32, zero in columns >= H: h_t goes to
// slot t % 2 (h0 to slot 1).
template <typename S, int U>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const S* __restrict__ xp, const float* __restrict__ w, const S* __restrict__ h0,
                const S* __restrict__ c0, S* __restrict__ ys, S* __restrict__ gates, S* __restrict__ hcprev,
                S* __restrict__ hT, S* __restrict__ cT, float* hbuf, unsigned* bar, int B, int T, int H,
                int stages, int w_terms) {
  constexpr int NT = U / 2, N = 4 * U, KMAX = U == 4 ? 4 : 8, CK = kFwdChunk, LDP = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x;
  const int Hp = padded_h(H), ks = Hp / 128, kbase = warp * 16 * ks, j0 = blockIdx.x * U;
  const int rows = tile_rows(B);
  const SmemPlan plan = fwd_plan(B, H, U, stages, w_terms);
  uint2* w1 = w_terms == 2 ? reinterpret_cast<uint2*>(smem) + static_cast<size_t>(warp) * ks * NT * 32 : nullptr;
  float* part = reinterpret_cast<float*>(smem + plan.w1);
  float* cs = reinterpret_cast<float*>(smem + plan.w1 + plan.part);  // (B, U): c
  float* hs = cs + B * U;                                             // (B, U): h, f32
  float* slots = reinterpret_cast<float*>(smem + plan.w1 + plan.part + plan.cells) +
                 static_cast<size_t>(warp) * stages * plan.slot_floats;

  // w's rows g H + j0 + u, split once: B fragments (k, n) = w[row(n), k]
  uint32_t w0[KMAX][NT][2];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      w0[k][nt][0] = w0[k][nt][1] = 0u;
      if (k < ks) {
        const int n = 8 * nt + (lane >> 2), j = j0 + n % U;
        const float* wr = w + static_cast<size_t>((n / U) * H + (j < H ? j : 0)) * H;
        w_fragment(w0[k][nt], w1 != nullptr ? w1 + (k * NT + nt) * 32 + lane : nullptr, kbase + 16 * k, lane,
                   [&](int kk) { return j < H && kk < H ? wr[kk] : 0.f; });
      }
    }
  for (int i = tid; i < B * U; i += kThreads) {
    const int b = i / U, j = j0 + i % U;
    if (j < H) {
      const float h = to_float(h0[static_cast<size_t>(b) * H + j]);
      cs[i] = to_float(c0[static_cast<size_t>(b) * H + j]);
      hs[i] = h;
      hbuf[(static_cast<size_t>(B) + b) * Hp + j] = h;
    }
  }
  // this thread's cell of a batch tile: (row m, unit u)
  const int m = tid / U, u = tid % U, j = j0 + u;
  const bool mine = m < min(rows, B) && j < H;
  float xq[4] = {0.f, 0.f, 0.f, 0.f};  // its xp in the first tile, fetched ahead of the step
  if (mine) load_xp(xq, xp, m, 0, T, H, j);
  unsigned epoch = 1;
  grid_arrive(bar);
  grid_wait(bar, epoch * gridDim.x);
  CellOut out = {};  // this thread's cell of the step's last tile
  bool pending = false;

  for (int t = 0; t < T; ++t) {
    const float* hx = hbuf + static_cast<size_t>((t + 1) & 1) * B * Hp;  // h_{t-1}
    for (int b0 = 0; b0 < B; b0 += rows) {
      const int nb = min(rows, B - b0);
      float acc[2][NT][4] = {};
      warp_product<KMAX, CK, NT, false>(acc, w0, w1, slots, stages, static_cast<int>(plan.slot_floats),
                                 hx + static_cast<size_t>(b0) * Hp, Hp, nb, kbase, ks, lane);
      store_partials<NT>(part + static_cast<size_t>(warp) * rows * LDP, acc, nb, lane);
      __syncthreads();
      if (m < nb && j < H) {  // the cell update, a thread a cell
        const int b = b0 + m, cell = b * U + u;
        float x[4];
        if (b0 == 0) {
#pragma unroll
          for (int g = 0; g < 4; ++g) x[g] = xq[g];
        } else {
          load_xp(x, xp, b, t, T, H, j);
        }
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = 0.f;
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp) s += part[(static_cast<size_t>(wp) * rows + m) * LDP + g * U + u];
          pre[g] = x[g] + s;
        }
        const float gi = sigmoidf_(pre[0]), gf = sigmoidf_(pre[1]), gg = tanhf(pre[2]), go = sigmoidf_(pre[3]);
        const float cp = cs[cell], hp = hs[cell];
        const float cn = gf * cp + gi * gg;
        const float hn = go * tanhf(cn);
        cs[cell] = cn;
        hs[cell] = hn;
        hbuf[(static_cast<size_t>(t & 1) * B + b) * Hp + j] = hn;
        out = {{gi, gf, gg, go}, hp, cp, hn, cn, b};
        pending = b0 + rows >= B;  // the step's last tile: stored after the barrier's arrival
        if (!pending) store_cell(out, ys, gates, hcprev, hT, cT, t, B, T, H, j);
      }
      __syncthreads();  // the partials are read; the next tile may write them
    }
    // only h_t must reach L2 before the arrival; the residuals follow it
    if (t + 1 < T) grid_arrive(bar);
    if (pending) store_cell(out, ys, gates, hcprev, hT, cT, t, B, T, H, j);
    pending = false;
    if (t + 1 < T) {
      if (mine) load_xp(xq, xp, m, t + 1, T, H, j);
      grid_wait(bar, ++epoch * gridDim.x);
    }
  }
}

// ------------------------------------------------------------------ backward

// The inputs of one cell's backward at step t: its four gates, c_{t-1} and
// d ys, as float
struct CellIn {
  float g[4], cp, dy;
};

template <typename S>
__device__ __forceinline__ CellIn load_cell(const S* __restrict__ gates, const S* __restrict__ hcprev,
                                            const S* __restrict__ dys, int b, int t, int B, int T, int H, int j) {
  CellIn in;
  const S* gr = gates + (static_cast<size_t>(t) * B + b) * 4 * H + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) in.g[g] = to_float(gr[static_cast<size_t>(g) * H]);
  in.cp = to_float(hcprev[(static_cast<size_t>(t) * B + b) * 2 * H + H + j]);
  in.dy = to_float(dys[(static_cast<size_t>(b) * T + t) * H + j]);
  return in;
}

// d x_proj[b, t, g H + j] = d pre, rounded to the storage type
template <typename S>
__device__ __forceinline__ void store_dxp(const float dg[4], S* __restrict__ dxp, int b, int t, int T, int H, int j) {
  S* d = dxp + (static_cast<size_t>(b) * T + t) * 4 * H + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) d[static_cast<size_t>(g) * H] = from_float<S>(dg[g]);
}

// d h_{t-1} of a batch tile for the block's units: the warps' products of
// the tile's rows of x (stride K) with the w fragments, then added in warp
// order into out[(b0 + row) U + unit] (rows < nb)
template <int KMAX, int CK>
__device__ __forceinline__ void bwd_tile(float* out, const uint32_t (&w0)[KMAX][1][2], const uint2* w1,
                                         float* slots, int stages, int slot_floats, const float* x, int K,
                                         int nb, int b0, int kbase, int ks, float* part, int rows, int warp,
                                         int lane) {
  constexpr int U = kBwdUnits, LDP = 16;
  float acc[2][1][4] = {};
  warp_product<KMAX, CK, 1, true>(acc, w0, w1, slots, stages, slot_floats, x, K, nb, kbase, ks, lane);
  store_partials<1>(part + static_cast<size_t>(warp) * rows * LDP, acc, nb, lane);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nb * U) {
    const int mm = threadIdx.x / U, uu = threadIdx.x % U;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += part[(static_cast<size_t>(wp) * rows + mm) * LDP + uu];
    out[(b0 + mm) * U + uu] = s;
  }
  __syncthreads();
}

// 8 units a block: d h_{t-1}[:, j0 .. j0 + 7] = d pre_t . w[:, j0 ..], K =
// 4 Hp (row g Hp + jj of K is row g H + jj of w, zero for jj >= H); dpre
// (T, B, 4Hp) words: d pre of every step split into two bf16 terms by the
// cell that computes it, columns 2m and 2m + 1 as the word pair {their
// first terms, their second terms}, zero in the padding columns; read back
// by every block after the step's barrier and by lstm_dw_kernel.
template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const S* __restrict__ gates, const S* __restrict__ hcprev, const S* __restrict__ dys,
                const S* __restrict__ dhT, const S* __restrict__ dcT, const float* __restrict__ w,
                S* __restrict__ dxp, S* __restrict__ dh0, S* __restrict__ dc0, float* dpre, unsigned* bar,
                int B, int T, int H, int stages, int w_terms) {
  constexpr int U = kBwdUnits, KMAX = 32, CK = kBwdChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x;
  const int Hp = padded_h(H), K = 4 * Hp, ks = K / 128, kbase = warp * 16 * ks, j0 = blockIdx.x * U;
  const int rows = tile_rows(B);
  const SmemPlan plan = bwd_plan(B, H, stages, w_terms);
  uint2* w1 = w_terms == 2 ? reinterpret_cast<uint2*>(smem) + static_cast<size_t>(warp) * ks * 32 : nullptr;
  float* part = reinterpret_cast<float*>(smem + plan.w1);
  float* dhs = reinterpret_cast<float*>(smem + plan.w1 + plan.part);  // (B, U): carried d h
  float* dcs = dhs + B * U;                                            // (B, U): carried d c
  float* slots = reinterpret_cast<float*>(smem + plan.w1 + plan.part + plan.cells) +
                 static_cast<size_t>(warp) * stages * plan.slot_floats;
  const int slot_floats = static_cast<int>(plan.slot_floats);

  // w's columns j0 + n, split once: B fragments (k, n) = w[row(k), j0 + n]
  uint32_t w0[KMAX][1][2];
  {
    const int j = j0 + (lane >> 2);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      w0[k][0][0] = w0[k][0][1] = 0u;
      if (k < ks)
        w_fragment(w0[k][0], w1 != nullptr ? w1 + k * 32 + lane : nullptr, kbase + 16 * k, lane, [&](int kk) {
          const int jj = kk % Hp;
          return j < H && jj < H ? w[static_cast<size_t>((kk / Hp) * H + jj) * H + j] : 0.f;
        });
    }
  }
  for (int i = tid; i < B * U; i += kThreads) {
    const int b = i / U, j = j0 + i % U;
    const bool live = j < H;
    dhs[i] = live ? to_float(dhT[static_cast<size_t>(b) * H + j]) : 0.f;
    dcs[i] = live ? to_float(dcT[static_cast<size_t>(b) * H + j]) : 0.f;
  }
  // this thread's first cell (row tid / U, unit tid % U): its inputs are
  // fetched a step ahead
  const int mb = tid / U, mj = j0 + tid % U;
  const bool mine = mb < B && mj < H;
  CellIn nxt = {};
  float mdg[4] = {0.f, 0.f, 0.f, 0.f};  // its d pre, stored to d x_proj after the arrival
  if (mine) nxt = load_cell(gates, hcprev, dys, mb, T - 1, B, T, H, mj);
  unsigned epoch = 0;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // the cells' backward: d pre_t of the block's units (whole warps run
    // each pass: a cell's neighbour in the next lane is the next unit)
    for (int i0 = 0; i0 < B * U; i0 += kThreads) {
      const int i = i0 + tid, b = i / U, j = j0 + i % U;
      const bool live = i < B * U && j < H;
      float dg[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        const CellIn in = i == tid ? nxt : load_cell(gates, hcprev, dys, b, t, B, T, H, j);
        const float gi = in.g[0], gf = in.g[1], gg = in.g[2], go = in.g[3];
        const float tc = tanhf(gf * in.cp + gi * gg);
        const float dh = in.dy + dhs[i];
        const float dc = dcs[i] + dh * go * (1.f - tc * tc);
        dg[0] = dc * gg * gi * (1.f - gi);
        dg[1] = dc * in.cp * gf * (1.f - gf);
        dg[2] = dc * gi * (1.f - gg * gg);
        dg[3] = dh * tc * go * (1.f - go);
        if (i == tid) {
#pragma unroll
          for (int g = 0; g < 4; ++g) mdg[g] = dg[g];
        } else {
          store_dxp(dg, dxp, b, t, T, H, j);
        }
        dcs[i] = dc * gf;
      }
      // d pre_t split once, here: an even unit stores its column and the
      // next one's (zero past H) as one 8-byte word pair a gate
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float next = __shfl_down_sync(0xffffffffu, dg[g], 1);
        if (live && !(j & 1)) {
          uint32_t w2[2];
          split_pack<2>(dg[g], next, w2);
          *reinterpret_cast<uint2*>(dpre + (static_cast<size_t>(t) * B + b) * K + g * Hp + j) =
              make_uint2(w2[0], w2[1]);
        }
      }
    }
    // only d pre_t must reach L2 before the arrival; d x_proj follows it
    grid_arrive(bar);
    if (mine) store_dxp(mdg, dxp, mb, t, T, H, mj);
    if (mine && t > 0) nxt = load_cell(gates, hcprev, dys, mb, t - 1, B, T, H, mj);
    grid_wait(bar, ++epoch * gridDim.x);
    // d h_{t-1} of the block's units (at t = 0: d h0)
    for (int b0 = 0; b0 < B; b0 += rows)
      bwd_tile<KMAX, CK>(dhs, w0, w1, slots, stages, slot_floats, dpre + (static_cast<size_t>(t) * B + b0) * K, K,
                         min(rows, B - b0), b0, kbase, ks, part, rows, warp, lane);
  }
  for (int i = tid; i < B * U; i += kThreads) {
    const int b = i / U, j = j0 + i % U;
    if (j < H) {
      dh0[static_cast<size_t>(b) * H + j] = from_float<S>(dhs[i]);
      dc0[static_cast<size_t>(b) * H + j] = from_float<S>(dcs[i]);
    }
  }
}

// d w (4H, H) = sum over (t, b) of d pre[t, b, :]^T h_{t-1}[b, :], f32 from
// the unrounded d pre (as the backward stored it, two bf16 terms) and the
// stored h_{t-1} (hcprev[:, :, :H]: two terms in f32, one in bf16).  A block
// owns a 64 x 64 tile of d w in K's padded rows (g Hp + jj); its 8 warps
// 32 x 16 each; (t, b) runs in order, 32 at a time, as bf16 planes in shared
// memory (h_{t-1} split once on the way).  Each element of d w is one
// thread's sum: a fixed order, no atomics.
template <typename S>
__global__ void __launch_bounds__(kThreads)
lstm_dw_kernel(const float* __restrict__ dpre, const S* __restrict__ hcprev, float* __restrict__ dw, int B,
               int T, int H) {
  constexpr int BM = 64, BN = 64, BK = 32, LDS = BN + 8;  // bf16 rows of 144 bytes
  constexpr bool kF32 = sizeof(S) == 4;
  __shared__ __align__(16) bf16 as[2][BK][LDS];  // d pre planes, [tb][r]
  __shared__ __align__(16) bf16 bs[2][BK][LDS];  // h_{t-1} planes, [tb][k]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x;
  const int Hp = padded_h(H), K = 4 * Hp, TB = T * B;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
  const int lr = tid >> 3, lc = (tid & 7) * 8;  // this thread's row and 8 columns of a (BK, 64) chunk
  uint4 av[2];  // d pre's words of 8 columns: {first, second} terms of each pair
  float bv[8];
  auto fetch = [&](int tb0) {
    const int tb = tb0 + lr;
    const bool in = tb < TB;
    const uint4* a = reinterpret_cast<const uint4*>(dpre + static_cast<size_t>(in ? tb : 0) * K + m0 + lc);
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    av[0] = in ? a[0] : z;
    av[1] = in ? a[1] : z;
    const S* h = hcprev + static_cast<size_t>(in ? tb : 0) * 2 * H;
#pragma unroll
    for (int q = 0; q < 8; ++q) bv[q] = in && n0 + lc + q < H ? to_float(h[n0 + lc + q]) : 0.f;
  };
  float acc[2][2][4] = {};
  fetch(0);
  for (int tb0 = 0; tb0 < TB; tb0 += BK) {
    const uint32_t pa[2][4] = {{av[0].x, av[0].z, av[1].x, av[1].z}, {av[0].y, av[0].w, av[1].y, av[1].w}};
    uint32_t pb[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t t[2];
      split_pack<2>(bv[2 * q], bv[2 * q + 1], t);
      pb[0][q] = t[0];
      pb[1][q] = t[1];
    }
    *reinterpret_cast<uint4*>(&as[0][lr][lc]) = make_uint4(pa[0][0], pa[0][1], pa[0][2], pa[0][3]);
    *reinterpret_cast<uint4*>(&as[1][lr][lc]) = make_uint4(pa[1][0], pa[1][1], pa[1][2], pa[1][3]);
    *reinterpret_cast<uint4*>(&bs[0][lr][lc]) = make_uint4(pb[0][0], pb[0][1], pb[0][2], pb[0][3]);
    if (kF32) *reinterpret_cast<uint4*>(&bs[1][lr][lc]) = make_uint4(pb[1][0], pb[1][1], pb[1][2], pb[1][3]);
    __syncthreads();
    if (tb0 + BK < TB) fetch(tb0 + BK);  // the next chunk's loads fly under this one's products
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int p = 0; p < 2; ++p) load_a_trans(a[mt][p], &as[p][0][0], LDS, wm + 16 * mt, 16 * kk, lane);
      load_b_trans(b[0], &bs[0][0][0], LDS, wn, 16 * kk, lane);
      if (kF32) load_b_trans(b[1], &bs[1][0][0], LDS, wn, 16 * kk, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's products, smallest first
          mma(p, a[mt][1], b[0][2 * nt], b[0][2 * nt + 1]);
          if (kF32) mma(p, a[mt][0], b[1][2 * nt], b[1][2 * nt + 1]);
          mma(p, a[mt][0], b[0][2 * nt], b[0][2 * nt + 1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += p[q];
        }
    }
    __syncthreads();
  }
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int r = m0 + wm + 16 * mt + g + 8 * h8, jj = r % Hp;
      if (r >= K || jj >= H) continue;
      float* out = dw + static_cast<size_t>((r / Hp) * H + jj) * H;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + 8 * nt + 2 * c + e;
          if (n < H) out[n] = acc[mt][nt][2 * h8 + e];
        }
    }
}

// ------------------------------------------------------------------ launch

// the grid of `blocks` blocks must be co-resident (one cooperative launch)
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int blocks, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  return blocks <= per_sm * sms ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

bool geometry_ok(int B, int T, int H, int stages, int w_terms, size_t smem) {
  return B >= 1 && T >= 1 && H >= 1 && H <= kMaxH && stages >= 1 && stages <= kMaxStages &&
         (w_terms == 1 || w_terms == 2) && smem <= kSmemMax;
}

template <typename S, int U>
cudaError_t launch_fwd(void** args, int H, size_t smem, cudaStream_t stream) {
  const int blocks = (H + U - 1) / U;
  cudaError_t err = prepare(lstm_fwd_kernel<S, U>, blocks, smem);
  if (err != cudaSuccess) return err;
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_fwd_kernel<S, U>), dim3(blocks),
                                     dim3(kThreads), args, smem, stream);
}

template <typename S>
int fwd(const void* xp, const void* w, const void* h0, const void* c0, void* ys, void* gates, void* hcprev,
        void* hT, void* cT, void* hbuf, void* bar, int B, int T, int H, int units, int stages, int w_terms,
        void* stream) {
  if (units != 4 && units != 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_plan(B, H, units, stages, w_terms).total;
  if (!geometry_ok(B, T, H, stages, w_terms, smem) || (units == 4 && padded_h(H) > 512))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&xp, &w, &h0, &c0, &ys, &gates, &hcprev, &hT, &cT, &hbuf, &bar,
                  &B, &T, &H, &stages, &w_terms};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = units == 4 ? launch_fwd<S, 4>(args, H, smem, st) : launch_fwd<S, 8>(args, H, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int bwd(const void* gates, const void* hcprev, const void* dys, const void* dhT, const void* dcT, const void* w,
        void* dxp, void* dw, void* dh0, void* dc0, void* dpre, void* bar, int B, int T, int H, int stages,
        int w_terms, void* stream) {
  const size_t smem = bwd_plan(B, H, stages, w_terms).total;
  if (!geometry_ok(B, T, H, stages, w_terms, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (H + kBwdUnits - 1) / kBwdUnits;
  cudaError_t err = prepare(lstm_bwd_kernel<S>, blocks, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  void* args[] = {&gates, &hcprev, &dys, &dhT, &dcT, &w, &dxp, &dh0, &dc0, &dpre, &bar,
                  &B, &T, &H, &stages, &w_terms};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_bwd_kernel<S>), dim3(blocks), dim3(kThreads),
                                    args, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Hp = padded_h(H);
  lstm_dw_kernel<S><<<dim3(4 * Hp / 64, Hp / 64), kThreads, 0, st>>>(
      static_cast<const float*>(dpre), static_cast<const S*>(hcprev), static_cast<float*>(dw), B, T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xp, h0, c0 and the outputs of the storage type (f32 or bf16), w f32 (of
// `w_terms` bf16 terms: 1 where it is a bf16 weight cast); hbuf (2, B, Hp)
// f32, zero in columns >= H; bar one zeroed unsigned; `units` and `stages` from
// ops/lstm_scan.py::launch_geometry
int emo_lstm_fwd_f32(const void* xp, const void* w, const void* h0, const void* c0, void* ys, void* gates,
                     void* hcprev, void* hT, void* cT, void* hbuf, void* bar, int B, int T, int H, int units,
                     int stages, int w_terms, void* stream) {
  return fwd<float>(xp, w, h0, c0, ys, gates, hcprev, hT, cT, hbuf, bar, B, T, H, units, stages, w_terms,
                    stream);
}

int emo_lstm_fwd_bf16(const void* xp, const void* w, const void* h0, const void* c0, void* ys, void* gates,
                      void* hcprev, void* hT, void* cT, void* hbuf, void* bar, int B, int T, int H, int units,
                      int stages, int w_terms, void* stream) {
  return fwd<__nv_bfloat16>(xp, w, h0, c0, ys, gates, hcprev, hT, cT, hbuf, bar, B, T, H, units, stages,
                            w_terms, stream);
}

// the residuals, dys, dhT, dcT and d xp, dh0, dc0 of the storage type; w
// and dw f32; dpre (T, B, 4 Hp) words (4 bytes each), zero in each gate's
// columns >= H; `stages` from launch_geometry
int emo_lstm_bwd_f32(const void* gates, const void* hcprev, const void* dys, const void* dhT, const void* dcT,
                     const void* w, void* dxp, void* dw, void* dh0, void* dc0, void* dpre, void* bar, int B,
                     int T, int H, int stages, int w_terms, void* stream) {
  return bwd<float>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T, H, stages, w_terms,
                    stream);
}

int emo_lstm_bwd_bf16(const void* gates, const void* hcprev, const void* dys, const void* dhT, const void* dcT,
                      const void* w, void* dxp, void* dw, void* dh0, void* dc0, void* dpre, void* bar, int B,
                      int T, int H, int stages, int w_terms, void* stream) {
  return bwd<__nv_bfloat16>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T, H, stages,
                            w_terms, stream);
}

// shared memory of a block in bytes: kind 0 the forward (`units` 4 or 8),
// 1 the backward (8 units)
int emo_lstm_smem_bytes(int kind, int B, int H, int units, int stages, int w_terms) {
  const SmemPlan p = kind == 0 ? fwd_plan(B, H, units, stages, w_terms) : bwd_plan(B, H, stages, w_terms);
  return static_cast<int>(p.total);
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
