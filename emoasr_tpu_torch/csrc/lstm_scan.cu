// The whole LSTM recurrence in one launch for Hopper (sm_90a): forward
// from the input projections, and the exact reverse recurrence backward.
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
// The forward upcasts xp per step and rounds what it stores; its carry is
// never rounded (h_{t-1} for the next step comes from an f32 ping-pong
// buffer, not from ys).  The backward reads dys, d h_T, d c_T and the
// rounded residuals in the storage type and recomputes from those, carries
// d h and d c in f32, sums d w in f32 from the unrounded d pre (an f32
// ping-pong buffer shares d pre_t between the blocks), and rounds d xp,
// d h0 and d c0 to the storage type.
//
// What bounds it on this card: neither bytes nor operations but the T
// dependent steps.  At the prediction network's largest training shape
// (B 18, T 129, H 512) the forward does 4.9 GFLOP (0.073 ms at the f32
// peak) and moves ~56 MB (0.017 ms); the TPU kernel keeps w_hh (4 MB) in
// VMEM for the whole recurrence.  No SM holds 4 MB, so:
//
// Design.  One cooperative launch of ceil(H / U) blocks, all co-resident
// (the launcher checks it and refuses otherwise), each owning U hidden units
// j.  A grid-wide barrier (an arrival counter with acquire loads) separates
// the time steps, one barrier a step.
//  * forward: a warp owns one unit j and a share of the batch rows; its
//    lanes hold the four rows of w_hh for unit j (4H values) in registers,
//    so w_hh is read from memory once per launch.  Each step the block
//    stages h_{t-1} (ys[:, t-1], written by every block before the
//    barrier; read past L1) in shared memory, batch tile by batch tile; a
//    warp reduces the four gate dot products, and lane 0 applies the cell
//    update, keeps c (shared memory, one owner per (b, j)) and writes h
//    (f32 buffer), ys, the gates and [h, c]_{t-1}.
//  * backward: d h_{t-1}[:, j] needs d pre_t of every unit, so a warp
//    holds the column w_hh[:, j] (4H values) instead.  Each step lane 0 of
//    the owner first turns the carried d h, d c of its (b, j) into the four
//    d pre, writes them to d xp; after the barrier the block stages d pre_t
//    of every unit in shared memory, and each warp computes d h_{t-1}[b, j]
//    = d pre_t[b] . w_hh[:, j] and adds d pre_t[b] h_{t-1}[b, j] into its
//    register share of d w[:, j]; at the end the warps of a unit add their
//    shares in warp order.
// Above H = 512 a gate row (forward) or column (backward) of 4H values no
// longer fits a warp's registers beside the rest: every block then takes
// kWarps units (one warp each), keeps their rows (forward, 4 x Hp floats a
// unit) or columns (backward, 4Hp floats a unit) of w_hh in shared memory,
// 128 KB at H = 1024, and reads them from there each step; the backward's
// warp, the only one of its unit, writes its d w_hh column itself.  The
// grid, ceil(H / 8) blocks of one per SM, must still be co-resident: H <=
// 1024 (8 x 132 SMs would allow 1056; the kernels are instanced for 1024).
// The barrier's latency (one to a few microseconds) times T is the
// expected limit, not the arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRegH = 512;   // the widest H whose w_hh rows/columns stay in registers
constexpr int kMaxH = 1024;     // the widest H of the shared-memory instances
constexpr size_t kSmemBudget = 200 * 1024;  // registers variant: the batch tile's room
constexpr size_t kSmemMax = 232448;         // what one block may use on sm_90

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename S> __device__ __forceinline__ S from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

constexpr long long kBarrierTimeout = 20000000000LL;  // clock cycles, some 10 s

// every block of the grid arrives, then all wait until `target` arrivals
// (k barriers so far times the grid size); the grid is co-resident.  A wait
// past kBarrierTimeout traps (a launch failure the wrapper raises) rather
// than hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const long long start = clock64();
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
      if (clock64() - start > kBarrierTimeout) __trap();
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// ------------------------------------------------------------------ forward

// NC float4 chunks of a length-H row per lane (k = 4 lane + 128 c + q);
// hbuf (2, B, H) f32: h_t goes to slot t % 2.  WS: the rows of w_hh sit in
// shared memory (U = kWarps units, one warp each) instead of registers.
template <int NC, typename S, bool WS>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const S* __restrict__ xp, const float* __restrict__ w,
                const S* __restrict__ h0, const S* __restrict__ c0, S* __restrict__ ys,
                S* __restrict__ gates, S* __restrict__ hcprev, S* __restrict__ hT,
                S* __restrict__ cT, float* hbuf, unsigned* bar, int B, int T, int H, int U,
                int BT) {
  constexpr int Hp = 128 * NC;
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;                                   // WS: (U, 4, Hp) rows g H + j of w
  float* hs = smem + (WS ? static_cast<size_t>(U) * 4 * Hp : 0);  // (BT, Hp): h_{t-1} of a batch tile
  float* cs = hs + static_cast<size_t>(BT) * Hp;      // (B, U): c of the block's units
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = warp % U, j = blockIdx.x * U + u;
  const int bstep = kWarps / U, bfirst = warp / U;
  const bool live = j < H;  // warp-uniform
  const int H4 = 4 * H;

  float4 wr[4][WS ? 1 : NC];  // rows g H + j of w, this lane's chunks
  if constexpr (WS) {
    for (int i = threadIdx.x; i < U * 4 * Hp; i += kThreads) {
      const int uu = i / (4 * Hp), g = (i / Hp) % 4, k = i % Hp;
      const int jj = blockIdx.x * U + uu;
      wsm[i] = (jj < H && k < H) ? w[static_cast<size_t>(g * H + jj) * H + k] : 0.f;
    }  // the batch tile's barrier below orders these stores before any read
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float e[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 4 * lane + 128 * c + q;
          e[q] = (live && k < H) ? w[static_cast<size_t>(g * H + j) * H + k] : 0.f;
        }
        wr[g][c] = make_float4(e[0], e[1], e[2], e[3]);
      }
  }
  // (b, j) belongs to lane 0 of the warp with bfirst = b % bstep: only that
  // thread reads and writes cs[b][u]
  if (live && lane == 0)
    for (int b = bfirst; b < B; b += bstep) cs[b * U + u] = to_float(c0[static_cast<size_t>(b) * H + j]);

  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < nb * Hp; i += kThreads) {
        const int r = i / Hp, k = i % Hp;
        float v = 0.f;
        if (k < H)
          v = t == 0 ? to_float(h0[static_cast<size_t>(b0 + r) * H + k])
                     : __ldcg(hbuf + (static_cast<size_t>((t - 1) & 1) * B + b0 + r) * H + k);
        hs[i] = v;
      }
      __syncthreads();
      if (!live) continue;  // no barrier below: the whole warp skips alike
      for (int b = b0 + bfirst; b < b0 + nb; b += bstep) {
        const float4* hrow = reinterpret_cast<const float4*>(hs + static_cast<size_t>(b - b0) * Hp);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 hv = hrow[lane + 32 * c];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float4 wv;
            if constexpr (WS)
              wv = reinterpret_cast<const float4*>(wsm + (static_cast<size_t>(u) * 4 + g) * Hp)[lane + 32 * c];
            else
              wv = wr[g][c];
            acc[g] = dot4(wv, hv, acc[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = warp_sum(acc[g]);
        if (lane == 0) {
          const size_t row = static_cast<size_t>(b) * T + t;
          const S* x = xp + row * H4;
          const float gi = sigmoidf_(acc[0] + to_float(x[j]));
          const float gf = sigmoidf_(acc[1] + to_float(x[H + j]));
          const float gg = tanhf(acc[2] + to_float(x[2 * H + j]));
          const float go = sigmoidf_(acc[3] + to_float(x[3 * H + j]));
          const float cp = cs[b * U + u];
          const float hp = hs[static_cast<size_t>(b - b0) * Hp + j];
          const float cn = gf * cp + gi * gg;
          const float hn = go * tanhf(cn);
          cs[b * U + u] = cn;
          hbuf[(static_cast<size_t>(t & 1) * B + b) * H + j] = hn;
          ys[row * H + j] = from_float<S>(hn);
          S* gr = gates + (static_cast<size_t>(t) * B + b) * H4;
          gr[j] = from_float<S>(gi);
          gr[H + j] = from_float<S>(gf);
          gr[2 * H + j] = from_float<S>(gg);
          gr[3 * H + j] = from_float<S>(go);
          S* hc = hcprev + (static_cast<size_t>(t) * B + b) * 2 * H;
          hc[j] = from_float<S>(hp);
          hc[H + j] = from_float<S>(cp);
          if (t == T - 1) {
            hT[static_cast<size_t>(b) * H + j] = from_float<S>(hn);
            cT[static_cast<size_t>(b) * H + j] = from_float<S>(cn);
          }
        }
      }
    }
    if (t + 1 < T) grid_sync(bar, static_cast<unsigned>(t + 1) * gridDim.x);
  }
}

// ------------------------------------------------------------------ backward

// NG float4 chunks of a length-4H column per lane (r = 4 lane + 128 c + q);
// dpre (2, B, 4H) f32: d pre_t goes to slot t % 2.  WS: the columns of w_hh
// sit in shared memory (U = kWarps units, one warp each, so that a warp's
// share of d w_hh[:, j] is the whole of it) instead of registers.
template <int NG, typename S, bool WS>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const S* __restrict__ gates, const S* __restrict__ hcprev,
                const S* __restrict__ dys, const S* __restrict__ dhT,
                const S* __restrict__ dcT, const float* __restrict__ w, S* __restrict__ dxp,
                float* __restrict__ dw, S* __restrict__ dh0, S* __restrict__ dc0, float* dpre,
                unsigned* bar, int B, int T, int H, int U, int BT) {
  constexpr int Gp = 128 * NG;
  extern __shared__ __align__(16) float smem[];
  const int rows = WS ? BT : max(BT, kWarps);
  float* wcs = smem;                                   // WS: (U, Gp) columns j of w
  float* ds = smem + (WS ? static_cast<size_t>(U) * Gp : 0);  // (BT, Gp): d pre_t of a batch tile
  float* dhs = ds + static_cast<size_t>(rows) * Gp;    // (B, U): carried d h
  float* dcs = dhs + static_cast<size_t>(B) * U;       // (B, U): carried d c
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = warp % U, j = blockIdx.x * U + u;
  const int bstep = kWarps / U, bfirst = warp / U;
  const bool live = j < H;
  const int H4 = 4 * H;

  float4 wc[WS ? 1 : NG], acc[NG];  // column j of w, and this warp's share of d w[:, j]
  if constexpr (WS) {
    for (int i = threadIdx.x; i < U * Gp; i += kThreads) {
      const int r = i / U, uu = i % U;  // neighbouring threads read neighbouring columns
      const int jj = blockIdx.x * U + uu;
      wcs[static_cast<size_t>(uu) * Gp + r] = (jj < H && r < H4) ? w[static_cast<size_t>(r) * H + jj] : 0.f;
    }  // the grid barrier below orders these stores before any read
  }
#pragma unroll
  for (int c = 0; c < NG; ++c) {
    if constexpr (!WS) {
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * lane + 128 * c + q;
        e[q] = (live && r < H4) ? w[static_cast<size_t>(r) * H + j] : 0.f;
      }
      wc[c] = make_float4(e[0], e[1], e[2], e[3]);
    }
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (live && lane == 0)
    for (int b = bfirst; b < B; b += bstep) {
      dhs[b * U + u] = to_float(dhT[static_cast<size_t>(b) * H + j]);
      dcs[b * U + u] = to_float(dcT[static_cast<size_t>(b) * H + j]);
    }

  for (int t = T - 1; t >= 0; --t) {
    // the cell's backward for the (b, j) this thread owns: d pre_t
    if (live && lane == 0)
      for (int b = bfirst; b < B; b += bstep) {
        const S* gr = gates + (static_cast<size_t>(t) * B + b) * H4;
        const float gi = to_float(gr[j]), gf = to_float(gr[H + j]);
        const float gg = to_float(gr[2 * H + j]), go = to_float(gr[3 * H + j]);
        const float cp = to_float(hcprev[(static_cast<size_t>(t) * B + b) * 2 * H + H + j]);
        const float tc = tanhf(gf * cp + gi * gg);
        const float dh = to_float(dys[(static_cast<size_t>(b) * T + t) * H + j]) + dhs[b * U + u];
        const float dc = dcs[b * U + u] + dh * go * (1.f - tc * tc);
        const float dg[4] = {dc * gg * gi * (1.f - gi), dc * cp * gf * (1.f - gf),
                             dc * gi * (1.f - gg * gg), dh * tc * go * (1.f - go)};
        S* d = dxp + (static_cast<size_t>(b) * T + t) * H4;
        float* dp = dpre + (static_cast<size_t>(t & 1) * B + b) * H4;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          d[g * H + j] = from_float<S>(dg[g]);
          dp[g * H + j] = dg[g];
        }
        dcs[b * U + u] = dc * gf;
      }
    grid_sync(bar, static_cast<unsigned>(T - t) * gridDim.x);
    // d h_{t-1}[b, j] = d pre_t[b] . w[:, j];  d w[:, j] += d pre_t[b] h_{t-1}[b, j]
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      __syncthreads();
      for (int i = threadIdx.x; i < nb * Gp; i += kThreads) {
        const int r = i / Gp, k = i % Gp;
        ds[i] = k < H4 ? __ldcg(dpre + (static_cast<size_t>(t & 1) * B + b0 + r) * H4 + k) : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      for (int b = b0 + bfirst; b < b0 + nb; b += bstep) {
        const float hp = to_float(hcprev[(static_cast<size_t>(t) * B + b) * 2 * H + j]);
        const float4* drow = reinterpret_cast<const float4*>(ds + static_cast<size_t>(b - b0) * Gp);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NG; ++c) {
          const float4 d = drow[lane + 32 * c];
          float4 wv;
          if constexpr (WS)
            wv = reinterpret_cast<const float4*>(wcs + static_cast<size_t>(u) * Gp)[lane + 32 * c];
          else
            wv = wc[c];
          dot = dot4(d, wv, dot);
          acc[c].x = fmaf(d.x, hp, acc[c].x);
          acc[c].y = fmaf(d.y, hp, acc[c].y);
          acc[c].z = fmaf(d.z, hp, acc[c].z);
          acc[c].w = fmaf(d.w, hp, acc[c].w);
        }
        dot = warp_sum(dot);
        if (lane == 0) dhs[b * U + u] = dot;
      }
    }
  }
  if (live && lane == 0)
    for (int b = bfirst; b < B; b += bstep) {
      dh0[static_cast<size_t>(b) * H + j] = from_float<S>(dhs[b * U + u]);
      dc0[static_cast<size_t>(b) * H + j] = from_float<S>(dcs[b * U + u]);
    }
  if constexpr (WS) {  // one warp a unit: its share is d w[:, j]
    if (live) {
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        const float e[4] = {acc[c].x, acc[c].y, acc[c].z, acc[c].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 4 * lane + 128 * c + q;
          if (r < H4) dw[static_cast<size_t>(r) * H + j] = e[q];
        }
      }
    }
    return;
  }
  // d w[:, j]: the bstep warps of unit u add their shares in warp order
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(ds);
#pragma unroll
  for (int c = 0; c < NG; ++c) part[static_cast<size_t>(warp) * (Gp / 4) + lane + 32 * c] = acc[c];
  __syncthreads();
  if (live && bfirst == 0) {
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      float4 s = part[static_cast<size_t>(u) * (Gp / 4) + lane + 32 * c];
      for (int k = 1; k < bstep; ++k) {
        const float4 p = part[static_cast<size_t>(u + k * U) * (Gp / 4) + lane + 32 * c];
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
      const float e[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * lane + 128 * c + q;
        if (r < H4) dw[static_cast<size_t>(r) * H + j] = e[q];
      }
    }
  }
}

// ------------------------------------------------------------------ launch

// batch rows staged per tile: the whole batch if it fits `budget` beside
// `fixed_bytes`, else a multiple of `align` (so that the warps' batch shares
// stay aligned across tiles)
int batch_tile(int B, int row_floats, size_t fixed_bytes, size_t budget, int align) {
  const size_t room = budget - fixed_bytes;
  const int fit = static_cast<int>(room / (static_cast<size_t>(row_floats) * sizeof(float)));
  if (fit >= B) return B;
  return (fit / align) * align;
}

// units per block: the fewest, from u_min (most blocks), whose grid is
// co-resident; `unit_floats` of shared memory a unit beside the batch tile
template <typename K>
cudaError_t plan(K kernel, int H, int B, int rows_floats, int unit_floats, int u_min, int& U,
                 int& nblocks, size_t& smem) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  for (U = u_min; U <= kWarps; U *= 2) {
    smem = (static_cast<size_t>(rows_floats) + static_cast<size_t>(U) * unit_floats) * sizeof(float) +
           2 * static_cast<size_t>(B) * U * sizeof(float);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    nblocks = (H + U - 1) / U;
    if (nblocks <= per_sm * sms) return cudaSuccess;
  }
  return cudaErrorCooperativeLaunchTooLarge;  // the grid cannot be co-resident
}

template <int NC, typename S, bool WS>
cudaError_t launch_fwd(const void* xp, const void* w, const void* h0, const void* c0, void* ys,
                       void* gates, void* hcprev, void* hT, void* cT, void* hbuf, void* bar,
                       int B, int T, int H, cudaStream_t stream) {
  constexpr int Hp = 128 * NC;
  const int unit = WS ? 4 * Hp : 0;  // shared memory of a unit's rows of w
  const size_t fixed = (static_cast<size_t>(kWarps) * unit + 2 * static_cast<size_t>(B) * kWarps) * sizeof(float);
  int BT = batch_tile(B, Hp, fixed, WS ? kSmemMax : kSmemBudget, WS ? 1 : kWarps);
  if (BT < 1) return cudaErrorInvalidValue;
  int U = 0, nblocks = 0;
  size_t smem = 0;
  cudaError_t err = plan(lstm_fwd_kernel<NC, S, WS>, H, B, BT * Hp, unit, WS ? kWarps : 1, U, nblocks, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&xp, &w, &h0, &c0, &ys, &gates, &hcprev, &hT, &cT, &hbuf, &bar,
                  &B, &T, &H, &U, &BT};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_fwd_kernel<NC, S, WS>),
                                     dim3(nblocks), dim3(kThreads), args, smem, stream);
}

template <int NG, typename S, bool WS>
cudaError_t launch_bwd(const void* gates, const void* hcprev, const void* dys, const void* dhT,
                       const void* dcT, const void* w, void* dxp, void* dw, void* dh0, void* dc0,
                       void* dpre, void* bar, int B, int T, int H, cudaStream_t stream) {
  constexpr int Gp = 128 * NG;
  const int unit = WS ? Gp : 0;  // shared memory of a unit's column of w
  const size_t fixed = (static_cast<size_t>(kWarps) * unit + 2 * static_cast<size_t>(B) * kWarps) * sizeof(float);
  int BT = batch_tile(B, Gp, fixed, WS ? kSmemMax : kSmemBudget, WS ? 1 : kWarps);
  if (BT < 1) return cudaErrorInvalidValue;
  int U = 0, nblocks = 0;
  size_t smem = 0;
  const int rows = WS ? BT : (BT > kWarps ? BT : kWarps);
  cudaError_t err = plan(lstm_bwd_kernel<NG, S, WS>, H, B, rows * Gp, unit, WS ? kWarps : 1, U, nblocks, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&gates, &hcprev, &dys, &dhT, &dcT, &w, &dxp, &dw, &dh0, &dc0, &dpre, &bar,
                  &B, &T, &H, &U, &BT};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_bwd_kernel<NG, S, WS>),
                                     dim3(nblocks), dim3(kThreads), args, smem, stream);
}

// the kernel instance for H (forward: NC chunks of a row of H; backward: NG
// chunks of a column of 4H; w_hh in shared memory above kMaxRegH)
template <typename S>
int fwd(const void* xp, const void* w, const void* h0, const void* c0, void* ys, void* gates,
        void* hcprev, void* hT, void* cT, void* hbuf, void* bar, int B, int T, int H,
        void* stream) {
  if (B < 1 || T < 1 || H < 1 || H > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (H <= 128)
    err = launch_fwd<1, S, false>(xp, w, h0, c0, ys, gates, hcprev, hT, cT, hbuf, bar, B, T, H, s);
  else if (H <= 256)
    err = launch_fwd<2, S, false>(xp, w, h0, c0, ys, gates, hcprev, hT, cT, hbuf, bar, B, T, H, s);
  else if (H <= kMaxRegH)
    err = launch_fwd<4, S, false>(xp, w, h0, c0, ys, gates, hcprev, hT, cT, hbuf, bar, B, T, H, s);
  else
    err = launch_fwd<8, S, true>(xp, w, h0, c0, ys, gates, hcprev, hT, cT, hbuf, bar, B, T, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int bwd(const void* gates, const void* hcprev, const void* dys, const void* dhT, const void* dcT,
        const void* w, void* dxp, void* dw, void* dh0, void* dc0, void* dpre, void* bar, int B,
        int T, int H, void* stream) {
  if (B < 1 || T < 1 || H < 1 || H > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int H4 = 4 * H;
  if (H4 <= 128)
    err = launch_bwd<1, S, false>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T, H, s);
  else if (H4 <= 256)
    err = launch_bwd<2, S, false>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T, H, s);
  else if (H4 <= 512)
    err = launch_bwd<4, S, false>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T, H, s);
  else if (H4 <= 1024)
    err = launch_bwd<8, S, false>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T, H, s);
  else if (H <= kMaxRegH)
    err = launch_bwd<16, S, false>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T, H, s);
  else
    err = launch_bwd<32, S, true>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xp, h0, c0 and the outputs of the storage type (f32 or bf16), w f32;
// hbuf (2, B, H) f32 scratch; bar one zeroed unsigned
int emo_lstm_fwd_f32(const void* xp, const void* w, const void* h0, const void* c0, void* ys,
                     void* gates, void* hcprev, void* hT, void* cT, void* hbuf, void* bar, int B,
                     int T, int H, void* stream) {
  return fwd<float>(xp, w, h0, c0, ys, gates, hcprev, hT, cT, hbuf, bar, B, T, H, stream);
}

int emo_lstm_fwd_bf16(const void* xp, const void* w, const void* h0, const void* c0, void* ys,
                      void* gates, void* hcprev, void* hT, void* cT, void* hbuf, void* bar, int B,
                      int T, int H, void* stream) {
  return fwd<__nv_bfloat16>(xp, w, h0, c0, ys, gates, hcprev, hT, cT, hbuf, bar, B, T, H,
                            stream);
}

// the residuals, dys, dhT, dcT and d xp, dh0, dc0 of the storage type; w
// and dw f32; dpre (2, B, 4H) f32 scratch
int emo_lstm_bwd_f32(const void* gates, const void* hcprev, const void* dys, const void* dhT,
                     const void* dcT, const void* w, void* dxp, void* dw, void* dh0, void* dc0,
                     void* dpre, void* bar, int B, int T, int H, void* stream) {
  return bwd<float>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T, H,
                    stream);
}

int emo_lstm_bwd_bf16(const void* gates, const void* hcprev, const void* dys, const void* dhT,
                      const void* dcT, const void* w, void* dxp, void* dw, void* dh0, void* dc0,
                      void* dpre, void* bar, int B, int T, int H, void* stream) {
  return bwd<__nv_bfloat16>(gates, hcprev, dys, dhT, dcT, w, dxp, dw, dh0, dc0, dpre, bar, B, T,
                            H, stream);
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
