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
// (U1 = U + 1), w (J, V) with strides (w_sk, w_sv), one of them 1 (so the
// (V, J) weight of a linear layer is read in place, transposed), bias (V,),
// labels (B, U) int32.  For each cell (t, u):
//   z = tanh(he[b, t] + hd[b, u]);  logits = z . w + bias;
//   lse = logsumexp_v logits;
//   lp_blank[b, t, u] = logits[blank] - lse           (B, T, U1)
//   lp_label[b, t, u] = logits[labels[b, u]] - lse    (B, T, U), u < U only
// A label outside [0, V) selects nothing: its logit counts as 0.
//
// Types: he, hd and w share one type, float32 or bfloat16 (the wrapper casts
// hd and w to he's, as the TPU kernel does); bias is f32.  In bf16, z is
// formed in bf16 (the sum rounded, then the tanh rounded), each product of
// bf16 values is exact in f32 and accumulates in f32, and the lse and both
// outputs are f32: the TPU kernel's arithmetic.
//
// What bounds it on this card: operations.  2 B T U1 J V flops (949 GFLOP
// at the largest L4 training bucket, (18, 399, 129) x (512, 1000): 14.2 ms
// at the f32 peak) against ~24 MB of inputs and outputs.  This first
// version computes in f32 on the CUDA cores (no wgmma).
//
// Design.  The TPU kernel keeps the z tile and an (J, Vc) tile of W in
// VMEM and carries the running max/sum across a sequential V grid axis;
// here one block owns BM consecutive cells (t, u) of one utterance in
// row-major (t, u) order (no padding of U1 to a tile: the ragged end of the
// utterance is masked), builds their z once into shared memory (J x BM
// floats, 136 KB at J = 512 and BM = 64), and loops over V in tiles of 64
// columns; W is streamed through shared memory in slices of 32 rows of a
// tile, never as a whole (J, 64) tile.  BM is 64 where the z tile fits the
// 227 KB a block may use (J <= 819), else 32 (J <= 1551), else 16 (J <=
// 2794): fewer cells a block re-read W more often, but each cell's sums
// run in the same order, so the outputs do not depend on BM.  The running
// max/sum of each cell stays in registers (16 lanes share a cell, as in
// csrc/ctc_head.cu), the ragged last V tile is masked by bounds, and the
// blank and label logits are taken from the tile that holds their column
// by the one thread that computed them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBN = 64;        // vocabulary columns per tile
constexpr int kBK = 32;        // rows of w per streamed slice
constexpr int kThreads = 256;  // 16 x 16 threads, BM / 16 x 4 logits each
constexpr int kLD = kBN + 4;   // padded leading dimension of the w slice, keeps 16 B alignment
constexpr size_t kSmemMax = 232448;  // what one block may use on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// round an f32 value to E's precision and back (identity for f32)
template <typename E>
__device__ __forceinline__ float round_to(float x) {
  if (std::is_same<E, float>::value) return x;
  return __bfloat162float(__float2bfloat16(x));
}

struct WLayout {
  long long sk, sv;
  __device__ __forceinline__ size_t at(int k, int v) const {
    return static_cast<size_t>(k) * sk + static_cast<size_t>(v) * sv;
  }
};

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// shared memory of a block of BM cells: the z tile (J, BM + 4), the w slice
// (kBK, kLD), the blank and label logits and the label columns
size_t smem_bytes(int J, int BM) {
  return (static_cast<size_t>(J) * (BM + 4) + static_cast<size_t>(kBK) * kLD + 2 * BM) * sizeof(float) +
         BM * sizeof(int);
}

// cells a block takes at joint width J: 64, 32 or 16, the most whose z tile
// fits; 0 when not even 16 fit
int cells_per_block(int J) {
  for (int bm = 64; bm >= 16; bm /= 2)
    if (smem_bytes(J, bm) <= kSmemMax) return bm;
  return 0;
}

template <typename E, int BM>
__global__ void __launch_bounds__(kThreads)
rnnt_joint_kernel(const E* __restrict__ he, const E* __restrict__ hd,
                  const E* __restrict__ w, const float* __restrict__ bias,
                  const int* __restrict__ labels, float* __restrict__ lpb,
                  float* __restrict__ lpl, int T, int U1, int J, int V, int blank, WLayout wl) {
  constexpr int RM = BM / 16;   // cells a thread takes
  constexpr int LDZ = BM + 4;   // padded leading dimension of the z tile
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                                      // (J, LDZ): zs[k][cell]
  float* ws = zs + static_cast<size_t>(J) * LDZ;         // (kBK, kLD): a slice of w
  float* blank_s = ws + kBK * kLD;                       // (BM): each cell's blank logit
  float* label_s = blank_s + BM;                         // (BM): and its label logit
  int* lab_s = reinterpret_cast<int*>(label_s + BM);     // (BM): its label column
  const int b = blockIdx.y;
  const int U = U1 - 1;
  const long long M = static_cast<long long>(T) * U1;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  // z of the block's cells; cells past the utterance's end are 0 and never written out
  for (int i = threadIdx.x; i < BM * J; i += kThreads) {
    const int r = i / J, k = i % J;
    const long long m = m0 + r;
    float z = 0.f;
    if (m < M) {
      const int t = static_cast<int>(m / U1), u = static_cast<int>(m % U1);
      z = round_to<E>(tanhf(round_to<E>(to_float(he[(static_cast<size_t>(b) * T + t) * J + k]) +
                                        to_float(hd[(static_cast<size_t>(b) * U1 + u) * J + k]))));
    }
    zs[k * LDZ + r] = z;
  }
  if (threadIdx.x < BM) {
    const long long m = m0 + threadIdx.x;
    int lab = -1;  // no label: u = U, or past the end
    if (m < M) {
      const int u = static_cast<int>(m % U1);
      if (u < U) {
        lab = labels[static_cast<size_t>(b) * U + u];
        if (lab < 0 || lab >= V) lab = -1;  // selects nothing: logit 0
      }
    }
    lab_s[threadIdx.x] = lab;
    blank_s[threadIdx.x] = 0.f;
    label_s[threadIdx.x] = 0.f;
  }

  float mx[RM], l[RM], acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    mx[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int v0 = 0; v0 < V; v0 += kBN) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < J; k0 += kBK) {
      __syncthreads();  // the previous slice is consumed (and zs, lab_s are written)
      for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
        int kk, c;
        if (wl.sv == 1) {  // neighbouring threads along the axis whose stride is 1
          kk = i / kBN;
          c = i % kBN;
        } else {
          c = i / kBK;
          kk = i % kBK;
        }
        const int k = k0 + kk, v = v0 + c;
        ws[kk * kLD + c] = (k < J && v < V) ? to_float(w[wl.at(k, v)]) : 0.f;
      }
      __syncthreads();
      const int kn = min(kBK, J - k0);
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float* zr = zs + (k0 + kk) * LDZ + ty * RM;
        float a[RM];
        if constexpr (RM == 4) {
          const float4 a4 = *reinterpret_cast<const float4*>(zr);
          a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
        } else if constexpr (RM == 2) {
          const float2 a2 = *reinterpret_cast<const float2*>(zr);
          a[0] = a2.x; a[1] = a2.y;
        } else {
          a[0] = zr[0];
        }
        const float4 b4 = *reinterpret_cast<const float4*>(ws + kk * kLD + tx * 4);
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    // bias, the streaming logsumexp over the tile's valid columns, and the
    // blank and label logits where this thread computed their column
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx * 4 + j;
      bj[j] = v < V ? bias[v] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const int lab = lab_s[r];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = v0 + tx * 4 + j;
        acc[i][j] += bj[j];
        if (v < V) tmax = fmaxf(tmax, acc[i][j]);
        if (v == blank) blank_s[r] = acc[i][j];
        if (v == lab) label_s[r] = acc[i][j];
      }
      const float m_new = fmaxf(mx[i], row_max16(tmax));  // finite: column v0 is valid
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v0 + tx * 4 + j < V) sum += expf(acc[i][j] - m_new);
      l[i] = l[i] * expf(mx[i] - m_new) + row_sum16(sum);
      mx[i] = m_new;
    }
  }
  __syncthreads();  // blank_s, label_s are written
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const long long m = m0 + r;
      if (m >= M) continue;
      const int t = static_cast<int>(m / U1), u = static_cast<int>(m % U1);
      const float lse = mx[i] + logf(l[i]);
      lpb[(static_cast<size_t>(b) * T + t) * U1 + u] = blank_s[r] - lse;
      if (u < U) lpl[(static_cast<size_t>(b) * T + t) * U + u] = label_s[r] - lse;
    }
  }
}

template <typename E, int BM>
int launch_bm(const void* he, const void* hd, const void* w, const void* bias, const void* labels,
              void* lpb, void* lpl, int B, int T, int U1, int J, int V, int blank, long long w_sk,
              long long w_sv, void* stream) {
  const size_t smem = smem_bytes(J, BM);
  cudaError_t err = cudaFuncSetAttribute(rnnt_joint_kernel<E, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cells = static_cast<long long>(T) * U1;
  const dim3 grid(static_cast<unsigned>((cells + BM - 1) / BM), B);
  rnnt_joint_kernel<E, BM><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(he), static_cast<const E*>(hd), static_cast<const E*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels), static_cast<float*>(lpb),
      static_cast<float*>(lpl), T, U1, J, V, blank, WLayout{w_sk, w_sv});
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch(const void* he, const void* hd, const void* w, const void* bias, const void* labels,
           void* lpb, void* lpl, int B, int T, int U1, int J, int V, int blank, long long w_sk,
           long long w_sv, void* stream) {
  const int bm = J >= 1 ? cells_per_block(J) : 0;
  if (B < 1 || T < 1 || U1 < 1 || bm == 0 || V < 1 || blank < 0 || blank >= V ||
      (w_sk != 1 && w_sv != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 64)
    return launch_bm<E, 64>(he, hd, w, bias, labels, lpb, lpl, B, T, U1, J, V, blank, w_sk, w_sv, stream);
  if (bm == 32)
    return launch_bm<E, 32>(he, hd, w, bias, labels, lpb, lpl, B, T, U1, J, V, blank, w_sk, w_sv, stream);
  return launch_bm<E, 16>(he, hd, w, bias, labels, lpb, lpl, B, T, U1, J, V, blank, w_sk, w_sv, stream);
}

}  // namespace

extern "C" {

// cells a block takes at joint width J (64, 32 or 16), 0 if the card's
// shared memory holds no z tile that wide
int emo_rnnt_joint_cells(int J) { return J >= 1 ? cells_per_block(J) : 0; }

// he, hd and w of one type (f32 or bf16), bias f32; lpb and lpl f32
int emo_rnnt_joint_f32(const void* he, const void* hd, const void* w, const void* bias,
                       const void* labels, void* lpb, void* lpl, int B, int T, int U1, int J,
                       int V, int blank, long long w_sk, long long w_sv, void* stream) {
  return launch<float>(he, hd, w, bias, labels, lpb, lpl, B, T, U1, J, V, blank, w_sk, w_sv,
                       stream);
}

int emo_rnnt_joint_bf16(const void* he, const void* hd, const void* w, const void* bias,
                        const void* labels, void* lpb, void* lpl, int B, int T, int U1, int J,
                        int V, int blank, long long w_sk, long long w_sv, void* stream) {
  return launch<__nv_bfloat16>(he, hd, w, bias, labels, lpb, lpl, B, T, U1, J, V, blank, w_sk,
                               w_sv, stream);
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
