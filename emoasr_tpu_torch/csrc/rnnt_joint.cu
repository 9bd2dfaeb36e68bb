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
// here one block owns 64 consecutive cells (t, u) of one utterance in
// row-major (t, u) order (no padding of U1 to a tile: the ragged end of the
// utterance is masked), builds their z once into shared memory (J x 64
// floats, 136 KB at J = 512), and loops over V in tiles of 64 columns; W is
// streamed through shared memory in slices of 32 rows of a tile, never as a
// whole (J, 64) tile, so J up to `kJMax` fits.  The running max/sum of each
// cell stays in registers (16 lanes share a cell, as in csrc/ctc_head.cu),
// the ragged last V tile is masked by bounds, and the blank and label
// logits are taken from the tile that holds their column by the one thread
// that computed them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;        // cells per block
constexpr int kBN = 64;        // vocabulary columns per tile
constexpr int kBK = 32;        // rows of w per streamed slice
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 logits each
constexpr int kLD = 68;        // padded leading dimension, keeps 16 B alignment
constexpr int kJMax = 768;     // joint width the shared-memory z tile holds

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

size_t smem_bytes(int J) {
  return (static_cast<size_t>(J) * kLD + static_cast<size_t>(kBK) * kLD + 2 * kBM) * sizeof(float) +
         kBM * sizeof(int);
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
rnnt_joint_kernel(const E* __restrict__ he, const E* __restrict__ hd,
                  const E* __restrict__ w, const float* __restrict__ bias,
                  const int* __restrict__ labels, float* __restrict__ lpb,
                  float* __restrict__ lpl, int T, int U1, int J, int V, int blank, WLayout wl) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                                      // (J, kLD): zs[k][cell]
  float* ws = zs + static_cast<size_t>(J) * kLD;         // (kBK, kLD): a slice of w
  float* blank_s = ws + kBK * kLD;                       // (kBM): each cell's blank logit
  float* label_s = blank_s + kBM;                        // (kBM): and its label logit
  int* lab_s = reinterpret_cast<int*>(label_s + kBM);    // (kBM): its label column
  const int b = blockIdx.y;
  const int U = U1 - 1;
  const long long M = static_cast<long long>(T) * U1;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  // z of the block's cells; cells past the utterance's end are 0 and never written out
  for (int i = threadIdx.x; i < kBM * J; i += kThreads) {
    const int r = i / J, k = i % J;
    const long long m = m0 + r;
    float z = 0.f;
    if (m < M) {
      const int t = static_cast<int>(m / U1), u = static_cast<int>(m % U1);
      z = round_to<E>(tanhf(round_to<E>(to_float(he[(static_cast<size_t>(b) * T + t) * J + k]) +
                                        to_float(hd[(static_cast<size_t>(b) * U1 + u) * J + k]))));
    }
    zs[k * kLD + r] = z;
  }
  if (threadIdx.x < kBM) {
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

  float mx[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int v0 = 0; v0 < V; v0 += kBN) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
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
        const float4 a4 = *reinterpret_cast<const float4*>(zs + (k0 + kk) * kLD + ty * 4);
        const float4 b4 = *reinterpret_cast<const float4*>(ws + kk * kLD + tx * 4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
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
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
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
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const long long m = m0 + r;
      if (m >= M) continue;
      const int t = static_cast<int>(m / U1), u = static_cast<int>(m % U1);
      const float lse = mx[i] + logf(l[i]);
      lpb[(static_cast<size_t>(b) * T + t) * U1 + u] = blank_s[r] - lse;
      if (u < U) lpl[(static_cast<size_t>(b) * T + t) * U + u] = label_s[r] - lse;
    }
  }
}

template <typename E>
int launch(const void* he, const void* hd, const void* w, const void* bias, const void* labels,
           void* lpb, void* lpl, int B, int T, int U1, int J, int V, int blank, long long w_sk,
           long long w_sv, void* stream) {
  if (B < 1 || T < 1 || U1 < 1 || J < 1 || J > kJMax || V < 1 || blank < 0 || blank >= V ||
      (w_sk != 1 && w_sv != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(J);
  cudaError_t err = cudaFuncSetAttribute(rnnt_joint_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cells = static_cast<long long>(T) * U1;
  const dim3 grid(static_cast<unsigned>((cells + kBM - 1) / kBM), B);
  rnnt_joint_kernel<E><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(he), static_cast<const E*>(hd), static_cast<const E*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels), static_cast<float*>(lpb),
      static_cast<float*>(lpl), T, U1, J, V, blank, WLayout{w_sk, w_sv});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

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
