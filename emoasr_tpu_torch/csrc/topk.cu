// Exact small-k top-k over the last axis, for Hopper (sm_90a).
//
// Replaces: emoasr_tpu/ops/topk_pallas.py::topk_pallas (Pallas kernel
// `_kernel`), the selection step of the beam searches: the CTC prefix beam's
// (B, V) log-probs once a frame (k = beam width), the attention beam's
// (B, W, V) pre-selection (k = 1.5 W), the ALSD expansion's (B, W, V - 1)
// (k = W) and the W x W pool of wide beams; k <= 32, V up to MAX_V.
//
// Semantics (those of lax.top_k, held bit for bit): values in descending
// order, in the input's dtype, bit-identical to the input's entries; int32
// indices; equal values resolve to the lowest index; a row whose remaining
// entries are all -inf still emits fresh indices in ascending order.  All of
// this follows from selecting by one total order on 64-bit words,
// pack(key, idx) = key << 32 | (2^32 - 1 - idx), where key is the float's
// order-preserving 32-bit image: a larger key wins, then a lower index; no
// two entries of a row share a word.
//
// What bounds it on this card: bytes.  A call reads each row once (V x 4 or
// 2 bytes) and writes k values and indices; at the decode shapes that is
// under 8 MB, some 2 us at 3.35 TB/s.  The selection itself is O(V) compares.
//
// Design: a row is cut into `parts` equal slices, one block of 256 threads
// each; a row's blocks form a thread-block cluster when parts > 1, so that
// a few rows still fill the card (the CTC beam's 18 rows take 4 blocks
// each).  A block reads its slice once, in 16-byte words (a word that
// straddles two slices or two rows is read by both and masked), and keeps
// it in registers as keys: up to WPT words a thread, no shared-memory copy
// of the row.  Then, with no k-serial chain:
//   1. each thread takes the largest word of its slots; each warp sorts its
//      32 thread maxima (bitonic, by shuffles);
//   2. a threshold tau with at least k entries >= tau and few above it:
//      where 8 x k x (keys a thread) fit the candidates' buffer, the
//      largest of the warps' k-th largest thread maxima (at most k threads
//      a warp hold entries >= tau); else the k-th largest of the block's
//      256 thread maxima, found by ranking the warps' sorted k largest
//      against each other (binary searches), which only k threads reach;
//   3. the entries >= tau are compacted into shared memory (a warp scan and
//      one atomic a warp) and each is ranked against the others: rank < k
//      places it in the block's sorted list;
//   4. with parts > 1 each block writes its k words into the cluster's first
//      block (distributed shared memory), and after one cluster barrier that
//      block ranks the parts' sorted lists against each other.
// Two or three block barriers and, split, two cluster barriers a call,
// whatever k.
// Values are rebuilt from the keys (the key map is a bijection on bit
// patterns, and a bf16 key came from an exact widening), so they are the
// input's bits.  The launch needs no dynamic shared memory: nothing to set
// per launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr int kMaxParts = 8;
constexpr int kMaxKeys = 32;                   // keys a thread (the valid mask is 32 bits)
constexpr int kMaxCand = kMaxK * kMaxKeys;     // entries that can pass tau in one block

// order-preserving map float -> uint32 (total order on bit patterns, -inf
// lowest of the non-NaN values) and its inverse
__device__ __forceinline__ uint32_t ordered_key(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t key_bits(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key;
}

__device__ __forceinline__ u64 pack(uint32_t key, int idx) {
  return (static_cast<u64>(key) << 32) | static_cast<u64>(0xFFFFFFFFu - static_cast<uint32_t>(idx));
}

__device__ __forceinline__ int word_index(u64 w) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(w & 0xFFFFFFFFull));
}

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kPerWord = 4;
  __device__ static uint32_t key(const uint4& q, int c) {
    return ordered_key(__uint_as_float(c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w));
  }
  __device__ static uint32_t key_at(const float* p) { return ordered_key(*p); }
  __device__ static float value(uint32_t key) { return __uint_as_float(key_bits(key)); }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 8;
  __device__ static uint32_t key(const uint4& q, int c) {
    const uint32_t half2 = (c >> 1) == 0 ? q.x : (c >> 1) == 1 ? q.y : (c >> 1) == 2 ? q.z : q.w;
    return ordered_key(__uint_as_float((c & 1) ? (half2 & 0xFFFF0000u) : (half2 << 16)));
  }
  __device__ static uint32_t key_at(const __nv_bfloat16* p) {
    return ordered_key(__uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) << 16));
  }
  __device__ static __nv_bfloat16 value(uint32_t key) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(key_bits(key) >> 16));
  }
};

// 32 words across a warp's lanes, sorted descending (bitonic network)
__device__ __forceinline__ u64 warp_sort_desc(u64 v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(0xFFFFFFFFu, v, stride);
      const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
      v = keep_max ? (o > v ? o : v) : (o < v ? o : v);
    }
  }
  return v;
}

// entries of a descending list of n <= 32 words that are larger than w:
// a binary search without branches, so that several interleave
__device__ __forceinline__ int count_greater(const u64* list, u64 w, int n) {
  int pos = 0;
#pragma unroll
  for (int step = 32; step > 0; step >>= 1) {
    const u64 v = list[min(pos + step, n) - 1];
    pos += (pos + step <= n && v > w) ? step : 0;
  }
  return pos;
}

template <typename T>
__device__ __forceinline__ void emit(T* vals, int* idx, size_t at, u64 w) {
  vals[at] = Elem<T>::value(static_cast<uint32_t>(w >> 32));
  idx[at] = word_index(w);
}

// one block: slice `part` of row `row`, split into `parts` slices; WPT
// 16-byte words a thread
template <typename T, int WPT>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const T* __restrict__ x, T* __restrict__ vals, int* __restrict__ idx,
            long long total, int V, int k, int parts, int chunk) {
  constexpr int EPW = Elem<T>::kPerWord;
  constexpr int KPT = WPT * EPW;
  static_assert(KPT <= kMaxKeys, "keys a thread");
  __shared__ u64 warp_top[kWarps][kMaxK];
  __shared__ u64 cand[kMaxCand];
  __shared__ u64 merged[kMaxParts * kMaxK];
  __shared__ u64 tau_s;
  __shared__ int n_cand;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / parts, part = blockIdx.x - row * parts;
  if (parts > 1)  // every block of the cluster runs before the remote stores
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the slice [lo, hi) of the row, in words of the whole tensor
  const int lo = part * chunk, hi = min(V, lo + chunk);
  const long long base = static_cast<long long>(row) * V;
  const long long q0 = (base + lo) / EPW, q1 = (base + hi - 1) / EPW + 1;
  uint32_t keys[KPT];
  uint32_t valid = 0;  // bit j * EPW + c: slot holds an entry of the slice
#pragma unroll
  for (int j = 0; j < WPT; ++j) {
    const long long q = q0 + tid + j * kThreads;
    const long long e0 = q * EPW;  // the word's first element in the tensor
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    const bool in = q < q1;
    const bool whole = in && e0 + EPW <= total;
    if (whole) word = __ldg(reinterpret_cast<const uint4*>(x + e0));
#pragma unroll
    for (int c = 0; c < EPW; ++c) {
      const long long i = e0 + c - base;  // index in the row
      const bool v = in && i >= lo && i < hi;
      keys[j * EPW + c] = whole ? Elem<T>::key(word, c) : (v ? Elem<T>::key_at(x + e0 + c) : 0u);
      valid |= static_cast<uint32_t>(v) << (j * EPW + c);
    }
  }
  const int i0 = static_cast<int>(q0 * EPW - base) + tid * EPW;  // row index of slot (0, 0)
  auto word_of = [&](int slot) -> u64 {
    const int j = slot / EPW, c = slot - j * EPW;
    return ((valid >> slot) & 1u) ? pack(keys[slot], i0 + j * kThreads * EPW + c) : 0ull;
  };

  // 1. thread maxima, sorted within each warp
  u64 best = 0;
#pragma unroll
  for (int s = 0; s < KPT; ++s) {
    const u64 w = word_of(s);
    best = w > best ? w : best;
  }
  const u64 sorted = warp_sort_desc(best, lane);
  u64 tau = 0;
  if (kWarps * k * KPT <= kMaxCand) {
    // 2. (few keys a thread for this k) tau, the largest of the warps' k-th
    // largest thread maxima: at most k threads a warp hold entries >= tau,
    // and their keys fit the candidates' buffer
    const u64 kth = __shfl_sync(0xFFFFFFFFu, sorted, k - 1);  // every lane shuffles
    if (lane == 0) warp_top[warp][0] = kth;
    if (tid == 0) n_cand = 0;
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kWarps; ++b) tau = warp_top[b][0] > tau ? warp_top[b][0] : tau;
  } else {
    if (lane < k) warp_top[warp][lane] = sorted;
    if (tid == 0) { tau_s = 0; n_cand = 0; }
    __syncthreads();
    // 2. tau, the k-th largest thread maximum: at most k threads hold
    // entries >= tau.  A word's own list counts its position (the lists are
    // sorted and no two words are equal), so every list is searched, with
    // no branch
    if (tid < kWarps * k) {
      const int a = tid / k, p = tid - a * k;
      const u64 w = warp_top[a][p];
      int r = 0;
#pragma unroll
      for (int b = 0; b < kWarps; ++b) r += count_greater(warp_top[b], w, k);
      if (w != 0 && r == k - 1) tau_s = w;
    }
    __syncthreads();
    tau = tau_s;
  }

  // 3. compact the entries >= tau (every entry where tau is 0: fewer than
  // k threads hold any), then rank each against the others
  tau = tau > 0 ? tau : 1ull;
  int mine = 0;
#pragma unroll
  for (int s = 0; s < KPT; ++s) mine += word_of(s) >= tau;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += o;
  }
  int at = 0;
  if (lane == 31 && incl > 0) at = atomicAdd(&n_cand, incl);
  at = __shfl_sync(0xFFFFFFFFu, at, 31) + incl - mine;
#pragma unroll
  for (int s = 0; s < KPT; ++s) {
    const u64 w = word_of(s);
    if (w >= tau && at < kMaxCand) cand[at++] = w;  // step 2 bounds them to the buffer
  }
  __syncthreads();
  const int n = min(n_cand, kMaxCand);
  u64* list = merged + part * kMaxK;  // this block's sorted k words (parts > 1)
  if (parts > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    cg::cluster_group cluster = cg::this_cluster();
    list = cluster.map_shared_rank(list, 0);
    if (tid >= n && tid < k) list[tid] = 0;  // a slice with fewer than k entries
  }
  for (int c = tid; c < n; c += kThreads) {
    const u64 w = cand[c];
    int r = 0;
    for (int j = 0; j < n; ++j) r += cand[j] > w;
    if (r < k) {
      if (parts > 1) list[r] = w;
      else emit(vals, idx, static_cast<size_t>(row) * k + r, w);
    }
  }
  if (parts == 1) return;

  // 4. the cluster's first block merges the parts' sorted lists
  cg::this_cluster().sync();
  if (part != 0) return;
  if (tid < parts * k) {
    const int a = tid / k, p = tid - a * k;
    const u64 w = merged[a * kMaxK + p];
    int r = 0;
#pragma unroll
    for (int b = 0; b < kMaxParts; ++b)
      if (b < parts) r += count_greater(merged + b * kMaxK, w, k);
    if (w != 0 && r < k) emit(vals, idx, static_cast<size_t>(row) * k + r, w);
  }
}

template <typename T, int WPT>
int launch_wpt(const void* x, void* vals, void* idx, int rows, int V, int k, int parts, cudaStream_t stream) {
  const int chunk = (V + parts - 1) / parts;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * parts));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(parts);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = parts > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, topk_kernel<T, WPT>, static_cast<const T*>(x), static_cast<T*>(vals), static_cast<int*>(idx),
      static_cast<long long>(rows) * V, V, k, parts, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the 16-byte words of a slice of `chunk` elements that starts anywhere
__host__ __device__ constexpr int slice_words(int chunk, int epw) { return (chunk - 1) / epw + 2; }

template <typename T>
int launch(const void* x, void* vals, void* idx, int rows, int V, int k, int parts, int wpt, void* stream) {
  constexpr int EPW = Elem<T>::kPerWord;
  const int chunk = parts > 0 ? (V + parts - 1) / parts : 0;
  if (rows < 1 || k < 1 || k > kMaxK || k > V || parts < 1 || parts > kMaxParts || wpt < 1 ||
      wpt * EPW > kMaxKeys || slice_words(chunk, EPW) > wpt * kThreads ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wpt) {
    case 1: return launch_wpt<T, 1>(x, vals, idx, rows, V, k, parts, st);
    case 2: return launch_wpt<T, 2>(x, vals, idx, rows, V, k, parts, st);
    case 3: return launch_wpt<T, 3>(x, vals, idx, rows, V, k, parts, st);
    case 4: return launch_wpt<T, 4>(x, vals, idx, rows, V, k, parts, st);
    default: break;
  }
  if constexpr (EPW == 4) {
    switch (wpt) {
      case 5: return launch_wpt<T, 5>(x, vals, idx, rows, V, k, parts, st);
      case 6: return launch_wpt<T, 6>(x, vals, idx, rows, V, k, parts, st);
      case 7: return launch_wpt<T, 7>(x, vals, idx, rows, V, k, parts, st);
      case 8: return launch_wpt<T, 8>(x, vals, idx, rows, V, k, parts, st);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x (rows, V) contiguous, 16-byte aligned; vals (rows, k) in x's dtype, idx
// (rows, k) int32; `parts` blocks a row (a cluster when > 1), `wpt` 16-byte
// words a thread (ops/topk.py::launch_geometry)
int emo_topk_f32(const void* x, void* vals, void* idx, int rows, int V, int k, int parts, int wpt,
                 void* stream) {
  return launch<float>(x, vals, idx, rows, V, k, parts, wpt, stream);
}

int emo_topk_bf16(const void* x, void* vals, void* idx, int rows, int V, int k, int parts, int wpt,
                  void* stream) {
  return launch<__nv_bfloat16>(x, vals, idx, rows, V, k, parts, wpt, stream);
}

const char* emo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
