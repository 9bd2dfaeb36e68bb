// Tensor-core building blocks shared by K1 (csrc/ctc_head.cu), K4
// (csrc/attention.cu) and K7 (csrc/rnnt_joint.cu): `cp.async` copies into shared
// memory, `ldmatrix` loads of 8x8 bf16 tiles, and `mma.sync.m16n8k16` with
// bf16 operands and float32 accumulators, the product every Pallas kernel
// of the JAX package computes (bf16 x bf16, summed in f32).
//
// Fragment layouts of m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..),
//     a3 (g+8, 2c+8..);
//   B (16 x 8, k x n): b0 (k 2c..2c+1, n g), b1 (k 2c+8.., n g);
//   C (16 x 8): c0, c1 (g, 2c..2c+1), c2, c3 (g+8, 2c..2c+1).
// So two C tiles side by side are, once rounded, the A fragment of the next
// product (`pack_a`): a result never leaves the registers.
//
// Shared-memory tiles are bf16 rows `ld` elements apart, with ld * 2 an odd
// multiple of 16 bytes, so that the eight rows of one ldmatrix fall on 32
// different banks.
//
// The kernels' build hashes this header with each source (ops/cuda_lib.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace emo_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !pred (src is then
// not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
// 4 bytes global -> shared (cached at all levels, the only form that takes
// fewer than 16 bytes): for rows without 16-byte alignment
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment (rows m0.., k k0..) of a row-major tile [m][k]
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld, int m0, int k0, int lane) {
  ldmatrix_x4(a, s + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// A fragment (rows m0.., k k0..) of a tile stored transposed, [k][m]
__device__ __forceinline__ void load_a_trans(uint32_t a[4], const bf16* s, int ld, int m0, int k0,
                                             int lane) {
  ldmatrix_x4_trans(a, s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 + (((lane >> 3) & 1) << 3));
}

// B fragments of two n8 tiles (n n0..n0+15, k k0..k0+15) of a tile stored
// [n][k]: b[0], b[1] for n0.., b[2], b[3] for n0+8..
__device__ __forceinline__ void load_b(uint32_t b[4], const bf16* s, int ld, int n0, int k0, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3));
}

// the same from a tile stored [k][n]
__device__ __forceinline__ void load_b_trans(uint32_t b[4], const bf16* s, int ld, int n0, int k0,
                                             int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + ((lane >> 4) << 3));
}

// the A fragment of k-step kk made of C tiles 2kk and 2kk+1 (rounded)
__device__ __forceinline__ void pack_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// x = t0 + t1 + t2 + r, each t a bf16 value and |r| <= 2^-24 |x| or so:
// the f32 operand split into bf16 terms (the first N of them)
template <int N>
__device__ __forceinline__ void split(float x, float t[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = __bfloat162float(__float2bfloat16_rn(x));
    x -= t[i];
  }
}

// the same for a pair (x, y), each term packed as one bf16x2 register (x in
// the low half): the A or B fragment registers of a split f32 operand
template <int N>
__device__ __forceinline__ void split_pack(float x, float y, uint32_t t[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

}  // namespace emo_mma
