// mma_bf16.cuh: hand-written PTX wrappers for warp-level bf16 tensor-core
// products on sm_80+ (used on sm_90a by int8_matmul.cu, int8_matmul_t.cu,
// int4_matmul.cu, fused_update.cu and flash_attention.cu).
//
//  * mma_bf16_16816: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
//    accumulating in place into four f32 registers.
//  * ldsm_x4 / ldsm_x4_t: ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16.
//  * cp_async16: cp.async.cg (16 bytes, L2 only) and cp_async4 (cp.async.ca,
//    4 bytes), each with a zero fill of the bytes past src_bytes;
//    cp_async_commit / cp_async_wait<N>.
//  * pack_bf16x2; split_bf16x2: hi and lo of two floats; s8x4_to_bf16x2 /
//    s8x4_to_bf16x2_pairs: four int8 codes as two bf16x2 words, (c0, c2)
//    (c1, c3) or (c0, c1) (c2, c3);
//    nibbles_to_bf16x2: the two INT4 codes of one byte as u' = nibble - 8.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 words: a0 = (row g, k 2t..2t+1), a1 = (row
//     g + 8, k 2t..), a2 = (row g, k 2t + 8..), a3 = (row g + 8, k 2t + 8..);
//   B (16 x 8, column major), 2 words: b0 = (k 2t..2t+1, col g), b1 = (k
//     2t + 8.., col g);
//   C (16 x 8), 4 floats: c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row
//     g + 8, cols 2t, 2t+1).
// In every bf16x2 word the lower half holds the smaller index.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// d += a * b (f32 accumulators)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// r[i] receives matrix i (lane: row g, elements 2t, 2t+1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// The same, transposed: r[i] receives (rows 2t, 2t+1, element g) of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// 16 bytes global -> shared, asynchronously; bytes past src_bytes (0 or 16)
// are written as zeros and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared (cp.async.ca), zero fill past src_bytes (0 or 4)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// bf16x2 word: lo in the lower half, both rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a, b) as two bf16x2 words, hi = bf16(a, b) and lo = bf16 of the
// residuals (a - hi, b - hi), which are exact in f32: hi + lo carries 16
// significant bits, and a product with an exact bf16 operand taken as two
// mma (hi, lo) into one f32 sum is within ~2^-16 of the f32 product.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  lo = pack_bf16x2(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xFFFF0000u));
}

// Four int8 codes c0..c3 (byte 0 lowest) as exact floats. Byte ^ 0x80 is
// the code + 128 as an unsigned byte; placed in the mantissa of 2^23 it is
// the float 2^23 + code + 128, from which 2^23 + 128 is subtracted exactly.
// An integer in [-128, 127] has at most 8 significant bits, so its float's
// upper half is its exact bf16.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  const float magic = 8388736.f;  // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - magic;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - magic;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - magic;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - magic;
}

// ... as bf16x2 words (c0, c2) and (c1, c3)
__device__ __forceinline__ void s8x4_to_bf16x2(uint32_t w, uint32_t& even, uint32_t& odd) {
  float f[4];
  s8x4_to_f32(w, f);
  even = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  odd = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

// ... as bf16x2 words (c0, c1) and (c2, c3)
__device__ __forceinline__ void s8x4_to_bf16x2_pairs(uint32_t w, uint32_t& lo, uint32_t& hi) {
  float f[4];
  s8x4_to_f32(w, f);
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// The two nibbles of byte i of w (low nibble first) as a bf16x2 word of
// u' = nibble - 8, exactly; w4 = w >> 4. A byte permute and a mask put
// 128 + nibble into each bf16's mantissa, one bf16x2 subtraction of 136
// leaves u'.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t w, uint32_t w4, int i) {
  const uint32_t sel = static_cast<uint32_t>(i) | (static_cast<uint32_t>(4 + i) << 8);
  const uint32_t y = (__byte_perm(w, w4, sel) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&y);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma_bf16
