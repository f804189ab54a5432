// sr_requant: W' = SR_quant(deq(W) + U) for one INT8 weight
//
// Replaces the Pallas TPU kernel src/repro/kernels/sr_requant.py::sr_requant
// (the pl.pallas_call at sr_requant.py:53): dequantize the codes with their
// per-(row, 256 columns) scale, add the update, recompute each group's
// absmax scale, and round stochastically with the uniforms u01 passed in
// (as the TPU kernel takes them):
//     w = q * s + U;  s' = max(absmax_group(w) / 127, 1e-12);
//     q' = clip(floor(w / s' + u), -128, 127).
// The requantization is int8_group.cuh's, the epilogue of fused_update.cu:
// true division and no FMA contraction, so the codes equal those of
// ref.sr_requant_ref on the same inputs, bit for bit.
//
// What bounds it on an H100: bytes. Each weight element moves 1 byte of
// code in and out, 4 bytes of f32 update and 4 of f32 uniforms (18 bytes in
// all); a 2048 x 2048 weight is 42 MB, 0.0125 ms at 3.35 TB/s. The design
// streams each byte once: a warp owns one row's 256-column group, each lane
// 8 consecutive values read as one 8-byte and four 16-byte loads, and a
// block of 8 warps covers 32 rows of one group (4 rows a warp), so the
// loads of four rows are in flight together.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_group.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = (THREADS / 32) * ROWS_PER_WARP;  // rows per block

__global__ void __launch_bounds__(THREADS)
sr_requant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  const float* __restrict__ upd, const float* __restrict__ u01,
                  int8_t* __restrict__ q_out, float* __restrict__ scale_out, int R, int C) {
  const int grp = blockIdx.x;
  const int G = C / int8_group::GROUP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int row = blockIdx.y * ROWS + warp * ROWS_PER_WARP + i;
    if (row >= R) return;                           // warp-uniform
    const size_t off = static_cast<size_t>(row) * C + grp * int8_group::GROUP + lane * 8;
    const float s_old = scale[static_cast<size_t>(row) * G + grp];
    const int2 raw = __ldg(reinterpret_cast<const int2*>(q + off));
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(upd + off));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(upd + off + 4));
    const float4 u0 = __ldg(reinterpret_cast<const float4*>(u01 + off));
    const float4 u1 = __ldg(reinterpret_cast<const float4*>(u01 + off + 4));
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    float w[8];
    int8_group::unpack(raw, w);
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = __fadd_rn(__fmul_rn(w[j], s_old), a[j]);
    int2 codes;
    const float s_new = int8_group::sr_requant(w, u, &codes);
    *reinterpret_cast<int2*>(q_out + off) = codes;
    if (lane == 0) scale_out[static_cast<size_t>(row) * G + grp] = s_new;
  }
}

}  // namespace

// q, q_out (R, C) int8; scale, scale_out (R, C/256) f32; upd, u01 (R, C) f32;
// C % 256 == 0; q, upd and u01 16-byte aligned. Returns cudaGetLastError()
// after the launch.
extern "C" int qgl_sr_requant(const void* q, const void* scale, const void* upd, const void* u01,
                              void* q_out, void* scale_out, int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const dim3 grid(C / int8_group::GROUP, (R + ROWS - 1) / ROWS);
  sr_requant_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<const float*>(upd), static_cast<const float*>(u01),
      static_cast<int8_t*>(q_out), static_cast<float*>(scale_out), R, C);
  return static_cast<int>(cudaGetLastError());
}
