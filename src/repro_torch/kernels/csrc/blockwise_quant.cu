// blockwise_quant: symmetric block-wise INT8 quantization of a 2-D tensor
//
// Replaces the Pallas TPU kernel src/repro/kernels/blockwise_quant.py::
// blockwise_quant (the pl.pallas_call at blockwise_quant.py:37): per row and
// 256-column group, s = max(absmax / 127, 1e-12), q = clip(rint(x / s),
// -128, 127), rounding half to even as jnp.round and torch.round do. The
// group's arithmetic is int8_group.cuh's (a true division, no reciprocal),
// so codes and scales equal those of ref.blockwise_quant_ref and of
// core.quant.quantize_blockwise on the same input, bit for bit.
//
// What bounds it on an H100: bytes, 4 in and 1 out per element (plus a
// scale per 256). A warp owns one row's group, each lane 8 consecutive
// values read as two 16-byte loads; a block of 8 warps covers 32 rows.
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
blockwise_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scale, int R, int C) {
  const int grp = blockIdx.x;
  const int G = C / int8_group::GROUP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int row = blockIdx.y * ROWS + warp * ROWS_PER_WARP + i;
    if (row >= R) return;                           // warp-uniform
    const size_t off = static_cast<size_t>(row) * C + grp * int8_group::GROUP + lane * 8;
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(x + off));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(x + off + 4));
    const float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    int2 codes;
    const float s = int8_group::rn_quant(v, &codes);
    *reinterpret_cast<int2*>(q + off) = codes;
    if (lane == 0) scale[static_cast<size_t>(row) * G + grp] = s;
  }
}

}  // namespace

// x (R, C) f32, 16-byte aligned; q (R, C) int8; scale (R, C/256) f32;
// C % 256 == 0. Returns cudaGetLastError() after the launch.
extern "C" int qgl_blockwise_quant(const void* x, void* q, void* scale, int R, int C,
                                   void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const dim3 grid(C / int8_group::GROUP, (R + ROWS - 1) / ROWS);
  blockwise_quant_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), R, C);
  return static_cast<int>(cudaGetLastError());
}
