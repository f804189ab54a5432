// splitk.cuh: the ordered second pass of a split contraction, shared by
// int8_matmul.cu and int4_matmul.cu. Each split wrote a float32 partial of
// the whole output into ws; the sum is taken in split order, so the result
// does not depend on the schedule (no atomics).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace splitk {

// out[i] = sum over splits of ws[s][i], in split order
__global__ void reduce(const float* __restrict__ ws, float* __restrict__ out, int splits,
                       size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[static_cast<size_t>(z) * n + i];
    out[i] = s;
  }
}

// ws: splits x n partials, out: n floats
inline void launch(const float* ws, float* out, int splits, size_t n, cudaStream_t st) {
  constexpr int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  reduce<<<blocks, threads, 0, st>>>(ws, out, splits, n);
}

}  // namespace splitk
