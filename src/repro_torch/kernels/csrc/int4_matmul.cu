// int4_matmul: out (M, R) f32 = g (M, K) @ deq_int4(P (K, R))
//
// Replaces the Pallas TPU kernel src/repro/kernels/int4_matmul.py::
// int4_matmul (the pl.pallas_call at int4_matmul.py:60): the GaLore
// projection of a full-rank gradient G onto the INT4 projection P, which is
// stored as packed nibbles, two a byte, the low nibble at the even index,
// with an asymmetric scale and zero point per (row, block of R):
//     P[k, r] = ((nibble - 8) - zero[k, r / block]) * scale[k, r / block].
// P never exists in device memory at more than 4 bits and its scales: each
// block unpacks and dequantizes its P tile into shared memory.
//
// Shapes: M and K ragged (every load is masked), R even and a multiple of
// block, ragged against the 64-column tile (columns past R are masked).
//
// What bounds it on an H100: the multiply-adds, 2 * M * K * R (4.3 GFLOP at
// M = K = 2048, R = 512), against ~19 MB of traffic. This first version is a
// plain register-blocked float32 GEMM (64 x 64 output tile, 32-deep K step,
// 4 x 4 outputs a thread) without tensor cores; the small tile keeps the
// grid at 256+ blocks for R = 512 (a 128-wide tile would leave half the
// SMs idle at M = 2048).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const T* __restrict__ g, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale, const float* __restrict__ zero,
                   float* __restrict__ out, int M, int K, int R, int block) {
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int Rh = R / 2;
  const int nb = R / block;

  __shared__ __align__(16) float As[BK][BM + 4];  // g tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];      // P tile, dequantized

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // g (BM x BK): 8 values a thread, consecutive threads along k
#pragma unroll
    for (int t = 0; t < (BM * BK) / THREADS; ++t) {
      const int idx = tid + t * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? to_f32(g[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    // P (BK x BN): 32 rows of 32 packed bytes, 4 bytes (8 values) a thread
    {
      const int kk = tid / 8, b0 = (tid % 8) * 4;
      const int k = k0 + kk;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int byte_idx = n0 / 2 + b0 + b;
        const int r_lo = 2 * byte_idx;
        float lo = 0.f, hi = 0.f;
        if (k < K && byte_idx < Rh) {
          const uint8_t byte = packed[static_cast<size_t>(k) * Rh + byte_idx];
          const size_t s = static_cast<size_t>(k) * nb;
          const int g_lo = r_lo / block, g_hi = (r_lo + 1) / block;
          lo = __fmul_rn(__fsub_rn(static_cast<float>(byte & 0xF) - 8.f, zero[s + g_lo]),
                         scale[s + g_lo]);
          hi = __fmul_rn(__fsub_rn(static_cast<float>(byte >> 4) - 8.f, zero[s + g_hi]),
                         scale[s + g_hi]);
        }
        Bs[kk][2 * (b0 + b)] = lo;
        Bs[kk][2 * (b0 + b) + 1] = hi;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = n0 + tx * TN + j;
      if (r < R) out[static_cast<size_t>(m) * R + r] = acc[i][j];
    }
  }
}

}  // namespace

// g (M, K) f32 or bf16 (g_bf16 != 0); packed (K, R/2) uint8; scale, zero
// (K, R/block) f32; out (M, R) f32; R even, R % block == 0. Returns
// cudaGetLastError() after the launch.
extern "C" int qgl_int4_matmul(const void* g, int g_bf16, const void* packed, const void* scale,
                               const void* zero, void* out, int M, int K, int R, int block,
                               void* stream) {
  if (M <= 0 || R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + BN - 1) / BN, (M + BM - 1) / BM);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  float* o = static_cast<float*>(out);
  if (g_bf16)
    int4_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), p, s, z, o, M, K, R, block);
  else
    int4_matmul_kernel<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(g), p, s, z,
                                                        o, M, K, R, block);
  return static_cast<int>(cudaGetLastError());
}
