// int8_matmul_t: out (M, K) f32 = g (M, N) @ deq(q (K, N) int8, scale (K, N/256) f32)^T
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py::int8_matmul_t
// (the pl.pallas_call at int8_matmul.py:141): dL/dx of every quantized
// dense layer, streaming the SAME stored INT8 blocks as the forward (no
// transposed weight copy). The contraction runs along N, the quant axis, so
// the scale is a per-group accumulator epilogue, as in the TPU kernel
// (int8_matmul.py:100-122) and ref.int8_matmul_t_ref:
//     out[m, k] = sum_g scale[k, g] * (sum_{n in group g} g[m, n] * q[k, n]).
// Each thread keeps a 256-column group's raw-code dot products in a
// register tile, then scales and adds them into its output accumulator.
//
// N is the QTensor's padded width (a multiple of 256); the wrapper zero-pads
// g to it, so padded codes contribute nothing. K (the output width) may be
// ragged (5461 = llama-1b's d_ff): the row loop over q stops at K.
//
// What bounds it on an H100: the multiply-adds at M = 2048 tokens (2*M*K*N
// operations on 1 byte of weight per M of them). This first version is a
// plain register-blocked float32 GEMM (128x128 output tile, 32-deep N step,
// 8x8 outputs per thread) with codes converted to f32 in shared memory; it
// does not use the tensor cores (mma/wgmma on bf16 tiles is the next step,
// shared with int8_matmul's tiled path).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 256;      // quant block along N
constexpr int THREADS = 256;
constexpr int BM = 128, BK = 128, BN = 32, TM = 8, TK = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
i8mm_t_tiled(const T* __restrict__ g, const int8_t* __restrict__ q,
             const float* __restrict__ scale, float* __restrict__ out,
             int M, int K, int N) {
  const int k0 = blockIdx.x * BK;
  const int m0 = blockIdx.y * BM;
  const int G = N / GROUP;

  __shared__ __align__(16) float As[BN][BM + 4];   // g tile, transposed (+4: fewer bank conflicts on the store)
  __shared__ __align__(16) float Bs[BN][BK];   // codes as f32, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TK], part[TM][TK];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TK; ++j) acc[i][j] = 0.f;

  for (int grp = 0; grp < G; ++grp) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) part[i][j] = 0.f;
    for (int n0 = grp * GROUP; n0 < (grp + 1) * GROUP; n0 += BN) {
      // g (BM x BN): 4096 values, 16 a thread, consecutive threads along n
#pragma unroll
      for (int t = 0; t < (BM * BN) / THREADS; ++t) {
        const int idx = tid + t * THREADS;
        const int r = idx / BN, c = idx % BN;
        const int m = m0 + r;
        As[c][r] = m < M ? to_f32(g[static_cast<size_t>(m) * N + n0 + c]) : 0.f;
      }
      // q (BK x BN): 128 rows of 32 bytes, 16 bytes a thread
      {
        const int r = tid / 2, c = (tid % 2) * 16;
        const int k = k0 + r;
        int4 raw = make_int4(0, 0, 0, 0);
        if (k < K)
          raw = __ldg(reinterpret_cast<const int4*>(q + static_cast<size_t>(k) * N + n0 + c));
        const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Bs[c + 4 * w + j][r] = static_cast<float>(
                static_cast<int>(static_cast<unsigned>(words[w]) << (24 - 8 * j)) >> 24);
      }
      __syncthreads();
#pragma unroll 8
      for (int nn = 0; nn < BN; ++nn) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[nn][ty * TM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[nn][ty * TM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[nn][tx * TK]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[nn][tx * TK + 4]);
        const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[TK] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TK; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }
    // scale epilogue of the group: one scale per output column k
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const int k = k0 + tx * TK + j;
      const float s = k < K ? scale[static_cast<size_t>(k) * G + grp] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(part[i][j], s, acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const int k = k0 + tx * TK + j;
      if (k < K) out[static_cast<size_t>(m) * K + k] = acc[i][j];
    }
  }
}

}  // namespace

// g (M, N) f32 or bf16 (g_bf16 != 0), q (K, N) int8, scale (K, N/256) f32,
// out (M, K) f32; N % 256 == 0. Returns cudaGetLastError() after the launch.
extern "C" int qgl_int8_matmul_t(const void* g, int g_bf16, const void* q, const void* scale,
                                 void* out, int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((K + BK - 1) / BK, (M + BM - 1) / BM);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (g_bf16)
    i8mm_t_tiled<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), qc, sc, o, M, K, N);
  else
    i8mm_t_tiled<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(g), qc, sc, o,
                                                  M, K, N);
  return static_cast<int>(cudaGetLastError());
}
