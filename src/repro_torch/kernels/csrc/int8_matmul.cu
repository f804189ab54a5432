// int8_matmul: out (M, N) f32 = x (M, K) @ deq(q (K, N) int8, scale (K, N/256) f32)
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py::int8_matmul
// (the pl.pallas_call at int8_matmul.py:85). Same arithmetic: the per-(k,
// 256-column group) scale varies along the contraction axis, so it folds
// into the activation, out[:, g] = (x * s[:, g]) @ q[:, g]; no dequantized
// weight tile is ever formed. Accumulation is float32 FMA; x is f32 or bf16.
// N is the QTensor's padded width (a multiple of 256); padded columns hold
// code 0 and come out 0, the caller crops them. K may be ragged (5461 =
// llama-1b's d_ff): every K loop stops at K itself.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 FMA):
//  * decode and short prefill (M <= 16): the weight bytes. Each code is read
//    once and used M times, so the kernel is a stream over K*N bytes. The
//    small-M path gives each block one 256-column group (one scale column)
//    and a slice of K; each lane loads 8 codes (8 bytes) per row, a warp 256
//    contiguous bytes, and the 8 warps of a block take interleaved rows. The
//    scaled activations x*s for the block's K chunk sit in shared memory.
//    When there are too few column groups to fill the card, K is split over
//    a grid axis; each split writes a float32 partial and a second kernel
//    sums them in a fixed order (deterministic, no atomics).
//  * prefill (M > 16): the multiply-adds. The tiled path is a plain
//    register-blocked float32 GEMM (128x128 tile, 16-deep K step, 8x8
//    outputs per thread): codes are converted to f32 in shared memory, x is
//    scaled on its way in. It does not use the tensor cores yet; that
//    (mma/wgmma on bf16 tiles, TMA, persistence) is the next step.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 256;      // quant block along N
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// sign-extend byte j of a 32-bit word
__device__ __forceinline__ float code(int w, int j) {
  return static_cast<float>(static_cast<int>(static_cast<unsigned>(w) << (24 - 8 * j)) >> 24);
}

// ---------------------------------------------------------------------------
// small-M path: one 256-column group per block, K split over blockIdx.y
// ---------------------------------------------------------------------------
constexpr int KSUB = 256;       // K rows staged in shared memory at a time

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS)
i8mm_small(const T* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, float* __restrict__ out,
           int M, int K, int N, int kc) {
  const int g = blockIdx.x;
  const int n0 = g * GROUP;
  const int G = N / GROUP;
  const int k_begin = blockIdx.y * kc;
  const int k_end = min(K, k_begin + kc);
  float* dst = out + static_cast<size_t>(blockIdx.y) * M * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __shared__ float xs[MT][KSUB];
  __shared__ float red[THREADS / 32][GROUP];

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += KSUB) {
    const int rows = min(KSUB, k_end - k0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = threadIdx.x; i < MT * KSUB; i += THREADS) {
      const int m = i / KSUB, kk = i % KSUB;
      float v = 0.f;
      if (m < M && kk < rows) {
        const int k = k0 + kk;
        v = to_f32(x[static_cast<size_t>(m) * K + k]) *
            scale[static_cast<size_t>(k) * G + g];
      }
      xs[m][kk] = v;
    }
    __syncthreads();
    const int8_t* qp = q + static_cast<size_t>(k0) * N + n0 + lane * 8;
#pragma unroll 4
    for (int kk = warp; kk < rows; kk += THREADS / 32) {
      const int2 raw = __ldg(reinterpret_cast<const int2*>(qp + static_cast<size_t>(kk) * N));
      float w[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = code(raw.x, j);
        w[j + 4] = code(raw.y, j);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float a = xs[m][kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(a, w[j], acc[m][j]);
      }
    }
  }

  // sum the 8 warps' partial columns, one output row at a time
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][lane * 8 + j] = acc[m][j];
      __syncthreads();
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) s += red[w][threadIdx.x];
      dst[static_cast<size_t>(m) * N + n0 + threadIdx.x] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// tiled path: 128x128 output tile per block, K split over blockIdx.z
// ---------------------------------------------------------------------------
constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
i8mm_tiled(const T* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, float* __restrict__ out,
           int M, int K, int N, int kc) {
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int g = n0 / GROUP;
  const int G = N / GROUP;
  const int k_begin = blockIdx.z * kc;
  const int k_end = min(K, k_begin + kc);
  float* dst = out + static_cast<size_t>(blockIdx.z) * M * N;

  __shared__ __align__(16) float As[BK][BM];   // (x * s)^T tile
  __shared__ __align__(16) float Bs[BK][BN];   // codes as f32

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      float v = 0.f;
      if (m < M && k < k_end)
        v = to_f32(x[static_cast<size_t>(m) * K + k]) *
            scale[static_cast<size_t>(k) * G + g];
      As[c][r] = v;
    }
    {
      const int r = tid / 16, c = (tid % 16) * 8;
      const int k = k0 + r;
      int2 raw = make_int2(0, 0);
      if (k < k_end)
        raw = __ldg(reinterpret_cast<const int2*>(q + static_cast<size_t>(k) * N + n0 + c));
      float4 lo, hi;
      lo.x = code(raw.x, 0); lo.y = code(raw.x, 1); lo.z = code(raw.x, 2); lo.w = code(raw.x, 3);
      hi.x = code(raw.y, 0); hi.y = code(raw.y, 1); hi.z = code(raw.y, 2); hi.w = code(raw.y, 3);
      *reinterpret_cast<float4*>(&Bs[r][c]) = lo;
      *reinterpret_cast<float4*>(&Bs[r][c + 4]) = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m < M) {
      float* o = dst + static_cast<size_t>(m) * N + n0 + tx * TN;
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// out[i] = sum over splits of ws[s][i], in split order
__global__ void splitk_reduce(const float* __restrict__ ws, float* __restrict__ out,
                              int splits, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[static_cast<size_t>(z) * n + i];
    out[i] = s;
  }
}

template <typename T>
void launch_small(const T* x, const int8_t* q, const float* s, float* o, int M, int K,
                  int N, int m_tile, int kc, int splits, cudaStream_t st) {
  const dim3 grid(N / GROUP, splits);
  switch (m_tile) {
    case 1: i8mm_small<T, 1><<<grid, THREADS, 0, st>>>(x, q, s, o, M, K, N, kc); break;
    case 2: i8mm_small<T, 2><<<grid, THREADS, 0, st>>>(x, q, s, o, M, K, N, kc); break;
    case 4: i8mm_small<T, 4><<<grid, THREADS, 0, st>>>(x, q, s, o, M, K, N, kc); break;
    case 8: i8mm_small<T, 8><<<grid, THREADS, 0, st>>>(x, q, s, o, M, K, N, kc); break;
    default: i8mm_small<T, 16><<<grid, THREADS, 0, st>>>(x, q, s, o, M, K, N, kc); break;
  }
}

template <typename T>
void launch_tiled(const T* x, const int8_t* q, const float* s, float* o, int M, int K,
                  int N, int kc, int splits, cudaStream_t st) {
  const dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  i8mm_tiled<T><<<grid, THREADS, 0, st>>>(x, q, s, o, M, K, N, kc);
}

}  // namespace

// path 0: small-M (m_tile in {1, 2, 4, 8, 16}, M <= m_tile); path 1: tiled.
// With splits > 1 the partials go to ws (splits * M * N floats) and a second
// kernel sums them into out. Returns cudaGetLastError() after the launches.
extern "C" int qgl_int8_matmul(const void* x, int x_bf16, const void* q, const void* scale,
                               void* out, void* ws, int M, int K, int N, int path,
                               int m_tile, int kc, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* dst = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(out);
  if (path == 0) {
    if (x_bf16)
      launch_small(static_cast<const __nv_bfloat16*>(x), qc, sc, dst, M, K, N, m_tile, kc, splits, st);
    else
      launch_small(static_cast<const float*>(x), qc, sc, dst, M, K, N, m_tile, kc, splits, st);
  } else {
    if (x_bf16)
      launch_tiled(static_cast<const __nv_bfloat16*>(x), qc, sc, dst, M, K, N, kc, splits, st);
    else
      launch_tiled(static_cast<const float*>(x), qc, sc, dst, M, K, N, kc, splits, st);
  }
  if (splits > 1) {
    const size_t n = static_cast<size_t>(M) * N;
    const int blocks = static_cast<int>((n + THREADS - 1) / THREADS < 4096 ? (n + THREADS - 1) / THREADS : 4096);
    splitk_reduce<<<blocks, THREADS, 0, st>>>(static_cast<const float*>(ws),
                                              static_cast<float*>(out), splits, n);
  }
  return static_cast<int>(cudaGetLastError());
}
