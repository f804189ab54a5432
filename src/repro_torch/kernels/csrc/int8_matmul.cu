// int8_matmul: out (M, N) f32 = x (M, K) @ deq(q (K, N) int8, scale (K, N/256) f32)
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py::int8_matmul
// (the pl.pallas_call at int8_matmul.py:85). Same arithmetic: the per-(k,
// 256-column group) scale varies along the contraction axis, so it folds
// into the activation, out[:, g] = (x * s[:, g]) @ q[:, g]; no dequantized
// weight tile is ever formed. x is f32 or bf16; the sums are f32. N is the
// QTensor's padded width (a multiple of 256); padded columns hold code 0
// and come out 0, the caller crops them. K may be ragged (5461 = llama-1b's
// d_ff): every K loop stops at K itself.
//
// Two paths, chosen by the wrapper's plan() from M:
//
//  * decode and short prefill (M <= 16), bound by the weight bytes. Each code
//    is read once and used M times, so the kernel is a stream over K*N
//    bytes. The small-M path gives each block one 256-column group (one
//    scale column) and a slice of K; each lane loads 8 codes (8 bytes) per
//    row, a warp 256 contiguous bytes, and the 8 warps of a block take
//    interleaved rows. The scaled activations x*s for the block's K chunk
//    sit in shared memory; the multiply-adds are f32 FMA.
//
//  * prefill and training (M > 16), bound by the multiply-adds: the tiled
//    path runs them on the tensor cores (mma.sync m16n8k16 bf16 -> f32,
//    csrc/mma_bf16.cuh). A block owns a BM x 128 output tile (BM 64 or 128)
//    inside one 256-column group, so every k row of its A operand has the
//    single scale s[k, g]. Per 32-deep k tile, through a 4-stage cp.async
//    ring (16-byte copies, zero fill past the K range):
//      - the codes (rows padded to 144 bytes), the tile's 32 scales, and
//        the raw x slice of each row. A row of x need not be 16-byte
//        aligned (K = 5461 in bf16): its slice is copied as the aligned
//        chunks that cover it, one chunk more than the slice, zero filled
//        from the split's k_end on;
//      - while tile kt's mma run, tile kt + 3 is in flight, and after them
//        the raw x of tile kt + 1 is scaled into the other A buffer: read
//        at the row's byte offset (a funnel shift for an odd bf16 offset),
//        multiplied by s in f32, rounded to bf16 (rows padded to 80 bytes,
//        so ldmatrix is conflict free). One barrier a tile.
//      - ldmatrix.trans reads the codes' byte pairs as b16: a lane gets the
//        codes of k rows 2t, 2t+1 at columns 2g and 2g+1, which feed two
//        n8 tiles (even and odd output columns); they become bf16 exactly
//        in registers (s8x4_to_bf16x2), so the only rounding in the product
//        is that of x * s. A lane's four accumulators of an (even, odd)
//        pair are four consecutive output columns: one float4 store.
//      - 8 warps as 2 x 4, each a (BM/2) x 32 warp tile.
//    bf16 x takes one pass: x is already bf16, and rounding x * s to bf16 is
//    what the TPU's MXU does with an f32 dot_general at default precision
//    (relative error ~2^-9 a term, well inside the 2e-2 tolerance). f32 x
//    takes two: hi = bf16(x * s) and lo = bf16(x * s - hi) are two A tiles,
//    and each fragment issues two mma into the same accumulator; since the
//    codes are exact in bf16 this keeps f32 callers (CPU/GPU parity, the
//    card tests) within ~2^-16 of the f32 product at twice the work.
//    What bounds the path now: instruction issue (mma.sync, the scaling
//    pass and the in-register code conversion, which the two warps of a
//    column repeat); wgmma, TMA and warp specialisation are a later step.
//
// When the output tiles cannot fill the card, K is split over a grid axis;
// each split writes a float32 partial and a second kernel sums them in a
// fixed order (deterministic, no atomics).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "splitk.cuh"

namespace {

using namespace mma_bf16;

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
// tiled path: BM x 128 output tile per block on the tensor cores, K split
// over blockIdx.z
// ---------------------------------------------------------------------------
constexpr int TBN = 128, TBK = 32;
constexpr int LDA = TBK + 8;    // bf16 elements per staged A row (80 bytes)
constexpr int LDB = TBN + 16;   // bytes per staged B row (144)

template <typename T, int BM_>
struct Tiled {
  static constexpr int PASSES = sizeof(T) == 4 ? 2 : 1;   // f32 x: hi and lo bf16 tiles
  static constexpr int STAGES = 4;                        // cp.async ring depth
  static constexpr int NCH = TBK * sizeof(T) / 16 + 1;    // 16-byte chunks of a raw x row
  static constexpr int XR = STAGES * BM_ * NCH * 16;
  static constexpr int SC = STAGES * TBK * 4;
  static constexpr int BS = STAGES * TBK * LDB;
  static constexpr int AS = 2 * PASSES * BM_ * LDA * 2;
  static constexpr int SMEM = XR + SC + BS + AS;
};

// Raw x, the 32 scales and the codes of tile kt + 3 are copied by cp.async
// while tile kt's mma run; after them the raw x of tile kt + 1 is scaled
// into the other A buffer. A row of x need not be 16-byte aligned (K =
// 5461, bf16): its tile slice is copied as the aligned 16-byte chunks that
// cover it, one more than the slice, with zero fill from k_end on, and the
// scaling pass reads it at the row's byte offset within the first chunk.
template <typename T, int BM_>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 1 : 2)
i8mm_mma(const T* __restrict__ x, const int8_t* __restrict__ q,
         const float* __restrict__ scale, float* __restrict__ out,
         int M, int K, int N, int kc) {
  using Cfg = Tiled<T, BM_>;
  constexpr int PASSES = Cfg::PASSES, S_ = Cfg::STAGES, NCH = Cfg::NCH;
  constexpr int E = sizeof(T);
  constexpr int WM = BM_ / 2;                      // warp tile rows (2 x 4 warps)
  constexpr int MI = WM / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Xr = smem;                                           // [S][BM][NCH * 16]
  float* Sc = reinterpret_cast<float*>(smem + Cfg::XR);               // [S][TBK]
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + Cfg::XR + Cfg::SC);   // [S][TBK][LDB]
  __nv_bfloat16* As =
      reinterpret_cast<__nv_bfloat16*>(smem + Cfg::XR + Cfg::SC + Cfg::BS);  // [2][P][BM][LDA]

  const int n0 = blockIdx.x * TBN;
  const int m0 = blockIdx.y * BM_;
  const int g = n0 / GROUP;
  const int G = N / GROUP;
  const int k_begin = blockIdx.z * kc;
  const int k_end = min(K, k_begin + kc);
  const int n_kt = (k_end - k_begin + TBK - 1) / TBK;
  float* dst = out + static_cast<size_t>(blockIdx.z) * M * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  // tile kt into stage kt % S: the codes (32 k rows x 8 chunks of 16, one
  // chunk a thread), the raw x slices and the 32 scales
  const int b_row = tid >> 3, b_col = (tid & 7) * 16;
  auto load_tile = [&](int kt) {
    const int s = kt % S_;
    const int kb = k_begin + kt * TBK;
    const int k = kb + b_row;
    const bool ok = k < k_end;
    cp_async16(Bs + (s * TBK + b_row) * LDB + b_col,
               q + static_cast<size_t>(ok ? k : k_begin) * N + n0 + b_col, ok ? 16 : 0);
    unsigned char* xr = Xr + s * BM_ * NCH * 16;
    for (int i = tid; i < BM_ * NCH; i += THREADS) {
      const int r = i / NCH, j = i % NCH;
      const T* row = x + static_cast<size_t>(m0 + r) * K;
      const uintptr_t first = reinterpret_cast<uintptr_t>(row + kb);
      const long long src = static_cast<long long>(first & ~uintptr_t(15)) + 16 * j;
      const long long end = static_cast<long long>(reinterpret_cast<uintptr_t>(row + k_end));
      // chunks past the slice's last byte (the extra one of an aligned row) stay unread
      const bool need = j <= static_cast<int>(((first & 15) + TBK * sizeof(T) - 1) >> 4);
      const int bytes = m0 + r < M && need
          ? static_cast<int>(max(0LL, min(16LL, end - src))) : 0;
      cp_async16(xr + i * 16, bytes ? reinterpret_cast<const void*>(src) : x, bytes);
    }
    if (tid < TBK) {
      const bool in = kb + tid < k_end;
      cp_async4(Sc + s * TBK + tid, scale + static_cast<size_t>(in ? kb + tid : 0) * G + g,
                in ? 4 : 0);
    }
  };
  // the landed raw x of tile kt into A buffer buf, 8 values an item:
  // bf16(x * s), and for f32 x also bf16 of the rounding's residual
  auto convert = [&](int kt, int buf) {
    const int s = kt % S_;
    const int kb = k_begin + kt * TBK;
    const unsigned char* xr = Xr + s * BM_ * NCH * 16;
    const float* sc = Sc + s * TBK;
#pragma unroll
    for (int i = tid; i < BM_ * TBK / 8; i += THREADS) {
      const int r = i / (TBK / 8), c = (i % (TBK / 8)) * 8;
      const int off = static_cast<int>(
          reinterpret_cast<uintptr_t>(x + static_cast<size_t>(m0 + r) * K + kb) & 15) + c * E;
      const uint32_t* w = reinterpret_cast<const uint32_t*>(xr + r * NCH * 16) + (off >> 2);
      float v[8];
      if constexpr (E == 2) {
        uint32_t p[4];
        if ((off & 15) == 0) {     // an aligned row: one 16-byte load
          const uint4 a = *reinterpret_cast<const uint4*>(w);
          p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
        } else {
          uint32_t u[5];
#pragma unroll
          for (int j = 0; j < 5; ++j) u[j] = w[j];
#pragma unroll
          for (int j = 0; j < 4; ++j) p[j] = off & 2 ? __funnelshift_r(u[j], u[j + 1], 16) : u[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[2 * j] = __uint_as_float(p[j] << 16);
          v[2 * j + 1] = __uint_as_float(p[j] & 0xFFFF0000u);
        }
      } else if ((off & 15) == 0) {
        const float4 a = *reinterpret_cast<const float4*>(w);
        const float4 b = *reinterpret_cast<const float4*>(w + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __uint_as_float(w[j]);
      }
      const float4 s0 = *reinterpret_cast<const float4*>(sc + c);
      const float4 s1 = *reinterpret_cast<const float4*>(sc + c + 4);
      v[0] *= s0.x; v[1] *= s0.y; v[2] *= s0.z; v[3] *= s0.w;
      v[4] *= s1.x; v[5] *= s1.y; v[6] *= s1.z; v[7] *= s1.w;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[j] = pack_bf16x2(v[2 * j], v[2 * j + 1]);
        if (PASSES == 2)
          lo[j] = pack_bf16x2(v[2 * j] - __uint_as_float(hi[j] << 16),
                              v[2 * j + 1] - __uint_as_float(hi[j] & 0xFFFF0000u));
      }
      *reinterpret_cast<uint4*>(As + ((buf * PASSES) * BM_ + r) * LDA + c) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      if (PASSES == 2)
        *reinterpret_cast<uint4*>(As + ((buf * PASSES + 1) * BM_ + r) * LDA + c) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S_ - 1; ++s) {
    if (s < n_kt) load_tile(s);
    cp_async_commit();
  }
  cp_async_wait<S_ - 2>();         // tile 0 has landed
  __syncthreads();
  convert(0, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<S_ - 3>();       // tiles up to kt + 1 have landed
    __syncthreads();               // ... for every thread, and A tile kt is stored
    if (kt + S_ - 1 < n_kt) load_tile(kt + S_ - 1);
    cp_async_commit();
    const __nv_bfloat16* Ab = As + (kt & 1) * PASSES * BM_ * LDA;
    const int8_t* Bb = Bs + (kt % S_) * TBK * LDB;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      // codes of k rows kk..kk+15 at the warp's 32 columns; b[j] = n8 tile j:
      // 0 and 1 the even and odd columns of the first 16, 2 and 3 of the next
      uint32_t raw[4], b[4][2];
      ldsm_x4_t(raw, Bb + (kk + (lane & 15)) * LDB + wn * 32 + (lane >> 4) * 16);
      s8x4_to_bf16x2(raw[0], b[0][0], b[1][0]);
      s8x4_to_bf16x2(raw[1], b[0][1], b[1][1]);
      s8x4_to_bf16x2(raw[2], b[2][0], b[3][0]);
      s8x4_to_bf16x2(raw[3], b[2][1], b[3][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          uint32_t a[4];
          ldsm_x4(a, Ab + (p * BM_ + wm * WM + mi * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[mi][j], a, b[j][0], b[j][1]);
        }
      }
    }
    // the other A buffer was last read in tile kt - 1
    if (kt + 1 < n_kt) convert(kt + 1, (kt + 1) & 1);
  }
  cp_async_wait<0>();

  // a lane holds, for rows g and g + 8, the columns 4t..4t+3 of each 16
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int r = m0 + wm * WM + mi * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + wn * 32 + h * 16 + (lane & 3) * 4;
      if (r < M)
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * N + c) =
            make_float4(acc[mi][2 * h][0], acc[mi][2 * h + 1][0], acc[mi][2 * h][1],
                        acc[mi][2 * h + 1][1]);
      if (r + 8 < M)
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(r + 8) * N + c) =
            make_float4(acc[mi][2 * h][2], acc[mi][2 * h + 1][2], acc[mi][2 * h][3],
                        acc[mi][2 * h + 1][3]);
    }
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

template <typename T, int BM_>
cudaError_t launch_mma(const T* x, const int8_t* q, const float* s, float* o, int M,
                       int K, int N, int kc, int splits, cudaStream_t st) {
  constexpr int smem = Tiled<T, BM_>::SMEM;
  auto kern = i8mm_mma<T, BM_>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(N / TBN, (M + BM_ - 1) / BM_, splits);
  kern<<<grid, THREADS, smem, st>>>(x, q, s, o, M, K, N, kc);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_tiled(const T* x, const int8_t* q, const float* s, float* o, int M,
                         int K, int N, int bm, int kc, int splits, cudaStream_t st) {
  if (bm == 64) return launch_mma<T, 64>(x, q, s, o, M, K, N, kc, splits, st);
  if (bm == 128) return launch_mma<T, 128>(x, q, s, o, M, K, N, kc, splits, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// path 0: small-M (m_tile in {1, 2, 4, 8, 16}, M <= m_tile); path 1: tiled
// (m_tile = the block's rows, 64 or 128; kc a multiple of 32; q 16-byte
// aligned). With splits > 1 the partials go to ws (splits * M * N floats)
// and a second kernel sums them into out. Returns cudaGetLastError() after
// the launches.
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
    const cudaError_t err =
        x_bf16 ? launch_tiled(static_cast<const __nv_bfloat16*>(x), qc, sc, dst, M, K, N,
                              m_tile, kc, splits, st)
               : launch_tiled(static_cast<const float*>(x), qc, sc, dst, M, K, N, m_tile, kc,
                              splits, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (splits > 1)
    splitk::launch(static_cast<const float*>(ws), static_cast<float*>(out), splits,
                   static_cast<size_t>(M) * N, st);
  return static_cast<int>(cudaGetLastError());
}
