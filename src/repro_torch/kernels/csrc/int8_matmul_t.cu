// int8_matmul_t: out (M, K) f32 = g (M, N) @ deq(q (K, N) int8, scale (K, N/256) f32)^T
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py::int8_matmul_t
// (the pl.pallas_call at int8_matmul.py:141): dL/dx of every quantized
// dense layer, streaming the SAME stored INT8 blocks as the forward (no
// transposed weight copy). The contraction runs along N, the quant axis, so
// the scale is a per-group accumulator epilogue, as in the TPU kernel
// (int8_matmul.py:100-122) and ref.int8_matmul_t_ref:
//     out[m, k] = sum_grp scale[k, grp] * (sum_{n in group grp} g[m, n] * q[k, n]).
//
// N is the QTensor's padded width (a multiple of 256); the wrapper zero-pads
// g to it, so padded codes contribute nothing, and every row of g and of q
// is 16-byte aligned. K (the output width) may be ragged (5461 = llama-1b's
// d_ff): code rows past K are zero filled and the stores are masked.
//
// What bounds it on an H100: the multiply-adds at M = 2048 tokens (2*M*K*N
// operations on 1 byte of weight per M of them), so the product runs on the
// tensor cores: mma.sync m16n8k16 bf16 with f32 sums (csrc/mma_bf16.cuh).
// The layout suits the mma as it is stored:
//  * A is g, row major along the contraction n: no scaling pass (the scale
//    is per output column, not per n), so bf16 g goes straight from
//    cp.async into the A tile.
//  * B[n, k] = q[k, n] is contiguous along n, the mma's column-major B. A
//    non-transposed ldmatrix of an 8 x 8 b16 matrix over 8 code rows gives
//    lane (g, t) the codes n = 4t..4t+3 of output column g: one whole k16 B
//    fragment, converted exactly to bf16 in registers as (c0, c1) and
//    (c2, c3). That maps the mma's k indices {2t, 2t+1, 2t+8, 2t+9} to
//    n = 4t..4t+3, so A is read with the same permutation: lane (g, t)
//    takes row g, n = 4t..4t+3 as one 64-bit shared load (and row g + 8).
//    Any permutation A and B share gives the same sum.
//  * the scale: the mma sums of one 256-wide group (part) are multiplied by
//    scale[k, grp] (one per output column, copied into shared memory with
//    the group's first step) and added into acc; two accumulator sets.
// A block owns a 128 x 128 output tile, 8 warps as 2 x 4, each a 64 x 32
// warp tile: 256 blocks at M = K = 2048, the training step's smallest
// problem, so the whole contraction runs in one block. The g tile and the
// code tile of each 32-deep n step stream through a 4-stage cp.async ring
// (one barrier a step).
// bf16 g takes one pass: bf16 times an int8 code is exact in f32, so the
// only rounding is the f32 sum's. f32 g takes two: hi = bf16(g) and
// lo = bf16(g - hi), rounded in a conversion pass one step ahead in shared
// memory, and two mma into the same sums (~2^-17 of each term).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int GROUP = 256;          // quant block along N
constexpr int THREADS = 256;
constexpr int BM = 128;             // output rows (m) a block
constexpr int TBN = 128;            // output columns (k) a block
constexpr int TBK = 32;             // contraction (n) a step
constexpr int STEPS_GROUP = GROUP / TBK;
constexpr int LDA = TBK + 16;       // bf16 a staged A row: 96 bytes, so the
                                    // 64-bit fragment loads are conflict free
constexpr int LDB = TBK + 16;       // bytes a staged code row: 48, so
                                    // ldmatrix is conflict free
constexpr int LDR = TBK * 4 + 16;   // bytes a raw f32 g row (144)

template <typename T>
struct Cfg {
  static constexpr int PASSES = sizeof(T) == 4 ? 2 : 1;   // f32 g: hi and lo
  static constexpr int STAGES = 4;                        // cp.async ring depth
  static constexpr int GROW = sizeof(T) == 4 ? LDR : LDA * 2;  // bytes a staged g row
  static constexpr int GS = STAGES * BM * GROW;
  static constexpr int BS = STAGES * TBN * LDB;
  static constexpr int AS = PASSES == 2 ? 2 * 2 * BM * LDA * 2 : 0;  // [buffer][hi, lo]
  static constexpr int SS = 2 * TBN * 4;                  // two groups' scales
  static constexpr int SMEM = GS + BS + AS + SS;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
i8mm_t_mma(const T* __restrict__ g, const int8_t* __restrict__ q,
           const float* __restrict__ scale, float* __restrict__ out,
           int M, int K, int N) {
  using C = Cfg<T>;
  constexpr int PASSES = C::PASSES, S_ = C::STAGES, E = sizeof(T);
  constexpr int WM = BM / 2;                    // warp tile rows (2 x 4 warps)
  constexpr int MI = WM / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Gs = smem;                                         // [S][BM][GROW]
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + C::GS);             // [S][TBN][LDB]
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + C::GS + C::BS);  // [2][2][BM][LDA]
  float* Ss = reinterpret_cast<float*>(smem + C::GS + C::BS + C::AS);            // [2][TBN]

  const int k0 = blockIdx.x * TBN;
  const int m0 = blockIdx.y * BM;
  const int G = N / GROUP;
  const int n_steps = G * STEPS_GROUP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;

  // step st into stage st % S: the codes (128 rows x 2 chunks of 16, one a
  // thread; rows past K zero filled) and the g rows (zero past M); with a
  // group's first step, the group's 128 scales into buffer (group & 1),
  // which the group two later overwrites only after this one's epilogue
  auto load_step = [&](int st) {
    const int s = st % S_;
    const int n = st * TBK;
    {
      const int r = tid >> 1, c = (tid & 1) * 16;
      const bool ok = k0 + r < K;
      cp_async16(Bs + (s * TBN + r) * LDB + c,
                 ok ? q + static_cast<size_t>(k0 + r) * N + n + c : q, ok ? 16 : 0);
    }
    if (st % STEPS_GROUP == 0 && tid < TBN) {
      const int gi = st / STEPS_GROUP;
      const bool ok = k0 + tid < K;
      cp_async4(Ss + (gi & 1) * TBN + tid,
                ok ? scale + static_cast<size_t>(k0 + tid) * G + gi : scale,
                ok ? 4 : 0);
    }
    constexpr int CPR = TBK * E / 16;            // 16-byte chunks a g row
#pragma unroll
    for (int i = tid; i < BM * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = m0 + r < M;
      cp_async16(Gs + (s * BM + r) * C::GROW + c * 16,
                 ok ? g + static_cast<size_t>(m0 + r) * N + n + c * (16 / E) : g, ok ? 16 : 0);
    }
  };
  // f32 g: the landed raw step st as bf16 hi and lo into A buffer buf
  auto convert = [&](int st, int buf) {
    const unsigned char* raw = Gs + (st % S_) * BM * C::GROW;
#pragma unroll
    for (int i = tid; i < BM * TBK / 8; i += THREADS) {
      const int r = i / (TBK / 8), c = (i % (TBK / 8)) * 8;
      const float4 a = *reinterpret_cast<const float4*>(raw + r * LDR + c * 4);
      const float4 b = *reinterpret_cast<const float4*>(raw + r * LDR + c * 4 + 16);
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[j] = pack_bf16x2(v[2 * j], v[2 * j + 1]);
        lo[j] = pack_bf16x2(v[2 * j] - __uint_as_float(hi[j] << 16),
                            v[2 * j + 1] - __uint_as_float(hi[j] & 0xFFFF0000u));
      }
      *reinterpret_cast<uint4*>(As + ((buf * 2) * BM + r) * LDA + c) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(As + ((buf * 2 + 1) * BM + r) * LDA + c) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  float acc[MI][4][4], part[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = part[mi][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S_ - 1; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }
  if constexpr (PASSES == 2) {
    cp_async_wait<S_ - 2>();        // step 0 has landed
    __syncthreads();
    convert(0, 0);
  }

  for (int st = 0; st < n_steps; ++st) {
    // one pass: step st has landed; two: st + 1 too (it is converted below)
    if constexpr (PASSES == 2) cp_async_wait<S_ - 3>(); else cp_async_wait<S_ - 2>();
    __syncthreads();                // ... for every thread; step st - 1 is consumed
    if (st + S_ - 1 < n_steps) load_step(st + S_ - 1);
    cp_async_commit();
    const int8_t* Bb = Bs + (st % S_) * TBN * LDB;
    const __nv_bfloat16* Ab =
        PASSES == 2 ? As + (st & 1) * 2 * BM * LDA
                    : reinterpret_cast<const __nv_bfloat16*>(Gs + (st % S_) * BM * C::GROW);
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      // lane l addresses code row wn * 32 + l: matrix j is n8 tile j
      uint32_t raw[4], b[4][2];
      ldsm_x4(raw, Bb + (wn * 32 + lane) * LDB + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) s8x4_to_bf16x2_pairs(raw[j], b[j][0], b[j][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          const __nv_bfloat16* row = Ab + (p * BM + wm * WM + mi * 16 + gq) * LDA + kk + 4 * tq;
          const uint2 r0 = *reinterpret_cast<const uint2*>(row);
          const uint2 r8 = *reinterpret_cast<const uint2*>(row + 8 * LDA);
          const uint32_t a[4] = {r0.x, r8.x, r0.y, r8.y};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16_16816(part[mi][j], a, b[j][0], b[j][1]);
        }
      }
    }
    if ((st + 1) % STEPS_GROUP == 0) {    // the group's scale epilogue
      // this lane's output columns 8j + 2t, 8j + 2t + 1 (zero past K)
      const float* sg = Ss + ((st / STEPS_GROUP) & 1) * TBN + wn * 32 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(sg + 8 * j);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][j][e] = fmaf(part[mi][j][e], e & 1 ? sc.y : sc.x, acc[mi][j][e]);
            part[mi][j][e] = 0.f;
          }
      }
    }
    // the other A buffer was last read in step st - 1
    if constexpr (PASSES == 2)
      if (st + 1 < n_steps) convert(st + 1, (st + 1) & 1);
  }
  cp_async_wait<0>();

  // a lane holds, for rows g and g + 8, the columns 8j + 2t, 8j + 2t + 1;
  // a row of the output is 8-byte aligned only when K is even
  auto store2 = [&](int r, int c, float v0, float v1) {
    if (r >= M || c >= K) return;
    float* p = out + static_cast<size_t>(r) * K + c;
    if ((K & 1) == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (c + 1 < K) p[1] = v1;
    }
  };
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int r = m0 + wm * WM + mi * 16 + gq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + wn * 32 + 8 * j + 2 * tq;
      store2(r, c, acc[mi][j][0], acc[mi][j][1]);
      store2(r + 8, c, acc[mi][j][2], acc[mi][j][3]);
    }
  }
}

template <typename T>
cudaError_t launch(const T* g, const int8_t* q, const float* s, float* o, int M, int K, int N,
                   cudaStream_t st) {
  constexpr int smem = Cfg<T>::SMEM;
  auto kern = i8mm_t_mma<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((K + TBN - 1) / TBN, (M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, st>>>(g, q, s, o, M, K, N);
  return cudaSuccess;
}

}  // namespace

// g (M, N) f32 or bf16 (g_bf16 != 0), 16-byte aligned; q (K, N) int8,
// 16-byte aligned; scale (K, N/256) f32; out (M, K) f32; N % 256 == 0;
// (M + 127) / 128 <= 65535. Returns cudaGetLastError() after the launch.
extern "C" int qgl_int8_matmul_t(const void* g, int g_bf16, const void* q, const void* scale,
                                 void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      g_bf16 ? launch(static_cast<const __nv_bfloat16*>(g), qc, sc, o, M, K, N, st)
             : launch(static_cast<const float*>(g), qc, sc, o, M, K, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
