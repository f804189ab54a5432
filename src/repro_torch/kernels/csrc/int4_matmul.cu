// int4_matmul: out (M, R) f32 = g (M, K) @ deq_int4(P (K, R))
//
// Replaces the Pallas TPU kernel src/repro/kernels/int4_matmul.py::
// int4_matmul (the pl.pallas_call at int4_matmul.py:60): the GaLore
// projection of a full-rank gradient G onto the INT4 projection P, which is
// stored as packed nibbles, two a byte, the low nibble at the even index,
// with an asymmetric scale and zero point per (row k, block b of R):
//     P[k, r] = (u'[k, r] - zero[k, b]) * scale[k, b],  u' = nibble - 8.
// P never exists in device memory at more than 4 bits and its scales.
//
// What bounds it on an H100: the multiply-adds, 2 * M * K * R (4.3 GFLOP at
// M = K = 2048, R = 512), against ~19 MB of traffic, so the product runs on
// the tensor cores: mma.sync m16n8k16 bf16 with f32 sums (csrc/mma_bf16.cuh).
// The scale and the zero point vary along the contraction axis k, as the
// scale does in the forward int8_matmul, so the same fold carries it:
//  * a block owns an output tile inside one block b of R (128 columns; a
//    narrower block, or the block's last tile, masks the columns past its
//    end), so every k row of its A operand has the one scale s[k, b]:
//    A = g * s[:, b], rounded to bf16 (bf16 g: one pass; f32 g:
//    hi = bf16(g * s) and lo = bf16(g * s - hi), two mma into the same
//    sums);
//  * B is u', exact in bf16: each k step's nibbles are unpacked in
//    registers (mma_bf16.cuh's nibbles_to_bf16x2) and stored as bf16, then
//    read with ldmatrix.trans;
//  * the zero point is not an integer (zero = qmin - min / scale), so
//    u' - z is not exact in bf16 and stays out of B: the correction
//    c[m] = sum_k (g * s)[m, k] * z[k, b] is accumulated in f32 while A is
//    staged, reduced across the threads of a row at the end, and
//    subtracted in the epilogue: out = mma sum - c.
// A block owns a 64 x 128 output tile: at M = 2048, R = 512 that is 128
// blocks, so K is split in two to fill the card's 132 SMs (the unfused
// update's 5461-row projection makes 344 blocks and takes no split).
// 8 warps as 2 x 4, each a 32 x 32 warp tile; a 32-deep k step is
// loaded into registers one step ahead (plain loads: any M, K and R, rows
// of any alignment) and staged into the other of two shared buffers after
// the step's mma, one barrier a step. A K split runs over a grid axis;
// each split writes a float32 partial and a second kernel sums them in a
// fixed order (no atomics).
//
// Shapes: M and K ragged (every load is masked), R even and a multiple of
// block (block even).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "splitk.cuh"

namespace {

using namespace mma_bf16;

constexpr int THREADS = 256;
constexpr int TBK = 32;             // contraction (k) a step
constexpr int BM = 64;              // output rows a block
constexpr int BN = 128;             // output columns a block (inside one block of R)
constexpr int LDA = TBK + 8;        // bf16 a staged A row (80 bytes: ldmatrix conflict free)
constexpr int LDB = BN + 8;         // bf16 a staged B row

template <typename T>
struct Cfg {
  static constexpr int PASSES = sizeof(T) == 4 ? 2 : 1;   // f32 g: hi and lo
  static constexpr int AS = 2 * PASSES * BM * LDA * 2;     // [buffer][pass][BM][LDA]
  static constexpr int BS = 2 * TBK * LDB * 2;             // [buffer][TBK][LDB]
  static constexpr int SMEM = AS + BS + BM * 4;            // + the row corrections
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
i4mm_mma(const T* __restrict__ g, const uint8_t* __restrict__ packed,
         const float* __restrict__ scale, const float* __restrict__ zero,
         float* __restrict__ out, int M, int K, int R, int block, int kc, int vec) {
  using C = Cfg<T>;
  constexpr int PASSES = C::PASSES;
  constexpr int WM = BM / 2, MI = WM / 16;       // 2 x 4 warps
  constexpr int WN = BN / 4, NJ = WN / 8;
  constexpr int NR = BM / 16;                    // A rows a thread stages
  constexpr int NW = BN / 64;                    // packed words a thread stages
  using Raw = typename std::conditional<sizeof(T) == 4, float2, uint32_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + C::AS);
  float* Cs = reinterpret_cast<float*>(smem + C::AS + C::BS);

  const int nb = R / block, Rh = R / 2;
  const int tpb = (block + BN - 1) / BN;       // tiles a block of R
  const int b = blockIdx.x / tpb;
  const int c0 = b * block + (blockIdx.x % tpb) * BN;
  const int c_end = min(c0 + BN, (b + 1) * block);
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * kc;
  const int k_end = min(K, k_begin + kc);
  const int n_steps = (k_end - k_begin + TBK - 1) / TBK;
  float* dst = out + static_cast<size_t>(blockIdx.z) * M * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  // A staging: a thread holds the k pair 2 kp, 2 kp + 1 of NR rows; the
  // half-warps of a store take rows 4 apart (80-byte rows: no conflicts)
  const int kp = lane & 15;
  auto a_row = [&](int t) {
    return 8 * ((warp >> 2) + 2 * t) + (warp & 3) + 4 * (lane >> 4);
  };
  // B staging: a thread holds words part, part + 8 of code row kr
  const int kr = tid >> 3, part = tid & 7;

  Raw raw[NR];
  float sk[2], zk[2], corr[NR];
  uint32_t pw[NW];
#pragma unroll
  for (int t = 0; t < NR; ++t) corr[t] = 0.f;

  auto fetch = [&](int st) {
    const int kb = k_begin + st * TBK;
    const int k = kb + 2 * kp;
    const bool ok0 = k < k_end, ok1 = k + 1 < k_end;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = e ? ok1 : ok0;
      const size_t i = static_cast<size_t>(k + e) * nb + b;
      sk[e] = ok ? __ldg(scale + i) : 0.f;
      zk[e] = ok ? __ldg(zero + i) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < NR; ++t) {
      const int m = m0 + a_row(t);
      const T* p = g + static_cast<size_t>(m < M ? m : 0) * K + k;
      if (m < M && ok1 && vec) {
        raw[t] = *reinterpret_cast<const Raw*>(p);
      } else if constexpr (sizeof(T) == 4) {
        raw[t] = make_float2(m < M && ok0 ? p[0] : 0.f, m < M && ok1 ? p[1] : 0.f);
      } else {
        raw[t] = (m < M && ok0 ? static_cast<uint32_t>(__bfloat16_as_ushort(p[0])) : 0u) |
                 (m < M && ok1 ? static_cast<uint32_t>(__bfloat16_as_ushort(p[1])) << 16 : 0u);
      }
    }
    const int krow = kb + kr;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int c = c0 + 8 * (part + 8 * w);      // first column of the word
      const uint8_t* p = packed + static_cast<size_t>(krow) * Rh + c / 2;
      if (krow < k_end && c + 8 <= c_end && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
        pw[w] = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)     // 0x88: both nibbles 8, u' = 0
          v |= static_cast<uint32_t>(krow < k_end && c + 2 * j < c_end ? p[j] : 0x88) << (8 * j);
        pw[w] = v;
      }
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int t = 0; t < NR; ++t) {
      float v0, v1;
      if constexpr (sizeof(T) == 4) {
        v0 = raw[t].x;
        v1 = raw[t].y;
      } else {
        v0 = __uint_as_float(raw[t] << 16);
        v1 = __uint_as_float(raw[t] & 0xFFFF0000u);
      }
      v0 *= sk[0];
      v1 *= sk[1];
      corr[t] = fmaf(v1, zk[1], fmaf(v0, zk[0], corr[t]));
      const uint32_t hi = pack_bf16x2(v0, v1);
      __nv_bfloat16* dst_a = As + ((buf * PASSES) * BM + a_row(t)) * LDA + 2 * kp;
      *reinterpret_cast<uint32_t*>(dst_a) = hi;
      if constexpr (PASSES == 2)
        *reinterpret_cast<uint32_t*>(dst_a + BM * LDA) =
            pack_bf16x2(v0 - __uint_as_float(hi << 16), v1 - __uint_as_float(hi & 0xFFFF0000u));
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t x = pw[w], x4 = x >> 4;
      *reinterpret_cast<uint4*>(Bs + (buf * TBK + kr) * LDB + 8 * (part + 8 * w)) =
          make_uint4(nibbles_to_bf16x2(x, x4, 0), nibbles_to_bf16x2(x, x4, 1),
                     nibbles_to_bf16x2(x, x4, 2), nibbles_to_bf16x2(x, x4, 3));
    }
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  if (n_steps > 0) {
    fetch(0);
    stage(0);
  }
  for (int st = 0; st < n_steps; ++st) {
    __syncthreads();    // buffer st & 1 is staged; buffer (st + 1) & 1 is consumed
    if (st + 1 < n_steps) fetch(st + 1);
    const __nv_bfloat16* Ab = As + (st & 1) * PASSES * BM * LDA;
    const __nv_bfloat16* Bb = Bs + (st & 1) * TBK * LDB;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      uint32_t bf[NJ][2];
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t r4[4];
        ldsm_x4_t(r4, Bb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + wn * WN +
                          jp * 16 + (lane >> 4) * 8);
        bf[2 * jp][0] = r4[0];
        bf[2 * jp][1] = r4[1];
        bf[2 * jp + 1][0] = r4[2];
        bf[2 * jp + 1][1] = r4[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          uint32_t a[4];
          ldsm_x4(a, Ab + (p * BM + wm * WM + mi * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_bf16_16816(acc[mi][j], a, bf[j][0], bf[j][1]);
        }
      }
    }
    if (st + 1 < n_steps) stage((st + 1) & 1);
  }

  // the row corrections: the 16 threads of a half-warp share a row
#pragma unroll
  for (int t = 0; t < NR; ++t) {
    float v = corr[t];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    if (kp == 0) Cs[a_row(t)] = v;
  }
  __syncthreads();

  // a lane holds, for rows g and g + 8, the columns 8j + 2t, 8j + 2t + 1
  // (R and block are even, so both or neither lie before c_end)
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int rl = wm * WM + mi * 16 + gq;
    const float cr0 = Cs[rl], cr8 = Cs[rl + 8];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + wn * WN + 8 * j + 2 * tq;
      if (c >= c_end) continue;
      if (m0 + rl < M)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(m0 + rl) * R + c) =
            make_float2(acc[mi][j][0] - cr0, acc[mi][j][1] - cr0);
      if (m0 + rl + 8 < M)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(m0 + rl + 8) * R + c) =
            make_float2(acc[mi][j][2] - cr8, acc[mi][j][3] - cr8);
    }
  }
}

template <typename T>
cudaError_t launch(const T* g, const uint8_t* p, const float* s, const float* z, float* o,
                   int M, int K, int R, int block, int kc, int splits, int vec,
                   cudaStream_t st) {
  constexpr int smem = Cfg<T>::SMEM;
  auto kern = i4mm_mma<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (R / block) * ((block + BN - 1) / BN);
  const dim3 grid(tiles, (M + BM - 1) / BM, splits);
  kern<<<grid, THREADS, smem, st>>>(g, p, s, z, o, M, K, R, block, kc, vec);
  return cudaSuccess;
}

}  // namespace

// g (M, K) f32 or bf16 (g_bf16 != 0); packed (K, R/2) uint8; scale, zero
// (K, R/block) f32; out (M, R) f32; R even, block even, R % block == 0;
// (M + 63) / 64 <= 65535. kc: K rows a split (a multiple of 32); with
// splits > 1 the partials go to ws (splits * M * R floats) and a second
// kernel sums them into out. vec != 0: K is even and g is aligned to two
// elements, so a k pair is one load. Returns cudaGetLastError() after the
// launches.
extern "C" int qgl_int4_matmul(const void* g, int g_bf16, const void* packed, const void* scale,
                               const void* zero, void* out, void* ws, int M, int K, int R,
                               int block, int kc, int splits, int vec, void* stream) {
  if (M <= 0 || R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zero);
  float* dst = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(out);
  const cudaError_t err =
      g_bf16 ? launch(static_cast<const __nv_bfloat16*>(g), p, s, z, dst, M, K, R, block, kc,
                      splits, vec, st)
             : launch(static_cast<const float*>(g), p, s, z, dst, M, K, R, block, kc, splits,
                      vec, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1)
    splitk::launch(static_cast<const float*>(ws), static_cast<float*>(out), splits,
                   static_cast<size_t>(M) * R, st);
  return static_cast<int>(cudaGetLastError());
}
