// flash_attention: o = softmax(q k^T / sqrt(d)) v, causal or full, native GQA
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (the pl.pallas_call at flash_attention.py:77), with the
// semantics of its _kernel (flash_attention.py:23-62): the scores are
// scaled by 1/sqrt(d) in f32; the KV blocks are walked with the online
// softmax recurrence, keeping a running (max, denominator, accumulator) in
// f32; masked scores are -1e30; KV blocks strictly above the diagonal are
// skipped; the output is acc / max(l, 1e-30), cast to q's type.
//
// Differences from the TPU kernel, none of them in the semantics:
//   * GQA is native: query head h reads kv head h / (H / KH), so K and V are
//     never repeated in memory (the TPU kernel takes them repeated);
//   * any S: the last query and KV tiles are ragged and masked (the TPU
//     kernel needs S divisible by its blocks);
//   * the layouts stay (B, S, H, d): a block computes its own strides.
//
// Two hand-written kernels, chosen by q's type (both are flash_attention):
//
// bf16 (every serving bundle): flash_mma, the FlashAttention-2 shape on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32, csrc/mma_bf16.cuh). One block
// of 4 warps per (batch x head, 64-row query tile), heaviest causal tiles
// first; each warp owns 16 query rows. The Q tile is loaded once and kept in
// registers as A fragments. 64-row K and V tiles go through a cp.async
// double-buffered ring in shared memory (rows padded by 16 bytes, so
// ldmatrix is conflict free; d and dv padded to 32, 64 or 128 with zeros,
// which add nothing). S = Q K^T comes out of mma in f32 registers; it is
// scaled by 1/sqrt(d) there (not on bf16 q, so nothing rounds twice; for
// d = 64 the two are the same) and by log2(e), so the online softmax runs
// on exp2f; the row max and denominator are quad shuffles. P is repacked
// to bf16 in registers and used directly as the A operand of P V (the
// m16n8 accumulator layout is the m16n8k16 A layout); V's B fragments come
// from ldmatrix.trans. What bounds it: at S 512 the bytes of q, k, v and o
// and the per-tile softmax; at long S the mma issue rate (wgmma, TMA and
// warp specialisation are a later step).
//
// f32 (parity phases and tests, never a serving bundle): flash_kernel, on
// the SIMT units, so f32 callers keep f32 products. One block of 256
// threads per (batch x head, 64-row query tile). The scaled Q tile and
// each 64-row K and V tile are staged in shared memory as f32 (K and Q
// rows padded so that 16-byte loads of eight lanes hit 32 distinct banks). Warp w owns query rows
// 8w..8w+7: a lane computes the scores of those rows against KV columns lane
// and lane + 32, reduces the row max and sum with warp shuffles, writes its
// probabilities to the warp's rows of a shared P tile, and accumulates P V
// for value columns lane + 32 t: f32 FMA, bound by the SIMT units
// (67 TFLOP/s).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;              // query rows per block
constexpr int BKV = 64;             // KV rows per tile (two per lane)
constexpr int RW = BQ / WARPS;      // query rows per warp
constexpr float NEG_INF = -1e30f;   // the TPU kernel's mask value
static_assert(BQ == BKV, "the causal tile count and load_tile assume square tiles");


struct Dims {
  int S, H, KH, d, dv;
  int dp;       // padded row of the Q and K tiles: round_up(d, 8) + 4
  int vw;       // padded row of the V tile: 32 * NT
  int causal;
  float scale;  // 1 / sqrt(d)
};

// 64 rows x width elements of a (B, S, heads, width) tensor starting at row
// s0 of head `head`, times mul, into a (64, ld) f32 tile, zero past S and
// past width
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int b, int s0, int head, int heads, int width,
                                          int ld, int S, float mul) {
  for (int idx = threadIdx.x; idx < BKV * ld; idx += THREADS) {
    const int r = idx / ld, c = idx % ld;
    const int s = s0 + r;
    float v = 0.f;
    if (s < S && c < width)
      v = src[((static_cast<size_t>(b) * S + s) * heads + head) * width + c];
    dst[idx] = mul == 1.f ? v : v * mul;
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Dims D) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // BQ x dp, scaled
  float* Ks = Qs + BQ * D.dp;            // BKV x dp
  float* Vs = Ks + BKV * D.dp;           // BKV x vw
  float* Ps = Vs + BKV * D.vw;           // BQ x BKV

  const int bh = blockIdx.x;
  const int b = bh / D.H, h = bh % D.H;
  const int kh = h / (D.H / D.KH);
  const int n_q = gridDim.y;
  const int qt = n_q - 1 - blockIdx.y;   // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d8 = D.dp - 4;

  load_tile(Qs, q, b, q0, h, D.H, D.d, D.dp, D.S, D.scale);

  float m[RW], l[RW], acc[RW][NT];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }

  const int n_kv = (D.S + BKV - 1) / BKV;
  const int n_iter = D.causal ? min(qt + 1, n_kv) : n_kv;   // BQ == BKV
  for (int j = 0; j < n_iter; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();                     // the previous tile is consumed
    load_tile(Ks, k, b, kv0, kh, D.KH, D.d, D.dp, D.S, 1.f);
    load_tile(Vs, v, b, kv0, kh, D.KH, D.dv, D.vw, D.S, 1.f);
    __syncthreads();

    // scores of rows 8w..8w+7 against columns lane, lane + 32
    float s[RW][2];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r][0] = s[r][1] = 0.f;
    const float* qrow = Qs + (warp * RW) * D.dp;
    const float* k0 = Ks + lane * D.dp;
    const float* k1 = Ks + (lane + 32) * D.dp;
#pragma unroll 2
    for (int dd = 0; dd < d8; dd += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k0 + dd);
      const float4 kb = *reinterpret_cast<const float4*>(k1 + dd);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qa = *reinterpret_cast<const float4*>(qrow + r * D.dp + dd);
        s[r][0] = fmaf(qa.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qa.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qa.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qa.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qa.x, kb.x, s[r][1]);
        s[r][1] = fmaf(qa.y, kb.y, s[r][1]);
        s[r][1] = fmaf(qa.z, kb.z, s[r][1]);
        s[r][1] = fmaf(qa.w, kb.w, s[r][1]);
      }
    }

    // mask, online softmax, P to shared memory
    float* prow = Ps + (warp * RW) * BKV;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int qpos = q0 + warp * RW + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = kv0 + lane + 32 * c;
        const bool ok = kpos < D.S && (!D.causal || kpos <= qpos);
        if (!ok) s[r][c] = NEG_INF;
      }
      float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= alpha;
      prow[r * BKV + lane] = p0;
      prow[r * BKV + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V over the tile's 64 KV rows
#pragma unroll 2
    for (int jj = 0; jj < BKV; jj += 4) {
      float4 p[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) p[r] = *reinterpret_cast<const float4*>(prow + r * BKV + jj);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float v0 = Vs[(jj + 0) * D.vw + lane + 32 * t];
        const float v1 = Vs[(jj + 1) * D.vw + lane + 32 * t];
        const float v2 = Vs[(jj + 2) * D.vw + lane + 32 * t];
        const float v3 = Vs[(jj + 3) * D.vw + lane + 32 * t];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          acc[r][t] = fmaf(p[r].x, v0, acc[r][t]);
          acc[r][t] = fmaf(p[r].y, v1, acc[r][t]);
          acc[r][t] = fmaf(p[r].z, v2, acc[r][t]);
          acc[r][t] = fmaf(p[r].w, v3, acc[r][t]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int s_ = q0 + warp * RW + r;
    if (s_ >= D.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<size_t>(b) * D.S + s_) * D.H + h) * D.dv;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = lane + 32 * t;
      if (c < D.dv) orow[c] = __fdiv_rn(acc[r][t], den);
    }
  }
}

template <typename T, int NT>
int launch(const void* q, const void* k, const void* v, void* o, int B, Dims D,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(BQ + BKV) * D.dp
                                       + static_cast<size_t>(BKV) * D.vw + BQ * BKV);
  auto kern = flash_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * D.H, (D.S + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(o), D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_nt(const void* q, const void* k, const void* v, void* o, int B, Dims D,
                cudaStream_t st) {
  const int nt = (D.dv + 31) / 32;
  D.vw = 32 * nt;
  switch (nt) {
    case 1: return launch<T, 1>(q, k, v, o, B, D, st);
    case 2: return launch<T, 2>(q, k, v, o, B, D, st);
    case 3: return launch<T, 3>(q, k, v, o, B, D, st);
    case 4: return launch<T, 4>(q, k, v, o, B, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int MTHREADS = 128;       // 4 warps, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;

// 64 rows x `width` elements of a (B, S, heads, width) bf16 tensor from row
// s0 of head `head` into a (64, LD) tile. vec: width % 8 == 0 and 16-byte
// aligned bases, so 16-byte cp.async copies with zero fill past S (the
// columns from width to W hold zeros, written once by zero_pad); otherwise
// element by element, zeros past S and past width.
template <int W, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src, int b,
                                          int s0, int head, int heads, int width, int S,
                                          bool vec) {
  if (vec) {
    const int chunks = width / 8;
    for (int i = threadIdx.x; i < 64 * chunks; i += MTHREADS) {
      const int r = i / chunks, c = i % chunks;
      const int s = s0 + r;
      const bool ok = s < S;
      mma_bf16::cp_async16(
          dst + r * LD + c * 8,
          src + ((static_cast<size_t>(b) * S + (ok ? s : 0)) * heads + head) * width + c * 8,
          ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * W; i += MTHREADS) {
      const int r = i / W, c = i % W;
      const int s = s0 + r;
      dst[r * LD + c] = s < S && c < width
          ? src[((static_cast<size_t>(b) * S + s) * heads + head) * width + c]
          : __float2bfloat16_rn(0.f);
    }
  }
}

// zeros in columns [width rounded down to 8, W) of `rows` rows
template <int W, int LD>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* dst, int rows, int width) {
  const int c0 = width / 8, chunks = W / 8 - c0;
  for (int i = threadIdx.x; i < rows * chunks; i += MTHREADS)
    *reinterpret_cast<uint4*>(dst + (i / chunks) * LD + (c0 + i % chunks) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
}

template <int DP, int DVP>
constexpr int mma_smem() {
  return (BQ * (DP + 8) + 2 * BKV * (DP + 8) + 2 * BKV * (DVP + 8)) * 2;
}

template <int DP, int DVP>
__global__ void __launch_bounds__(MTHREADS)
flash_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Dims D,
          int vec) {
  using namespace mma_bf16;
  constexpr int LDQ = DP + 8, LDV = DVP + 8;   // bf16 elements per staged row
  constexpr int KD = DP / 16, NV = DVP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LDQ
  __nv_bfloat16* Ks = Qs + BQ * LDQ;                                // 2 x BKV x LDQ
  __nv_bfloat16* Vs = Ks + 2 * BKV * LDQ;                           // 2 x BKV x LDV

  const int bh = blockIdx.x;
  const int b = bh / D.H, h = bh % D.H;
  const int kh = h / (D.H / D.KH);
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  if (vec) {
    zero_pad<DP, LDQ>(Qs, BQ + 2 * BKV, D.d);   // Q and both K stages
    zero_pad<DVP, LDV>(Vs, 2 * BKV, D.dv);
  }
  load_rows<DP, LDQ>(Qs, q, b, q0, h, D.H, D.d, D.S, vec);
  load_rows<DP, LDQ>(Ks, k, b, 0, kh, D.KH, D.d, D.S, vec);
  load_rows<DVP, LDV>(Vs, v, b, 0, kh, D.KH, D.dv, D.S, vec);
  cp_async_commit();

  const int n_kv = (D.S + BKV - 1) / BKV;
  const int n_iter = D.causal ? min(qt + 1, n_kv) : n_kv;   // BQ == BKV
  const float sl2 = D.scale * LOG2E;
  uint32_t qf[KD][4];
  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int j = 0; j < n_iter; ++j) {
    const int st = j & 1;
    if (j + 1 < n_iter) {
      load_rows<DP, LDQ>(Ks + (st ^ 1) * BKV * LDQ, k, b, (j + 1) * BKV, kh, D.KH, D.d, D.S, vec);
      load_rows<DVP, LDV>(Vs + (st ^ 1) * BKV * LDV, v, b, (j + 1) * BKV, kh, D.KH, D.dv, D.S,
                          vec);
    }
    cp_async_commit();
    cp_async_wait<1>();            // tile j (and Q) have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldsm_x4(qf[kd], Qs + (warp * 16 + (lane & 15)) * LDQ + kd * 16 + (lane >> 4) * 8);
    }

    // S = Q K^T: the warp's 16 rows against the tile's 64 columns
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const __nv_bfloat16* Kt = Ks + st * BKV * LDQ;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDQ + kd * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * np], qf[kd], kb[0], kb[1]);
        mma_bf16_16816(s[2 * np + 1], qf[kd], kb[2], kb[3]);
      }
    }

    // scale to the log2 domain, mask, online softmax
    const int kv0 = j * BKV;
    const bool masked = kv0 + BKV > D.S || (D.causal && kv0 + BKV - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (masked) {
          const int col = kv0 + n * 8 + 2 * t + (e & 1);
          const int row = q0 + warp * 16 + g + (e >> 1) * 8;
          if (col >= D.S || (D.causal && col > row)) x = NEG_INF;
        }
        s[n][e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float alpha = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][2 * r] = exp2f(s[n][2 * r] - m_new);
        s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - m_new);
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l_r[r] = l_r[r] * alpha + sum;   // this lane's columns; quad-summed at the end
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // acc += P V, P repacked to bf16 A fragments in registers
    const __nv_bfloat16* Vt = Vs + st * BKV * LDV;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int vp = 0; vp < DVP / 16; ++vp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV + vp * 16 +
                          (lane >> 4) * 8);
        mma_bf16_16816(acc[2 * vp], pa, vb[0], vb[1]);
        mma_bf16_16816(acc[2 * vp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();               // stage st is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int s_ = q0 + warp * 16 + g + 8 * r;
    if (s_ >= D.S) continue;
    __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * D.S + s_) * D.H + h) * D.dv;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int c = n * 8 + 2 * t;
      const float v0 = acc[n][2 * r] / den, v1 = acc[n][2 * r + 1] / den;
      if (D.dv % 2 == 0 && c + 1 < D.dv) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16x2(v0, v1);
      } else {
        if (c < D.dv) orow[c] = __float2bfloat16_rn(v0);
        if (c + 1 < D.dv) orow[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int DP, int DVP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, Dims D, int vec,
               cudaStream_t st) {
  constexpr int smem = mma_smem<DP, DVP>();
  auto kern = flash_mma<DP, DVP>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * D.H, (D.S + BQ - 1) / BQ);
  kern<<<grid, MTHREADS, smem, st>>>(static_cast<const __nv_bfloat16*>(q),
                                     static_cast<const __nv_bfloat16*>(k),
                                     static_cast<const __nv_bfloat16*>(v),
                                     static_cast<__nv_bfloat16*>(o), D, vec);
  return static_cast<int>(cudaGetLastError());
}

// d and dv padded to 32, 64 or 128
template <int DP>
int dispatch_dv(const void* q, const void* k, const void* v, void* o, int B, Dims D, int vec,
                cudaStream_t st) {
  if (D.dv <= 32) return launch_mma<DP, 32>(q, k, v, o, B, D, vec, st);
  if (D.dv <= 64) return launch_mma<DP, 64>(q, k, v, o, B, D, vec, st);
  return launch_mma<DP, 128>(q, k, v, o, B, D, vec, st);
}

int dispatch_mma(const void* q, const void* k, const void* v, void* o, int B, Dims D,
                 cudaStream_t st) {
  const int vec = D.d % 8 == 0 && D.dv % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  if (D.d <= 32) return dispatch_dv<32>(q, k, v, o, B, D, vec, st);
  if (D.d <= 64) return dispatch_dv<64>(q, k, v, o, B, D, vec, st);
  return dispatch_dv<128>(q, k, v, o, B, D, vec, st);
}

}  // namespace

// q, o (B, S, H, d / dv); k (B, S, KH, d); v (B, S, KH, dv); all of one type,
// f32 or bf16 (bf16 != 0), contiguous; H % KH == 0; 1 <= d, dv <= 128.
// bf16 runs flash_mma (tensor cores), f32 flash_kernel (SIMT).
// Returns the CUDA error of the launch (0 on success).
extern "C" int qgl_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int bf16, int B, int S, int H, int KH, int d, int dv,
                                   int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (d < 1 || d > 128 || dv < 1 || dv > 128 || KH < 1 || H % KH)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims D{S, H, KH, d, dv, (d + 7) / 8 * 8 + 4, 0, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_mma(q, k, v, o, B, D, st)
              : dispatch_nt<float>(q, k, v, o, B, D, st);
}
