// flash_attention: o = softmax(q k^T / sqrt(d)) v, causal or full, native GQA
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (the pl.pallas_call at flash_attention.py:77), with the
// semantics of its _kernel (flash_attention.py:23-62): q is scaled by
// 1/sqrt(d) in f32 before the dot; the KV blocks are walked with the online
// softmax recurrence, keeping a running (max, denominator, accumulator) in
// f32; KV blocks strictly above the diagonal are skipped; the output is
// acc / max(l, 1e-30), cast to q's type.
//
// Differences from the TPU kernel, none of them numeric:
//   * GQA is native: query head h reads kv head h / (H / KH), so K and V are
//     never repeated in memory (the TPU kernel takes them repeated);
//   * any S: the last query and KV tiles are ragged and masked (the TPU
//     kernel needs S divisible by its blocks);
//   * the layouts stay (B, S, H, d): a block computes its own strides.
//
// Design. One block of 256 threads per (batch x head, 64-row query tile),
// heaviest (last) causal tiles scheduled first. The scaled Q tile and each
// 64-row K and V tile are staged in shared memory as f32 (K and Q rows padded
// so that 16-byte loads of eight lanes hit 32 distinct banks). Warp w owns
// query rows 8w..8w+7: a lane computes the scores of those rows against KV
// columns lane and lane + 32, reduces the row max and sum with warp shuffles,
// writes its probabilities to the warp's rows of a shared P tile, and
// accumulates P V for value columns lane + 32 t. Everything is f32 FMA on
// the SIMT units; mma.sync / wgmma and TMA are a later step.
//
// What bounds it on an H100: with f32 FMA, the multiply-adds, 2 * B * H *
// S (S + 1) / 2 * (d + dv) for causal attention (8.6 GFLOP at B 8, H 32,
// S 512, d = dv = 64); the card's own least time is the 67 MB of q, k, v and
// o in bf16 (0.020 ms at 3.35 TB/s; the products take 0.009 ms at the bf16
// tensor-core peak).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;              // query rows per block
constexpr int BKV = 64;             // KV rows per tile (two per lane)
constexpr int RW = BQ / WARPS;      // query rows per warp
constexpr float NEG_INF = -1e30f;   // the TPU kernel's mask value
static_assert(BQ == BKV, "the causal tile count and load_tile assume square tiles");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
      v = to_f32(src[((static_cast<size_t>(b) * S + s) * heads + head) * width + c]);
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
      if (c < D.dv) store(orow + c, __fdiv_rn(acc[r][t], den));
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

}  // namespace

// q, o (B, S, H, d / dv); k (B, S, KH, d); v (B, S, KH, dv); all of one type,
// f32 or bf16 (bf16 != 0), contiguous; H % KH == 0; 1 <= d, dv <= 128.
// Returns the CUDA error of the launch (0 on success).
extern "C" int qgl_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int bf16, int B, int S, int H, int KH, int d, int dv,
                                   int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (d < 1 || d > 128 || dv < 1 || dv > 128 || KH < 1 || H % KH)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims D{S, H, KH, d, dv, (d + 7) / 8 * 8 + 4, 0, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_nt<__nv_bfloat16>(q, k, v, o, B, D, st)
              : dispatch_nt<float>(q, k, v, o, B, D, st);
}
