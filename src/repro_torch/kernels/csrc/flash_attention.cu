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
// Both dtypes run the FlashAttention-2 shape on the tensor cores (mma.sync
// m16n8k16 bf16 -> f32, csrc/mma_bf16.cuh): each warp owns 16 query rows,
// the heaviest causal query tiles go first, and 64-row K and V tiles stream
// through shared memory (rows padded by 16 bytes, so ldmatrix is conflict
// free; d and dv padded to 32, 64 or 128 with zeros, which add nothing).
// S = Q K^T comes out of mma in f32 registers; it is scaled by 1/sqrt(d)
// there (not on q, so nothing rounds twice) and by log2(e), so the online
// softmax runs on exp2f; the row max and denominator are quad shuffles. P
// is repacked to bf16 in registers and used directly as the A operand of
// P V (the m16n8 accumulator layout is the m16n8k16 A layout); V's B
// fragments come from ldmatrix.trans. The two kernels:
//
//  * bf16 (every serving bundle): flash_mma, 4 warps a 64-row query tile.
//    The Q tile is loaded once and kept in registers as A fragments; K and
//    V go through a cp.async double-buffered ring. What bounds it: at S 512
//    the bytes of q, k, v and o and the per-tile softmax; at long S the mma
//    issue rate (wgmma, TMA and warp specialisation are a later step).
//
//  * f32 (the f32 bundles of models.model_zoo, the parity phases and
//    tests): flash_f32, 8 warps a 128-row query tile, split precision so
//    that f32 callers keep f32 accuracy. Every f32 operand x becomes hi =
//    bf16(x) and lo = bf16(x - hi), and each product takes three passes
//    into the same f32 sums, S = Qh Kh^T + Qh Kl^T + Ql Kh^T and O += Ph Vh
//    + Ph Vl + Pl Vh; the dropped lo.lo term is ~2^-16 relative. Q is split
//    once into registers (read straight from device memory); each K and V
//    tile lands as f32 (16-byte cp.async for rows of a multiple of 4 floats
//    on 16-byte aligned tensors, else 4-byte cp.async) and is split once in
//    shared memory for all 8 warps, while the next tile is in flight; P is
//    split in registers. A warp whose 16 rows lie wholly above a causal
//    tile, or past S, skips it. What bounds it: mma.sync issue (three
//    passes) and the split pass of each tile.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int BKV = 64;             // KV rows per tile
constexpr float NEG_INF = -1e30f;   // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

struct Dims {
  int S, H, KH, d, dv;
  int causal;
  float scale;  // 1 / sqrt(d)
};

// ---------------------------------------------------------------------------
// warp-level pieces shared by both kernels (one warp, 16 query rows, a
// 64-row KV tile; lane = 4g + t)
// ---------------------------------------------------------------------------

// K B fragments of KV rows np*16..np*16+15 at the d columns kd*16..kd*16+15
// of a staged (64, LDQ) bf16 tile: kb[0], kb[1] for the first 8 rows, kb[2],
// kb[3] for the next 8
template <int LDQ>
__device__ __forceinline__ void k_frags(uint32_t (&kb)[4], const bf16* Kt, int np, int kd,
                                        int lane) {
  ldsm_x4(kb, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDQ + kd * 16 +
                  ((lane >> 3) & 1) * 8);
}

// V B fragments of KV rows kc*16..kc*16+15 at the dv columns vp*16.. of a
// staged (64, LDV) bf16 tile: vb[0], vb[1] for the first 8 columns, vb[2],
// vb[3] for the next 8
template <int LDV>
__device__ __forceinline__ void v_frags(uint32_t (&vb)[4], const bf16* Vt, int kc, int vp,
                                        int lane) {
  ldsm_x4_t(vb, Vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV + vp * 16 +
                    (lane >> 4) * 8);
}

// The scores s of rows row0.. against KV columns kv0..kv0+63, scaled to the
// log2 domain (sl2 = scale * log2 e), masked where `masked` says a tile
// needs it, and folded into the running max m_r and this lane's share of
// the denominator l_r; acc is rescaled, and s becomes exp2(x - max).
template <int NV>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&acc)[NV][4],
                                               float (&m_r)[2], float (&l_r)[2], float sl2,
                                               bool masked, int kv0, int row0, const Dims& D,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * sl2;
      if (masked) {
        const int col = kv0 + n * 8 + 2 * t + (e & 1);
        const int row = row0 + g + (e >> 1) * 8;
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
}

// acc / max(l, 1e-30) of rows row0.. into o (rows < S, columns < dv)
template <typename T, int NV>
__device__ __forceinline__ void store_rows(T* __restrict__ o, const float (&acc)[NV][4],
                                           const float (&l_r)[2], int b, int h, int row0,
                                           const Dims& D, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int s_ = row0 + g + 8 * r;
    if (s_ >= D.S) continue;
    T* orow = o + ((static_cast<size_t>(b) * D.S + s_) * D.H + h) * D.dv;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int c = n * 8 + 2 * t;
      const float v0 = acc[n][2 * r] / den, v1 = acc[n][2 * r + 1] / den;
      if constexpr (sizeof(T) == 4) {
        if (D.dv % 2 == 0 && c + 1 < D.dv) {
          *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
        } else {
          if (c < D.dv) orow[c] = v0;
          if (c + 1 < D.dv) orow[c + 1] = v1;
        }
      } else if (D.dv % 2 == 0 && c + 1 < D.dv) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16x2(v0, v1);
      } else {
        if (c < D.dv) orow[c] = __float2bfloat16_rn(v0);
        if (c + 1 < D.dv) orow[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: one pass
// ---------------------------------------------------------------------------
constexpr int BQ = 64;              // query rows per block
constexpr int MTHREADS = 128;       // 4 warps, 16 query rows each
static_assert(BQ == BKV, "the causal tile count assumes square tiles");

// 64 rows x `width` elements of a (B, S, heads, width) bf16 tensor from row
// s0 of head `head` into a (64, LD) tile. vec: width % 8 == 0 and 16-byte
// aligned bases, so 16-byte cp.async copies with zero fill past S (the
// columns from width to W hold zeros, written once by zero_pad); otherwise
// element by element, zeros past S and past width.
template <int W, int LD>
__device__ __forceinline__ void load_rows(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                          int b, int s0, int head, int heads, int width, int S,
                                          bool vec) {
  if (vec) {
    const int chunks = width / 8;
    for (int i = threadIdx.x; i < 64 * chunks; i += MTHREADS) {
      const int r = i / chunks, c = i % chunks;
      const int s = s0 + r;
      const bool ok = s < S;
      cp_async16(dst + r * LD + c * 8,
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
__device__ __forceinline__ void zero_pad(bf16* dst, int rows, int width) {
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
flash_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          bf16* __restrict__ o, Dims D, int vec) {
  constexpr int LDQ = DP + 8, LDV = DVP + 8;   // bf16 elements per staged row
  constexpr int KD = DP / 16, NV = DVP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LDQ
  bf16* Ks = Qs + BQ * LDQ;                      // 2 x BKV x LDQ
  bf16* Vs = Ks + 2 * BKV * LDQ;                 // 2 x BKV x LDV

  const int bh = blockIdx.x;
  const int b = bh / D.H, h = bh % D.H;
  const int kh = h / (D.H / D.KH);
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

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
    const bf16* Kt = Ks + st * BKV * LDQ;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        k_frags<LDQ>(kb, Kt, np, kd, lane);
        mma_bf16_16816(s[2 * np], qf[kd], kb[0], kb[1]);
        mma_bf16_16816(s[2 * np + 1], qf[kd], kb[2], kb[3]);
      }
    }

    const int kv0 = j * BKV;
    const bool masked = kv0 + BKV > D.S || (D.causal && kv0 + BKV - 1 > q0);
    online_softmax(s, acc, m_r, l_r, sl2, masked, kv0, q0 + warp * 16, D, lane);

    // acc += P V, P repacked to bf16 A fragments in registers
    const bf16* Vt = Vs + st * BKV * LDV;
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
        v_frags<LDV>(vb, Vt, kc, vp, lane);
        mma_bf16_16816(acc[2 * vp], pa, vb[0], vb[1]);
        mma_bf16_16816(acc[2 * vp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();               // stage st is consumed before it is refilled
  }
  cp_async_wait<0>();
  store_rows(o, acc, l_r, b, h, q0 + warp * 16, D, lane);
}

// ---------------------------------------------------------------------------
// f32: three passes on split operands
// ---------------------------------------------------------------------------
constexpr int FQ = 128;             // query rows per block
constexpr int FTHREADS = 256;       // 8 warps, 16 query rows each

// 64 rows x `width` floats of a (B, S, heads, width) f32 tensor from row s0
// of head `head` into a (64, W) tile. vec: width % 4 == 0 and a 16-byte
// aligned base, so 16-byte cp.async copies with zero fill past S (the
// columns from width to W hold zeros, written once); otherwise 4-byte
// cp.async copies with zero fill past S and past width.
template <int W>
__device__ __forceinline__ void load_raw(float* __restrict__ dst, const float* __restrict__ src,
                                         int b, int s0, int head, int heads, int width, int S,
                                         bool vec) {
  if (vec) {
    const int chunks = width / 4;
    for (int i = threadIdx.x; i < 64 * chunks; i += FTHREADS) {
      const int r = i / chunks, c = i % chunks;
      const int s = s0 + r;
      const bool ok = s < S;
      cp_async16(dst + r * W + c * 4,
                 src + ((static_cast<size_t>(b) * S + (ok ? s : 0)) * heads + head) * width + c * 4,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * W; i += FTHREADS) {
      const int r = i / W, c = i % W;
      const int s = s0 + r;
      const bool ok = s < S && c < width;
      cp_async4(dst + i,
                ok ? src + ((static_cast<size_t>(b) * S + s) * heads + head) * width + c : src,
                ok ? 4 : 0);
    }
  }
}

// hi = bf16(x) and lo = bf16(x - hi) of a landed (64, W) f32 tile into the
// (64, LD) bf16 tiles hi and lo, four values an item
template <int W, int LD>
__device__ __forceinline__ void split_tile(bf16* __restrict__ hi, bf16* __restrict__ lo,
                                           const float* __restrict__ raw) {
  for (int i = threadIdx.x; i < 64 * W / 4; i += FTHREADS) {
    const int r = i / (W / 4), c = (i % (W / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * W + c);
    uint32_t h0, h1, l0, l1;
    split_bf16x2(x.x, x.y, h0, l0);
    split_bf16x2(x.z, x.w, h1, l1);
    *reinterpret_cast<uint2*>(hi + r * LD + c) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo + r * LD + c) = make_uint2(l0, l1);
  }
}

template <int DP, int DVP>
constexpr int f32_smem() {
  return BKV * (DP + DVP) * 4                                  // the landed f32 K and V tiles
         + 2 * BKV * (DP + 8) * 2 + 2 * BKV * (DVP + 8) * 2;  // hi and lo of each
}

template <int DP, int DVP>
__global__ void __launch_bounds__(FTHREADS)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, Dims D, int vec) {
  constexpr int LDQ = DP + 8, LDV = DVP + 8;   // bf16 elements per split row
  constexpr int KD = DP / 16, NV = DVP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Kr = reinterpret_cast<float*>(smem_raw);   // BKV x DP
  float* Vr = Kr + BKV * DP;                        // BKV x DVP
  bf16* Ks = reinterpret_cast<bf16*>(Vr + BKV * DVP);  // [hi, lo] x BKV x LDQ
  bf16* Vs = Ks + 2 * BKV * LDQ;                        // [hi, lo] x BKV x LDV

  const int bh = blockIdx.x;
  const int b = bh / D.H, h = bh % D.H;
  const int kh = h / (D.H / D.KH);
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tiles first
  const int q0 = qt * FQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;             // the warp's first query row

  if (vec) {   // the columns past d and dv, which the 16-byte copies leave alone
    for (int i = threadIdx.x; i < BKV * (DP - D.d); i += FTHREADS)
      Kr[(i / (DP - D.d)) * DP + D.d + i % (DP - D.d)] = 0.f;
    for (int i = threadIdx.x; i < BKV * (DVP - D.dv); i += FTHREADS)
      Vr[(i / (DVP - D.dv)) * DVP + D.dv + i % (DVP - D.dv)] = 0.f;
  }
  load_raw<DP>(Kr, k, b, 0, kh, D.KH, D.d, D.S, vec);
  load_raw<DVP>(Vr, v, b, 0, kh, D.KH, D.dv, D.S, vec);
  cp_async_commit();

  // Q as hi and lo A fragments, straight from device memory:
  // a0 = (row g, cols 2t, 2t+1), a1 = (row g + 8, ...), a2, a3 = cols + 8
  uint32_t qh[KD][4], ql[KD][4];
  {
    auto at = [&](int r, int c) {
      const int s_ = row0 + r;
      return s_ < D.S && c < D.d
          ? q[((static_cast<size_t>(b) * D.S + s_) * D.H + h) * D.d + c] : 0.f;
    };
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + (i & 1) * 8, c = kd * 16 + 2 * t + (i >> 1) * 8;
        split_bf16x2(at(r, c), at(r, c + 1), qh[kd][i], ql[kd][i]);
      }
  }

  const int n_kv = (D.S + BKV - 1) / BKV;
  const int n_iter = D.causal ? min((q0 + FQ + BKV - 1) / BKV, n_kv) : n_kv;
  const float sl2 = D.scale * LOG2E;
  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const bf16 *Kh = Ks, *Kl = Ks + BKV * LDQ, *Vh = Vs, *Vl = Vs + BKV * LDV;

  for (int j = 0; j < n_iter; ++j) {
    cp_async_wait<0>();            // tile j has landed ...
    __syncthreads();               // ... for every thread, and tile j - 1 is consumed
    split_tile<DP, LDQ>(Ks, Ks + BKV * LDQ, Kr);
    split_tile<DVP, LDV>(Vs, Vs + BKV * LDV, Vr);
    __syncthreads();               // the split tiles are stored, the f32 ones free
    if (j + 1 < n_iter) {
      load_raw<DP>(Kr, k, b, (j + 1) * BKV, kh, D.KH, D.d, D.S, vec);
      load_raw<DVP>(Vr, v, b, (j + 1) * BKV, kh, D.KH, D.dv, D.S, vec);
    }
    cp_async_commit();

    const int kv0 = j * BKV;
    if (row0 >= D.S || (D.causal && kv0 > row0 + 15)) continue;   // nothing for this warp

    // S = Qh Kh^T + Qh Kl^T + Ql Kh^T
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kbh[4], kbl[4];
        k_frags<LDQ>(kbh, Kh, np, kd, lane);
        k_frags<LDQ>(kbl, Kl, np, kd, lane);
        mma_bf16_16816(s[2 * np], qh[kd], kbh[0], kbh[1]);
        mma_bf16_16816(s[2 * np + 1], qh[kd], kbh[2], kbh[3]);
        mma_bf16_16816(s[2 * np], qh[kd], kbl[0], kbl[1]);
        mma_bf16_16816(s[2 * np + 1], qh[kd], kbl[2], kbl[3]);
        mma_bf16_16816(s[2 * np], ql[kd], kbh[0], kbh[1]);
        mma_bf16_16816(s[2 * np + 1], ql[kd], kbh[2], kbh[3]);
      }
    }

    const bool masked = kv0 + BKV > D.S || (D.causal && kv0 + BKV - 1 > row0);
    online_softmax(s, acc, m_r, l_r, sl2, masked, kv0, row0, D, lane);

    // O += Ph Vh + Ph Vl + Pl Vh, P split in registers
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int vp = 0; vp < DVP / 16; ++vp) {
        uint32_t vbh[4], vbl[4];
        v_frags<LDV>(vbh, Vh, kc, vp, lane);
        v_frags<LDV>(vbl, Vl, kc, vp, lane);
        mma_bf16_16816(acc[2 * vp], ph, vbh[0], vbh[1]);
        mma_bf16_16816(acc[2 * vp + 1], ph, vbh[2], vbh[3]);
        mma_bf16_16816(acc[2 * vp], ph, vbl[0], vbl[1]);
        mma_bf16_16816(acc[2 * vp + 1], ph, vbl[2], vbl[3]);
        mma_bf16_16816(acc[2 * vp], pl, vbh[0], vbh[1]);
        mma_bf16_16816(acc[2 * vp + 1], pl, vbh[2], vbh[3]);
      }
    }
  }
  cp_async_wait<0>();
  store_rows(o, acc, l_r, b, h, row0, D, lane);
}

// ---------------------------------------------------------------------------
// launches: d and dv padded to 32, 64 or 128
// ---------------------------------------------------------------------------
template <int DP, int DVP>
constexpr auto kernel_for(float) { return flash_f32<DP, DVP>; }
template <int DP, int DVP>
constexpr auto kernel_for(bf16) { return flash_mma<DP, DVP>; }

template <typename T, int DP, int DVP>
int launch(const void* q, const void* k, const void* v, void* o, int B, Dims D, int vec,
           cudaStream_t st) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int smem = F32 ? f32_smem<DP, DVP>() : mma_smem<DP, DVP>();
  constexpr int rows = F32 ? FQ : BQ;
  auto kern = kernel_for<DP, DVP>(T{});
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * D.H, (D.S + rows - 1) / rows);
  kern<<<grid, F32 ? FTHREADS : MTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), D, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int dispatch_dv(const void* q, const void* k, const void* v, void* o, int B, Dims D, int vec,
                cudaStream_t st) {
  if (D.dv <= 32) return launch<T, DP, 32>(q, k, v, o, B, D, vec, st);
  if (D.dv <= 64) return launch<T, DP, 64>(q, k, v, o, B, D, vec, st);
  return launch<T, DP, 128>(q, k, v, o, B, D, vec, st);
}

// vec: rows of whole 16-byte chunks on 16-byte aligned tensors (the f32
// kernel reads q straight into registers, so only k and v count for it)
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, Dims D,
             cudaStream_t st) {
  constexpr int per16 = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                         (sizeof(T) == 4 ? 0 : reinterpret_cast<uintptr_t>(q));
  const int vec = D.d % per16 == 0 && D.dv % per16 == 0 && addr % 16 == 0;
  if (D.d <= 32) return dispatch_dv<T, 32>(q, k, v, o, B, D, vec, st);
  if (D.d <= 64) return dispatch_dv<T, 64>(q, k, v, o, B, D, vec, st);
  return dispatch_dv<T, 128>(q, k, v, o, B, D, vec, st);
}

}  // namespace

// q, o (B, S, H, d / dv); k (B, S, KH, d); v (B, S, KH, dv); all of one type,
// f32 or bf16 (bf16 != 0), contiguous; H % KH == 0; 1 <= d, dv <= 128.
// bf16 runs flash_mma (one pass), f32 flash_f32 (three passes on split
// operands), both on the tensor cores.
// Returns the CUDA error of the launch (0 on success).
extern "C" int qgl_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int bf16_in, int B, int S, int H, int KH, int d, int dv,
                                   int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (d < 1 || d > 128 || dv < 1 || dv > 128 || KH < 1 || H % KH)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims D{S, H, KH, d, dv, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_in ? dispatch<bf16>(q, k, v, o, B, D, st) : dispatch<float>(q, k, v, o, B, D, st);
}
