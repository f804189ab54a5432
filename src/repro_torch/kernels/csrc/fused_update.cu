// fused_qgalore_update: one Q-GaLore weight step for one 2-D INT8 weight
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_update.py::
// fused_qgalore_update (the pl.pallas_call at fused_update.py:234), with the
// semantics of its _kernel_right / _kernel_left (fused_update.py:89-137):
//   1. f32 Adam on the low-rank gradient: m' = b1 m + (1-b1) g,
//      v' = b2 v + (1-b2) g^2, dir = (m'/bc1) / (sqrt(v'/bc2) + eps);
//   2. INT4 P, P[d, k] = (u'[d, k] - z[d, b]) * s[d, b] with u' = nibble - 8,
//      asymmetric per block b of pblock ranks, low nibble first
//      (core/quant.py pack_int4);
//   3. back-projection U = gscale * dir @ P^T (side right: dir (M, r),
//      P (N, r)) or gscale * P @ dir (side left: P (M, r), dir (r, N));
//   4. w = deq(q), U += wd * w, w' = w - lr * U, per-256-column absmax
//      scale' = max(absmax / 127, 1e-12), q' = clip(floor(w' / scale' + u),
//      -128, 127) with the uniforms u01 drawn outside (as on the TPU).
//
// What bounds it on an H100: the traffic, ~47 MB at 2048 x 2048, r = 512
// (the f32 uniforms and the codes in and out, ~25 MB; the f32 low-rank
// triple in and the moments out, ~21 MB), once the rank-r product (2 * M *
// N * r = 4.3 GFLOP) runs on the tensor cores: mma.sync m16n8k16 bf16 with
// f32 sums (csrc/mma_bf16.cuh), while the kernel streams the rest. Two
// launches:
//  * qgl_adam_{right,left}: Adam, elementwise, in the reference's rounding
//    (explicit _rn intrinsics, true division), so m' and v' equal the
//    plain version's. It writes the direction as two bf16 arrays, hi =
//    bf16(dir) and lo = bf16(dir - hi), in the layout the product reads
//    (each block of the rank padded with zeros to a multiple of 32), and
//    the direction's block sums S_b = sum_{k in b} dir in f32.
//  * qgl_update: one block per 64 weight rows x one 256-column scale group
//    (the absmax needs the whole group). P is read packed, 4 bits a rank,
//    and enters the mma as the exact u', converted in registers
//    (nibbles_to_bf16x2). Each product of u' with hi or lo is exact in
//    f32, so dir takes two passes into the same sums. The scale and zero
//    point vary along the contraction, once a block of the rank, so they
//    are an epilogue a block: part = sum_{k in b} dir * u' in f32, then
//    acc += s_b * (part - z_b * S_b), with s_b, z_b those of the output
//    column (right) or row (left). The contraction runs in the permuted
//    order in which one ldmatrix of packed P rows hands a lane the ranks
//    8t..8t+7 of its row (two k16 steps), so the direction is read in the
//    same order: right, as 16-byte loads of 8 ranks of a row; left, staged
//    with its rows permuted and read with ldmatrix.trans. The operands
//    stream through a cp.async ring (4 stages right, 3 left). Before the
//    product starts, the tile's codes and f32 uniforms go into shared
//    memory as bulk copies on an mbarrier, so the epilogue does not wait
//    on them. The epilogue stages U through shared memory into one warp a
//    row, 8 values a lane, and requantizes with int8_group.cuh (the code
//    of sr_requant.cu): codes agree with fused_qgalore_update_ref except
//    where the product's summation order moves a value across a floor
//    boundary (one INT8 quantum).
// Warps: 8, each 32 along the direction's axis x 64 along P's rows
// (right: 2 x 4 warps of 32 rows x 64 columns; left: 1 x 8 of 64 x 32).
// Shapes: M ragged (rows masked); N % 256 == 0 (padded columns have zero P
// scale and zero point, so they stay zero); R and pblock even with
// R % pblock == 0; P is copied 16 bytes at a time when R and pblock are
// multiples of 32 and P is 16-byte aligned, else a byte at a time.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_group.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int GROUP = 256;      // weight quant block along N: a tile's columns
constexpr int THREADS = 256;
constexpr int BM = 64;          // weight rows a tile
constexpr int TBK = 32;         // ranks a step
constexpr int LDD = GROUP + 8;  // bf16 a staged left-side direction row (ldmatrix.trans conflict free)
constexpr int LDU = GROUP + 8;  // f32 a staged U row (fragment stores conflict free)
constexpr int EPI_ROW = GROUP * 4 + GROUP;  // bytes of uniforms and codes a weight row

struct Hyper {
  float b1, omb1, b2, omb2, bc1, bc2, eps, lr, gscale, wd;
};

// ---------------------------------------------------------------------------
// Adam, and the direction as hi / lo bf16 with its block sums
// ---------------------------------------------------------------------------

__device__ __forceinline__ float adam(const float* __restrict__ g, const float* __restrict__ m,
                                      const float* __restrict__ v, float* __restrict__ m_out,
                                      float* __restrict__ v_out, size_t i, const Hyper& h) {
  const float gi = g[i];
  const float mn = __fadd_rn(__fmul_rn(h.b1, m[i]), __fmul_rn(h.omb1, gi));
  const float vn = __fadd_rn(__fmul_rn(h.b2, v[i]), __fmul_rn(h.omb2, __fmul_rn(gi, gi)));
  m_out[i] = mn;
  v_out[i] = vn;
  return __fdiv_rn(__fdiv_rn(mn, h.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, h.bc2)), h.eps));
}

// dir - hi is exact in f32, so hi + lo carries 16 significant bits of dir
__device__ __forceinline__ void store_split(__nv_bfloat16* __restrict__ dh,
                                            __nv_bfloat16* __restrict__ dl, size_t i, float d) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(d);
  dh[i] = hi;
  dl[i] = __float2bfloat16_rn(__fsub_rn(d, __bfloat162float(hi)));
}

// side right: g/m/v (M, R); dh, dl (M, nb * kb); dsum (M, nb). One warp per
// (row, block of the rank).
__global__ void qgl_adam_right(const float* __restrict__ g, const float* __restrict__ m,
                               const float* __restrict__ v, float* __restrict__ m_out,
                               float* __restrict__ v_out, __nv_bfloat16* __restrict__ dh,
                               __nv_bfloat16* __restrict__ dl, float* __restrict__ dsum, int M,
                               int R, int pblock, int kb, Hyper h) {
  const int nb = R / pblock;
  const size_t unit = (blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (unit >= static_cast<size_t>(M) * nb) return;   // warp-uniform
  const size_t row = unit / nb;
  const int b = static_cast<int>(unit % nb);
  const size_t src = row * R + static_cast<size_t>(b) * pblock;
  const size_t dst = row * nb * kb + static_cast<size_t>(b) * kb;
  float s = 0.f;
  for (int j = lane; j < kb; j += 32) {
    const float d = j < pblock ? adam(g, m, v, m_out, v_out, src + j, h) : 0.f;
    store_split(dh, dl, dst + j, d);
    s += d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) dsum[unit] = s;
}

// side left: g/m/v (R, N); dh, dl (nb * kb, N); dsum (nb, N). A block owns
// 32 columns of one block of the rank, 8 slices of its rows.
__global__ void qgl_adam_left(const float* __restrict__ g, const float* __restrict__ m,
                              const float* __restrict__ v, float* __restrict__ m_out,
                              float* __restrict__ v_out, __nv_bfloat16* __restrict__ dh,
                              __nv_bfloat16* __restrict__ dl, float* __restrict__ dsum, int N,
                              int pblock, int kb, Hyper h) {
  __shared__ float part[8][33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int b = blockIdx.y;
  float s = 0.f;
  for (int j = slice; j < kb; j += 8) {
    const float d = j < pblock ? adam(g, m, v, m_out, v_out,
                                      static_cast<size_t>(b * pblock + j) * N + col, h)
                               : 0.f;
    store_split(dh, dl, static_cast<size_t>(b * kb + j) * N + col, d);
    s += d;
  }
  part[slice][lane] = s;
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int i = 1; i < 8; ++i) s += part[i][lane];
    dsum[static_cast<size_t>(b) * N + col] = s;
  }
}

// ---------------------------------------------------------------------------
// The mbarrier and the bulk copies of the epilogue's inputs
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for the completion of the phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) global -> shared,
// completing on bar
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// ---------------------------------------------------------------------------
// The update
// ---------------------------------------------------------------------------

template <bool RIGHT>
struct Cfg {
  static constexpr int STAGES = RIGHT ? 4 : 3;
  static constexpr int LP = RIGHT ? GROUP : BM;   // P rows a tile: its columns (right), rows (left)
  static constexpr int LDIR = RIGHT ? BM : GROUP; // the direction's rows (right) or columns (left)
  static constexpr int DS = RIGHT ? BM * TBK * 2 : TBK * LDD * 2;  // bytes of a hi or lo tile
  static constexpr int PS = LP * (TBK / 2);                        // bytes of a packed P tile
  static constexpr int STAGE = 2 * DS + PS;                        // [hi][lo][P]
  static constexpr int RING = STAGES * STAGE;
  static constexpr int UT = BM * LDU * 4;                          // U, after the ring is done
  static constexpr int U01 = RING > UT ? RING : UT;                // uniforms [BM][GROUP] f32
  static constexpr int Q = U01 + BM * GROUP * 4;                   // codes [BM][GROUP]
  static constexpr int WS = Q + BM * GROUP;                        // old scales [BM]
  static constexpr int BAR = WS + BM * 4;                          // the mbarrier
  static constexpr int PAR = BAR + 16;   // P's scale and zero [nb][LP], then S [nb][LDIR]
  static int smem(int nb) { return PAR + nb * (2 * LP + LDIR) * 4; }
};

template <bool RIGHT>
__global__ void __launch_bounds__(THREADS, 1)
qgl_update(const __nv_bfloat16* __restrict__ dh, const __nv_bfloat16* __restrict__ dl,
           const float* __restrict__ dsum, const uint8_t* __restrict__ pq,
           const float* __restrict__ ps, const float* __restrict__ pz,
           const int8_t* __restrict__ q, const float* __restrict__ ws,
           const float* __restrict__ u01, int8_t* __restrict__ q_out,
           float* __restrict__ ws_out, int M, int N, int R, int pblock, int kb, Hyper h) {
  using C = Cfg<RIGHT>;
  constexpr int S_ = C::STAGES;
  constexpr int MI = RIGHT ? 2 : 4;     // m16 tiles a warp
  constexpr int NJ = RIGHT ? 8 : 4;     // n8 tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* Us = reinterpret_cast<float*>(smem);
  float* Uf = reinterpret_cast<float*>(smem + C::U01);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem + C::Q);
  float* Ws = reinterpret_cast<float*>(smem + C::WS);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::BAR);
  const int nb = R / pblock;
  float* Sp = reinterpret_cast<float*>(smem + C::PAR);   // [nb][LP]
  float* Zp = Sp + nb * C::LP;                            // [nb][LP]
  float* Sd = Zp + nb * C::LP;                            // [nb][LDIR]

  const int grp = blockIdx.x, c0 = grp * GROUP;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const int G = N / GROUP;
  const int spb = kb / TBK, n_steps = nb * spb;
  const int RP = nb * kb;               // the padded rank of dh, dl
  const int Rh = R / 2;
  const bool p_vec = R % TBK == 0 && pblock % TBK == 0 &&
                     (reinterpret_cast<uintptr_t>(pq) & 15) == 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rw = RIGHT ? (warp >> 2) * 32 : 0;           // the warp's first row
  const int cw = RIGHT ? (warp & 3) * 64 : warp * 32;    // ... first column

  // the epilogue's codes and uniforms, one bulk copy each a row
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) mbar_expect_tx(bar, rows * EPI_ROW);
    __syncwarp();
    for (int r = lane; r < rows; r += 32) {
      const size_t off = static_cast<size_t>(m0 + r) * N + c0;
      bulk_g2s(Uf + r * GROUP, u01 + off, GROUP * 4, bar);
      bulk_g2s(Qs + r * GROUP, q + off, GROUP, bar);
    }
  }

  // with step 0: the old scales, P's scales and zeros and the direction's
  // block sums of the tile (zero past M)
  auto load_params = [&]() {
    if (tid < BM) {
      const bool ok = tid < rows;
      cp_async4(Ws + tid, ok ? ws + static_cast<size_t>(m0 + tid) * G + grp : ws, ok ? 4 : 0);
    }
    if constexpr (RIGHT) {
      for (int i = tid; i < nb * GROUP; i += THREADS) {
        const size_t src = static_cast<size_t>(c0 + i % GROUP) * nb + i / GROUP;
        cp_async4(Sp + i, ps + src, 4);
        cp_async4(Zp + i, pz + src, 4);
      }
      for (int i = tid; i < nb * BM; i += THREADS) {
        const int r = i % BM;
        const bool ok = r < rows;
        cp_async4(Sd + i, ok ? dsum + static_cast<size_t>(m0 + r) * nb + i / BM : dsum,
                  ok ? 4 : 0);
      }
    } else {
      for (int i = tid; i < nb * BM; i += THREADS) {
        const int r = i % BM;
        const bool ok = r < rows;
        const size_t src = static_cast<size_t>(m0 + r) * nb + i / BM;
        cp_async4(Sp + i, ok ? ps + src : ps, ok ? 4 : 0);
        cp_async4(Zp + i, ok ? pz + src : pz, ok ? 4 : 0);
      }
      for (int i = tid; i < nb * GROUP / 4; i += THREADS) {
        const int b = i / (GROUP / 4), c = 4 * (i % (GROUP / 4));
        cp_async16(Sd + b * GROUP + c, dsum + static_cast<size_t>(b) * N + c0 + c, 16);
      }
    }
  };

  // step st (block st / spb of the rank, its chunk st % spb) into stage st % S_
  auto load_step = [&](int st) {
    unsigned char* base = smem + (st % S_) * C::STAGE;
    __nv_bfloat16* Dh = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* Dl = reinterpret_cast<__nv_bfloat16*>(base + C::DS);
    uint8_t* Pt = base + 2 * C::DS;
    const int b = st / spb, c = st % spb;
    const int kd = b * kb + c * TBK;        // the step's first rank in dh, dl
    const int kp = b * pblock + c * TBK;    // ... in P
    if constexpr (RIGHT) {
      // 64 rows x 32 ranks, hi then lo, 4 chunks of 16 bytes a row
#pragma unroll
      for (int i = tid; i < 2 * BM * 4; i += THREADS) {
        const int hl = i / (BM * 4), r = (i / 4) % BM, ch = i % 4;
        const bool ok = r < rows;
        const __nv_bfloat16* src =
            (hl ? dl : dh) + static_cast<size_t>(m0 + (ok ? r : 0)) * RP + kd + 8 * ch;
        cp_async16((hl ? Dl : Dh) + r * TBK + 8 * ch, src, ok ? 16 : 0);
      }
    } else {
      // 32 ranks x 256 columns, hi then lo; rank kk = 8t + 4s + 2h + e of
      // the step goes to row 16s + 8h + 2t + e, so that ldmatrix.trans of
      // rows 16s + 8h .. + 7 gives lane (g, t) the ranks of its fragment
#pragma unroll
      for (int i = tid; i < 2 * TBK * 32; i += THREADS) {
        const int hl = i / (TBK * 32), kk = (i / 32) % TBK, ch = i % 32;
        const int row = (((kk >> 2) & 1) << 4) | (((kk >> 1) & 1) << 3) | ((kk >> 3) << 1) |
                        (kk & 1);
        const __nv_bfloat16* src = (hl ? dl : dh) + static_cast<size_t>(kd + kk) * N + c0 + 8 * ch;
        cp_async16((hl ? Dl : Dh) + row * LDD + 8 * ch, src, 16);
      }
    }
    // packed P: LP rows x 16 bytes (32 ranks); the direction is zero past
    // the block, so what P holds there does not matter
    const int prow0 = RIGHT ? c0 : m0, prows = RIGHT ? GROUP : rows;
    for (int r = tid; r < C::LP; r += THREADS) {
      uint8_t* dst = Pt + r * 16;
      const uint8_t* src = pq + static_cast<size_t>(prow0 + (r < prows ? r : 0)) * Rh + kp / 2;
      if (p_vec) {
        cp_async16(dst, src, r < prows ? 16 : 0);
      } else {
        const int end = (b + 1) * pblock / 2 - kp / 2;   // bytes left in the block
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)     // 0x88: both nibbles 8, u' = 0
          w[j >> 2] |= static_cast<uint32_t>(r < prows && j < end ? src[j] : 0x88) << (8 * (j & 3));
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  float acc[MI][NJ][4], part[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = part[mi][j][e] = 0.f;

  // the block's scale epilogue: acc += s_b * (part - z_b * S_b)
  auto fold = [&](int b) {
    const float* sp = Sp + b * C::LP;
    const float* zp = Zp + b * C::LP;
    const float* sd = Sd + b * C::LDIR;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rw + 16 * mi + gq + 8 * (e >> 1);
          const int c = cw + 8 * j + 2 * tq + (e & 1);
          const int ip = RIGHT ? c : r, id = RIGHT ? r : c;
          acc[mi][j][e] = fmaf(sp[ip], part[mi][j][e] - zp[ip] * sd[id], acc[mi][j][e]);
          part[mi][j][e] = 0.f;
        }
  };

  load_params();
#pragma unroll
  for (int s = 0; s < S_ - 1; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }

  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<S_ - 2>();    // step st has landed
    __syncthreads();            // ... for every thread; step st - 1 is consumed
    if (st + S_ - 1 < n_steps) load_step(st + S_ - 1);
    cp_async_commit();
    const unsigned char* base = smem + (st % S_) * C::STAGE;
    const __nv_bfloat16* Dh = reinterpret_cast<const __nv_bfloat16*>(base);
    const __nv_bfloat16* Dl = reinterpret_cast<const __nv_bfloat16*>(base + C::DS);
    const uint8_t* Pt = base + 2 * C::DS;
    if constexpr (RIGHT) {
      // B = P^T: lane l addresses P row cw + 32 jq + l, so matrix i is n8
      // tile 4 jq + i and lane (g, t) holds bytes 4t..4t+3 (ranks
      // 8t..8t+7) of column g: b0, b1 of the two k16 steps
      uint32_t bw[NJ][4];
#pragma unroll
      for (int jq = 0; jq < NJ / 4; ++jq) {
        uint32_t raw[4];
        ldsm_x4(raw, Pt + (cw + 32 * jq + lane) * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t x = raw[i], x4 = x >> 4;
#pragma unroll
          for (int e = 0; e < 4; ++e) bw[4 * jq + i][e] = nibbles_to_bf16x2(x, x4, e);
        }
      }
      // A = dir: lane (g, t) reads ranks 8t..8t+7 of rows g and g + 8
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = rw + 16 * mi + gq;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const __nv_bfloat16* D = p ? Dl : Dh;
          const uint4 v0 = *reinterpret_cast<const uint4*>(D + r * TBK + 8 * tq);
          const uint4 v8 = *reinterpret_cast<const uint4*>(D + (r + 8) * TBK + 8 * tq);
          const uint32_t a0[4] = {v0.x, v8.x, v0.y, v8.y};   // ranks 8t .. 8t + 3
          const uint32_t a1[4] = {v0.z, v8.z, v0.w, v8.w};   // ranks 8t + 4 .. 8t + 7
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            mma_bf16_16816(part[mi][j], a0, bw[j][0], bw[j][1]);
            mma_bf16_16816(part[mi][j], a1, bw[j][2], bw[j][3]);
          }
        }
      }
    } else {
      // A = P: lane l addresses P row 32 mq + l, so matrices 2h, 2h + 1 are
      // rows g and g + 8 of m16 tile 2 mq + h, bytes 4t..4t+3 of each
      uint32_t aw[MI][2][4];
#pragma unroll
      for (int mq = 0; mq < MI / 2; ++mq) {
        uint32_t raw[4];
        ldsm_x4(raw, Pt + (32 * mq + lane) * 16);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t x = raw[2 * hh], x4 = x >> 4, y = raw[2 * hh + 1], y4 = y >> 4;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            aw[2 * mq + hh][s][0] = nibbles_to_bf16x2(x, x4, 2 * s);
            aw[2 * mq + hh][s][1] = nibbles_to_bf16x2(y, y4, 2 * s);
            aw[2 * mq + hh][s][2] = nibbles_to_bf16x2(x, x4, 2 * s + 1);
            aw[2 * mq + hh][s][3] = nibbles_to_bf16x2(y, y4, 2 * s + 1);
          }
        }
      }
      // B = dir, rows permuted at staging: k16 step s is rows 16s .. 16s + 15
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const __nv_bfloat16* D = p ? Dl : Dh;
          uint32_t bf[NJ][2];
#pragma unroll
          for (int jp = 0; jp < NJ / 2; ++jp) {
            uint32_t r4[4];
            ldsm_x4_t(r4, D + (16 * s + (lane & 7) + ((lane >> 3) & 1) * 8) * LDD + cw +
                              16 * jp + (lane >> 4) * 8);
            bf[2 * jp][0] = r4[0];
            bf[2 * jp][1] = r4[1];
            bf[2 * jp + 1][0] = r4[2];
            bf[2 * jp + 1][1] = r4[3];
          }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int j = 0; j < NJ; ++j) mma_bf16_16816(part[mi][j], aw[mi][s], bf[j][0], bf[j][1]);
        }
      }
    }
    if (st % spb == spb - 1) fold(st / spb);
  }
  cp_async_wait<0>();
  __syncthreads();              // every warp is done with the ring, which U overlays

  // U into shared memory: lane (g, t) holds rows g, g + 8 and columns 2t,
  // 2t + 1 of each m16 x n8 tile
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = rw + 16 * mi + gq, c = cw + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(Us + r * LDU + c) = make_float2(acc[mi][j][0], acc[mi][j][1]);
      *reinterpret_cast<float2*>(Us + (r + 8) * LDU + c) =
          make_float2(acc[mi][j][2], acc[mi][j][3]);
    }
  mbar_wait(bar, 0);            // the codes and uniforms have landed
  __syncthreads();

  // one warp a row, 8 columns a lane: dequantize, step, SR requantize
  for (int r = warp; r < rows; r += THREADS / 32) {
    const float4 ua = *reinterpret_cast<const float4*>(Us + r * LDU + 8 * lane);
    const float4 ub = *reinterpret_cast<const float4*>(Us + r * LDU + 8 * lane + 4);
    const float4 u0 = *reinterpret_cast<const float4*>(Uf + r * GROUP + 8 * lane);
    const float4 u1 = *reinterpret_cast<const float4*>(Uf + r * GROUP + 8 * lane + 4);
    const int2 raw = *reinterpret_cast<const int2*>(Qs + r * GROUP + 8 * lane);
    const float s_old = Ws[r];
    const float U[8] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
    const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    float code[8], wn[8];
    int8_group::unpack(raw, code);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float w = __fmul_rn(code[j], s_old);
      float upd = __fmul_rn(h.gscale, U[j]);
      if (h.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(h.wd, w));
      wn[j] = __fsub_rn(w, __fmul_rn(h.lr, upd));
    }
    int2 codes;
    const float scale = int8_group::sr_requant(wn, u, &codes);
    const size_t row = static_cast<size_t>(m0 + r);
    *reinterpret_cast<int2*>(q_out + row * N + c0 + 8 * lane) = codes;
    if (lane == 0) ws_out[row * G + grp] = scale;
  }
}

template <bool RIGHT>
cudaError_t launch_update(const __nv_bfloat16* dh, const __nv_bfloat16* dl, const float* dsum,
                          const uint8_t* pq, const float* ps, const float* pz, const int8_t* q,
                          const float* ws, const float* u01, int8_t* q_out, float* ws_out, int M,
                          int N, int R, int pblock, int kb, const Hyper& h, cudaStream_t st) {
  const int smem = Cfg<RIGHT>::smem(R / pblock);
  auto kern = qgl_update<RIGHT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / GROUP, (M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, st>>>(dh, dl, dsum, pq, ps, pz, q, ws, u01, q_out, ws_out, M, N, R,
                                    pblock, kb, h);
  return cudaSuccess;
}

}  // namespace

// The ranks of one block of P as the product reads them: pblock rounded up
// to a multiple of 32 (the wrapper sizes dh and dl by it).
extern "C" int qgl_fused_update_block_ranks(int pblock) {
  return (pblock + TBK - 1) / TBK * TBK;
}

// right != 0: g/m/v (M, R), P (N, R/2) packed + (N, R/pblock) scale/zero,
//   dh/dl (M, nb * kb) bf16, dsum (M, nb) f32;
// right == 0: g/m/v (R, N), P (M, R/2) packed + (M, R/pblock) scale/zero,
//   dh/dl (nb * kb, N) bf16, dsum (nb, N) f32;
// with nb = R / pblock and kb = qgl_fused_update_block_ranks(pblock).
// q, q_out (M, N) int8; ws, ws_out (M, N/256); u01 (M, N) f32; N % 256 == 0;
// q and u01 16-byte aligned; R, pblock even. Returns cudaGetLastError()
// after the two launches.
extern "C" int qgl_fused_update(const void* g, const void* m, const void* v, const void* pq,
                                const void* ps, const void* pz, const void* q, const void* ws,
                                const void* u01, void* q_out, void* ws_out, void* m_out,
                                void* v_out, void* dh, void* dl, void* dsum, int M, int N, int R,
                                int pblock, int right, float b1, float omb1, float b2,
                                float omb2, float bc1, float bc2, float eps, float lr,
                                float gscale, float wd, void* stream) {
  if (M <= 0 || N <= 0 || R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, omb1, b2, omb2, bc1, bc2, eps, lr, gscale, wd};
  const int nb = R / pblock, kb = qgl_fused_update_block_ranks(pblock);
  auto* gf = static_cast<const float*>(g);
  auto* mf = static_cast<const float*>(m);
  auto* vf = static_cast<const float*>(v);
  auto* mo = static_cast<float*>(m_out);
  auto* vo = static_cast<float*>(v_out);
  auto* hi = static_cast<__nv_bfloat16*>(dh);
  auto* lo = static_cast<__nv_bfloat16*>(dl);
  auto* sum = static_cast<float*>(dsum);
  if (right) {
    const size_t threads = static_cast<size_t>(M) * nb * 32;
    qgl_adam_right<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
        gf, mf, vf, mo, vo, hi, lo, sum, M, R, pblock, kb, h);
  } else {
    qgl_adam_left<<<dim3(N / 32, nb), 256, 0, st>>>(gf, mf, vf, mo, vo, hi, lo, sum, N, pblock,
                                                     kb, h);
  }
  auto* pqc = static_cast<const uint8_t*>(pq);
  auto* psf = static_cast<const float*>(ps);
  auto* pzf = static_cast<const float*>(pz);
  auto* qc = static_cast<const int8_t*>(q);
  auto* wsf = static_cast<const float*>(ws);
  auto* uf = static_cast<const float*>(u01);
  auto* qo = static_cast<int8_t*>(q_out);
  auto* wo = static_cast<float*>(ws_out);
  const cudaError_t err =
      right ? launch_update<true>(hi, lo, sum, pqc, psf, pzf, qc, wsf, uf, qo, wo, M, N, R,
                                  pblock, kb, h, st)
            : launch_update<false>(hi, lo, sum, pqc, psf, pzf, qc, wsf, uf, qo, wo, M, N, R,
                                   pblock, kb, h, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
