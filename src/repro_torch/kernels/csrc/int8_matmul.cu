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
// Both paths run on the tensor cores (mma.sync m16n8k16 bf16 -> f32,
// csrc/mma_bf16.cuh). A block's columns lie inside one 256-column group, so
// every k row of its A operand (x * s) has the single scale s[k, g]. The
// codes arrive raw through a cp.async ring (16-byte copies, zero fill past
// the K range, rows padded by 16 bytes); ldmatrix.trans reads their byte
// pairs as b16 (code_frags): a lane gets the codes of k rows 2t, 2t+1 at
// columns 2g and 2g+1, which feed two n8 tiles (even and odd output
// columns); they become bf16 exactly in registers (s8x4_to_bf16x2), so the
// only rounding in the product is that of x * s. A lane's four accumulators
// of an (even, odd) pair are four consecutive output columns. Where x * s
// takes two passes, hi = bf16(x * s) and lo = bf16(x * s - hi) go into the
// same f32 sums; since the codes are exact in bf16 this keeps the product
// within ~2^-16 of the f32 product.
//
// Two launch designs, chosen by the wrapper's plan() from M (and K):
//
//  * decode and short prefill (M <= 16, K <= 8 * 2048): i8mm_small, bound
//    by the weight bytes (each code is read once and used M times). M is
//    padded to one m16 tile; at this intensity the padded rows cost
//    nothing, and both dtypes take the two passes (in accumulators of
//    their own), which cost nothing either. A block owns 128 columns and
//    one split of K, 8 warps as 4 column warps (32 columns each) x 2 k
//    warps (alternate 16-row steps of each 64-row k tile). The codes
//    stream through a 4-stage ring of 64-row tiles that waits for tile kt
//    itself; while the first tiles are in flight, x * s of the whole
//    split is staged once as hi and lo (the split's scales ride with tile
//    0), so the loop reads codes only.
//    K is split over the blocks of a thread-block cluster (at most 8,
//    portable), and the split partials meet in distributed shared memory:
//    each block sums its k warps, pushes each item (four columns of a row)
//    to the block that owns it with st.async, counted on that block's
//    mbarrier, and every block sums the items it owns in rank order
//    (deterministic, no atomics, no partials in device memory, one launch
//    a call). What bounds it: per call, the first bytes of a fresh weight
//    (~3-4 us after the launch) and the cluster's hand-over (~1 us); then
//    the bytes one block an SM keeps in flight (~0.45 us a 64-row tile).
//    Neither a cheaper code conversion nor none at all made it faster.
//
//  * prefill and training (M > 16, and any M past the small path's K):
//    i8mm_mma, bound by the multiply-adds.
//    A block owns a BM x 128 output tile (BM 64 or 128), 32-deep k tiles
//    through a 4-stage ring that also carries the tile's 32 scales and the
//    raw x slice of each row. A row of x need not be 16-byte aligned (K =
//    5461 in bf16): its slice is copied as the aligned chunks that cover
//    it, one chunk more than the slice, zero filled from the split's k_end
//    on; after the mma of tile kt the raw x of tile kt + 1 is scaled into
//    the other A buffer (read at the row's byte offset, a funnel shift for
//    an odd bf16 offset, multiplied by s in f32, rounded to bf16; rows
//    padded to 80 bytes). 8 warps as 2 x 4, each a (BM/2) x 32 warp tile.
//    bf16 x takes one pass: x is already bf16, and rounding x * s to bf16
//    is what the TPU's MXU does with an f32 dot_general at default
//    precision (relative error ~2^-9 a term, well inside the 2e-2
//    tolerance); f32 x takes two. What bounds it now: instruction issue
//    (mma.sync, the scaling pass and the in-register code conversion, which
//    the two warps of a column repeat); wgmma, TMA and warp specialisation
//    are a later step. When the output tiles cannot fill the card, K is
//    split over a grid axis; each split writes a float32 partial and a
//    second kernel sums them in a fixed order (deterministic, no atomics).
//
// Expert stacks (the reference's vmap of this kernel over an MoE layer's E
// experts, ops.py:368): one launch computes E independent problems x[e]
// (M, K) @ deq(q[e], scale[e]) -> out[e], all contiguous and of the same
// shape. The expert is one more grid axis: z on the small path (the
// cluster stays the K splits of one column tile of one expert), and z
// together with the K split on the tiled path (z = e * splits + split).
// Each block offsets its pointers by its expert's strides and runs the 2-D
// code unchanged, so a row of expert e is the 2-D kernel's output on
// expert e's problem, bit for bit, at the same plan.
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

// ---------------------------------------------------------------------------
// operand code shared by both paths
// ---------------------------------------------------------------------------

// B fragments of 16 k rows x 32 columns of staged codes (rows of ldb bytes
// from B): b[j] is n8 tile j, 0 and 1 the even and odd columns of the first
// 16, 2 and 3 of the next 16
__device__ __forceinline__ void code_frags(uint32_t (&b)[4][2], const int8_t* B, int ldb,
                                           int lane) {
  uint32_t raw[4];
  ldsm_x4_t(raw, B + (lane & 15) * ldb + (lane >> 4) * 16);
  s8x4_to_bf16x2(raw[0], b[0][0], b[1][0]);
  s8x4_to_bf16x2(raw[1], b[0][1], b[1][1]);
  s8x4_to_bf16x2(raw[2], b[2][0], b[3][0]);
  s8x4_to_bf16x2(raw[3], b[2][1], b[3][1]);
}

// ---------------------------------------------------------------------------
// small-M path: 128 columns x one K split a block, the splits of a column
// tile in one cluster
// ---------------------------------------------------------------------------
constexpr int SBN = 128;                      // columns a block
constexpr int SBK = 64;                       // k tile of the codes ring
constexpr int SST = 4;                        // ring stages
constexpr int SWN = SBN / 32;                 // column warps
constexpr int SWK = THREADS / 32 / SWN;       // k warps: alternate 16-row steps of a tile
constexpr int SLDB = SBN + 16;                // bytes per staged code row
constexpr int MAX_CLUSTER = 8;
constexpr int SRING = SST * SBK * SLDB;       // bytes of the codes ring
constexpr int XK = 2;                         // k a thread per batch of x * s
static_assert(SWK * 16 * SBN * 4 <= SRING, "the partials must fit in the ring");

// Shared memory of a launch, in this order: the codes ring (the k warps'
// partials go there at the end), the reduction's mbarrier (16 bytes), the
// slots the cluster's blocks push their partials into (a float4 a slot,
// splits x slots(M, splits)), hi and lo of x * s for the split (M rows of
// kc + 8 bf16), 16 zero bytes for the A rows past M, the split's scales.
struct SmallSmem {
  int per, recv, as, zero, sc, bytes;
  __host__ __device__ SmallSmem(int M, int kc, int splits) {
    per = (M * (SBN / 4) + splits - 1) / splits;   // slots a block owns
    recv = SRING + 16;
    as = recv + splits * per * 16;
    zero = as + 2 * M * (kc + 8) * 2;
    sc = zero + 16;
    bytes = sc + kc * 4;
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of `p` (this block's shared memory) in block
// `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  return addr;
}
// v into another block's shared memory, counted as 16 bytes of that
// block's mbarrier transaction (both cluster addresses)
__device__ __forceinline__ void push16(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}
// wait for phase 0 of a local mbarrier, acquiring what its arrivals released
__device__ __forceinline__ void cluster_mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
i8mm_small(const T* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, float* __restrict__ out,
           int M, int K, int N, int kc) {
  {                                             // expert blockIdx.z's problem
    const size_t e = blockIdx.z;
    x += e * M * K;
    q += e * K * N;
    scale += e * K * (N / GROUP);
    out += e * M * N;
  }
  const int split = blockIdx.x;                 // the block's rank in its cluster
  const int splits = gridDim.x;                 // the cluster's size
  const SmallSmem L(M, kc, splits);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Bs = reinterpret_cast<int8_t*>(smem);                          // [SST][SBK][SLDB]
  float* red = reinterpret_cast<float*>(smem);                           // [SWK][16][SBN]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + SRING);
  float4* recv = reinterpret_cast<float4*>(smem + L.recv);               // [splits][per]
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + L.as);     // [hi, lo][M][lda]
  __nv_bfloat16* zero = reinterpret_cast<__nv_bfloat16*>(smem + L.zero);
  float* Sc = reinterpret_cast<float*>(smem + L.sc);                     // [kc]
  const int lda = kc + 8;

  const int n0 = blockIdx.y * SBN;
  const int g = n0 / GROUP;
  const int G = N / GROUP;
  const int k_begin = split * kc;
  const int k_end = min(K, k_begin + kc);
  const int n_kt = (k_end - k_begin + SBK - 1) / SBK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % SWN, wk = warp / SWN;

  // codes tile kt into stage kt % SST: 64 rows x 8 chunks of 16, two a
  // thread, zero filled past k_end
  auto load_tile = [&](int kt) {
    const int kb = k_begin + kt * SBK;
    int8_t* dst = Bs + (kt % SST) * SBK * SLDB;
    for (int i = tid; i < SBK * SBN / 16; i += THREADS) {
      const int r = i / (SBN / 16), c = (i % (SBN / 16)) * 16;
      const bool ok = kb + r < k_end;
      cp_async16(dst + r * SLDB + c,
                 q + static_cast<size_t>(ok ? kb + r : k_begin) * N + n0 + c, ok ? 16 : 0);
    }
  };
  // the split's scales ride with tile 0, so their latency hides under the codes'
  for (int kk = tid; kk < kc; kk += THREADS) {
    const bool in = k_begin + kk < k_end;
    cp_async4(Sc + kk, scale + static_cast<size_t>(in ? k_begin + kk : 0) * G + g, in ? 4 : 0);
  }
#pragma unroll
  for (int s = 0; s < SST - 1; ++s) {
    if (s < n_kt) load_tile(s);
    cp_async_commit();
  }
  // the reduction's mbarrier: its phase completes when the cluster's blocks
  // have pushed this block's share (items split, split + splits, ...) of
  // their partials, 16 bytes an item
  if (tid == 0) {   // after the loads are on their way
    const int mine = (M * (SBN / 4) - split + splits - 1) / splits;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(mine * 16 * splits) : "memory");
  }

  cluster_arrive();                // every block's mbarrier is initialised (waited for at the end)

  // x * s of the split as hi and lo, XK k a thread a batch (the M rows of
  // each); the first batch's x is read before the scales have landed
  for (int k0 = 0; k0 < kc; k0 += XK * THREADS) {
    float v[XK][16];
#pragma unroll
    for (int j = 0; j < XK; ++j) {
      const int k = k_begin + k0 + j * THREADS + tid;
      const bool in = k0 + j * THREADS + tid < kc && k < k_end;
#pragma unroll
      for (int m = 0; m < 16; ++m)
        v[j][m] = in && m < M ? to_f32(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    if (k0 == 0) {
      cp_async_wait<SST - 2>();    // tile 0 and the scales have landed ...
      __syncthreads();             // ... for every thread
    }
#pragma unroll
    for (int j = 0; j < XK; ++j) {
      const int kk = k0 + j * THREADS + tid;
      if (kk < kc) {
        const float sk = Sc[kk];
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          if (m < M) {
            const float xs = v[j][m] * sk;
            const __nv_bfloat16 hi = __float2bfloat16_rn(xs);
            As[m * lda + kk] = hi;
            As[(M + m) * lda + kk] = __float2bfloat16_rn(xs - __bfloat162float(hi));
          }
        }
      }
    }
  }
  if (tid < 8) zero[tid] = __float2bfloat16_rn(0.f);

  // the hi and lo passes into accumulators of their own (two dependency
  // chains), added at the end
  float acc[2][4][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;

  // a lane's A row for ldmatrix: row lane & 15 of the pass, or the zero
  // chunk past M
  const int ar = lane & 15;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<SST - 2>();      // tile kt has landed ...
    __syncthreads();               // ... for every thread; tile kt - 1 is consumed, A stored
    if (kt + SST - 1 < n_kt) load_tile(kt + SST - 1);
    cp_async_commit();
    const int8_t* Bb = Bs + (kt % SST) * SBK * SLDB;
#pragma unroll
    for (int kk = wk * 16; kk < SBK; kk += SWK * 16) {
      uint32_t b[4][2];
      code_frags(b, Bb + kk * SLDB + wn * 32, SLDB, lane);
      const int col = kt * SBK + kk + (lane >> 4) * 8;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t a[4];
        ldsm_x4(a, ar < M ? As + (p * M + ar) * lda + col : zero);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[p][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free for the partials
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] += acc[1][j][e];

  // a lane holds, for rows g and g + 8, the columns 4t..4t+3 of each 16
  const int r = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = wn * 32 + h * 16 + (lane & 3) * 4;
    const float(&a)[4][4] = acc[0];
    if (r < M)
      *reinterpret_cast<float4*>(red + (wk * 16 + r) * SBN + c) =
          make_float4(a[2 * h][0], a[2 * h + 1][0], a[2 * h][1], a[2 * h + 1][1]);
    if (r + 8 < M)
      *reinterpret_cast<float4*>(red + (wk * 16 + r + 8) * SBN + c) =
          make_float4(a[2 * h][2], a[2 * h + 1][2], a[2 * h][3], a[2 * h + 1][3]);
  }
  __syncthreads();

  // Push: item e (four columns of row e / 32) belongs to block e % splits;
  // this block's sum of its k warps goes to that block's slot [split][e /
  // splits], completing 16 bytes of that block's mbarrier transaction.
  cluster_wait();
  for (int e = tid; e < M * (SBN / 4); e += THREADS) {
    const int m = e / (SBN / 4), c = (e % (SBN / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(red + m * SBN + c);
#pragma unroll
    for (int w = 1; w < SWK; ++w) {
      const float4 u = *reinterpret_cast<const float4*>(red + (w * 16 + m) * SBN + c);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    const int owner = e % splits;
    push16(cluster_addr(recv + split * L.per + e / splits, owner), v, cluster_addr(bar, owner));
  }

  // every block's share has arrived: sum it in rank order
  cluster_mbar_wait(bar);
  for (int i = tid; i < L.per; i += THREADS) {
    const int e = i * splits + split;
    if (e >= M * (SBN / 4)) break;
    float4 sum = recv[i];
    for (int rk = 1; rk < splits; ++rk) {
      const float4 u = recv[rk * L.per + i];
      sum.x += u.x; sum.y += u.y; sum.z += u.z; sum.w += u.w;
    }
    const int m = e / (SBN / 4), c = (e % (SBN / 4)) * 4;
    *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * N + n0 + c) = sum;
  }
}

// ---------------------------------------------------------------------------
// tiled path: BM x 128 output tile per block on the tensor cores, K split
// (and the expert) over blockIdx.z
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
  // z = expert * splits + split; split s of every expert writes partial s
  // of the whole (E, M, N) output
  const int splits = (K + kc - 1) / kc;
  const int e = blockIdx.z / splits, split = blockIdx.z % splits;
  const int n_exp = gridDim.z / splits;
  x += static_cast<size_t>(e) * M * K;
  q += static_cast<size_t>(e) * K * N;
  scale += static_cast<size_t>(e) * K * (N / GROUP);
  const int k_begin = split * kc;
  const int k_end = min(K, k_begin + kc);
  const int n_kt = (k_end - k_begin + TBK - 1) / TBK;
  float* dst = out + (static_cast<size_t>(split) * n_exp + e) * M * N;
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
      // codes of k rows kk..kk+15 at the warp's 32 columns
      uint32_t b[4][2];
      code_frags(b, Bb + kk * LDB + wn * 32, LDB, lane);
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
cudaError_t launch_small(const T* x, const int8_t* q, const float* s, float* o, int E, int M,
                         int K, int N, int kc, int splits, cudaStream_t st) {
  if (M == 0 || E == 0) return cudaSuccess;   // no rows: nothing to write
  if (M < 0 || M > 16 || kc % SBK || splits < 1 || splits > MAX_CLUSTER || E < 0 || E > 65535)
    return cudaErrorInvalidValue;
  const int smem = SmallSmem(M, kc, splits).bytes;
  auto kern = i8mm_small<T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, N / SBN, E);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, x, q, s, o, M, K, N, kc);
}

template <typename T, int BM_>
cudaError_t launch_mma(const T* x, const int8_t* q, const float* s, float* o, int E, int M,
                       int K, int N, int kc, int splits, cudaStream_t st) {
  if (M == 0 || E == 0) return cudaSuccess;
  if (M < 0 || E < 0 || static_cast<long long>(E) * splits > 65535 ||
      (M + BM_ - 1) / BM_ > 65535 || (K + kc - 1) / kc != splits)
    return cudaErrorInvalidValue;
  constexpr int smem = Tiled<T, BM_>::SMEM;
  auto kern = i8mm_mma<T, BM_>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(N / TBN, (M + BM_ - 1) / BM_, E * splits);
  kern<<<grid, THREADS, smem, st>>>(x, q, s, o, M, K, N, kc);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_tiled(const T* x, const int8_t* q, const float* s, float* o, int E, int M,
                         int K, int N, int bm, int kc, int splits, cudaStream_t st) {
  if (bm == 64) return launch_mma<T, 64>(x, q, s, o, E, M, K, N, kc, splits, st);
  if (bm == 128) return launch_mma<T, 128>(x, q, s, o, E, M, K, N, kc, splits, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// E problems x (E, M, K) @ deq(q (E, K, N), scale (E, K, N/256)) -> out
// (E, M, N), each contiguous. path 0: small-M (M <= 16; kc a multiple of
// 64; splits = the blocks of a cluster, 1..8, reduced in distributed shared
// memory; m_tile and ws unused); path 1: tiled (m_tile = the block's rows,
// 64 or 128; kc a multiple of 32, splits = ceil(K / kc); with splits > 1
// the partials go to ws, splits * E * M * N floats, and a second kernel
// sums them into out). q 16-byte aligned. Returns the launch's error, or
// cudaGetLastError() after the launches.
extern "C" int qgl_int8_matmul_batched(const void* x, int x_bf16, const void* q,
                                       const void* scale, void* out, void* ws, int E, int M,
                                       int K, int N, int path, int m_tile, int kc, int splits,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  if (path == 0) {
    const cudaError_t err =
        x_bf16 ? launch_small(static_cast<const __nv_bfloat16*>(x), qc, sc,
                              static_cast<float*>(out), E, M, K, N, kc, splits, st)
               : launch_small(static_cast<const float*>(x), qc, sc, static_cast<float*>(out),
                              E, M, K, N, kc, splits, st);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  float* dst = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(out);
  const cudaError_t err =
      x_bf16 ? launch_tiled(static_cast<const __nv_bfloat16*>(x), qc, sc, dst, E, M, K, N,
                            m_tile, kc, splits, st)
             : launch_tiled(static_cast<const float*>(x), qc, sc, dst, E, M, K, N, m_tile,
                            kc, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1 && M > 0 && E > 0)
    splitk::launch(static_cast<const float*>(ws), static_cast<float*>(out), splits,
                   static_cast<size_t>(E) * M * N, st);
  return static_cast<int>(cudaGetLastError());
}

// One problem: x (M, K) @ deq(q (K, N), scale (K, N/256)) -> out (M, N),
// the batched entry at E = 1.
extern "C" int qgl_int8_matmul(const void* x, int x_bf16, const void* q, const void* scale,
                               void* out, void* ws, int M, int K, int N, int path,
                               int m_tile, int kc, int splits, void* stream) {
  return qgl_int8_matmul_batched(x, x_bf16, q, scale, out, ws, 1, M, K, N, path, m_tile, kc,
                                 splits, stream);
}
