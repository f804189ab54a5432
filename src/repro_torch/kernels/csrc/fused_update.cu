// fused_qgalore_update: one Q-GaLore weight step for one 2-D INT8 weight
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_update.py::
// fused_qgalore_update (the pl.pallas_call at fused_update.py:234), with the
// semantics of its _kernel_right / _kernel_left (fused_update.py:89-137):
//   1. f32 Adam on the low-rank gradient: m' = b1 m + (1-b1) g,
//      v' = b2 v + (1-b2) g^2, dir = (m'/bc1) / (sqrt(v'/bc2) + eps);
//   2. INT4 P unpack, (nibble - 8 - zero) * scale, asymmetric per block
//      along r, low nibble first (core/quant.py pack_int4);
//   3. back-projection U = gscale * dir @ P^T (side right: dir (M, r),
//      P (N, r)) or gscale * P @ dir (side left: P (M, r), dir (r, N));
//   4. w = deq(q), U += wd * w, w' = w - lr * U, per-256-column absmax
//      scale' = max(absmax / 127, 1e-12), q' = clip(floor(w' / scale' + u),
//      -128, 127) with the uniforms u01 drawn outside (as on the TPU).
//
// Design. Blocks run in parallel on Hopper and every block of the update
// needs the Adam direction and the dequantized P of its rows or columns,
// so two small passes run first, each writing a buffer once:
//   * qgl_adam: elementwise over the low-rank triple; writes m', v' and dir
//     to new buffers (no block recomputes Adam, none races on the moments);
//   * qgl_deq_p: unpacks P to f32, as P^T (r, N) for side right and as P
//     (M, r) for side left, so the update's factors are always A (M, r) and
//     B (r, N) row-major: right A = dir, B = P^T; left A = P, B = dir;
//   * qgl_update: one block per (32 rows x one 256-column scale group) of
//     the weight: the absmax forces a block to own whole scale groups of its
//     rows. A and B stream through shared memory in 32-deep chunks of the
//     rank (P at r = 512 is 4 MB as f32, far beyond shared memory), both
//     loaded along their rows. A warp owns 4 rows x 256 columns, so each
//     row's absmax is a warp shuffle reduction, in the epilogue.
// Arithmetic follows the reference order with explicit round-to-nearest
// intrinsics (no FMA contraction outside the product, true division; the
// requantization is int8_group.cuh's, shared with sr_requant.cu):
// codes then agree with fused_qgalore_update_ref except where the product's
// summation order moves a value across a floor boundary (one INT8 quantum).
//
// What bounds it on an H100: the rank-r product, 2*M*N*r multiply-adds
// (4.3 GFLOP at 2048 x 2048, r = 512) in float32 FMA, against ~45 MB of
// memory traffic dominated by the f32 uniforms. No tensor cores yet.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound through a plain C entry point loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_group.cuh"

namespace {

constexpr int GROUP = 256;      // weight quant block along N
constexpr int THREADS = 256;
constexpr int ROWS = 32;        // weight rows per block (4 per warp)
constexpr int RK = 32;          // rank chunk streamed through shared memory
constexpr int MAX_BLOCKS = 4096;

struct Hyper {
  float b1, omb1, b2, omb2, bc1, bc2, eps, lr, gscale, wd;
};

__global__ void qgl_adam(const float* __restrict__ g, const float* __restrict__ m,
                         const float* __restrict__ v, float* __restrict__ m_out,
                         float* __restrict__ v_out, float* __restrict__ dir,
                         size_t n, Hyper h) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float gi = g[i];
    const float mn = __fadd_rn(__fmul_rn(h.b1, m[i]), __fmul_rn(h.omb1, gi));
    const float vn = __fadd_rn(__fmul_rn(h.b2, v[i]), __fmul_rn(h.omb2, __fmul_rn(gi, gi)));
    m_out[i] = mn;
    v_out[i] = vn;
    dir[i] = __fdiv_rn(__fdiv_rn(mn, h.bc1),
                       __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, h.bc2)), h.eps));
  }
}

// P (d, R) from packed nibbles (row-major (d, R/2)) and (d, R/pblock)
// scale / zero, written as P^T (R, d) when transpose != 0 (the writes, the
// larger stream, stay contiguous either way)
__global__ void qgl_deq_p(const uint8_t* __restrict__ pq, const float* __restrict__ ps,
                          const float* __restrict__ pz, float* __restrict__ out, int d, int R,
                          int pblock, int transpose) {
  const size_t n = static_cast<size_t>(d) * R;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = transpose ? static_cast<int>(i % d) : static_cast<int>(i / R);
    const int k = transpose ? static_cast<int>(i / d) : static_cast<int>(i % R);
    const uint8_t byte = pq[static_cast<size_t>(row) * (R / 2) + k / 2];
    const int nib = (k & 1) ? (byte >> 4) : (byte & 0xF);
    const size_t s = static_cast<size_t>(row) * (R / pblock) + k / pblock;
    out[i] = __fmul_rn(__fsub_rn(static_cast<float>(nib) - 8.f, pz[s]), ps[s]);
  }
}

__global__ void __launch_bounds__(THREADS)
qgl_update(const float* __restrict__ A, const float* __restrict__ B,
           const int8_t* __restrict__ q, const float* __restrict__ ws,
           const float* __restrict__ u01, int8_t* __restrict__ q_out,
           float* __restrict__ ws_out, int M, int N, int R, Hyper h) {
  const int grp = blockIdx.x;
  const int c0 = grp * GROUP;
  const int r0 = blockIdx.y * ROWS;
  const int G = N / GROUP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __shared__ __align__(16) float As[RK][ROWS + 4];  // A chunk, rank-major (+4: bank spread)
  __shared__ __align__(16) float Bs[RK][GROUP];     // B chunk

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < R; k0 += RK) {
#pragma unroll
    for (int t = 0; t < (ROWS * RK) / THREADS; ++t) {
      const int idx = threadIdx.x + t * THREADS;
      const int i = idx / RK, kk = idx % RK;
      const int row = r0 + i, k = k0 + kk;
      As[kk][i] = (row < M && k < R) ? A[static_cast<size_t>(row) * R + k] : 0.f;
    }
#pragma unroll 4
    for (int t = 0; t < (RK * GROUP) / THREADS; ++t) {
      const int idx = threadIdx.x + t * THREADS;
      const int kk = idx / GROUP, j = idx % GROUP;
      const int k = k0 + kk;
      Bs[kk][j] = k < R ? B[static_cast<size_t>(k) * N + c0 + j] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < RK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][warp * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][lane * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][lane * 8 + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: dequantize, step, per-row absmax over the group, SR requant
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + warp * 4 + i;
    if (row >= M) continue;                        // warp-uniform
    const size_t off = static_cast<size_t>(row) * N + c0 + lane * 8;
    const float s_old = ws[static_cast<size_t>(row) * G + grp];
    const int2 raw = *reinterpret_cast<const int2*>(q + off);
    const float4 u0 = *reinterpret_cast<const float4*>(u01 + off);
    const float4 u1 = *reinterpret_cast<const float4*>(u01 + off + 4);
    const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    float code[8], wn[8];
    int8_group::unpack(raw, code);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float w = __fmul_rn(code[j], s_old);
      float upd = __fmul_rn(h.gscale, acc[i][j]);
      if (h.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(h.wd, w));
      wn[j] = __fsub_rn(w, __fmul_rn(h.lr, upd));
    }
    int2 codes;
    const float scale = int8_group::sr_requant(wn, u, &codes);
    *reinterpret_cast<int2*>(q_out + off) = codes;
    if (lane == 0) ws_out[static_cast<size_t>(row) * G + grp] = scale;
  }
}

int grid_for(size_t n) {
  const size_t blocks = (n + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

}  // namespace

// right != 0: g/m/v/dir (M, R), P (N, R/2) packed + (N, R/pblock) scale/zero;
// right == 0: g/m/v/dir (R, N), P (M, R/2) packed + (M, R/pblock) scale/zero.
// p_f32 is scratch for P as f32 ((R, N) right, (M, R) left).
// q, q_out (M, N) int8; ws, ws_out (M, N/256); u01 (M, N) f32; N % 256 == 0.
// Returns cudaGetLastError() after the three launches.
extern "C" int qgl_fused_update(const void* g, const void* m, const void* v, const void* pq,
                                const void* ps, const void* pz, const void* q, const void* ws,
                                const void* u01, void* q_out, void* ws_out, void* m_out,
                                void* v_out, void* dir, void* p_f32, int M, int N, int R,
                                int pblock, int right, float b1, float omb1, float b2,
                                float omb2, float bc1, float bc2, float eps, float lr,
                                float gscale, float wd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, omb1, b2, omb2, bc1, bc2, eps, lr, gscale, wd};
  const size_t n_low = static_cast<size_t>(right ? M : N) * R;
  auto* d = static_cast<float*>(dir);
  auto* p = static_cast<float*>(p_f32);
  qgl_adam<<<grid_for(n_low), THREADS, 0, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<float*>(m_out), static_cast<float*>(v_out), d, n_low, h);
  const int rows_p = right ? N : M;
  qgl_deq_p<<<grid_for(static_cast<size_t>(rows_p) * R), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(pq), static_cast<const float*>(ps),
      static_cast<const float*>(pz), p, rows_p, R, pblock, right);
  const dim3 grid(N / GROUP, (M + ROWS - 1) / ROWS);
  qgl_update<<<grid, THREADS, 0, st>>>(right ? d : p, right ? p : d,
                                        static_cast<const int8_t*>(q),
                                        static_cast<const float*>(ws),
                                        static_cast<const float*>(u01),
                                        static_cast<int8_t*>(q_out),
                                        static_cast<float*>(ws_out), M, N, R, h);
  return static_cast<int>(cudaGetLastError());
}
