// int8_group.cuh: the per-group INT8 epilogue shared by fused_update.cu,
// sr_requant.cu and blockwise_quant.cu.
//
// One warp holds one row's 256-column scale group, 8 consecutive values a
// lane. The group's absmax is a warp shuffle reduction; the scale is
// max(absmax / 127, 1e-12) by a true division; each value becomes a code by
// stochastic rounding, clip(floor(w / s + u), -128, 127), or by rounding to
// nearest, half to even, clip(rint(w / s), -128, 127). Every operation is an
// explicit round-to-nearest intrinsic, so no FMA contraction or reciprocal
// moves a value across a floor or a rounding boundary: the codes are those
// of the plain versions (kernels/ref.py) on the same inputs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int8_group {

constexpr int GROUP = 256;  // quant block along the last axis
constexpr int PER_LANE = GROUP / 32;

// The group's scale from each lane's partial absmax (every lane of the
// warp must call it).
__device__ __forceinline__ float scale_of(float amax) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

__device__ __forceinline__ float lane_absmax(const float (&w)[PER_LANE]) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) amax = fmaxf(amax, fabsf(w[j]));
  return amax;
}

// 8 codes (already integers in [-128, 127]) as 8 bytes, lowest index first
__device__ __forceinline__ int2 pack(const float (&c)[PER_LANE]) {
  unsigned packed[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    packed[j >> 2] |= (static_cast<unsigned>(static_cast<int>(c[j])) & 0xFFu) << (8 * (j & 3));
  return make_int2(static_cast<int>(packed[0]), static_cast<int>(packed[1]));
}

// 8 int8 codes from 8 bytes, lowest index first, as floats
__device__ __forceinline__ void unpack(int2 raw, float (&c)[PER_LANE]) {
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int word = j < 4 ? raw.x : raw.y;
    c[j] = static_cast<float>(
        static_cast<int>(static_cast<unsigned>(word) << (24 - 8 * (j & 3))) >> 24);
  }
}

// Stochastic rounding of the group: returns the new scale, the lane's
// 8 codes packed.
__device__ __forceinline__ float sr_requant(const float (&w)[PER_LANE],
                                            const float (&u)[PER_LANE], int2* codes) {
  const float scale = scale_of(lane_absmax(w));
  float c[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    c[j] = fminf(fmaxf(floorf(__fadd_rn(__fdiv_rn(w[j], scale), u[j])), -128.f), 127.f);
  *codes = pack(c);
  return scale;
}

// Round to nearest, half to even: returns the scale, the lane's codes packed.
__device__ __forceinline__ float rn_quant(const float (&x)[PER_LANE], int2* codes) {
  const float scale = scale_of(lane_absmax(x));
  float c[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    c[j] = fminf(fmaxf(rintf(__fdiv_rn(x[j], scale)), -128.f), 127.f);
  *codes = pack(c);
  return scale;
}

}  // namespace int8_group
