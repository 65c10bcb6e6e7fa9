// Shared declarations of the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define WCA_EXPORT extern "C" __attribute__((visibility("default")))

namespace wca {

constexpr unsigned kFullMask = 0xffffffffu;

// Value of a load, in float.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

// Sum (or max) of v over the block; every thread gets the result. `red`
// holds one float per warp; blockDim.x is a multiple of 32.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFullMask, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // `red` may still be read from a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < n_warps ? red[lane] : (kMax ? -CUDART_INF_F : 0.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFullMask, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to the storage type T and back (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

}  // namespace wca
