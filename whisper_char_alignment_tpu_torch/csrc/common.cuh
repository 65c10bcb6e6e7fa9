// Shared declarations of the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#define WCA_EXPORT extern "C" __attribute__((visibility("default")))

namespace wca {

constexpr unsigned kFullMask = 0xffffffffu;

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

// Asynchronous copy of kBytes (4, 8 or 16) from global to shared memory
// (cp.async): the first src_bytes are read, the rest of the destination is
// zero-filled, so src_bytes = 0 reads nothing and writes zeros. Both
// addresses must be aligned to kBytes.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(kBytes), "r"(src_bytes)
                 : "memory");
}

// cp_async with a width known only at run time (16, 8 or 4 bytes).
__device__ __forceinline__ void cp_async_w(void* smem, const void* gmem,
                                           int width, int src_bytes) {
  if (width == 16)
    cp_async<16>(smem, gmem, src_bytes);
  else if (width == 8)
    cp_async<8>(smem, gmem, src_bytes);
  else
    cp_async<4>(smem, gmem, src_bytes);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Let kKernel take `smem` bytes of dynamic shared memory. The attribute is
// set once per kernel and size in a process (cudaFuncSetAttribute would
// cost host time on every decode step otherwise); raced calls only set it
// twice.
template <auto kKernel>
cudaError_t allow_smem(size_t smem) {
  static std::atomic<size_t> allowed{0};
  if (smem <= allowed.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed.store(smem, std::memory_order_relaxed);
  return err;
}

// Widest copy (16, 8 or 4 bytes; else `elem`, one element at a time) that
// keeps every row start of a row-major panel with rows of row_bytes aligned,
// given a 16-byte aligned base.
inline int copy_width(long long row_bytes, int elem) {
  for (int w = 16; w >= 4; w /= 2)
    if (row_bytes % w == 0) return w;
  return elem;
}

}  // namespace wca
