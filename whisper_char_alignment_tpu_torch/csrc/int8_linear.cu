// The two fused passes around the int8 encoder linear's int8 x int8 -> int32
// product: a per-row activation quantize before it and a float epilogue
// after it.
//
// Replaces: no Pallas kernel. The JAX package computes its int8 linear
//   (whisper_char_alignment_tpu/models/whisper.py, _linear_int8 with
//   _int8_rowwise) in XLA, which fuses the quantize (abs, row max, scale,
//   divide, round, clip, convert) into one pass and the epilogue (convert,
//   two products, convert, bias) into another. Run as separate PyTorch
//   operations they move ~45 bytes per input element and ~38 per output
//   element; these kernels move each once. The product itself stays the
//   library int8 GEMM (torch._int_mm, cuBLASLt), as JAX leaves it to XLA.
//
// What bounds them on an H100: bytes. The quantize reads the (M, K) row
//   block once (bf16 or f32) and writes int8 codes and one f32 scale a row;
//   the epilogue reads the (M, N) int32 product once and writes (M, N) in the
//   compute dtype. At Whisper-medium, B=8 (M = 12,000), the six linears of a
//   layer move ~1.4 GB through them (0.43 ms at 3.35 TB/s).
//
// Numbers: both are bit-equal to their plain versions in
//   ops/int8_cuda.py. The row scale is amax * f32(1/127) (how XLA compiles
//   amax / 127), 1 where amax is 0; codes are rint(x / scale) with an IEEE
//   division, clipped to [-127, 127]. The epilogue is JAX's _linear_int8 as
//   XLA compiles it: in bf16, ((float(y) * xs) * s) rounded to bf16, then +
//   bias in bf16 (float add, one rounding); in f32 the last product and the
//   bias add are one fused multiply-add, fma(float(y) * xs, s, bias), as XLA
//   contracts them. Every other product and sum is an explicit _rn
//   intrinsic, so nvcc contracts nothing else, and the build has no
//   fast-math.
//
// Design: the quantize gives each row a block whose threads hold the row in
//   registers (up to kMaxVec vectors of 8 values a thread, one 16-byte load
//   per vector for bf16, two for f32), take the row max by warp shuffles and
//   one value per warp through shared memory, then store 8 codes a thread as
//   one 8-byte write. A row-split tensor-parallel layer passes the row max
//   all-reduced over its model group (amax_in), so the codes are the slice
//   of the whole row's. The epilogue gives each row one block (or a few,
//   for N above 1024), each thread 4 consecutive columns: one 16-byte int32
//   load, one 16- or 8-byte store.
#include "common.cuh"

namespace {

constexpr int kMaxVec = 4;        // 8-value vectors a quantize thread holds
constexpr int kMaxThreads = 256;  // quantize threads a row
constexpr int kEpiThreads = 256;
constexpr float kRecip127 = 1.0f / 127.0f;  // rounded to f32 at compile time

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ int code_of(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    int8_quant_kernel(const T* __restrict__ x, const float* __restrict__ amax_in,
                      int8_t* __restrict__ codes, float* __restrict__ scales,
                      int k) {
  const int row = blockIdx.x;
  const int n_vec = k / 8;
  const T* xr = x + (size_t)row * k;
  float v[kMaxVec][8];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < n_vec) {
      load8(xr + (size_t)i * 8, v[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[j][e]));
    }
  }
  __shared__ float red[kMaxThreads / 32];
  float amax;
  if (amax_in != nullptr) {
    amax = amax_in[row];
  } else {
    amax = wca::block_reduce<true>(m, red);
  }
  const float scale = amax == 0.f ? 1.f : __fmul_rn(amax, kRecip127);
  if (threadIdx.x == 0) scales[row] = scale;
  int8_t* cr = codes + (size_t)row * k;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < n_vec) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= (uint32_t)(code_of(v[j][e], scale) & 0xff) << (8 * e);
        hi |= (uint32_t)(code_of(v[j][e + 4], scale) & 0xff) << (8 * e);
      }
      *reinterpret_cast<uint2*>(cr + (size_t)i * 8) = make_uint2(lo, hi);
    }
  }
}

// t = float(y) * xs (rounded); the epilogue multiplies t by s, and in f32
// fuses the bias add into that product.
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&t)[4],
                                       const float4 s, const T* bias, int c);

template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&t)[4],
                                              const float4 s,
                                              const float* bias, int c) {
  float4 r;
  if (bias != nullptr) {
    const float4 b = *reinterpret_cast<const float4*>(bias + c);
    r = make_float4(__fmaf_rn(t[0], s.x, b.x), __fmaf_rn(t[1], s.y, b.y),
                    __fmaf_rn(t[2], s.z, b.z), __fmaf_rn(t[3], s.w, b.w));
  } else {
    r = make_float4(__fmul_rn(t[0], s.x), __fmul_rn(t[1], s.y),
                    __fmul_rn(t[2], s.z), __fmul_rn(t[3], s.w));
  }
  *reinterpret_cast<float4*>(p) = r;
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(
    __nv_bfloat16* p, const float (&t)[4], const float4 s,
    const __nv_bfloat16* bias, int c) {
  __nv_bfloat16 r[4];
  r[0] = __float2bfloat16_rn(__fmul_rn(t[0], s.x));
  r[1] = __float2bfloat16_rn(__fmul_rn(t[1], s.y));
  r[2] = __float2bfloat16_rn(__fmul_rn(t[2], s.z));
  r[3] = __float2bfloat16_rn(__fmul_rn(t[3], s.w));
  if (bias != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r[e]),
                                           __bfloat162float(bias[c + e])));
  }
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(r);
}

template <typename T>
__global__ void __launch_bounds__(kEpiThreads)
    int8_dequant_kernel(const int* __restrict__ y, const float* __restrict__ xs,
                        const float* __restrict__ s, const T* __restrict__ bias,
                        T* __restrict__ out, int n) {
  const int row = blockIdx.x;
  const int c = 4 * (blockIdx.y * kEpiThreads + threadIdx.x);
  if (c >= n) return;
  const size_t off = (size_t)row * n + c;
  const int4 yv = *reinterpret_cast<const int4*>(y + off);
  const float4 sv = *reinterpret_cast<const float4*>(s + c);
  const float xr = xs[row];
  const float t[4] = {__fmul_rn(__int2float_rn(yv.x), xr),
                      __fmul_rn(__int2float_rn(yv.y), xr),
                      __fmul_rn(__int2float_rn(yv.z), xr),
                      __fmul_rn(__int2float_rn(yv.w), xr)};
  store4<T>(out + off, t, sv, bias, c);
}

}  // namespace

// x (M, K) bf16 (is_bf16) or f32; amax_in (M,) f32 or null (then each row's
// max |x| is taken here); codes (M, K) int8; scales (M,) f32. K % 8 == 0,
// K <= 8 * kMaxVec * kMaxThreads; x 16-byte aligned.
WCA_EXPORT int wca_int8_quant(const void* x, const void* amax_in, void* codes,
                              void* scales, int m, int k, int is_bf16,
                              void* stream) {
  if (m <= 0 || k <= 0 || k % 8 != 0 || k > 8 * kMaxVec * kMaxThreads)
    return cudaErrorInvalidValue;
  // one vector a thread up to 256 vectors (K = 2048), then up to kMaxVec
  const int threads = min(kMaxThreads, (k / 8 + 31) / 32 * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(amax_in);
  auto* c = static_cast<int8_t*>(codes);
  auto* sc = static_cast<float*>(scales);
  if (is_bf16)
    int8_quant_kernel<__nv_bfloat16><<<m, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), a, c, sc, k);
  else
    int8_quant_kernel<float><<<m, threads, 0, s>>>(
        static_cast<const float*>(x), a, c, sc, k);
  return cudaGetLastError();
}

// y (M, N) int32; xs (M,) f32; s (N,) f32; bias (N,) in the output dtype or
// null; out (M, N) bf16 (is_bf16) or f32. N % 4 == 0; y, s, bias, out
// 16-byte aligned.
WCA_EXPORT int wca_int8_dequant(const void* y, const void* xs, const void* s,
                                const void* bias, void* out, int m, int n,
                                int is_bf16, void* stream) {
  if (m <= 0 || n <= 0 || n % 4 != 0) return cudaErrorInvalidValue;
  dim3 grid(m, (n / 4 + kEpiThreads - 1) / kEpiThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* yy = static_cast<const int*>(y);
  const auto* x = static_cast<const float*>(xs);
  const auto* sc = static_cast<const float*>(s);
  if (is_bf16)
    int8_dequant_kernel<__nv_bfloat16><<<grid, kEpiThreads, 0, st>>>(
        yy, x, sc, static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), n);
  else
    int8_dequant_kernel<float><<<grid, kEpiThreads, 0, st>>>(
        yy, x, sc, static_cast<const float*>(bias), static_cast<float*>(out),
        n);
  return cudaGetLastError();
}
