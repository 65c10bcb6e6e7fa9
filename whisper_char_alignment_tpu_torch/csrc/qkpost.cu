// Fused cross-attention QK post-process: median filter -> scaled f32 softmax
// -> masks, one block per (item, head, tile of kRows token rows).
//
// Replaces: whisper_char_alignment_tpu/ops/qkpost_pallas.py,
//   qk_postprocess_fused (its _kernel). Same function, in order: a width-w
//   median along frames on the raw logits, with windows reflected at frame 0
//   and at the item's last valid frame m = frame_len - 1 (inputs pass through
//   unfiltered when frame_len <= w/2); x qk_scale; frames > m -> -inf; an f32
//   softmax over frames; token rows >= token_len -> 0.
//
// What bounds it on an H100: bytes. One read and one write of the
//   (B, H, T, F) f32 logits (147 MB at B=8, H=16, T=96, F=1500: 44 us at
//   3.35 TB/s); a w <= 15 median is a few comparisons per element.
//
// Design: each row of F logits is staged once in shared memory; each thread
//   takes columns c = tid, tid + 256, ... and builds its window with the
//   reflection applied directly at 0 and at m, then takes the median with an
//   odd-even transposition network in registers (the compare-exchange order
//   of ops/medfilt._median_of; a median is a selection by comparison, so
//   every exact method gives the same value). The TPU kernel's base pass plus
//   edge correction exists only because Mosaic has no arbitrary-lane load;
//   shared memory has one, so a single pass gives the same medians. The row's
//   max and sum are block-wide f32 reductions (warp shuffles, then one value
//   per warp through shared memory), with expf (not __expf). Rows at or past
//   token_len are written as zeros without being read. The median width is a
//   template parameter instantiated for every odd width up to kMaxWidth.
#include "common.cuh"

namespace {

constexpr int kMaxWidth = 15;  // QKPOST_MAX_WIDTH in ops/_lib.py
constexpr int kThreads = 256;
constexpr int kRows = 4;       // token rows per block

template <int W>
__device__ __forceinline__ float median_of(float (&v)[W]) {
#pragma unroll
  for (int p = 0; p < W; ++p) {
#pragma unroll
    for (int i = p & 1; i < W - 1; i += 2) {
      const float lo = fminf(v[i], v[i + 1]);
      const float hi = fmaxf(v[i], v[i + 1]);
      v[i] = lo;
      v[i + 1] = hi;
    }
  }
  return v[W / 2];
}

// Block-wide max (IS_MAX) or sum; every thread gets the result.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float other = __shfl_xor_sync(wca::kFullMask, v, off);
    v = IS_MAX ? fmaxf(v, other) : v + other;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red[] is free: the last reduction's readers are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? red[lane] : (IS_MAX ? -CUDART_INF_F : 0.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float other = __shfl_xor_sync(wca::kFullMask, v, off);
    v = IS_MAX ? fmaxf(v, other) : v + other;
  }
  return v;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    qkpost_kernel(const float* __restrict__ qk, float* __restrict__ out,
                  const int* __restrict__ frame_len,
                  const int* __restrict__ token_len, int h, int t, int f,
                  float qk_scale) {
  constexpr int PAD = W / 2;
  extern __shared__ float smem[];
  float* xs = smem;      // [f] raw logits of the row
  float* ys = smem + f;  // [f] filtered, scaled, masked logits -> exp
  __shared__ float red[kThreads / 32];

  const int b = blockIdx.z, hh = blockIdx.y;
  const int fl = min(frame_len[b], f);  // frame_len is in [1, F]
  const int tl = token_len[b];
  const int m = fl - 1;
  const bool passthrough = fl <= PAD;

  for (int rr = 0; rr < kRows; ++rr) {
    const int row = blockIdx.x * kRows + rr;
    if (row >= t) break;  // uniform across the block
    const size_t off = (((size_t)b * h + hh) * t + row) * f;
    float* orow = out + off;
    if (row >= tl) {
      for (int c = threadIdx.x; c < f; c += kThreads) orow[c] = 0.f;
      continue;
    }
    const float* irow = qk + off;
    __syncthreads();  // the previous row's readers of xs are done
    for (int c = threadIdx.x; c < f; c += kThreads) xs[c] = irow[c];
    __syncthreads();

    float mx = -CUDART_INF_F;
    for (int c = threadIdx.x; c < f; c += kThreads) {
      float val = -CUDART_INF_F;
      if (c <= m) {
        float med;
        if (passthrough) {
          med = xs[c];
        } else {
          float win[W];
#pragma unroll
          for (int s = 0; s < W; ++s) {
            int i = abs(c - PAD + s);   // reflect at frame 0
            if (i > m) i = 2 * m - i;   // reflect at the item's last frame
            win[s] = xs[i];
          }
          med = median_of<W>(win);
        }
        val = med * qk_scale;
      }
      ys[c] = val;
      mx = fmaxf(mx, val);
    }
    mx = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int c = threadIdx.x; c < f; c += kThreads) {
      const float e = expf(ys[c] - mx);
      ys[c] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red);
    for (int c = threadIdx.x; c < f; c += kThreads) orow[c] = ys[c] / sum;
  }
}

template <int W>
cudaError_t launch(const float* qk, float* out, const int* fl, const int* tl,
                   int b, int h, int t, int f, float scale, cudaStream_t s) {
  const size_t smem = 2 * sizeof(float) * (size_t)f;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qkpost_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((t + kRows - 1) / kRows, h, b);
  qkpost_kernel<W><<<grid, kThreads, smem, s>>>(qk, out, fl, tl, h, t, f, scale);
  return cudaGetLastError();
}

}  // namespace

// qk, out: (B, H, T, F) float32 contiguous; frame_len, token_len: (B,) int32.
WCA_EXPORT int wca_qkpost(const void* qk, void* out, const void* frame_len,
                          const void* token_len, int b, int h, int t, int f,
                          int width, float qk_scale, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || f <= 0 || b > 65535 || h > 65535)
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(qk);
  float* y = static_cast<float*>(out);
  const int* fl = static_cast<const int*>(frame_len);
  const int* tl = static_cast<const int*>(token_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch<1>(x, y, fl, tl, b, h, t, f, qk_scale, s);
    case 3: return launch<3>(x, y, fl, tl, b, h, t, f, qk_scale, s);
    case 5: return launch<5>(x, y, fl, tl, b, h, t, f, qk_scale, s);
    case 7: return launch<7>(x, y, fl, tl, b, h, t, f, qk_scale, s);
    case 9: return launch<9>(x, y, fl, tl, b, h, t, f, qk_scale, s);
    case 11: return launch<11>(x, y, fl, tl, b, h, t, f, qk_scale, s);
    case 13: return launch<13>(x, y, fl, tl, b, h, t, f, qk_scale, s);
    case kMaxWidth: return launch<kMaxWidth>(x, y, fl, tl, b, h, t, f, qk_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
