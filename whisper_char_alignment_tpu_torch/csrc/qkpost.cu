// Fused cross-attention QK post-process: median filter -> scaled f32 softmax
// -> masks, one block per (item, head, tile of kRows token rows).
//
// Replaces: whisper_char_alignment_tpu/ops/qkpost_pallas.py,
//   qk_postprocess_fused (its _kernel). Same function, in order: a width-w
//   median along frames on the raw logits, with windows reflected at frame 0
//   and at the item's last valid frame m = frame_len - 1 (inputs pass through
//   unfiltered when frame_len <= w/2); x qk_scale; frames > m -> -inf; an f32
//   softmax over frames; token rows >= token_len -> 0. Any odd width w >= 1.
//
// What bounds it on an H100: bytes for small widths. One read and one write
//   of the (B, H, T, F) f32 logits (147 MB at B=8, H=16, T=96, F=1500: 44 us
//   at 3.35 TB/s); a w <= 15 median is a few comparisons per element. Wider
//   windows are bound by their comparisons instead (counts below).
//
// Design: each row of F logits is staged once in shared memory; each thread
//   takes columns c = tid, tid + 256, ... and builds its window with the
//   reflection applied directly at 0 and at m. A median is a selection by
//   comparison, so every exact method gives the same value:
//   - widths 1..31 (kMaxNetWidth) are a template parameter: the window sits
//     in registers and an odd-even transposition network takes the median
//     (the compare-exchange order of ops/medfilt._median_of), w (w - 1) / 2
//     compare-exchanges per element;
//   - any wider odd width is a run-time argument (template W = 0): the
//     median is the window value v with #{x < v} <= w/2 < #{x <= v} (rank
//     selection). A thread holds kCand candidates in registers and counts
//     both ranks for all of them in one pass over the window, read from the
//     staged row, so no per-thread array is indexed at run time; it stops at
//     the first candidate that qualifies. That is up to 2 w^2 comparisons
//     per element and w * ceil(w / kCand) shared-memory loads, still one pass
//     over the row in device memory. That is more work than the network's
//     at the same width, so the network is instantiated up to 31
//     (chip_smoke.py times width 31 on the network beside 33 on ranks).
//   The TPU kernel's base pass plus edge correction exists only because
//   Mosaic has no arbitrary-lane load; shared memory has one, so a single
//   pass gives the same medians. The row's max and sum are block-wide f32
//   reductions (warp shuffles, then one value per warp through shared
//   memory), with expf (not __expf). Rows at or past token_len are written as
//   zeros without being read.
#include "common.cuh"

namespace {

constexpr int kMaxNetWidth = 31;  // widest network instantiated
constexpr int kThreads = 256;
constexpr int kRows = 4;          // token rows per block
constexpr int kCand = 8;          // rank-selection candidates per pass

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

// Index i of a window reflected at 0 and at the last valid frame m: one
// reflection each way suffices, since a filtered item has w/2 <= m.
__device__ __forceinline__ int reflect(int i, int m) {
  i = abs(i);
  return i > m ? 2 * m - i : i;
}

// Median of the width-(2 pad + 1) window of column c over the staged row xs
// (valid frames 0..m), by rank: the window value v whose count of smaller
// values is at most pad and whose count of smaller-or-equal values is above
// pad. Candidates past the window's end repeat its last value.
__device__ __forceinline__ float median_by_rank(const float* xs, int c,
                                                int pad, int m) {
  const int w = 2 * pad + 1;
  const int lo = c - pad;
  for (int j0 = 0; j0 < w; j0 += kCand) {
    float v[kCand];
    int lt[kCand], le[kCand];
#pragma unroll
    for (int k = 0; k < kCand; ++k) {
      v[k] = xs[reflect(lo + min(j0 + k, w - 1), m)];
      lt[k] = 0;
      le[k] = 0;
    }
    for (int s = 0; s < w; ++s) {
      const float x = xs[reflect(lo + s, m)];
#pragma unroll
      for (int k = 0; k < kCand; ++k) {
        lt[k] += x < v[k];
        le[k] += x <= v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kCand; ++k)
      if (lt[k] <= pad && le[k] > pad) return v[k];
  }
  return xs[c];  // not reached: the window's sorted middle value qualifies
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

// W > 0: the width, a compile-time constant (the network); W == 0: the
// width is `width` (rank selection).
template <int W>
__global__ void __launch_bounds__(kThreads)
    qkpost_kernel(const float* __restrict__ qk, float* __restrict__ out,
                  const int* __restrict__ frame_len,
                  const int* __restrict__ token_len, int h, int t, int f,
                  int width, float qk_scale) {
  const int pad = (W > 0 ? W : width) / 2;
  extern __shared__ float smem[];
  float* xs = smem;      // [f] raw logits of the row
  float* ys = smem + f;  // [f] filtered, scaled, masked logits -> exp
  __shared__ float red[kThreads / 32];

  const int b = blockIdx.z, hh = blockIdx.y;
  const int fl = min(frame_len[b], f);  // frame_len is in [1, F]
  const int tl = token_len[b];
  const int m = fl - 1;
  const bool passthrough = fl <= pad;

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
        } else if constexpr (W > 0) {
          float win[W];
#pragma unroll
          for (int s = 0; s < W; ++s) win[s] = xs[reflect(c - pad + s, m)];
          med = median_of<W>(win);
        } else {
          med = median_by_rank(xs, c, pad, m);
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
                   int b, int h, int t, int f, int width, float scale,
                   cudaStream_t s) {
  const size_t smem = 2 * sizeof(float) * (size_t)f;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qkpost_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((t + kRows - 1) / kRows, h, b);
  qkpost_kernel<W><<<grid, kThreads, smem, s>>>(qk, out, fl, tl, h, t, f,
                                                width, scale);
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
#define WCA_QKPOST_NET(W) \
  case W:                 \
    return launch<W>(x, y, fl, tl, b, h, t, f, width, qk_scale, s);
    WCA_QKPOST_NET(1) WCA_QKPOST_NET(3) WCA_QKPOST_NET(5) WCA_QKPOST_NET(7)
    WCA_QKPOST_NET(9) WCA_QKPOST_NET(11) WCA_QKPOST_NET(13) WCA_QKPOST_NET(15)
    WCA_QKPOST_NET(17) WCA_QKPOST_NET(19) WCA_QKPOST_NET(21) WCA_QKPOST_NET(23)
    WCA_QKPOST_NET(25) WCA_QKPOST_NET(27) WCA_QKPOST_NET(29)
    WCA_QKPOST_NET(kMaxNetWidth)
#undef WCA_QKPOST_NET
    default:
      if (width < kMaxNetWidth || width % 2 != 1) return cudaErrorInvalidValue;
      return launch<0>(x, y, fl, tl, b, h, t, f, width, qk_scale, s);
  }
}
