// One decode step's cross-attention, one block per (batch item, head).
//
// Replaces: whisper_char_alignment_tpu/ops/cross_attn_pallas.py,
//   cross_attn_step_int8 (quantized) and cross_attn_step (float K/V), which
//   share one kernel body (_body). Same function, every step in float32:
//     s[f] = (sum_d q[d] * k[d, f]) * k_s[f] * k_scale     (k_s: int8 only)
//     w[f] = exp(s[f] - max s) / sum exp(s - max s)
//     w[f] *= v_s[f]                                        (int8 only)
//     o[d] = sum_f v[d, f] * w[f]
//   with q (B, H, 1, hd) float32, K/V (B, H, hd, F) int8 with float32
//   per-frame scales (B, H, 1, F), or bfloat16 / float32 without scales.
//
// What bounds it on an H100: bytes. K and V are read once: at B=8, H=16,
//   hd=64, F=1500 that is 24.6 MB of int8 codes + 1.5 MB of scales (7.8 us
//   at 3.35 TB/s) or 49.2 MB of bf16 (14.7 us), for 49 MFLOP.
//
// Design: the TPU kernel takes one batch item per grid step and vectorises
//   over heads in VMEM. Here each (item, head) is a block (128 blocks at
//   B=8, H=16). Pass 1: threads walk the frames; at each d a warp reads
//   k[d, f..f+31], consecutive addresses, so the loads coalesce. The F
//   scores stay in shared memory (6 KB at F=1500); the row max and sum are
//   block reductions. Pass 2: one warp per head-dim row d forms
//   sum_f v[d, f] w[f] with lanes over consecutive f and a shuffle
//   reduction. Plain loads; vector loads and several rows per block are
//   later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    cross_attn_kernel(const float* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ k_s, const T* __restrict__ v,
                      const float* __restrict__ v_s, float* __restrict__ o,
                      int hd, int n_frames, float k_scale) {
  extern __shared__ float smem[];
  float* red = smem;             // [kWarps]
  float* qs = red + kWarps;      // [hd]
  float* w = qs + hd;            // [n_frames]

  const int tid = threadIdx.x;
  const size_t bh = blockIdx.x;
  const T* kb = k + bh * hd * n_frames;
  const T* vb = v + bh * hd * n_frames;
  const float* ksb = kQuant ? k_s + bh * n_frames : nullptr;
  const float* vsb = kQuant ? v_s + bh * n_frames : nullptr;

  for (int d = tid; d < hd; d += kThreads) qs[d] = q[bh * hd + d];
  __syncthreads();

  float m = -CUDART_INF_F;
  for (int f = tid; f < n_frames; f += kThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < hd; ++d)
      s = fmaf(wca::to_float(kb[(size_t)d * n_frames + f]), qs[d], s);
    if (kQuant) s *= ksb[f];
    s *= k_scale;
    w[f] = s;
    m = fmaxf(m, s);
  }
  m = wca::block_reduce<true>(m, red);

  float l = 0.f;
  for (int f = tid; f < n_frames; f += kThreads) {
    const float e = expf(w[f] - m);
    w[f] = e;
    l += e;
  }
  l = wca::block_reduce<false>(l, red);
  for (int f = tid; f < n_frames; f += kThreads) {
    float p = w[f] / l;
    if (kQuant) p *= vsb[f];
    w[f] = p;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int d = warp; d < hd; d += kWarps) {
    const T* vrow = vb + (size_t)d * n_frames;
    float acc = 0.f;
    for (int f = lane; f < n_frames; f += 32)
      acc = fmaf(wca::to_float(vrow[f]), w[f], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(wca::kFullMask, acc, off);
    if (lane == 0) o[bh * hd + d] = acc;
  }
}

template <typename T, bool kQuant>
cudaError_t launch(const void* q, const void* k, const void* k_s,
                   const void* v, const void* v_s, void* o, int bh, int hd,
                   int n_frames, float k_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(kWarps + hd + n_frames);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  cross_attn_kernel<T, kQuant><<<bh, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const float*>(k_s), static_cast<const T*>(v),
      static_cast<const float*>(v_s), static_cast<float*>(o), hd, n_frames,
      k_scale);
  return cudaGetLastError();
}

bool bad_shape(int bh, int hd, int n_frames) {
  return bh <= 0 || hd <= 0 || n_frames <= 0;
}

}  // namespace

// q (bh, hd) f32; k8, v8 (bh, hd, F) int8; k_s, v_s (bh, F) f32; o (bh, hd)
// f32. All contiguous.
WCA_EXPORT int wca_cross_attn_int8(const void* q, const void* k8,
                                   const void* k_s, const void* v8,
                                   const void* v_s, void* o, int bh, int hd,
                                   int n_frames, float k_scale, void* stream) {
  if (bad_shape(bh, hd, n_frames)) return cudaErrorInvalidValue;
  return launch<int8_t, true>(q, k8, k_s, v8, v_s, o, bh, hd, n_frames,
                              k_scale, static_cast<cudaStream_t>(stream));
}

// q (bh, hd) f32; k, v (bh, hd, F) float32 (is_bf16 == 0) or bfloat16;
// o (bh, hd) f32. All contiguous.
WCA_EXPORT int wca_cross_attn(const void* q, const void* k, const void* v,
                              void* o, int bh, int hd, int n_frames,
                              float k_scale, int is_bf16, void* stream) {
  if (bad_shape(bh, hd, n_frames)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(q, k, nullptr, v, nullptr, o, bh, hd,
                                        n_frames, k_scale, s);
  return launch<float, false>(q, k, nullptr, v, nullptr, o, bh, hd, n_frames,
                              k_scale, s);
}
