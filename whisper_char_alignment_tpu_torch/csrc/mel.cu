// Whisper's log-mel frontend up to the log: framing, window, DFT, power, mel
// projection, log10. One block per (64-frame tile, batch item).
//
// Replaces: whisper_char_alignment_tpu/ops/mel_pallas.py, log_mel_pallas
//   (its _mel_kernel and the framing before it). For frame t < n_samples /
//   160 and tap n < 400, x[n] = audio[reflect(160 t + n - 200)] * window[n]
//   (torch/numpy "reflect" padding by 200 on each side); then
//     re[k] = sum_n x[n] cos_b[n, k],  im[k] = sum_n x[n] sin_b[n, k]
//     out[m, t] = log10(max(sum_k fb[m, k] (re[k]^2 + im[k]^2), 1e-10))
//   for the 201 bins k and n_mels filters m, all in float32. The per-item
//   (max - 8) clip and (x + 4) / 4 stay outside, as in the JAX package.
//
// What bounds it on an H100: operations. 400 x 201 x 2 multiply-adds per
//   frame for the DFT: ~7.7 GFLOP at B=8 and 30 s (24,000 frames) against
//   ~23 MB in and out, so the 67 TFLOP/s float32 rate (~0.12 ms).
//
// Design: the TPU kernel takes pre-gathered frames padded to 512 taps and
//   multiplies by (512, 256) cos/sin panels on the MXU. Here each block
//   gathers its 64 frames' reflect-padded taps straight from the audio into
//   shared memory (rows padded to 401 floats: conflict-free), so no frames
//   tensor is ever written. The DFT bases are never read as panels: every
//   basis value is cos_b[n, k] = c[(n k) mod 400] with c = cos_b[:, 1] (the
//   same for sin), so the wrapper passes that one column of the f32 bases
//   (3.2 KB, in shared memory) instead of 643 KB per block. A warp takes 8
//   bins at a time for the block's 64 frames (2 per lane), so each table
//   value is a broadcast read and feeds 4 multiply-adds. Power goes to
//   shared memory; each mel filter sums only its own bins [lo[m], hi[m])
//   (the nonzero run of its triangle, passed in by the wrapper).
#include "common.cuh"

namespace {

constexpr int kNfft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNfft / 2;
constexpr int kBins = kNfft / 2 + 1;  // 201
constexpr int kTF = 64;               // frames per block
constexpr int kLDX = kNfft + 1;       // padded tap row
constexpr int kBinChunk = 8;          // bins per warp pass
constexpr int kChunks = (kBins + kBinChunk - 1) / kBinChunk;  // 26
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kTF * kLDX + kTF * kBins + 2 * kNfft);
}

__device__ __forceinline__ int reflect(int j, int n) {
  if (j < 0) return -j;
  if (j >= n) return 2 * (n - 1) - j;
  return j;
}

__global__ void __launch_bounds__(kThreads)
    mel_kernel(const float* __restrict__ audio,
               const float* __restrict__ window,
               const float* __restrict__ cos_col,
               const float* __restrict__ sin_col,
               const float* __restrict__ fb, const int* __restrict__ lo,
               const int* __restrict__ hi, float* __restrict__ out,
               int n_samples, int n_frames, int n_mels) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [kTF][kLDX] windowed taps
  float* pw = xs + kTF * kLDX;         // [kTF][kBins] power
  float* ct = pw + kTF * kBins;        // [kNfft] cos table
  float* st = ct + kNfft;              // [kNfft] sin table

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTF;
  const int b = blockIdx.y;
  const float* ab = audio + (size_t)b * n_samples;

  for (int i = tid; i < kNfft; i += kThreads) {
    ct[i] = cos_col[i];
    st[i] = sin_col[i];
  }
  for (int idx = tid; idx < kTF * kNfft; idx += kThreads) {
    const int f = idx / kNfft, n = idx % kNfft, t = t0 + f;
    xs[f * kLDX + n] =
        t < n_frames
            ? ab[reflect(t * kHop + n - kPad, n_samples)] * window[n]
            : 0.f;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const float* x0 = xs + lane * kLDX;
  const float* x1 = xs + (lane + 32) * kLDX;
  for (int c = warp; c < kChunks; c += kWarps) {
    const int k0 = c * kBinChunk;
    float re0[kBinChunk], im0[kBinChunk], re1[kBinChunk], im1[kBinChunk];
    int idx[kBinChunk];
#pragma unroll
    for (int j = 0; j < kBinChunk; ++j) {
      re0[j] = im0[j] = re1[j] = im1[j] = 0.f;
      idx[j] = 0;  // (n * k) mod 400 at n = 0
    }
#pragma unroll 2
    for (int n = 0; n < kNfft; ++n) {
      const float a0 = x0[n], a1 = x1[n];
#pragma unroll
      for (int j = 0; j < kBinChunk; ++j) {
        const float cv = ct[idx[j]], sv = st[idx[j]];
        re0[j] = fmaf(a0, cv, re0[j]);
        im0[j] = fmaf(a0, sv, im0[j]);
        re1[j] = fmaf(a1, cv, re1[j]);
        im1[j] = fmaf(a1, sv, im1[j]);
        idx[j] += k0 + j;  // k < 400, so one wrap at most
        if (idx[j] >= kNfft) idx[j] -= kNfft;
      }
    }
#pragma unroll
    for (int j = 0; j < kBinChunk; ++j) {
      const int k = k0 + j;
      if (k < kBins) {
        pw[lane * kBins + k] = re0[j] * re0[j] + im0[j] * im0[j];
        pw[(lane + 32) * kBins + k] = re1[j] * re1[j] + im1[j] * im1[j];
      }
    }
  }
  __syncthreads();

  // lanes over consecutive frames: conflict-free power reads (odd pitch),
  // one filter row per warp step, coalesced stores along time
  for (int p = tid; p < kTF * n_mels; p += kThreads) {
    const int f = p % kTF, m = p / kTF, t = t0 + f;
    if (t >= n_frames) continue;
    const float* frow = fb + (size_t)m * kBins;
    const float* prow = pw + f * kBins;
    float acc = 0.f;
    for (int k = lo[m]; k < hi[m]; ++k) acc = fmaf(frow[k], prow[k], acc);
    out[((size_t)b * n_mels + m) * n_frames + t] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// audio (B, n_samples) f32; window, cos_col, sin_col (400,) f32; fb
// (n_mels, 201) f32; lo, hi (n_mels,) int32; out (B, n_mels, n_frames) f32.
// n_frames = n_samples / 160; n_samples > 200 (reflect padding).
WCA_EXPORT int wca_mel(const void* audio, const void* window,
                       const void* cos_col, const void* sin_col,
                       const void* fb, const void* lo, const void* hi,
                       void* out, int batch, int n_samples, int n_frames,
                       int n_mels, void* stream) {
  if (batch <= 0 || n_samples <= kPad || n_frames <= 0 || n_mels <= 0 ||
      n_frames > n_samples / kHop)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_frames + kTF - 1) / kTF, batch);
  mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(window),
      static_cast<const float*>(cos_col), static_cast<const float*>(sin_col),
      static_cast<const float*>(fb), static_cast<const int*>(lo),
      static_cast<const int*>(hi), static_cast<float*>(out), n_samples,
      n_frames, n_mels);
  return cudaGetLastError();
}
