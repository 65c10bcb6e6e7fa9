// Whisper's log-mel frontend as two kernels: the spectrum (framing, window,
// a real 400-point FFT, power, mel projection, log10, and each tile's
// maximum) and the per-item clip and scale.
//
// Replaces: whisper_char_alignment_tpu/ops/mel_pallas.py, log_mel_pallas
//   (its pallas_call, the framing before it and the clip after it). For
//   frame t < n_samples / 160 and tap n < 400,
//     x_t[n] = audio[reflect(160 t + n - 200)] * window[n]
//     P_t[k] = |sum_n x_t[n] e^{-2 pi i n k / 400}|^2          k = 0..200
//     L[m, t] = log10(max(sum_k fb[m, k] P_t[k], 1e-10))
//     out[b, m, t] = (max(L, max_{m,t} L[b] - 8) + 4) / 4
//   all in float32.
//
// What bounds it on an H100: bytes. It reads the audio once (15.36 MB at
//   B=8, 30 s) and writes the log-mel once (7.68 MB at 80 mels): 23.0 MB,
//   0.0069 ms at 3.35 TB/s. A real FFT is ~0.24 GFLOP there, 0.0036 ms at
//   the 67 TFLOP/s float32 rate. The clip kernel reads and writes the
//   log-mel once more (15.4 MB, 0.0046 ms).
//
// Spectrum kernel (mel_spectrum_kernel): one block of 8 warps per 64
//   consecutive frames of one item. The block copies its frames' contiguous
//   span of 160 * 63 + 400 samples into shared memory once, with 16-byte
//   cp.async where the span lies inside the item and the item starts on a
//   16-byte boundary, else one sample at a time with the reflect (the first
//   and last tiles, and items of n_samples not a multiple of 4); a frame is
//   then a window into the span, with no gather. Each warp takes 8
//   consecutive frames, one at a time:
//   - the 400 real taps are packed as 200 complex z[j] = x[2j] + i x[2j+1]
//     and transformed by a 200-point complex FFT, 200 = 8 * 5 * 5, with
//     j = 25 n1 + 5 n2 + n3 and k = k1 + 8 k2 + 40 k3:
//       stage 1: 25 lanes (n2, n3) each a radix-8 DFT over n1, read
//                straight from the span with the window in registers,
//                then times W_200^{5 n2 k1};
//       stage 2: 40 radix-5 DFTs (k1, n3) over n2, in place, then times
//                W_200^{n3 (k1 + 8 k2)};
//       stage 3: 40 radix-5 DFTs (k1, k2) over n3 into Z[k];
//     the split step X[k] = (Z[k] + Z*[200-k]) / 2
//                         - i W_400^k (Z[k] - Z*[200-k]) / 2
//     gives the 201 bins and their power (one lane takes bins k and 200 - k,
//     which read the same two values). The wrapper computes every twiddle
//     and radix constant in float64 with numpy and rounds it to float32;
//     the kernel calls no sin or cos.
//   - each lane sums the nonzero run of up to 4 filters (m = lane + 32 r;
//     at most 14 bins a filter) against the frame's power in shared memory;
//     the lanes of a round all loop to the round's longest run, their own
//     bins predicated, which keeps the loop free of divergent branches. The
//     log10 values of the warp's 8 frames stay in registers; then each lane
//     stores its filters' 8 consecutive values, 32 bytes, as two 16-byte
//     stores where aligned: whole sectors, with no staging panel.
//   - every thread keeps the maximum of its values; the block reduces them
//     into tile_max[b, tile] (no atomics, no initialising launch).
//   Shared memory: 41.9 KB of span, 2.4 KB per warp (Z and power), 3.6 KB
//   of twiddles, the packed filter runs: ~69 KB, so 3 blocks of 256
//   threads fit on an SM (80 registers a thread), and the 376 tiles of
//   (8, 480000) run in one wave on 132 SMs. The register array of log
//   values is sized by n_mels (3 or 4 filters a lane): 24 registers at 80
//   mels.
//
// Clip kernel (mel_clip_kernel): each block reduces its item's tile maxima,
//   then applies max(x, m - 8) and (x + 4) / 4 in place over its share of
//   the item with 16-byte loads and stores: the same float32 operations in
//   the same order as audio/mel.py clip_and_scale, so bit-equal to it.
//
// Tried and dropped (scratch builds timed on the card): the direct DFT this
//   kernel replaces (400 x 201 complex products a frame against a 400-entry
//   table: 30x an FFT's work, bound by its shared-memory loads, one block of
//   157 KB per SM with [64][201] power and tap panels); 4-byte cp.async for
//   the edge tiles (no faster: the loads are a small share); a rolled frame
//   loop shifting the log values through registers (spilled, slower); a
//   second accumulator in the mel loop and stage 2 unrolled into two
//   predicated rounds (no faster). The kernel sits at the 80-register cap
//   of 3 blocks an SM, and small changes of its code move its time.
#include "common.cuh"

namespace {

constexpr int kNfft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNfft / 2;
constexpr int kBins = kNfft / 2 + 1;      // 201
constexpr int kHalf = kNfft / 2;          // 200 complex points
constexpr int kTF = 64;                   // frames per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerWarp = kTF / kWarps;  // 8
constexpr int kSpan = kHop * (kTF - 1) + kNfft;  // 10480 samples
constexpr int kPowStride = (kBins + 3) & ~3;  // 201 powers, padded to 204
constexpr int kMaxMels = 128;

// twiddle table, in floats (re, im pairs), as ops/mel_cuda.py lays it out
constexpr int kTwR5 = 0;     // cos(2pi/5), sin(2pi/5), cos(4pi/5), sin(4pi/5)
constexpr int kTwR8 = 4;     // sqrt(1/2)
constexpr int kTw40 = 8;     // W_200^{5 n2 k1} at [n2 * 8 + k1], 40 pairs
constexpr int kTw200 = 88;   // W_200^{n3 q} at [n3 * 40 + q], 200 pairs
constexpr int kTw400 = 488;  // W_400^k, 201 pairs
constexpr int kTwFloats = 892;

struct cf {
  float x, y;
};
__device__ __forceinline__ cf add(cf a, cf b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ cf sub(cf a, cf b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ cf mul(cf a, cf b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
__device__ __forceinline__ cf scl(cf a, float s) { return {a.x * s, a.y * s}; }
// -i * a
__device__ __forceinline__ cf mul_mi(cf a) { return {a.y, -a.x}; }
__device__ __forceinline__ cf ld(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return {v.x, v.y};
}
__device__ __forceinline__ void st(float* p, cf a) {
  *reinterpret_cast<float2*>(p) = make_float2(a.x, a.y);
}

// 4-point DFT, forward
__device__ __forceinline__ void dft4(cf u0, cf u1, cf u2, cf u3, cf* o) {
  const cf t0 = add(u0, u2), t1 = sub(u0, u2), t2 = add(u1, u3),
           t3 = sub(u1, u3);
  o[0] = add(t0, t2);
  o[2] = sub(t0, t2);
  o[1] = add(t1, mul_mi(t3));
  o[3] = sub(t1, mul_mi(t3));
}

// 8-point DFT, forward, in place: two 4-point DFTs and W_8^k
__device__ __forceinline__ void dft8(cf* v, float c8) {
  cf a[4], b[4];
  dft4(v[0], v[2], v[4], v[6], a);
  dft4(v[1], v[3], v[5], v[7], b);
  const cf w1 = {c8 * (b[1].x + b[1].y), c8 * (b[1].y - b[1].x)};
  const cf w2 = mul_mi(b[2]);
  const cf w3 = {c8 * (b[3].y - b[3].x), -c8 * (b[3].x + b[3].y)};
  v[0] = add(a[0], b[0]);
  v[4] = sub(a[0], b[0]);
  v[1] = add(a[1], w1);
  v[5] = sub(a[1], w1);
  v[2] = add(a[2], w2);
  v[6] = sub(a[2], w2);
  v[3] = add(a[3], w3);
  v[7] = sub(a[3], w3);
}

// 5-point DFT, forward, in place; r5 = (cos 2pi/5, sin 2pi/5, cos 4pi/5,
// sin 4pi/5)
__device__ __forceinline__ void dft5(cf* v, const float* r5) {
  const float c1 = r5[0], s1 = r5[1], c2 = r5[2], s2 = r5[3];
  const cf a1 = add(v[1], v[4]), b1 = sub(v[1], v[4]);
  const cf a2 = add(v[2], v[3]), b2 = sub(v[2], v[3]);
  const cf x0 = v[0];
  const cf p1 = add(x0, add(scl(a1, c1), scl(a2, c2)));
  const cf p2 = add(x0, add(scl(a1, c2), scl(a2, c1)));
  const cf q1 = mul_mi(add(scl(b1, s1), scl(b2, s2)));
  const cf q2 = mul_mi(sub(scl(b1, s2), scl(b2, s1)));
  v[0] = add(x0, add(a1, a2));
  v[1] = add(p1, q1);
  v[4] = sub(p1, q1);
  v[2] = add(p2, q2);
  v[3] = sub(p2, q2);
}

// |X[k]|^2 of the 400 real taps from zk = Z[k mod 200], zr = Z[(200 - k)
// mod 200] and w = W_400^k: X[k] = (zk + zr*) / 2 - i w (zk - zr*) / 2
__device__ __forceinline__ float bin_power(cf zk, cf zr, cf w) {
  const cf zc = {zr.x, -zr.y};
  const cf e = scl(add(zk, zc), 0.5f);
  const cf wd = mul(w, sub(zk, zc));
  const float xr = e.x + 0.5f * wd.y, xi = e.y - 0.5f * wd.x;
  return xr * xr + xi * xi;
}

__device__ __forceinline__ int reflect(int j, int n) {
  if (j < 0) return -j;
  if (j >= n) return 2 * (n - 1) - j;
  return j;
}

size_t spectrum_smem_floats(int n_mels, int n_nz) {
  return (size_t)kSpan + kTwFloats + kWarps * (2 * kHalf + kPowStride) +
         ((n_nz + 3) & ~3) + 2 * ((n_mels + 4) & ~3);
}

// kRounds filters a lane: n_mels <= 32 * kRounds
template <int kRounds>
__global__ void __launch_bounds__(kThreads, 3)
    mel_spectrum_kernel(const float* __restrict__ audio,
                        const float* __restrict__ window,
                        const float* __restrict__ twiddles,
                        const float* __restrict__ fb_packed,
                        const int* __restrict__ lo, const int* __restrict__ off,
                        float* __restrict__ out, float* __restrict__ tile_max,
                        int n_samples, int n_frames, int n_mels, int n_nz) {
  extern __shared__ __align__(16) float smem[];
  float* span = smem;                         // [kSpan]
  float* tw = span + kSpan;                   // [kTwFloats]
  float* wbuf = tw + kTwFloats;               // per warp: Z, power
  float* fbw = wbuf + kWarps * (2 * kHalf + kPowStride);
  int* lo_s = reinterpret_cast<int*>(fbw + ((n_nz + 3) & ~3));
  int* off_s = lo_s + ((n_mels + 4) & ~3);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int t0 = tile * kTF;
  const int nf = min(kTF, n_frames - t0);
  const int len = kHop * (nf - 1) + kNfft;  // span this tile's frames read
  const int s0 = t0 * kHop - kPad;
  const float* ab = audio + (size_t)b * n_samples;

  if (s0 >= 0 && s0 + len <= n_samples &&
      (reinterpret_cast<uintptr_t>(ab) & 15) == 0) {
    // interior: 16-byte copies (s0 and len are multiples of 4)
    for (int i = tid; i < len / 4; i += kThreads)
      wca::cp_async<16>(span + 4 * i, ab + s0 + 4 * i, 16);
    wca::cp_async_commit();
  } else {
    for (int i = tid; i < len; i += kThreads)
      span[i] = ab[reflect(s0 + i, n_samples)];
  }
  for (int i = tid; i < kTwFloats; i += kThreads) tw[i] = twiddles[i];
  for (int i = tid; i < n_nz; i += kThreads) fbw[i] = fb_packed[i];
  for (int i = tid; i < n_mels; i += kThreads) lo_s[i] = lo[i];
  for (int i = tid; i <= n_mels; i += kThreads) off_s[i] = off[i];
  // stage 1's window taps: lane m < 25 reads x[50 n1 + 2m], x[50 n1 + 2m + 1]
  cf win[8];
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1)
    win[n1] = lane < 25 ? ld(window + 50 * n1 + 2 * lane) : cf{0.f, 0.f};
  wca::cp_async_wait<0>();
  __syncthreads();

  float* zb = wbuf + warp * (2 * kHalf + kPowStride);  // 200 complex
  float* pw = zb + 2 * kHalf;                          // 201 powers
  const float c8 = tw[kTwR8];
  // the longest filter run among the warp's filters of each round: every
  // lane of a round loops that many times, its own run's bins predicated
  int run_max[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int m = lane + 32 * r;
    run_max[r] = __reduce_max_sync(wca::kFullMask,
                                   m < n_mels ? off_s[m + 1] - off_s[m] : 0);
  }
  float logv[kRounds][kFramesPerWarp];
  float vmax = -CUDART_INF_F;

#pragma unroll
  for (int fi = 0; fi < kFramesPerWarp; ++fi) {
    const int f = warp * kFramesPerWarp + fi;
    if (f >= nf) continue;  // warp-uniform
    const float* xf = span + kHop * f;

    // stage 1: lane m = 5 n2 + n3 < 25, radix 8 over n1
    if (lane < 25) {
      cf v[8];
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) {
        const cf x = ld(xf + 50 * n1 + 2 * lane);
        v[n1] = {x.x * win[n1].x, x.y * win[n1].y};
      }
      dft8(v, c8);
      const int n2 = lane / 5;
#pragma unroll
      for (int k1 = 0; k1 < 8; ++k1) {
        const cf t = k1 == 0 ? v[0] : mul(v[k1], ld(tw + kTw40 + 2 * (n2 * 8 + k1)));
        st(zb + 2 * (k1 * 25 + lane), t);
      }
    }
    __syncwarp();

    // stage 2: p = 5 k1 + n3 < 40, radix 5 over n2, in place
    for (int p = lane; p < 40; p += 32) {
      const int k1 = p / 5, n3 = p % 5;
      float* base = zb + 2 * (k1 * 25 + n3);
      cf v[5];
#pragma unroll
      for (int n2 = 0; n2 < 5; ++n2) v[n2] = ld(base + 10 * n2);
      dft5(v, tw + kTwR5);
#pragma unroll
      for (int k2 = 0; k2 < 5; ++k2) {
        const cf t = n3 == 0 ? v[k2]
                             : mul(v[k2], ld(tw + kTw200 +
                                             2 * (n3 * 40 + k1 + 8 * k2)));
        st(base + 10 * k2, t);
      }
    }
    __syncwarp();

    // stage 3: p = k1 + 8 k2 < 40, radix 5 over n3 into Z[p + 40 k3]; all
    // reads before any write (the writes land on other lanes' inputs)
    cf v3[2][5];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = lane + 32 * r;
      if (p < 40) {
        const float* base = zb + 2 * ((p & 7) * 25 + 5 * (p >> 3));
#pragma unroll
        for (int n3 = 0; n3 < 5; ++n3) v3[r][n3] = ld(base + 2 * n3);
        dft5(v3[r], tw + kTwR5);
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = lane + 32 * r;
      if (p < 40) {
#pragma unroll
        for (int k3 = 0; k3 < 5; ++k3) st(zb + 2 * (p + 40 * k3), v3[r][k3]);
      }
    }
    __syncwarp();

    // split step and power: lane k <= 100 takes bins k and 200 - k, which
    // read the same two values, Z[k] and Z[(200 - k) mod 200]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = lane + 32 * r;
      if (k <= kHalf / 2) {
        const cf za = ld(zb + 2 * k);
        const cf zr = ld(zb + 2 * (k == 0 ? 0 : kHalf - k));
        pw[k] = bin_power(za, zr, ld(tw + kTw400 + 2 * k));
        if (k < kHalf / 2)
          pw[kHalf - k] = bin_power(zr, za, ld(tw + kTw400 + 2 * (kHalf - k)));
      }
    }
    __syncwarp();

    // mel projection over each filter's nonzero run, then log10
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int m = lane + 32 * r;
      float val = 0.f;
      if (m < n_mels) {
        const int k0 = lo_s[m], o0 = off_s[m], n = off_s[m + 1] - o0;
        float acc = 0.f;
#pragma unroll 4
        for (int j = 0; j < run_max[r]; ++j)
          if (j < n) acc = fmaf(fbw[o0 + j], pw[k0 + j], acc);
        val = log10f(fmaxf(acc, 1e-10f));
        vmax = fmaxf(vmax, val);
      }
      logv[r][fi] = val;
    }
    __syncwarp();  // zb and pw are rewritten by the next frame
  }

  // each lane's filters: 8 consecutive frames, 32 bytes a row
  const int f0 = warp * kFramesPerWarp;
  const int nv = min(kFramesPerWarp, nf - f0);
  if (nv > 0) {
    const int t = t0 + f0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int m = lane + 32 * r;
      if (m >= n_mels) continue;
      float* row = out + ((size_t)b * n_mels + m) * n_frames + t;
      if (nv == kFramesPerWarp && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
        reinterpret_cast<float4*>(row)[0] =
            make_float4(logv[r][0], logv[r][1], logv[r][2], logv[r][3]);
        reinterpret_cast<float4*>(row)[1] =
            make_float4(logv[r][4], logv[r][5], logv[r][6], logv[r][7]);
      } else {
#pragma unroll
        for (int j = 0; j < kFramesPerWarp; ++j)
          if (j < nv) row[j] = logv[r][j];
      }
    }
  }

  __shared__ float red[kWarps];
  const float bmax = wca::block_reduce<true>(vmax, red);
  if (tid == 0) tile_max[(size_t)b * n_tiles + tile] = bmax;
}

constexpr int kClipThreads = 256;
constexpr int kClipVecPerThread = 4;

__device__ __forceinline__ float clip_one(float x, float floor_v) {
  return __fmul_rn(__fadd_rn(fmaxf(x, floor_v), 4.f), 0.25f);
}

__global__ void __launch_bounds__(kClipThreads)
    mel_clip_kernel(float* __restrict__ x, const float* __restrict__ tile_max,
                    int n_tiles, int per_item) {
  const int b = blockIdx.y;
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x; i < n_tiles; i += kClipThreads)
    m = fmaxf(m, tile_max[(size_t)b * n_tiles + i]);
  __shared__ float red[kClipThreads / 32];
  const float floor_v = __fsub_rn(wca::block_reduce<true>(m, red), 8.f);

  float* p = x + (size_t)b * per_item;
  const int head = min(per_item,
                       (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4));
  const int n4 = (per_item - head) / 4;
  const int tail = head + 4 * n4;
  const int stride = gridDim.x * kClipThreads;
  const int i0 = blockIdx.x * kClipThreads + threadIdx.x;
  if (i0 < head) p[i0] = clip_one(p[i0], floor_v);
  if (i0 < per_item - tail) p[tail + i0] = clip_one(p[tail + i0], floor_v);
  float4* q = reinterpret_cast<float4*>(p + head);
  for (int i = i0; i < n4; i += stride) {
    float4 v = q[i];
    v.x = clip_one(v.x, floor_v);
    v.y = clip_one(v.y, floor_v);
    v.z = clip_one(v.z, floor_v);
    v.w = clip_one(v.w, floor_v);
    q[i] = v;
  }
}

}  // namespace

// audio (B, n_samples) f32; window (400,) f32; twiddles
// (892,) f32; fb_packed (n_nz,) f32, each filter's nonzero run in turn; lo
// (n_mels,), off (n_mels + 1,) int32; out (B, n_mels, n_frames) f32;
// tile_max (B, ceil(n_frames / 64)) f32. n_frames = n_samples / 160;
// n_samples > 200 (reflect padding); n_mels <= 128.
WCA_EXPORT int wca_mel(const void* audio, const void* window,
                       const void* twiddles, const void* fb_packed,
                       const void* lo, const void* off, void* out,
                       void* tile_max, int batch, int n_samples, int n_frames,
                       int n_mels, int n_nz, void* stream) {
  if (batch <= 0 || n_samples <= kPad || n_frames <= 0 || n_mels <= 0 ||
      n_mels > kMaxMels || n_nz <= 0 || n_frames != n_samples / kHop)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * spectrum_smem_floats(n_mels, n_nz);
  dim3 grid((n_frames + kTF - 1) / kTF, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(audio);
  const auto* w = static_cast<const float*>(window);
  const auto* tw = static_cast<const float*>(twiddles);
  const auto* fb = static_cast<const float*>(fb_packed);
  const auto* l = static_cast<const int*>(lo);
  const auto* o = static_cast<const int*>(off);
  auto* y = static_cast<float*>(out);
  auto* tm = static_cast<float*>(tile_max);
  cudaError_t err;
  if (n_mels <= 96) {
    err = wca::allow_smem<mel_spectrum_kernel<3>>(smem);
    if (err != cudaSuccess) return err;
    mel_spectrum_kernel<3><<<grid, kThreads, smem, s>>>(
        a, w, tw, fb, l, o, y, tm, n_samples, n_frames, n_mels, n_nz);
  } else {
    err = wca::allow_smem<mel_spectrum_kernel<4>>(smem);
    if (err != cudaSuccess) return err;
    mel_spectrum_kernel<4><<<grid, kThreads, smem, s>>>(
        a, w, tw, fb, l, o, y, tm, n_samples, n_frames, n_mels, n_nz);
  }
  return cudaGetLastError();
}

// x (B, per_item) f32, clipped and scaled in place by the maximum of each
// item's n_tiles values of tile_max (B, n_tiles) f32.
WCA_EXPORT int wca_mel_clip(void* x, const void* tile_max, int batch,
                            int per_item, int n_tiles, void* stream) {
  if (batch <= 0 || per_item <= 0 || n_tiles <= 0)
    return cudaErrorInvalidValue;
  const int n4 = per_item / 4 + 1;
  const int blocks = (n4 + kClipThreads * kClipVecPerThread - 1) /
                     (kClipThreads * kClipVecPerThread);
  dim3 grid(blocks, batch);
  mel_clip_kernel<<<grid, kClipThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<const float*>(tile_max), n_tiles,
      per_item);
  return cudaGetLastError();
}
