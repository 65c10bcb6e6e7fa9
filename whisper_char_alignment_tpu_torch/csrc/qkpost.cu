// Fused cross-attention QK post-process: median filter -> scaled f32 softmax
// -> masks, one warp a row.
//
// Replaces: whisper_char_alignment_tpu/ops/qkpost_pallas.py,
//   qk_postprocess_fused (its _kernel). Same function, in order: a width-w
//   median along frames on the raw logits, with windows reflected at frame 0
//   and at the item's last valid frame m = frame_len - 1 (inputs pass through
//   unfiltered when frame_len <= w/2); x qk_scale; frames > m -> -inf; an f32
//   softmax over frames; token rows >= token_len -> 0. Any odd width w >= 1.
//
// What bounds it on an H100: bytes. The function needs only the valid frames
//   of the valid rows read (rows < token_len, frames < frame_len) and the
//   whole (B, H, T, F) f32 output written: at B=8, H=16, T=96, F=1500 and the
//   smoke's ragged lengths 13 MB read and 74 MB written, 26 us at 3.35 TB/s.
//   Frames past frame_len come out exactly 0 (exp(-inf) = 0) and rows past
//   token_len are 0, so neither is read. Once the median costs O(w) an
//   element, even w = 101 needs far fewer operations than the bytes take.
//
// Design:
//   - Rows: a warp takes one (item, head, token) row at a time, and warp g
//     of the grid walks rows g, g + n_warps, ... of the flattened (B, H, T)
//     rows, so that every warp takes rows of every item. The grid is at most
//     kWaves times the blocks the card holds at once (about two rows a warp
//     at the smoke's shape): the block scheduler hands a finished block's
//     place to the next one, which balances short items against long ones.
//   - Ring: each warp has two row buffers in shared memory. A row's valid
//     frames are staged with 16-byte cp.async (4-byte copies for the head
//     and tail where a row does not start on a 16-byte boundary), and the
//     next row's copy is in flight while this row is filtered.
//   - Runs: lane l owns the run of R consecutive columns from l R (R =
//     ceil(frame_len / 32) made odd, so that the lanes' shared-memory reads
//     fall in distinct banks). It sorts its first window once, then for
//     each next column removes the value that leaves the window and inserts
//     the one that enters: O(w) an output instead of the TPU network's
//     w (w - 1) / 2 compare-exchanges.
//   - Sorted window: one branch-free pass over the sorted window s both
//     deletes a (u[i] = s[i] < a ? s[i] : s[i + 1]) and inserts b
//     (s'[i] = min(u[i], max(b, u[i - 1]))). Deleting any copy of a tied
//     value leaves the same sorted values, and a median is a selection by
//     comparison, so the medians equal the network's (-0.0 and +0.0 compare
//     equal and may swap signs, which the softmax cannot see). The window
//     lives in registers: widths up to 31 (kMaxExactWidth) each have their
//     own template; widths up to 127 take the next capacity C of 40, 48,
//     64, ..., 128, the window padded with -inf below and +inf above so that
//     its median sits at a fixed register (its first window sorted by a
//     bitonic network). A wider odd width keeps each lane's window in shared
//     memory, w floats at a stride of 32 (distinct banks across the warp),
//     walked by the same pass.
//   - Softmax: each lane takes the max of its filtered values while it
//     filters; max and sum are warp shuffles, with expf (not __expf), and
//     the row is scaled by 1 / sum. It is written with 16-byte streaming
//     stores, zeros past frame_len without any work; rows at or past
//     token_len are written as zeros without being read.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxExactWidth = 31;  // widest window of its own template
constexpr int kWarps = 2;           // warps (rows in flight) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kWaves = 4;  // most blocks: kWaves x what the card holds

// Streaming (evict-first) stores: the output is not read again here.
__device__ __forceinline__ void store1(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// Index i of a window reflected at 0 and at the last valid frame m: one
// reflection each way suffices, since a filtered item has w/2 <= m.
__device__ __forceinline__ int reflect(int i, int m) {
  i = abs(i);
  return i > m ? 2 * m - i : i;
}

// Offset in floats of p from the 16-byte boundary below it.
__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Remove a (a value of the sorted s), insert b, in one branch-free pass.
template <int C>
__device__ __forceinline__ void slide_sorted(float (&s)[C], float a, float b) {
  float prev = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float next = i + 1 < C ? s[i + 1 < C ? i + 1 : i] : CUDART_INF_F;
    const float u = s[i] < a ? s[i] : next;
    s[i] = fminf(u, fmaxf(b, prev));
    prev = u;
  }
}

// The sorted window of an odd width W <= kMaxExactWidth, in registers.
template <int W>
struct RegWindow {
  static constexpr bool kShared = false;
  float s[W];

  __device__ __forceinline__ RegWindow(float*, int) {}

  // Sort the window xs[reflect(lo + k, m)], k < W: insertion, branch-free.
  __device__ __forceinline__ float init(const float* xs, int lo, int m) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float v = xs[reflect(lo + k, m)];
      s[k] = CUDART_INF_F;
#pragma unroll
      for (int i = k; i > 0; --i) s[i] = fminf(s[i], fmaxf(v, s[i - 1]));
      s[0] = fminf(s[0], v);
    }
    return s[W / 2];
  }

  __device__ __forceinline__ float slide(float a, float b) {
    slide_sorted(s, a, b);
    return s[W / 2];
  }
};

__host__ __device__ constexpr int pow2_at_least(int c) {
  int n = 1;
  while (n < c) n <<= 1;
  return n;
}

// Sort C registers ascending: a bitonic network on the next power of two
// N, every compare-exchange putting the smaller value at the lower index,
// so that the N - C positions past C, +inf, never move and their
// compare-exchanges are dropped.
template <int C>
__device__ __forceinline__ void sort_registers(float (&s)[C]) {
  constexpr int N = pow2_at_least(C);
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int l = j == k >> 1 ? i ^ (k - 1) : i ^ j;  // flip, then halve
        if (l > i && l < C) {
          const float lo = fminf(s[i], s[l]);
          s[l] = fmaxf(s[i], s[l]);
          s[i] = lo;
        }
      }
    }
  }
}

// The sorted window of an odd run-time width w < C (C even) in C
// registers, padded with (C - 1 - w) / 2 copies of -inf below and the rest
// +inf above, so that its median sits at C/2 - 1 whatever w.
template <int C>
struct PadWindow {
  static constexpr bool kShared = false;
  float s[C];
  int w;

  __device__ __forceinline__ PadWindow(float*, int width) : w(width) {}

  __device__ __forceinline__ float init(const float* xs, int lo, int m) {
    const int below = (C - 1 - w) / 2;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int k = i - below;
      const float v = xs[reflect(lo + min(max(k, 0), w - 1), m)];
      s[i] = k < 0 ? -CUDART_INF_F : (k < w ? v : CUDART_INF_F);
    }
    sort_registers(s);
    return s[C / 2 - 1];
  }

  __device__ __forceinline__ float slide(float a, float b) {
    slide_sorted(s, a, b);
    return s[C / 2 - 1];
  }
};

// The sorted window of any odd width w, each lane's in shared memory at
// s[i * 32].
struct SmemWindow {
  static constexpr bool kShared = true;
  float* s;
  int w;

  __device__ __forceinline__ SmemWindow(float* lane_window, int width)
      : s(lane_window), w(width) {}

  __device__ __forceinline__ float init(const float* xs, int lo, int m) {
    for (int k = 0; k < w; ++k) {
      const float v = xs[reflect(lo + k, m)];
      int i = k;
      for (; i > 0; --i) {
        const float below = s[(i - 1) * 32];
        if (below <= v) break;
        s[i * 32] = below;
      }
      s[i * 32] = v;
    }
    return s[(w / 2) * 32];
  }

  __device__ __forceinline__ float slide(float a, float b) {
    float prev = -CUDART_INF_F, cur = s[0];
    for (int i = 0; i < w; ++i) {
      const float next = i + 1 < w ? s[(i + 1) * 32] : CUDART_INF_F;
      const float u = cur < a ? cur : next;
      s[i * 32] = fminf(u, fmaxf(b, prev));
      prev = u;
      cur = next;
    }
    return s[(w / 2) * 32];
  }
};

// Filter columns [c0, c1) of the staged row xs into ys (x scale); the max.
template <class Window>
__device__ __forceinline__ float filter_run(Window& win, const float* xs,
                                            float* ys, int c0, int c1,
                                            int pad, int m, float scale) {
  float y = win.init(xs, c0 - pad, m) * scale;
  ys[c0] = y;
  float mx = y;
  for (int c = c0 + 1; c < c1; ++c) {
    y = win.slide(xs[reflect(c - 1 - pad, m)], xs[reflect(c + pad, m)]) *
        scale;
    ys[c] = y;
    mx = fmaxf(mx, y);
  }
  return mx;
}

// Start the copy of row r's valid frames into the buffer at dst0 (the
// frame of column c lands at dst0 + misalign(row) + c). Reads nothing for a
// row past the end or past its item's token_len.
__device__ __forceinline__ void stage_row(const float* qk,
                                          const int* frame_len,
                                          const int* token_len, long long r,
                                          long long n_rows, int h, int t,
                                          int f, float* dst0, int lane) {
  if (r >= n_rows) return;
  const int b = static_cast<int>(r / ((long long)h * t));
  if (static_cast<int>(r % t) >= token_len[b]) return;
  const int fl = min(frame_len[b], f);
  const float* src = qk + r * f;
  const int a = misalign(src);
  float* dst = dst0 + a;
  const int head = min((4 - a) & 3, fl);
  const int n4 = (fl - head) >> 2;
  const int tail = head + 4 * n4;
  if (lane < head) wca::cp_async<4>(dst + lane, src + lane, 4);
  for (int j = lane; j < n4; j += 32)
    wca::cp_async<16>(dst + head + 4 * j, src + head + 4 * j, 16);
  if (lane < fl - tail)
    wca::cp_async<4>(dst + tail + lane, src + tail + lane, 4);
}

// slot: floats of one row buffer, a multiple of 4 that holds F + 3.
template <class Window>
__global__ void __launch_bounds__(kThreads)
    qkpost_kernel(const float* __restrict__ qk, float* __restrict__ out,
                  const int* __restrict__ frame_len,
                  const int* __restrict__ token_len, int h, int t, int f,
                  int width, float qk_scale, int slot, long long n_rows) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pad = width / 2;
  float* base =
      smem + (size_t)warp * (3 * slot + (Window::kShared ? 32 * width : 0));
  float* ybuf = base + 2 * slot;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;

  stage_row(qk, frame_len, token_len, first, n_rows, h, t, f, base, lane);
  wca::cp_async_commit();
  int k = 0;
  for (long long r = first; r < n_rows; r += n_warps, ++k) {
    const float* cur = base + (k & 1) * slot;
    stage_row(qk, frame_len, token_len, r + n_warps, n_rows, h, t, f,
              base + ((k + 1) & 1) * slot, lane);
    wca::cp_async_commit();

    const int b = static_cast<int>(r / ((long long)h * t));
    const int tl = token_len[b];
    const int fl = min(frame_len[b], f);
    float* orow = out + r * f;
    const int oa = misalign(orow);
    const int ohead = min((4 - oa) & 3, f);
    const int on4 = (f - ohead) >> 2;
    const int otail = ohead + 4 * on4;
    if (static_cast<int>(r % t) >= tl) {
      if (lane < ohead) store1(orow + lane, 0.f);
      for (int j = lane; j < on4; j += 32)
        store4(orow + ohead + 4 * j, make_float4(0.f, 0.f, 0.f, 0.f));
      if (lane < f - otail) store1(orow + otail + lane, 0.f);
      continue;  // nothing was staged for this row
    }
    wca::cp_async_wait<1>();  // this row's copy is done (lane's own part)
    __syncwarp();             // ... and every lane's
    const float* xs = cur + misalign(qk + r * f);
    float* ys = ybuf + oa;  // ys + c is 16-byte aligned where orow + c is

    const int run = ((fl + 31) >> 5) | 1;
    const int c0 = lane * run, c1 = min(c0 + run, fl);
    const int m = fl - 1;
    float mx = -CUDART_INF_F;
    if (c0 < c1) {
      if (fl <= pad) {  // passed through unfiltered
        for (int c = c0; c < c1; ++c) {
          ys[c] = xs[c] * qk_scale;
          mx = fmaxf(mx, ys[c]);
        }
      } else {
        Window win(base + 3 * slot + lane, width);
        mx = filter_run(win, xs, ys, c0, c1, pad, m, qk_scale);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(wca::kFullMask, mx, off));
    __syncwarp();  // ys complete; xs read by every lane
    float sum = 0.f;
    for (int c = lane; c < fl; c += 32) {
      const float e = expf(ys[c] - mx);
      ys[c] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(wca::kFullMask, sum, off);
    __syncwarp();
    const float inv = 1.f / sum;
    if (lane < ohead) store1(orow + lane, lane < fl ? ys[lane] * inv : 0.f);
    for (int j = lane; j < on4; j += 32) {
      const int c = ohead + 4 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < fl) {
        const float4 e = *reinterpret_cast<const float4*>(ys + c);
        v.x = e.x * inv;
        v.y = c + 1 < fl ? e.y * inv : 0.f;
        v.z = c + 2 < fl ? e.z * inv : 0.f;
        v.w = c + 3 < fl ? e.w * inv : 0.f;
      }
      store4(orow + c, v);
    }
    if (lane < f - otail) {
      const int c = otail + lane;
      store1(orow + c, c < fl ? ys[c] * inv : 0.f);
    }
    __syncwarp();  // the buffers are free for the next rows
  }
  wca::cp_async_wait<0>();
}

template <class Window>
cudaError_t launch(const float* qk, float* out, const int* fl, const int* tl,
                   int b, int h, int t, int f, int width, float scale,
                   cudaStream_t s) {
  const int slot = (f + 3) / 4 * 4 + 4;
  const size_t smem =
      sizeof(float) * kWarps *
      (3 * (size_t)slot + (Window::kShared ? 32 * (size_t)width : 0));
  cudaError_t err = wca::allow_smem<qkpost_kernel<Window>>(smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, qkpost_kernel<Window>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long n_rows = (long long)b * h * t;
  long long blocks = (n_rows + kWarps - 1) / kWarps;
  blocks = std::min(blocks, (long long)kWaves * per_sm * sms);
  qkpost_kernel<Window><<<(unsigned)blocks, kThreads, smem, s>>>(
      qk, out, fl, tl, h, t, f, width, scale, slot, n_rows);
  return cudaGetLastError();
}

}  // namespace

// qk, out: (B, H, T, F) float32 contiguous; frame_len, token_len: (B,) int32.
WCA_EXPORT int wca_qkpost(const void* qk, void* out, const void* frame_len,
                          const void* token_len, int b, int h, int t, int f,
                          int width, float qk_scale, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || f <= 0 || width <= 0 || width % 2 != 1)
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(qk);
  float* y = static_cast<float*>(out);
  const int* fl = static_cast<const int*>(frame_len);
  const int* tl = static_cast<const int*>(token_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
#define WCA_QKPOST_REG(W) \
  case W:                 \
    return launch<RegWindow<W>>(x, y, fl, tl, b, h, t, f, width, qk_scale, s);
    WCA_QKPOST_REG(1) WCA_QKPOST_REG(3) WCA_QKPOST_REG(5) WCA_QKPOST_REG(7)
    WCA_QKPOST_REG(9) WCA_QKPOST_REG(11) WCA_QKPOST_REG(13) WCA_QKPOST_REG(15)
    WCA_QKPOST_REG(17) WCA_QKPOST_REG(19) WCA_QKPOST_REG(21) WCA_QKPOST_REG(23)
    WCA_QKPOST_REG(25) WCA_QKPOST_REG(27) WCA_QKPOST_REG(29)
    WCA_QKPOST_REG(kMaxExactWidth)
#undef WCA_QKPOST_REG
    default:
#define WCA_QKPOST_PAD(C)                                                 \
  if (width < C)                                                          \
    return launch<PadWindow<C>>(x, y, fl, tl, b, h, t, f, width, qk_scale, \
                                s);
      WCA_QKPOST_PAD(40) WCA_QKPOST_PAD(48) WCA_QKPOST_PAD(64)
      WCA_QKPOST_PAD(80) WCA_QKPOST_PAD(96) WCA_QKPOST_PAD(112)
      WCA_QKPOST_PAD(128)
#undef WCA_QKPOST_PAD
      return launch<SmemWindow>(x, y, fl, tl, b, h, t, f, width, qk_scale, s);
  }
}
