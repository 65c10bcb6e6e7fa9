// Monotonic DTW for word alignment: the anti-diagonal cost/trace wavefront
// (one block per item) and the backtrace to first-visit frames (one thread
// per item).
//
// Replaces: whisper_char_alignment_tpu/ops/dtw_pallas.py, _dtw_trace_raw
//   (its _dtw_kernel) and dtw_jump_frames_pallas (its _backtrace_kernel).
//   Same function as ops/dtw.py: over the (N+1, M+1) cost grid,
//   cost[i, j] = x[i-1, j-1] + min(cost[i-1, j-1], cost[i-1, j], cost[i, j-1])
//   with the asymmetric tie-break (diagonal only on a strict minimum, else up
//   only on a strict minimum, else left), cells with j > M at +inf, the int8
//   trace stored per anti-diagonal as trace[b, i + j - 2, i]; then each item's
//   walk from (n_b, m_b) to (0, 0) (i == 0 -> left, j == 0 -> up), recording
//   the first frame at which the path enters each text row; rows >= n_b -> -1.
//
// What bounds it on an H100: the N + M - 1 dependent diagonal steps. Each
//   diagonal needs the two before it, so an item's recurrence is a chain of
//   ~N+M block-wide barriers (1619 at N=120, M=1500); the bytes (B*N*M f32
//   in, B*(N+M)*(N+1) int8 out) and the few comparisons per cell are small
//   beside it. The backtrace is a chain of up to N+M dependent trace reads.
//
// Design: the wavefront gives each item one block whose threads own text
//   rows i = 0..N (strided when N+1 > 1024). The two previous cost diagonals
//   sit in shared memory in a ring of three buffers: diagonal d writes buffer
//   d % 3 while reading (d-1) % 3 and (d-2) % 3, so one __syncthreads() per
//   diagonal orders every write before its readers and every read before the
//   buffer is reused. Costs stay f32 (bf16 costs move the paths). One block
//   per item leaves most of the 132 SMs idle at B=8: accepted in this first
//   version. The backtrace needs no cooperation: the path visits rows in
//   decreasing order and, within a row, frames in decreasing order, so the
//   last frame written for a row is its first visit.
#include "common.cuh"

namespace {

__global__ void dtw_trace_kernel(const float* __restrict__ x,
                                 int8_t* __restrict__ trace, int n, int m) {
  extern __shared__ float ring[];  // 3 x (n + 1) costs
  const int n1 = n + 1;
  const int b = blockIdx.x;
  const float* xb = x + (size_t)b * n * m;
  int8_t* tb = trace + (size_t)b * (n + m - 1) * n1;

  // diagonal 0 holds cost[0, 0] = 0; diagonal 1 is all +inf
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    ring[i] = i == 0 ? 0.f : CUDART_INF_F;
    ring[n1 + i] = CUDART_INF_F;
  }
  __syncthreads();

  for (int d = 2; d <= n + m; ++d) {
    const float* prev = ring + ((d - 1) % 3) * n1;   // cost[., j-1] / [i-1, j]
    const float* prev2 = ring + ((d - 2) % 3) * n1;  // cost[i-1, j-1]
    float* cur = ring + (d % 3) * n1;
    int8_t* trow = tb + (size_t)(d - 2) * n1;
    for (int i = threadIdx.x; i < n1; i += blockDim.x) {
      const int j = d - i;
      float c = CUDART_INF_F;
      int8_t tr = -1;
      if (i >= 1 && j >= 1 && j <= m) {
        const float c0 = prev2[i - 1], c1 = prev[i - 1], c2 = prev[i];
        float best;
        if (c0 < c1 && c0 < c2) {
          best = c0;
          tr = 0;
        } else if (c1 < c0 && c1 < c2) {
          best = c1;
          tr = 1;
        } else {
          best = c2;
          tr = 2;
        }
        c = __fadd_rn(xb[(size_t)(i - 1) * m + (j - 1)], best);
      }
      cur[i] = c;
      trow[i] = tr;
    }
    __syncthreads();
  }
}

__global__ void dtw_backtrace_kernel(const int8_t* __restrict__ trace,
                                     const int* __restrict__ n_len,
                                     const int* __restrict__ m_len,
                                     int* __restrict__ jump, int batch, int n,
                                     int m) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int n1 = n + 1;
  const int8_t* tb = trace + (size_t)b * (n + m - 1) * n1;
  int* jb = jump + (size_t)b * n1;
  for (int r = 0; r < n1; ++r) jb[r] = -1;
  int i = min(max(n_len[b], 0), n);
  int j = min(max(m_len[b], 0), m);
  while (i > 0 || j > 0) {
    if (i > 0) jb[i - 1] = j - 1;
    const int t = i == 0 ? 2 : (j == 0 ? 1 : tb[(size_t)(i + j - 2) * n1 + i]);
    if (t == 0) {
      --i;
      --j;
    } else if (t == 1) {
      --i;
    } else {
      --j;
    }
  }
}

}  // namespace

// x: (B, N, M) float32 costs; trace: (B, N+M-1, N+1) int8 out.
WCA_EXPORT int wca_dtw_trace(const void* x, void* trace, int b, int n, int m,
                             void* stream) {
  if (b <= 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  const size_t smem = 3 * sizeof(float) * (size_t)(n + 1);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  int threads = ((n + 1 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dtw_trace_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(trace), n, m);
  return cudaGetLastError();
}

// trace: (B, N+M-1, N+1) int8; n_len, m_len: (B,) int32; jump: (B, N+1) int32.
WCA_EXPORT int wca_dtw_backtrace(const void* trace, const void* n_len,
                                 const void* m_len, void* jump, int b, int n,
                                 int m, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  const int threads = 64;
  dtw_backtrace_kernel<<<(b + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(trace), static_cast<const int*>(n_len),
      static_cast<const int*>(m_len), static_cast<int*>(jump), b, n, m);
  return cudaGetLastError();
}
