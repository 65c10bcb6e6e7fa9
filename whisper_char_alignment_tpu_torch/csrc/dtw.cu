// Monotonic DTW for word alignment: the anti-diagonal cost/trace wavefront
// (one block per item, rows in registers) and the backtrace to first-visit
// frames (one block per item, the trace streamed through shared memory).
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
// What bounds them on an H100: two chains of dependent steps, not bytes or
//   operations. The wavefront is a chain of N + M - 1 diagonals (1619 at
//   N=120, M=1500): each needs the two before it. The backtrace is a walk of
//   up to N + M steps, each reading the trace entry that the step before it
//   chose. The bytes (B*N*M f32 in, B*(N+M-1)*(N+1) int8 out) and the few
//   comparisons per cell take about 2 us of the card; what a step costs is
//   the latency of what lies on the chain.
//
// Design. The wavefront keeps memory off the chain. One block per item; each
//   warp owns 32 * R consecutive text rows (lane l holds rows l, l + 32, ...
//   of its warp's; R = 1 up to 256 rows, so the main path's N + 1 of about
//   100 rows take 3-4 warps on 4 schedulers, R = 2 up to 1024, R = 8 up to
//   4096)
//   and keeps its rows' previous diagonal in registers: cost[i-1, j] comes
//   from the lane below by one shuffle, and cost[i-1, j-1] is the value that
//   shuffle gave one diagonal earlier. There is no block barrier. The warps
//   run windows of P diagonals (R * P = 32), each a window behind the warp
//   below it: a warp's top row goes to the warp above through a shared ring
//   of a few windows of costs, and a per-warp count of finished windows
//   tells the warp above that a window is there (and the warp below that its
//   slots have been read); a waiting warp polls with pauses, so that its
//   polls do not slow the shuffles of the warp it waits for. The costs x arrive ahead of the wavefront: over a
//   window each row reads P consecutive x values, so while a warp computes a
//   window its loads of the next window are in flight (coalesced: the lanes
//   of a load read consecutive columns of a row, at any row alignment); it
//   then parks them in a shared buffer laid out [diagonal][row], padded so
//   that neither the parking nor the step's read has a bank conflict. Trace
//   stores are coalesced per diagonal (consecutive lanes, consecutive rows,
//   consecutive bytes) and nothing waits on them. Costs stay f32, added with
//   __fadd_rn.
//
//   The backtrace walks from diagonal n_b + m_b down. Its block streams
//   windows of W whole trace diagonals (W * (N+1) contiguous bytes, the
//   16-byte aligned superset copied with cp.async) into a double-buffered
//   shared ring: all threads copy window k+1 while one thread walks window k,
//   so each step's dependent read is a shared-memory load. Where none of the
//   next 8 steps can leave the window, the walker takes them with no test
//   between them (a step from row 0 or column 0 stays where it is), and forms
//   each step's next address from the trace byte by shifts and adds: the
//   chain is the load and a few integer operations. The jump frames
//   stay in shared memory (filled with -1 by all threads) and are written
//   once, coalesced. The path visits rows in decreasing order and, within a
//   row, frames in decreasing order, so the last frame written for a row is
//   its first visit; once the walk reaches column 0 the remaining rows keep
//   -1, and once it reaches row 0 it records nothing more, so it stops there.
#include <type_traits>

#include "common.cuh"

namespace {

using wca::kFullMask;

// ---------------------------------------------------------------------------
// 3a: the wavefront
// ---------------------------------------------------------------------------

// Window k of a warp covers diagonals 2 + k*kP .. 2 + k*kP + kP - 1. Each
// warp's top row goes to the warp above through a ring of kRing windows of
// costs in shared memory; done[w] counts the windows warp w has finished.
constexpr int kRing = 4;

__device__ __forceinline__ int load_volatile(const int* p) {
  return *(const volatile int*)p;
}

// kR text rows per lane, kP diagonals per window, up to kMaxWarps warps.
template <int kR, int kP, int kMaxWarps>
__global__ void __launch_bounds__(32 * kMaxWarps)
    dtw_trace_kernel(const float* __restrict__ x, int8_t* __restrict__ trace,
                     int n, int m) {
  constexpr int kRowsW = 32 * kR;
  // padded column of the staged window: a load instruction covers kG =
  // 32 / kP rows of kP diagonals each, which this pad spreads over the banks
  constexpr int kG = 32 / kP;
  constexpr int kStride = kRowsW + kG;
  constexpr int kStash = kR * kP;  // x values a lane carries per window
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n1 = n + 1;
  const float* xb = x + (size_t)blockIdx.x * n * m;
  int8_t* tb = trace + (size_t)blockIdx.x * (n + m - 1) * n1;
  float* stage = smem + (size_t)warp * kP * kStride;  // this warp's window
  float* ring = smem + (size_t)n_warps * kP * kStride;  // [n_warps][ring]
  int* done = reinterpret_cast<int*>(ring + n_warps * kRing * kP);
  const int row0 = warp * kRowsW;

  // x[i-1, d-i-1] for this warp's rows and the kP diagonals from d0: each
  // row's kP values are consecutive in x, so a load instruction reads kG
  // runs of kP floats. Lane l takes diagonal d0 + l % kP of rows i_l + q*kG
  // (q < kStash), i_l = row0 + l / kP: from one element to the next the row
  // grows by kG and the column falls by kG. A cell off the grid reads
  // nothing and gets +inf, so that its cost is +inf with no select.
  const int t_l = lane % kP, i_l = row0 + lane / kP;
  float stash[kStash];
  auto load = [&](int d0) {
    int c = d0 + t_l - i_l - 1;
    const float* src = xb + (ptrdiff_t)(i_l - 1) * m + c;
    if constexpr (kR > 1) {
      // a window whose cells all lie on the grid, the common case when a
      // warp owns many rows, loads with no bounds to test (the branch is
      // the same for the whole warp)
      if (row0 >= 1 && row0 + kRowsW <= n && d0 - row0 - kRowsW >= 0 &&
          d0 + kP - row0 - 1 <= m) {
#pragma unroll
        for (int q = 0; q < kStash; ++q) {
          stash[q] = __ldg(src);
          src += kG * (ptrdiff_t)(m - 1);
        }
        return;
      }
    }
#pragma unroll
    for (int q = 0; q < kStash; ++q) {
      const bool ok = ((unsigned)(i_l + q * kG - 1) < (unsigned)n) &
                      ((unsigned)c < (unsigned)m);
      stash[q] = ok ? __ldg(src) : CUDART_INF_F;
      src += kG * (ptrdiff_t)(m - 1);
      c -= kG;
    }
  };
  // ... parked at stage[(d - d0) * kStride + row - row0]
  float* park_at = stage + t_l * kStride + lane / kP;
  auto park = [&]() {
#pragma unroll
    for (int q = 0; q < kStash; ++q) park_at[q * kG] = stash[q];
  };

  float prev[kR];  // cost on the previous diagonal, this lane's rows
  float up2[kR];   // cost of the row below, two diagonals back
  int lim[kR];     // m for the text rows 1..n, 0 for row 0 and the padding
  int col[kR];     // the byte of a trace diagonal this row writes
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = row0 + lane + 32 * r;
    prev[r] = CUDART_INF_F;  // diagonal 1 is all +inf
    up2[r] = i == 1 ? 0.f : CUDART_INF_F;  // cost[0, 0]
    lim[r] = i >= 1 && i <= n ? m : 0;
    // padding rows write -1 where row 0 writes -1 too, so that no store
    // needs a predicate (a predicated store became a branch)
    col[r] = i <= n ? i : 0;
  }
  for (int k = threadIdx.x; k < n_warps * kRing * kP; k += blockDim.x)
    ring[k] = CUDART_INF_F;  // diagonal 1, below every warp's first window
  for (int k = threadIdx.x; k < n_warps; k += blockDim.x) done[k] = 0;
  __syncthreads();

  // one window of diagonals from d0, in registers: its x and, for lane 0,
  // the costs of the row below its first row one diagonal earlier
  const int last = n + m;
  const float* ring_in = ring + (warp - 1) * kRing * kP;  // warp - 1's top row
  float* ring_out = ring + warp * kRing * kP;
  auto window = [&](int k, auto whole) {
    const int d0 = 2 + k * kP;
    float xw[kP][kR], below[kP];
#pragma unroll
    for (int t = 0; t < kP; ++t) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        xw[t][r] = stage[t * kStride + lane + 32 * r];
      below[t] = warp > 0 ? ring_in[(d0 + t - 1) % (kRing * kP)]
                          : CUDART_INF_F;
    }
#pragma unroll
    for (int t = 0; t < kP; ++t) {
      const int d = d0 + t;
      if constexpr (!decltype(whole)::value)
        if (d > last) break;
      float rot[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        rot[r] = __shfl_sync(kFullMask, prev[r], (lane + 31) & 31);
      int8_t* trow = tb + (size_t)(d - 2) * n1;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        // cost[i-1, j]: lane 0's row r sits on lane 31's row r - 1
        const float c0 = up2[r], c2 = prev[r];
        const float c1 = lane ? rot[r] : (r ? rot[r ? r - 1 : 0] : below[t]);
        // selects, not branches: lanes disagree on every one of them. is0
        // and is1 exclude each other, so the diagonal-or-left select can
        // start before is1 is known, one select less on the chain.
        const bool is0 = (c0 < c1) & (c0 < c2);
        const bool is1 = (c1 < c0) & (c1 < c2);
        const float best = is1 ? c1 : (is0 ? c0 : c2);
        const bool valid =
            (unsigned)(d - (row0 + lane + 32 * r) - 1) < (unsigned)lim[r];
        up2[r] = c1;
        prev[r] = __fadd_rn(xw[t][r], best);
        trow[col[r]] = valid ? (is0 ? 0 : (is1 ? 1 : 2)) : -1;
      }
      if (lane == 31) ring_out[d % (kRing * kP)] = prev[kR - 1];
    }
  };
  // wait until *flag >= v (one lane polls; the warp waits with it). The
  // pause keeps a waiting warp's polls off the shared-memory pipe that the
  // warps it waits for need for their shuffles.
  auto wait_for = [&](const int* flag, int v) {
    if (lane == 0)
      while (load_volatile(flag) < v) __nanosleep(32);
    __syncwarp();
    __threadfence_block();
  };

  const int n_win = (last - 1 + kP - 1) / kP;  // diagonals 2..last
  load(2);
  park();
  __syncwarp();
  for (int k = 0; k < n_win; ++k) {
    // the warp below has finished this window, and the warp above has
    // read what this window overwrites in the ring
    if (warp > 0) wait_for(done + warp - 1, k + 1);
    if (warp + 1 < n_warps) wait_for(done + warp + 1, k - kRing + 2);
    if (k + 1 < n_win) {
      load(2 + (k + 1) * kP);  // in flight while this window is computed
      window(k, std::true_type());
      __syncwarp();  // every lane has read this window's x
      park();
    } else {
      window(k, std::false_type());
    }
    __syncwarp();
    __threadfence_block();  // the ring's costs before the count
    if (lane == 0) *(volatile int*)(done + warp) = k + 1;
  }
}

template <int kR, int kP, int kMaxWarps>
cudaError_t launch_trace(const float* x, int8_t* trace, int b, int n, int m,
                         cudaStream_t stream) {
  const int warps = (n + 1 + 32 * kR - 1) / (32 * kR);
  if (warps > kMaxWarps) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)warps * kP * (32 * kR + 32 / kP) +
                                       (size_t)warps * kRing * kP) +
                      sizeof(int) * warps;
  const cudaError_t err =
      wca::allow_smem<dtw_trace_kernel<kR, kP, kMaxWarps>>(smem);
  if (err != cudaSuccess) return err;
  dtw_trace_kernel<kR, kP, kMaxWarps>
      <<<b, 32 * warps, smem, stream>>>(x, trace, n, m);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3b: the backtrace
// ---------------------------------------------------------------------------

constexpr int kBtThreads = 128;
// bytes of trace per window: W = max(2, kBtWindowBytes / (N + 1)) diagonals
// (ops/dtw_cuda.backtrace_window says the same)
constexpr int kBtWindowBytes = 16384;
// walk steps taken between two tests of the walk's position
constexpr int kWalkRun = 8;

__host__ __device__ inline int round16(long long v) {
  return (int)((v + 15) / 16 * 16);
}

__global__ void __launch_bounds__(kBtThreads)
    dtw_backtrace_kernel(const int8_t* __restrict__ trace,
                         const int* __restrict__ n_len,
                         const int* __restrict__ m_len, int* __restrict__ jump,
                         int n, int m, int win, long long total) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int done;
  const int n1 = n + 1;
  const int tid = threadIdx.x;
  // jb[-1] takes what a step on row 0 records
  int* jb = reinterpret_cast<int*>(sm) + 1;
  const int buf_bytes = round16((long long)win * n1 + 32);
  unsigned char* bufs = sm + round16(4LL * (n1 + 1));
  // this item's trace, as a byte offset from the (16-byte aligned) base
  const long long item = (long long)blockIdx.x * (n + m - 1) * n1;

  for (int r = tid - 1; r < n1; r += kBtThreads) jb[r] = -1;
  int i = min(max(n_len[blockIdx.x], 0), n);
  int j = min(max(m_len[blockIdx.x], 0), m);
  const int top = i + j;
  // windows of diagonals from the top down to diagonal 2, the last read;
  // a walk that starts on row 0 or column 0 reads nothing and records
  // nothing but -1
  const int n_win = i > 0 && j > 0 ? (top - 2 + win) / win : 0;
  auto lo_of = [&](int k) { return max(top - k * win - win + 1, 2); };
  // window k's bytes: trace rows lo - 2 .. hi - 2, from a 16-byte boundary
  auto issue = [&](int k) {
    const int hi = top - k * win;
    const long long g_lo = item + (long long)(lo_of(k) - 2) * n1;
    const long long g_hi = item + (long long)(hi - 1) * n1;
    const long long a_lo = g_lo & ~15LL;
    unsigned char* buf = bufs + (k & 1) * buf_bytes;
    for (long long off = a_lo + 16LL * tid; off < g_hi; off += 16 * kBtThreads)
      wca::cp_async<16>(buf + (off - a_lo), trace + off,
                        (int)min(16LL, total - off));
  };

  if (tid == 0) done = 0;
  if (n_win > 0) issue(0);
  wca::cp_async_commit();
  __syncthreads();
  for (int k = 0; k < n_win; ++k) {
    if (k + 1 < n_win) issue(k + 1);
    wca::cp_async_commit();
    wca::cp_async_wait<1>();  // window k has landed
    __syncthreads();
    if (tid == 0) {
      const int lo = lo_of(k);
      const long long g_lo = item + (long long)(lo - 2) * n1;
      const unsigned char* base =
          bufs + (k & 1) * buf_bytes + (g_lo - (g_lo & ~15LL));
      // the entry of (i, j) in this window: base + (i + j - lo) * n1 + i
      const int8_t* p = reinterpret_cast<const int8_t*>(base) +
                        (long long)(i + j - lo) * n1 + i;
      // kWalkRun steps at a time, with no test between them, while none of
      // them can leave the window (a step lowers i + j by 1 or 2). Inside
      // the grid t is 0, 1 or 2 and the step goes back 2n1 + 1, n1 + 1 or
      // n1 bytes: shifts and adds on t, no branch and no select on the
      // chain. A step taken from row 0 or column 0 reads -1 there (the
      // trace holds -1 on row 0 and at j < 1); with n1 + 1 in place of
      // -(n1 + 1) it then moves 0 bytes, and i and j stay: the walk ends.
      while (i + j - 2 * kWalkRun >= lo && i > 0 && j > 0) {
#pragma unroll
        for (int u = 0; u < kWalkRun; ++u) {
          jb[i - 1] = j - 1;
          const int t = *p;
          const bool live = (i > 0) & (j > 0);
          p += (live ? -(n1 + 1) : n1 + 1) + (t >> 1) -
               (((t - 1) >> 31) & n1);
          i -= live & ((unsigned)t < 2u);
          j -= live & (t != 1);
        }
      }
      // then one step at a time. t = 0: diagonal, 1: up, anything else:
      // left; the three entries a step can go to are formed while its load
      // is in flight.
      while (i > 0 && j > 0 && i + j >= lo) {
        jb[i - 1] = j - 1;
        const int8_t* p_diag = p - (2 * n1 + 1);
        const int8_t* p_up = p - (n1 + 1);
        const int8_t* p_left = p - n1;
        const int t = *p;
        const bool up = (unsigned)t < 2u, left = t != 1;
        p = t == 0 ? p_diag : (up ? p_up : p_left);
        i -= up;
        j -= left;
      }
      if (i == 0 || j == 0) {
        if (i > 0) jb[i - 1] = -1;  // a walk down column 0 enters row i there
        done = 1;
      }
    }
    __syncthreads();  // the walker is done with window k
    if (done) break;
  }
  wca::cp_async_wait<0>();  // a walk that ended early leaves a copy in flight
  __syncthreads();
  int* out = jump + (size_t)blockIdx.x * n1;
  for (int r = tid; r < n1; r += kBtThreads) out[r] = jb[r];
}

// ---------------------------------------------------------------------------
// the chain floor: latency of one dependent shuffle and one dependent
// shared-memory load on this card, as clock cycles and nanoseconds
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void dtw_chain_probe_kernel(int steps, double* out) {
  __shared__ int ring[256];
  const int lane = threadIdx.x;
  for (int k = lane; k < 256; k += 32) ring[k] = (k + 37) & 255;
  __syncwarp();
  float v = (float)lane;
  long long c0 = clock64();
  unsigned long long t0 = global_ns();
  for (int s = 0; s < steps; ++s)
    v = __shfl_sync(kFullMask, v, (lane + 1) & 31);
  long long c1 = clock64();
  unsigned long long t1 = global_ns();
  int p = lane;
  for (int s = 0; s < steps; ++s) p = *(volatile int*)&ring[p];
  long long c2 = clock64();
  unsigned long long t2 = global_ns();
  if (lane == 0) {
    out[0] = (double)(c1 - c0) / steps;
    out[1] = (double)(t1 - t0) / steps;
    out[2] = (double)(c2 - c1) / steps;
    out[3] = (double)(t2 - t1) / steps;
    out[4] = v + p;  // keeps both chains
  }
}

}  // namespace

// x: (B, N, M) float32 costs; trace: (B, N+M-1, N+1) int8 out.
WCA_EXPORT int wca_dtw_trace(const void* x, void* trace, int b, int n, int m,
                             void* stream) {
  if (b <= 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  int8_t* tp = static_cast<int8_t*>(trace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = n + 1;
  // one row per lane to 256 rows (8 warps), then 2 rows per lane (16
  // warps), then 8; kR * kP = 32 x values per lane and window, and few
  // enough threads that no thread is held to 64 registers
  if (rows <= 256) return launch_trace<1, 32, 8>(xp, tp, b, n, m, s);
  if (rows <= 1024) return launch_trace<2, 16, 16>(xp, tp, b, n, m, s);
  if (rows <= 4096) return launch_trace<8, 4, 16>(xp, tp, b, n, m, s);
  return cudaErrorInvalidValue;
}

// trace: (B, N+M-1, N+1) int8, 16-byte aligned; n_len, m_len: (B,) int32;
// jump: (B, N+1) int32.
WCA_EXPORT int wca_dtw_backtrace(const void* trace, const void* n_len,
                                 const void* m_len, void* jump, int b, int n,
                                 int m, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  const int n1 = n + 1;
  const int win = kBtWindowBytes / n1 > 2 ? kBtWindowBytes / n1 : 2;
  const size_t smem = round16(4LL * (n1 + 1)) +
                      2 * (size_t)round16((long long)win * n1 + 32);
  const cudaError_t err = wca::allow_smem<dtw_backtrace_kernel>(smem);
  if (err != cudaSuccess) return err;
  dtw_backtrace_kernel<<<b, kBtThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(trace), static_cast<const int*>(n_len),
      static_cast<const int*>(m_len), static_cast<int*>(jump), n, m, win,
      (long long)b * (n + m - 1) * n1);
  return cudaGetLastError();
}

// out: 5 float64 on the card: cycles and ns per dependent shuffle, cycles and
// ns per dependent shared-memory load, and a checksum; one warp, `steps`
// steps of each chain.
WCA_EXPORT int wca_dtw_chain_probe(void* out, int steps, void* stream) {
  if (steps <= 0) return cudaErrorInvalidValue;
  dtw_chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<double*>(out));
  return cudaGetLastError();
}
