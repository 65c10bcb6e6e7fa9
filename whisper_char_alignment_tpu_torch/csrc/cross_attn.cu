// One decode step's cross-attention, one block per (batch item, head),
// streaming its K and V panels through shared memory.
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
//   hd=64, F=384 (the 128-frame bucket) that is 6.3 MB of int8 codes and
//   0.4 MB of scales (2.0 us at 3.35 TB/s); at F=1500 26.2 MB (7.8 us), or
//   49.2 MB in bf16 (14.7 us). The work is 49 MFLOP at most.
//
// Design: K and V are laid out (hd, F): row d of a panel holds frame after
//   frame, so 16 or more consecutive rows are one contiguous, 16-byte
//   aligned run (16*F*elem bytes from a multiple of it). Splitting the
//   frames over many blocks instead makes each read short pieces of every
//   row, F*elem bytes apart; those designs (a cluster per (item, head),
//   warps owning 32 frames) were slower at F=1500 and in bf16. Here one
//   block of 16 warps takes one (item, head) (128 blocks at B*H = 128: one
//   wave, no cluster, nothing to fold across blocks) and streams its panels
//   run by run, K rows then V rows, through a ring of 3 shared-memory
//   stages. Each run is one bulk copy (cp.async.bulk, completing on the
//   stage's mbarrier), started by one thread: per-thread cp.async kept too
//   few bytes in flight per SM. The first run also brings q and the scales.
//   Runs are as long as fit 48 KB (the whole panel at F=384 in int8, 32
//   rows at F=1500), so a short F takes few steps. Each thread keeps the
//   scores of the frames tid, tid + 512, ... in registers (code unrolled
//   for the count it holds, four chains each) and adds a K run's rows;
//   after the last K run two block reductions give the max and the sum and
//   w = e^(s - m) [* v_s] goes to shared memory; on a V run each warp takes
//   1-8 rows at once, its lanes walk the frames (each w[f] read once for
//   all of them) and shuffles fold sum_f v[d, f] w[f]. int8 codes become
//   floats through one OR and one add (0x4B0000uu = 2^23 + c + 128),
//   exact, instead of the quarter-rate integer conversion. int8 K/V take
//   one stage, up to 3072 frames (Whisper's window is 1500): more is
//   refused. Float K/V beyond a stage's width (1536 bf16 or 512 f32
//   frames) are walked in frame chunks with a running max; those runs are
//   no longer contiguous and go by per-thread 16-byte cp.async of each
//   row's aligned span, its byte shift kept beside it, reads stopping at
//   the chunk's end, so shared memory stays under ~211 KB whatever F. What
//   is left is the block's chain per run (wait, barrier, dependent loads,
//   reductions) on one SM: with L2-warm inputs it runs only ~25% faster
//   than from HBM. With one batch item only H blocks run (16 of 132 SMs at
//   H=16), each through the same chain, so B=1 sits further above its
//   bound than B=8.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;  // rows per run, at least: one per warp in P.V
constexpr int kStages = 3;     // runs in flight
constexpr int kRunBytes = 49152;  // a run of a single frame chunk, at most

// Widest frame chunk: a run of kRows rows stays near 48 KB.
template <typename T>
__host__ __device__ constexpr int max_chunk() {
  return sizeof(T) == 1 ? 3072 : sizeof(T) == 2 ? 1536 : 512;
}

// Bytes of a staged row: a chunk's frames, up to 15 bytes of shift and the
// last 16-byte copy's overhang, rounded to 16.
template <typename T>
__host__ __device__ constexpr int staged_row(int chunk) {
  return (chunk * (int)sizeof(T) + 30 + 15) / 16 * 16;
}

// cp.async.wait_group with a count known at run time (0 .. kStages - 1).
__device__ __forceinline__ void cp_async_wait_n(int pending) {
  if (pending <= 0)
    wca::cp_async_wait<0>();
  else if (pending == 1)
    wca::cp_async_wait<1>();
  else
    wca::cp_async_wait<2>();
}

// mbarrier helpers for the bulk copies (one arrival: the issuing thread).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
// Arrive on `bar` expecting `bytes` of bulk copies to land on it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory with the bulk-copy engine, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// e^(m_part - m) for a running max: 0 before the first chunk.
__device__ __forceinline__ float rescale(float m_part, float m) {
  return m_part == -CUDART_INF_F ? 0.f : expf(m_part - m);
}

// The frame at byte p of a staged row, as a float; int8 codes exactly, via
// 0x4B0000uu = 2^23 + u for u = c + 128.
template <typename T>
__device__ __forceinline__ float frame_at(const unsigned char* p);
template <>
__device__ __forceinline__ float frame_at<int8_t>(const unsigned char* p) {
  return __int_as_float(0x4B000000u | (*p ^ 0x80u)) - 8388736.f;
}
template <>
__device__ __forceinline__ float frame_at<__nv_bfloat16>(
    const unsigned char* p) {
  return __uint_as_float(
      (uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
}
template <>
__device__ __forceinline__ float frame_at<float>(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

// s[j] += sum over a run's rows d0 .. d0 + rows - 1 of q[d] * K[d, frame of
// slot j], for the first kSlots slots (frames tid + j * kThreads: row + j *
// kThreads * elem). Four chains per slot.
template <typename T, int kSlots, int kMax>
__device__ __forceinline__ void score_run(float (&s)[kMax],
                                          const unsigned char* run, int ldr,
                                          int rows, int d0, const float* qs,
                                          int frame_byte, bool bulk,
                                          size_t f_bytes, size_t f0_bytes) {
  float acc[kSlots][4];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    acc[j][0] = s[j], acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
  for (int rr = 0; rr < rows; rr += 4) {  // rows and d0: multiples of 16
    const float4 q4 = *reinterpret_cast<const float4*>(qs + d0 + rr);
    const float qd[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int shift =
          bulk ? 0 : (int)(((size_t)(d0 + rr + i) * f_bytes + f0_bytes) & 15);
      const unsigned char* row = run + (rr + i) * ldr + shift + frame_byte;
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        acc[j][i] = fmaf(frame_at<T>(row + j * kThreads * (int)sizeof(T)),
                         qd[i], acc[j][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    s[j] = (acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3]);
}

// score_run for the slots (1 .. kMax) that hold frames, chosen at run time.
template <typename T, int kSlots, int kMax>
__device__ __forceinline__ void score_run_n(int slots, float (&s)[kMax],
                                            const unsigned char* run, int ldr,
                                            int rows, int d0, const float* qs,
                                            int frame_byte, bool bulk,
                                            size_t f_bytes, size_t f0_bytes) {
  if constexpr (kSlots <= kMax) {
    if (slots == kSlots)
      score_run<T, kSlots, kMax>(s, run, ldr, rows, d0, qs, frame_byte, bulk,
                                 f_bytes, f0_bytes);
    else
      score_run_n<T, kSlots + 1, kMax>(slots, s, run, ldr, rows, d0, qs,
                                       frame_byte, bulk, f_bytes, f0_bytes);
  }
}

// os[d] = os[d] * alpha + sum_f V[d, f] w[f] for the kR rows d of a V run
// that warp `warp` takes (rows warp, warp + kWarps, ...; the run's first row
// is panel row d0), lanes over the frames, each w[f] read once for all kR.
template <typename T, int kR>
__device__ __forceinline__ void pv_rows(float* os, float alpha,
                                        const unsigned char* run, int ldr,
                                        int d0, const float* w, int n,
                                        bool bulk, size_t f_bytes,
                                        size_t f0_bytes) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* row[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int rr = warp + i * kWarps;
    const int shift =
        bulk ? 0 : (int)(((size_t)(d0 + rr) * f_bytes + f0_bytes) & 15);
    row[i] = run + rr * ldr + shift;
  }
  float pv[kR][2];
#pragma unroll
  for (int i = 0; i < kR; ++i) pv[i][0] = pv[i][1] = 0.f;
  int f = lane;
  for (; f + 32 < n; f += 64) {
    const float w0 = w[f], w1 = w[f + 32];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      pv[i][0] = fmaf(frame_at<T>(row[i] + f * (int)sizeof(T)), w0, pv[i][0]);
      pv[i][1] = fmaf(frame_at<T>(row[i] + (f + 32) * (int)sizeof(T)), w1,
                      pv[i][1]);
    }
  }
  if (f < n) {
    const float w0 = w[f];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      pv[i][0] = fmaf(frame_at<T>(row[i] + f * (int)sizeof(T)), w0, pv[i][0]);
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    float sum = pv[i][0] + pv[i][1];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(wca::kFullMask, sum, off);
    const int d = d0 + warp + i * kWarps;
    if (lane == 0) os[d] = os[d] * alpha + sum;
  }
}

// One decode step for the (item, head) blockIdx.x. chunk: frames per frame
// chunk (<= max_chunk<T>(); int8: one chunk); rows: rows per run (kRows, or
// with one frame chunk up to HD: as many as fit kRunBytes).
template <typename T, int HD, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    cross_attn_kernel(const float* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ k_s, const T* __restrict__ v,
                      const float* __restrict__ v_s, float* __restrict__ o,
                      int n_frames, int chunk, int rows, float k_scale) {
  constexpr int kElem = sizeof(T);
  const int kRuns = HD / rows;  // runs per panel
  // frames a thread scores: tid, tid + kThreads, ...
  constexpr int kPerThread = max_chunk<T>() / kThreads;
  const int n_chunks = (n_frames + chunk - 1) / chunk;
  const size_t f_bytes = (size_t)n_frames * kElem;  // one row of a panel
  // one frame chunk: a run of `rows` rows is one contiguous, 16-byte
  // aligned span (rows * F * elem bytes from a multiple of it), one bulk copy
  const bool bulk = n_chunks == 1;
  const int ldr = bulk ? (int)f_bytes : staged_row<T>(chunk);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // [kStages]
  unsigned char* ring = smem_raw + 64;                 // [kStages][rows][ldr]
  float* scales = reinterpret_cast<float*>(ring + kStages * rows * ldr);
  float* w = scales + (kQuant ? 2 * chunk : 0);  // k_s, v_s; then w [chunk]
  float* qs = w + chunk;          // [HD]
  float* os = qs + HD;            // [HD]
  float* red = os + HD;           // [kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = blockIdx.x;
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k) + bh * HD * f_bytes;
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v) + bh * HD * f_bytes;
  const int n_runs = n_chunks * 2 * kRuns;  // per frame chunk: K runs, V runs
  // q is copied with the first run when bulk; so are the scales (int8 is
  // always bulk) where their rows are 16-byte aligned: F a multiple of 4 and
  // aligned bases (the scales may be a view into a larger tensor)
  const bool q_bulk = bulk && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool s_bulk = kQuant && n_frames % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(k_s) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(v_s) % 16 == 0;
  const uint32_t side = s_bulk ? 8u * n_frames : 0u;
  if (bulk && tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // run c into its stage: `rows` rows of a panel's frames [f0, f0 + n), by
  // one bulk copy, or per thread with each row as the 16-byte aligned span
  // that holds it (float K/V only)
  auto fetch = [&](int c) {
    const int fc = c / (2 * kRuns), r = c % (2 * kRuns);
    const int f0 = fc * chunk, n = min(chunk, n_frames - f0);
    const unsigned char* src = r < kRuns ? kb : vb;
    const int row0 = (r % kRuns) * rows;
    unsigned char* dst = ring + (c % kStages) * rows * ldr;
    if (bulk) {
      if (tid == 0) {
        // the stage's last readers passed a block barrier; order their reads
        // before the bulk engine's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t bytes = (uint32_t)(rows * f_bytes);
        // the first run also brings q and, where aligned, the scales
        mbar_expect(bars + c % kStages,
                    bytes + (c == 0 ? (q_bulk ? HD * 4u : 0u) + side : 0u));
        if (c == 0) {
          if (q_bulk) bulk_copy(qs, q + bh * HD, HD * 4, bars);
          if (side) {
            bulk_copy(scales, k_s + bh * n_frames, n_frames * 4, bars);
            bulk_copy(scales + chunk, v_s + bh * n_frames, n_frames * 4, bars);
          }
        }
        bulk_copy(dst, src + row0 * f_bytes, bytes, bars + c % kStages);
      }
      return;
    }
    const int per_row = (n * kElem + 30) / 16;  // copies per row
    for (int i = tid; i < rows * per_row; i += kThreads) {
      const int rr = i / per_row, piece = i % per_row;
      const size_t a = (size_t)(row0 + rr) * f_bytes + (size_t)f0 * kElem;
      const size_t from = (a & ~(size_t)15) + 16 * piece;
      const long long left = (long long)(a + n * kElem) - (long long)from;
      const int valid = left <= 0 ? 0 : left >= 16 ? 16 : (int)left;
      wca::cp_async<16>(dst + rr * ldr + 16 * piece,
                        src + (valid > 0 ? from : 0), valid);
    }
    wca::cp_async_commit();
  };

  for (int c = 0; c < kStages && c < n_runs; ++c) fetch(c);
  // q's (and, with bulk copies, the scales') loads wait while the copies are
  // in flight
  for (int d = tid; d < HD; d += kThreads) {
    if (!q_bulk) qs[d] = q[bh * HD + d];
    os[d] = 0.f;
  }
  if (kQuant && !s_bulk) {
    for (int f = tid; f < n_frames; f += kThreads) {
      scales[f] = k_s[bh * n_frames + f];
      scales[chunk + f] = v_s[bh * n_frames + f];
    }
  }

  float m_run = -CUDART_INF_F, l_run = 0.f, alpha = 0.f;
  float s[kPerThread];
  for (int c = 0; c < n_runs; ++c) {
    const int fc = c / (2 * kRuns), r = c % (2 * kRuns);
    const int f0 = fc * chunk, n = min(chunk, n_frames - f0);
    if (bulk)  // run c landed: its stage's (c / kStages)-th completion
      mbar_wait(bars + c % kStages, (c / kStages) & 1);
    else
      cp_async_wait_n(min(kStages - 1, n_runs - 1 - c));
    __syncthreads();
    const unsigned char* run = ring + (c % kStages) * rows * ldr;
    if (r < kRuns) {  // K rows: every thread's frames, over `rows` more rows
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) s[j] = 0.f;
      }
      // this thread's frames tid, tid + kThreads, ... below n
      const int slots = tid < n ? (n - tid + kThreads - 1) / kThreads : 0;
      if (slots > 0)
        score_run_n<T, 1, kPerThread>(slots, s, run, ldr, rows, r * rows, qs,
                                      tid * kElem, bulk, f_bytes,
                                      (size_t)f0 * kElem);
      if (r == kRuns - 1) {  // the chunk's scores are whole: softmax step
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int f = tid + j * kThreads;
          if (f < n) {
            s[j] = (kQuant ? s[j] * scales[f] : s[j]) * k_scale;
            mx = fmaxf(mx, s[j]);
          }
        }
        const float m_new = fmaxf(m_run, wca::block_reduce<true>(mx, red));
        alpha = rescale(m_run, m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int f = tid + j * kThreads;
          if (f < n) {
            const float e = expf(s[j] - m_new);
            sum += e;
            w[f] = kQuant ? e * scales[chunk + f] : e;
          }
        }
        l_run = l_run * alpha + wca::block_reduce<false>(sum, red);
        m_run = m_new;
      }
    } else {  // V rows: warps over rows, lanes over the frames
      const int d0 = (r - kRuns) * rows;
      const size_t f0b = (size_t)f0 * kElem;
      if (rows == kRows)
        pv_rows<T, 1>(os, alpha, run, ldr, d0, w, n, bulk, f_bytes, f0b);
      else if (rows == 2 * kRows)
        pv_rows<T, 2>(os, alpha, run, ldr, d0, w, n, bulk, f_bytes, f0b);
      else if (rows == 4 * kRows)
        pv_rows<T, 4>(os, alpha, run, ldr, d0, w, n, bulk, f_bytes, f0b);
      else
        pv_rows<T, 8>(os, alpha, run, ldr, d0, w, n, bulk, f_bytes, f0b);
    }
    __syncthreads();  // run c's stage (and, after a V run, w) is free
    if (c + kStages < n_runs) fetch(c + kStages);
  }
  for (int d = tid; d < HD; d += kThreads) o[bh * HD + d] = os[d] / l_run;
}

template <typename T, int HD, bool kQuant>
cudaError_t launch(const void* q, const void* k, const void* k_s,
                   const void* v, const void* v_s, void* o, int bh,
                   int n_frames, float k_scale, cudaStream_t stream) {
  // frame chunks of equal width, at most max_chunk<T>(), a multiple of 4
  const int n_chunks = (n_frames + max_chunk<T>() - 1) / max_chunk<T>();
  if (kQuant && n_chunks > 1) return cudaErrorInvalidValue;  // int8: 1 stage
  const int chunk = ((n_frames + n_chunks - 1) / n_chunks + 3) / 4 * 4;
  const int ldr =
      n_chunks == 1 ? n_frames * (int)sizeof(T) : staged_row<T>(chunk);
  // with one frame chunk, runs as long as kRunBytes allows (fewer, longer
  // runs: fewer steps of the block's chain for a short F)
  int rows = kRows;
  while (n_chunks == 1 && rows * 2 <= HD && rows * 2 * ldr <= kRunBytes)
    rows *= 2;
  const size_t smem = 64 + (size_t)kStages * rows * ldr +
                      sizeof(float) * ((kQuant ? 3 : 1) * chunk + 2 * HD +
                                       kWarps);
  constexpr auto kernel = cross_attn_kernel<T, HD, kQuant>;
  cudaError_t err = wca::allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<bh, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const float*>(k_s), static_cast<const T*>(v),
      static_cast<const float*>(v_s), static_cast<float*>(o), n_frames, chunk,
      rows, k_scale);
  return cudaGetLastError();
}

template <typename T, bool kQuant>
int dispatch(const void* q, const void* k, const void* k_s, const void* v,
             const void* v_s, void* o, int bh, int hd, int n_frames,
             float k_scale, void* stream) {
  if (bh <= 0 || n_frames <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<T, 16, kQuant>(q, k, k_s, v, v_s, o, bh, n_frames,
                                   k_scale, s);
    case 32:
      return launch<T, 32, kQuant>(q, k, k_s, v, v_s, o, bh, n_frames,
                                   k_scale, s);
    case 64:
      return launch<T, 64, kQuant>(q, k, k_s, v, v_s, o, bh, n_frames,
                                   k_scale, s);
    case 128:
      return launch<T, 128, kQuant>(q, k, k_s, v, v_s, o, bh, n_frames,
                                    k_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, hd) f32; k8, v8 (bh, hd, F) int8, 16-byte aligned, F <= 3072;
// k_s, v_s (bh, F) f32; o (bh, hd) f32. All contiguous; hd in
// 16/32/64/128.
WCA_EXPORT int wca_cross_attn_int8(const void* q, const void* k8,
                                   const void* k_s, const void* v8,
                                   const void* v_s, void* o, int bh, int hd,
                                   int n_frames, float k_scale, void* stream) {
  return dispatch<int8_t, true>(q, k8, k_s, v8, v_s, o, bh, hd, n_frames,
                                k_scale, stream);
}

// q (bh, hd) f32; k, v (bh, hd, F) float32 (is_bf16 == 0) or bfloat16,
// 16-byte aligned; o (bh, hd) f32. All contiguous; hd in 16/32/64/128.
WCA_EXPORT int wca_cross_attn(const void* q, const void* k, const void* v,
                              void* o, int bh, int hd, int n_frames,
                              float k_scale, int is_bf16, void* stream) {
  if (is_bf16)
    return dispatch<__nv_bfloat16, false>(q, k, nullptr, v, nullptr, o, bh,
                                          hd, n_frames, k_scale, stream);
  return dispatch<float, false>(q, k, nullptr, v, nullptr, o, bh, hd,
                                n_frames, k_scale, stream);
}
