// A linear layer y = x W^T (+ b) whose every output's sum over K runs in
// one order fixed by (N, K) alone, never by the number of rows M: a row's
// result does not depend on the rows beside it.
//
// Replaces: no Pallas site. The JAX package computes the decoder's linears
//   and its tied lm head as XLA dots; the port's plain versions are
//   `F.linear(x, W, b)` and, for the lm head, `F.linear(x.float(),
//   W.float())` (`models/whisper._linear`, `_logits`).
//
// Why a kernel: cuBLAS picks its kernel, its tiles and any split of K from
//   M, so a row computed in a decode step at B = 1 and at B = 16, or in a
//   5-row speculative window against a 1-row step, was summed in different
//   orders (and split-K partials may be reduced in bf16). Here K is cut into
//   segments chosen from (N, K) only (`plan`); each segment is one chain of
//   products from zero, in rising k, and the segments' sums are added in
//   rising order, then the bias, then one rounding to the output type. What
//   M changes is only where that happens: at few rows (a decode step) each
//   segment is its own block, which parks its partial sums and the last
//   block of a tile to arrive (a ticket) adds them in order; at many rows
//   one block walks all segments and adds them in registers in the same
//   order. Both give the same bits.
//
// bf16: mma.sync.m16n8k16 (bf16 in, f32 accumulate) on 64-column tiles of
//   16 or 64 rows, 4 warps, 64-deep k chunks through a 3-stage cp.async
//   ring of padded rows, fragments by ldmatrix (conflict-free). The output
//   is bf16 (a linear) or f32 (the lm head, whose layer-normed rows and
//   embedding are bf16, so the f32 product of the plain version is the same
//   function). f32: the CUDA cores, 64 x 64 tiles, 4 x 4 outputs a thread,
//   each a chain of fmaf in rising k.
//
// What bounds it on an H100: at a decode step's rows, bytes: the weight is
//   read once (2 MB for 1024 x 1024 bf16: 0.63 us at 3.35 TB/s; the lm
//   head's 51865 x 1024 bf16 106 MB: 31.7 us). At a transcript's or the
//   audio's rows, operations (2 M N K at 989 TFLOP/s bf16). mma.sync
//   reaches about two thirds of that peak at best; wgmma with TMA-fed
//   tiles is the later step.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;        // bf16 chunk depth
constexpr int kStages = 3;
constexpr int kRowH = kBK + 8; // padded smem row, in bf16 elements (144 B)
constexpr int kF32BK = 16;     // f32 chunk depth
constexpr int kF32Threads = 256;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory into mma fragments: lanes 8i to
// 8i + 7 give the 16-byte row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The output element (m, n), in order: the sum of its segments' partials
// (already added), the bias, one rounding.
template <typename TB, typename TO>
__device__ __forceinline__ void store_out(TO* out, const TB* bias, int m,
                                          int n, int n_cols, float acc) {
  float y = acc;
  if (bias != nullptr) {
    if constexpr (sizeof(TB) == 2)
      y += __bfloat162float(bias[n]);
    else
      y += bias[n];
  }
  if constexpr (sizeof(TO) == 2)
    out[(long long)m * n_cols + n] = __float2bfloat16_rn(y);
  else
    out[(long long)m * n_cols + n] = y;
}

// Park a block's partial sums; the last of the tile's `n_seg` blocks adds
// every segment's partials in rising order. Returns true in that block.
__device__ __forceinline__ bool last_of_tile(int* tickets, int tile,
                                             int n_seg) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(&tickets[tile], 1);
    last = t == n_seg - 1;
    if (last) tickets[tile] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

// kBM rows a block: 16 (one m16 tile, the 4 warps side by side on N) or 64
// (2 x 2 warps of 32 x 32).
template <int kBM>
struct Shape {
  static constexpr int kWarpsM = kBM == 16 ? 1 : 2;
  static constexpr int kWarpsN = 4 / kWarpsM;
  static constexpr int kMT = kBM / 16 / kWarpsM;     // m16 tiles a warp
  static constexpr int kNT = kBN / 8 / kWarpsN;      // n8 tiles a warp
  static constexpr int kStageH = (kBM + kBN) * kRowH;  // bf16 a stage
};

template <int kBM, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads)
    rows_linear_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            const TB* __restrict__ bias, TO* __restrict__ out,
                            float* __restrict__ part, int* __restrict__ tickets,
                            int n_rows, int n_cols, int depth, int seg_chunks,
                            int n_seg) {
  using S = Shape<kBM>;
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp / S::kWarpsN, warp_n = warp % S::kWarpsN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_chunks = (depth + kBK - 1) / kBK;
  // this block's chunks: all segments, or the one segment blockIdx.z
  const bool split = gridDim.z > 1;
  const int c_begin = split ? blockIdx.z * seg_chunks : 0;
  const int c_end = split ? min(n_chunks, c_begin + seg_chunks) : n_chunks;
  const int n_iter = c_end - c_begin;

  auto load = [&](int stage, int chunk) {
    __nv_bfloat16* sa = sm + stage * S::kStageH;
    __nv_bfloat16* sb = sa + kBM * kRowH;
    const int k0 = chunk * kBK;
    for (int i = tid; i < (kBM + kBN) * (kBK / 8); i += kThreads) {
      const int row = i / (kBK / 8), c8 = (i % (kBK / 8)) * 8;
      const int k = k0 + c8;
      if (row < kBM) {
        const int m = m0 + row;
        const bool ok = m < n_rows && k < depth;
        wca::cp_async<16>(sa + row * kRowH + c8,
                          ok ? x + (long long)m * depth + k : x, ok ? 16 : 0);
      } else {
        const int n = n0 + row - kBM;
        const bool ok = n < n_cols && k < depth;
        wca::cp_async<16>(sb + (row - kBM) * kRowH + c8,
                          ok ? w + (long long)n * depth + k : w, ok ? 16 : 0);
      }
    }
  };

  float acc[S::kMT][S::kNT][4];
  float tot[S::kMT][S::kNT][4];
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load(s, c_begin + s);
    wca::cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    wca::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < n_iter) load(nxt % kStages, c_begin + nxt);
    wca::cp_async_commit();

    const __nv_bfloat16* sa = sm + (it % kStages) * S::kStageH;
    const __nv_bfloat16* sb = sa + kBM * kRowH;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[S::kMT][4], bfr[S::kNT][2];
      // A: rows 0-15 of the m16 tile at k, then at k + 8 (a0..a3);
      // B: two n8 tiles, each at k and k + 8 (b0, b1 of each)
#pragma unroll
      for (int i = 0; i < S::kMT; ++i) {
        const int r = (warp_m * S::kMT + i) * 16 + (lane & 15);
        ldmatrix_x4(af[i], sa + r * kRowH + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j = 0; j < S::kNT; j += 2) {
        const int c = (warp_n * S::kNT + j) * 8 + (lane & 7) +
                      ((lane >> 4) << 3);
        uint32_t b4[4];
        ldmatrix_x4(b4, sb + c * kRowH + kk + ((lane >> 3) & 1) * 8);
        bfr[j][0] = b4[0];
        bfr[j][1] = b4[1];
        bfr[j + 1][0] = b4[2];
        bfr[j + 1][1] = b4[3];
      }
#pragma unroll
      for (int i = 0; i < S::kMT; ++i)
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    // a segment ends: its chain joins the running sum (the first is copied,
    // not added to zero, as the ticket's sum starts from segment 0; a split
    // block holds one segment)
    const int c = c_begin + it;
    if ((c + 1) % seg_chunks == 0 || c + 1 == n_chunks) {
      const bool first = split || c < seg_chunks;
#pragma unroll
      for (int i = 0; i < S::kMT; ++i)
#pragma unroll
        for (int j = 0; j < S::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[i][j][e] = first ? acc[i][j][e] : tot[i][j][e] + acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
    }
  }
  wca::cp_async_wait<0>();

  // fragment element e of (i, j): row g (+8 for e >= 2), column 2t (+1)
  auto elem = [&](int i, int j, int e, int& m, int& n) {
    m = m0 + (warp_m * S::kMT + i) * 16 + g + (e >= 2 ? 8 : 0);
    n = n0 + (warp_n * S::kNT + j) * 8 + 2 * t + (e & 1);
  };
  if (split) {
    float* mine = part + (long long)blockIdx.z * n_rows * n_cols;
#pragma unroll
    for (int i = 0; i < S::kMT; ++i)
#pragma unroll
      for (int j = 0; j < S::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int m, n;
          elem(i, j, e, m, n);
          if (m < n_rows && n < n_cols)
            mine[(long long)m * n_cols + n] = tot[i][j][e];
        }
    if (!last_of_tile(tickets, blockIdx.y * gridDim.x + blockIdx.x, n_seg))
      return;
    // segment by segment, every element's partial loaded at once (one L2
    // round trip a segment), each added in rising segment order
    for (int z = 0; z < n_seg; ++z) {
      const float* pz = part + (long long)z * n_rows * n_cols;
#pragma unroll
      for (int i = 0; i < S::kMT; ++i)
#pragma unroll
        for (int j = 0; j < S::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int m, n;
            elem(i, j, e, m, n);
            const float p = m < n_rows && n < n_cols
                                ? __ldcg(pz + (long long)m * n_cols + n)
                                : 0.f;
            tot[i][j][e] = z == 0 ? p : tot[i][j][e] + p;
          }
    }
  }
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int m, n;
        elem(i, j, e, m, n);
        if (m < n_rows && n < n_cols)
          store_out(out, bias, m, n, n_cols, tot[i][j][e]);
      }
}

// ---------------------------------------------------------------------------
// f32
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kF32Threads)
    rows_linear_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, float* __restrict__ part,
                           int* __restrict__ tickets, int n_rows, int n_cols,
                           int depth, int seg_chunks, int n_seg) {
  __shared__ __align__(16) float xs[kF32BK][64 + 4];  // [k][m]
  __shared__ __align__(16) float ws[kF32BK][64 + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int n_chunks = (depth + kF32BK - 1) / kF32BK;
  const bool split = gridDim.z > 1;
  const int c_begin = split ? blockIdx.z * seg_chunks : 0;
  const int c_end = split ? min(n_chunks, c_begin + seg_chunks) : n_chunks;
  // the tile's loads: row tid / 4, four k from (tid % 4) * 4
  const int lr = tid / 4, lk = (tid % 4) * 4;

  float acc[4][4], tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int k = c * kF32BK + lk;
    float4 xa = make_float4(0.f, 0.f, 0.f, 0.f), wa = xa;
    if (m0 + lr < n_rows && k < depth)
      xa = *reinterpret_cast<const float4*>(x + (long long)(m0 + lr) * depth + k);
    if (n0 + lr < n_cols && k < depth)
      wa = *reinterpret_cast<const float4*>(w + (long long)(n0 + lr) * depth + k);
    __syncthreads();  // the previous chunk's reads are done
    xs[lk + 0][lr] = xa.x; xs[lk + 1][lr] = xa.y;
    xs[lk + 2][lr] = xa.z; xs[lk + 3][lr] = xa.w;
    ws[lk + 0][lr] = wa.x; ws[lk + 1][lr] = wa.y;
    ws[lk + 2][lr] = wa.z; ws[lk + 3][lr] = wa.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if ((c + 1) % seg_chunks == 0 || c + 1 == n_chunks) {
      const bool first = split || c < seg_chunks;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tot[i][j] = first ? acc[i][j] : tot[i][j] + acc[i][j];
          acc[i][j] = 0.f;
        }
    }
  }

  if (split) {
    float* mine = part + (long long)blockIdx.z * n_rows * n_cols;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
        if (m < n_rows && n < n_cols)
          mine[(long long)m * n_cols + n] = tot[i][j];
      }
    if (!last_of_tile(tickets, blockIdx.y * gridDim.x + blockIdx.x, n_seg))
      return;
    for (int z = 0; z < n_seg; ++z) {  // as the bf16 kernel's
      const float* pz = part + (long long)z * n_rows * n_cols;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
          const float p = m < n_rows && n < n_cols
                              ? __ldcg(pz + (long long)m * n_cols + n)
                              : 0.f;
          tot[i][j] = z == 0 ? p : tot[i][j] + p;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < n_rows && n < n_cols) store_out(out, bias, m, n, n_cols, tot[i][j]);
    }
}

template <int kBM, typename TB, typename TO>
cudaError_t launch_bf16(const void* x, const void* w, const void* bias,
                        void* out, void* part, void* tickets, int m, int n,
                        int k, int seg_chunks, int n_seg, int split,
                        cudaStream_t stream) {
  const size_t smem = (size_t)kStages * Shape<kBM>::kStageH * 2;
  cudaError_t err =
      wca::allow_smem<rows_linear_bf16_kernel<kBM, TB, TO>>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, split ? n_seg : 1);
  rows_linear_bf16_kernel<kBM, TB, TO><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const TB*>(bias),
      static_cast<TO*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), m, n, k, seg_chunks, n_seg);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch_bf16(const void* x, const void* w, const void* bias,
                          void* out, void* part, void* tickets, int m, int n,
                          int k, int seg_chunks, int n_seg, int split,
                          cudaStream_t stream) {
  if (m <= 16)
    return launch_bf16<16, __nv_bfloat16, TO>(x, w, bias, out, part, tickets,
                                              m, n, k, seg_chunks, n_seg,
                                              split, stream);
  return launch_bf16<64, __nv_bfloat16, TO>(x, w, bias, out, part, tickets, m,
                                            n, k, seg_chunks, n_seg, split,
                                            stream);
}

}  // namespace

// x (M, K) and w (N, K) row-major, 16-byte aligned; bias (N,) in x's type or
// null; out (M, N) in x's type or, for bf16 x with out_f32, f32. The plan
// (seg_chunks chunks of 64 (bf16) or 16 (f32) k a segment, n_seg segments)
// comes from (N, K) alone (`ops/rows_linear_cuda.plan`); `split` (one block
// a segment, partials in `part` (n_seg, M, N) f32, tickets zeroed ints, one
// per output tile) is the caller's choice by M and does not change the
// result. bf16: K % 8 == 0; f32: K % 4 == 0.
WCA_EXPORT int wca_rows_linear(const void* x, const void* w, const void* bias,
                               void* out, void* part, void* tickets, int m,
                               int n, int k, int seg_chunks, int n_seg,
                               int split, int is_bf16, int out_f32,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || seg_chunks <= 0 || n_seg <= 0 ||
      k % (is_bf16 ? 8 : 4) != 0 || (split && (part == nullptr ||
                                               tickets == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (!out_f32) return cudaErrorInvalidValue;
    dim3 grid((n + 63) / 64, (m + 63) / 64, split ? n_seg : 1);
    rows_linear_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out),
        static_cast<float*>(part), static_cast<int*>(tickets), m, n, k,
        seg_chunks, n_seg);
    return cudaGetLastError();
  }
  if (out_f32)
    return dispatch_bf16<float>(x, w, bias, out, part, tickets, m, n, k,
                                seg_chunks, n_seg, split, s);
  return dispatch_bf16<__nv_bfloat16>(x, w, bias, out, part, tickets, m, n, k,
                                      seg_chunks, n_seg, split, s);
}
