// Decoder attention whose every row is computed in one order fixed by the
// head dim and the key count alone: a row's result does not depend on how
// many other rows, batch items or heads share the call.
//
// Replaces: no Pallas site. The JAX package computes the decoder's
//   attention as XLA dots (whisper_char_alignment_tpu/models/whisper.py,
//   `_attend`); the port's plain version is `models/whisper._attend` on the
//   inputs the call sites give it. Same function:
//     k'[d, s] = dtype(dtype(k[d, s]) * k_scale)        (k_scale optional)
//     s[r, s]  = sum_d q[r, d] k'[d, s]  (+ mask[r, s])  in f32
//     w[r, s]  = dtype(exp(s - max_s) / sum_s exp(s - max_s))
//     o[r, d]  = dtype(sum_s w[r, s] dtype(v[d, s]))     in f32
//   q (B, H, P, hd) and K/V (B, H, hd, S, by strides) in the compute dtype
//   (bf16 or f32), mask (P, S) f32, optional scores
//   (B, H, P, S) f32 out, o written (B, P, H, hd).
//
// Why a kernel: `torch.matmul` picks a GEMV at one query row and a GEMM at
//   k+1 or T rows, and a batch of B items another shape again, so a row's
//   sums ran in an order that depended on its neighbours (the speculative
//   window against the greedy step, a batched request against its solo
//   run). Here each (batch item, head) and tile of query rows is one block
//   of 256 threads; column s of the scores belongs to thread s % 256, which
//   sums its columns in rising order, and one fixed-shape tree (warp
//   butterflies, then the 8 warps' results) folds the threads; in P.V lane
//   l of a warp owns the columns s = l (mod 32), again in rising order,
//   folded by a warp butterfly. Columns masked to -inf add exactly zero, so
//   a longer key axis (a longer cache, a padded transcript) leaves a row's
//   bits as they are. The rows of a block never mix: a block of 1 or 8 rows
//   computes each row the same way.
//
// What bounds it on an H100: bytes. A decode step reads K and V once: at
//   B=8, H=16, hd=64 over 1500 frames of bf16, 49.2 MB (14.7 us at 3.35
//   TB/s); the self-attention cache at 448 columns 14.7 MB. The work is
//   4 B H P S hd flops. The design leaves latency on the table (one block a
//   (item, head, row tile), scalar 2-byte loads of K columns, no staging):
//   it is the first, simple version; the f32 copies of K and V it replaces
//   were 44-52% of the step's device time.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDPerWarp = 8;  // head-dim rows a warp folds at once in P.V

template <typename T>
__device__ __forceinline__ float widen(T x);
template <>
__device__ __forceinline__ float widen<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T (round to nearest even), widened back to f32.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long qb, qh, qp;          // q's last axis is contiguous
  long long kb, kh, kd, ks;
  long long vb, vh, vd, vs;
};

// TK: K/V's type, TC: q's and o's (one dtype: the entry point takes the
// compute dtype for both); kRows query rows a block.
template <typename TK, typename TC, int kRows>
__global__ void __launch_bounds__(kThreads)
    dec_attn_kernel(const TC* __restrict__ q, const TK* __restrict__ k,
                    const TK* __restrict__ v, const float* __restrict__ mask,
                    TC* __restrict__ out, float* __restrict__ scores,
                    Strides st, int n_head, int n_rows, int n_keys, int hd,
                    float k_scale, int has_scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [kRows][hd]
  float* ws = qs + kRows * hd;   // [kRows][n_keys]: scores, then weights
  __shared__ float red[32];

  const int bh = blockIdx.y;
  const int b = bh / n_head, h = bh % n_head;
  const int p0 = blockIdx.x * kRows;
  const int rows = min(kRows, n_rows - p0);
  const int tid = threadIdx.x;

  const TC* qbase = q + b * st.qb + h * st.qh;
  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    qs[i] = r < rows ? widen(qbase[(p0 + r) * st.qp + d]) : 0.f;
  }
  __syncthreads();

  // scores: thread tid owns columns tid, tid + 256, ...
  const TK* kbase = k + b * st.kb + h * st.kh;
  float mx[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) mx[r] = -CUDART_INF_F;
  for (int s = tid; s < n_keys; s += kThreads) {
    const TK* kc = kbase + s * st.ks;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 32
    for (int d = 0; d < hd; ++d) {
      float kv = round_to<TC>(widen(kc[d * st.kd]));
      if (has_scale) kv = round_to<TC>(kv * k_scale);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(qs[r * hd + d], kv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        float sc = acc[r];
        if (mask != nullptr) sc += mask[(long long)(p0 + r) * n_keys + s];
        ws[r * n_keys + s] = sc;
        if (scores != nullptr)
          scores[((long long)bh * n_rows + p0 + r) * n_keys + s] = sc;
        mx[r] = fmaxf(mx[r], sc);
      }
    }
  }

  // softmax per row: the max, then exp and its sum, each folded by the
  // block's fixed tree; the weights rounded to the compute dtype
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {  // uniform over the block
      float* wr = ws + r * n_keys;
      const float m = wca::block_reduce<true>(mx[r], red);
      float part = 0.f;
      for (int s = tid; s < n_keys; s += kThreads) {
        const float e = expf(wr[s] - m);
        wr[s] = e;
        part += e;
      }
      const float sum = wca::block_reduce<false>(part, red);
      for (int s = tid; s < n_keys; s += kThreads)
        wr[s] = round_to<TC>(wr[s] / sum);
    }
  }
  __syncthreads();

  // P.V: a warp takes kDPerWarp head-dim rows, lane l the columns l (mod 32)
  const TK* vbase = v + b * st.vb + h * st.vh;
  const int warp = tid >> 5, lane = tid & 31;
  for (int d0 = warp * kDPerWarp; d0 < hd; d0 += kWarps * kDPerWarp) {
    float acc[kDPerWarp][kRows];
#pragma unroll
    for (int j = 0; j < kDPerWarp; ++j)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[j][r] = 0.f;
#pragma unroll 4
    for (int s = lane; s < n_keys; s += 32) {
      float w[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) w[r] = r < rows ? ws[r * n_keys + s] : 0.f;
#pragma unroll
      for (int j = 0; j < kDPerWarp; ++j) {
        const float vv = round_to<TC>(widen(vbase[(d0 + j) * st.vd + s * st.vs]));
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[j][r] = fmaf(w[r], vv, acc[j][r]);
      }
    }
#pragma unroll
    for (int j = 0; j < kDPerWarp; ++j)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x = acc[j][r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_xor_sync(wca::kFullMask, x, off);
        acc[j][r] = x;
      }
    if (lane < kDPerWarp) {
#pragma unroll
      for (int j = 0; j < kDPerWarp; ++j) {
        if (j != lane) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rows)
            out[(((long long)b * n_rows + p0 + r) * n_head + h) * hd + d0 + j] =
                narrow<TC>(acc[j][r]);
      }
    }
  }
}

template <typename TK, typename TC, int kRows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, void* scores,
                   const Strides& st, int b, int n_head, int n_rows,
                   int n_keys, int hd, float k_scale, int has_scale,
                   cudaStream_t stream) {
  auto kernel = dec_attn_kernel<TK, TC, kRows>;
  const size_t smem = (size_t)kRows * (hd + n_keys) * sizeof(float);
  cudaError_t err = wca::allow_smem<dec_attn_kernel<TK, TC, kRows>>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_rows + kRows - 1) / kRows, b * n_head);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TC*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), static_cast<const float*>(mask),
      static_cast<TC*>(out), static_cast<float*>(scores), st, n_head, n_rows,
      n_keys, hd, k_scale, has_scale);
  return cudaGetLastError();
}

template <typename TK, typename TC>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* scores,
                          const Strides& st, int b, int n_head, int n_rows,
                          int n_keys, int hd, float k_scale, int has_scale,
                          cudaStream_t stream) {
  // one row a block for a decode step; eight otherwise (a window, a prompt,
  // a teacher-forced transcript): the same arithmetic per row either way
  if (n_rows == 1)
    return launch<TK, TC, 1>(q, k, v, mask, out, scores, st, b, n_head,
                             n_rows, n_keys, hd, k_scale, has_scale, stream);
  return launch<TK, TC, 8>(q, k, v, mask, out, scores, st, b, n_head, n_rows,
                           n_keys, hd, k_scale, has_scale, stream);
}

}  // namespace

// strides: 11 element strides (q: b, h, p; k: b, h, d, s; v: b, h, d, s).
// kv_bf16 / c_bf16: K/V's and the compute dtype's type (else f32); the
// decoder keeps its cache and cross K/V in the compute dtype, so the two
// agree.
WCA_EXPORT int wca_dec_attn(const void* q, const void* k, const void* v,
                            const void* mask, void* out, void* scores,
                            const long long* strides, int b, int n_head,
                            int n_rows, int n_keys, int hd, float k_scale,
                            int has_scale, int kv_bf16, int c_bf16,
                            void* stream) {
  if (b <= 0 || n_head <= 0 || n_rows <= 0 || n_keys <= 0 || hd <= 0 ||
      hd % kDPerWarp != 0 || hd > 256 || kv_bf16 != c_bf16)
    return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (c_bf16)
    return dispatch_rows<bf, bf>(q, k, v, mask, out, scores, st, b, n_head,
                                 n_rows, n_keys, hd, k_scale, has_scale, s);
  return dispatch_rows<float, float>(q, k, v, mask, out, scores, st, b,
                                     n_head, n_rows, n_keys, hd, k_scale,
                                     has_scale, s);
}
