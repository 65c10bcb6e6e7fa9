// Encoder self-attention for Whisper, one (batch*head, 64-query tile) per block.
//
// Replaces: whisper_char_alignment_tpu/ops/encoder_attn_pallas.py,
//   encoder_self_attention (its _kernel). Same function: S = q k^T with q and
//   k pre-scaled by head_dim^-0.25, columns >= n_valid set to -inf, an f32
//   softmax, the probabilities cast to the compute dtype, then P v.
//
// What bounds it on an H100: operations. 4*B*H*T^2*hd FLOPs (73.7 GFLOP at
//   B=8, H=16, T=1500, hd=64) against 2*4*B*H*T*hd bytes moved (~25 MB in
//   bf16): far above the card's ~295 FLOP/byte ridge, so the tensor cores'
//   989 TFLOP/s bf16 peak (75 us) is the bound.
//
// Design: the TPU kernel keeps the whole (T_pad, hd) K and V panels in VMEM
//   and takes a full-row softmax; at T=1500, hd=64 in bf16 K+V are 384 KB,
//   more than a block's 227 KB of shared memory. So this kernel walks K/V in
//   64-key tiles staged in shared memory and keeps a running row max and sum
//   in f32 (an online softmax), accumulating O in f32 registers. 256 threads
//   each own a 4x4 patch of the 64x64 score tile (rows ty+16a, keys tx+16b)
//   and a 4 x hd/16 patch of O; a row's max and sum are reduced over the 16
//   lanes that share it with warp shuffles. The probability tile is rounded
//   to the compute dtype before P v, as the TPU kernel casts its
//   probabilities. Scores and P v are scalar f32 FMAs: simple and exact, far
//   from the tensor-core bound; wgmma/TMA tiles are later work.
//
// The kKT instantiation replaces encoder_self_attention_kt (its _kernel_kt):
//   the same function with K handed over transposed, as (bh, hd, t). Only
//   the K tile load differs: lanes walk consecutive keys of one head-dim
//   row, so the global reads coalesce, and the tile lands in the same
//   padded [key][d] layout (bank (key + d) mod 32: conflict-free stores).
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLDP = kBK + 1;  // padded row of the probability tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (HD + 1) + 2 * kBK * (HD + 1) + kBQ * kLDP);
}

template <typename T, int HD, bool kKT>
__global__ void __launch_bounds__(kThreads)
    encoder_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int t,
                        int n_valid) {
  constexpr int LD = HD + 1;  // padded rows: conflict-free column reads
  constexpr int DC = HD / 16; // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][LD]
  float* ks = qs + kBQ * LD;    // [kBK][LD]
  float* vs = ks + kBK * LD;    // [kBK][LD]
  float* ps = vs + kBK * LD;    // [kBQ][kLDP]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.y * kBQ;
  const size_t base = (size_t)blockIdx.x * t * HD;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD, row = q0 + r;
    qs[r * LD + c] = row < t ? wca::to_float(qb[(size_t)row * HD + c]) : 0.f;
  }

  float m_run[4], l_run[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = -CUDART_INF_F;
    l_run[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  const int kv_len = n_valid < t ? n_valid : t;
  for (int k0 = 0; k0 < kv_len; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, c = idx % HD, key = k0 + r;
      const bool in = key < kv_len;
      if (!kKT)
        ks[r * LD + c] = in ? wca::to_float(kb[(size_t)key * HD + c]) : 0.f;
      vs[r * LD + c] = in ? wca::to_float(vb[(size_t)key * HD + c]) : 0.f;
    }
    if (kKT) {  // kb is (HD, t): row c holds every key's component c
      for (int idx = tid; idx < kBK * HD; idx += kThreads) {
        const int c = idx / kBK, r = idx % kBK, key = k0 + r;
        ks[r * LD + c] =
            key < kv_len ? wca::to_float(kb[(size_t)c * t + key]) : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = ks[(tx + 16 * b) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kv[b], s[a][b]);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (k0 + tx + 16 * b >= kv_len) {
#pragma unroll
        for (int a = 0; a < 4; ++a) s[a][b] = -CUDART_INF_F;
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(wca::kFullMask, mx, off));
      // every tile holds at least one valid key, so m_new is finite
      const float m_new = fmaxf(m_run[a], mx);
      const float alpha = expf(m_run[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        rs += p;
        ps[(ty + 16 * a) * kLDP + tx + 16 * b] = wca::round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(wca::kFullMask, rs, off);
      l_run[a] = l_run[a] * alpha + rs;
      m_run[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pa[4], vv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * kLDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pa[a], vv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row < t) {
      const float inv = 1.f / l_run[a];
      T* orow = o + base + (size_t)row * HD;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        orow[tx + 16 * c] = wca::from_float<T>(acc[a][c] * inv);
    }
  }
}

template <typename T, int HD, bool kKT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int t, int n_valid, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attn_kernel<T, HD, kKT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (t + kBQ - 1) / kBQ);
  encoder_attn_kernel<T, HD, kKT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, n_valid);
  return cudaGetLastError();
}

template <typename T, bool kKT>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int bh, int t, int n_valid, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16, kKT>(q, k, v, o, bh, t, n_valid, s);
    case 32: return launch<T, 32, kKT>(q, k, v, o, bh, t, n_valid, s);
    case 64: return launch<T, 64, kKT>(q, k, v, o, bh, t, n_valid, s);
    case 128: return launch<T, 128, kKT>(q, k, v, o, bh, t, n_valid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kKT>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int t, int n_valid, int hd, int is_bf16, void* stream) {
  if (bh <= 0 || t <= 0 || n_valid <= 0 || n_valid > t)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16, kKT>(q, k, v, o, bh, t, n_valid, hd, s);
  return dispatch_hd<float, kKT>(q, k, v, o, bh, t, n_valid, hd, s);
}

}  // namespace

// q, k, v, o: (bh, t, hd) contiguous, float32 (is_bf16 == 0) or bfloat16.
WCA_EXPORT int wca_encoder_attn(const void* q, const void* k, const void* v,
                                void* o, int bh, int t, int n_valid, int hd,
                                int is_bf16, void* stream) {
  return dispatch<false>(q, k, v, o, bh, t, n_valid, hd, is_bf16, stream);
}

// As wca_encoder_attn with K transposed: kt (bh, hd, t) contiguous.
WCA_EXPORT int wca_encoder_attn_kt(const void* q, const void* kt,
                                   const void* v, void* o, int bh, int t,
                                   int n_valid, int hd, int is_bf16,
                                   void* stream) {
  return dispatch<true>(q, kt, v, o, bh, t, n_valid, hd, is_bf16, stream);
}
