// Encoder self-attention for Whisper: a flash-attention kernel on the tensor
// cores for bfloat16 and a register-tiled one on the CUDA cores for float32.
//
// Replaces: whisper_char_alignment_tpu/ops/encoder_attn_pallas.py,
//   encoder_self_attention (its _kernel) and, with K handed over transposed
//   as (bh, hd, t) (the kKT layout: encoder_attn_kernel_bf16_kt and the f32
//   kernel's kKT instantiations), encoder_self_attention_kt (its
//   _kernel_kt). Same function: S = q k^T with q and k pre-scaled by
//   head_dim^-0.25, columns >= n_valid set to -inf, an f32 softmax, the
//   probabilities rounded to the compute dtype, then P v summed in f32.
//
// What bounds it on an H100: operations. 4*B*H*T^2*hd FLOPs (73.7 GFLOP at
//   B=8, H=16, T=1500, hd=64) against ~25 MB moved in bf16: far above the
//   card's ~295 FLOP/byte ridge, so the bound is the tensor cores' 989
//   TFLOP/s (75 us) in bf16 and the CUDA cores' 67 TFLOP/s (1.10 ms) in f32
//   (float32 stays real: no TF32).
//
// Design, bf16: FlashAttention-2 with mma.sync.m16n8k16 (bf16 in, f32
//   accumulate). Each of a block's 8 warps owns 16 query rows and keeps
//   them as A fragments (ldmatrix, once). 64-key K and V tiles are
//   double-buffered in shared memory with cp.async (16-byte copies,
//   zero-filled past n_valid; rows padded by 16 bytes so that ldmatrix is
//   free of bank conflicts). Scores
//   stay in registers; the online softmax's row max and sum live on the
//   accumulator fragments and reduce over the 4 lanes of a quad. P turns
//   from the C layout into bf16 A fragments in registers: the row sum l
//   adds the unrounded f32 values and only the mma operand is rounded, as
//   the TPU kernel sums its f32 softmax and casts after. V (and K^T in the
//   kKT layout) is read as B fragments with ldmatrix.trans. O stays in f32
//   registers and is divided by l at the end. K^T rows are t*2 bytes long,
//   so their copies take the widest of 16/8/4 bytes that keeps each row's
//   start aligned (8 at t=1500), or single elements.
//
// Design, f32: the CUDA cores, as the TPU kernel's f32 path has no cheaper
//   exact unit. 256 threads take 128 query rows against 64-key tiles; each
//   thread holds an 8-row x 4-key score patch and an 8-row x hd/16 patch of
//   O, and reads its operands as float4 (12 shared-memory loads per 128
//   FMAs: Q as [row][hd], K as K^T [hd][key], P as [row][key], V as
//   [key][hd]). A row's max and sum reduce over the 16 lanes that share it,
//   and those 16 lanes are the only readers of the row's P, so P needs a
//   warp barrier only.
//
// K^T rows are t*2 bytes apart, so at t=1500 every other row starts 8 bytes
// past a 16-byte boundary: its tile copies are 8 bytes wide, and ldmatrix
// needs 16-byte aligned rows, so no wider copy can land them. The kKT
// layout takes 28% longer than the other at t=1500 and 14% at t=1536, where
// t*2 is a multiple of 16 (chip_smoke.py on an H100).
//
// Every tile walked holds at least one valid key (tiles stop at n_valid),
// so the running max is finite; query rows at or above t are never stored.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpsBf16 = 8;  // 16 query rows each
constexpr int kBK = 64;        // keys per K/V tile

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD, bool kKT>
struct Bf16Tile {
  static constexpr int kBQ = 16 * kWarpsBf16;
  static constexpr int kLD = HD + 8;    // a [row][hd] tile's row, + 16 bytes
  static constexpr int kLDT = kBK + 8;  // a K^T [hd][key] tile's row
  static constexpr int kQ = kBQ * kLD;
  static constexpr int kK = kKT ? HD * kLDT : kBK * kLD;
  static constexpr int kV = kBK * kLD;
  static constexpr size_t kSmem = sizeof(bf16) * (kQ + 2 * (kK + kV));
};

// The bf16 kernel's body; kt_bytes: width of one copy of K^T (16, 8, 4, or
// 2 for single elements).
template <int HD, bool kKT>
__device__ __forceinline__ void attn_bf16(const bf16* __restrict__ q,
                                          const bf16* __restrict__ k,
                                          const bf16* __restrict__ v,
                                          bf16* __restrict__ o, int t,
                                          int n_valid, int kt_bytes) {
  using L = Bf16Tile<HD, kKT>;
  constexpr int kThreads = kWarpsBf16 * 32;
  constexpr int kChunks = HD / 8;  // 16-byte copies per [row][hd] tile row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv = qs + L::kQ;  // stage s: K at kv + s*(kK+kV), V after it

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * L::kBQ;
  const size_t base = (size_t)blockIdx.x * t * HD;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int n_tiles = (n_valid + kBK - 1) / kBK;

  for (int i = tid; i < L::kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, row = q0 + r;
    const bool in = row < t;
    wca::cp_async<16>(qs + r * L::kLD + c * 8,
                      qb + (size_t)(in ? row : 0) * HD + c * 8, in ? 16 : 0);
  }

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    bf16* ks = kv + stage * (L::kK + L::kV);
    bf16* vs = ks + L::kK;
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks, key = k0 + r;
      const bool in = key < n_valid;
      const size_t off = (size_t)(in ? key : 0) * HD + c * 8;
      wca::cp_async<16>(vs + r * L::kLD + c * 8, vb + off, in ? 16 : 0);
      if constexpr (!kKT)
        wca::cp_async<16>(ks + r * L::kLD + c * 8, kb + off, in ? 16 : 0);
    }
    if constexpr (kKT) {  // kb is (HD, t): row d holds every key's component d
      // e elements per copy, a power of two: shifts, not divisions
      const int e = kt_bytes / 2, shift = __ffs(kBK / e) - 1;
      for (int i = tid; i < HD << shift; i += kThreads) {
        const int d = i >> shift, c = (i & ((1 << shift) - 1)) * e;
        const int key = k0 + c;
        const int n = min(max(n_valid - key, 0), e);
        bf16* dst = ks + d * L::kLDT + c;
        const bf16* src = kb + (size_t)d * t + (n > 0 ? key : 0);
        if (e == 1)
          *dst = n > 0 ? *src : __float2bfloat16_rn(0.f);
        else
          wca::cp_async_w(dst, src, kt_bytes, n * 2);
      }
    }
  };

  load_tile(0, 0);
  wca::cp_async_commit();  // group 0: Q and the first K/V tile

  uint32_t qf[HD / 16][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // rows lane/4 (h = 0) and lane/4 + 8 (h = 1) of the warp's 16
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile(j + 1, (j + 1) & 1);
      wca::cp_async_commit();
      wca::cp_async_wait<1>();
    } else {
      wca::cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and Q) landed for every thread
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * L::kLD +
                                kk * 16 + (lane >> 4) * 8);
    }
    const bf16* ks = kv + (j & 1) * (L::kK + L::kV);
    const bf16* vs = ks + L::kK;

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // keys np*16 .. np*16+15
        uint32_t b[4];
        if constexpr (kKT)
          ldmatrix_x4_trans(b, ks + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                     (lane & 7)) * L::kLDT +
                                   np * 16 + (lane >> 4) * 8);
        else
          ldmatrix_x4(b, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                  L::kLD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }
    const int k0 = j * kBK;
    if (k0 + kBK > n_valid) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + (lane & 3) * 2 + (e & 1) >= n_valid)
            s[n][e] = -CUDART_INF_F;
    }

    // online softmax on the fragments; s becomes the unnormalised f32 P
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(wca::kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(wca::kFullMask, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float alpha = exp2f((m_run[h] - m_new) * kLog2e);
      const float mb = m_new * kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp2f(fmaf(s[n][e], kLog2e, -mb));
          s[n][e] = p;
          rs += p;
        }
      l_run[h] = l_run[h] * alpha + rs;  // this lane's share of the row
      m_run[h] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        acc[c][2 * h] *= alpha;
        acc[c][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P's C fragments become bf16 A fragments in registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys kk*16 .. kk*16+15
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {  // columns dp*16 .. dp*16+15
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                   (lane & 7)) * L::kLD +
                                 dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its reload
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(wca::kFullMask, l, 1);
    l += __shfl_xor_sync(wca::kFullMask, l, 2);
    const float inv = 1.f / l;
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row < t) {
      bf16* orow = o + base + (size_t)row * HD + (lane & 3) * 2;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 8) =
            __floats2bfloat162_rn(acc[c][2 * h] * inv,
                                  acc[c][2 * h + 1] * inv);
    }
  }
}

// Its two layouts, as two kernels because they need other launch bounds.
// Left free, ptxas fits the K-as-is layout in 125 registers at hd=64 (two
// blocks of 8 warps per SM); the K^T layout took 129 and ran one block per
// SM, 1.3x slower, so it asks for two blocks per SM (at most 128
// registers). Asking the same of the first made it 5% slower.
template <int HD>
__global__ void __launch_bounds__(kWarpsBf16 * 32)
    encoder_attn_kernel_bf16(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             int t, int n_valid, int kt_bytes) {
  attn_bf16<HD, false>(q, k, v, o, t, n_valid, kt_bytes);
}

template <int HD>
__global__ void __launch_bounds__(kWarpsBf16 * 32, HD <= 64 ? 2 : 1)
    encoder_attn_kernel_bf16_kt(const bf16* __restrict__ q,
                                const bf16* __restrict__ kt,
                                const bf16* __restrict__ v,
                                bf16* __restrict__ o, int t, int n_valid,
                                int kt_bytes) {
  attn_bf16<HD, true>(q, kt, v, o, t, n_valid, kt_bytes);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreadsF32 = 256;  // 16 x 16
constexpr int kBQF32 = 128;       // query rows per block: 8 per thread

template <int HD>
struct F32Tile {
  static constexpr int kLDQ = HD + 4;   // Q [row][hd]
  static constexpr int kLDK = kBK + 4;  // K^T [hd][key]
  static constexpr int kLDP = kBK + 4;  // P [row][key]
  static constexpr size_t kSmem =
      sizeof(float) *
      (size_t)(kBQF32 * kLDQ + HD * kLDK + kBK * HD + kBQF32 * kLDP);
};

__device__ __forceinline__ float lane_of(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// kVW consecutive floats of a row, as one vector load.
template <int kVW>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[kVW]) {
  if constexpr (kVW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else if constexpr (kVW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

template <int HD, bool kKT>
__global__ void __launch_bounds__(kThreadsF32, HD <= 64 ? 2 : 1)
    encoder_attn_kernel_f32(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, int t, int n_valid) {
  using L = F32Tile<HD>;
  constexpr int kCols = HD / 16;                // O columns per thread
  constexpr int kVW = kCols < 4 ? kCols : 4;    // of them per vector
  constexpr int kGroups = kCols / kVW;          // column groups 16*kVW apart
  constexpr int kQ4 = HD / 4;                   // float4s per row of hd
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQF32][kLDQ]
  float* kts = qs + kBQF32 * L::kLDQ;           // [HD][kLDK]
  float* vs = kts + HD * L::kLDK;               // [kBK][HD]
  float* ps = vs + kBK * HD;                    // [kBQF32][kLDP]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.y * kBQF32;
  const size_t base = (size_t)blockIdx.x * t * HD;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < kBQF32 * kQ4; i += kThreadsF32) {
    const int r = i / kQ4, c = i % kQ4, row = q0 + r;
    *reinterpret_cast<float4*>(qs + r * L::kLDQ + c * 4) =
        row < t ? *reinterpret_cast<const float4*>(qb + (size_t)row * HD +
                                                   c * 4)
                : zero;
  }

  // this thread's rows are ty + 16 i, its keys tx*4 .. tx*4+3, its O
  // columns g*16*kVW + tx*kVW + e
  float acc[8][kCols], m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < n_valid; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * kQ4; i += kThreadsF32) {
      const int r = i / kQ4, c = i % kQ4, key = k0 + r;
      *reinterpret_cast<float4*>(vs + r * HD + c * 4) =
          key < n_valid ? *reinterpret_cast<const float4*>(
                              vb + (size_t)key * HD + c * 4)
                        : zero;
    }
    if constexpr (kKT) {  // kb is (HD, t): copy rows, lanes over keys
      for (int i = tid; i < HD * kBK; i += kThreadsF32) {
        const int d = i / kBK, r = i % kBK, key = k0 + r;
        kts[d * L::kLDK + r] = key < n_valid ? kb[(size_t)d * t + key] : 0.f;
      }
    } else {  // transpose: lanes over keys, so the shared stores never clash
      for (int i = tid; i < kBK * kQ4; i += kThreadsF32) {
        const int r = i % kBK, c = i / kBK, key = k0 + r;
        const float4 x = key < n_valid ? *reinterpret_cast<const float4*>(
                                             kb + (size_t)key * HD + c * 4)
                                       : zero;
        kts[(4 * c + 0) * L::kLDK + r] = x.x;
        kts[(4 * c + 1) * L::kLDK + r] = x.y;
        kts[(4 * c + 2) * L::kLDK + r] = x.z;
        kts[(4 * c + 3) * L::kLDK + r] = x.w;
      }
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < kQ4; ++d4) {
      float4 kk[4];
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        kk[dd] = *reinterpret_cast<const float4*>(
            kts + (4 * d4 + dd) * L::kLDK + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * L::kLDQ + 4 * d4);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = fmaf(lane_of(qv, dd), lane_of(kk[dd], j), s[i][j]);
      }
    }
    if (k0 + kBK > n_valid) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx * 4 + j >= n_valid) {
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i][j] = -CUDART_INF_F;
        }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(wca::kFullMask, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float4 p;
      p.x = expf(s[i][0] - m_new);
      p.y = expf(s[i][1] - m_new);
      p.z = expf(s[i][2] - m_new);
      p.w = expf(s[i][3] - m_new);
      l_run[i] = l_run[i] * alpha + ((p.x + p.y) + (p.z + p.w));
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty + 16 * i) * L::kLDP + tx * 4) = p;
    }
    __syncwarp();  // a row's P is written and read by its own 16 lanes

#pragma unroll 2
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float vv[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          float x[kVW];
          load_vec<kVW>(vs + (4 * j4 + jj) * HD + g * 16 * kVW + tx * kVW, x);
#pragma unroll
          for (int e = 0; e < kVW; ++e) vv[jj][g * kVW + e] = x[e];
        }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(
            ps + (ty + 16 * i) * L::kLDP + 4 * j4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[i][c] = fmaf(lane_of(pv, jj), vv[jj][c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(wca::kFullMask, l, off);
    const int row = q0 + ty + 16 * i;
    if (row < t) {
      const float inv = 1.f / l;
      float* orow = o + base + (size_t)row * HD;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        orow[(c / kVW) * 16 * kVW + tx * kVW + c % kVW] = acc[i][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD, bool kKT>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int bh, int t, int n_valid, int is_bf16,
                      cudaStream_t stream) {
  if (is_bf16) {
    using L = Bf16Tile<HD, kKT>;
    constexpr auto kernel = kKT ? encoder_attn_kernel_bf16_kt<HD>
                                : encoder_attn_kernel_bf16<HD>;
    cudaError_t err = wca::allow_smem<kernel>(L::kSmem);
    if (err != cudaSuccess) return err;
    const int kt_bytes = kKT ? wca::copy_width(2LL * t, 2) : 16;
    dim3 grid(bh, (t + L::kBQ - 1) / L::kBQ);
    kernel<<<grid, kWarpsBf16 * 32, L::kSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), t, n_valid,
        kt_bytes);
  } else {
    using L = F32Tile<HD>;
    constexpr auto kernel = encoder_attn_kernel_f32<HD, kKT>;
    cudaError_t err = wca::allow_smem<kernel>(L::kSmem);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (t + kBQF32 - 1) / kBQF32);
    kernel<<<grid, kThreadsF32, L::kSmem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), t, n_valid);
  }
  return cudaGetLastError();
}

template <bool kKT>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int t, int n_valid, int hd, int is_bf16, void* stream) {
  if (bh <= 0 || t <= 0 || n_valid <= 0 || n_valid > t)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16, kKT>(q, k, v, o, bh, t, n_valid, is_bf16, s);
    case 32: return launch_hd<32, kKT>(q, k, v, o, bh, t, n_valid, is_bf16, s);
    case 64: return launch_hd<64, kKT>(q, k, v, o, bh, t, n_valid, is_bf16, s);
    case 128:
      return launch_hd<128, kKT>(q, k, v, o, bh, t, n_valid, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (bh, t, hd) contiguous, 16-byte aligned, float32
// (is_bf16 == 0) or bfloat16.
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
