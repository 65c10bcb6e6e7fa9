// Decoder attention whose every row is computed in one order fixed by the
// head dim and the key chunks' positions alone: a row's result does not
// depend on how many other rows, batch items or heads share the call.
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
//   run).
//
// Design: the key axis is cut into chunks of kChunk = 128 columns at fixed
//   positions (chunk c is columns [128c, 128c + 128), whatever S is) and the
//   query rows into tiles of 16; a block of 4 warps takes one (query tile,
//   chunk, batch item x head). K and V chunks are staged in shared memory by
//   cp.async, in 16-, 8- or 4-byte pieces along whichever axis has stride 1
//   (S in the cache layout, hd in a projection's). A bf16 cache an odd
//   number of columns long (35 at a TIMIT decode's cap, 99 at a
//   LibriSpeech one's, 227 in long form) keeps no row 4-byte aligned: the
//   16-byte words that hold its rows land by cp.async in the rows' places,
//   then a thread a row shifts each into place (stage_unaligned). Staged
//   one 2-byte load after another (128 a thread for K and V), such a self
//   step took 61-66 us on an H100 at B=16 S=99 and B=32 S=35, against 9.4
//   and 10.4 us at S=104 and 40; staged so, 10.8 and 11.2 us. bf16
//   products are mma.sync.m16n8k16 (bf16 in, f32 sums): the scores over hd
//   in rising 16-deep steps from zero, K' rounded in the fragment; P.V over
//   a chunk's keys in rising order from zero. Per row and chunk: the scores
//   plus the mask; m_c and l_c = sum exp(s - m_c) (each warp's 32 keys, then
//   the 4 warps in order); M and L = sum_c l_c exp(m_c - M) folded in rising
//   chunk order; the weights the plain version's dtype(exp(s - M) / L),
//   normalised then rounded; the chunks' f32 P.V partials added in rising
//   chunk order, rounded once.
//   - S in one chunk (a decode step's self-attention, a transcript's): one
//     launch, dec_attn_one, does all of it in the block.
//   - Past one chunk, two launches. dec_attn_qk writes the scores (the
//     output, or a workspace) and each row's (m_c, l_c). dec_attn_pv, a
//     programmatic dependent launch, asks for its V chunk while dec_attn_qk
//     ends, then folds the terms, weighs, and parks its partials; the last
//     block of the tile to arrive (a ticket, which it resets for the next
//     launch or graph replay) adds them. No float atomics.
//   A chunk that the mask hides from every row of the tile is not read: it
//   adds nothing to M, L or P.V, and a row skips every chunk it cannot see,
//   so the self step reads only the cache columns up to its position and
//   more masked keys change no bit. A one-row step goes through the same
//   16-row MMA tile (the other rows unused) and the same folds as a row of a
//   window, a prompt or a transcript: the order depends on hd and the chunk
//   index, never on B, P or S, so one launch or two give the same bits. f32
//   runs the same chunks and folds on the CUDA cores (fmaf chains in rising
//   d and rising key): no TF32. Every exponential is exp2(x log2 e).
//
// What bounds it on an H100: bytes. A decode step's cross attention reads K
//   and V once: at B=8, H=16, hd=64 over 1500 frames of bf16, 49.2 MB (14.7
//   us at 3.35 TB/s); the capture's 96 rows add their f32 scores, 126.0 MB
//   in all. The work, 4 B H P S hd flops, is far below the tensor cores'
//   rate. What holds it back instead is each block's instruction chain (the
//   kernels run no faster from L2 than from HBM): staging by per-thread
//   copies, the fragment-wise K scaling and the per-row softmax terms, at
//   16 KB of K or V a block; at 96 rows, the scores read back and the parked
//   partials (37.7 MB) besides.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // keys a chunk, the same for every shape
constexpr int kTile = 16;    // query rows a tile: one m16 MMA tile
constexpr int kPad = 8;      // bf16 pad of a shared-memory row (16 bytes)
constexpr int kPadF = 4;     // f32 pad
constexpr int kLdW = kChunk + kPad;  // a bf16 row of keys

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  void* out;
  float* scores;   // (B H, P, S): the output, or a workspace; may be null
                   // with one chunk
  float2* stats;   // (B H, P, chunks): (m_c, l_c); null with one chunk
  float* part;     // (B H, P, chunks, hd); null with one chunk
  int* tickets;    // (B H, tiles), zeroed; null with one chunk
  long long qb, qh, qp, kb, kh, kd, ks, vb, vh, vd, vs;
  int n_head, n_rows, n_keys, hd, n_chunks;
  float k_scale;
  int has_scale, want_scores;
  int qw, kw, vw;  // copy widths in bytes (16, 8, 4; 2: stage_unaligned)
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory into mma fragments: lanes 8i to
// 8i + 7 give the 16-byte row addresses of matrix i; `.trans` delivers each
// matrix transposed.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// B fragments of two n8 tiles (n0, n0 + 8) at depth kk, from a panel whose
// rows run along n ([n][k], `kTrans` false) or along k ([k][n], true).
template <bool kTrans>
__device__ __forceinline__ void load_b(uint32_t* b4,
                                       const __nv_bfloat16* sm, int ld,
                                       int n0, int kk, int lane) {
  if constexpr (kTrans)
    ldmatrix_x4<true>(b4, sm + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                              n0 + (lane >> 4) * 8);
  else
    ldmatrix_x4<false>(b4, sm + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                               kk + ((lane >> 3) & 1) * 8);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
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

// e^x as 2^(x log2 e): one special-function instruction. Every exponential
// of the kernels is this one, so the weights and their sums agree.
__device__ __forceinline__ float ex(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// Panels whose 2-byte rows no piece of 4 bytes or more keeps aligned (a
// cache an odd number of columns long, its rows starting 2 bytes off 4) go
// in two steps:
// - stage_unaligned: the 16-byte words of global memory that hold a row's
//   valid elements land by cp.async in the row's own place in shared memory
//   (they fit: a row is n_inner + kPad elements, and the words n_inner / 8
//   + 1 at most), word j in piece j, so that a warp's copies are as
//   contiguous as stage's aligned ones; the pieces past them are zeroed;
// - settle_unaligned, once every copy has landed (a barrier, since other
//   threads asked for them): a thread a row, thread `first` taking row 0,
//   shifts its row down by the row's offset into its first word (8, 4 and 2
//   bytes, as the offset's bits ask), a 16-byte piece at a time from the
//   first, so each word is read before it is written over, and zeroes what
//   lies past the valid elements.
// The bytes end where stage's aligned paths put them.
__device__ __forceinline__ int row_offset(const void* row) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
}

// 16-byte words that hold a row's first `valid` 2-byte elements.
__device__ __forceinline__ int row_words(int offset, int valid) {
  return valid > 0 ? (offset + 2 * valid + 15) >> 4 : 0;
}

template <typename T>
__device__ __forceinline__ void stage_unaligned(T* sm, int ld, const T* g,
                                                long long stride, int n_outer,
                                                int n_inner, int valid_outer,
                                                int valid_inner) {
  const int pieces = n_inner / 8;
  const int valid = max(0, min(n_inner, valid_inner));
  // word j of row o into piece j, zeros past the row's words; the last
  // piece's thread also lands the word past it (the pad) where there is one
  auto put = [&](int o, int j) {
    const char* row = reinterpret_cast<const char*>(g + o * stride);
    const int sh = row_offset(row);
    const int n_words = o < valid_outer ? row_words(sh, valid) : 0;
    const void* word = row - sh + 16 * j;
    T* dst = sm + o * ld + 8 * j;
    wca::cp_async<16>(dst, j < n_words ? word : g, j < n_words ? 16 : 0);
    if (j == pieces - 1 && n_words > pieces)
      wca::cp_async<16>(dst + 8, row - sh + 16 * (j + 1), 16);
  };
  if (kThreads % pieces == 0) {
    const int step = kThreads / pieces, o0 = threadIdx.x / pieces;
    const int j = threadIdx.x - o0 * pieces;
    for (int o = o0; o < n_outer; o += step) put(o, j);
    return;
  }
  for (int i = threadIdx.x; i < n_outer * pieces; i += kThreads)
    put(i / pieces, i % pieces);
}

template <typename T>
__device__ __forceinline__ void settle_unaligned(T* sm, int ld, const T* g,
                                                 long long stride,
                                                 int n_outer, int n_inner,
                                                 int valid_outer,
                                                 int valid_inner, int first) {
  static_assert(sizeof(T) == 2, "2-byte elements only");
  const int valid = max(0, min(n_inner, valid_inner));
  const int n_pieces = (valid + 7) / 8;  // pieces with a valid element
  const uint4 zeros = make_uint4(0, 0, 0, 0);
  const int o0 =
      ((static_cast<int>(threadIdx.x) - first) % kThreads + kThreads) %
      kThreads;
  for (int o = o0; o < min(n_outer, valid_outer); o += kThreads) {
    const int sh = row_offset(g + o * stride);
    const int n_words = row_words(sh, valid);
    uint4* row = reinterpret_cast<uint4*>(sm + o * ld);
    uint4 lo = n_words > 0 ? row[0] : zeros;
#pragma unroll 4
    for (int j = 0; j < n_pieces; ++j) {
      const uint4 hi = j + 1 < n_words ? row[j + 1] : zeros;
      uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 6; ++i) w[i] = (sh & 8) ? w[i + 2] : w[i];
#pragma unroll
      for (int i = 0; i < 5; ++i) w[i] = (sh & 4) ? w[i + 1] : w[i];
      uint32_t p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 8 * j + 2 * k;  // this word's elements: e, e + 1
        const uint32_t x = __funnelshift_r(w[k], w[k + 1], (sh & 2) * 8);
        p[k] = e + 1 < valid ? x : e < valid ? x & 0xffffu : 0u;
      }
      row[j] = make_uint4(p[0], p[1], p[2], p[3]);
      lo = hi;
    }
    // the word past the valid pieces landed with the row's tail
    if (n_words > n_pieces && n_pieces < n_inner / 8) row[n_pieces] = zeros;
  }
}

// An n_outer x n_inner panel (inner axis contiguous in global memory, outer
// rows `stride` elements apart) into shared rows of `ld` elements, by
// cp.async pieces of `width` bytes; width 2 (no piece of 4 bytes or more
// keeps every row aligned): stage_unaligned, which put_panel<true>
// finishes.
// Elements past (valid_outer, valid_inner) end zero, and nothing outside
// the 16-byte words that hold the valid ones is read. n_inner is a
// multiple of 8, ld at least n_inner + 8.
template <typename T>
__device__ __forceinline__ void stage(T* sm, int ld, const T* g,
                                      long long stride, int n_outer,
                                      int n_inner, int valid_outer,
                                      int valid_inner, int width) {
  constexpr int kElem = sizeof(T);
  if (width < 4) {
    stage_unaligned(sm, ld, g, stride, n_outer, n_inner, valid_outer,
                    valid_inner);
    return;
  }
  const int per = width / kElem;
  const int pieces = n_inner / per;
  auto put = [&](T* dst, const T* src, int valid) {
    wca::cp_async_w(dst, valid ? src : g, width, valid * kElem);
  };
  if (kThreads % pieces == 0) {
    // a thread keeps one piece of the row and walks the rows: the piece's
    // place and its valid length are worked out once
    const int step = kThreads / pieces, o0 = threadIdx.x / pieces;
    const int e0 = (threadIdx.x - o0 * pieces) * per;
    const int valid = max(0, min(per, valid_inner - e0));
    const T* src = g + o0 * stride + e0;
    T* dst = sm + o0 * ld + e0;
    for (int o = o0; o < n_outer; o += step) {
      put(dst, src, o < valid_outer ? valid : 0);
      src += step * stride;
      dst += step * ld;
    }
    return;
  }
  for (int i = threadIdx.x; i < n_outer * pieces; i += kThreads) {
    const int o = i / pieces, e0 = (i - o * pieces) * per;
    put(sm + o * ld + e0, g + o * stride + e0,
        o < valid_outer ? max(0, min(per, valid_inner - e0)) : 0);
  }
}

// Whether some panel of the call is staged unaligned, so that it has to be
// shifted once its copies land (put_panel<true>; the same in every thread
// of the grid).
__device__ __forceinline__ bool unaligned(const Args& a) {
  return a.qw < 4 || a.kw < 4 || a.vw < 4;
}

// stage, or (kSettle) its second step, by one set of arguments: once
// every thread's copies have landed and before the panel is read, the
// unaligned path's shift, its rows taken by the threads from `first` on;
// nothing on the aligned paths.
template <bool kSettle, typename T>
__device__ __forceinline__ void put_panel(T* sm, int ld, const T* g,
                                          long long stride, int n_outer,
                                          int n_inner, int valid_outer,
                                          int valid_inner, int width,
                                          int first) {
  if constexpr (!kSettle)
    stage(sm, ld, g, stride, n_outer, n_inner, valid_outer, valid_inner,
          width);
  else if constexpr (sizeof(T) == 2)
    if (width < 4)
      settle_unaligned(sm, ld, g, stride, n_outer, n_inner, valid_outer,
                       valid_inner, first);
}

// A row's chunk terms from the 4 warps' (m_w, l_w), in warp order:
// m_c = max m_w, l_c = sum l_w exp(m_w - m_c) over the warps that see it.
__device__ __forceinline__ float2 combine(const float (*wm)[kTile],
                                          const float (*wl)[kTile], int r) {
  float m = wm[0][r];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wm[w][r]);
  float l = 0.f;
  if (m != -CUDART_INF_F)
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (wm[w][r] != -CUDART_INF_F) l += wl[w][r] * ex(wm[w][r] - m);
  return make_float2(m, l);
}

// Where a block sits: its query tile, key chunk, batch item and head.
struct Place {
  int b, h, bh, tile, chunk, p0, rows, c0, cols;
  __device__ Place(const Args& a) {
    tile = blockIdx.x;
    chunk = blockIdx.y;
    bh = blockIdx.z;
    b = bh / a.n_head;
    h = bh - b * a.n_head;
    p0 = tile * kTile;
    rows = min(kTile, a.n_rows - p0);
    c0 = chunk * kChunk;
    cols = min(kChunk, a.n_keys - c0);
  }
  __device__ long long row(const Args& a, int r) const {
    return (long long)bh * a.n_rows + p0 + r;
  }
  __device__ long long out_at(const Args& a, int r, int d) const {
    return (((long long)b * a.n_rows + p0 + r) * a.n_head + h) * a.hd + d;
  }
};

// Each row's softmax terms as the P.V phase reads them.
struct RowTerms {
  float m[kTile], l[kTile];
  int sees[kTile];
};

// True in every thread when the mask shows some column of the chunk to some
// row of the tile (always without a mask).
__device__ __forceinline__ bool chunk_visible(const Args& a, const Place& at) {
  if (a.mask == nullptr) return true;
  bool seen = false;
  for (int e = threadIdx.x; e < at.rows * at.cols; e += kThreads) {
    const int r = e / at.cols, c = e - r * at.cols;
    seen |= a.mask[(long long)(at.p0 + r) * a.n_keys + at.c0 + c] !=
            -CUDART_INF_F;
  }
  return __syncthreads_or(seen);
}

// A chunk no row sees: -inf scores when asked, and (m_c, l_c) = (-inf, 0)
// where the key axis is split (one chunk: the rows' outputs are zeros).
template <typename T>
__device__ void hidden_chunk(const Args& a, const Place& at) {
  if (a.want_scores)
    for (int e = threadIdx.x; e < at.rows * at.cols; e += kThreads) {
      const int r = e / at.cols, c = e - r * at.cols;
      a.scores[at.row(a, r) * a.n_keys + at.c0 + c] = -CUDART_INF_F;
    }
  if (a.n_chunks > 1)
    for (int r = threadIdx.x; r < at.rows; r += kThreads)
      a.stats[at.row(a, r) * a.n_chunks + at.chunk] =
          make_float2(-CUDART_INF_F, 0.f);
  else
    for (int e = threadIdx.x; e < at.rows * a.hd; e += kThreads)
      static_cast<T*>(a.out)[at.out_at(a, e / a.hd, e % a.hd)] = zero<T>();
}

// The score of row r, column c of the chunk: the product, plus the mask;
// -inf past the key axis. Written out where there is a scores buffer.
__device__ __forceinline__ float masked(const Args& a, const Place& at, int r,
                                        int c, float s) {
  if (r >= at.rows) return s;  // a row past the tile: never read
  if (c >= at.cols) return -CUDART_INF_F;
  if (a.mask != nullptr)
    s += a.mask[(long long)(at.p0 + r) * a.n_keys + at.c0 + c];
  if (a.scores != nullptr) a.scores[at.row(a, r) * a.n_keys + at.c0 + c] = s;
  return s;
}

// A row's softmax terms from its n chunks' (m_c, l_c), in rising chunk
// order: M the max, L the sum of l_c exp(m_c - M) over the chunks it sees;
// `sees` whether it sees chunk `chunk`. Rows past the tile see nothing.
__device__ __forceinline__ void fold_terms(const float2* st, int n, int chunk,
                                           bool valid, RowTerms& rt, int r) {
  float m = -CUDART_INF_F, l = 0.f;
  int sees = 0;
  if (valid) {
#pragma unroll 4
    for (int c = 0; c < n; ++c) m = fmaxf(m, st[c].x);
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float2 s = st[c];
      if (s.x != -CUDART_INF_F) l += s.y * ex(s.x - m);
    }
    sees = st[chunk].x != -CUDART_INF_F;
  }
  rt.m[r] = m;
  rt.l[r] = l;
  rt.sees[r] = sees;
}

// The weight of row r at column c: the plain version's dtype(exp(s - M) /
// L), zero where the row does not see the chunk and past the key axis.
template <typename T>
__device__ __forceinline__ T weight(const Place& at, const RowTerms& rt,
                                    int r, int c, float s) {
  float w = 0.f;
  if (r < at.rows && c < at.cols && rt.sees[r])
    w = ex(s - rt.m[r]) / rt.l[r];
  return narrow<T>(w);
}

// Park a block's partials; the last of the tile's chunks to arrive returns
// true (and resets the ticket for the next launch).
__device__ __forceinline__ bool last_of_tile(int* tickets, int tile,
                                             int n_chunks) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(&tickets[tile], 1);
    last = t == n_chunks - 1;
    if (last) tickets[tile] = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// A chunk's partial of output (r, d), zero where the row does not see the
// chunk: the output itself with one chunk, else parked for the fold.
template <typename T>
__device__ __forceinline__ void put_partial(const Args& a, const Place& at,
                                            const RowTerms& rt, int r, int d,
                                            float o) {
  if (r >= at.rows || d >= a.hd) return;
  o = rt.sees[r] ? o : 0.f;
  if (a.n_chunks == 1)
    static_cast<T*>(a.out)[at.out_at(a, r, d)] = narrow<T>(o);
  else
    a.part[(at.row(a, r) * a.n_chunks + at.chunk) * a.hd + d] = o;
}

// The last block of a tile: each output (r, d) the row's partials of the
// chunks it sees, added in rising chunk order (the first copied), rounded
// once. Every partial is loaded, a few in flight at once; those of chunks
// the row does not see are not added.
template <typename T>
__device__ __forceinline__ void fold_partials(const Args& a, const Place& at) {
  if (!last_of_tile(a.tickets, at.bh * gridDim.x + at.tile, a.n_chunks))
    return;
  for (int e = threadIdx.x; e < at.rows * a.hd; e += kThreads) {
    const int r = e / a.hd, d = e - r * a.hd;
    const long long row = at.row(a, r);
    const float2* st = a.stats + row * a.n_chunks;
    const float* pr = a.part + row * a.n_chunks * a.hd + d;
    float o = 0.f;
    bool first = true;
#pragma unroll 4
    for (int c = 0; c < a.n_chunks; ++c) {
      const float p = __ldcg(pr + (long long)c * a.hd);
      if (st[c].x != -CUDART_INF_F) {
        o = first ? p : o + p;
        first = false;
      }
    }
    static_cast<T*>(a.out)[at.out_at(a, r, d)] = narrow<T>(o);
  }
}

// Programmatic dependent launch: the P.V launch may start while the scores
// launch runs, and waits here before it reads what that launch wrote.
__device__ __forceinline__ void let_dependents_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_scores() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf = __nv_bfloat16;

// Shared-memory panels in bf16 elements: Q (16 rows of the MMA depth hdp,
// padded), a K or V chunk (kCache: (hd, S) with S contiguous, rows of
// kLdW; else (S, hd), rows of hdp + kPad), the weights (16 x kLdW).
__host__ __device__ constexpr int q_tile_bf16(int hdp) {
  return kTile * (hdp + kPad);
}
__host__ __device__ constexpr int panel_bf16(bool cache, int hdp) {
  return cache ? hdp * kLdW : kChunk * (hdp + kPad);
}
constexpr int kWTileBf16 = kTile * kLdW;

// Q's and K's panels: staged, or (kSettle) settled once their copies have
// landed.
template <bool kCache, bool kSettle = false>
__device__ __forceinline__ void stage_qk_bf16(const Args& a, const Place& at,
                                              bf* qs, bf* ksm, int hdp) {
  put_panel<kSettle>(qs, hdp + kPad,
      static_cast<const bf*>(a.q) + at.b * a.qb + at.h * a.qh + at.p0 * a.qp,
      a.qp, at.rows, hdp, at.rows, a.hd, a.qw, 0);
  const bf* kg = static_cast<const bf*>(a.k) + at.b * a.kb + at.h * a.kh;
  if (kCache)
    put_panel<kSettle>(ksm, kLdW, kg + at.c0, a.kd, hdp, kChunk, a.hd,
                       at.cols, a.kw, 0);
  else
    put_panel<kSettle>(ksm, hdp + kPad, kg + at.c0 * a.ks, a.ks, kChunk, hdp,
                       at.cols, a.hd, a.kw, 0);
}

// V's panel, as stage_qk_bf16. `first`: the thread that settles V's row 0
// where its rows are staged unaligned (dec_attn_one: the thread after K's
// rows, so that K's rows and V's are settled by different threads).
template <bool kCache, bool kSettle = false>
__device__ __forceinline__ void stage_v_bf16(const Args& a, const Place& at,
                                             bf* vsm, int hdp, int first) {
  const bf* vg = static_cast<const bf*>(a.v) + at.b * a.vb + at.h * a.vh;
  if (kCache)
    put_panel<kSettle>(vsm, kLdW, vg + at.c0, a.vd, hdp, kChunk, a.hd,
                       at.cols, a.vw, first);
  else
    put_panel<kSettle>(vsm, hdp + kPad, vg + at.c0 * a.vs, a.vs, kChunk, hdp,
                       at.cols, a.hd, a.vw, first);
}

// The tile's scores over the chunk, masked: warp w holds keys [32w, 32w +
// 32) as four n8 tiles, element e of tile j at row g (+8 for e >= 2),
// column 32w + 8j + 2t (+1). Each K element reaches one fragment once,
// where it becomes k' = dtype(k * k_scale).
template <bool kCache>
__device__ __forceinline__ void scores_bf16(const Args& a, const Place& at,
                                            const bf* qs, const bf* ksm,
                                            int hdp, float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ldq = hdp + kPad, ldk = kCache ? kLdW : ldq;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < hdp; kk += 16) {
    uint32_t af[4];
    ldmatrix_x4<false>(af, qs + (lane & 15) * ldq + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b4[4];
      load_b<kCache>(b4, ksm, ldk, warp * 32 + j * 8, kk, lane);
      if (a.has_scale)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&b4[i]);
          const float2 f = __bfloat1622float2(x);
          x = __floats2bfloat162_rn(f.x * a.k_scale, f.y * a.k_scale);
          b4[i] = *reinterpret_cast<uint32_t*>(&x);
        }
      mma_bf16(acc[j], af, b4);
      mma_bf16(acc[j + 1], af, b4 + 2);
    }
  }
  // the thread's two rows (g, g + 8): mask added, scores written, -inf past
  // the key axis; rows past the tile are never read
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    if (r >= at.rows) continue;
    const float* mrow =
        a.mask == nullptr
            ? nullptr
            : a.mask + (long long)(at.p0 + r) * a.n_keys + at.c0;
    float* srow = a.scores == nullptr
                      ? nullptr
                      : a.scores + at.row(a, r) * a.n_keys + at.c0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = warp * 32 + j * 8 + 2 * t + h;
        float& s = acc[j][2 * i + h];
        if (c >= at.cols) {
          s = -CUDART_INF_F;
        } else {
          if (mrow != nullptr) s += mrow[c];
          if (srow != nullptr) srow[c] = s;
        }
      }
  }
}

// Each row's chunk terms (m_c, l_c): each warp's max and sum of exp over its
// 32 keys (the 4 lanes of a row by a butterfly), then the warps combined in
// order. Thread r < 16 gets row r's.
__device__ __forceinline__ float2 terms_bf16(const float (&acc)[4][4],
                                             int rows) {
  __shared__ float wm[kWarps][kTile], wl[kWarps][kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], acc[j][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(wca::kFullMask, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(wca::kFullMask, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (g + (e >> 1) * 8 < rows && mx[e >> 1] != -CUDART_INF_F)
        l[e >> 1] += ex(acc[j][e] - mx[e >> 1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(wca::kFullMask, l[i], 1);
    l[i] += __shfl_xor_sync(wca::kFullMask, l[i], 2);
  }
  if (t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wm[warp][g + 8 * i] = mx[i];
      wl[warp][g + 8 * i] = l[i];
    }
  __syncthreads();
  return threadIdx.x < kTile ? combine(wm, wl, threadIdx.x)
                             : make_float2(0.f, 0.f);
}

// P.V over the chunk's keys in rising order from zero: pairs of n8 tiles of
// hd, warp w the pairs w, w + 4, ... kCache: V laid out (hd, S).
template <typename TO, bool kCache>
__device__ __forceinline__ void pv_bf16(const Args& a, const Place& at,
                                        const RowTerms& rt, const bf* wsm,
                                        const bf* vsm, int hdp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ldv = kCache ? kLdW : hdp + kPad;
  for (int n0 = warp * 16; n0 < hdp; n0 += kWarps * 16) {
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t af[4], b4[4];
      ldmatrix_x4<false>(af, wsm + (lane & 15) * kLdW + kk + (lane >> 4) * 8);
      load_b<!kCache>(b4, vsm, ldv, n0, kk, lane);
      mma_bf16(acc[0], af, b4);
      mma_bf16(acc[1], af, b4 + 2);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put_partial<TO>(a, at, rt, g + (e >> 1) * 8,
                        n0 + j * 8 + 2 * t + (e & 1), acc[j][e]);
  }
}

// Split key axis, launch 1: the chunk's scores and each row's terms.
template <bool kCache>
__global__ void __launch_bounds__(kThreads)
    dec_attn_qk_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  let_dependents_start();
  const Place at(a);
  if (!chunk_visible(a, at)) {
    hidden_chunk<bf>(a, at);
    return;
  }
  const int hdp = (a.hd + 15) & ~15;  // MMA depth, zero-padded
  bf* qs = reinterpret_cast<bf*>(smem);
  bf* ksm = qs + q_tile_bf16(hdp);
  stage_qk_bf16<kCache>(a, at, qs, ksm, hdp);
  wca::cp_async_commit();
  wca::cp_async_wait<0>();
  if (unaligned(a)) {
    __syncthreads();
    stage_qk_bf16<kCache, true>(a, at, qs, ksm, hdp);
  }
  __syncthreads();
  float acc[4][4];
  scores_bf16<kCache>(a, at, qs, ksm, hdp, acc);
  const float2 ml = terms_bf16(acc, at.rows);
  if (threadIdx.x < at.rows)
    a.stats[at.row(a, threadIdx.x) * a.n_chunks + at.chunk] = ml;
}

// Split key axis, launch 2: the chunk's P.V partials and the fold. V is
// asked for first, where the mask shows the chunk, while launch 1 ends.
template <bool kCache>
__global__ void __launch_bounds__(kThreads)
    dec_attn_pv_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RowTerms rt;
  const Place at(a);
  const int hdp = (a.hd + 15) & ~15;
  bf* wsm = reinterpret_cast<bf*>(smem);
  bf* vsm = wsm + kWTileBf16;
  if (chunk_visible(a, at)) stage_v_bf16<kCache>(a, at, vsm, hdp, 0);
  wca::cp_async_commit();
  wait_for_scores();
  if (threadIdx.x < kTile)
    fold_terms(a.stats + at.row(a, threadIdx.x) * a.n_chunks, a.n_chunks,
               at.chunk, threadIdx.x < at.rows, rt, threadIdx.x);
  const bool any = __syncthreads_or(threadIdx.x < kTile && rt.sees[threadIdx.x]);
  if (any) {
    for (int e = threadIdx.x; e < at.rows * kChunk; e += kThreads) {
      const int r = e / kChunk, c = e - r * kChunk;
      const float s = c < at.cols
                          ? a.scores[at.row(a, r) * a.n_keys + at.c0 + c]
                          : 0.f;
      wsm[r * kLdW + c] = weight<bf>(at, rt, r, c, s);
    }
    wca::cp_async_wait<0>();
    if (unaligned(a)) {
      __syncthreads();
      stage_v_bf16<kCache, true>(a, at, vsm, hdp, 0);
    }
    __syncthreads();
    pv_bf16<bf, kCache>(a, at, rt, wsm, vsm, hdp);
  }
  wca::cp_async_wait<0>();
  fold_partials<bf>(a, at);
}

// The key axis in one chunk: scores, terms, weights and P.V in one block,
// the same arithmetic as the split launches.
template <bool kKCache, bool kVCache>
__global__ void __launch_bounds__(kThreads)
    dec_attn_one_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RowTerms rt;
  const Place at(a);
  if (!chunk_visible(a, at)) {
    hidden_chunk<bf>(a, at);
    return;
  }
  const int hdp = (a.hd + 15) & ~15;
  bf* qs = reinterpret_cast<bf*>(smem);
  bf* ksm = qs + q_tile_bf16(hdp);
  bf* wsm = ksm + panel_bf16(kKCache, hdp);
  bf* vsm = wsm + kWTileBf16;
  const int v_first = kKCache ? hdp : kChunk;
  stage_qk_bf16<kKCache>(a, at, qs, ksm, hdp);
  stage_v_bf16<kVCache>(a, at, vsm, hdp, v_first);
  wca::cp_async_commit();
  wca::cp_async_wait<0>();
  if (unaligned(a)) {
    __syncthreads();
    stage_qk_bf16<kKCache, true>(a, at, qs, ksm, hdp);
    stage_v_bf16<kVCache, true>(a, at, vsm, hdp, v_first);
  }
  __syncthreads();
  float acc[4][4];
  scores_bf16<kKCache>(a, at, qs, ksm, hdp, acc);
  const float2 ml = terms_bf16(acc, at.rows);
  if (threadIdx.x < kTile)
    fold_terms(&ml, 1, 0, threadIdx.x < at.rows, rt, threadIdx.x);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (lane >> 2) + (e >> 1) * 8;
      const int c = warp * 32 + j * 8 + 2 * (lane & 3) + (e & 1);
      wsm[r * kLdW + c] = weight<bf>(at, rt, r, c, acc[j][e]);
    }
  __syncthreads();
  pv_bf16<bf, kVCache>(a, at, rt, wsm, vsm, hdp);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// Shared-memory panels in floats: Q (16 x hd), a K or V chunk (kCache:
// (hd, S), rows of 132; else (S, hd), rows of hd + 4), the weights (16 x
// 128).
__host__ __device__ constexpr int panel_f32(bool cache, int hd) {
  return cache ? hd * (kChunk + kPadF) : kChunk * (hd + kPadF);
}
constexpr int kWTileF32 = kTile * kChunk;

template <bool kCache>
__device__ __forceinline__ void stage_qk_f32(const Args& a, const Place& at,
                                             float* qs, float* ksm) {
  stage(qs, a.hd,
        static_cast<const float*>(a.q) + at.b * a.qb + at.h * a.qh +
            at.p0 * a.qp,
        a.qp, at.rows, a.hd, at.rows, a.hd, a.qw);
  const float* kg = static_cast<const float*>(a.k) + at.b * a.kb + at.h * a.kh;
  if (kCache)
    stage(ksm, kChunk + kPadF, kg + at.c0, a.kd, a.hd, kChunk, a.hd, at.cols,
          a.kw);
  else
    stage(ksm, a.hd + kPadF, kg + at.c0 * a.ks, a.ks, kChunk, a.hd, at.cols,
          a.hd, a.kw);
}

template <bool kCache>
__device__ __forceinline__ void stage_v_f32(const Args& a, const Place& at,
                                            float* vsm) {
  const float* vg = static_cast<const float*>(a.v) + at.b * a.vb + at.h * a.vh;
  if (kCache)
    stage(vsm, kChunk + kPadF, vg + at.c0, a.vd, a.hd, kChunk, a.hd, at.cols,
          a.vw);
  else
    stage(vsm, a.hd + kPadF, vg + at.c0 * a.vs, a.vs, kChunk, a.hd, at.cols,
          a.hd, a.vw);
}

// Thread c: the scores of key c of the chunk for every row of the tile, a
// chain of fmaf in rising d, masked.
template <bool kCache>
__device__ __forceinline__ void scores_f32(const Args& a, const Place& at,
                                           const float* qs, const float* ksm,
                                           float (&acc)[kTile]) {
  const int c = threadIdx.x;
  const int ldk = kCache ? kChunk + kPadF : a.hd + kPadF;
#pragma unroll
  for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
  for (int d = 0; d < a.hd; ++d) {
    float kv = kCache ? ksm[d * ldk + c] : ksm[c * ldk + d];
    if (a.has_scale) kv *= a.k_scale;
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      if (r < at.rows) acc[r] = fmaf(qs[r * a.hd + d], kv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kTile; ++r) acc[r] = masked(a, at, r, c, acc[r]);
}

// Each row's chunk terms: each warp's max and sum of exp over its 32 keys
// (butterflies), then the 4 warps combined in order. Thread r < 16 gets
// row r's.
__device__ __forceinline__ float2 terms_f32(const float (&acc)[kTile],
                                            int rows) {
  __shared__ float wm[kWarps][kTile], wl[kWarps][kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    if (r >= rows) break;
    float m = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(wca::kFullMask, m, off));
    float x = m == -CUDART_INF_F ? 0.f : ex(acc[r] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(wca::kFullMask, x, off);
    if (lane == 0) {
      wm[warp][r] = m;
      wl[warp][r] = x;
    }
  }
  __syncthreads();
  return threadIdx.x < kTile ? combine(wm, wl, threadIdx.x)
                             : make_float2(0.f, 0.f);
}

// P.V: output (r, d) a chain of fmaf over the chunk's keys in rising order.
template <bool kCache>
__device__ __forceinline__ void pv_f32(const Args& a, const Place& at,
                                       const RowTerms& rt, const float* wsm,
                                       const float* vsm) {
  const int ldv = kCache ? kChunk + kPadF : a.hd + kPadF;
  for (int e = threadIdx.x; e < at.rows * a.hd; e += kThreads) {
    const int r = e / a.hd, d = e - r * a.hd;
    float o = 0.f;
    if (rt.sees[r])
      for (int c = 0; c < at.cols; ++c)
        o = fmaf(wsm[r * kChunk + c], kCache ? vsm[d * ldv + c]
                                             : vsm[c * ldv + d], o);
    put_partial<float>(a, at, rt, r, d, o);
  }
}

template <bool kCache>
__global__ void __launch_bounds__(kThreads)
    dec_attn_qk_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  let_dependents_start();
  const Place at(a);
  if (!chunk_visible(a, at)) {
    hidden_chunk<float>(a, at);
    return;
  }
  float* qs = reinterpret_cast<float*>(smem);
  float* ksm = qs + kTile * a.hd;
  stage_qk_f32<kCache>(a, at, qs, ksm);
  wca::cp_async_commit();
  wca::cp_async_wait<0>();
  __syncthreads();
  float acc[kTile];
  scores_f32<kCache>(a, at, qs, ksm, acc);
  const float2 ml = terms_f32(acc, at.rows);
  if (threadIdx.x < at.rows)
    a.stats[at.row(a, threadIdx.x) * a.n_chunks + at.chunk] = ml;
}

template <bool kCache>
__global__ void __launch_bounds__(kThreads)
    dec_attn_pv_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RowTerms rt;
  const Place at(a);
  float* wsm = reinterpret_cast<float*>(smem);
  float* vsm = wsm + kWTileF32;
  if (chunk_visible(a, at)) stage_v_f32<kCache>(a, at, vsm);
  wca::cp_async_commit();
  wait_for_scores();
  if (threadIdx.x < kTile)
    fold_terms(a.stats + at.row(a, threadIdx.x) * a.n_chunks, a.n_chunks,
               at.chunk, threadIdx.x < at.rows, rt, threadIdx.x);
  const bool any = __syncthreads_or(threadIdx.x < kTile && rt.sees[threadIdx.x]);
  if (any) {
    for (int e = threadIdx.x; e < at.rows * kChunk; e += kThreads) {
      const int r = e / kChunk, c = e - r * kChunk;
      const float s = c < at.cols
                          ? a.scores[at.row(a, r) * a.n_keys + at.c0 + c]
                          : 0.f;
      wsm[e] = weight<float>(at, rt, r, c, s);
    }
    wca::cp_async_wait<0>();
    __syncthreads();
    pv_f32<kCache>(a, at, rt, wsm, vsm);
  }
  wca::cp_async_wait<0>();
  fold_partials<float>(a, at);
}

template <bool kKCache, bool kVCache>
__global__ void __launch_bounds__(kThreads)
    dec_attn_one_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RowTerms rt;
  const Place at(a);
  if (!chunk_visible(a, at)) {
    hidden_chunk<float>(a, at);
    return;
  }
  float* qs = reinterpret_cast<float*>(smem);
  float* ksm = qs + kTile * a.hd;
  float* wsm = ksm + panel_f32(kKCache, a.hd);
  float* vsm = wsm + kWTileF32;
  stage_qk_f32<kKCache>(a, at, qs, ksm);
  stage_v_f32<kVCache>(a, at, vsm);
  wca::cp_async_commit();
  wca::cp_async_wait<0>();
  __syncthreads();
  float acc[kTile];
  scores_f32<kKCache>(a, at, qs, ksm, acc);
  const float2 ml = terms_f32(acc, at.rows);
  if (threadIdx.x < kTile)
    fold_terms(&ml, 1, 0, threadIdx.x < at.rows, rt, threadIdx.x);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kTile; ++r)
    wsm[r * kChunk + threadIdx.x] =
        weight<float>(at, rt, r, threadIdx.x, acc[r]);
  __syncthreads();
  pv_f32<kVCache>(a, at, rt, wsm, vsm);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// `after`: the P.V launch, allowed to start before the scores launch ends
// (programmatic dependent launch; it waits in wait_for_scores).
template <auto kKernel>
cudaError_t launch(const Args& a, dim3 grid, size_t smem, cudaStream_t stream,
                   bool after = false) {
  cudaError_t err = wca::allow_smem<kKernel>(smem);
  if (err != cudaSuccess) return err;
  if (!after) {
    kKernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kKernel, a);
}

// One chunk: one launch; else the scores launch, then the P.V launch.
template <auto kQK, auto kPV, auto kOne>
cudaError_t run(const Args& a, dim3 grid, size_t q_tile, size_t k_panel,
                size_t w_tile, size_t v_panel, cudaStream_t stream) {
  if (a.n_chunks == 1)
    return launch<kOne>(a, grid, q_tile + k_panel + w_tile + v_panel, stream);
  const cudaError_t err = launch<kQK>(a, grid, q_tile + k_panel, stream);
  if (err != cudaSuccess) return err;
  return launch<kPV>(a, grid, w_tile + v_panel, stream, true);
}

template <bool kK, bool kV>
cudaError_t run_bf16(const Args& a, dim3 grid, cudaStream_t stream) {
  const int hdp = (a.hd + 15) & ~15;
  return run<dec_attn_qk_bf16_kernel<kK>, dec_attn_pv_bf16_kernel<kV>,
             dec_attn_one_bf16_kernel<kK, kV>>(
      a, grid, q_tile_bf16(hdp) * 2, panel_bf16(kK, hdp) * 2,
      kWTileBf16 * 2, panel_bf16(kV, hdp) * 2, stream);
}

template <bool kK, bool kV>
cudaError_t run_f32(const Args& a, dim3 grid, cudaStream_t stream) {
  return run<dec_attn_qk_f32_kernel<kK>, dec_attn_pv_f32_kernel<kV>,
             dec_attn_one_f32_kernel<kK, kV>>(
      a, grid, kTile * a.hd * 4, panel_f32(kK, a.hd) * 4, kWTileF32 * 4,
      panel_f32(kV, a.hd) * 4, stream);
}

// The widest cp.async piece (16, 8 or 4 bytes; else one element) that keeps
// every piece of a panel aligned: the base and every stride between rows.
int piece_width(const void* p, int elem, long long s0, long long s1,
               long long s2) {
  for (int w = 16; w >= 4; w /= 2)
    if (reinterpret_cast<uintptr_t>(p) % w == 0 && (s0 * elem) % w == 0 &&
        (s1 * elem) % w == 0 && (s2 * elem) % w == 0)
      return w;
  return elem;
}

}  // namespace

// strides: 11 element strides (q: b, h, p; k: b, h, d, s; v: b, h, d, s);
// K and V each have stride 1 along d or along s. With S in one chunk of 128
// keys: one launch; scores (B, H, P, S) f32 when want_scores, else null;
// stats, part and tickets null. Past one chunk: two launches; scores the
// output when want_scores, else a workspace; stats (B H P chunks) f32
// pairs, part (B H P chunks hd) f32, tickets (B H tiles) zeroed ints.
// kv_bf16 / c_bf16: K/V's and the compute dtype's type (else f32); the
// decoder keeps its cache and cross K/V in the compute dtype, so the two
// agree.
WCA_EXPORT int wca_dec_attn(const void* q, const void* k, const void* v,
                            const void* mask, void* out, void* scores,
                            void* stats, void* part, void* tickets,
                            const long long* strides, int b, int n_head,
                            int n_rows, int n_keys, int hd, float k_scale,
                            int has_scale, int want_scores, int kv_bf16,
                            int c_bf16, void* stream) {
  const int n_chunks = (n_keys + kChunk - 1) / kChunk;
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  const long long bh = (long long)b * n_head;
  const bool k_cache = strides[6] == 1, v_cache = strides[10] == 1;
  const bool split = n_chunks > 1;
  if (b <= 0 || n_head <= 0 || n_rows <= 0 || n_keys <= 0 || hd <= 0 ||
      hd % 8 != 0 || hd > 256 || kv_bf16 != c_bf16 || bh > 65535 ||
      n_chunks > 65535 || ((split || want_scores) && scores == nullptr) ||
      (split && (stats == nullptr || part == nullptr || tickets == nullptr)) ||
      (!k_cache && strides[5] != 1) || (!v_cache && strides[9] != 1))
    return cudaErrorInvalidValue;
  const int elem = c_bf16 ? 2 : 4;
  const Args a{q, k, v, static_cast<const float*>(mask), out,
               static_cast<float*>(scores), static_cast<float2*>(stats),
               static_cast<float*>(part), static_cast<int*>(tickets),
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               strides[10], n_head, n_rows, n_keys, hd, n_chunks, k_scale,
               has_scale, want_scores,
               piece_width(q, elem, strides[0], strides[1], strides[2]),
               piece_width(k, elem, strides[3], strides[4],
                          k_cache ? strides[5] : strides[6]),
               piece_width(v, elem, strides[7], strides[8],
                          v_cache ? strides[9] : strides[10])};
  const dim3 grid(n_tiles, n_chunks, (unsigned)bh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_bf16) {
    if (k_cache)
      return v_cache ? run_bf16<true, true>(a, grid, s)
                     : run_bf16<true, false>(a, grid, s);
    return v_cache ? run_bf16<false, true>(a, grid, s)
                   : run_bf16<false, false>(a, grid, s);
  }
  if (k_cache)
    return v_cache ? run_f32<true, true>(a, grid, s)
                   : run_f32<true, false>(a, grid, s);
  return v_cache ? run_f32<false, true>(a, grid, s)
                 : run_f32<false, false>(a, grid, s);
}
