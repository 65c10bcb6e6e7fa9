// A linear layer y = x W^T (+ b) whose every output's sum over K runs in
// one order fixed by (N, K) alone, never by the number of rows M: a row's
// result does not depend on the rows beside it.
//
// Replaces: no Pallas site. The JAX package computes the decoder's linears
//   and its tied lm head as XLA dots (whisper_char_alignment_tpu/models/
//   whisper.py:139, `_linear`'s jnp.dot); the port's plain versions are
//   `F.linear(x, W, b)` and, for the lm head, `F.linear(x.float(),
//   W.float())` (`models/whisper._linear`, `_logits`).
//
// Why a kernel: cuBLAS picks its kernel, its tiles and any split of K from
//   M, so a row computed in a decode step at B = 1 and at B = 16, or in a
//   5-row speculative window against a 1-row step, was summed in different
//   orders.
//
// The contract and the plan: K is cut into 64-deep chunks and the chunks
//   into n_seg segments of seg_chunks, chosen from (N, K) and the dtype only
//   (`ops/rows_linear_cuda.plan`: at most 8 segments, as many as put some
//   128 blocks of 64 columns on the card at few rows). Each segment is one
//   chain of k16 products from zero (wgmma's scale-d = 0 on its first k16),
//   in rising k; the segments' sums are added in rising order (the first
//   copied, the rest added), then the bias, then one rounding to the output
//   type. M decides only where that happens, never its order: a row's bits
//   are the same at any M, in any tile, in a graph or not.
//
// bf16: wgmma.mma_async m64nNk16 (bf16 in, f32 sums), both operands
//   K-major in shared memory with the 128-byte swizzle, fed by TMA
//   (cuTensorMapEncodeTiled through the runtime's driver entry point, the
//   maps as __grid_constant__ parameters; rows and columns past M, N and K
//   read as zeros and are never stored). The instruction probe
//   (wca_rows_linear_probe, a card test) feeds the same bf16 tiles with
//   exponents over 2^-20..2^20 and cancelling sums through mma.sync
//   m16n8k16, wgmma with x as A at N = 8, 64 and 128, and wgmma with the
//   weight as A at N = 8, 16, 32 and 64, chained over 2-8 k16 steps from
//   zero and from a carried sum. On an H100 every form gives the same bits
//   in every case: the tensor cores sum a k16 step alike whatever the
//   shape and the operands' roles. So the regimes take different forms:
//   - Few rows (rows_linear_narrow_kernel, one warpgroup, tiles of 64
//     columns by 8, 16, 32 or 64 rows): bound by the weight's bytes (2 MB
//     for 1024 x 1024 bf16: 0.63 us at 3.35 TB/s). The weight is A and x
//     is B (m64nNk16 with N the tile's rows), so the tensor cores and the
//     shared memory do the rows there are, not 64. A block issues the
//     copies of all its chunks at once (a ring of up to 8 stages when it
//     has more), so the whole weight is in flight together. Split (the
//     host's choice by M), the n_seg segments of one output tile are one
//     thread-block cluster: each block stores its segment's sums straight
//     into the shared memory of the block that folds their columns (16
//     bytes a store), then arrives on that block's mbarrier; each block
//     waits until its barrier has counted every rank, adds its columns'
//     sums in rising rank order, adds the bias, rounds once and stores. No
//     partials in device memory, no global fence, no ticket, no serial
//     chain of reads, and no block waits for the others to leave (none
//     reads another's shared memory). Not split (the lm head, whose 51865
//     columns fill the card at one segment), as few blocks as the card
//     holds at once each walk the same number of tiles, their ring running
//     on from one tile to the next, and add the segments in registers.
//   - Many rows (rows_linear_wide_kernel, 128-row tiles of 64 or 128
//     columns): bound by operations (2 M N K at 989 TFLOP/s). x is A, the
//     weight B. One producer thread keeps a 4-stage TMA ring full on
//     mbarriers; two consumer warpgroups (setmaxnreg) each take 64 rows,
//     and at each segment's end add the chain's sum to a running total in
//     registers, in segment order. The tile leaves through shared memory
//     in whole rows.
//
// f32: the CUDA cores, 64 x 64 tiles, 4 x 4 outputs a thread, each a chain
//   of fmaf in rising k over 16-deep chunks; split, each segment a block
//   whose partial sums are parked in device memory and added in order by the
//   last block of the tile (a ticket). On no bf16 path.
#include <cooperative_groups.h>
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;            // bf16 k a chunk: one 128-byte row
constexpr int kRowBytes = kChunk * 2;
constexpr int kNarrowBN = 64;
constexpr int kNarrowStages = 8;
constexpr int kMaxCluster = 8;
constexpr int kWideBM = 128;
constexpr int kWideStages = 4;
constexpr int kWideThreads = 384;     // two consumer warpgroups, a producer
constexpr int kF32BK = 16;            // f32 chunk depth
constexpr int kF32Threads = 256;

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on `bar` expecting `bytes` of copies to land on it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed; with
// kCluster, acquire at cluster scope (the phase's arrivals came from other
// blocks of the cluster, and their writes are seen). A wait that outlasts
// some seconds is a fault: it traps (a launch error) rather than hang the
// card.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
    if constexpr (kCluster)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(bar)), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(bar)), "r"(parity)
          : "memory");
  }
}

// Arrive, releasing this block's writes to the cluster, on the barrier at
// `bar`'s place in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// The box at (k0, row0) of a 2-D tensor map into shared memory, counted on
// `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k0, int row0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tensormap_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The cluster barrier in halves: arrive (relaxed: the barriers set before
// it are published by their init fence) and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A K-major operand in shared memory with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart, the tile 1024-byte aligned; a k16
// step within the row is +32 bytes on the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads across the wait.
template <int kN>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32, in the wgmma accumulator layout) = A (64 x 16) B^T (N x
// 16) + (scale_d ? d : 0), A and B from shared-memory descriptors.
__device__ __forceinline__ void wgmma_n8(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3},"
      " %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n16(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int kN>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b,
                                      int scale_d) {
  if constexpr (kN == 8)
    wgmma_n8(d, a, b, scale_d);
  else if constexpr (kN == 16)
    wgmma_n16(d, a, b, scale_d);
  else if constexpr (kN == 32)
    wgmma_n32(d, a, b, scale_d);
  else if constexpr (kN == 64)
    wgmma_n64(d, a, b, scale_d);
  else
    wgmma_n128(d, a, b, scale_d);
}

// Accumulator element r of a warpgroup's 64 x N tile: row 16 warp + g (+8
// for r % 4 >= 2), column 8 (r / 4) + 2t (+1 for odd r).
__device__ __forceinline__ int acc_row(int r, int warp, int g) {
  return warp * 16 + g + ((r & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int r, int t) {
  return (r >> 2) * 8 + 2 * t + (r & 1);
}

// The output element (m, n), in order: the sum of its segments (already
// added), the bias, one rounding.
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

// One chunk's four k16 steps into `acc`, the segment's chain started from
// zero at its first chunk.
template <int kN>
__device__ __forceinline__ void chunk_mma(float* acc, uint32_t a, uint32_t b,
                                          bool seg_start) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma<kN>(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32),
              (seg_start && kk == 0) ? 0 : 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<kN / 2>(acc);
}

// At a segment's end its chain joins the running total: copied for the
// first segment, added for the others.
template <int kR>
__device__ __forceinline__ void end_segment(float* tot, const float* acc,
                                            bool first) {
#pragma unroll
  for (int r = 0; r < kR; ++r) tot[r] = first ? acc[r] : tot[r] + acc[r];
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<uint8_t*>((a + 1023) & ~uintptr_t(1023));
}

// Where row m of a column sits in a fold slot of kNX rows: in order for 8
// rows; else each thread's four rows of a 16-row group (2t, 2t + 1, 2t + 8,
// 2t + 9 in the accumulator layout) side by side, for one 16-byte store.
template <int kNX>
__device__ __forceinline__ int slot_pos(int m) {
  if constexpr (kNX == 8) return m;
  const int w = m & 15;
  return (m & ~15) | (((w & 7) >> 1) << 2) | ((w >> 3) << 1) | (w & 1);
}

// ---------------------------------------------------------------------------
// bf16, few rows: one warpgroup, a tile of 64 columns by kNX rows, the
// weight as A and x as B (so the tensor cores do kNX rows' work, not 64);
// split, one segment a block and the tile's segments one cluster, else a
// block walks every segment of tiles blockIdx.x, + gridDim.x, ...
// ---------------------------------------------------------------------------

template <int kNX, typename TO>
__global__ void __launch_bounds__(128)
    rows_linear_narrow_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap,
                              const __nv_bfloat16* __restrict__ bias,
                              TO* __restrict__ out, int n_rows, int n_cols,
                              int n_chunks, int seg_chunks, int n_stages,
                              int slot_off, int main_bytes) {
  constexpr int kStage = (kNarrowBN + kNX) * kRowBytes;
  constexpr int kR = kNX / 2;  // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + main_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kNX;
  const bool split = gridDim.z > 1;
  const int n_tiles = (n_cols + kNarrowBN - 1) / kNarrowBN;
  // the block's work: (tile, chunk) pairs, tile by tile
  const int c_begin = split ? blockIdx.z * seg_chunks : 0;
  const int per_tile =
      split ? min(n_chunks, c_begin + seg_chunks) - c_begin : n_chunks;
  const int my_tiles =
      split ? 1 : (n_tiles - (int)blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_iter = per_tile * my_tiles;
  auto tile_n0 = [&](int j) {
    return (blockIdx.x + (split ? 0 : j * gridDim.x)) * kNarrowBN;
  };

  const CUtensorMap* xm = &xmap;
  const CUtensorMap* wm = &wmap;
  uint64_t* folded = full + n_stages;  // split: every rank's sums are here
  if (tid == 0) {
    tensormap_prefetch(wm);
    tensormap_prefetch(xm);
    for (int s = 0; s < n_stages; ++s) mbar_init(full + s, 1);
    if (split) mbar_init(folded, gridDim.z);
    mbar_init_fence();
  }
  __syncthreads();
  // split: the bias of the tile's columns, read while the weight is on its
  // way (the last kNarrowBN floats before the barriers)
  float* bias_s = reinterpret_cast<float*>(sm + main_bytes) - kNarrowBN;
  if (split) {
    cluster_arrive_relaxed();  // this rank's barriers are set
    const int n = tile_n0(0) + tid;
    if (bias != nullptr && tid < kNarrowBN && n < n_cols)
      bias_s[tid] = __bfloat162float(bias[n]);
  }
  auto issue = [&](int i) {  // item i into stage i % n_stages
    const int s = i % n_stages, k0 = (c_begin + i % per_tile) * kChunk;
    uint8_t* st = sm + s * kStage;
    mbar_expect(full + s, kStage);
    tma_load(st, wm, k0, tile_n0(i / per_tile), full + s);
    tma_load(st + kNarrowBN * kRowBytes, xm, k0, m0, full + s);
  };
  if (tid == 0)
    for (int i = 0; i < min(n_iter, n_stages); ++i) issue(i);

  float acc[kR], tot[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = tot[r] = 0.f;
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % n_stages, c = c_begin + i % per_tile;
    mbar_wait(full + s, (i / n_stages) & 1);
    const uint32_t w_tile = smem_addr(sm + s * kStage);
    chunk_mma<kNX>(acc, w_tile, w_tile + kNarrowBN * kRowBytes,
                   c % seg_chunks == 0);
    if ((c + 1) % seg_chunks == 0 || c + 1 == n_chunks)
      end_segment<kR>(tot, acc, split || c < seg_chunks);
    if (i + n_stages < n_iter) {  // the ring turns: every warp is done with
      __syncthreads();            // stage s before it is loaded again
      if (tid == 0) issue(i + n_stages);
    }
    if (!split && c + 1 == n_chunks) {  // a tile's last chunk: its outputs
      const int n0 = tile_n0(i / per_tile);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int n = n0 + acc_row(r, warp, g), m = m0 + acc_col(r, t);
        if (m < n_rows && n < n_cols)
          store_out(out, bias, m, n, n_cols, tot[r]);
      }
    }
  }
  if (!split) return;

  // push each sum to the rank that owns its column (cols_per columns a
  // rank), into this segment's slot there, [z][column][row]; each rank's
  // barrier `folded` counts the ranks whose sums have landed; then each
  // rank adds its columns' slots in rank order, adds the bias, rounds once
  // and stores. No rank reads another's shared memory, so none waits for
  // the others to leave.
  const int n_seg = gridDim.z, rank = blockIdx.z, n0 = tile_n0(0);
  const int cols_per = (kNarrowBN + n_seg - 1) / n_seg;
  const int rows_here = min(kNX, n_rows - m0);
  float* slots = reinterpret_cast<float*>(sm + slot_off);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();  // every rank's barriers are set
  if constexpr (kNX == 8) {  // rows 2t, 2t + 1 of a column: 8 bytes
#pragma unroll
    for (int r = 0; r < kR; r += 2) {
      const int row = acc_col(r, t), col = acc_row(r, warp, g);
      if (row < rows_here) {
        const int owner = col / cols_per;
        float* dst = cluster.map_shared_rank(slots, owner) +
                     (rank * cols_per + col - owner * cols_per) * kNX + row;
        *reinterpret_cast<float2*>(dst) = make_float2(tot[r], tot[r + 1]);
      }
    }
  } else {  // rows 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-row group: 16 bytes
#pragma unroll
    for (int q = 0; q < kR / 4; ++q) {
      const int r = (q >> 1) * 8 + (q & 1) * 2;
      const int row = acc_col(r, t), col = acc_row(r, warp, g);
      if (row < rows_here) {
        const int owner = col / cols_per;
        float* dst = cluster.map_shared_rank(slots, owner) +
                     (rank * cols_per + col - owner * cols_per) * kNX +
                     slot_pos<kNX>(row);
        *reinterpret_cast<float4*>(dst) =
            make_float4(tot[r], tot[r + 1], tot[r + 4], tot[r + 5]);
      }
    }
  }
  __syncthreads();  // the block's sums are written: one arrival a rank
  if (tid < n_seg) mbar_arrive_remote(folded, tid);
  mbar_wait<true>(folded, 0);
  const int c_lo = rank * cols_per;
  const int c_n = min(kNarrowBN, c_lo + cols_per) - c_lo;
  for (int e = tid; e < rows_here * c_n; e += 128) {
    const int row = e / c_n, c = e % c_n, n = n0 + c_lo + c;
    const int pos = slot_pos<kNX>(row);
    float sum = slots[c * kNX + pos];
    for (int z = 1; z < n_seg; ++z) sum += slots[(z * cols_per + c) * kNX + pos];
    if (n < n_cols)
      store_out(out, static_cast<const __nv_bfloat16*>(nullptr), m0 + row, n,
                n_cols, bias != nullptr ? sum + bias_s[c_lo + c] : sum);
  }
}

// A staged output row of kBN columns in shared memory, padded so that the
// accumulator layout's writes fall in distinct banks, in elements.
template <int kBN, typename TO>
__host__ __device__ constexpr int staged_ld() {
  return kBN + (sizeof(TO) == 2 ? 8 : 4);
}

// A warpgroup's 64 x kBN outputs (tot, the accumulator layout) at rows
// m0.., columns n0..: each plus its bias and rounded once into `st`, then
// stored in whole rows (16-byte pieces where every row start allows).
// Named barrier `bar` holds the warpgroup's 128 threads.
template <int kBN, typename TO>
__device__ __forceinline__ void store_tile(const float* tot, TO* st,
                                           const __nv_bfloat16* bias,
                                           TO* out, int m0, int n0,
                                           int n_rows, int n_cols, int bar) {
  constexpr int kLd = staged_ld<kBN, TO>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < kBN / 2; r += 2) {
    const int row = acc_row(r, warp, g), col = acc_col(r, t), n = n0 + col;
    float y0 = tot[r], y1 = tot[r + 1];
    if (bias != nullptr) {
      if (n < n_cols) y0 += __bfloat162float(bias[n]);
      if (n + 1 < n_cols) y1 += __bfloat162float(bias[n + 1]);
    }
    if constexpr (sizeof(TO) == 2)
      *reinterpret_cast<__nv_bfloat162*>(st + row * kLd + col) =
          __floats2bfloat162_rn(y0, y1);
    else
      *reinterpret_cast<float2*>(st + row * kLd + col) = make_float2(y0, y1);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
  constexpr int kVec = 16 / sizeof(TO);
  if (n_cols % kVec == 0) {
    constexpr int kPerRow = kBN / kVec;
    for (int v = tid; v < 64 * kPerRow; v += 128) {
      const int row = v / kPerRow, col = (v % kPerRow) * kVec;
      const int m = m0 + row, n = n0 + col;
      if (m < n_rows && n < n_cols)
        *reinterpret_cast<uint4*>(out + (long long)m * n_cols + n) =
            *reinterpret_cast<const uint4*>(st + row * kLd + col);
    }
  } else {
    for (int e = tid; e < 64 * kBN; e += 128) {
      const int row = e / kBN, col = e % kBN;
      const int m = m0 + row, n = n0 + col;
      if (m < n_rows && n < n_cols)
        out[(long long)m * n_cols + n] = st[row * kLd + col];
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");  // st is free
}

// ---------------------------------------------------------------------------
// bf16, many rows: 128 x kBN tiles, a producer warp and two consumer
// warpgroups over a TMA ring
// ---------------------------------------------------------------------------

template <int kBN, typename TO>
__global__ void __launch_bounds__(kWideThreads, 1)
    rows_linear_wide_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const __nv_bfloat16* __restrict__ bias,
                            TO* __restrict__ out, int n_rows, int n_cols,
                            int n_chunks, int seg_chunks) {
  constexpr int kStage = (kWideBM + kBN) * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kWideStages * kStage);
  uint64_t* empty = full + kWideStages;
  const int tid = threadIdx.x, wg = tid >> 7;
  // tiles blockIdx.x, + gridDim.x, ...: columns fastest, so the blocks at
  // work share x's rows and the weight in L2
  const int tiles_n = (n_cols + kBN - 1) / kBN;
  const int n_tiles = tiles_n * ((n_rows + kWideBM - 1) / kWideBM);

  if (tid == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrival a consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy, its ring
                  // running on from one tile into the next
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 2 * 128) {
      int q = 0;  // chunks issued
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * kBN;
        const int m0 = (tile / tiles_n) * kWideBM;
        for (int c = 0; c < n_chunks; ++c, ++q) {
          const int s = q % kWideStages;
          if (q >= kWideStages)
            mbar_wait(empty + s, ((q / kWideStages) - 1) & 1);
          uint8_t* st = sm + s * kStage;
          mbar_expect(full + s, kStage);
          tma_load(st, &xmap, c * kChunk, m0, full + s);
          tma_load(st + kWideBM * kRowBytes, &wmap, c * kChunk, n0, full + s);
        }
      }
    }
  } else {  // a consumer: rows 64 wg .. 64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    TO* st = reinterpret_cast<TO*>(sm + kWideStages * kStage + 1024) +
             wg * 64 * staged_ld<kBN, TO>();
    float acc[kBN / 2], tot[kBN / 2];
#pragma unroll
    for (int r = 0; r < kBN / 2; ++r) acc[r] = tot[r] = 0.f;
    int q = 0;  // chunks taken
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int c = 0; c < n_chunks; ++c, ++q) {
        const int s = q % kWideStages;
        mbar_wait(full + s, (q / kWideStages) & 1);
        const uint32_t a = smem_addr(sm + s * kStage);
        chunk_mma<kBN>(acc, a + wg * 64 * kRowBytes, a + kWideBM * kRowBytes,
                       c % seg_chunks == 0);
        if ((tid & 127) == 0) mbar_arrive(empty + s);
        if ((c + 1) % seg_chunks == 0 || c + 1 == n_chunks)
          end_segment<kBN / 2>(tot, acc, c < seg_chunks);
      }
      store_tile<kBN>(tot, st, bias, out,
                      (tile / tiles_n) * kWideBM + wg * 64,
                      (tile % tiles_n) * kBN, n_rows, n_cols, 1 + wg);
    }
  }
}

// ---------------------------------------------------------------------------
// f32
// ---------------------------------------------------------------------------

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


// ---------------------------------------------------------------------------
// the instruction probe (a card test): the forms the kernels could mix, on
// the same tiles
// ---------------------------------------------------------------------------

// Element (r, k) of a K-major tile of `rows` rows in 64-deep panels with the
// 128-byte swizzle, as TMA lays it: byte offset from the tile.
__device__ __forceinline__ int sw128_offset(int r, int k, int rows) {
  const int p = k / kChunk, kc = k % kChunk;
  return p * rows * kRowBytes + r * kRowBytes +
         (((kc >> 3) ^ (r & 7)) << 4) + (kc & 7) * 2;
}

// x (64, K) and w (128, K) bf16 row-major, K = 16 steps (steps 1..8); c0
// (64, 128) f32 carried in, or null for chains from zero; out (8, 64, 128)
// f32: [0] mma.sync m16n8k16, [1..3] wgmma m64nNk16 with x as A at N = 8,
// 64 and 128, [4..7] wgmma with the weight as A (swap-AB) at N = 64, 8, 16
// and 32.
__global__ void __launch_bounds__(128)
    rows_linear_probe_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ c0,
                             float* __restrict__ out, int steps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = align1024(smem_raw);         // 2 panels of 64 rows: 16 KB
  uint8_t* ws = xs + 2 * 64 * kRowBytes;     // 2 panels of 128 rows: 32 KB
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, k_len = 16 * steps;
  for (int i = tid; i < 64 * 128; i += 128) {
    const int r = i / 128, k = i % 128;
    *reinterpret_cast<__nv_bfloat16*>(xs + sw128_offset(r, k, 64)) =
        k < k_len ? x[r * k_len + k] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < 128 * 128; i += 128) {
    const int r = i / 128, k = i % 128;
    *reinterpret_cast<__nv_bfloat16*>(ws + sw128_offset(r, k, 128)) =
        k < k_len ? w[r * k_len + k] : __float2bfloat16(0.f);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  auto c_in = [&](int m, int n) { return c0 ? c0[m * 128 + n] : 0.f; };
  auto put = [&](int form, int m, int n, float v) {
    out[(form * 64 + m) * 128 + n] = v;
  };

  // [0] mma.sync, fragments read from global memory
  for (int j = 0; j < 16; ++j) {
    const int r0 = warp * 16 + g, col = j * 8 + 2 * t;
    float c[4] = {c_in(r0, col), c_in(r0, col + 1), c_in(r0 + 8, col),
                  c_in(r0 + 8, col + 1)};
    for (int s = 0; s < steps; ++s) {
      const int k = 16 * s + 2 * t;
      auto pair = [&](const __nv_bfloat16* p) {
        return *reinterpret_cast<const uint32_t*>(p);
      };
      const uint32_t a[4] = {pair(x + r0 * k_len + k),
                             pair(x + (r0 + 8) * k_len + k),
                             pair(x + r0 * k_len + k + 8),
                             pair(x + (r0 + 8) * k_len + k + 8)};
      const uint32_t b[2] = {pair(w + (j * 8 + g) * k_len + k),
                             pair(w + (j * 8 + g) * k_len + k + 8)};
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
    }
    put(0, r0, col, c[0]);
    put(0, r0, col + 1, c[1]);
    put(0, r0 + 8, col, c[2]);
    put(0, r0 + 8, col + 1, c[3]);
  }

  // [1..3] x as A, the weight's rows nb N .. nb N + N - 1 as B
  auto x_as_a = [&](auto n_tag, int form) {
    constexpr int kN = decltype(n_tag)::value;
    for (int nb = 0; nb < 128 / kN; ++nb) {
      float d[kN / 2];
#pragma unroll
      for (int r = 0; r < kN / 2; ++r)
        d[r] = c_in(acc_row(r, warp, g), nb * kN + acc_col(r, t));
      wgmma_fence();
      for (int s = 0; s < steps; ++s) {
        const uint32_t a = smem_addr(xs) + (s / 4) * 64 * kRowBytes +
                           (s % 4) * 32;
        const uint32_t b = smem_addr(ws) + (s / 4) * 128 * kRowBytes +
                           nb * kN * kRowBytes + (s % 4) * 32;
        wgmma<kN>(d, sw128_desc(a), sw128_desc(b), (s == 0 && !c0) ? 0 : 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kN / 2>(d);
#pragma unroll
      for (int r = 0; r < kN / 2; ++r)
        put(form, acc_row(r, warp, g), nb * kN + acc_col(r, t), d[r]);
    }
  };
  x_as_a(std::integral_constant<int, 8>(), 1);
  x_as_a(std::integral_constant<int, 64>(), 2);
  x_as_a(std::integral_constant<int, 128>(), 3);

  // [4..7] swap-AB: the weight's rows nb 64 .. nb 64 + 63 as A, x as B in
  // groups of N rows; the accumulator is the transposed tile
  auto w_as_a = [&](auto n_tag, int form) {
    constexpr int kN = decltype(n_tag)::value;
    for (int nb = 0; nb < 2; ++nb)
      for (int mb = 0; mb < 64 / kN; ++mb) {
        float d[kN / 2];
#pragma unroll
        for (int r = 0; r < kN / 2; ++r)
          d[r] = c_in(mb * kN + acc_col(r, t), nb * 64 + acc_row(r, warp, g));
        wgmma_fence();
        for (int s = 0; s < steps; ++s) {
          const uint32_t a = smem_addr(ws) + (s / 4) * 128 * kRowBytes +
                             nb * 64 * kRowBytes + (s % 4) * 32;
          const uint32_t b = smem_addr(xs) + (s / 4) * 64 * kRowBytes +
                             mb * kN * kRowBytes + (s % 4) * 32;
          wgmma<kN>(d, sw128_desc(a), sw128_desc(b),
                    (s == 0 && !c0) ? 0 : 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<kN / 2>(d);
#pragma unroll
        for (int r = 0; r < kN / 2; ++r)
          put(form, mb * kN + acc_col(r, t), nb * 64 + acc_row(r, warp, g),
              d[r]);
      }
  };
  w_as_a(std::integral_constant<int, 64>(), 4);
  w_as_a(std::integral_constant<int, 8>(), 5);
  w_as_a(std::integral_constant<int, 16>(), 6);
  w_as_a(std::integral_constant<int, 32>(), 7);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// libcuda); null where the driver lacks it.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (rows, k) bf16 row-major tensor read in boxes of box_rows x 64, with the
// 128-byte swizzle; out of range reads as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int k,
                     int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(base), dims, strides, box,
                         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The regimes, chosen by the caller from M (`ops/rows_linear_cuda.route`).
enum Mode { kWalk = 0, kSplit = 1, kWide64 = 2, kWide128 = 3 };

// Blocks of `kernel` an SM holds with `smem` bytes each, times the SMs.
template <auto kKernel>
int resident_blocks(int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <int kNX, typename TO>
cudaError_t launch_narrow(const void* x, const void* w, const void* bias,
                          void* out, int m, int n, int k, int seg_chunks,
                          int n_seg, bool split, cudaStream_t stream) {
  constexpr int kStage = (kNarrowBN + kNX) * kRowBytes;
  constexpr auto kKernel = rows_linear_narrow_kernel<kNX, TO>;
  const int n_chunks = (k + kChunk - 1) / kChunk;
  const int n_tiles = (n + kNarrowBN - 1) / kNarrowBN;
  if (split && n_seg > kMaxCluster) return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  cudaError_t err = make_map(&xmap, x, m, k, kNX);
  if (err != cudaSuccess) return err;
  err = make_map(&wmap, w, n, k, kNarrowBN);
  if (err != cudaSuccess) return err;
  const int per_block = split ? seg_chunks : n_chunks;
  const int n_stages = per_block < kNarrowStages ? per_block : kNarrowStages;
  // the ring, then (split) a slot of kNX rows by the columns a rank folds
  // for each segment and the tile's bias, then the barriers
  const int slot_off = n_stages * kStage;
  const int main_bytes =
      slot_off + (split ? n_seg * kNX * ((kNarrowBN + n_seg - 1) / n_seg) * 4 +
                              kNarrowBN * 4
                        : 0);
  const size_t smem = 1024 + main_bytes + (n_stages + 1) * 8;
  err = wca::allow_smem<kKernel>(smem);
  if (err != cudaSuccess) return err;
  // not split: as few blocks as hold every tile with the same number of
  // tiles each, within what the card holds at once
  int grid_x = n_tiles;
  if (!split) {
    const int slots = resident_blocks<kKernel>(128, smem);
    if (slots <= 0) return cudaErrorInvalidConfiguration;
    const int per = (n_tiles + slots - 1) / slots;
    grid_x = (n_tiles + per - 1) / per;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split ? n_seg : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, (m + kNX - 1) / kNX, split ? n_seg : 1);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kKernel, xmap, wmap,
                            static_cast<const __nv_bfloat16*>(bias),
                            static_cast<TO*>(out), m, n, n_chunks, seg_chunks,
                            n_stages, slot_off, main_bytes);
}

template <int kBN, typename TO>
cudaError_t launch_wide(const void* x, const void* w, const void* bias,
                        void* out, int m, int n, int k, int seg_chunks,
                        cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  cudaError_t err = make_map(&xmap, x, m, k, kWideBM);
  if (err != cudaSuccess) return err;
  err = make_map(&wmap, w, n, k, kBN);
  if (err != cudaSuccess) return err;
  // the ring, its barriers (in 1 KB), the staged output tile
  const size_t smem = 1024 + kWideStages * (kWideBM + kBN) * kRowBytes +
                      1024 + kWideBM * staged_ld<kBN, TO>() * sizeof(TO);
  constexpr auto kKernel = rows_linear_wide_kernel<kBN, TO>;
  err = wca::allow_smem<kKernel>(smem);
  if (err != cudaSuccess) return err;
  // a block an SM at most, walking its tiles
  const int n_tiles = (n + kBN - 1) / kBN * ((m + kWideBM - 1) / kWideBM);
  const int slots = resident_blocks<kKernel>(kWideThreads, smem);
  if (slots <= 0) return cudaErrorInvalidConfiguration;
  const dim3 grid(n_tiles < slots ? n_tiles : slots);
  rows_linear_wide_kernel<kBN, TO><<<grid, kWideThreads, smem, stream>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(bias),
      static_cast<TO*>(out), m, n, (k + kChunk - 1) / kChunk, seg_chunks);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch_bf16(const void* x, const void* w, const void* bias,
                          void* out, int m, int n, int k, int seg_chunks,
                          int n_seg, int mode, cudaStream_t stream) {
  switch (mode) {
    case kWalk:
    case kSplit: {
      // x's rows in a tile: the fewest of 8, 16, 32, 64 that hold M
      const bool sp = mode == kSplit;
      if (m <= 8)
        return launch_narrow<8, TO>(x, w, bias, out, m, n, k, seg_chunks,
                                    n_seg, sp, stream);
      if (m <= 16)
        return launch_narrow<16, TO>(x, w, bias, out, m, n, k, seg_chunks,
                                     n_seg, sp, stream);
      if (m <= 32)
        return launch_narrow<32, TO>(x, w, bias, out, m, n, k, seg_chunks,
                                     n_seg, sp, stream);
      return launch_narrow<64, TO>(x, w, bias, out, m, n, k, seg_chunks,
                                   n_seg, sp, stream);
    }
    case kWide64:
      return launch_wide<64, TO>(x, w, bias, out, m, n, k, seg_chunks,
                                 stream);
    case kWide128:
      return launch_wide<128, TO>(x, w, bias, out, m, n, k, seg_chunks,
                                  stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) and w (N, K) row-major, 16-byte aligned; bias (N,) in x's type or
// null; out (M, N) in x's type or, for bf16 x with out_f32, f32. The plan
// (seg_chunks chunks of 64 (bf16) or 16 (f32) k a segment, n_seg segments)
// comes from (N, K) alone (`ops/rows_linear_cuda.plan`); `mode`, the
// caller's choice by M, does not change the result. bf16 (K % 8 == 0):
// 0 the narrow kernel, each block walking every segment; 1 the narrow
// kernel, a segment a block, a cluster a tile (n_seg <= 8); 2, 3 the wide
// kernel with tiles of 64 or 128 columns; `part` and `tickets` unused.
// f32 (K % 4 == 0): 0 one block walks every segment; 1 one block a segment,
// partials in `part` (n_seg, M, N) f32, tickets zeroed ints, one per
// 64 x 64 output tile.
WCA_EXPORT int wca_rows_linear(const void* x, const void* w, const void* bias,
                               void* out, void* part, void* tickets, int m,
                               int n, int k, int seg_chunks, int n_seg,
                               int mode, int is_bf16, int out_f32,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || seg_chunks <= 0 || n_seg <= 0 ||
      k % (is_bf16 ? 8 : 4) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const bool split = mode == 1;
    if (!out_f32 || mode < 0 || mode > 1 ||
        (split && (part == nullptr || tickets == nullptr)))
      return cudaErrorInvalidValue;
    dim3 grid((n + 63) / 64, (m + 63) / 64, split ? n_seg : 1);
    rows_linear_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out),
        static_cast<float*>(part), static_cast<int*>(tickets), m, n, k,
        seg_chunks, n_seg);
    return cudaGetLastError();
  }
  if (out_f32)
    return dispatch_bf16<float>(x, w, bias, out, m, n, k, seg_chunks, n_seg,
                                mode, s);
  return dispatch_bf16<__nv_bfloat16>(x, w, bias, out, m, n, k, seg_chunks,
                                      n_seg, mode, s);
}

// The instruction probe (see rows_linear_probe_kernel): one block.
WCA_EXPORT int wca_rows_linear_probe(const void* x, const void* w,
                                     const void* c0, void* out, int steps,
                                     void* stream) {
  if (steps < 1 || steps > 8) return cudaErrorInvalidValue;
  const size_t smem = 1024 + (2 * 64 + 2 * 128) * kRowBytes;
  cudaError_t err = wca::allow_smem<rows_linear_probe_kernel>(smem);
  if (err != cudaSuccess) return err;
  rows_linear_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(
                                               stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(c0),
      static_cast<float*>(out), steps);
  return cudaGetLastError();
}
