// elle_bitmm: one squaring of Elle's packed closure as a Boolean matrix
// product on Hopper's tensor cores (sm_90a), for elle_packed.cu
// (elle_packed_square) and elle_sharded.cu (elle_sharded_square).
//
// The product. Bit j of word j/32 in row i of a (S, n, W = n/32) uint32
// plane is R[s,i,j]. A squaring is
//   out[s,i,c] = OR_j A[s,i,j] & B[s,j,c],
// with A = B = R for the packed closure, and for the sharded closure A
// the gathered reach and B one shard's column block (S, n, w_loc). As a
// count, C[i,c] = popc(A row i AND column c of B), and out = (C > 0):
// wgmma's 1-bit form (m64nNk256 .b1, AND then popcount, s32 sums) takes
// both operands K-major, so column c of B has to lie in memory as a row.
// Three operations on the caller's stream make a squaring:
//
//   1. flag_kernel: one byte per 128-row x 1024-bit tile of A, set when
//      the tile holds a bit (for the packed squaring, A = B, the
//      transpose sets them instead, over a zeroed plane);
//   2. transpose_kernel: T = B^T, (S, 32 w, W) words, row c of T the bits
//      of column c of B, and one byte per 256-row x 1024-bit tile of T.
//      A block takes 1024 rows x 8 words of B through shared memory (one
//      tile of T); a warp turns each 32 x 32 bit block around with five
//      shuffle stages, and each lane then holds 32 consecutive words of
//      one T row, stored as 128 bytes, unless the tile has no bit (then
//      nothing is stored: no stage loads it);
//   3. product_kernel: persistent, one CTA per SM over the S x n/128 x
//      ceil(32 w / 256) output tiles of 128 x 256 bits (subset-major,
//      eight row panels column by column so a wave's panels share L2).
//      A producer warpgroup keeps TMA loads in flight into a ring of
//      four 48 KB stages (A: two 64-row boxes, B: up to four; a box is
//      64 rows x 32 words, 128-byte swizzle; box parts outside a
//      subset's plane arrive as zeros); two consumer warpgroups each
//      run four m64n256k256 AND/popc wgmma a stage on 64 rows. A k
//      stage whose A tile or T tile has no bit is neither loaded nor
//      multiplied (both sides read the same flags, 32 stages to a ballot
//      mask): the early squarings are sparse, and a tile with no stage
//      left stores its zero words straight away. The epilogue of the
//      others thresholds each count (> 0), packs 32 columns into a word
//      with two quad shuffles, stores the words inside the output's
//      columns and adds their popcounts to counts[s] with one atomic
//      per warp per subset.
//
// What bounds it. A dense squaring at n_pad 16384 (S = 3) is S n^3 =
// 1.3e13 bit AND/popc steps, 2.6e16 operations; at the 1-bit peak
// (eight times int8's 1,979 TOP/s on an H100, occupancy.py's PEAKS)
// that is ~1.7 ms, against 0.06 ms of bytes. So the tensor cores
// bound it; sparse squarings skip tiles and fall toward
// the flag and transpose passes (a read of the plane or two, the
// transpose's flagged tiles written) and the output's write.
//
// Scratch comes from the caller: T (S, 32 w, W) uint32, the A flags
// (S, n/128, ceil(W/32)) and the T flags (S, ceil(32 w/256),
// ceil(W/32)) bytes (elle/tpu.py::bitmm_scratch). counts must be zero
// on entry; the kernel adds.

#pragma once

#include <cstdint>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                 // output tile rows
constexpr int kBN = 256;                 // output tile columns (T rows)
constexpr int kKW = 32;                  // k words a stage (1024 bits)
constexpr int kBoxRows = 64;             // TMA box: 32 words (128 B) x 64 rows
constexpr uint32_t kBoxBytes = kBoxRows * kKW * 4;          // 8 KB
constexpr int kBBoxes = kBN / kBoxRows;                     // B boxes a stage
constexpr uint32_t kStageBytes = (2 + kBBoxes) * kBoxBytes;  // 48 KB
constexpr int kStages = 4;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + 1024-B alignment
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kGroup = 8;                // row panels walked together
constexpr int kTRows = kKW * 32;         // transpose block: B rows (1024)
constexpr int kTWords = kBN / 32;        // transpose block: B words (8)
constexpr unsigned kFull = 0xffffffffu;

// -- flags and transpose ------------------------------------------------------

// grid (ceil(W/32), n/128, S), block 256: fa[s, i/128, w/32] = 1 when
// the 128-row x 32-word tile of a holds a bit, else 0
__global__ void __launch_bounds__(256)
flag_kernel(const uint32_t* __restrict__ a, uint8_t* __restrict__ fa, int n) {
  const int W = n >> 5;
  const int kc = blockIdx.x, rt = blockIdx.y, s = blockIdx.z;
  const int w = kc * kKW + (threadIdx.x & 31);
  uint32_t any = 0;
  if (w < W) {
    const uint32_t* p =
        a + (static_cast<size_t>(s) * n + rt * kBM + (threadIdx.x >> 5)) * W + w;
#pragma unroll
    for (int q = 0; q < kBM / 8; ++q) any |= p[static_cast<size_t>(q) * 8 * W];
  }
  const int nz = __syncthreads_or(any != 0u);
  if (threadIdx.x == 0)
    fa[(static_cast<size_t>(s) * gridDim.y + rt) * gridDim.x + kc] = nz ? 1 : 0;
}

// lane l holds row l of a 32 x 32 bit matrix (bit b = column b); after
// the five stages lane k holds column k (bit l = row l's bit k). Stage
// j swaps the off-diagonal j x j blocks between lanes l and l ^ j.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int j = 16 >> i;
    const uint32_t m = masks[i];
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? ((x & ~m) | ((y & ~m) >> j))
                   : ((x & m) | ((y & m) << j));
  }
  return x;
}

// grid (ceil(w/8), ceil(W/32), S), block 256: T[s, c, v] bit b =
// B[s, 32 v + b, c] (B (S, n, w) words, T (S, 32 w, W)); fb[s, c/256,
// v/32] = 1 when the block's 256 x 32-word tile of T holds a bit. A
// tile without a bit is not written: the product never loads it. When
// B is also A (w = W), fa is not null and zero on entry: each warp sets
// fa[s, i/128, v/32] for its 128 rows of the block when they hold a
// bit, so the packed squaring needs no flag pass.
__global__ void __launch_bounds__(256)
transpose_kernel(const uint32_t* __restrict__ b, uint32_t* __restrict__ t,
                 uint8_t* __restrict__ fb, uint8_t* __restrict__ fa, int n,
                 int w) {
  const int W = n >> 5;
  const int cg = blockIdx.x, kc = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ uint32_t in[kTRows][kTWords + 1];
  {
    const int c = tid & (kTWords - 1);
    const int col = cg * kTWords + c;
    const uint32_t* src = b + static_cast<size_t>(s) * n * w;
    for (int r = tid / kTWords; r < kTRows; r += 256 / kTWords) {
      const int j = kc * kTRows + r;
      in[r][c] = (j < n && col < w) ? src[static_cast<size_t>(j) * w + col]
                                    : 0u;
    }
  }
  __syncthreads();
  if (fa != nullptr) {
    // warp r: rows 128 r .. 128 r + 127 of the block, its 8 words
    uint32_t v = 0;
    for (int i = lane; i < kBM * kTWords; i += 32)
      v |= in[warp * kBM + i / kTWords][i % kTWords];
    const int rt = kc * (kTRows / kBM) + warp;
    if (__any_sync(kFull, v != 0u) && lane == 0 && rt < n / kBM)
      fa[(static_cast<size_t>(s) * (n / kBM) + rt) * gridDim.y +
         cg / (kKW / kTWords)] = 1;
  }
  const int col = cg * kTWords + warp;  // this warp's word column of B
  uint32_t o[32];
  uint32_t any = 0;
#pragma unroll
  for (int jb = 0; jb < 32; ++jb) {
    o[jb] = transpose32(in[jb * 32 + lane][warp], lane);
    any |= o[jb];
  }
  const int nonzero = __syncthreads_or(any != 0u);
  if (tid == 0)
    fb[(static_cast<size_t>(s) * gridDim.x + cg) * gridDim.y + kc] =
        nonzero ? 1 : 0;
  if (nonzero && col < w) {
    // lane k: T row 32 col + k, words kc*32 .. kc*32 + 31 (those < W; W
    // is a multiple of 4, so whole 16-byte groups)
    uint32_t* trow = t + (static_cast<size_t>(s) * 32 * w + 32 * col + lane) * W +
                     kc * kKW;
    const int nw = min(kKW, W - kc * kKW);
#pragma unroll
    for (int q = 0; q < kKW / 4; ++q)
      if (4 * q < nw)
        reinterpret_cast<uint4*>(trow)[q] =
            make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  }
}

// -- the product ----------------------------------------------------------------

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary
__device__ __forceinline__ void fence_acc(uint32_t (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define BITMM_R8(i)                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),             \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define BITMM_OPERANDS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "     \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "     \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "     \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "    \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "    \
  "%127}, %128, %129, p;\n}\n"
#define BITMM_ACC                                                         \
  BITMM_R8(0), BITMM_R8(8), BITMM_R8(16), BITMM_R8(24), BITMM_R8(32),     \
      BITMM_R8(40), BITMM_R8(48), BITMM_R8(56), BITMM_R8(64),             \
      BITMM_R8(72), BITMM_R8(80), BITMM_R8(88), BITMM_R8(96),             \
      BITMM_R8(104), BITMM_R8(112), BITMM_R8(120)

// d (64 x 256, s32) += popc(A (64 x 256 bits) AND B (256 x 256 bits)),
// both K-major in shared memory
__device__ __forceinline__ void wgmma_b1(uint32_t (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc "
      BITMM_OPERANDS
      : BITMM_ACC
      : "l"(a), "l"(b), "r"(1));
}

// tile `tile` of the S x Tm x Tn walk: its subset and top-left corner;
// within a subset, kGroup row panels at a time, column by column
__device__ __forceinline__ void tile_coords(int tile, int Tm, int Tn, int& s,
                                            int& row0, int& col0) {
  const int per = Tm * Tn;
  s = tile / per;
  const int u = tile - s * per;
  const int span = kGroup * Tn;
  const int grp = u / span;
  const int first = grp * kGroup;
  const int rows = min(Tm - first, kGroup);
  const int v = u - grp * span;
  row0 = (first + v % rows) * kBM;
  col0 = (v / rows) * kBN;
}

// a warp's ones of subset s into counts[s]
__device__ __forceinline__ void flush_ones(int* counts, int s,
                                           uint32_t ones, int lane) {
#pragma unroll
  for (int off = 16; off; off >>= 1) ones += __shfl_xor_sync(kFull, ones, off);
  if (lane == 0 && ones) atomicAdd(&counts[s], static_cast<int>(ones));
}

// A tile's rows of the flag planes: fa's for its 128 A rows, fb's for
// its 256 T rows, one byte a k stage.
struct TileFlags {
  const uint8_t *a, *b;
};

__device__ __forceinline__ TileFlags tile_flags(const uint8_t* fa,
                                                const uint8_t* fb, int tile,
                                                int Tm, int Tn, int KC) {
  int s, row0, col0;
  tile_coords(tile, Tm, Tn, s, row0, col0);
  return {fa + (static_cast<size_t>(s) * Tm + row0 / kBM) * KC,
          fb + (static_cast<size_t>(s) * Tn + col0 / kBN) * KC};
}

// One lane's two flags of stage k (0 past the last stage), loaded a tile
// ahead of their use for the first 32 stages, so that their latency
// hides behind the tile before.
struct StageFlags {
  uint32_t a, b;
};

__device__ __forceinline__ StageFlags stage_flags(TileFlags f, int k,
                                                  int KC) {
  return k < KC ? StageFlags{f.a[k], f.b[k]} : StageFlags{0u, 0u};
}

// The stages k0 .. k0 + 31 that both flags set, one bit a stage, from
// each lane's flags of stage k0 + lane. Warp-collective.
__device__ __forceinline__ uint32_t stage_mask(StageFlags g) {
  return __ballot_sync(kFull, (g.a & g.b) != 0u);
}

// grid: min(SMs, tiles) persistent CTAs; block kThreads; kSmem dynamic.
// A is (S, n, W) words, T (S, n_cols, W); out (S, n, n_cols / 32). The
// producer and the consumers walk the same stages of a tile, 32 at a
// time: the first 32 from flags fetched a tile ahead, any later ones
// (n > 32768) from flags loaded when their turn comes.
__global__ void __launch_bounds__(kThreads, 1)
product_kernel(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap tmap,
               const uint8_t* __restrict__ fa, const uint8_t* __restrict__ fb,
               uint32_t* __restrict__ out, int* __restrict__ counts, int n,
               int n_cols, int S) {
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int W = n >> 5, out_words = n_cols >> 5;
  const int Tm = n / kBM, Tn = (n_cols + kBN - 1) / kBN;
  const int KC = (W + kKW - 1) / kKW;
  const int n_tiles = S * Tm * Tn;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_u32(&full_bar[i]), 1);
      mbar_init(smem_u32(&empty_bar[i]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&amap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&tmap))
                 : "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0 reads each tile's stage mask, its lane 0
    // keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int stage = 0;
      uint32_t phase = 0;
      StageFlags next{0u, 0u};
      if (blockIdx.x < n_tiles)
        next = stage_flags(tile_flags(fa, fb, blockIdx.x, Tm, Tn, KC), lane,
                           KC);
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int s, row0, col0;
        tile_coords(tile, Tm, Tn, s, row0, col0);
        // T boxes that start inside the output's columns
        const int b_boxes =
            min(kBBoxes, (n_cols - col0 + kBoxRows - 1) / kBoxRows);
        const TileFlags f = tile_flags(fa, fb, tile, Tm, Tn, KC);
        uint32_t mask = stage_mask(next);
        if (tile + static_cast<int>(gridDim.x) < n_tiles)
          next = stage_flags(tile_flags(fa, fb, tile + gridDim.x, Tm, Tn, KC),
                             lane, KC);
        for (int k0 = 0; k0 < KC; k0 += 32) {
          if (k0) mask = stage_mask(stage_flags(f, k0 + lane, KC));
          if (lane == 0) {
            for (; mask; mask &= mask - 1) {
              const int kb = k0 + __ffs(mask) - 1;
              // the first pass over the ring finds every stage free
              mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
              const uint32_t bar = smem_u32(&full_bar[stage]);
              const uint32_t dst = ring + stage * kStageBytes;
              mbar_expect_tx(bar, (2 + b_boxes) * kBoxBytes);
              const int kw = kb * kKW;
              tma_load_3d(dst, &amap, kw, row0, s, bar);
              tma_load_3d(dst + kBoxBytes, &amap, kw, row0 + kBoxRows, s, bar);
              for (int j = 0; j < b_boxes; ++j)
                tma_load_3d(dst + (2 + j) * kBoxBytes, &tmap, kw,
                            col0 + j * kBoxRows, s, bar);
              if (++stage == kStages) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
          __syncwarp();
        }
      }
    }
  } else {
    // ---- consumers: rows c*64 .. c*64+63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int q4 = lane & 3;
    int stage = 0;
    uint32_t phase = 0;
    int cur_s = -1;
    uint32_t ones = 0;
    StageFlags next{0u, 0u};
    if (blockIdx.x < n_tiles)
      next = stage_flags(tile_flags(fa, fb, blockIdx.x, Tm, Tn, KC), lane,
                         KC);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int s, row0, col0;
      tile_coords(tile, Tm, Tn, s, row0, col0);
      if (s != cur_s) {
        if (cur_s >= 0) flush_ones(counts, cur_s, ones, lane);
        cur_s = s;
        ones = 0;
      }
      uint32_t* o = out + static_cast<size_t>(s) * n * out_words;
      const TileFlags f = tile_flags(fa, fb, tile, Tm, Tn, KC);
      uint32_t mask = stage_mask(next);
      if (tile + static_cast<int>(gridDim.x) < n_tiles)
        next = stage_flags(tile_flags(fa, fb, tile + gridDim.x, Tm, Tn, KC),
                           lane, KC);
      if (!mask && KC <= 32) {
        // no stage: the warpgroup's 64 rows of the tile are zero words,
        // stored row by row (the tile's words inside the output)
        const int nw = min(kBN / 32, out_words - col0 / 32);
        for (int e = threadIdx.x & 127; e < 64 * (kBN / 32); e += 128) {
          const int q = e % (kBN / 32);
          if (q < nw)
            o[static_cast<size_t>(row0 + c * 64 + e / (kBN / 32)) *
                  out_words + col0 / 32 + q] = 0u;
        }
        continue;
      }
      uint32_t d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0u;
      fence_acc(d);
      int prev = -1;
      for (int k0 = 0; k0 < KC; k0 += 32) {
        if (k0) mask = stage_mask(stage_flags(f, k0 + lane, KC));
        for (int left = __popc(mask); left; --left) {
          mbar_wait(smem_u32(&full_bar[stage]), phase);
          const uint32_t a = ring + stage * kStageBytes + c * kBoxBytes;
          const uint32_t b = ring + stage * kStageBytes + 2 * kBoxBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            // both K-major: 8-row groups 1024 B apart, each k256 step 32
            // B on inside the 128-byte swizzle row
            wgmma_b1(d, smem_desc(a + kk * 32, 16, 1024),
                     smem_desc(b + kk * 32, 16, 1024));
          wgmma_commit();
          wgmma_wait<1>();
          if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
          prev = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      // (past 32 stages a tile may find none: its epilogue stores zeros)
      if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));

      // epilogue: d[4b + 2h + e] is row r + 8h, column 8b + 2 q4 + e; the
      // word of columns 32q .. 32q+31 gathers blocks 4q .. 4q+3 over the
      // quad, and lane q4 stores words q4 and q4 + 4
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = row0 + c * 64 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int q = 0; q < kBN / 32; ++q) {
          uint32_t p = 0;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int blk = 4 * q + jj;
            p |= (d[4 * blk + 2 * h] != 0u ? 1u : 0u) << (8 * jj + 2 * q4);
            p |= (d[4 * blk + 2 * h + 1] != 0u ? 1u : 0u)
                 << (8 * jj + 2 * q4 + 1);
          }
          p |= __shfl_xor_sync(kFull, p, 1);
          p |= __shfl_xor_sync(kFull, p, 2);
          const int cw = col0 / 32 + q;
          if ((q & 3) == q4 && cw < out_words) {
            o[row * out_words + cw] = p;
            ones += __popc(p);
          }
        }
      }
    }
    if (cur_s >= 0) flush_ones(counts, cur_s, ones, lane);
  }
}

// -- host ---------------------------------------------------------------------------

constexpr int kMaps = 16;  // cached tensor maps
constexpr int kMaxDevices = 64;

struct MapEntry {
  const void* ptr;
  int words, rows, S;
  CUtensorMap map;
};

std::mutex g_lock;
MapEntry g_maps[kMaps];
int g_n_maps = 0, g_next_map = 0;
int g_sms[kMaxDevices];  // 0 until the device's first launch

// the tensor map of a (S, rows, words) uint32 plane in 64-row x 32-word
// boxes with 128-byte swizzle, encoded once per (pointer, shape)
int tensor_map(const void* p, int words, int rows, int S, CUtensorMap* out) {
  for (int i = 0; i < g_n_maps; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.ptr == p && e.words == words && e.rows == rows && e.S == S) {
      *out = e.map;
      return 0;
    }
  }
  EncodeTiled encode;
  const int rc = encoder(&encode);
  if (rc) return rc;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(words),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(S)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(words) * 4,
                                 static_cast<cuuint64_t>(rows) * words * 4};
  const cuuint32_t box[3] = {kKW, kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  MapEntry& e = g_n_maps < kMaps ? g_maps[g_n_maps++]
                                 : g_maps[g_next_map++ % kMaps];
  e.ptr = nullptr;
  const CUresult cr = encode(
      &e.map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return kEncodeError + static_cast<int>(cr);
  e.ptr = p;
  e.words = words;
  e.rows = rows;
  e.S = S;
  *out = e.map;
  return 0;
}

// the current device's SM count, the products' shared-memory limit set
// on its first use
int device_sms(int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_sms[dev]) {
    e = cudaFuncSetAttribute(product_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int count = 0;
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_sms[dev] = count;
  }
  *sms = g_sms[dev];
  return 0;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

// One squaring: out (S, n, w) = A (S, n, n/32) times B (S, n, w) over
// the Boolean semiring, each subset's popcount added to counts; t, fa
// and fb are the scratch of the header comment. Returns a cudaError_t
// or an encoder code (error_text).
int bitmm_square(const uint32_t* a, const uint32_t* b, uint32_t* out,
                 int* counts, uint32_t* t, uint8_t* fa, uint8_t* fb, int S,
                 int n, int w, cudaStream_t stream) {
  const int W = n / 32;
  if (S < 1 || n < kBM || n % kBM || w < 1 || w > W ||
      (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(t) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int KC = (W + kKW - 1) / kKW, n_cols = 32 * w;
  CUtensorMap amap, tmap;
  int sms = 0;
  {
    std::lock_guard<std::mutex> hold(g_lock);
    int rc = device_sms(&sms);
    if (!rc) rc = tensor_map(a, W, n, S, &amap);
    if (!rc) rc = tensor_map(t, W, n_cols, S, &tmap);
    if (rc) return rc;
  }
  // the A flags: set by the transpose when A is B, else a pass of their own
  int rc;
  if (a == b) {
    rc = static_cast<int>(cudaMemsetAsync(
        fa, 0, static_cast<size_t>(S) * (n / kBM) * KC, stream));
  } else {
    flag_kernel<<<dim3(KC, n / kBM, S), 256, 0, stream>>>(a, fa, n);
    rc = launched();
  }
  if (rc) return rc;
  transpose_kernel<<<dim3((w + kTWords - 1) / kTWords, KC, S), 256, 0,
                     stream>>>(b, t, fb, a == b ? fa : nullptr, n, w);
  rc = launched();
  if (rc) return rc;
  const long long tiles = static_cast<long long>(S) * (n / kBM) *
                          ((n_cols + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  product_kernel<<<grid, kThreads, kSmem, stream>>>(amap, tmap, fa, fb, out, counts,
                                             n, n_cols, S);
  return launched();
}

}  // namespace
