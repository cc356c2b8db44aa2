// elle_closure: Elle's dense transitive closure by repeated squaring,
// for Hopper (sm_90a).
//
// Replaces jepsen_tpu/elle/tpu.py::make_closure_kernel (jitted by
// _compiled): per edge-type subset s (S = 3), R <- (R @ R > 0) on the
// (n_pad, n_pad) reach matrix seeded with A|I, until the per-subset
// reach counts repeat; then SCC labels label[s, i] = min{j : R[i,j] &
// R[j,i]} and the rw queries R[s, q_dst, q_src]. The host wrapper
// (jepsen_tpu_torch/elle/tpu.py::closure) scatters the seed, launches
// one squaring per step, reads the S counts after each (the
// reference's while_loop condition) and then launches the label pass.
// The plain PyTorch version is tpu.py::closure_ref; outputs agree bit
// for bit.
//
// What bounds it. A squaring is 2 S n_pad^3 flops over 3 n_pad^2 * 2 B
// of reach (read) and as much written: at n_pad 4096 that is 4.1e11
// flops against 200 MB, about 2000 flops per byte, far above the card's
// ~295 bf16 flops per byte, so the tensor cores bound it: 0.42 ms per
// squaring at 989 TFLOP/s.
//
// What this design does about it. The product runs on the tensor cores
// through wgmma (m64n256k16, bf16 in, f32 accumulated): entries are
// 0/1, exact in bf16, and a sum of at most n_pad <= 8320 ones is exact
// in f32 in any order, so (acc > 0) equals the reference's f32 result
// for any tiling. The squaring is one persistent kernel, one CTA per SM,
// walking the S x (n/128) x ceil(n/256) output tiles of 128 x 256
// (within a subset, groups of kGroup row panels column by column, so
// the panels a wave of CTAs shares stay in L2; at n = 128 mod 256 the
// last column tile is half outside and its outer half is neither
// loaded, stored nor counted). A 128 x 128 tile would need ~7.7 TB/s
// of L2 traffic at the tensor-core peak; 128 x 256 needs two thirds of
// that. Each CTA is warp-specialised:
//   * a producer warpgroup, whose one thread keeps TMA loads in flight
//     into a ring of kStages stages (48 KB each: the A tile 128 x 64 and
//     the B tile 64 x 256, six 64 x 64 boxes of one tensor map over the
//     (S n, n) view, 128-byte swizzle), each stage guarded by a full and
//     an empty mbarrier; it hands registers to the consumers with
//     setmaxnreg (40 each, 232 for a consumer: the 168 a thread the
//     kernel is given, rebalanced);
//   * two consumer warpgroups, each 64 rows x 256 columns of the tile:
//     four wgmma per stage with both operands in shared memory (A
//     K-major, B MN-major through the transpose bit, since R is
//     row-major), one wgmma group kept in flight and the stage before it
//     released to the producer.
// The epilogue works from registers: binarise acc > 0, pack bf16 1/0
// pairs, a quad shuffle turns each thread's pairs into 8 contiguous
// columns for one 16-byte store, and each warp's ones (__popc) go to
// the subset's int32 counter with one atomicAdd per warp per subset.
// Squarings are out of place (two buffers), as the reference's
// immutable arrays are. The tensor map of each reach buffer is encoded
// once on the host and cached by (pointer, n, S); cuTensorMapEncodeTiled
// is reached through cudaGetDriverEntryPoint, so the library needs no
// -lcuda. A pipeline that stops making progress traps (a launch error)
// instead of spinning forever. The simple first kernel of this file
// (nvcuda::wmma, synchronous tile copies, 3072 short-lived CTAs) took
// 3.35 ms a squaring at n_pad 4096; its numbers stay in PERF.md.
//
// The label pass walks, per subset and 32-row block i, the column
// blocks j <= i (R[i,i] = 1, so every row finds its label by the
// diagonal block), reading R[i-block, j-block] and R[j-block, i-block]
// and transposing the second through shared memory; a warp's ballot
// over the 32 columns gives a row's first mutual j. Extra blocks answer
// the rw queries.

#include <cstdint>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                  // output tile rows
constexpr int kBN = 256;                  // output tile columns
constexpr int kBK = 64;                   // k depth of one stage
constexpr int kBox = 64;                  // TMA box: 64 columns (128 B) x 64 rows
constexpr uint32_t kBoxBytes = kBox * kBox * 2;       // 8 KB
constexpr int kBBoxes = kBN / kBox;                   // B boxes a stage
constexpr uint32_t kStageBytes = (2 + kBBoxes) * kBoxBytes;  // A 128x64 + B 64x256
constexpr int kStages = 4;
constexpr int kSmem = kStages * kStageBytes + 1024;   // + 1024-B alignment
constexpr int kThreads = 384;             // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kGroup = 8;                 // row panels walked together
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kOne = 0x3F80;         // bf16 1.0

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16, K-major) @ B (16 x 256, MN-major)
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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

// grid: min(SMs, tiles) persistent CTAs; block kThreads; kSmem dynamic
__global__ void __launch_bounds__(kThreads, 1)
square_kernel(const __grid_constant__ CUtensorMap map,
              uint16_t* __restrict__ out, int* __restrict__ counts, int n,
              int S) {
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  // n is a multiple of 128: the last column tile may be half outside
  const int Tm = n / kBM, Tn = (n + kBN - 1) / kBN, k_blocks = n / kBK;
  const int n_tiles = S * Tm * Tn;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_u32(&full_bar[i]), 1);
      mbar_init(smem_u32(&empty_bar[i]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&map))
                 : "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int s, row0, col0;
        tile_coords(tile, Tm, Tn, s, row0, col0);
        const int base = s * n;
        // B boxes inside the matrix (those past column n are not
        // loaded; their columns are neither stored nor counted)
        const int b_boxes = min(kBBoxes, (n - col0) / kBox);
        for (int kb = 0; kb < k_blocks; ++kb) {
          // the first pass over the ring finds every stage free
          mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full_bar[stage]);
          const uint32_t dst = ring + stage * kStageBytes;
          mbar_expect_tx(bar, (2 + b_boxes) * kBoxBytes);
          const int k0 = kb * kBK;
          tma_load(dst, &map, k0, base + row0, bar);                // A top
          tma_load(dst + kBoxBytes, &map, k0, base + row0 + 64, bar);
          for (int j = 0; j < b_boxes; ++j)                         // B
            tma_load(dst + (2 + j) * kBoxBytes, &map, col0 + j * kBox,
                     base + k0, bar);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: rows c*64 .. c*64+63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int q = lane & 3;
    const size_t plane = static_cast<size_t>(n) * n;
    int stage = 0;
    uint32_t phase = 0;
    int cur_s = -1;
    uint32_t ones = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int s, row0, col0;
      tile_coords(tile, Tm, Tn, s, row0, col0);
      if (s != cur_s) {
        if (cur_s >= 0) flush_ones(counts, cur_s, ones, lane);
        cur_s = s;
        ones = 0;
      }
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      fence_acc(d);
      int prev = -1;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(smem_u32(&full_bar[stage]), phase);
        const uint32_t a = ring + stage * kStageBytes + c * kBoxBytes;
        const uint32_t b = ring + stage * kStageBytes + 2 * kBoxBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          // A: 8-row groups 1024 B apart, k advances 32 B inside the
          // swizzle row; B: 8-row k groups 1024 B apart, each next 64
          // columns 8 KB on, k advances 16 rows of 128 B
          wgmma_256(d, smem_desc(a + kk * 32, 16, 1024),
                    smem_desc(b + kk * 2048, kBoxBytes, 1024));
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));

      // epilogue: d[4b + 2h + e] is row r + 8h, column 8b + 2q + e
      uint16_t* o = out + s * plane;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t grow = row0 + c * 64 + warp * 16 + (lane >> 2) + 8 * h;
        uint16_t* orow = o + grow * n + col0;
#pragma unroll
        for (int g = 0; g < kBN / 32; ++g) {
          uint32_t mask = 0;
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int blk = 4 * g + j;
            const bool lo = d[4 * blk + 2 * h] > 0.0f;
            const bool hi = d[4 * blk + 2 * h + 1] > 0.0f;
            v[j] = (lo ? kOne : 0u) | (hi ? kOne << 16 : 0u);
            mask |= (lo ? 1u : 0u) << (2 * j);
            mask |= (hi ? 1u : 0u) << (2 * j + 1);
          }
          // quad transpose: lane q ends with block 4g+q's 8 columns,
          // word k from lane k (columns 2k, 2k+1)
          uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int snd = (q - r) & 3;
            const uint32_t send = snd == 0 ? v[0]
                                  : snd == 1 ? v[1]
                                  : snd == 2 ? v[2]
                                             : v[3];
            const int k = (q + r) & 3;
            const uint32_t got =
                __shfl_sync(kFull, send, (lane & ~3) | k);
            w0 = k == 0 ? got : w0;
            w1 = k == 1 ? got : w1;
            w2 = k == 2 ? got : w2;
            w3 = k == 3 ? got : w3;
          }
          // a quad's 32 columns lie inside the matrix or past it
          if (col0 + 32 * g < n) {
            *reinterpret_cast<uint4*>(orow + (4 * g + q) * 8) =
                make_uint4(w0, w1, w2, w3);
            ones += __popc(mask);
          }
        }
      }
    }
    if (cur_s >= 0) flush_ones(counts, cur_s, ones, lane);
  }
}

// grid (n/32 + query blocks, S), block (32, 32)
__global__ void __launch_bounds__(1024)
labels_kernel(const uint16_t* __restrict__ r,
              const int32_t* __restrict__ q_src,
              const int32_t* __restrict__ q_dst, int32_t* __restrict__ labels,
              uint8_t* __restrict__ closed, int n, int q_pad) {
  const int s = blockIdx.y;
  const size_t plane = static_cast<size_t>(n) * n;
  const uint16_t* a = r + s * plane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n_lab = n >> 5;
  if (static_cast<int>(blockIdx.x) >= n_lab) {
    const int q = (blockIdx.x - n_lab) * 1024 + ty * 32 + tx;
    if (q < q_pad)
      closed[s * q_pad + q] =
          a[static_cast<size_t>(q_dst[q]) * n + q_src[q]] != 0;
    return;
  }
  __shared__ uint16_t tij[32][33];
  __shared__ uint16_t tji[32][33];
  const int ib = blockIdx.x;
  const int i = ib * 32 + ty;
  int label = n;
  for (int jb = 0; jb <= ib; ++jb) {
    tij[ty][tx] = a[static_cast<size_t>(i) * n + jb * 32 + tx];
    tji[ty][tx] = a[static_cast<size_t>(jb * 32 + ty) * n + ib * 32 + tx];
    __syncthreads();
    // row i = ty, column j = jb * 32 + tx: R[i, j] & R[j, i]
    const bool m = tij[ty][tx] != 0 && tji[tx][ty] != 0;
    const unsigned b = __ballot_sync(kFull, m);
    if (label == n && b) label = jb * 32 + __ffs(b) - 1;
    // also the barrier before the tiles are overwritten
    if (__syncthreads_and(label != n)) break;
  }
  if (tx == 0) labels[s * n + i] = label;
}

// -- host: tensor maps, launch ------------------------------------------------

constexpr int kMaps = 16;             // cached tensor maps
constexpr int kMaxDevices = 64;

struct MapEntry {
  const void* ptr;
  int n, S;
  CUtensorMap map;
};

std::mutex g_lock;
MapEntry g_maps[kMaps];
int g_n_maps = 0, g_next_map = 0;
int g_sms[kMaxDevices];  // 0 until the device's first launch

// the tensor map of reach buffer r, (S n, n) bf16 row-major, in 64 x 64
// boxes with 128-byte swizzle: encoded once per (pointer, n, S)
int tensor_map(const void* r, int n, int S, CUtensorMap* out) {
  for (int i = 0; i < g_n_maps; ++i) {
    if (g_maps[i].ptr == r && g_maps[i].n == n && g_maps[i].S == S) {
      *out = g_maps[i].map;
      return 0;
    }
  }
  EncodeTiled encode;
  const int rc = encoder(&encode);
  if (rc) return rc;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(S) * n};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t box[2] = {kBox, kBox};
  const cuuint32_t elem[2] = {1, 1};
  MapEntry& e = g_n_maps < kMaps ? g_maps[g_n_maps++]
                                 : g_maps[g_next_map++ % kMaps];
  e.ptr = nullptr;
  const CUresult cr = encode(
      &e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(r),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return kEncodeError + static_cast<int>(cr);
  e.ptr = r;
  e.n = n;
  e.S = S;
  *out = e.map;
  return 0;
}

// the current device's SM count, its kernel attribute set on first use
int device_sms(int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_sms[dev]) {
    e = cudaFuncSetAttribute(square_kernel,
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

}  // namespace

extern "C" int elle_closure_square(const void* r, void* out, int* counts,
                                   int S, int n, void* stream) {
  if (S < 1 || n < kBM || n % kBM ||
      (reinterpret_cast<uintptr_t>(r) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  int sms = 0;
  {
    std::lock_guard<std::mutex> hold(g_lock);
    int rc = device_sms(&sms);
    if (!rc) rc = tensor_map(r, n, S, &map);
    if (rc) return rc;
  }
  const long long tiles =
      static_cast<long long>(S) * (n / kBM) * ((n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  square_kernel<<<grid, kThreads, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<uint16_t*>(out), counts, n, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int elle_closure_labels(const void* r, const int32_t* q_src,
                                   const int32_t* q_dst, int32_t* labels,
                                   uint8_t* closed, int S, int n, int q_pad,
                                   void* stream) {
  const dim3 grid(n / 32 + (q_pad + 1023) / 1024, S);
  labels_kernel<<<grid, dim3(32, 32), 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(r), q_src, q_dst, labels, closed, n,
      q_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* elle_closure_error_string(int code) {
  return error_text(code);
}
