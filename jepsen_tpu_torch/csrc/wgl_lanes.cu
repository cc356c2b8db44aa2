// wgl_lanes: the mesh scheduler's two carry programs, for Hopper
// (sm_90a).
//
// Replaces jepsen_tpu/parallel/mesh.py::_reset_fn (a jitted jnp.where
// of every carry leaf against a fresh init tree) and ::_migrate_fn
// (jepsen_tpu/ops/adapt.py::migrate_frontier_batch jitted at a target
// K). The plain PyTorch versions are jepsen_tpu_torch/parallel/mesh.py::
// reset_lanes_ref and jepsen_tpu_torch/ops/adapt.py::
// migrate_frontier_batch; the wrappers are mesh.py::reset_lanes and
// ::migrate_lanes. The carry is the WGL search's 8 leaves with a lead
// lane axis, int32: fr (lanes, K, C), fr_cnt (lanes), bk (lanes, B, C),
// bk_cnt (lanes), table (lanes, H, 4), flags (lanes, 3), stats
// (lanes, 6), ring (lanes, ring_words).
//
// wgl_lane_reset. Each lane whose mask is set takes the search's start
// state in every leaf: frontier zero but row 0's model state (column
// mst_col = mstate0), fr_cnt 1, memo table, backlog, bk_cnt, flags,
// stats and ring zero. Other lanes are not touched. What bounds it:
// the bytes written, H x 16 + B x C x 4 + K x C x 4 + ring_words x 4 +
// 48 a masked lane (8.4 MB at the fan-out's H 2^19, B 2^14, C 5), over
// 3.35 TB/s. The design: the grid is (blocks, masked lanes), so no block
// is launched only to return: block row y resets the y-th masked lane.
// A carry of at most 64 lanes passes its mask by value, one 64-bit
// word (the mesh resets 4-lane shards: no mask buffer, no copy to the
// card); row y takes the y-th set bit. A wider carry passes the masked
// lanes' indices in device memory instead. The wrapper hands every
// argument over in one host block (below). The blocks of a lane are
// sized so that the whole grid is about one wave of resident blocks
// (kBlocksPerSM a multiprocessor), capped by the lane's widest slice in
// 16-byte stores (the memo slice dominates), and stride over its
// slices with 16-byte stores. jnp.where instead reads and writes every
// lane of every leaf.
//
// wgl_frontier_migrate. dst (lanes, k_new, C) = src (lanes, k_old, C)
// padded with zero rows or cut to k_new rows. Bound: the rows kept read
// once and the new frontier written once. In each lane the kept rows
// are one contiguous run of min(k_old, k_new) C words and the rest of
// the lane is zero, so the design copies that run and zeroes the rest:
// grid (blocks, lanes), 16-byte vectors where source and destination
// share their alignment, scalar head and tail, and no division by C or
// k. The frontier is KB to a few hundred KB, so the launch's host path
// (jepsen_tpu_torch/ops/_native.py::launch) is most of its cost.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// zero n words at p, thread t of `stride`: 16-byte stores between a
// scalar head (to the first 16-byte boundary) and a scalar tail
__device__ __forceinline__ void zero_words(int32_t* p, size_t n, size_t t,
                                           size_t stride) {
  size_t head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2;
  if (head > n) head = n;
  for (size_t i = t; i < head; i += stride) p[i] = 0;
  int4* v = reinterpret_cast<int4*>(p + head);
  const size_t nv = (n - head) >> 2;
  const int4 z = make_int4(0, 0, 0, 0);
  for (size_t i = t; i < nv; i += stride) v[i] = z;
  for (size_t i = head + (nv << 2) + t; i < n; i += stride) p[i] = 0;
}

// the lane of block row y: the y-th set bit of `mask`, or idx[y]
__device__ __forceinline__ size_t masked_lane(const int32_t* idx,
                                              unsigned long long mask,
                                              unsigned y) {
  if (idx) return static_cast<size_t>(idx[y]);
  for (; y; --y) mask &= mask - 1;  // drop the y lowest set bits
  return static_cast<size_t>(__ffsll(static_cast<long long>(mask)) - 1);
}

// grid (blocks per lane, masked lanes), block kThreads
__global__ void __launch_bounds__(kThreads)
reset_kernel(int32_t* __restrict__ fr, int32_t* __restrict__ fr_cnt,
             int32_t* __restrict__ bk, int32_t* __restrict__ bk_cnt,
             int32_t* __restrict__ table, int32_t* __restrict__ flags,
             int32_t* __restrict__ stats, int32_t* __restrict__ ring,
             const int32_t* __restrict__ idx, unsigned long long mask,
             int K, int C, int B, int H, int ring_words, int mst_col,
             int mstate0) {
  const size_t lane = masked_lane(idx, mask, blockIdx.y);
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  zero_words(table + lane * H * 4, static_cast<size_t>(H) * 4, t, stride);
  zero_words(bk + lane * B * C, static_cast<size_t>(B) * C, t, stride);
  zero_words(ring + lane * ring_words, ring_words, t, stride);
  // the frontier is small: one word a thread, row 0's model state set
  // by the thread that writes it (no second pass, no race)
  int32_t* f = fr + lane * K * C;
  for (size_t i = t; i < static_cast<size_t>(K) * C; i += stride)
    f[i] = i == static_cast<size_t>(mst_col) ? mstate0 : 0;
  if (t < 3) flags[lane * 3 + t] = 0;
  if (t < 6) stats[lane * 6 + t] = 0;
  if (t == 0) {
    fr_cnt[lane] = 1;
    bk_cnt[lane] = 0;
  }
}

// copy n words src -> dst, thread t of `stride`: 16-byte vectors
// between a scalar head and tail when both share their alignment
__device__ __forceinline__ void copy_words(int32_t* dst, const int32_t* src,
                                           size_t n, size_t t,
                                           size_t stride) {
  if ((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src))
      & 15) {
    for (size_t i = t; i < n; i += stride) dst[i] = src[i];
    return;
  }
  size_t head = ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  if (head > n) head = n;
  for (size_t i = t; i < head; i += stride) dst[i] = src[i];
  int4* dv = reinterpret_cast<int4*>(dst + head);
  const int4* sv = reinterpret_cast<const int4*>(src + head);
  const size_t nv = (n - head) >> 2;
  for (size_t i = t; i < nv; i += stride) dv[i] = sv[i];
  for (size_t i = head + (nv << 2) + t; i < n; i += stride) dst[i] = src[i];
}

// grid (blocks per lane, lanes), block kThreads
__global__ void __launch_bounds__(kThreads)
migrate_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
               int k_old, int k_new, int C) {
  const size_t lane = blockIdx.y;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t total = static_cast<size_t>(k_new) * C;
  const size_t keep = static_cast<size_t>(k_old < k_new ? k_old : k_new) * C;
  int32_t* d = dst + lane * total;
  copy_words(d, src + lane * k_old * C, keep, t, stride);
  zero_words(d + keep, total - keep, t, stride);
}

int blocks_for(size_t work) {
  const size_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

// resident kThreads-thread blocks a multiprocessor holds (2048 threads)
constexpr int kBlocksPerSM = 2048 / kThreads;

// the multiprocessors of the current card, read once a card
int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

}  // namespace

// The arguments arrive in one host block of int64 words (one pointer
// through ctypes in place of twenty conversions, about 7 us of a call's
// host path; layout parallel/mesh.py::RESET_WORDS): a[0..7] the leaves
// fr, fr_cnt, bk, bk_cnt, table, flags, stats, ring; a[8] the masked
// lanes' indices on the card, or 0 when a[9] holds the mask by value (a
// carry of at most 64 lanes); a[10] the masked count; a[11..15] K, C,
// B, H, ring words a lane; a[16] the model-state column, a[17] its
// value. The block is read before the launch returns.
extern "C" int wgl_lane_reset(const int64_t* a, void* stream) {
  auto ptr = [a](int i) {
    return reinterpret_cast<int32_t*>(static_cast<intptr_t>(a[i]));
  };
  const int32_t* idx = ptr(8);
  const unsigned long long mask = static_cast<unsigned long long>(a[9]);
  const long long n_masked = a[10];
  const int K = static_cast<int>(a[11]), C = static_cast<int>(a[12]);
  const int B = static_cast<int>(a[13]), H = static_cast<int>(a[14]);
  if (n_masked < 0 || n_masked > 65535 ||
      (!idx && __builtin_popcountll(mask) != n_masked))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_masked == 0) return 0;
  const int n = static_cast<int>(n_masked);
  // a lane's widest slice in 16-byte stores: the table's H slots or
  // the backlog's B x C words
  size_t widest = static_cast<size_t>(H);
  const size_t bk_v = static_cast<size_t>(B) * C / 4 + 1;
  if (bk_v > widest) widest = bk_v;
  // about one wave of resident blocks over all masked lanes, no more
  // blocks a lane than its widest slice fills
  const int wave = (sm_count() * kBlocksPerSM + n - 1) / n;
  const int need = blocks_for(widest);
  const dim3 grid(need < wave ? need : wave, n);
  reset_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ptr(0), ptr(1), ptr(2), ptr(3), ptr(4), ptr(5), ptr(6), ptr(7), idx,
      mask, K, C, B, H, static_cast<int>(a[15]), static_cast<int>(a[16]),
      static_cast<int>(a[17]));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgl_frontier_migrate(const int32_t* src, int32_t* dst,
                                    int lanes, int k_old, int k_new, int C,
                                    void* stream) {
  if (lanes > 65535 || k_old < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t words = static_cast<size_t>(k_new) * C;
  if (lanes < 1 || words == 0) return 0;
  // enough blocks a lane for its words in 16-byte pieces
  const dim3 grid(blocks_for(words / 4 + 1), lanes);
  migrate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, dst, k_old, k_new, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgl_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
