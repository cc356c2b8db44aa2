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
// 3.35 TB/s. The design: grid (blocks, lanes), a block of an unmasked
// lane returns at once; the blocks of a masked lane stride over its
// slices with 16-byte stores (the memo slice dominates). jnp.where
// instead reads and writes every lane of every leaf.
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

// grid (blocks per lane, lanes), block kThreads
__global__ void __launch_bounds__(kThreads)
reset_kernel(int32_t* __restrict__ fr, int32_t* __restrict__ fr_cnt,
             int32_t* __restrict__ bk, int32_t* __restrict__ bk_cnt,
             int32_t* __restrict__ table, int32_t* __restrict__ flags,
             int32_t* __restrict__ stats, int32_t* __restrict__ ring,
             const int32_t* __restrict__ mask, int K, int C, int B, int H,
             int ring_words, int mst_col, int mstate0) {
  const size_t lane = blockIdx.y;
  if (!mask[lane]) return;  // whole block
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

}  // namespace

extern "C" int wgl_lane_reset(int32_t* fr, int32_t* fr_cnt, int32_t* bk,
                              int32_t* bk_cnt, int32_t* table,
                              int32_t* flags, int32_t* stats, int32_t* ring,
                              const int32_t* mask, int lanes, int K, int C,
                              int B, int H, int ring_words, int mst_col,
                              int mstate0, void* stream) {
  if (lanes < 1 || lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // enough blocks a lane for its largest slice in 16-byte stores
  size_t widest = static_cast<size_t>(H);  // int4 slots of the table
  const size_t bk_v = static_cast<size_t>(B) * C / 4 + 1;
  if (bk_v > widest) widest = bk_v;
  const dim3 grid(blocks_for(widest), lanes);
  reset_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fr, fr_cnt, bk, bk_cnt, table, flags, stats, ring, mask, K, C, B, H,
      ring_words, mst_col, mstate0);
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
