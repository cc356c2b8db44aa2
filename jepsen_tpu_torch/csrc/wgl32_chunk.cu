// wgl32_chunk: one chunk of the narrow-window (W <= 32) WGL
// linearizability search, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/wgl32.py::_build_search32 -> chunk_fn (the
// jitted lax.while_loop over round_body) with its host-layout semantics:
// depth=1, compact=False, accel=False. The plain PyTorch version of the
// same function is jepsen_tpu_torch/ops/wgl32.py::chunk_ref; the two
// agree bit for bit on every carry leaf and on the packed summary.
//
// What bounds it. A round is a chain of dependent steps: read the
// frontier and op metadata, expand and hash, probe the memo table (a
// random 16-byte read per probe into a table of 2^23 slots = 128 MB at
// the 10k-op headline, far past the 50 MB L2), claim and write the
// insert slot, read it back to verify, compact, then spill to and refill
// from the backlog. That is about five dependent global-memory round
// trips per round, and the next round cannot start before this one
// ends. At the headline's beam (K = 2..16 rows, R = K*(W+ic) = 80..640
// successor rows) the bytes per round are a few tens of KB, so the
// round is latency-bound, not bandwidth- or compute-bound.
//
// What this design does about it: one persistent CTA runs the whole
// round loop of a chunk on the device, so a chunk is one launch and no
// round pays a launch or a host round trip; one block keeps JAX's row
// order deterministic (the compaction order is a block-wide prefix sum
// over all R rows) and nothing has to cross blocks. Where the round's
// working set fits in shared memory (the successor rows, the three
// signatures, insert slots, row flags, per-parent min rets and both
// frontiers: the mesh's K = 64 at W 32, ic 16 takes 112,896 bytes), it
// lives there,
// so the only device-memory round trips of a round are the memo probe,
// the claim, the won-check read, the entry write and the verify read;
// the block has a warp multiple of R threads, not 1024 at every K (at
// K = 2, R = 80 rows take 3 warps). Larger buckets (the headline's K =
// 512, R = 20,480 rows, ~740 KB) keep the round's scratch in device
// memory. The wrapper picks the form by shape (ops/wgl32.py::
// block_form); the phases of one round are in wgl_common.cuh, shared
// with the wide-window kernel (wgln_chunk.cu), which also has a
// grid-wide form. This file holds the narrow layout's ok-row window
// update: one uint32 window word.

#include "wgl_common.cuh"

namespace {

// The narrow layout: the window is one uint32 lane.
struct Narrow {
  static __device__ __forceinline__ int lanes(const wgl::Params&) {
    return 1;
  }
  // t = trailing ones of the window with bit j set (32: drained)
  static __device__ __forceinline__ int ok_shift(const wgl::Params&,
                                                 const int32_t* row, int j) {
    const uint32_t x = ~((uint32_t)row[1] | (1u << j));
    return x ? (__ffs((int)x) - 1) : 32;
  }
  static __device__ __forceinline__ uint32_t ok_lane(const wgl::Params&,
                                                     const int32_t* row,
                                                     int j, int t, int) {
    const uint32_t wok = (uint32_t)row[1] | (1u << j);
    return t >= 32 ? 0u : (wok >> t);
  }
};

template <bool kShared>
__global__ void __launch_bounds__(wgl::kMaxThreads, 1)
wgl32_chunk_kernel(wgl::Params p) {
  wgl::chunk_body<Narrow, kShared>(p);
}

// The lane-batched form: one CTA per lane (key), each running the chunk
// loop above on its own slice to its own stop. Replaces
// jepsen_tpu/ops/wgl32.py::chunk_fn_batched (:757) and the narrow branch of
// jepsen_tpu/parallel/batched.py::_compiled_batched (:234). A lane's CTA
// is the solo kernel's, in either one-CTA form, so a batch of lanes takes
// one wave of the 132 SMs up to 132 lanes (more where a lane's block is
// small) and more waves past that; each lane's round is bound as the
// solo kernel's is, by its chain of dependent memo accesses, and the
// lanes' random memo probes (one table per lane, far past the L2
// together) queue on the same device memory.
template <bool kShared>
__global__ void __launch_bounds__(wgl::kMaxThreads, 1)
wgl32_chunk_batched_kernel(wgl::BatchParams b) {
  wgl::lane_chunk_body<Narrow, kShared>(b);
}

}  // namespace

// The launch form: `threads` a block, `smem` > 0 the shared form's
// dynamic bytes (the narrow search has no grid form)
extern "C" int wgl32_chunk(WGL_CHUNK_ARGS, int threads, int smem,
                           void* stream) {
  const wgl::Params p = WGL_CHUNK_PARAMS;
  return static_cast<int>(wgl::launch_block(
      &wgl32_chunk_kernel<false>, &wgl32_chunk_kernel<true>, p, 1, threads,
      smem, static_cast<cudaStream_t>(stream)));
}

extern "C" int wgl32_chunk_batched(WGL_BATCHED_ARGS, int threads, int smem,
                                   void* stream) {
  const wgl::BatchParams b = WGL_BATCHED_PARAMS;
  return static_cast<int>(wgl::launch_block(
      &wgl32_chunk_batched_kernel<false>, &wgl32_chunk_batched_kernel<true>,
      b, lanes, threads, smem, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* wgl32_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
