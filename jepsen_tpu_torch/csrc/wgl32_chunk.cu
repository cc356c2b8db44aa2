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
// What this design does about it: one persistent CTA of 1024 threads
// runs the whole round loop of a chunk on the device, with
// __syncthreads() between phases, so a chunk is one launch and no
// round pays a launch or a host round trip. One block keeps JAX's row
// order deterministic (the compaction order is a block-wide prefix sum
// over all R rows) and nothing has to cross blocks. At K = 512 (R =
// 20,480) the block loops over its rows. A grid-wide design
// (cooperative groups, memo insert by 128-bit CAS) and CUDA graphs over
// chunk launches are later work.
//
// The phases of one round are in wgl_common.cuh, shared with the
// wide-window kernel (wgln_chunk.cu); this file holds the narrow
// layout's ok-row window update: one uint32 window word.

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

__global__ void __launch_bounds__(wgl::kThreads, 1)
wgl32_chunk_kernel(wgl::Params p) {
  wgl::chunk_body<Narrow>(p);
}

}  // namespace

extern "C" int wgl32_chunk(WGL_CHUNK_ARGS) {
  const wgl::Params p = WGL_CHUNK_PARAMS;
  wgl32_chunk_kernel<<<1, wgl::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgl32_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
