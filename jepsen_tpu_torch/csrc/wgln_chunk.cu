// wgln_chunk: one chunk of the wide-window (32 < W = 32 L <= 1024) WGL
// linearizability search, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/wgln.py::_build_searchN -> chunk_fn (the
// jitted lax.while_loop over round_body, wgln.py:322) with its
// host-layout semantics: accel=False, compact=False. The plain PyTorch
// version of the same function is jepsen_tpu_torch/ops/wgln.py::
// chunk_ref; the two agree bit for bit on every carry leaf and on the
// packed summary.
//
// The window is L uint32 lanes (slot j is bit j % 32 of lane j / 32).
// Setting slot j of an ok-row's window and renormalizing it is a
// cross-lane funnel shift: t = 32 q + r trailing ones, where q is the
// first lane that is not all ones (L when all are) and r that lane's
// trailing ones; shifted lane l is
//     (w[l+q] >> r) | (w[l+q+1] << (32 - r))     (w[i] = 0 for i >= L;
// r == 0 takes w[l+q] alone), and the successor's base is base + t.
// Everything else of the round (legality, hashing, memo probe and
// insert, compaction, spill, refill, bookkeeping) is the chunk loop of
// wgl_common.cuh, shared with wgl32_chunk.cu.
//
// What bounds it. Every round walks R = K*(W + ic) successor rows: at
// the top bucket K = 4096 that is 425,984 rows on the 16-wave
// adversarial history (W 96, ic 8) and 2,785,280 on the 900-op long
// tail (W 672, ic 24), each row writing C = 2 + L + Il words and
// probing 4 random 16-byte memo slots in a 128 MB table. Past the
// narrow kernel's latency-bound beam, a round is bounded by the row
// work of ONE streaming multiprocessor: this is a single-SM design (one
// persistent 1024-thread CTA per chunk, the shape the narrow kernel
// proved), chosen because it keeps JAX's row order with one block-wide
// scan and nothing crossing blocks. A grid-wide round (cooperative
// groups, or one block per parent group with a cross-block scan) is a
// later perf PR.
//
// What this design does about the width: no thread holds the L lanes
// in registers (L reaches 32 at W = 1024); each reads its parent's
// lanes from global memory, where L1 catches the W + ic rows that share
// a parent, and streams the row's words through the three FNV hashes as
// it writes them.

#include "wgl_common.cuh"

namespace {

// The wide layout: the window is p.L uint32 lanes.
struct Wide {
  static __device__ __forceinline__ int lanes(const wgl::Params& p) {
    return p.L;
  }
  // lane i of the parent's window with slot j set; 0 past the last lane
  static __device__ __forceinline__ uint32_t lane_ok(const wgl::Params& p,
                                                     const int32_t* row,
                                                     int j, int i) {
    if (i >= p.L) return 0u;
    uint32_t v = (uint32_t)row[1 + i];
    if (i == (j >> 5)) v |= 1u << (j & 31);
    return v;
  }
  // t = 32 q + r (32 L when every lane is full: the window drains)
  static __device__ __forceinline__ int ok_shift(const wgl::Params& p,
                                                 const int32_t* row, int j) {
    for (int q = 0; q < p.L; ++q) {
      const uint32_t v = lane_ok(p, row, j, q);
      if (v != 0xFFFFFFFFu) return 32 * q + (__ffs((int)~v) - 1);
    }
    return 32 * p.L;
  }
  static __device__ __forceinline__ uint32_t ok_lane(const wgl::Params& p,
                                                     const int32_t* row,
                                                     int j, int t, int l) {
    const int q = t >> 5, r = t & 31;
    const uint32_t a = lane_ok(p, row, j, l + q);
    if (r == 0) return a;  // a 32-bit shift is undefined, not a no-op
    return (a >> r) | (lane_ok(p, row, j, l + q + 1) << (32 - r));
  }
};

__global__ void __launch_bounds__(wgl::kThreads, 1)
wgln_chunk_kernel(wgl::Params p) {
  wgl::chunk_body<Wide>(p);
}

// The lane-batched form: one CTA per lane (key), each running the chunk
// loop above on its own slice to its own stop. Replaces
// the wide branch of jepsen_tpu/parallel/batched.py::
// _compiled_batched (:234), jit(vmap(wgln chunk_fn)). A lane's CTA
// is the solo kernel's, so a batch of lanes takes one wave of the 132
// SMs up to 132 lanes and more waves past that; what bounds each lane's
// round is what bounds the solo kernel's.
__global__ void __launch_bounds__(wgl::kThreads, 1)
wgln_chunk_batched_kernel(wgl::BatchParams b) {
  wgl::lane_chunk_body<Wide>(b);
}

}  // namespace

extern "C" int wgln_chunk(WGL_CHUNK_ARGS) {
  const wgl::Params p = WGL_CHUNK_PARAMS;
  wgln_chunk_kernel<<<1, wgl::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgln_chunk_batched(WGL_BATCHED_ARGS) {
  const wgl::BatchParams b = WGL_BATCHED_PARAMS;
  wgln_chunk_batched_kernel<<<lanes, wgl::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgln_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
