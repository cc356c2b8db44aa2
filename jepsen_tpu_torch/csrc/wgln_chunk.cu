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
// probing 4 random 16-byte memo slots in a 128 MB table. On one SM such
// a round is bounded by that SM's share of the memory system (8.2 ns a
// row at L = 2, ~1.3-1.6 ms a round at K = 2048-4096 on the one-CTA
// design); across the card it is bounded by the random memo sectors and
// the row traffic at the card's memory rate.
//
// What this design does about it. Past a crossover in R (ops/wgln.py::
// GRID_MIN_ROWS, measured on the card), or where one CTA could not keep
// the round in shared memory, the solo search runs the grid form of
// wgl_common.cuh: one cooperative launch of up to one 1024-thread CTA
// per SM, each block owning a contiguous range of rows, with a
// hand-written grid barrier between the phases (four a round) and the
// loop state in device memory. Below it, one CTA runs the round in
// shared memory. The lane-batched kernel
// keeps one CTA a lane. The wrapper picks the form by shape
// (ops/wgln.py::solo_form).
//
// What this design does about the width: no thread holds the L lanes
// in registers (L reaches 32 at W = 1024); each reads its parent's
// lanes, where L1 catches the W + ic rows that share a parent, and
// streams the row's words through the three FNV hashes as it writes
// them.

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

template <bool kShared>
__global__ void __launch_bounds__(wgl::kMaxThreads, 1)
wgln_chunk_kernel(wgl::Params p) {
  wgl::chunk_body<Wide, kShared>(p);
}

// The grid form: every block of one cooperative launch on the same
// search, block b on its range of rows.
__global__ void __launch_bounds__(wgl::kMaxThreads, 1)
wgln_chunk_grid_kernel(wgl::Params p, int32_t* ctl) {
  wgl::grid_chunk_body<Wide>(p, ctl);
}

// The lane-batched form: one CTA per lane (key), each running the chunk
// loop above on its own slice to its own stop. Replaces
// the wide branch of jepsen_tpu/parallel/batched.py::
// _compiled_batched (:234), jit(vmap(wgln chunk_fn)). A lane's CTA
// is the solo kernel's one-CTA form, so a batch of lanes takes one wave
// of the 132 SMs up to 132 lanes and more waves past that; what bounds
// each lane's round is what bounds the one-CTA solo kernel's.
template <bool kShared>
__global__ void __launch_bounds__(wgl::kMaxThreads, 1)
wgln_chunk_batched_kernel(wgl::BatchParams b) {
  wgl::lane_chunk_body<Wide, kShared>(b);
}

}  // namespace

// The launch form: `blocks` > 0 takes the grid form (at most that many
// blocks of 1024 threads, no shared bytes); 0 one CTA of `threads`
// threads, `smem` > 0 its shared form's dynamic bytes
extern "C" int wgln_chunk(WGL_CHUNK_ARGS, int threads, int blocks, int smem,
                          void* stream) {
  const wgl::Params p = WGL_CHUNK_PARAMS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    if (threads != wgl::kMaxThreads || smem != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        wgl::launch_grid(&wgln_chunk_grid_kernel, p, blocks, s));
  }
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(wgl::launch_block(
      &wgln_chunk_kernel<false>, &wgln_chunk_kernel<true>, p, 1, threads,
      smem, s));
}

extern "C" int wgln_chunk_batched(WGL_BATCHED_ARGS) {
  const wgl::BatchParams b = WGL_BATCHED_PARAMS;
  return static_cast<int>(wgl::launch_block(
      &wgln_chunk_batched_kernel<false>, &wgln_chunk_batched_kernel<true>,
      b, lanes, threads, smem, static_cast<cudaStream_t>(stream)));
}

// int32 words of the grid form's control block, which follows the
// round's scratch (wgl::scratch_words) in the scratch the caller passes
extern "C" int wgln_chunk_grid_ctl_words() { return wgl::kGridCtlWords; }

extern "C" const char* wgln_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
