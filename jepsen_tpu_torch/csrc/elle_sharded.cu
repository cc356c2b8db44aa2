// elle_sharded: one squaring of Elle's packed closure restricted to a
// block of word columns, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/elle/tpu.py::make_sharded_closure_kernel (run
// under shard_map by _compiled_sharded): the packed reach (S, n, W =
// n/32) uint32 words is split by word columns into shards of w_loc =
// W / n_shards words. Shard k owns loc (S, n, w_loc), its columns
// [k w_loc, (k+1) w_loc). Before each squaring every shard gathers the
// full reach (S, n, W) (jepsen_tpu_torch/elle/tpu.py::sharded_closure
// copies each block into each shard's gather buffer); one squaring of
// shard k is
//   out[s,i,w] = OR_{j : bit j of full[s,i]} loc[s,j,w],  w < w_loc,
// with a popcount per subset. The host sums the shards' counts (the
// reference's psum) and stops as the packed closure does. The label
// pass then runs elle_packed_labels over the final gathered reach. The
// plain version is tpu.py::sharded_square_ref (packed_square_ref
// restricted to the column block).
//
// The squaring is the Boolean product full x loc on the tensor cores,
// csrc/elle_bitmm.cuh with A = full and B = loc: a flag pass over the
// gathered reach, the bit transpose of the shard's own block only ((S,
// n, w_loc) -> (S, 32 w_loc, W): exactly the rows of B^T its output
// columns need), and the persistent TMA + wgmma product over the S x
// n/128 x ceil(32 w_loc / 256) output tiles, skipping k stages whose
// tiles hold no bit. A block narrower than 256 columns (w_loc < 8)
// loads its T rows as boxes whose rows past the block arrive as zeros,
// and stores only its own words. That header says what bounds it. The
// first kernel of this file walked the set bits of full with __ffs
// against staged rows of loc; its numbers stay in PERF.md.

#include <cstdint>

#include "elle_bitmm.cuh"

// t, fa, fb: the shard's scratch for this squaring (elle_bitmm.cuh),
// allocated on its stream; counts zero on entry
extern "C" int elle_sharded_square(const uint32_t* full, const uint32_t* loc,
                                   uint32_t* out, int* counts, uint32_t* t,
                                   uint8_t* fa, uint8_t* fb, int S, int n,
                                   int w_loc, void* stream) {
  return bitmm_square(full, loc, out, counts, t, fa, fb, S, n, w_loc,
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* elle_sharded_error_string(int code) {
  return error_text(code);
}
