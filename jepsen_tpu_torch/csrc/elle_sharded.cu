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
// What bounds it: a set bit j of row i selects row j's w_loc local
// words, one OR per (set bit, local word): ones x w_loc a shard per
// squaring; bytes: the gathered reach read once, the local block read
// and written once. The design is elle_packed.cu's square_kernel with
// separate pointers and strides for the bit source (full, stride W),
// the staged rows and the output (stride w_loc): a warp holds 32 local
// word columns of one row i, a block stages 32 rows x 32 local words of
// row block jb in shared memory and walks the set bits of full[s,i,jb]
// with __ffs for 64 rows i. A shard narrower than 32 words leaves the
// rest of the warp's lanes idle.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // rows i per block
constexpr int kThreadsX = 32;      // local word columns per block
constexpr int kThreadsY = 8;       // warps; each warp kRows / 8 rows
constexpr int kPerThread = kRows / kThreadsY;
constexpr unsigned kFull = 0xffffffffu;

// grid (ceil(w_loc / 32), n / 64, S), block (32, 8)
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
sharded_square_kernel(const uint32_t* __restrict__ full,
                      const uint32_t* __restrict__ loc,
                      uint32_t* __restrict__ out, int* __restrict__ counts,
                      int n, int w_loc) {
  const int W = n >> 5;
  const int s = blockIdx.z;
  const uint32_t* f = full + s * static_cast<size_t>(n) * W;
  const uint32_t* a = loc + s * static_cast<size_t>(n) * w_loc;
  uint32_t* o = out + s * static_cast<size_t>(n) * w_loc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int w = blockIdx.x * kThreadsX + tx;
  const bool in = w < w_loc;
  const int i0 = blockIdx.y * kRows + ty;
  __shared__ uint32_t rows[32][kThreadsX + 1];
  uint32_t acc[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) acc[q] = 0u;

  for (int jb = 0; jb < W; ++jb) {
    for (int k = ty; k < 32; k += kThreadsY)
      rows[k][tx] =
          in ? a[static_cast<size_t>(jb * 32 + k) * w_loc + w] : 0u;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      uint32_t bits = f[static_cast<size_t>(i0 + kThreadsY * q) * W + jb];
      uint32_t v = acc[q];
      while (bits) {
        const int k = __ffs(static_cast<int>(bits)) - 1;
        bits &= bits - 1;
        v |= rows[k][tx];
      }
      acc[q] = v;
    }
    __syncthreads();
  }
  int ones = 0;
  if (in) {
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      o[static_cast<size_t>(i0 + kThreadsY * q) * w_loc + w] = acc[q];
      ones += __popc(acc[q]);
    }
  }
  ones = __reduce_add_sync(kFull, ones);
  if (tx == 0 && ones) atomicAdd(&counts[s], ones);
}

}  // namespace

extern "C" int elle_sharded_square(const uint32_t* full, const uint32_t* loc,
                                   uint32_t* out, int* counts, int S, int n,
                                   int w_loc, void* stream) {
  const dim3 grid((w_loc + kThreadsX - 1) / kThreadsX, n / kRows, S);
  sharded_square_kernel<<<grid, dim3(kThreadsX, kThreadsY), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      full, loc, out, counts, n, w_loc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* elle_sharded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
