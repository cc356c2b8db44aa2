// elle_packed: Elle's transitive closure over uint32 bitset rows, for
// Hopper (sm_90a).
//
// Replaces jepsen_tpu/elle/tpu.py::make_packed_closure_kernel (jitted
// by _compiled_packed): the reach matrix of each subset s is (n_pad,
// W = n_pad/32) uint32 words, bit j of row i at word j/32, bit j%32.
// One squaring is R2[s,i,w] = OR_{j : bit j of R[s,i]} R[s,j,w] with a
// popcount per subset; the host wrapper (jepsen_tpu_torch/elle/tpu.py::
// packed_closure) reads the S counts after each squaring and stops as
// the dense closure does. Then labels and rw queries from the bits.
// The plain PyTorch version is tpu.py::packed_closure_ref; outputs
// equal the dense closure's bit for bit (tests/test_elle_tpu.py's
// contract in the reference).
//
// What bounds it. The formulation does 2 S n_pad^2 W 32-bit word
// operations per squaring (an AND and an OR per (i, j, w)): 8.2e11 at
// n_pad 16384, about 50 ms at the card's int32 rate (132 SMs x 64 lanes
// x 1.98 GHz). Its bytes are 2 S n_pad W 4 (read and write the
// bitset): 200 MB, 0.06 ms at 3.35 TB/s. The work the data needs is
// less: a set bit j of row i selects row j, so one OR per (set bit,
// word), ones x W per squaring; chip_smoke.py takes the larger of that
// and the byte bound for each squaring.
//
// What this design does about it. Only the set bits cost work: a warp
// holds 32 word columns of one row i, and for each 32-row block jb
// walks the set bits of R[s,i,jb] with __ffs (the word is the same for
// the whole warp, so the loop is uniform), OR-ing the staged word of
// row j into its accumulator. A block stages 32 rows x 32 words of
// block jb in shared memory once and reuses them for 64 rows i, so
// early sparse squarings run far below the dense count. The counts are
// __popc of the new words, one atomic per warp. A bit-matrix product
// on the tensor cores (b1 mma) or a popcount-GEMM form is later work.
//
// The label pass: a warp takes 32 rows i (block ib) and walks column
// blocks jb <= ib; lane l reads its row's word jb (bits over j) and
// row jb*32+l's word ib (bits over i); 32 ballots transpose the second
// 32 x 32 bit block, and the first set bit of the AND is the row's
// label. Extra blocks answer the rw queries.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;          // rows i per block
constexpr int kThreadsX = 32;      // word columns per block
constexpr int kThreadsY = 8;       // warps; each warp kRows / 8 rows
constexpr int kPerThread = kRows / kThreadsY;
constexpr unsigned kFull = 0xffffffffu;

// grid (ceil(W / 32), n / 64, S), block (32, 8)
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
square_kernel(const uint32_t* __restrict__ r, uint32_t* __restrict__ out,
              int* __restrict__ counts, int n) {
  const int W = n >> 5;
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(n) * W;
  const uint32_t* a = r + s * plane;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int w = blockIdx.x * kThreadsX + tx;
  const bool in = w < W;
  const int i0 = blockIdx.y * kRows + ty;
  __shared__ uint32_t rows[32][kThreadsX + 1];
  uint32_t acc[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) acc[q] = 0u;

  for (int jb = 0; jb < W; ++jb) {
    for (int k = ty; k < 32; k += kThreadsY)
      rows[k][tx] = in ? a[static_cast<size_t>(jb * 32 + k) * W + w] : 0u;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      uint32_t bits = a[static_cast<size_t>(i0 + kThreadsY * q) * W + jb];
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
      out[s * plane + static_cast<size_t>(i0 + kThreadsY * q) * W + w] =
          acc[q];
      ones += __popc(acc[q]);
    }
  }
  ones = __reduce_add_sync(kFull, ones);
  if (tx == 0 && ones) atomicAdd(&counts[s], ones);
}

// grid (ceil(n/32 / 4) + query blocks, S), block 128 (4 warps)
__global__ void __launch_bounds__(128)
labels_kernel(const uint32_t* __restrict__ r,
              const int32_t* __restrict__ q_src,
              const int32_t* __restrict__ q_dst, int32_t* __restrict__ labels,
              uint8_t* __restrict__ closed, int n, int q_pad, int n_lab) {
  const int W = n >> 5;
  const int s = blockIdx.y;
  const size_t plane = static_cast<size_t>(n) * W;
  const uint32_t* a = r + s * plane;
  const int tid = threadIdx.x, lane = tid & 31;
  if (static_cast<int>(blockIdx.x) >= n_lab) {
    const int q = (blockIdx.x - n_lab) * 128 + tid;
    if (q < q_pad) {
      const uint32_t word =
          a[static_cast<size_t>(q_dst[q]) * W + (q_src[q] >> 5)];
      closed[s * q_pad + q] = (word >> (q_src[q] & 31)) & 1u;
    }
    return;
  }
  const int ib = blockIdx.x * 4 + (tid >> 5);
  if (ib >= W) return;  // whole warp
  const int i = ib * 32 + lane;
  int label = n;
  for (int jb = 0; jb <= ib; ++jb) {
    const uint32_t row_i = a[static_cast<size_t>(i) * W + jb];   // over j
    const uint32_t row_j =
        a[static_cast<size_t>(jb * 32 + lane) * W + ib];        // over i
    // col: bit l = bit `lane` of row jb*32+l's word, i.e. R[j, i]
    uint32_t col = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t b = __ballot_sync(kFull, (row_j >> k) & 1u);
      if (lane == k) col = b;
    }
    const uint32_t m = row_i & col;
    if (label == n && m) label = jb * 32 + __ffs(static_cast<int>(m)) - 1;
    if (__all_sync(kFull, label != n)) break;
  }
  labels[s * n + i] = label;
}

}  // namespace

extern "C" int elle_packed_square(const uint32_t* r, uint32_t* out,
                                  int* counts, int S, int n, void* stream) {
  const int W = n / 32;
  const dim3 grid((W + kThreadsX - 1) / kThreadsX, n / kRows, S);
  square_kernel<<<grid, dim3(kThreadsX, kThreadsY), 0,
                  static_cast<cudaStream_t>(stream)>>>(r, out, counts, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int elle_packed_labels(const uint32_t* r, const int32_t* q_src,
                                  const int32_t* q_dst, int32_t* labels,
                                  uint8_t* closed, int S, int n, int q_pad,
                                  void* stream) {
  const int n_lab = (n / 32 + 3) / 4;
  const dim3 grid(n_lab + (q_pad + 127) / 128, S);
  labels_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      r, q_src, q_dst, labels, closed, n, q_pad, n_lab);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* elle_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
