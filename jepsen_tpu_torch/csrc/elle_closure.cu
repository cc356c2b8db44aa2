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
// What this design does about it. The product runs in bf16 on the
// tensor cores with f32 accumulation (nvcuda::wmma 16x16x16 fragments):
// entries are 0/1, exact in bf16, and a sum of at most n_pad <= 8320
// ones is exact in f32, so (acc > 0) equals the reference's f32 result.
// A block computes a 128 x 128 output tile with 8 warps (64 x 32 each),
// staging 128 x 32 and 32 x 128 input tiles in shared memory per k
// step. The epilogue binarizes, writes bf16 1/0 with 16-byte stores and
// adds the tile's ones into the subset's int32 counter (warp ballot +
// __popc, one atomic per warp). Squarings are out of place (two
// buffers), as the reference's immutable arrays are. It is the simple
// first kernel: no cp.async/TMA pipeline and no wgmma, which is where
// the remaining factor to the bound lies (a later PR).
//
// The label pass walks, per subset and 32-row block i, the column
// blocks j <= i (R[i,i] = 1, so every row finds its label by the
// diagonal block), reading R[i-block, j-block] and R[j-block, i-block]
// and transposing the second through shared memory; a warp's ballot
// over the 32 columns gives a row's first mutual j. Extra blocks answer
// the rw queries.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128;          // output tile rows
constexpr int kBN = 128;          // output tile columns
constexpr int kBK = 32;           // k step
constexpr int kThreads = 256;     // 8 warps: 2 (rows) x 4 (columns)
constexpr int kLdA = kBK + 8;     // padded shared-memory row strides
constexpr int kLdB = kBN + 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint16_t kOne = 0x3F80; // bf16 1.0

__global__ void __launch_bounds__(kThreads)
square_kernel(const __nv_bfloat16* __restrict__ r,
              __nv_bfloat16* __restrict__ out, int* __restrict__ counts,
              int n) {
  __shared__ __align__(128) __nv_bfloat16 sa[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 sb[kBK * kLdB];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(n) * n;
  const __nv_bfloat16* a = r + s * plane;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < n; k0 += kBK) {
    // A tile: 128 rows x 32 columns = 128 x 4 16-byte vectors
    for (int idx = tid; idx < kBM * 4; idx += kThreads) {
      const int rr = idx >> 2, cc = (idx & 3) * 8;
      *reinterpret_cast<uint4*>(&sa[rr * kLdA + cc]) =
          *reinterpret_cast<const uint4*>(
              &a[static_cast<size_t>(row0 + rr) * n + k0 + cc]);
    }
    // B tile: 32 rows x 128 columns = 32 x 16 16-byte vectors
    for (int idx = tid; idx < kBK * 16; idx += kThreads) {
      const int rr = idx >> 4, cc = (idx & 15) * 8;
      *reinterpret_cast<uint4*>(&sb[rr * kLdB + cc]) =
          *reinterpret_cast<const uint4*>(
              &a[static_cast<size_t>(k0 + rr) * n + col0 + cc]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &sa[(wm * 64 + i * 16) * kLdA + kk],
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sb[kk * kLdB + wn * 32 + j * 16],
                               kLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: binarize, write bf16 1/0, count ones
  float* st = stage[warp];
  const int rr = lane >> 1, cc = (lane & 1) * 8;
  int ones = 0;
  uint16_t* o = reinterpret_cast<uint16_t*>(out) + s * plane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      uint32_t words[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool lo = st[rr * 16 + cc + 2 * q] > 0.0f;
        const bool hi = st[rr * 16 + cc + 2 * q + 1] > 0.0f;
        words[q] = (lo ? kOne : 0u) | ((hi ? kOne : 0u) << 16);
        ones += __popc(__ballot_sync(kFull, lo));
        ones += __popc(__ballot_sync(kFull, hi));
      }
      const size_t grow = row0 + wm * 64 + i * 16 + rr;
      const size_t gcol = col0 + wn * 32 + j * 16 + cc;
      *reinterpret_cast<uint4*>(&o[grow * n + gcol]) =
          make_uint4(words[0], words[1], words[2], words[3]);
      __syncwarp();
    }
  }
  // every lane holds the warp's total
  if (lane == 0 && ones) atomicAdd(&counts[s], ones);
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

}  // namespace

extern "C" int elle_closure_square(const void* r, void* out, int* counts,
                                   int S, int n, void* stream) {
  const dim3 grid(n / kBN, n / kBM, S);
  square_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(out),
      counts, n);
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
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
