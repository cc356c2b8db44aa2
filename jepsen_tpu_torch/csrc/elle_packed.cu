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
// The squaring (elle_packed_square) is the Boolean product R x R on the
// tensor cores, csrc/elle_bitmm.cuh with A = B = R: R's bit transpose,
// which sets the tile flags of both operands, and a persistent TMA + wgmma
// kernel of 1-bit AND/popc products that skips the k stages whose tiles
// hold no bit. That header says what bounds it. The first kernel of this
// file walked the set bits of each row with __ffs against 32-row tiles
// staged per 64 rows (9.3 to 43.6 ms a squaring at n_pad 16384); its
// numbers stay in PERF.md. elle_bitmm_rate runs the tensor cores' rate
// probe (rate_kernel below), which chip_smoke.py prints.
//
// The label pass: a warp takes 32 rows i (block ib) and walks column
// blocks jb <= ib; lane l reads its row's word jb (bits over j) and
// row jb*32+l's word ib (bits over i); 32 ballots transpose the second
// 32 x 32 bit block, and the first set bit of the AND is the row's
// label. Extra blocks answer the rw queries.

#include <cstdint>

#include "elle_bitmm.cuh"

namespace {

// the same shape in int8 (k 32 bytes): the rate probe's yardstick
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " BITMM_OPERANDS
      : BITMM_ACC
      : "l"(a), "l"(b), "r"(1));
}

// -- the rate probe ---------------------------------------------------------------

// Tensor-core issue rate, no memory traffic: every block loops `iters`
// times over one stage of its shared memory. Variant 0: three
// warpgroups, four m64n256k256 .b1 AND/popc wgmma an iteration; 1: 16
// warps, eight m16n8k256 .b1 AND/popc mma.sync an iteration from
// registers; 2: variant 0's loop in int8 (m64n256k32).
template <int V>
__global__ void __launch_bounds__(V == 1 ? 512 : 384, 1)
rate_kernel(int* sink, int iters) {
  int total = 0;
  if constexpr (V == 1) {
    uint32_t a[4], b[2];
    for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 2654435761u + i;
    for (int i = 0; i < 2; ++i) b[i] = threadIdx.x * 40503u + i;
    int acc[8][4] = {};
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]),
              "+r"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
    for (int j = 0; j < 8; ++j)
      for (int i = 0; i < 4; ++i) total += acc[j][i];
  } else {
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    uint32_t* words = reinterpret_cast<uint32_t*>(
        smem_raw + (base - smem_u32(smem_raw)));
    for (int i = threadIdx.x; i < static_cast<int>(kStageBytes / 4);
         i += blockDim.x)
      words[i] = i * 2654435761u;
    __syncthreads();
    uint32_t d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0u;
    const int wg = threadIdx.x >> 7;
    for (int it = 0; it < iters; ++it) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = smem_desc(base + wg * kBoxBytes + kk * 32, 16, 1024);
        const uint64_t db = smem_desc(base + 2 * kBoxBytes + kk * 32, 16, 1024);
        if constexpr (V == 0)
          wgmma_b1(d, da, db);
        else
          wgmma_s8(d, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_acc(d);
    for (int i = 0; i < 128; ++i) total += static_cast<int>(d[i]);
  }
  if (total == 12345) sink[0] = total;  // keeps the loop
}

// The rate probe: `blocks` blocks of variant `variant` for `iters`
// iterations (rate_kernel).
int bitmm_rate(int* sink, int variant, int iters, int blocks,
               cudaStream_t stream) {
  if (variant == 1) {
    rate_kernel<1><<<blocks, 512, 0, stream>>>(sink, iters);
    return launched();
  }
  if (variant != 0 && variant != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = variant == 0 ? rate_kernel<0> : rate_kernel<2>;
  const int smem = kStageBytes + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, 384, smem, stream>>>(sink, iters);
  return launched();
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

// t, fa, fb: the squaring's scratch (elle_bitmm.cuh); counts zero on
// entry
extern "C" int elle_packed_square(const uint32_t* r, uint32_t* out,
                                  int* counts, uint32_t* t, uint8_t* fa,
                                  uint8_t* fb, int S, int n, void* stream) {
  return bitmm_square(r, r, out, counts, t, fa, fb, S, n, n / 32,
                      static_cast<cudaStream_t>(stream));
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

// the tensor cores' issue rate: `blocks` blocks of rate_kernel<variant>
// (0: 1-bit wgmma, 1: 1-bit mma.sync, 2: int8 wgmma), `iters` each
extern "C" int elle_bitmm_rate(int* sink, int variant, int iters, int blocks,
                               void* stream) {
  return bitmm_rate(sink, variant, iters, blocks,
                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* elle_packed_error_string(int code) {
  return error_text(code);
}
